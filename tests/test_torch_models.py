"""The PyTorch port's model graphs and attention (K2's plain version)
against the JAX package, on the CPU with the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.models import pallas_attn
from caesar_yolo_tpu.models.yolo import build_model as jax_build_model
from caesar_yolo_tpu.models.yolo import count_params as jax_count_params
from caesar_yolo_tpu.models.yolo import decode_dfl as jax_decode_dfl
from caesar_yolo_tpu.models.yolo import init_params
from caesar_yolo_tpu_torch.models import cuda_attn
from caesar_yolo_tpu_torch.models.convert import load_jax_params
from caesar_yolo_tpu_torch.models.yolo import build_model, count_params
from caesar_yolo_tpu_torch.models.yolo import decode_dfl, init_weights

torch.set_num_threads(1)

ATOL = 2e-4  # f32 activations (tests/test_torch_parity.py:138)


def _pair(name, seed=0):
    jm = jax_build_model(name)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda: init_params(jm, seed))())
    tm = load_jax_params(build_model(name), params).eval()
    return jm, params, tm


@pytest.mark.parametrize("name", ["yolov8n", "yolo11n"])
def test_raw_head_and_decode_match_jax(name):
    """Raw head maps of v8n / v11n at 96 px (C2PSA N = 9) in f32 with the
    JAX init carried across, and the decoded boxes and scores."""
    jm, params, tm = _pair(name)
    assert count_params(tm) == jax_count_params(params)
    x = np.random.default_rng(0).random((2, 96, 96, 3), dtype=np.float32)
    jraw = jax.jit(jm.__call__)(params, jnp.asarray(x))
    with torch.no_grad():
        traw = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for (jb, jc), (tb, tc) in zip(jraw, traw):
        np.testing.assert_allclose(tb.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jb), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tc.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jc), atol=ATOL, rtol=0)
    jboxes, jscores = jax_decode_dfl(jraw, 96)
    tboxes, tscores = decode_dfl(traw, 96)
    np.testing.assert_allclose(tboxes.numpy(), np.asarray(jboxes),
                               atol=ATOL * 96, rtol=0)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               atol=ATOL, rtol=0)


def test_fused_model_matches_unfused():
    """Folding BN into the convs keeps the f32 forward within 2e-4."""
    from caesar_yolo_tpu_torch.models.layers import fuse_tree
    tm = init_weights(build_model("yolo11n"), seed=3).eval()
    for m in tm.modules():  # non-trivial BN statistics
        if hasattr(m, "gamma"):
            m.gamma.data.uniform_(0.5, 1.5)
            m.mean.uniform_(-0.1, 0.1)
            m.var.uniform_(0.5, 2.0)
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        ref = tm(x)
        got = fuse_tree(tm)(x)
    for (rb, rc), (gb, gc) in zip(ref, got):
        torch.testing.assert_close(gb, rb, atol=ATOL, rtol=0)
        torch.testing.assert_close(gc, rc, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["yolov8l", "yolo11l"])
def test_count_params_matches_jax_at_full_width(name):
    jm = jax_build_model(name)
    shapes = jax.eval_shape(lambda: init_params(jm, 0))
    assert count_params(build_model(name)) == jax_count_params(shapes)


@pytest.mark.parametrize("n", [16, 400])
def test_attention_plain_matches_pallas_interpret(monkeypatch, n):
    """K2's plain version against the Pallas kernel in interpret mode, f32,
    at the C2PSA head widths (kd 32, hd 64)."""
    monkeypatch.setattr(pallas_attn, "INTERPRET", True)
    rng = np.random.default_rng(n)
    b, h, kd, hd = 2, 2, 32, 64
    q = rng.standard_normal((b, h, n, kd)).astype(np.float32)
    k = rng.standard_normal((b, h, n, kd)).astype(np.float32)
    v = rng.standard_normal((b, h, n, hd)).astype(np.float32)
    scale = kd ** -0.5
    ref = np.asarray(pallas_attn.attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    got = cuda_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_attention_gate_follows_reference(monkeypatch):
    """The port takes its kernel exactly where the reference takes its
    Pallas kernel (pallas_attn.py:48), on N alone: head widths the kernel
    lacks still go to it (and it raises on CUDA), never to plain PyTorch.
    Other N take the einsum branch."""
    from caesar_yolo_tpu_torch.models.layers import Attention

    for n in (4, 9, 12, 400, 2048, 2056):
        assert cuda_attn.fused_gate(n) == (
            n % 8 == 0 and 8 <= n <= pallas_attn.MAX_N)
    calls = []
    plain = cuda_attn.attention_plain
    monkeypatch.setattr(cuda_attn, "attention",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    attn = Attention(48, num_heads=4).eval()     # kd 6, hd 12
    assert attn.key_dim not in cuda_attn.KERNEL_KD
    g = torch.Generator().manual_seed(0)
    for p in attn.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1, generator=g)
    with torch.no_grad():
        for hw in (4, 3):                        # N = 16 in the gate, 9 not
            attn(torch.randn(1, 48, hw, hw, generator=g))
    assert calls == [(1, 4, 16, 6)]


def _online_softmax_attention(q, k, v, scale):
    """What the kernel must not do: round p before normalising (the
    deferred normalisation of an online softmax)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(v.dtype)


def test_bf16_parity_rule_rejects_online_softmax():
    """The bf16 parity rule that holds K2 to its plain version on the card
    passes a change of f32 summation order (here: f64 sums) and fails an
    online softmax, which stays within one ulp but moves about half of
    the outputs.  C2PSA shape of yolo11l at 640 px, batch 2."""
    g = torch.Generator().manual_seed(0)
    b, h, n, kd, hd = 2, 4, 400, 32, 64
    q, k, v = (torch.randn(b, h, n, d, generator=g).bfloat16()
               for d in (kd, kd, hd))
    scale = kd ** -0.5
    ref = cuda_attn.attention_plain(q, k, v, scale)
    s = (torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
         ).float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).double()
    p = (p / p.sum(dim=-1, keepdim=True)).float().bfloat16()
    reordered = torch.matmul(p.double(), v.double()).bfloat16()
    assert cuda_attn.bf16_mismatch(reordered, ref) is None
    why = cuda_attn.bf16_mismatch(
        _online_softmax_attention(q, k, v, scale), ref)
    assert why is not None and "changed share" in why


def test_bf16_head_keeps_the_reference_biases():
    """In bf16 the trained yolov8n's class logits, averaged over every
    anchor (where rounding noise cancels), stay within 4e-3 of the JAX
    package's bf16 logits.  The reference adds f32 biases to its f32 conv
    output; rounding the biases to bf16 instead shifts every anchor of a
    channel alike (a mean gap of 8.7e-3 at stride 8 on this input, against
    2.2e-3 with f32 biases)."""
    import os

    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.parallel.engine import fuse_model_params
    from caesar_yolo_tpu_torch.detect.predictor import prepare_model
    from caesar_yolo_tpu_torch.models.convert import load_model

    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "yolov8n_synth96.npz")
    params, meta = load_params(weights)
    jm = jax_build_model(meta["model"], num_classes=int(meta["num_classes"]))
    tm = prepare_model(load_model(weights)[0],
                       dtype=torch.bfloat16, device=torch.device("cpu"))
    x = np.random.default_rng(0).random((2, 96, 96, 3), dtype=np.float32)
    jraw = jax.jit(jm.__call__)(fuse_model_params(jm, params),
                                jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        traw = tm(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    for (_, jc), (_, tc) in zip(jraw, traw):
        gap = (tc.float().permute(0, 2, 3, 1).numpy()
               - np.asarray(jc, np.float32))
        assert abs(gap.mean()) <= 4e-3, gap.mean()
