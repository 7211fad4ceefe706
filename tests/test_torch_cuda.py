"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Every test here needs a CUDA device and skips
without one.  Run them on the card (where JAX, which tests/conftest.py
imports, need not be installed) from the repository root with
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from caesar_yolo_tpu_torch.detect import cuda_nms
from caesar_yolo_tpu_torch.models import cuda_attn, cuda_epilogue, cuda_qconv
from caesar_yolo_tpu_torch.ops import (
    clahe,
    cuda_clahe,
    cuda_histeq,
    cuda_preproc,
    cuda_shift,
    cuda_stats,
    cuda_upsample,
)
from caesar_yolo_tpu_torch.ops.histeq import equalize_hist
from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain
from caesar_yolo_tpu_torch.ops.zscale import zscale_limits

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [100, 512, 1024, 2048])
@pytest.mark.parametrize("spread", [300.0, 30.0])
def test_nms_kernel_bit_equal(dev, k, spread):
    rng = np.random.default_rng(k)
    b = 4
    cx, cy = rng.random((2, b, k)) * spread
    w, h = rng.random((2, b, k)) * 30 + 2
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     axis=-1).astype(np.float32)
    boxes[:, 5:9] = boxes[:, 4:5]
    valid = torch.from_numpy(rng.random((b, k)) > 0.1).to(dev)
    boxes = torch.from_numpy(boxes).to(dev)
    got = cuda_nms.nms_suppress(boxes.transpose(1, 2), valid, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_nms.suppress_plain(boxes, valid, 0.5))


def _nms_inputs(dev, b, k, spread, seed):
    rng = np.random.default_rng(seed)
    cx, cy = rng.random((2, b, k)) * spread
    w, h = rng.random((2, b, k)) * 30 + 2
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     axis=-1).astype(np.float32)
    valid = torch.from_numpy(rng.random((b, k)) > 0.1).to(dev)
    return torch.from_numpy(boxes).to(dev), valid


@pytest.mark.parametrize("b,k", [(b, k) for b in (1, 32, 64)
                                 for k in (1, 33, 512, 2048)] + [(2, 4096)])
def test_nms_kernel_bit_equal_across_shapes(dev, b, k):
    """The mask launch's stripes and the scan's 32-row steps at ragged and
    large K, for one to 64 images."""
    boxes, valid = _nms_inputs(dev, b, k, 100.0 + k / 4, k + b)
    got = cuda_nms.nms_suppress(boxes.transpose(1, 2), valid, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_nms.suppress_plain(boxes, valid, 0.5))


def test_nms_kernel_all_overlapping_window(dev):
    """Every box overlaps every other (the scan's worst case: every
    removed word is written by a long chain), plus greedy chains where
    A kills B and B would have killed C."""
    rng = np.random.default_rng(3)
    b, k = 8, 512
    base = np.array([10.0, 10.0, 60.0, 60.0], np.float32)
    boxes = np.broadcast_to(base, (b, k, 4)).copy()
    boxes += rng.random((b, k, 4)).astype(np.float32) * 4.0
    chain = np.array([[0, 0, 10, 10], [0, 0, 10, 16], [0, 0, 10, 24]],
                     np.float32) + 200.0
    boxes[:, 100:103] = chain
    boxes = torch.from_numpy(boxes).to(dev)
    valid = torch.ones((b, k), dtype=torch.bool, device=dev)
    got = cuda_nms.nms_suppress(boxes.transpose(1, 2), valid, 0.5)
    again = cuda_nms.nms_suppress(boxes.transpose(1, 2), valid, 0.5)
    torch.cuda.synchronize()
    ref = cuda_nms.suppress_plain(boxes, valid, 0.5)
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert bool(ref[:, 100].all()) and not bool(ref[:, 101].any())
    assert bool(ref[:, 102].all())


def test_nms_kernel_repeats_bit_for_bit(dev):
    boxes, valid = _nms_inputs(dev, 32, 512, 300.0, 9)
    first = cuda_nms.nms_suppress(boxes.transpose(1, 2), valid, 0.5)
    second = cuda_nms.nms_suppress(boxes.transpose(1, 2), valid, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,kd,hd", [(32, 4, 400, 32, 64),
                                         (32, 4, 256, 32, 64),
                                         (2, 2, 16, 16, 32),
                                         (2, 2, 8, 32, 64),
                                         (1, 6, 2048, 32, 64),
                                         (2, 1, 64, 64, 128),
                                         (1, 2, 24, 16, 1),
                                         (3, 2, 40, 16, 24),
                                         (2, 1, 72, 64, 160),
                                         (1, 1, 2048, 64, 256),
                                         (1, 2, 424, 64, 64),
                                         (1, 2, 432, 64, 64),
                                         (1, 1, 1768, 64, 64),
                                         (128, 8, 400, 32, 32),
                                         (32, 8, 400, 32, 32)])
def test_attention_kernel_matches_plain(dev, dtype, b, h, n, kd, hd):
    """f32 within 1e-5; bf16 by cuda_attn's bf16 parity rule.  The shapes
    reach the kernels' less common paths: ragged N (padded keys), head
    widths padded to 16 (hd 1, 24) and copied element by element (hd % 8),
    several 64-column V passes with a ragged last one (hd 160, 256), and
    kd = 64 at the N (424, 432, 1768) where the shortest V stage holds
    fewer than 16 K rows; and yolo12l's area attention at 640 px, batch
    32 (P4's four strips a map, P5; heads of 32 for q, k and v)."""
    g = torch.Generator(device=dev).manual_seed(n)
    q, k, v = (torch.randn(b, h, n, d, device=dev, generator=g).to(dtype)
               for d in (kd, kd, hd))
    got = cuda_attn.attention(q, k, v, kd ** -0.5)
    torch.cuda.synchronize()
    ref = cuda_attn.attention_plain(q, k, v, kd ** -0.5)
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-5
    else:
        assert cuda_attn.bf16_mismatch(got, ref) is None


def test_attention_kernel_rejects_unsupported(dev):
    """Outside the reference's N gate, and at head widths the kernel does
    not take, the kernel raises on CUDA; so does a C2PSA attention of such
    widths, which never runs plain PyTorch on the card."""
    from caesar_yolo_tpu_torch.models.layers import Attention

    for n, kd, hd in ((12, 32, 32), (16, 8, 32), (16, 32, 300)):
        q = torch.randn(1, 1, n, kd, device=dev)
        v = torch.randn(1, 1, n, hd, device=dev)
        with pytest.raises(ValueError):
            cuda_attn.attention(q, q, v, 0.1)
    attn = Attention(48, num_heads=4).to(dev).eval()     # kd 6, hd 12
    with torch.no_grad(), pytest.raises(ValueError):
        attn(torch.randn(1, 48, 4, 4, device=dev))


@pytest.mark.parametrize("norm", [(0.0, 1.0), (-1.0, 2.0)])
@pytest.mark.parametrize("shape,offset,route", [
    ((6, 200, 160), 0, "cluster"), ((32, 640, 640), 0, "cluster"),
    ((32, 132, 132), 0, "cluster"), ((5, 33, 47), 0, "cluster"),
    ((6, 64, 64), 1, "cluster"), ((3, 800, 800), 0, "cluster"),
    ((3, 2048, 2048), 0, "stream"), ((3, 1023, 1021), 0, "stream"),
    ((3, 1024, 1024), 1, "stream")])
def test_zscale_minmax_kernel_matches_plain(dev, shape, offset, route, norm):
    """Bit-equal to the plain chain on both routes (aligned planes and
    planes that are not 16-byte aligned), the edge planes included; the
    route's counter shows the route ran; an all-zero plane's limits are
    (+inf, -inf) and the last, noise, plane is valid."""
    x = cs.preproc_planes(dev, np.random.default_rng(sum(shape)), shape,
                          offset)
    vmin, vmax = zscale_limits(x)
    vlims = torch.stack([vmin, vmax], dim=1)
    counter = f"{route}_launches"
    before = getattr(cuda_preproc.zscale_minmax, counter)
    out, zl = cuda_preproc.zscale_minmax(x, vlims, *norm)
    torch.cuda.synchronize()
    assert getattr(cuda_preproc.zscale_minmax, counter) == before + 1
    ref, rzl = cuda_preproc.zscale_minmax_plain(x, vlims, *norm)
    assert torch.equal(zl, rzl)
    assert torch.equal(out, ref)
    assert zl[0].tolist() == [float("inf"), float("-inf")]
    assert bool(zl[-1, 1] > zl[-1, 0])      # the noise plane has valid pixels


@pytest.mark.parametrize("cluster,segments", [
    (8, 1), (8, 8), (16, 1), (16, 2), (16, 4), (16, 8), (4, 3)])
def test_zscale_minmax_kernel_configurations(dev, cluster, segments):
    """Every cluster size and segmenting the tune table compares gives the
    plain chain's bits."""
    shape = (32, 640, 640) if cluster > 4 else (32, 132, 132)
    x = cs.preproc_planes(dev, np.random.default_rng(cluster), shape)
    vlims = torch.stack(zscale_limits(x), dim=1)
    out, zl = cuda_preproc.launch(x, vlims, 0.0, 1.0, "cluster", cluster,
                                  segments)
    torch.cuda.synchronize()
    ref, rzl = cuda_preproc.zscale_minmax_plain(x, vlims)
    assert torch.equal(zl, rzl) and torch.equal(out, ref)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(32, 132, 132), (32, 640, 640)])
def test_zscale_minmax_stream_route_on_edge_planes(dev, shape, offset):
    """The stream route, forced on planes the plan gives the cluster route,
    is bit-equal to the plain chain on every edge plane and on noise
    planes, aligned and not."""
    x = cs.preproc_planes(dev, np.random.default_rng(sum(shape) + offset),
                          shape, offset)
    vlims = torch.stack(zscale_limits(x), dim=1)
    before = cuda_preproc.zscale_minmax.stream_launches
    out, zl = cuda_preproc.launch(x, vlims, -1.0, 2.0, "stream", 16, 0)
    torch.cuda.synchronize()
    assert cuda_preproc.zscale_minmax.stream_launches == before + 1
    ref, rzl = cuda_preproc.zscale_minmax_plain(x, vlims, -1.0, 2.0)
    assert torch.equal(zl, rzl) and torch.equal(out, ref)
    valid = torch.isfinite(zl[:, 0]) & (zl[:, 1] > zl[:, 0])
    assert int(valid.sum()) > shape[0] // 2


def _edge_planes(dev, p, h, w, seed):
    """Noise planes with the edge cases of the clip statistics: all zero,
    NaN-blanked pixels, constant, a bright source, heavy duplicates."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (p, h, w)).astype(np.float32)
    x[0] = 0.0
    x[1, : h // 4] = np.nan
    x[2] = 3.0
    x[3, h // 2:h // 2 + 8, w // 2:w // 2 + 8] += 500.0
    x[4, : h // 2] = 0.25
    x[:, :2, :] = 0.0
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("sigmas", [(3.0, 3.0), (0.0, 20.0), (1.0, 20.0)])
@pytest.mark.parametrize("shape", [(32, 512, 512), (6, 96, 100),
                                   (5, 33, 47)])
def test_sigma_clip_kernel_matches_plain(dev, shape, sigmas):
    """By cuda_stats.stats_mismatch: n_valid equal, medians exact where
    the kept sets agree, the rest within 1e-5 of the plane's scale."""
    x = _edge_planes(dev, *shape, seed=shape[1])
    got = cuda_stats.clip_stats(x, *sigmas)
    torch.cuda.synchronize()
    ref = clip_stats_plain(x, None, *sigmas)
    assert cuda_stats.stats_mismatch(got, ref) is None
    assert int(got[1][0, 0]) == 0 and bool(got[0][0].isnan().all())


def _route_planes(dev, p, h, w, seed):
    """Planes for the route tests: noise with heavy duplicates and a
    NaN-blanked band, edge-case planes where p allows (all zero, constant,
    a bright source), and the last plane holding exactly one valid pixel."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(0, 1, (p, h, w)) * 64).astype(np.float32) / 64
    x[:, : h // 16] = np.nan
    if p > 4:
        x[1] = 0.0
        x[2] = 3.0
        x[3, h // 2:h // 2 + 8, w // 2:w // 2 + 8] += 500.0
    if p > 1:
        x[-1] = 0.0
        x[-1, h // 3, w // 3] = -2.5
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("sigmas", [(3.0, 3.0), (1.0, 20.0)])
@pytest.mark.parametrize("shape,route", [((32, 512, 512), "cluster"),
                                         ((1, 640, 640), "cluster"),
                                         ((32, 132, 132), "cluster"),
                                         ((5, 33, 47), "cluster"),
                                         ((2, 2048, 2048), "stream")])
def test_sigma_clip_kernel_routes(dev, shape, route, sigmas):
    """Each route against the plain version by cuda_stats.stats_mismatch;
    plan() picks the route by size and its counter shows it ran; two calls
    give bit-equal statistics; a one-pixel plane keeps its pixel."""
    assert cuda_stats.plan(shape[1] * shape[2])[0] == route
    x = _route_planes(dev, *shape, seed=shape[2])
    counter = f"{route}_launches"
    before = getattr(cuda_stats.clip_stats, counter)
    got = cuda_stats.clip_stats(x, *sigmas)
    again = cuda_stats.clip_stats(x, *sigmas)
    torch.cuda.synchronize()
    assert getattr(cuda_stats.clip_stats, counter) == before + 2
    assert torch.equal(got[0].nan_to_num(), again[0].nan_to_num())
    assert torch.equal(got[1], again[1])
    ref = clip_stats_plain(x, None, *sigmas)
    assert cuda_stats.stats_mismatch(got, ref) is None
    if shape[0] > 1:
        assert got[1][-1].tolist() == [1, 1]
        assert got[0][-1, 1].item() == -2.5


@pytest.mark.parametrize("draws", ["parity k3-shapes-edges", "seed 127"])
def test_sigma_clip_kernel_on_the_pinned_inputs(dev, draws):
    """The two inputs where the kernel once failed its rule
    (scripts/torch_k5_kept_probe.py: 5 pixels fewer kept on planes 7 and
    13 of the first, statistics 1.36e-5 of the scale off on the second),
    at each of the mosaic's sigmas: within cuda_stats.stats_mismatch, kept
    counts equal."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_k5_kept_probe.py")
    spec = importlib.util.spec_from_file_location("k5_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    rng = (probe.parity_generator("k3-shapes-edges") if draws.startswith(
        "parity") else np.random.default_rng(127))
    x = cs.mosaic_planes(dev, rng)
    for sig in cs.MOSAIC_SIGMAS:
        got = cuda_stats.clip_stats(x, *sig)
        torch.cuda.synchronize()
        ref = clip_stats_plain(x, None, *sig)
        assert cuda_stats.stats_mismatch(got, ref) is None, sig
        assert torch.equal(got[1], ref[1]), sig


def test_sigma_clip_kernel_rejects_what_it_cannot_take(dev):
    x = torch.randn(2, 16, 16, device=dev)
    with pytest.raises(ValueError):
        cuda_stats.clip_stats(x, 3.0, 3.0, mask=x != 0)
    with pytest.raises(ValueError):
        cuda_stats.clip_stats(x.double(), 3.0, 3.0)


def _histeq_planes(dev, p, h, w, seed):
    """_edge_planes, and where p allows a plane holding +inf, one holding
    -inf, and one whose values are all equal but one."""
    x = _edge_planes(dev, p, h, w, seed)
    extra = [lambda a: a.__setitem__((h // 2, w // 2), float("inf")),
             lambda a: a.__setitem__((h // 3, 1), -float("inf")),
             lambda a: (a.fill_(2.0), a.__setitem__((h - 1, w - 1), 5.0))]
    for i, fill in zip(range(5, p), extra):
        fill(x[i])
    return x


@pytest.mark.parametrize("shape", [(32, 512, 512), (1, 640, 640),
                                   (32, 132, 132), (6, 96, 100),
                                   (5, 33, 47), (8, 33, 47)])
def test_histeq_kernel_bit_equal(dev, shape):
    """The cluster route, one launch a call, bit-equal to equalize_hist on
    noise and the edge planes (a NaN poisons its plane; +-inf, constant,
    all equal but one)."""
    assert cuda_histeq.plan(shape[1] * shape[2])[0] == "cluster"
    x = (_histeq_planes(dev, *shape, seed=shape[2]) if shape[0] > 1 else
         torch.randn(shape, device=dev))
    before = (cuda_histeq.equalize_hist_batch.launches,
              cuda_histeq.equalize_hist_batch.cluster_launches)
    got = cuda_histeq.equalize_hist_batch(x)
    torch.cuda.synchronize()
    assert (cuda_histeq.equalize_hist_batch.launches,
            cuda_histeq.equalize_hist_batch.cluster_launches) == (
                before[0] + 1, before[1] + 1)
    ref = equalize_hist(x)
    assert torch.equal(got.isnan(), ref.isnan())
    if shape[0] > 1:
        assert bool(got[1].isnan().all())        # a NaN poisons its plane
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())


def test_histeq_kernel_stream_route(dev):
    """Planes past the cluster route's limit take the four-launch stream
    route, bit-equal too."""
    shape = (2, 1024, 1024)
    assert shape[1] * shape[2] > 16 * cuda_histeq.MAX_BLOCK_VALUES
    assert cuda_histeq.plan(shape[1] * shape[2])[0] == "stream"
    x = torch.randn(shape, device=dev)
    x[1, 5, 5] = float("nan")
    before = cuda_histeq.equalize_hist_batch.stream_launches
    got = cuda_histeq.equalize_hist_batch(x)
    torch.cuda.synchronize()
    assert cuda_histeq.equalize_hist_batch.stream_launches == before + 1
    ref = equalize_hist(x)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())


def test_histeq_kernel_rejects_what_it_cannot_take(dev):
    with pytest.raises(ValueError):
        cuda_histeq.equalize_hist_batch(torch.randn(2, 16, 16, device=dev)
                                        .double())
    with pytest.raises(ValueError):
        cuda_histeq.equalize_hist_batch(torch.randn(16, 16, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,kd,hd", [(16, 4, 400, 32, 64),
                                         (16, 4, 256, 32, 64),
                                         (2, 2, 16, 16, 32),
                                         (2, 2, 8, 32, 64),
                                         (1, 2, 2048, 32, 64),
                                         (2, 1, 72, 64, 160),
                                         (1, 2, 24, 16, 1),
                                         (3, 2, 40, 16, 24),
                                         (1, 1, 2048, 64, 256),
                                         (1, 2, 424, 64, 64),
                                         (1, 1, 1768, 64, 64),
                                         (16, 8, 400, 32, 32)])
def test_attention_backward_kernel_matches_plain(dev, dtype, b, h, n, kd, hd):
    """dq, dk, dv against autograd of attention_plain: f32 within 1e-5 of
    each gradient's largest value; bf16 by cuda_attn.bwd_bf16_mismatch."""
    g_ = torch.Generator(device=dev).manual_seed(n + hd)
    q, k, v, g = (torch.randn(b, h, n, d, device=dev, generator=g_).to(dtype)
                  for d in (kd, kd, hd, hd))
    got = cuda_attn.attention_backward(q, k, v, g, kd ** -0.5)
    torch.cuda.synchronize()
    ref = cuda_attn.attention_backward_plain(q, k, v, g, kd ** -0.5)
    if dtype == torch.float32:
        for x, r in zip(got, ref):
            assert (x - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    else:
        assert cuda_attn.bwd_bf16_mismatch(got, ref) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_repeats_bit_for_bit(dev, dtype):
    """No atomics: two calls on the same inputs give equal dq, dk, dv."""
    g_ = torch.Generator(device=dev).manual_seed(5)
    q, k, v, g = (torch.randn(16, 4, 400, d, device=dev, generator=g_)
                  .to(dtype) for d in (32, 32, 64, 64))
    first = cuda_attn.attention_backward(q, k, v, g, 32 ** -0.5)
    second = cuda_attn.attention_backward(q, k, v, g, 32 ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_backward_kernel_has_no_nxn_scratch(dev):
    """One bf16 backward call at the training shape [16,4,400,32/64] raises
    the peak device memory by less than 10 MB beyond its inputs and its
    outputs (the row statistics are 0.3 MB; an [N, N] f32 tensor per head
    would be 41 MB)."""
    g_ = torch.Generator(device=dev).manual_seed(6)
    q, k, v, g = (torch.randn(16, 4, 400, d, device=dev, generator=g_)
                  .bfloat16() for d in (32, 32, 64, 64))
    cuda_attn.attention_backward(q, k, v, g, 32 ** -0.5)   # build, warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    grads = cuda_attn.attention_backward(q, k, v, g, 32 ** -0.5)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in grads)
    extra = torch.cuda.max_memory_allocated(dev) - base - outputs
    assert extra < 10 * 2 ** 20, extra


def test_fused_attention_autograd_launches_both_kernels(dev):
    q, k, v = (torch.randn(2, 2, 64, d, device=dev, requires_grad=True)
               for d in (32, 32, 64))
    f0, b0 = cuda_attn.attention.launches, cuda_attn.attention_backward.launches
    cuda_attn.fused_attention(q, k, v, 0.2).sum().backward()
    assert cuda_attn.attention.launches == f0 + 1
    assert cuda_attn.attention_backward.launches == b0 + 1
    assert q.grad is not None and v.grad.shape == v.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 512, 20, 20), (16, 512, 40, 40),
                                   (2, 3, 5, 7), (1, 6, 4, 4)])
def test_upsample_kernels_bit_equal(dev, dtype, shape):
    """Forward and gradient bit-equal to the plain versions, channels_last
    in and out (and from an NCHW input)."""
    x = torch.randn(shape, device=dev).to(dtype)
    g = torch.randn(shape[0], shape[1], 2 * shape[2], 2 * shape[3],
                    device=dev).to(dtype)
    for xin in (x.contiguous(memory_format=torch.channels_last), x):
        y = cuda_upsample.upsample2x_forward(xin)
        torch.cuda.synchronize()
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(y, cuda_upsample.upsample2x_plain(x))
    gx = cuda_upsample.upsample2x_backward(
        g.contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert torch.equal(gx, cuda_upsample.upsample2x_backward_plain(g))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,offset,c,vec", [
    (1024, 0, 512, (16, 16)), (1024, 512, 512, (16, 16)),
    (768, 256, 512, (16, 16)), (1024, 3, 512, (2, 4)),
    (1024, 4, 512, (8, 16)), (520, 0, 510, (4, 8)), (8, 1, 6, (2, 4)),
    (4, 0, 1, (2, 4))])
def test_upsample_backward_reads_slices_in_place(dev, dtype, width, offset,
                                                 c, vec):
    """K4's backward on a channel slice of a channels_last gradient (the
    concat's) reads it where it lies, with no copy, in vectors of the
    width backward_plan gives (bf16, f32), bit-equal to the plain
    version; the same at every narrower vector width; an NCHW gradient is
    copied once."""
    full = torch.randn(2, width, 12, 10, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    g = full[:, offset:offset + c]
    plan = cuda_upsample.backward_plan(g.shape, g.stride(),
                                       g.storage_offset(), g.element_size())
    assert plan == vec[dtype == torch.float32]
    ref = cuda_upsample.upsample2x_backward_plain(g)
    copies = cuda_upsample.upsample2x_backward.copies
    gx = cuda_upsample.upsample2x_backward(g)
    torch.cuda.synchronize()
    assert cuda_upsample.upsample2x_backward.copies == copies
    assert gx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(gx, ref)
    for vb in (16, 8, 4, 2):
        if g.element_size() <= vb <= plan:
            got = cuda_upsample.launch_backward(g, vb)
            torch.cuda.synchronize()
            assert torch.equal(got, ref)
    gx = cuda_upsample.upsample2x_backward(g.contiguous())
    torch.cuda.synchronize()
    assert cuda_upsample.upsample2x_backward.copies == copies + (c > 1)
    assert torch.equal(gx, ref)


def test_upsample_autograd_through_concat_reads_in_place(dev):
    """The neck's pattern, cat([upsample(x), y]) under a channels_last
    gradient: autograd hands K4 a channel slice, which it reads with no
    copy; x's gradient equals the plain backward of that slice."""
    x = torch.randn(2, 64, 6, 5, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = torch.randn(2, 32, 12, 10, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(2, 96, 12, 10, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last)
    copies = cuda_upsample.upsample2x_backward.copies
    launches = cuda_upsample.upsample2x_backward.launches
    torch.cat([cuda_upsample.upsample2x(x), y], dim=1).backward(g)
    torch.cuda.synchronize()
    assert cuda_upsample.upsample2x_backward.copies == copies
    assert cuda_upsample.upsample2x_backward.launches == launches + 1
    assert torch.equal(x.grad,
                       cuda_upsample.upsample2x_backward_plain(g[:, :64]))


def _shift_case(dev, shape, pad, way, kind):
    """imgs [B, H, W, C] (contiguous for the row route, the transposed view
    of a contiguous [B, W, H, C] canvas for the column route) and shifts
    [B, H]: random ones past the clip (far apart within a strip) or the
    augmentation's shears; the clip limits on the first rows."""
    b, h, w, c = shape
    g_ = torch.Generator(device=dev).manual_seed(h + w + c)
    if way == "row":
        imgs = torch.rand(shape, device=dev, generator=g_)
    else:
        imgs = torch.rand(b, w, h, c, device=dev, generator=g_).transpose(1, 2)
    if kind == "random":
        shifts = (torch.rand(b, h, device=dev, generator=g_) * 2 - 1) * (
            pad + 3)
    else:
        r = (torch.rand(b, device=dev, generator=g_) * 2 - 1) * (np.pi / 4)
        r[0] = np.pi / 4
        ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2
        shifts = torch.tan(r)[:, None] * ys[None]
    shifts[0, :3] = torch.tensor([0.0, -pad, pad - 1.0])
    return imgs, shifts


@pytest.mark.parametrize("kind", ["random", "shear"])
@pytest.mark.parametrize("way", ["row", "column"])
@pytest.mark.parametrize("pad_val", [114 / 255, 1.0])
@pytest.mark.parametrize("shape,pad", [((16, 1092, 1092, 3), 548),
                                       ((2, 30, 20, 3), 12),
                                       ((2, 30, 21, 3), 12),
                                       ((2, 30, 21, 1), 12)])
def test_row_shift_kernel_bit_equal(dev, shape, pad, pad_val, way, kind):
    """Both routes bit-equal to row_shift_plain, W*C a multiple of 4 and
    not, C = 1, shifts at the clip limits -pad and pad - 1; the output
    keeps the input's strides and the route's counter shows it ran."""
    imgs, shifts = _shift_case(dev, shape, pad, way, kind)
    counter = f"{way}_launches"
    before = getattr(cuda_shift.fractional_row_shift_batch, counter)
    got = cuda_shift.fractional_row_shift_batch(imgs, shifts, pad, pad_val)
    torch.cuda.synchronize()
    assert getattr(cuda_shift.fractional_row_shift_batch,
                   counter) == before + 1
    assert got.stride() == imgs.stride()
    ref = cuda_shift.row_shift_plain(imgs, shifts, pad, pad_val)
    assert torch.equal(got, ref)


def test_row_shift_kernel_rejects_layouts(dev):
    """A layout neither route takes raises; nothing is copied into one."""
    imgs = torch.rand(2, 8, 6, 3, device=dev)
    shifts = torch.zeros(2, 8, device=dev)
    for bad in (imgs.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2),
                imgs[:, :, ::2], imgs.permute(1, 0, 2, 3).contiguous()
                .permute(1, 0, 2, 3)):
        with pytest.raises(ValueError):
            cuda_shift.fractional_row_shift_batch(
                bad, shifts[:, :bad.shape[1]], 4)
    with pytest.raises(ValueError):
        cuda_shift.fractional_row_shift_batch(imgs.double(), shifts, 4)


def test_augment_batch_column_route_equals_transpose_route(dev, monkeypatch):
    """augment_batch with the y-shear on the column route (the canvas read
    in place) gives the same bits as with a transposed copy on the row
    route (the design before it)."""
    from caesar_yolo_tpu_torch.train import augment

    g = torch.Generator().manual_seed(3)
    images = torch.rand(4, 64, 64, 3, generator=g).to(dev)
    boxes = torch.tensor([[[10.0, 10.0, 30.0, 30.0]]]).repeat(4, 1, 1)
    masks = torch.ones(4, 1, dtype=torch.bool)
    draws = augment.draw_augment_params(g, 4)
    cols = cuda_shift.fractional_row_shift_batch.column_launches
    got = augment.augment_batch(images, boxes, masks, *draws)
    assert cuda_shift.fractional_row_shift_batch.column_launches == cols + 1
    monkeypatch.setattr(
        augment, "fractional_row_shift_batch",
        lambda imgs, *a: cuda_shift.fractional_row_shift_batch(
            imgs.contiguous(), *a))
    ref = augment.augment_batch(images, boxes, masks, *draws)
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        assert torch.equal(x, r)


def _clahe_planes(dev, p, h, w, seed):
    """Noise planes with a bright source each, and the edge cases of the
    CLAHE binning: an all-zero plane, a plane holding a NaN, a constant
    plane."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (p, h, w)).astype(np.float32)
    x[:, h // 3:h // 3 + 6, w // 2:w // 2 + 6] += 150.0
    x[0] = 0.0
    x[1, h // 2, 3] = np.nan
    x[2] = 7.0
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("clip_limit", [0.03, 0.01])
@pytest.mark.parametrize("shape", [(32, 132, 132), (32, 640, 640),
                                   (4, 96, 100), (3, 128, 256)])
def test_clahe_kernels_bit_equal(dev, shape, clip_limit):
    """K7 on both routes, each forced, bit-equal to the plain version: the
    cluster route (plan's, one launch a call) and the stream route (its
    histogram and blend kernels, each launched on its own, bit-equal too);
    NaN, zero and constant
    planes come out finite in [0, 1]."""
    x = _clahe_planes(dev, *shape, seed=shape[1] + shape[2])
    ref = clahe.equalize_adapthist_plain(x, clip_limit)
    fn = cuda_clahe.equalize_adapthist_batch
    plan = cuda_clahe.plan(*shape[1:])
    assert plan[0] == "cluster"
    for route, config in (("cluster", plan[1:]), ("stream", (0, 0, 0))):
        before = (fn.launches, getattr(fn, f"{route}_launches"))
        out = cuda_clahe.launch(x, clip_limit, clahe.GRID, route, *config)
        torch.cuda.synchronize()
        assert (fn.launches, getattr(fn, f"{route}_launches")) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(out, ref), route
    out = fn(x, clip_limit)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    vmin, span = clahe.value_range(x)
    hist = cuda_clahe.tile_histograms(x, vmin, span)
    torch.cuda.synchronize()
    assert torch.equal(hist, clahe.tile_histograms_plain(x, vmin, span))
    th, tw = clahe.tile_size(*shape[1:])
    assert bool((hist.sum(dim=-1) == th * tw).all())
    cdf = clahe.cdf_tables(hist, th * tw, clip_limit)
    got = cuda_clahe.blend(x, vmin, span, cdf)
    torch.cuda.synchronize()
    assert torch.equal(got, clahe.blend_plain(x, vmin, span, cdf))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_clahe_cluster_sizes_bit_equal(dev, cluster):
    """Every cluster size the route can take, on the eval path's cutouts
    and an odd shape that reflect-pads both axes (rows 4-byte aligned or
    not), bit-equal to the plain version."""
    for shape in ((32, 132, 132), (5, 33, 47)):
        x = _clahe_planes(dev, *shape, seed=cluster)
        rows, win, smem = cuda_clahe.layout(*shape[1:], cluster)
        assert smem <= cuda_clahe.SMEM_BYTES
        out = cuda_clahe.launch(x, 0.03, clahe.GRID, "cluster", cluster,
                                rows, win)
        torch.cuda.synchronize()
        assert torch.equal(out, clahe.equalize_adapthist_plain(x, 0.03))


@pytest.mark.parametrize("shape", [(132, 132), (640, 640), (96, 100),
                                   (128, 256), (33, 47), (720, 720),
                                   (1024, 512)])
def test_clahe_layout_agrees_with_the_kernel(dev, shape):
    """For every cluster size whose blocks fit, the C entry point takes
    cuda_clahe.layout's rows, tile rows and byte count (it checks them
    against the kernel's own carving and windows) and gives the plain
    version's bits; a layout one tile row or one row off is refused."""
    x = _clahe_planes(dev, 4, *shape, seed=shape[1])
    ref = clahe.equalize_adapthist_plain(x, 0.03)
    taken = 0
    for cluster in (1, 2, 4, 8, 16):
        rows, win, smem = cuda_clahe.layout(*shape, cluster)
        if smem > cuda_clahe.SMEM_BYTES:
            continue
        out = cuda_clahe.launch(x, 0.03, clahe.GRID, "cluster", cluster,
                                rows, win)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), cluster
        taken += 1
        for bad in ((rows, win + 1), (rows + 1, win)):
            with pytest.raises(RuntimeError):
                cuda_clahe.launch(x, 0.03, clahe.GRID, "cluster", cluster,
                                  *bad)
    assert taken


def test_clahe_stream_route_by_size(dev):
    """Planes past the cluster route's shared memory take the four-launch
    stream route, bit-equal too."""
    shape = (3, 1024, 1024)
    assert cuda_clahe.plan(*shape[1:])[0] == "stream"
    x = _clahe_planes(dev, *shape, seed=5)
    before = cuda_clahe.equalize_adapthist_batch.stream_launches
    out = cuda_clahe.equalize_adapthist_batch(x)
    torch.cuda.synchronize()
    assert cuda_clahe.equalize_adapthist_batch.stream_launches == before + 1
    assert torch.equal(out, clahe.equalize_adapthist_plain(x))


def test_clahe_kernels_reject_what_they_cannot_take(dev):
    x = torch.randn(2, 32, 32, device=dev)
    vmin, span = clahe.value_range(x)
    with pytest.raises(ValueError):
        cuda_clahe.tile_histograms(x.double(), vmin, span)
    with pytest.raises(ValueError):
        cuda_clahe.blend(x, vmin, span, torch.zeros(2, 64, 128, device=dev))
    with pytest.raises(ValueError):
        cuda_clahe.equalize_adapthist_batch(torch.randn(1, 4, 64,
                                                        device=dev))


BIG_PLANE = (1, 32769, 32768)   # 2^30 + 32768 values, 4 GiB in f32


def test_planes_past_2_to_the_30_on_the_stream_routes(dev):
    """K3, K5 and K6 compute one whole-mosaic plane of 2^30 + 32768 values
    on their stream routes (64-bit in-plane indices), counted there: K3 and
    K6 bit-equal to their plain versions, K5 by cuda_stats.stats_mismatch
    (the mosaic chain's three sigma pairs)."""
    x = cs.mosaic_plane(torch, None, BIG_PLANE)
    assert x[0].numel() > 2 ** 30
    vlims = torch.stack(zscale_limits(x), dim=1)
    k3 = cuda_preproc.zscale_minmax
    before = k3.stream_launches
    out, zlims = k3(x, vlims)
    torch.cuda.synchronize()
    assert k3.stream_launches == before + 1
    ref_out, ref_zlims = cuda_preproc.zscale_minmax_plain(x, vlims)
    assert torch.equal(zlims, ref_zlims)
    assert torch.equal(out, ref_out)
    del out, ref_out
    for sig in cs.MOSAIC_SIGMAS:
        cs.parity_stats(torch, x, sig, "stream", cuda_stats.CLUSTER)
    k6 = cuda_histeq.equalize_hist_batch
    before = k6.stream_launches
    got = k6(x)
    torch.cuda.synchronize()
    assert k6.stream_launches == before + 1
    ref = equalize_hist(x)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())
    del x, got, ref
    torch.cuda.empty_cache()


@pytest.mark.parametrize("kernel", ["zscale_minmax", "clip_stats",
                                    "equalize_hist_batch"])
def test_planes_past_int32_counts_are_refused(dev, kernel):
    """K3, K5 and K6 count a plane's values in int32, as the JAX functions
    do: a plane of more than cuda_build.MAX_PLANE = 2^31 - 1 values is
    refused before any launch (an expanded view, so nothing is
    allocated)."""
    from caesar_yolo_tpu_torch import cuda_build
    assert cuda_build.MAX_PLANE == 2 ** 31 - 1
    wide = torch.zeros(1, 1, 1, device=dev).expand(1, 65536, 32768)
    assert wide[0].numel() == cuda_build.MAX_PLANE + 1
    fn, args = {
        "zscale_minmax": (cuda_preproc.zscale_minmax,
                          (torch.zeros(1, 2, device=dev),)),
        "clip_stats": (cuda_stats.clip_stats, (3.0, 3.0)),
        "equalize_hist_batch": (cuda_histeq.equalize_hist_batch, ())}[kernel]
    before = fn.launches
    with pytest.raises(ValueError, match="int32"):
        fn(wide, *args)
    assert fn.launches == before


# -- K9, the int8 conv --------------------------------------------------------


@pytest.mark.parametrize("act", [True, False], ids=["silu", "linear"])
@pytest.mark.parametrize("shape", cs.QCONV_SHAPES)
def test_qconv_kernel_bit_equal(dev, shape, act):
    """K9 against qconv_plain over its parity shapes and layouts: bit-equal,
    channels_last output in the input's dtype, one launch counted."""
    x, wq, ws, xs, bias = cs.qconv_case(torch, shape, dev, sum(shape[:7]))
    k, stride = shape[5], shape[6]
    n0 = cuda_qconv.qconv.launches
    got = cuda_qconv.qconv(x, wq, ws, xs, bias, stride, k // 2, act)
    torch.cuda.synchronize()
    assert cuda_qconv.qconv.launches == n0 + 1
    assert got.dtype == x.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = cuda_qconv.qconv_plain(x, wq, ws, xs, bias, stride, k // 2, act)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", cs.QCONV_SHAPES)
def test_qconv_quantize_pass_equals_plain(dev, shape):
    """K9's quantize pass: the padded int8 copy [B, H, W, Cp] equals
    quantize_padded_plain's (quantize_input's values, channels from cin on
    0) in every layout the model hands over."""
    x, wq, ws, xs, bias = cs.qconv_case(torch, shape, dev, sum(shape[:7]))
    got = cuda_qconv.quantize_padded(x, xs)
    torch.cuda.synchronize()
    ref = cuda_qconv.quantize_padded_plain(x, xs)
    assert got.shape == ref.shape and got.shape[-1] % 16 == 0
    assert torch.equal(got, ref)
    assert torch.equal(cuda_qconv.pack_weights(wq).cpu(),
                       cuda_qconv.pack_weights(wq.cpu()))


def test_qconv_kernel_refuses_what_it_does_not_take(dev):
    shape = (1, 8, 8, 6, 6, 3, 1, "float32", "channels_last")
    x, wq, ws, xs, bias = cs.qconv_case(torch, shape, dev, 0)
    n0 = cuda_qconv.qconv.launches
    for kw in (dict(wq=wq.contiguous()), dict(stride=3), dict(pad=0),
               dict(x=x.half()), dict(xs=xs.cpu()),
               dict(wp=cuda_qconv.pack_weights(wq)[:, :, :, :8])):
        args = dict(x=x, wq=wq, ws=ws, xs=xs, b=bias, stride=1, pad=1,
                    act=True)
        args.update(kw)
        with pytest.raises(ValueError):
            cuda_qconv.qconv(**args)
    assert cuda_qconv.qconv.launches == n0


def test_qconv_model_forward_on_the_kernel(dev, monkeypatch):
    """A quantized yolov8n on the card: every int8 conv of a forward
    launches K9 once, and the raw outputs equal the forward with the
    plain version in its place."""
    from caesar_yolo_tpu_torch.detect.predictor import prepare_model
    from caesar_yolo_tpu_torch.models import quant
    from caesar_yolo_tpu_torch.models.layers import Conv
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights

    model = init_weights(build_model("yolov8n"), seed=0)
    x = torch.rand((4, 3, 128, 128), generator=torch.Generator()
                   .manual_seed(0)).to(dev, torch.bfloat16).contiguous(
                       memory_format=torch.channels_last)
    qm = prepare_model(quant.quantize_model(model, [x]),
                       dtype=torch.bfloat16, device=dev)
    n_int8 = sum(isinstance(m, Conv) and m.wq is not None
                 for m in qm.modules())
    n0 = cuda_qconv.qconv.launches
    with torch.inference_mode():
        got = qm(x)
        torch.cuda.synchronize()
        assert cuda_qconv.qconv.launches == n0 + n_int8 > 30
        monkeypatch.setattr(cuda_qconv, "qconv", cuda_qconv.qconv_plain)
        ref = qm(x)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert torch.equal(a, b)


# -- K10, the bf16 conv epilogue ----------------------------------------------


@pytest.mark.parametrize("scaled", [False, True], ids=["bias", "bn_scale"])
@pytest.mark.parametrize("act", [True, False], ids=["silu", "linear"])
@pytest.mark.parametrize("c", [3, 16, 80, 131, 256])
def test_conv_epilogue_kernel_bit_equal(dev, c, act, scaled):
    """K10 against epilogue_plain at odd H and W: bit-equal, channels_last
    bf16 out, one launch counted; an NCHW input is read as channels_last."""
    g = torch.Generator().manual_seed(c + 2 * act + scaled)
    y = (torch.randn((3, c, 7, 9), generator=g)
         * torch.rand((1, c, 1, 1), generator=g) * 40).to(dev)
    shift = torch.randn(c, generator=g).to(dev)
    scale = (torch.rand(c, generator=g) * 3).to(dev) if scaled else None
    ref = cuda_epilogue.epilogue_plain(y, scale, shift, act)
    for inp in (y.contiguous(memory_format=torch.channels_last), y):
        n0 = cuda_epilogue.conv_epilogue.launches
        got = cuda_epilogue.conv_epilogue(inp, scale, shift, act)
        torch.cuda.synchronize()
        assert cuda_epilogue.conv_epilogue.launches == n0 + 1
        assert got.dtype == torch.bfloat16
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, ref)


def test_conv_epilogue_refuses_what_it_does_not_take(dev):
    y = torch.zeros((1, 8, 4, 4), device=dev)
    shift = torch.zeros(8, device=dev)
    n0 = cuda_epilogue.conv_epilogue.launches
    for args in ((y.bfloat16(), None, shift), (y, None, shift[:4]),
                 (y, shift.double(), shift), (y, None, shift.cpu())):
        with pytest.raises(ValueError):
            cuda_epilogue.conv_epilogue(*args, True)
    assert cuda_epilogue.conv_epilogue.launches == n0


def test_bf16_model_forward_on_the_epilogue_kernel(dev, monkeypatch):
    """A bf16 yolov8n forward on the card: every Conv and Conv2dRaw
    launches K10 once, and the raw outputs equal the forward with the
    plain epilogue in its place."""
    from caesar_yolo_tpu_torch.detect.predictor import prepare_model
    from caesar_yolo_tpu_torch.models.layers import Conv, Conv2dRaw
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights

    model = prepare_model(init_weights(build_model("yolov8n"), seed=0),
                          dtype=torch.bfloat16, device=dev)
    n_conv = sum(isinstance(m, (Conv, Conv2dRaw)) for m in model.modules())
    x = torch.rand((2, 3, 128, 128), generator=torch.Generator()
                   .manual_seed(0)).to(dev, torch.bfloat16).contiguous(
                       memory_format=torch.channels_last)
    n0 = cuda_epilogue.conv_epilogue.launches
    with torch.inference_mode():
        got = model(x)
        torch.cuda.synchronize()
        assert cuda_epilogue.conv_epilogue.launches == n0 + n_conv > 50
        monkeypatch.setattr(cuda_epilogue, "conv_epilogue",
                            cuda_epilogue.epilogue_plain)
        ref = model(x)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,pipe", [
    ("yolov8n", dict(zscale_stretch=True, normalize_minmax=True)),
    ("yolo11n", dict(subtract_bkg=True, chan3_preproc=True,
                     normalize_minmax=True)),
    ("yolov8n", "clahe")])
def test_exported_artifact_equals_the_live_engine(dev, arch, pipe):
    """A bf16 CUDA artifact of the tile step (deploy.export_detector) run
    after a load equals the live TileEngine on the same tiles bit for bit,
    and launches the kernels of its path inside the artifact: K1, K4 and
    K10 always, K3 with the README chain, K2 in yolo11, K5 and K6 with the
    chan3 chain, K7 with an adaptive hist-eq pipeline ("clahe")."""
    from caesar_yolo_tpu_torch.deploy import export_detector, load_detector
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops.transforms import (
        Pipeline, build_preprocessor, hist_equalizer)
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine

    def preprocessor():
        if pipe == "clahe":
            return Pipeline([hist_equalizer(adaptive=True)])
        return build_preprocessor(**pipe)

    model = init_weights(build_model(arch), seed=0)
    kw = dict(img_size=128, score_thr=1e-3, max_det=50)
    tiles = np.random.default_rng(3).random((4, 128, 128, 1), np.float32)
    tiles[1] = 0.0
    ref = TileEngine(model, preprocessor=preprocessor(), **kw).process(tiles)
    det = load_detector(export_detector(
        model, preprocessor=preprocessor(),
        tile_shape=tiles.shape[1:], batch=len(tiles), **kw))
    counters = (cuda_nms.nms_suppress, cuda_upsample.upsample2x_forward,
                cuda_epilogue.conv_epilogue, cuda_preproc.zscale_minmax,
                cuda_attn.attention, cuda_stats.clip_stats,
                cuda_histeq.equalize_hist_batch,
                cuda_clahe.equalize_adapthist_batch)
    n0 = [c.launches for c in counters]
    got = [t.cpu().numpy() for t in det(tiles)]
    n = dict(zip(("nms", "upsample", "epilogue", "preproc", "attn", "stats",
                  "histeq", "clahe"),
                 (c.launches - a for c, a in zip(counters, n0))))
    assert n["nms"] == 1 and n["upsample"] == 2 and n["epilogue"] > 50
    assert n["preproc"] == ("zscale_stretch" in pipe)
    assert n["attn"] == (arch == "yolo11n")
    assert (n["stats"], n["histeq"]) == ((3, 1) if "chan3_preproc" in pipe
                                         else (0, 0))
    assert n["clahe"] == (pipe == "clahe")
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)


@pytest.mark.parametrize("devices", ["cuda", "cpu"])
def test_device_starved_on_the_card_only(dev, tmp_path, devices):
    """cli.run tiled over a 512 px mosaic (64 tiles of 96 px at step 0.75,
    nine shapes, 13 batches of up to 8): on the card the report carries `engine.device_starved`, the
    stream's idle time between consecutive batches on the device's clock,
    never negative and within the detection span; on the CPU it is
    absent."""
    import os

    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits
    from caesar_yolo_tpu_torch.utils.trace import DEVICE_STARVED

    path = str(tmp_path / "m.fits")
    write_mosaic_fits(path, 512, 512, n_sources=30, seed=1)
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "yolov8n_synth96.npz")
    rc, sf = cli_run.run([
        f"--image={path}", f"--weights={weights}", "--imgsize=96",
        "--scoreThr=0.3", "--preprocessing", "--normalize_minmax",
        "--split_img_in_tiles", "--tile_xsize=96", "--tile_ysize=96",
        "--tile_xstep=0.75", "--tile_ystep=0.75", "--batch_size=8",
        f"--detect_outfile_json={tmp_path}/c.json",
        f"--detect_outfile={tmp_path}/c.reg",
        f"--spool_path={tmp_path}/spool.jsonl", f"--devices={devices}"])
    assert rc == 0
    phases = sf.report.phase_times
    assert len({s.batch for s in sf.report.spans
                if s.name == "sfinder.drain"}) == 13
    if devices == "cpu":
        assert DEVICE_STARVED not in phases
    else:
        assert 0.0 <= phases[DEVICE_STARVED] <= phases["detect"]


# -- the tile step as a CUDA graph (parallel/engine.py) -----------------------

GRAPH_KW = dict(img_size=128, score_thr=1e-3, max_det=50)
GRAPH_CHAINS = {
    "readme-yolo11n": ("yolo11n", dict(zscale_stretch=True,
                                       normalize_minmax=True), False),
    "bkg-chan3-yolov8n": ("yolov8n", dict(
        subtract_bkg=True, chan3_preproc=True, sigma_clip_baseline=0.0,
        sigma_clip_low=1.0, sigma_clip_up=20.0, normalize_minmax=True,
        norm_min=0.0, norm_max=255.0), False),
    "int8-readme-yolov8n": ("yolov8n", dict(zscale_stretch=True,
                                            normalize_minmax=True), True),
}
# a mosaic's batches: four of the main shape, then three edge shapes once
GRAPH_BATCHES = [(128, 128)] * 4 + [(128, 96), (96, 128), (96, 96)]


def _graph_engine(dev, chain, seed=0, preprocessor=None):
    """(TileEngine with a Recorder, a factory of the model) for a chain of
    GRAPH_CHAINS; `preprocessor` replaces the chain's."""
    from caesar_yolo_tpu_torch.models import quant
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.utils.trace import Recorder

    arch, pipe, int8 = GRAPH_CHAINS[chain]

    def model_of(s):
        model = init_weights(build_model(arch), seed=s)
        if not int8:
            return model
        x = torch.rand((4, 3, 128, 128), generator=torch.Generator()
                       .manual_seed(s)).to(dev, torch.bfloat16).contiguous(
                           memory_format=torch.channels_last)
        return quant.quantize_model(model, [x])

    engine = TileEngine(model_of(seed),
                        preprocessor=preprocessor or build_preprocessor(
                            **pipe), **GRAPH_KW)
    engine.recorder = Recorder()
    return engine, model_of


def _mosaic_batch(dev, mosaic_dev, k, shape, b=4):
    """Batch k's origins (distinct for every k) and its windows cut on
    the device apart from the engine."""
    h, w = shape
    H, W = mosaic_dev.shape
    rng = np.random.default_rng(k)
    origins = np.stack([rng.integers(0, H - h + 1, b),
                        rng.integers(0, W - w + 1, b)], axis=1)
    tiles = torch.stack([mosaic_dev[r:r + h, c:c + w]
                         for r, c in origins])[..., None]
    return origins, tiles


def _eager_step(engine):
    from caesar_yolo_tpu_torch.parallel.engine import make_tile_step
    return make_tile_step(engine.model, preprocessor=engine.preprocessor,
                          **GRAPH_KW)


def _assert_bit_equal(got, ref):
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g.contiguous().view(torch.uint8),
                           r.contiguous().view(torch.uint8))


@pytest.mark.parametrize("chain", list(GRAPH_CHAINS))
def test_replayed_tile_step_equals_the_eager_step(dev, chain):
    """Over a mosaic of four tile shapes (four batches of the main one),
    every batch's outputs equal make_tile_step's eager outputs bit for
    bit: the main shape's first batch eager, the second captured, the
    rest replayed, the edge shapes eager.  Three batches dispatched before
    any drain each keep their own outputs; a replayed batch waits on the
    host nowhere (sync debug mode "error"); nothing falls back."""
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    engine, _ = _graph_engine(dev, chain)
    step = _eager_step(engine)
    mosaic = engine.put_mosaic(make_mosaic(320, 320, n_sources=12, seed=3)[0])
    with torch.inference_mode():
        for k, shape in enumerate(GRAPH_BATCHES):
            origins, tiles = _mosaic_batch(dev, mosaic, k, shape)
            got = engine.process_mosaic_async(mosaic, origins, shape)
            _assert_bit_equal(got, step(tiles))
        # three in flight, then drained
        batches = [_mosaic_batch(dev, mosaic, 10 + k, GRAPH_BATCHES[0])
                   for k in range(3)]
        outs = [engine.process_mosaic_async(mosaic, o, GRAPH_BATCHES[0])
                for o, _ in batches]
        for (_, tiles), got in zip(batches, outs):
            _assert_bit_equal(got, step(tiles))
        origins, tiles = _mosaic_batch(dev, mosaic, 20, GRAPH_BATCHES[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = engine.process_mosaic_async(mosaic, origins,
                                              GRAPH_BATCHES[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _assert_bit_equal(got, step(tiles))
    c = engine.recorder.counters
    assert c.get("engine.graph_fallbacks", 0) == 0
    assert c["engine.graph_captures"] == 1
    assert c["engine.graph_replays"] == 3 + 3 + 1
    assert c["engine.eager_batches"] == 4


def test_replayed_tile_step_follows_update_params(dev):
    """update_params drops the graphs: the next batches of the shape run
    eagerly, are captured again and replayed on the new weights, equal to
    the eager step of the new model; process_async's staged batches take
    the same graphs' path."""
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    engine, model_of = _graph_engine(dev, "readme-yolo11n")
    new_model = model_of(0)
    with torch.no_grad():       # new weights that move every output
        g = torch.Generator().manual_seed(1)
        for p in new_model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    mosaic = make_mosaic(320, 320, n_sources=12, seed=4)[0]
    tiles = [np.stack([mosaic[8 * k:8 * k + 128, 16 * j:16 * j + 128]
                       for j in range(4)])[..., None] for k in range(6)]
    with torch.inference_mode():
        old_step = _eager_step(engine)
        for t in tiles[:3]:
            got = engine.process_async(t)
            _assert_bit_equal(got, old_step(engine.put_tiles(t)))
        engine.update_params(new_model)
        step = _eager_step(engine)
        for t in tiles[3:]:
            got = engine.process_async(t)
            _assert_bit_equal(got, step(engine.put_tiles(t)))
        old = old_step(engine.put_tiles(t))
        assert not all(torch.equal(g, o) for g, o in zip(got, old))
    c = engine.recorder.counters
    assert (c["engine.graph_captures"], c["engine.graph_replays"],
            c["engine.eager_batches"]) == (2, 4, 2)


def test_graphs_of_two_engines_share_a_pool_and_keep_their_outputs(dev):
    """Two live engines whose graphs share the device's memory pool,
    their batches interleaved and three in flight before any is read:
    every batch equals its engine's eager step bit for bit, also after a
    third engine's capture into the same pool."""
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    engines = [_graph_engine(dev, c)[0]
               for c in ("readme-yolo11n", "bkg-chan3-yolov8n")]
    steps = [_eager_step(e) for e in engines]
    mosaic = make_mosaic(320, 320, n_sources=12, seed=7)[0]
    mosaics = [e.put_mosaic(mosaic) for e in engines]
    shape = GRAPH_BATCHES[0]
    with torch.inference_mode():
        for k in range(6):
            batches = [(j, *_mosaic_batch(dev, mosaics[j], 3 * k + i, shape))
                       for i, j in enumerate((k % 2, 1 - k % 2, k % 2))]
            outs = [engines[j].process_mosaic_async(mosaics[j], o, shape)
                    for j, o, _ in batches]
            for (j, _, tiles), got in zip(batches, outs):
                _assert_bit_equal(got, steps[j](tiles))
        third, _ = _graph_engine(dev, "readme-yolo11n")
        for k in range(3):
            third.process_mosaic_async(mosaics[0], _mosaic_batch(
                dev, mosaics[0], 40 + k, shape)[0], shape)
        for j in (0, 1):
            origins, tiles = _mosaic_batch(dev, mosaics[j], 50 + j, shape)
            _assert_bit_equal(engines[j].process_mosaic_async(
                mosaics[j], origins, shape), steps[j](tiles))
    for e in engines + [third]:
        assert e.recorder.counters["engine.graph_captures"] == 1


def test_graph_memory_stays_flat_over_engines(dev):
    """An engine a field, each capturing its step and then dropped: from
    the third on, memory reserved does not grow (a capture that finds no
    live graph frees the dead graphs' pool before it makes its own)."""
    import gc

    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    mosaic = make_mosaic(320, 320, n_sources=12, seed=8)[0]
    shape, reserved = GRAPH_BATCHES[0], []
    with torch.inference_mode():
        for f in range(6):
            engine, _ = _graph_engine(dev, "readme-yolo11n")
            mos = engine.put_mosaic(mosaic)
            for k in range(3):
                engine.process_mosaic_async(mos, _mosaic_batch(
                    dev, mos, k, shape)[0], shape)
            assert engine.recorder.counters["engine.graph_captures"] == 1
            del engine, mos
            gc.collect()
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(dev))
    assert max(reserved[2:]) == reserved[2], reserved


def test_no_graph_outlives_its_engine(dev):
    """The engine module keeps no graph alive: once an engine is gone, its
    graphs and their memory pool are free (torch.cuda.empty_cache returns
    the pool to the device)."""
    import gc
    import weakref

    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    engine, _ = _graph_engine(dev, "readme-yolo11n")
    mos = engine.put_mosaic(make_mosaic(320, 320, n_sources=12, seed=9)[0])
    shape = GRAPH_BATCHES[0]
    with torch.inference_mode():
        for k in range(3):
            engine.process_mosaic_async(mos, _mosaic_batch(
                dev, mos, k, shape)[0], shape)
    graphs = [weakref.ref(g) for g in engine._graphs.values()
              if not isinstance(g, str)]
    assert len(graphs) == 1
    del engine, mos
    gc.collect()
    assert graphs[0]() is None


def test_a_wrapper_swapped_in_runs_once_update_params_drops_graphs(dev):
    """A replay calls no Python wrapper: a kernel wrapper swapped in after
    a shape's graph was captured is bypassed while the graph lives, and
    runs on the next batch once update_params has dropped the graphs (as
    chip_smoke.py's K10 parity and K4 A/B phases do)."""
    engine, model_of = _graph_engine(dev, "readme-yolo11n")
    kernel, calls = cuda_epilogue.conv_epilogue, []

    def counting(*args):
        calls.append(1)
        return kernel(*args)

    tiles = np.random.default_rng(0).random((4, 128, 128, 1), np.float32)
    with torch.inference_mode():
        for _ in range(3):          # eager, captured, replayed
            engine.process_async(tiles)
        counting.launches = kernel.launches
        cuda_epilogue.conv_epilogue = counting
        try:
            engine.process_async(tiles)
            replayed = len(calls)
            engine.update_params(model_of(0))
            engine.process_async(tiles)
        finally:
            cuda_epilogue.conv_epilogue = kernel
            kernel.launches = counting.launches
    torch.cuda.synchronize()
    assert replayed == 0 and len(calls) > 50


@pytest.mark.parametrize("chain", ["readme-yolo11n", "bkg-chan3-yolov8n"])
def test_graph_counters_and_launch_counters(dev, chain):
    """The first batch of a shape runs eagerly, the second is captured,
    every later one replayed, a shape seen once is never captured; and the
    launch counters the benchmark holds to the device trace (K10's, K3's
    cluster route, K5's) advance by the same amount in every batch of the
    main shape, replayed or eager."""
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    engine, _ = _graph_engine(dev, chain)
    mosaic = engine.put_mosaic(make_mosaic(320, 320, n_sources=12, seed=5)[0])
    counters = ((cuda_epilogue.conv_epilogue, "launches"),
                (cuda_preproc.zscale_minmax, "cluster_launches"),
                (cuda_stats.clip_stats, "launches"))
    rec = engine.recorder
    runs, advances = [], []
    with torch.inference_mode():
        for k, shape in enumerate(GRAPH_BATCHES):
            before = [getattr(f, a) for f, a in counters]
            seen = dict(rec.counters)
            engine.process_mosaic_async(mosaic, _mosaic_batch(
                dev, mosaic, k, shape)[0], shape)
            advances.append([getattr(f, a) - n
                             for (f, a), n in zip(counters, before)])
            runs.append(tuple(sorted(
                n for n, v in rec.counters.items() if v != seen.get(n, 0))))
    torch.cuda.synchronize()
    eager, capture = ("engine.eager_batches",), ("engine.graph_captures",
                                                "engine.graph_replays")
    assert runs == [eager, capture, ("engine.graph_replays",),
                    ("engine.graph_replays",), eager, eager, eager]
    main = advances[:4]
    assert all(a == main[0] for a in main) and main[0][0] > 50
    assert (main[0][1] > 0) == (chain == "readme-yolo11n")
    assert (main[0][2] > 0) == (chain == "bkg-chan3-yolov8n")


def test_graph_fallback_of_a_step_that_waits_on_the_host(dev, monkeypatch):
    """A chain with a stage that reads a value on the host cannot be
    captured: the engine counts one fallback, warns once, and runs every
    batch of that shape eagerly with the eager step's outputs; the launch
    counters keep no trace of the failed capture."""
    from caesar_yolo_tpu_torch.ops.transforms import (Pipeline, _ones,
                                                      _stage)
    from caesar_yolo_tpu_torch.parallel import engine as engine_mod
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning",
                        lambda msg, *args: warned.append(msg % args))

    def host_read(data):
        return data * float(data.amax().item() > 0), _ones(data)

    pre = Pipeline([_stage(host_read, uniform=True)])
    engine, _ = _graph_engine(dev, "readme-yolo11n", preprocessor=pre)
    step = _eager_step(engine)
    mosaic = engine.put_mosaic(make_mosaic(320, 320, n_sources=12, seed=6)[0])
    with torch.inference_mode():
        for k in range(4):
            origins, tiles = _mosaic_batch(dev, mosaic, k, (128, 128))
            n0 = cuda_epilogue.conv_epilogue.launches
            got = engine.process_mosaic_async(mosaic, origins, (128, 128))
            n1 = cuda_epilogue.conv_epilogue.launches
            _assert_bit_equal(got, step(tiles))
            # the engine's batch counted what one eager step counts
            assert n1 - n0 == cuda_epilogue.conv_epilogue.launches - n1 > 0
    c = engine.recorder.counters
    assert c["engine.graph_fallbacks"] == 1 and c["engine.eager_batches"] == 4
    assert "engine.graph_replays" not in c
    assert len(warned) == 1 and "cannot be captured" in warned[0]


# -- YOLO12's area attention (models/layers.py AAttn, A2C2f) -----------------

# bf16 A2C2f stage outputs of yolo12l against its f32 forward (TF32 off), as
# the relative L2 distance of each stage's output.  Each bf16 conv rounds
# its f32 result once (2^-9 relative at most, about 2^-10 on average) and
# the attention rounds its probabilities and output; through the layers
# before the two stages, with residuals that add the rounded branches,
# the H100 measured 0.00717 (layer 6) and 0.00724 (layer 8) on this input;
# the limit leaves room for other seeds and inputs and stays within about
# five bf16 ulps (2^-8 each) of the whole output.
STAGE_REL_L2 = 0.02


def _yolo12l(dev):
    """yolo12l with seeded random weights, random BatchNorm statistics and
    layer scales ~ U(0.5, 1.5), f32 on `dev`."""
    from caesar_yolo_tpu_torch.models.layers import A2C2f, BatchNorm
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    model = init_weights(build_model("yolo12l"), seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.gamma.copy_(0.5 + torch.rand(m.gamma.shape, generator=g))
                m.beta.copy_(torch.rand(m.beta.shape, generator=g) - 0.5)
                m.mean.copy_(0.2 * torch.rand(m.mean.shape, generator=g)
                             - 0.1)
                m.var.copy_(0.5 + torch.rand(m.var.shape, generator=g))
            if isinstance(m, A2C2f) and m.gamma is not None:
                m.gamma.copy_(0.5 + torch.rand(m.gamma.shape, generator=g))
    return model.to(dev).eval()


def _stage_outputs(model, x):
    """{stage name: output} of yolo12l's two area-attention stages."""
    got = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, inp, out, n=n: got.__setitem__(n, out.float()))
        for n in ("a2c2f_1", "a2c2f_2")]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return got


def test_a2c2f_stages_of_the_bf16_engine_match_f32(dev):
    """yolo12l at 640 px, batch 32: the outputs of layers 6 (area 4) and 8
    (area 1) of the engine's bf16 model (BatchNorm folded, channels_last,
    K2 and K10) against the f32 forward of the same weights with TF32
    off, computed in blocks of 8 images, within STAGE_REL_L2."""
    from caesar_yolo_tpu_torch.detect.predictor import prepare_model
    from caesar_yolo_tpu_torch.models import layers
    from caesar_yolo_tpu_torch.utils.device import exact_f32

    model = _yolo12l(dev)
    x = torch.rand((32, 3, 640, 640), generator=torch.Generator()
                   .manual_seed(2)).to(dev)
    ref = {}
    with exact_f32():
        for i in range(0, 32, 8):
            for k, v in _stage_outputs(model, x[i:i + 8]).items():
                ref.setdefault(k, []).append(v)
    ref = {k: torch.cat(v) for k, v in ref.items()}
    engine_model = prepare_model(model, dtype=torch.bfloat16, device=dev)
    fused = layers.area_attention.fused
    got = _stage_outputs(engine_model, x.bfloat16().contiguous(
        memory_format=torch.channels_last))
    assert layers.area_attention.fused - fused == 16
    for k in ref:
        dist = float((got[k] - ref[k]).norm() / ref[k].norm())
        assert dist <= STAGE_REL_L2, (k, dist)


def test_area_attention_outside_the_gate_counts_plain(dev):
    """A strip length the reference's gate refuses (9 positions) takes the
    plain path on the card and is counted so; one it takes (16) launches
    K2 and is counted as fused."""
    from caesar_yolo_tpu_torch.models import layers
    attn = layers.AAttn(64, 2, 4).to(dev).eval()
    for p in attn.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1)
    for hw, fused, plain in ((6, 0, 1), (8, 1, 0)):
        before = layers.area_attn_counts()
        k2 = cuda_attn.attention.launches
        with torch.no_grad():
            attn(torch.randn(2, 64, hw, hw, device=dev))
        after = layers.area_attn_counts()
        assert after[layers.AREA_ATTN_FUSED] - before[
            layers.AREA_ATTN_FUSED] == fused
        assert after[layers.AREA_ATTN_PLAIN] - before[
            layers.AREA_ATTN_PLAIN] == plain
        assert cuda_attn.attention.launches - k2 == fused


def test_yolo12l_tile_step_replays_with_area_attention(dev):
    """chip_smoke's yolo12 phase: K2 at yolo12l's shapes, forward and
    backward, and yolo12l's 640 px tile step captured and replayed with
    no fallback and 16 K2 launches a forward, the replay's counted."""
    cs.phase_yolo12(torch)
