"""The port's training slice against the JAX package on the CPU: loss and
assigner, train-mode BatchNorm and precise-BN, the optimizer's schedules,
three trainer steps of yolo11n, one bf16 step, resume, remat, the dataset
and the training CLI.  Weights cross through the npz round trip
(models/convert); inputs are seeded numpy arrays handed to both."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.models import layers as jlayers
from caesar_yolo_tpu.models.convert import _flatten as jax_flatten
from caesar_yolo_tpu.models.yolo import build_model as jax_build_model
from caesar_yolo_tpu.models.yolo import init_params
from caesar_yolo_tpu.train import TrainConfig as JaxTrainConfig
from caesar_yolo_tpu.train import Trainer as JaxTrainer
from caesar_yolo_tpu.train import loss as jloss
from caesar_yolo_tpu_torch.models import layers
from caesar_yolo_tpu_torch.models.convert import flat_params, load_jax_params
from caesar_yolo_tpu_torch.models.yolo import build_model
from caesar_yolo_tpu_torch.train import loss as tloss
from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

SLICE = dict(model="yolo11n", size=128, batch=2, steps=3)


def _params(name, seed=0):
    jm = jax_build_model(name)
    return jm, jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda: init_params(jm, seed))())


def _batches(n, bsz, size, seed=0):
    """Seeded (images, labels, boxes, mask) batches with 1-3 gt boxes of
    16-60 px per image (above the loss's bootstrap floor)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        imgs = rng.random((bsz, size, size, 3), dtype=np.float32)
        m = 4
        xy = rng.random((bsz, m, 2)) * (size - 64) + 2
        boxes = np.concatenate([xy, xy + rng.uniform(16, 60, (bsz, m, 2))],
                               -1).astype(np.float32)
        mask = np.arange(m)[None] < rng.integers(1, 4, (bsz, 1))
        labels = rng.integers(0, 5, (bsz, m)).astype(np.int32)
        out.append((imgs, labels, boxes * mask[..., None], mask))
    return out


def _leaf_tol(ref, init):
    """Per-leaf tolerance of a trained parameter: 2% of the leaf's own
    motion plus 4 f32 ulps of its magnitude plus 1e-9.  Gradients at equal
    weights agree within ~4e-5 (f32 sums in another order); a step then
    leaves ulp-level differences in the weights, which the next gradient
    of this tiny batch (BatchNorm over 4x4 maps at stride 32) amplifies.
    The 1e-9 covers leaves whose exact gradient is zero (a BN shift
    followed by another BN): theirs is f32 noise of ~1e-8, times lr."""
    motion = np.abs(ref - init).max()
    return (2e-2 * motion + 4 * np.spacing(np.float32(np.abs(ref).max()))
            + 1e-9)


# -- loss and assigner ------------------------------------------------------

def _raw_pair(seed, size=64, b=2, nc=5):
    rng = np.random.default_rng(seed)
    raw = []
    for s in (8, 16, 32):
        n = size // s
        raw.append((rng.standard_normal((b, n, n, 64)).astype(np.float32),
                    (rng.standard_normal((b, n, n, nc)) - 2).astype(
                        np.float32)))
    return raw


def _gt(b=2, m=4):
    labels = np.asarray([[1, 2, 0, 4], [3, 0, 0, 0]], np.int32)
    boxes = np.asarray([[[4, 6, 40, 44], [20, 18, 60, 58], [30, 2, 62, 30],
                         [0, 0, 0, 0]],
                        [[8, 8, 48, 40], [0, 0, 0, 0], [0, 0, 0, 0],
                         [0, 0, 0, 0]]], np.float32)
    mask = np.asarray([[1, 1, 1, 0], [1, 0, 0, 0]], bool)
    return labels, boxes, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_assigner_matches_jax(seed):
    """fg_mask and target labels equal, target boxes and scores within
    1e-6, on decoded random head outputs."""
    raw = _raw_pair(seed)
    gl, gb, mg = _gt()
    jd, jlog = jloss.flatten_raw([(jnp.asarray(a), jnp.asarray(c))
                                  for a, c in raw])
    td, tlog = tloss.flatten_raw([(torch.from_numpy(a).permute(0, 3, 1, 2),
                                   torch.from_numpy(c).permute(0, 3, 1, 2))
                                  for a, c in raw])
    from caesar_yolo_tpu.models.yolo import anchor_points, decode_dfl_window
    anchors, strides = anchor_points(64)
    jbox = decode_dfl_window(jd, anchors[None], strides[None])
    ref = jloss.task_aligned_assigner(
        jax.nn.sigmoid(jlog), jbox, anchors * strides, jnp.asarray(gl),
        jnp.asarray(gb), jnp.asarray(mg))
    tbox = torch.from_numpy(np.array(jbox))
    ta = torch.from_numpy(np.array(anchors * strides))
    got = tloss.task_aligned_assigner(
        torch.sigmoid(tlog), tbox, ta, torch.from_numpy(gl),
        torch.from_numpy(gb), torch.from_numpy(mg))
    fg = np.asarray(ref[3])
    assert fg.sum() > 0
    np.testing.assert_array_equal(got[3].numpy(), fg)
    np.testing.assert_array_equal(got[0].numpy()[fg], np.asarray(ref[0])[fg])
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_and_grad_match_jax(seed):
    """Total, parts and d(loss)/d(raw) within 1e-5 relative (f32 sums in
    another order)."""
    raw = _raw_pair(seed)
    gl, gb, mg = _gt()

    def jfn(r):
        return jloss.detection_loss(r, gl, gb, mg, img_size=64)

    (jt, jparts), jg = jax.value_and_grad(jfn, has_aux=True)(
        [(jnp.asarray(a), jnp.asarray(c)) for a, c in raw])
    traw = [(torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_(),
             torch.from_numpy(c).permute(0, 3, 1, 2).requires_grad_())
            for a, c in raw]
    tt, tparts = tloss.detection_loss(
        traw, torch.from_numpy(gl), torch.from_numpy(gb),
        torch.from_numpy(mg), img_size=64)
    tt.backward()
    assert tt.item() == pytest.approx(float(jt), rel=1e-5)
    for k in ("box", "cls", "dfl"):
        assert tparts[k].item() == pytest.approx(float(jparts[k]), rel=1e-5)
    for (ja, jc), (ta, tc) in zip(jg, traw):
        for j, t in ((ja, ta), (jc, tc)):
            j = np.asarray(j)
            got = t.grad.permute(0, 2, 3, 1).numpy()
            assert np.abs(got - j).max() <= 1e-5 * np.abs(j).max()


# -- train-mode BatchNorm ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_conv_bn_matches_jax(dtype):
    """A Conv block in train mode: batch-statistics BN (f32 mean, biased
    variance) and the recorded (mean, var), against the reference's
    train_mode.  f32 within 1e-5; bf16 (conv output rounded to bf16 by
    both, the BN epilogue in f32) within 2 bf16 ulps of the output scale
    and the statistics within 1e-2 relative."""
    rng = np.random.default_rng(0)
    jc = jlayers.Conv(8, 16, 3, 2)
    p = jax.tree_util.tree_map(np.asarray, jc.init(jax.random.PRNGKey(0)))
    p["bn"]["gamma"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    p["bn"]["beta"] = rng.uniform(-0.5, 0.5, 16).astype(np.float32)
    x = rng.standard_normal((2, 12, 12, 8)).astype(np.float32)
    stats = {}
    with jlayers.train_mode(stats):
        ref = np.asarray(jc(p, jnp.asarray(x, getattr(jnp, dtype))),
                         np.float32)
    (jmean, jvar), = stats.values()
    tc = layers.Conv(8, 16, 3, 2)
    tc.w.data = torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy())
    tc.bn.gamma.data = torch.from_numpy(p["bn"]["gamma"])
    tc.bn.beta.data = torch.from_numpy(p["bn"]["beta"])
    got_stats = {}
    with layers.train_mode(tc, got_stats):
        got = tc(torch.from_numpy(x).permute(0, 3, 1, 2).to(
            getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    (tmean, tvar), = got_stats.values()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-5, atol=0)
    else:
        assert np.abs(got - ref).max() <= 2 * 2 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(tvar.numpy(), jvar, rtol=1e-2, atol=0)
    assert not tc.train_mode and tc.bn_collect is None


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_precise_bn_matches_jax(compute_dtype):
    """calibrate_bn over two batches from the same weights writes the same
    running mean and variance into the weights and the EMA, yolo11n at
    64 px: within 5e-4 of each layer's largest statistic.  A mean near
    zero is a sum that cancels, and at stride 32 a statistic is taken over
    8 values at the end of ~70 layers of f32 rounding (found: 1.2e-4, in
    the stride-32 head).  The reference's precise-BN forward runs on its
    f32 images whatever the config's compute dtype (the model computes in
    its input's dtype), so a bfloat16 config must give the f32
    statistics too."""
    jm, params = _params("yolo11n")
    batches = [b[0] for b in _batches(2, 2, 64, seed=5)]
    jt = JaxTrainer(jm, params, JaxTrainConfig(img_size=64,
                                               compute_dtype=compute_dtype))
    jt.calibrate_bn(batches)
    tt = Trainer(load_jax_params(build_model("yolo11n"), params),
                 TrainConfig(img_size=64, compute_dtype=compute_dtype),
                 device="cpu")
    tt.calibrate_bn(batches)
    for tree, got in ((jt.state.params, tt.model.state_dict()),
                      (jt.state.ema_params, tt.ema)):
        ref = dict(jax_flatten(jax.device_get(tree)))
        got = flat_params(got)
        keys = [k for k in ref if k.endswith(("/mean", "/var"))]
        assert len(keys) > 100
        for k in keys:
            r = np.asarray(ref[k])
            np.testing.assert_allclose(got[k], r, rtol=0,
                                       atol=5e-4 * np.abs(r).max(), err_msg=k)


# -- optimizer --------------------------------------------------------------

def test_lr_and_momentum_per_step_match_optax():
    """lr and momentum at every step of warmup and decay equal the
    reference's optax schedules (evaluated on the optimizer's own 0-based
    count) bit for bit in f32."""
    from caesar_yolo_tpu.train.trainer import make_optimizer as jax_opt
    from caesar_yolo_tpu_torch.train.trainer import make_optimizer

    cfg = dict(epochs=3, warmup_epochs=1.5)
    tx, jlr = jax_opt(JaxTrainConfig(**cfg), 4)
    lr_fn, mom_fn = make_optimizer(TrainConfig(**cfg), 4)
    p = {"w": jnp.zeros(2)}
    state = tx.init(p)
    for step in range(14):
        _, state = tx.update({"w": jnp.ones(2)}, state, p)
        assert np.float32(jlr(jnp.int32(step))) == np.float32(lr_fn(step))
        assert (np.float32(state[2].hyperparams["decay"])
                == np.float32(mom_fn(step)))


def test_quality_recipe_schedules_match_jax_at_every_step():
    """The five-class quality recipe (scripts/torch_train_quality5.py:
    one epoch of 12000 steps, lrf 0.05, warmup 0.02 epochs = 240 steps):
    lr and momentum at every one of the 12000 steps equal the reference's
    schedules bit for bit in f32 (lr_fn, and the trace's injected momentum
    read from tx.update on a state at each count, vmapped, op by op as
    the existing 14-step test evaluates them), and so does the EMA decay's
    exponent -step / tau (trainer.py:175, the step after its increment).
    The decay d = ema_decay * (1 - exp(-step / tau)) and 1 - d equal the
    reference's wherever numpy's f32 exp and XLA's give the same value,
    and elsewhere differ by at most 2^-23 (an ulp of an exp in [0.5, 1)
    and d's own rounding): with the numpy and jax this was written
    against, the two libraries' f32 exp differ on 4745 of the 12000
    exponents (XLA's is not correctly rounded either), which moves d at
    1096 steps (relatively much at the first steps, where d is small and
    1 - exp cancels); the test asks only that they agree on most.  Jitted
    whole, the reference rewrites x / 240 as x * (1 / 240) and its lr
    differs from this eager evaluation at 2919 steps: the port matches
    the schedules' expressions as written, not a jitted training run's
    evaluation of them."""
    from caesar_yolo_tpu.train.trainer import make_optimizer as jax_opt
    from caesar_yolo_tpu_torch.train.trainer import (ema_decay_at,
                                                     make_optimizer)

    steps = 12000
    cfg = dict(epochs=1, batch_size=16, img_size=640, lr0=0.01, lrf=0.05,
               warmup_epochs=0.02, max_gt=4)
    jcfg = JaxTrainConfig(**cfg)
    tx, jlr = jax_opt(jcfg, steps)
    p = {"w": jnp.zeros(2)}
    init = tx.init(p)

    def momentum_at(count):
        state = jax.tree_util.tree_map(
            lambda leaf: count if leaf.dtype == jnp.int32 else leaf, init)
        _, state = tx.update({"w": jnp.ones(2)}, state, p)
        return state[2].hyperparams["decay"]

    count = jnp.arange(steps, dtype=jnp.int32)
    expo = -(count + 1) / jcfg.ema_tau
    d = jcfg.ema_decay * (1.0 - jnp.exp(expo))
    ref = [np.asarray(r, np.float32) for r in (
        jlr(count), jax.vmap(momentum_at)(count), d, 1.0 - d)]
    tcfg = TrainConfig(**cfg)
    lr_fn, mom_fn = make_optimizer(tcfg, steps)
    got = np.asarray([(lr_fn(i), mom_fn(i), *ema_decay_at(tcfg, i + 1))
                      for i in range(steps)], np.float32).T
    f32 = np.float32
    texpo = f32(-np.arange(1, steps + 1, dtype=f32)) / f32(tcfg.ema_tau)
    np.testing.assert_array_equal(texpo, np.asarray(expo, f32))
    same_exp = np.exp(texpo) == np.asarray(jnp.exp(expo), f32)
    assert same_exp.mean() > 0.5
    for i, name in enumerate(("lr", "momentum", "d", "1 - d")):
        g, r = got[i], ref[i]
        exact = np.ones(steps, bool) if i < 2 else same_exp
        np.testing.assert_array_equal(g[exact], r[exact], err_msg=name)
        assert np.abs(g.astype(np.float64) - r).max() <= 2.0 ** -23, name
    # the warmup ramps lr and momentum; then momentum holds, lr decays
    assert np.all(np.diff(ref[0][:240]) > 0) and np.all(ref[1][240:] ==
                                                        ref[1][240])
    assert np.all(np.diff(ref[0][240:]) < 0)


# -- the slice: three trainer steps ------------------------------------------

@pytest.fixture(scope="module")
def slice_runs():
    """The JAX Trainer and the port's Trainer, f32, from the same weights
    on the same three batches (one JAX compile for the module)."""
    name, size, bsz, steps = (SLICE[k] for k in ("model", "size", "batch",
                                                 "steps"))
    jm, params = _params(name)
    batches = _batches(steps, bsz, size)
    cfg = dict(epochs=2, batch_size=bsz, img_size=size, warmup_epochs=0.0,
               compute_dtype="float32")
    jt = JaxTrainer(jm, params, JaxTrainConfig(**cfg), steps_per_epoch=2)
    tt = Trainer(load_jax_params(build_model(name), params),
                 TrainConfig(**cfg), steps_per_epoch=2, device="cpu")
    losses = []
    for b in batches:
        jl, jp = jt.train_step(*b)
        tl, tp = tt.train_step(*b)
        losses.append(((float(jl), {k: float(v) for k, v in jp.items()}),
                       (float(tl), {k: float(v) for k, v in tp.items()})))
    return params, jt, tt, losses


def test_slice_losses_match_jax(slice_runs):
    """yolo11n at 128 px (C2PSA's N = 16 takes the fused attention), f32,
    batch 2: loss and its parts at each of 3 steps within 1e-4
    relative."""
    _, _, _, losses = slice_runs
    for (jl, jp), (tl, tp) in losses:
        assert tl == pytest.approx(jl, rel=1e-4)
        for k in jp:
            assert tp[k] == pytest.approx(jp[k], rel=1e-4)


def test_slice_weights_and_ema_match_jax(slice_runs):
    """After 3 steps every weight and EMA leaf, by the reference's param
    path, is within `_leaf_tol` of the JAX trainer's, and the weights
    moved."""
    params, jt, tt, _ = slice_runs
    init = dict(jax_flatten(params))
    moved = 0
    for tree, got in ((jt.state.params, tt.model.state_dict()),
                      (jt.state.ema_params, tt.ema)):
        ref = dict(jax_flatten(jax.device_get(tree)))
        got = flat_params(got)
        assert set(got) == set(ref)
        for k, r in ref.items():
            r = np.asarray(r)
            err = np.abs(got[k] - r).max()
            assert err <= _leaf_tol(r, init[k]), (k, err)
            moved += bool(np.abs(r - init[k]).max() > 0)
    assert moved > 200
    assert tt.step == int(jt.state.step) == SLICE["steps"]


def test_bf16_step_matches_jax_bf16():
    """One bf16 step (f32 master weights) of yolo11n at 128 px against the
    JAX trainer's bf16 step from the same weights, by a bf16 rule: the loss
    within 1e-2 relative, and the momentum trace after the step (the
    clipped gradient plus weight decay) over all conv weights no further
    from JAX's bf16 trace, in relative L2, than 1.5 times JAX's bf16 trace
    is from the f32 one.  bf16 rounding alone moves this random network's
    gradient by about half its norm in either framework (measured: 0.50
    JAX, 0.49 port, 0.52 between the two), so no elementwise bound
    holds; the port's f32 trace stands in for the f32 one (it is within
    4e-5 of JAX's)."""
    jm, params = _params("yolo11n")
    batch = _batches(1, 2, 128, seed=9)[0]
    cfg = dict(epochs=1, batch_size=2, img_size=128)
    jt = JaxTrainer(jm, params, JaxTrainConfig(**cfg), steps_per_epoch=2)
    traces, losses = [], []
    for dtype in ("bfloat16", "float32"):
        tt = Trainer(load_jax_params(build_model("yolo11n"), params),
                     TrainConfig(**cfg, compute_dtype=dtype),
                     steps_per_epoch=2, device="cpu")
        losses.append(tt.train_step(*batch)[0].item())
        traces.append(flat_params(tt.trace))
    jl, _ = jt.train_step(*batch)
    assert losses[0] == pytest.approx(float(jl), rel=1e-2)
    ref = dict(jax_flatten(jax.device_get(
        jt.state.opt_state[2].inner_state.trace)))
    keys = [k for k in ref if k.endswith("/w")]

    def dist(a, b):
        num = sum(np.sum((np.asarray(a[k]) - np.asarray(b[k])) ** 2)
                  for k in keys)
        return np.sqrt(num / sum(np.sum(np.asarray(b[k]) ** 2)
                                 for k in keys))

    assert dist(traces[0], ref) <= 1.5 * dist(ref, traces[1])


# -- resume, remat ------------------------------------------------------------

def test_resume_is_bit_exact(tmp_path):
    """Interrupt after 2 steps, save, restore into a fresh trainer and run
    2 more: weights, EMA and momentum trace equal the uninterrupted 4-step
    run bit for bit (warmup active, so the schedule position matters)."""
    from caesar_yolo_tpu_torch.models.yolo import init_weights
    batches = _batches(4, 2, 64, seed=2)
    cfg = TrainConfig(epochs=2, batch_size=2, img_size=64, lr0=1e-3,
                      warmup_epochs=1.0, compute_dtype="float32")

    def fresh():
        return Trainer(init_weights(build_model("yolov8n"), seed=1), cfg,
                       steps_per_epoch=2, device="cpu")

    straight = fresh()
    for b in batches:
        straight.train_step(*b)
    interrupted = fresh()
    for b in batches[:2]:
        interrupted.train_step(*b)
    interrupted.best_metric = 0.5
    path = interrupted.save_checkpoint(str(tmp_path), name="last")
    resumed = fresh()
    assert resumed.restore(path) == 2 and resumed.best_metric == 0.5
    for b in batches[2:]:
        resumed.train_step(*b)
    for a, b in ((resumed.model.state_dict(), straight.model.state_dict()),
                 (resumed.ema, straight.ema),
                 (resumed.trace, straight.trace)):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_remat_gives_the_same_gradients():
    """Checkpointing each layer recomputes the same forward: equal loss,
    equal gradients (within 1e-6 of each gradient's scale), and the BN
    collector holds one entry per BatchNorm either way."""
    from caesar_yolo_tpu_torch.models.yolo import init_weights
    model = init_weights(build_model("yolo11n"), seed=0)
    imgs, gl, gb, mg = _batches(1, 2, 64, seed=4)[0]
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    out = []
    for remat in (False, True):
        model.zero_grad()
        stats = {}
        with layers.train_mode(model, stats):
            loss, _ = tloss.detection_loss(
                model(x, remat=remat), torch.from_numpy(gl),
                torch.from_numpy(gb), torch.from_numpy(mg), img_size=64)
            loss.backward()
        out.append((loss.item(), len(stats),
                    {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l0, n0, g0), (l1, n1, g1) = out
    assert l0 == l1 and n0 == n1 == sum(
        isinstance(m, layers.BatchNorm) for m in model.modules())
    for k in g0:
        scale = g0[k].abs().max().item()
        assert (g0[k] - g1[k]).abs().max().item() <= 1e-6 * max(scale, 1e-30)


# -- dataset and CLI ------------------------------------------------------------

def _write_dataset(root, n=6, sizes=(40, 40, 40, 36, 40, 40), yaml_val=False):
    from caesar_yolo_tpu_torch.utils.fits import write_fits
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(n):
        s = sizes[i % len(sizes)]
        img, boxes = make_mosaic(s, s, n_sources=1 + i % 3, noise_sigma=0.05,
                                 seed=i, amp_range=(3.0, 8.0),
                                 sigma_range=(2.0, 4.0))
        write_fits(img, str(root / "images" / f"im{i}.fits"))
        rows = []
        for x1, y1, x2, y2 in np.clip(boxes, 0, s):
            rows.append(f"1 {(x1 + x2) / 2 / s:.6f} {(y1 + y2) / 2 / s:.6f} "
                        f"{(x2 - x1) / s:.6f} {(y2 - y1) / s:.6f}")
        (root / "labels" / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    spec = f"path: {root}\ntrain: images\n"
    if yaml_val:
        spec += "val: images\n"
    (root / "data.yaml").write_text(spec + "names:\n  0: spurious\n"
                                    "  1: compact\n")
    return str(root / "data.yaml")


@pytest.mark.parametrize("native", [False, True])
def test_dataset_batches_match_jax(tmp_path, native):
    """The same FITS directory gives the same batches, in the same order,
    as the JAX DetectionDataset (host or device letterbox, a reseeded
    epoch, mixed native shapes letterboxed on the host)."""
    from caesar_yolo_tpu.train.dataset import DetectionDataset as JaxDataset
    from caesar_yolo_tpu_torch.train.dataset import DetectionDataset
    data = _write_dataset(tmp_path)
    kw = dict(img_size=64, batch_size=2, max_gt=4, seed=3,
              device_letterbox=native)
    jds, tds = JaxDataset(data, **kw), DetectionDataset(data, **kw)
    assert tds.class_names == jds.class_names == ["spurious", "compact"]
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        ref, got = list(jds), list(tds)
        assert len(got) == len(ref) == 3
        for rb, gb in zip(ref, got):
            for r, g in zip(rb, gb):
                np.testing.assert_array_equal(g, r)


def test_dataset_refuses_png(tmp_path):
    """PNG is read (tests/test_torch_image_input.py holds it to the JAX
    loader), but a malformed one is refused with the fault named: a stream
    cut inside its image data."""
    import chip_smoke as cs
    from caesar_yolo_tpu_torch.train.dataset import load_sample
    path = tmp_path / "x.png"
    cs.write_png(str(path), np.arange(64 * 64, dtype=np.uint8
                                      ).reshape(64, 64, 1), 0)
    path.write_bytes(path.read_bytes()[:60])
    with pytest.raises(ValueError, match="truncated"):
        load_sample(str(path), 64, 4)


def test_cli_train_cpu_writes_last_and_npz(tmp_path):
    """cli.train --devices=cpu on a tiny FITS dataset (augmented, 2 epochs
    of 3 steps) writes the `last` checkpoint and its EMA weights as npz;
    the npz loads in the JAX load_params and the JAX model's raw outputs
    on it are within 2e-4 of the port's, relative to each map's largest
    value (precise-BN over three tiny batches leaves variances far below
    1, so the trained raw maps reach the hundreds).  --resume from the checkpoint
    directory runs on; a val split is validated on."""
    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu_torch.cli import train as cli_train
    from caesar_yolo_tpu_torch.models.convert import load_model
    data = _write_dataset(tmp_path / "d")
    ck = str(tmp_path / "ck")
    args = [f"--data={data}", "--devices=cpu", "--model=yolo11n",
            "--imgsz=64", "--batch=2", "--epochs=2", "--fp32",
            f"--checkpoint_dir={ck}", "--checkpoint_every=1",
            "--max_gt=4"]
    assert cli_train.main(args) == 0
    for name in ("last", "last.step", "last.npz", "step_1", "step_2"):
        assert os.path.exists(os.path.join(ck, name)), name
    with open(os.path.join(ck, "last.step")) as f:
        assert int(f.read()) == 6
    assert cli_train.resolve_resume_checkpoint(ck).endswith("last")
    params, meta = load_params(os.path.join(ck, "last.npz"))
    assert meta["model"] == "yolo11n"
    jm = jax_build_model("yolo11n")
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    jraw = jm(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tm, _ = load_model(os.path.join(ck, "last.npz"))
    with torch.no_grad():
        traw = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for (jb, jc), (tb, tc) in zip(jraw, traw):
        for j, t in ((jb, tb), (jc, tc)):
            j = np.asarray(j)
            np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), j,
                                       atol=2e-4 * np.abs(j).max(), rtol=0)
    assert cli_train.main(args + ["--epochs=3", f"--resume={ck}"]) == 0
    with open(os.path.join(ck, "last.step")) as f:
        assert int(f.read()) == 9
    # a `val:` split of the dataset YAML is the validation source (the
    # model has as many classes as the YAML names): the final validation
    # writes `best`
    val = _write_dataset(tmp_path / "v", yaml_val=True)
    vck = str(tmp_path / "vck")
    assert cli_train.main([f"--data={val}", "--devices=cpu",
                           "--model=yolo11n", "--num_classes=2",
                           "--imgsz=64", "--batch=2", "--epochs=1", "--fp32",
                           "--no_augment", f"--checkpoint_dir={vck}",
                           "--max_gt=4", "--val_score_thr=0.001"]) == 0
    for name in ("best", "best.step", "last"):
        assert os.path.exists(os.path.join(vck, name)), name
