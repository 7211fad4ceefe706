"""The port's five-class synthetic cutouts against the JAX package.

jax.random and torch.Generator draw different numbers, so the render is
held to JAX's on JAX's own draws: `jax_draws` rebuilds them with the key
splits of caesar_yolo_tpu/utils/synth5.py (split(key, batch); split(k, 4)
in `one`; split(ks[3], max_src); split(slot_key, 10) in `render_slot`)
and hands them to the port's `render_multiclass`.  Rules: labels and
masks equal, boxes within 1e-4 px, images within 1e-5 (cos, sin and exp
differ by an ulp between the libraries, and XLA may contract a product
and a sum into an FMA).  The property tests are twins of
tests/test_synth5.py on the port's own draws."""

import os

import jax
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.utils import synth5 as jsynth5
from caesar_yolo_tpu_torch.utils import synth5
from caesar_yolo_tpu_torch.utils.synth5 import (CLASS_NAMES, NATIVE_SIZE,
                                                make_multiclass_batch,
                                                render_multiclass,
                                                write_multiclass_dataset)

torch.set_num_threads(1)

IMG_TOL = 1e-5
BOX_TOL = 1e-4


def jax_draws(seed, batch, size=NATIVE_SIZE, max_src=4, noise=0.08):
    """The draws of JAX's make_multiclass_tile_fn(size, max_src,
    noise)(PRNGKey(seed), batch), as the port's draws dict."""
    jit_amp = 0.08 * size

    def slot(key):
        ks = jax.random.split(key, 10)
        return (jax.random.randint(ks[0], (), 0, 5),
                jax.random.uniform(ks[1], (), minval=-jit_amp,
                                   maxval=jit_amp),
                jax.random.uniform(ks[2], (), minval=-jit_amp,
                                   maxval=jit_amp),
                jax.random.uniform(ks[3], (), minval=0.0, maxval=np.pi),
                jax.random.uniform(ks[4], (8,)),
                jax.random.uniform(ks[5], (3,)),
                jax.random.uniform(ks[6], (3,)),
                jax.random.uniform(ks[7], (3,)))

    def one(key):
        ks = jax.random.split(key, 4)
        plane = noise * jax.random.normal(ks[0], (size, size))
        n_src = jax.random.randint(ks[1], (), 0, max_src + 1)
        perm = jax.random.permutation(ks[2], 4)[:max_src]
        slots = jax.vmap(slot)(jax.random.split(ks[3], max_src))
        return (plane, n_src, perm) + slots

    out = [np.asarray(a) for a in jax.jit(jax.vmap(one))(
        jax.random.split(jax.random.PRNGKey(seed), batch))]
    plane, n_src, perm, cls, jx, jy, theta, t, phi_u, sig_u, amp_u = out

    def tt(a, dtype=None):
        return torch.from_numpy(np.array(a)).to(dtype)

    return {"noise": tt(plane), "n_src": tt(n_src, torch.int64),
            "perm": tt(perm, torch.int64), "cls": tt(cls, torch.int64),
            "jitter": tt(np.stack([jx, jy], -1)), "theta": tt(theta),
            "t": tt(t), "phi_u": tt(phi_u), "sig_u": tt(sig_u),
            "amp_u": tt(amp_u)}


def jax_batch(seed, batch, size=NATIVE_SIZE, max_src=4):
    make = jsynth5.make_multiclass_tile_fn(size=size, max_src=max_src)
    return tuple(np.asarray(v) for v in make(jax.random.PRNGKey(seed),
                                             batch))


def assert_render_matches(got, ref):
    imgs, labels, boxes, mask = (t.numpy() for t in got)
    rimgs, rlabels, rboxes, rmask = ref
    np.testing.assert_array_equal(mask, rmask)
    np.testing.assert_array_equal(labels, rlabels)
    assert np.abs(boxes - rboxes).max() <= BOX_TOL
    assert imgs.shape == rimgs.shape
    assert np.abs(imgs - rimgs).max() <= IMG_TOL


@pytest.mark.parametrize("seed,batch,size", [(0, 12, NATIVE_SIZE),
                                             (5, 6, NATIVE_SIZE),
                                             (3, 4, 96)])
def test_render_matches_jax_on_jax_draws(seed, batch, size):
    draws = jax_draws(seed, batch, size)
    got = render_multiclass(draws, size=size)
    ref = jax_batch(seed, batch, size)
    assert_render_matches(got, ref)
    # every class and a source-free cutout among the cases' slots
    assert ref[3].any()


def test_render_matches_jax_with_two_slots():
    draws = jax_draws(2, 8, max_src=2)
    got = render_multiclass(draws, max_src=2)
    assert_render_matches(got, jax_batch(2, 8, max_src=2))


def test_boxes_without_the_image_equal_the_render():
    """The slots' geometry alone (`_slot_shapes`, no fields) gives
    render_multiclass's labels, boxes and mask bit for bit."""
    draws = jax_draws(11, 6)
    _, labels, boxes, mask = render_multiclass(draws)
    got = synth5._ground_truth(
        draws, synth5._slot_shapes(draws, NATIVE_SIZE), NATIVE_SIZE, 4)
    for g, r in zip(got, (labels, boxes, mask)):
        assert torch.equal(g, r)


def _two_sample_z(k1, n1, k2, n2):
    """|p1 - p2| over the pooled standard error of two proportions."""
    p = (k1 + k2) / (n1 + n2)
    se = np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return abs(k1 / n1 - k2 / n2) / se if se > 0 else 0.0


def test_draws_distribution_matches_jax():
    """The port's draws (torch.Generator) and JAX's (jax.random key
    splits, `jax_draws`) come from one distribution: 2048 cutouts of each
    at 132 px.  Two-sample tests, each within 4 standard errors: the share
    of each n_src value (0-4) among cutouts, the share of each class among
    the sources present, and per class the 25/50/75% quartiles of box
    width and height, by the share of each sample at or below the pooled
    sample's quartile (binomial, so no density estimate enters).  The
    boxes are render_multiclass's, from the slots' geometry alone."""
    n = 2048
    port = synth5.draw_multiclass_params(torch.Generator().manual_seed(1),
                                         n)
    samples = []
    for d in (port, jax_draws(1, n)):
        labels, boxes, mask = (t.numpy() for t in synth5._ground_truth(
            d, synth5._slot_shapes(d, NATIVE_SIZE), NATIVE_SIZE, 4))
        wh = (boxes[..., 2:] - boxes[..., :2])[mask]
        samples.append((d["n_src"].numpy(), labels[mask], wh))
    (ns1, c1, wh1), (ns2, c2, wh2) = samples
    z = {}
    for k in range(5):
        z[f"n_src={k}"] = _two_sample_z((ns1 == k).sum(), n,
                                        (ns2 == k).sum(), n)
        z[f"class {k}"] = _two_sample_z((c1 == k).sum(), len(c1),
                                        (c2 == k).sum(), len(c2))
        for axis, name in ((0, "w"), (1, "h")):
            a, b = wh1[c1 == k, axis], wh2[c2 == k, axis]
            assert len(a) > 300 and len(b) > 300
            for q in (0.25, 0.5, 0.75):
                x = np.quantile(np.concatenate([a, b]), q)
                z[f"class {k} {name} q{q}"] = _two_sample_z(
                    (a <= x).sum(), len(a), (b <= x).sum(), len(b))
    assert len(z) == 40
    assert max(z.values()) <= 4.0, max(z.items(), key=lambda kv: kv[1])


def test_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    d = synth5.draw_multiclass_params(gen, 5, size=64, max_src=3)
    assert d["noise"].shape == (5, 64, 64)
    assert d["perm"].shape == (5, 3) and d["cls"].shape == (5, 3)
    for row in d["perm"]:
        assert len(set(row.tolist())) == 3 and row.max() < 4
    assert (d["jitter"].abs() <= 0.08 * 64).all()
    assert ((d["theta"] >= 0) & (d["theta"] < np.pi)).all()
    assert d["t"].shape == (5, 3, 8) and d["phi_u"].shape == (5, 3, 3)
    assert int(d["n_src"].min()) >= 0 and int(d["n_src"].max()) <= 3


# -- twins of tests/test_synth5.py on the port's own draws --------------------


@pytest.fixture(scope="module")
def batch():
    return tuple(t.numpy() for t in make_multiclass_batch(0, 96,
                                                          device="cpu"))


def _single_source_tiles(batch, cls=None):
    imgs, labels, boxes, mask = batch
    out = []
    for i in range(len(imgs)):
        if mask[i].sum() != 1:
            continue
        j = int(np.argmax(mask[i]))
        if cls is not None and labels[i, j] != cls:
            continue
        out.append((imgs[i, :, :, 0], int(labels[i, j]), boxes[i, j]))
    return out


def test_shapes_ranges_and_class_mix(batch):
    imgs, labels, boxes, mask = batch
    assert imgs.shape == (96, NATIVE_SIZE, NATIVE_SIZE, 3)
    assert imgs.min() >= 0.0 and imgs.max() <= 1.0 + 1e-6
    counts = np.bincount(labels[mask], minlength=5)
    assert (counts > 0).all(), counts
    b = boxes[mask]
    assert (b[:, 0] < b[:, 2]).all() and (b[:, 1] < b[:, 3]).all()
    assert b.min() >= 0.0 and b.max() <= NATIVE_SIZE
    assert (mask.sum(1) == 0).any()


def test_flux_centroid_inside_box(batch):
    tiles = _single_source_tiles(batch)
    assert len(tiles) >= 5
    for im, cls, (x0, y0, x1, y1) in tiles:
        med = np.median(im)
        noise = np.std(np.concatenate([im[:10].ravel(), im[-10:].ravel()]))
        w = np.clip(im - med - 3.0 * noise, 0, None) ** 2
        assert w.sum() > 0, CLASS_NAMES[cls]
        yy, xx = np.mgrid[0:NATIVE_SIZE, 0:NATIVE_SIZE]
        cx = (w * xx).sum() / w.sum()
        cy = (w * yy).sum() / w.sum()
        assert x0 - 3 <= cx <= x1 + 3 and y0 - 3 <= cy <= y1 + 3, \
            (CLASS_NAMES[cls], cx, cy, (x0, y0, x1, y1))


def _count_islands(im, thr):
    """4-connected components above thr of at least 3 pixels."""
    lab = np.zeros(im.shape, np.int32)
    cur = 0
    stack = []
    for sy, sx in zip(*np.where(im > thr)):
        if lab[sy, sx]:
            continue
        cur += 1
        stack.append((sy, sx))
        lab[sy, sx] = cur
        while stack:
            y, x = stack.pop()
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                if (0 <= ny < im.shape[0] and 0 <= nx < im.shape[1]
                        and not lab[ny, nx] and im[ny, nx] > thr):
                    lab[ny, nx] = cur
                    stack.append((ny, nx))
    sizes = np.bincount(lab.ravel())[1:]
    return int((sizes >= 3).sum())


def test_multisland_has_disjoint_islands(batch):
    tiles = _single_source_tiles(batch, cls=3)
    assert len(tiles) >= 1
    multi = 0
    for im, _, (x0, y0, x1, y1) in tiles:
        bg = np.median(im)
        crop = im[int(y0):int(np.ceil(y1)), int(x0):int(np.ceil(x1))]
        peak = crop.max() - bg
        multi += _count_islands(crop - bg, 0.45 * peak) >= 2
    assert multi >= max(1, len(tiles) // 2), (multi, len(tiles))


def test_spurious_has_negative_ring(batch):
    tiles = _single_source_tiles(batch, cls=0)
    assert len(tiles) >= 1
    for im, _, (x0, y0, x1, y1) in tiles:
        crop = im[int(y0):int(np.ceil(y1)), int(x0):int(np.ceil(x1))]
        med = np.median(im)
        noise = np.std(np.concatenate([im[:10].ravel(), im[-10:].ravel()]))
        assert crop.min() < med - 2.0 * noise


def test_flagged_is_bright_and_elongated(batch):
    tiles = _single_source_tiles(batch, cls=4)
    assert len(tiles) >= 1
    for im, _, box in tiles:
        med = np.median(im)
        noise = np.std(np.concatenate([im[:10].ravel(), im[-10:].ravel()]))
        x0, y0, x1, y1 = box
        crop = im[int(y0):int(np.ceil(y1)), int(x0):int(np.ceil(x1))]
        assert crop.max() - med > 8.0 * noise
        ys, xs = np.where(crop - med > 1.5 * noise)
        pts = np.stack([xs - xs.mean(), ys - ys.mean()])
        cov = pts @ pts.T / len(xs)
        ev = np.sort(np.linalg.eigvalsh(cov))
        assert np.sqrt(ev[1] / max(ev[0], 1e-9)) >= 1.3, ev


def test_extended_larger_than_compact(batch):
    imgs, labels, boxes, mask = batch
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    a_compact = area[(labels == 1) & mask]
    a_ext = area[(labels == 2) & mask]
    assert a_ext.mean() > 2.0 * a_compact.mean()


def test_determinism_and_size_scaling():
    a = [t.numpy() for t in make_multiclass_batch(7, 4, device="cpu")]
    b = [t.numpy() for t in make_multiclass_batch(7, 4, device="cpu")]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    imgs, labels, boxes, mask = (t.numpy() for t in make_multiclass_batch(
        3, 16, size=264, device="cpu"))
    w = (boxes[..., 2] - boxes[..., 0])[mask]
    w0 = (a[2][..., 2] - a[2][..., 0])[a[3]]
    assert 1.2 * w0.mean() < w.mean() < 4.0 * w0.mean()


def test_write_multiclass_dataset(tmp_path):
    from caesar_yolo_tpu_torch.utils.fits import read_fits
    paths = write_multiclass_dataset(str(tmp_path), 6, seed=1, device="cpu")
    assert len(paths) == 6
    img, _, _ = read_fits(paths[0])
    assert img.shape == (NATIVE_SIZE, NATIVE_SIZE)
    yaml = (tmp_path / "dataset.yaml").read_text()
    for name in CLASS_NAMES:
        assert name in yaml
    rows = []
    for p in (tmp_path / "labels").iterdir():
        for line in p.read_text().splitlines():
            vals = line.split()
            assert len(vals) == 5
            assert 0 <= int(vals[0]) <= 4
            rows.append(vals)
    assert rows


# -- the dataset writer against JAX's -----------------------------------------


def _dataset_files(root):
    names = sorted(os.listdir(os.path.join(root, "images")))
    labels = {n: open(os.path.join(root, "labels", n)).read()
              for n in sorted(os.listdir(os.path.join(root, "labels")))}
    return names, labels


def test_write_multiclass_dataset_matches_jax_writer(tmp_path, monkeypatch):
    """Given JAX's cutouts, the port writes the same file names, the same
    label lines, FITS data equal bit for bit and the same dataset.yaml."""
    from caesar_yolo_tpu.utils.fits import read_fits as jread_fits
    from caesar_yolo_tpu_torch.utils.fits import read_fits

    seed, n = 4, 7
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpaths = jsynth5.write_multiclass_dataset(str(jdir), n, seed=seed)
    ref = jax_batch(seed, n)
    monkeypatch.setattr(synth5, "make_multiclass_batch",
                        lambda *a, **k: tuple(torch.from_numpy(v)
                                              for v in ref))
    tpaths = write_multiclass_dataset(str(tdir), n, seed=seed, device="cpu")
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths]
    assert _dataset_files(tdir) == _dataset_files(jdir)
    for jp, tp in zip(jpaths, tpaths):
        np.testing.assert_array_equal(read_fits(tp)[0], jread_fits(jp)[0])
    assert (tdir / "dataset.yaml").read_text() == \
        (jdir / "dataset.yaml").read_text()


def test_write_multiclass_dataset_on_jax_draws(tmp_path, monkeypatch):
    """The whole writer, render included, on JAX's draws: the same names,
    label lines of the same classes whose values agree within the box
    rule, FITS data within the image rule."""
    from caesar_yolo_tpu.utils.fits import read_fits as jread_fits
    from caesar_yolo_tpu_torch.utils.fits import read_fits

    seed, n = 6, 5
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpaths = jsynth5.write_multiclass_dataset(str(jdir), n, seed=seed)
    draws = jax_draws(seed, n)
    monkeypatch.setattr(synth5, "draw_multiclass_params",
                        lambda *a, **k: draws)
    tpaths = write_multiclass_dataset(str(tdir), n, seed=seed, device="cpu")
    jnames, jlabels = _dataset_files(jdir)
    tnames, tlabels = _dataset_files(tdir)
    assert tnames == jnames and sorted(tlabels) == sorted(jlabels)
    for name, text in jlabels.items():
        jrows = [r.split() for r in text.splitlines()]
        trows = [r.split() for r in tlabels[name].splitlines()]
        assert [r[0] for r in trows] == [r[0] for r in jrows]
        for jr, tr in zip(jrows, trows):
            diff = np.abs(np.float64(tr[1:]) - np.float64(jr[1:]))
            # %.6f of values within BOX_TOL / size, plus a rounding step
            assert diff.max() <= BOX_TOL / NATIVE_SIZE + 1.5e-6
    for jp, tp in zip(jpaths, tpaths):
        assert np.abs(read_fits(tp)[0] - jread_fits(jp)[0]).max() <= IMG_TOL

