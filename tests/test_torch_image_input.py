"""The port's PNG/JPEG input and WCS transforms against the JAX package on
the CPU: read_image on every PNG colour type and bit depth (written by
this file's own encoder, with all five row filters, plain and Adam7
interlaced) and on JPEG, the malformed streams it refuses, the SIN, TAN
and linear transforms, the serial SFinder on a PNG, evaluation and
cli.run --datalist over PNG cutouts, and the training loader."""

import json
import os
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caesar_yolo_tpu.detect.predictor as jax_predictor
import caesar_yolo_tpu.parallel.engine as jax_engine
from caesar_yolo_tpu.cli import evaluate as jax_cli_evaluate
from caesar_yolo_tpu.cli import run as jax_cli_run
from caesar_yolo_tpu.train import dataset as jax_dataset
from caesar_yolo_tpu.utils import fits as jfits
from caesar_yolo_tpu_torch.cli import evaluate as cli_evaluate
from caesar_yolo_tpu_torch.cli import run as cli_run
from caesar_yolo_tpu_torch.detect import predictor as port_predictor
from caesar_yolo_tpu_torch.evaluation.evaluate import load_eval_image
from caesar_yolo_tpu_torch.outputs.catalog import CLASS_NAMES
from caesar_yolo_tpu_torch.parallel import engine as port_engine
from caesar_yolo_tpu_torch.train import dataset as port_dataset
from caesar_yolo_tpu_torch.utils import fits as pfits
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
from caesar_yolo_tpu_torch.utils.synth import make_mosaic, write_labelled_cutouts

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
WEIGHTS = os.path.join(FIXTURES, "yolov8n_synth96.npz")
CUTOUTS = dict(label=1, noise_sigma=0.08, amp_range=(3.0, 8.0),
               sigma_range=(3.0, 6.0))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
           (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# -- a PNG encoder -------------------------------------------------------------

def _pack(samples, depth):
    """samples [h, w, c] -> the h scanlines' bytes (no filter byte)."""
    h = samples.shape[0]
    if depth == 16:
        return [bytes(r) for r in samples.astype(">u2").reshape(h, -1)
                .view(np.uint8)]
    if depth == 8:
        return [bytes(r) for r in samples.astype(np.uint8).reshape(h, -1)]
    per = 8 // depth
    rows = []
    for r in samples.reshape(h, -1).astype(np.uint8):
        r = np.concatenate([r, np.zeros(-len(r) % per, np.uint8)])
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows.append(bytes((r.reshape(-1, per) << shifts).sum(axis=1)
                          .astype(np.uint8)))
    return rows


def _filter(line, prev, bpp, kind):
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        out[i] = (x - pred) & 0xFF
    return bytes([kind]) + bytes(out)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(samples, ctype, depth, palette=None, trns=None,
               interlace=False):
    """samples [H, W, C] -> PNG bytes; row y of each (sub-)image takes
    filter type y % 5."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)

    def scanlines(img):
        lines = _pack(img, depth)
        prev = bytes(len(lines[0]))
        out = []
        for y, line in enumerate(lines):
            out.append(_filter(line, prev, bpp, y % 5))
            prev = line
        return b"".join(out)

    if interlace:
        body = b"".join(scanlines(samples[y0::dy, x0::dx])
                        for x0, y0, dx, dy in ADAM7
                        if w > x0 and h > y0)
    else:
        body = scanlines(samples)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(body, 9))
            + _chunk(b"IEND", b""))


def _random_png(ctype, depth, seed, h=29, w=37, interlace=False):
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, CHANNELS[ctype]))
    palette = trns = None
    if ctype == 3:
        n = min(top + 1, 256)
        palette = rng.integers(0, 256, (n, 3))
        trns = bytes(rng.integers(0, 256, n // 2 + 1).astype(np.uint8))
    return encode_png(samples, ctype, depth, palette, trns, interlace)


def _equal(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a, b))


# -- read_image ----------------------------------------------------------------

@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", FORMATS)
def test_png_equals_the_jax_reader(tmp_path, ctype, depth, interlace):
    """Every colour type at every bit depth PNG allows, all five row
    filters, plain and interlaced: the port's read_image (stdlib zlib)
    equals the JAX read_image (matplotlib) exactly: float32 in [0, 1],
    alpha stripped."""
    path = str(tmp_path / f"c{ctype}d{depth}.png")
    with open(path, "wb") as f:
        f.write(_random_png(ctype, depth, seed=10 * ctype + depth,
                            interlace=interlace))
    ref, ref_header = jfits.read_image(path)
    got, header = pfits.read_image(path)
    assert header is None and ref_header is None
    assert _equal(got, np.asarray(ref)), (got.shape, np.asarray(ref).shape)


@pytest.mark.parametrize("ctype,trns", [(0, struct.pack(">H", 7)),
                                        (2, struct.pack(">HHH", 1, 2, 3)),
                                        (3, bytes([0, 128]))])
def test_png_trns_as_matplotlib_applies_it(tmp_path, ctype, trns):
    """tRNS expands a palette's alpha (stripped after) and is ignored on
    grey and RGB images, as matplotlib does."""
    rng = np.random.default_rng(ctype)
    depth = 8
    samples = rng.integers(0, 256, (17, 23, CHANNELS[ctype]))
    palette = rng.integers(0, 256, (256, 3)) if ctype == 3 else None
    path = str(tmp_path / "t.png")
    with open(path, "wb") as f:
        f.write(encode_png(samples, ctype, depth, palette, trns))
    assert _equal(pfits.read_image(path)[0],
                  np.asarray(jfits.read_image(path)[0]))


def test_png_values_are_the_written_ones(tmp_path):
    """8-bit RGB and 16-bit grey come back as the written values / 255
    and / 65535."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (20, 30, 3))
    grey = rng.integers(0, 65536, (20, 30, 1))
    for name, samples, ctype, depth, top in (("rgb", rgb, 2, 8, 255),
                                             ("grey", grey, 0, 16, 65535)):
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(encode_png(samples, ctype, depth))
        got = pfits.read_image(path)[0]
        want = np.divide(samples, top, dtype=np.float32)
        assert _equal(got, want if ctype == 2 else want[:, :, 0])


def _corrupt(buf, how):
    if how == "signature":
        return b"\x89PNX" + buf[4:]
    if how == "crc":
        i = buf.index(b"IDAT") + 6
        return buf[:i] + bytes([buf[i] ^ 1]) + buf[i + 1:]
    if how == "truncated":
        return buf[:len(buf) // 2]
    if how == "filter":
        raw = zlib.compress(b"\x07" + bytes(3))
        ihdr = struct.pack(">IIBBBBB", 3, 1, 8, 0, 0, 0, 0)
        return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", raw) + _chunk(b"IEND", b""))
    if how == "depth":
        ihdr = struct.pack(">IIBBBBB", 3, 1, 4, 2, 0, 0, 0)
        return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(bytes(8)))
                + _chunk(b"IEND", b""))
    raise ValueError(how)


@pytest.mark.parametrize("how,match", [
    ("signature", "signature"), ("crc", "CRC"), ("truncated", "truncated"),
    ("filter", "row filter"), ("depth", "bit depth")])
def test_malformed_png_raises_naming_it(tmp_path, how, match):
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as f:
        f.write(_corrupt(_random_png(2, 8, seed=1), how))
    with pytest.raises(ValueError, match=match):
        pfits.read_image(path)


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_equals_the_jax_reader(tmp_path, mode):
    from PIL import Image
    rng = np.random.default_rng(3)
    shape = (24, 40, 3) if mode == "RGB" else (24, 40)
    path = str(tmp_path / f"x_{mode}.jpg")
    Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8),
                    mode).save(path, quality=90)
    assert _equal(pfits.read_image(path)[0],
                  np.asarray(jfits.read_image(path)[0]))


def test_jpeg_without_pillow_is_refused_by_name(tmp_path, monkeypatch):
    from PIL import Image
    path = str(tmp_path / "x.jpeg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG input needs Pillow"):
        pfits.read_image(path)


def test_other_extensions_are_unsupported(tmp_path):
    path = str(tmp_path / "x.bmp")
    open(path, "wb").close()
    assert pfits.read_image(path) is None
    assert jfits.read_image(path) is None


def test_fits_through_read_image(tmp_path):
    data = np.random.default_rng(0).normal(size=(12, 9)).astype(np.float32)
    path = str(tmp_path / "x.fits")
    pfits.write_fits(data, path)
    got, header = pfits.read_image(path)
    ref, ref_header = jfits.read_image(path)
    assert _equal(got, np.asarray(ref)) and header["NAXIS1"] == 9
    assert dict(header) == dict(ref_header)


# -- WCS -----------------------------------------------------------------------

WCS_HEADERS = {
    "sin-crota2": {"CTYPE1": "RA---SIN", "CTYPE2": "DEC--SIN",
                   "CRPIX1": 512.5, "CRPIX2": 480.0, "CRVAL1": 250.3,
                   "CRVAL2": -45.2, "CDELT1": -4.1e-4, "CDELT2": 4.1e-4,
                   "CROTA2": 12.5},
    "tan-pc": {"CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "CRPIX1": 100.0,
               "CRPIX2": 120.0, "CRVAL1": 10.0, "CRVAL2": 30.0,
               "CDELT1": -1e-3, "CDELT2": 1e-3, "PC1_1": 0.98,
               "PC1_2": -0.17, "PC2_1": 0.17, "PC2_2": 0.98},
    "tan-cd": {"CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "CRPIX1": 64.0,
               "CRPIX2": 64.0, "CRVAL1": 359.9, "CRVAL2": 80.0,
               "CD1_1": -2e-3, "CD1_2": 1e-4, "CD2_1": 1.5e-4,
               "CD2_2": 2e-3, "LONPOLE": 180.0},
    "linear": {"CTYPE1": "RA---CAR", "CTYPE2": "DEC--CAR", "CRPIX1": 10.0,
               "CRPIX2": 20.0, "CRVAL1": 150.0, "CRVAL2": 2.0,
               "CDELT1": -0.01, "CDELT2": 0.01},
}


@pytest.mark.parametrize("name", sorted(WCS_HEADERS))
def test_wcs_transforms_match_jax(name):
    """pixel_to_world and world_to_pixel of SIN, TAN and linear headers
    (CROTA2, PC and CD matrices) within 1e-9 deg / 1e-9 px of JAX, and
    round trips back to the pixels."""
    card = WCS_HEADERS[name]
    pw = pfits.Wcs.from_header(pfits.FitsHeader(card))
    jw = jfits.Wcs.from_header(jfits.FitsHeader(card))
    assert pw.projection == jw.projection == (
        name.split("-")[0].upper() if name != "linear" else "")
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-50, 1050, (2, 200))
    ra, dec = pw.pixel_to_world(x, y)
    jra, jdec = jw.pixel_to_world(x, y)
    np.testing.assert_allclose(ra, jra, rtol=0, atol=1e-9)
    np.testing.assert_allclose(dec, jdec, rtol=0, atol=1e-9)
    px, py = pw.world_to_pixel(ra, dec)
    jpx, jpy = jw.world_to_pixel(jra, jdec)
    np.testing.assert_allclose(px, jpx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(py, jpy, rtol=0, atol=1e-9)
    np.testing.assert_allclose(px, x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(py, y, rtol=0, atol=1e-6)


# -- the serial SFinder, evaluation, datalist and the loader on PNG -------------

def _mosaic_png(path, n=160, grey16=True):
    data = make_mosaic(n, n, n_sources=8, seed=9,
                       **{k: v for k, v in CUTOUTS.items() if k != "label"})[0]
    data = (data - data.min()) / (data.max() - data.min())
    if grey16:
        samples, ctype, depth = np.round(data * 65535)[:, :, None], 0, 16
    else:
        q = np.round(data * 255)
        samples, ctype, depth = np.stack([q, q, q], axis=-1), 2, 8
    with open(path, "wb") as f:
        f.write(encode_png(samples.astype(np.int64), ctype, depth))
    return path


def _sfinder_pair(path, out_dir, crop):
    """(rc, catalog) of the JAX and the port's serial SFinder in f32 with
    the README chain on path."""
    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.ops import build_preprocessor as jax_pre
    from caesar_yolo_tpu.parallel import SFinder as JaxSFinder
    from caesar_yolo_tpu.parallel import SFinderConfig as JaxConfig
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig

    x0, x1, y0, y1 = crop or (-1, -1, -1, -1)
    kw = dict(image_path=path, image_xmin=x0, image_xmax=x1, image_ymin=y0,
              image_ymax=y1, img_size=96, score_thr=0.3)
    pre = dict(zscale_stretch=True, normalize_minmax=True)
    params, meta = load_params(WEIGHTS)
    jsf = JaxSFinder(build_model(meta["model"],
                                 num_classes=int(meta["num_classes"])),
                     params,
                     JaxConfig(outfile_json=os.path.join(out_dir, "j.json"),
                               outfile_ds9=os.path.join(out_dir, "j.reg"),
                               **kw),
                     preprocessor=jax_pre(**pre),
                     engine_kwargs={"compute_dtype": jnp.float32})
    psf = SFinder(load_model(WEIGHTS)[0],
                  SFinderConfig(outfile_json=os.path.join(out_dir, "p.json"),
                                outfile_ds9=os.path.join(out_dir, "p.reg"),
                                **kw),
                  preprocessor=build_preprocessor(**pre),
                  engine_kwargs={"compute_dtype": torch.float32},
                  device="cpu")
    return (jsf.run(), jsf.sources["sources"]), (psf.run(),
                                                 psf.sources["sources"])


def _arrays(objs):
    boxes = np.asarray([[o["x1"], o["y1"], o["x2"], o["y2"]] for o in objs],
                       np.float64).reshape(-1, 4)
    return (boxes, np.asarray([o["score"] for o in objs]),
            np.asarray([o["class_id"] for o in objs]))


@pytest.mark.parametrize("crop", [None, (24, 151, 8, 135), (0, 160, 0, 99)],
                         ids=["whole", "crop", "out-of-range"])
def test_serial_sfinder_on_png_matches_jax(tmp_path, crop):
    """The serial SFinder on a 16-bit grey PNG, whole and cropped (the
    crop cut from the image, positions offset by its origin), by the
    catalog rule; a crop past the image's edge fails in both."""
    path = _mosaic_png(str(tmp_path / "m.png"))
    (jrc, jcat), (prc, pcat) = _sfinder_pair(path, str(tmp_path), crop)
    assert prc == jrc == (-1 if crop == (0, 160, 0, 99) else 0)
    if jrc == 0:
        assert len(jcat) > 0
        assert catalog_mismatch(_arrays(jcat), _arrays(pcat)) is None


def test_tiled_run_refuses_png(tmp_path):
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig
    path = _mosaic_png(str(tmp_path / "m.png"))
    sf = SFinder(load_model(WEIGHTS)[0],
                 SFinderConfig(image_path=path, split_image_in_tiles=True),
                 device="cpu")
    assert sf.run_tiled() == -1


@pytest.fixture
def f32_engines(monkeypatch):
    """Both packages' engines and predictors default to f32, and so does
    the model the port's cli.run prepares from npz weights, so that the
    CLIs (which have no dtype flag) are held by the catalog rule."""
    monkeypatch.setenv("CAESAR_YOLO_NO_COMPILE_CACHE", "1")
    for cls, f32 in ((jax_engine.TileEngine, jnp.float32),
                     (jax_predictor.Predictor, jnp.float32),
                     (port_engine.TileEngine, torch.float32),
                     (port_predictor.Predictor, torch.float32)):
        monkeypatch.setitem(cls.__init__.__kwdefaults__, "compute_dtype", f32)
    monkeypatch.setattr(port_predictor, "COMPUTE_DTYPE", torch.float32)


def _png_cutouts(root, n=6):
    """Labelled cutouts as 8-bit PNGs (grey and RGB in turn) beside their
    FITS originals, labels under root/labels; -> (png paths, filelist)."""
    paths = []
    for i, p in enumerate(write_labelled_cutouts(str(root), n,
                                                 sizes=(96, 96, 80), seed=70,
                                                 **CUTOUTS)):
        data = pfits.read_fits(p)[0]
        q = np.round((data - data.min()) / (data.max() - data.min()) * 255)
        samples = (q[:, :, None] if i % 2 == 0
                   else np.stack([q, q, q], axis=-1)).astype(np.int64)
        paths.append(os.path.splitext(p)[0] + ".png")
        with open(paths[-1], "wb") as f:
            f.write(encode_png(samples, 0 if i % 2 == 0 else 2, 8))
    filelist = os.path.join(str(root), "png_list.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    return paths, filelist


def test_load_eval_image_on_png(tmp_path):
    from caesar_yolo_tpu.evaluation.evaluate import load_eval_image as jload
    paths, _ = _png_cutouts(tmp_path, n=2)
    for p in paths:
        assert _equal(load_eval_image(p), np.asarray(jload(p)))


def test_cli_evaluate_on_png_matches_jax(tmp_path, capsys, f32_engines):
    """cli.evaluate on labelled PNG cutouts prints the JAX CLI's C/R/F1
    summary and the same per-image matches (catalog rule)."""
    _, filelist = _png_cutouts(tmp_path)
    common = [f"--weights={WEIGHTS}", f"--filelist={filelist}",
              "--imgsize=96", "--batch_size=3"]
    rdetail, gdetail = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert jax_cli_evaluate.main([*common, f"--save_detail={rdetail}"]) == 0
    ref_out = capsys.readouterr().out
    rc, _ = cli_evaluate.run([*common, f"--save_detail={gdetail}",
                              "--devices=cpu"])
    assert rc == 0
    assert capsys.readouterr().out == ref_out
    with open(rdetail) as f:
        ref = json.load(f)
    with open(gdetail) as f:
        got = json.load(f)
    assert [d["image"] for d in got] == [d["image"] for d in ref]
    n = 0
    for r, g in zip(ref, got):
        arrays = [(np.asarray([p["bbox"] for p in d["pred"]]).reshape(-1, 4),
                   np.asarray([p["score"] for p in d["pred"]]),
                   np.asarray([CLASS_NAMES.index(p["label"])
                               for p in d["pred"]])) for d in (r, g)]
        assert catalog_mismatch(*arrays) is None, r["image"]
        n += len(r["pred"])
    assert n >= 4


def test_cli_run_datalist_of_png_matches_jax(tmp_path, f32_engines):
    """cli.run --datalist of PNG cutouts (the batched route) writes the JAX
    CLI's out_<stem>.json per image (catalog rule)."""
    paths, filelist = _png_cutouts(tmp_path)
    argv = [f"--datalist={filelist}", f"--weights={WEIGHTS}",
            "--imgsize=96", "--scoreThr=0.3"]
    cwd = os.getcwd()
    try:
        for sub, fn, extra in (("jax", jax_cli_run.main, []),
                               ("port", cli_run.main, ["--devices=cpu"])):
            os.makedirs(tmp_path / sub)
            os.chdir(tmp_path / sub)
            assert fn([*argv, *extra]) == 0
    finally:
        os.chdir(cwd)
    n = 0
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        cats = []
        for sub in ("jax", "port"):
            with open(tmp_path / sub / f"out_{stem}.json") as f:
                cats.append(_arrays(json.load(f)["objs"]))
        assert catalog_mismatch(*cats) is None, stem
        n += len(cats[0][1])
    assert n >= 4


@pytest.mark.parametrize("native", [False, True])
def test_dataset_loader_on_png_matches_jax(tmp_path, native):
    """load_sample on grey and RGB PNG cutouts: image, labels, boxes and
    mask equal to the JAX loader's."""
    paths, _ = _png_cutouts(tmp_path, n=2)
    for p in paths:
        ref = jax_dataset.load_sample(p, 128, 8, native=native)
        got = port_dataset.load_sample(p, 128, 8, native=native)
        assert len(got) == len(ref) == 4
        for g, r in zip(got, ref):
            assert _equal(np.asarray(g), np.asarray(r))
