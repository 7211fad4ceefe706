"""The traffic generators repeat by seed and differ between seeds."""

import numpy as np

from traffic import mosaic

FIELD = {"field_px": 256, "n_sources": 16, "blank_border": 4}


def test_fields_repeat_by_seed(tmp_path):
    a = mosaic.make_field(np.random.default_rng([7, 0]), **FIELD)
    b = mosaic.make_field(np.random.default_rng([7, 0]), **FIELD)
    c = mosaic.make_field(np.random.default_rng([8, 0]), **FIELD)
    assert np.array_equal(a, b, equal_nan=True)
    assert not np.array_equal(a, c, equal_nan=True)
    assert np.isnan(a[:4]).all() and np.isfinite(a[4:-4, 4:-4]).all()


def test_fits_reads_back_through_the_program(tmp_path):
    from caesar_yolo_tpu_torch.utils.fits import read_fits
    img = mosaic.make_field(np.random.default_rng(3), **FIELD)
    path = str(tmp_path / "f.fits")
    mosaic.write_fits(img, path)
    data, header, _ = read_fits(path)
    assert np.array_equal(np.asarray(data), np.nan_to_num(img, nan=0.0))
    assert float(header["BMAJ"]) == 2.5e-3
