"""The stdlib PNG writer/reader (utils.image) that replaces Pillow on the
render path."""
import glob
import os

import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.utils.image import (
    read_image_rgba,
    read_png,
    read_png_u8,
    to_u8,
    write_png,
)

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden",
                                       "*.png")))


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 23, 3), (40, 64, 4)])
def test_png_round_trip(tmp_path, shape):
    """write_png -> read_png returns the 8-bit quantized image exactly (an
    RGBA input drops its alpha)."""
    rs = np.random.RandomState(sum(shape))
    img = rs.uniform(-0.2, 1.2, shape).astype(np.float32)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    back = read_png(path)
    assert back.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(np.rint(back * 255.0).astype(np.uint8),
                                  to_u8(img))
    rgba = read_image_rgba(path)
    assert rgba.shape == shape[:2] + (4,) and (rgba[..., 3] == 1.0).all()


def test_golden_set_is_complete():
    assert len(GOLDEN) == 8


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_png_reader_matches_pillow_on_goldens(path):
    """The goldens were written by Pillow with its adaptive row filters; the
    reader must decode every one of them exactly as Pillow does."""
    Image = pytest.importorskip("PIL.Image")
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(read_png_u8(path), want)
