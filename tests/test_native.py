"""Native image-prep extension tests (skipped when g++/lib unavailable)."""

import numpy as np
import pytest

from lavida_mod.data.native import (
    FILTER_BICUBIC, FILTER_BILINEAR, FILTER_LANCZOS,
    native_available, prep_pad_view_native, prep_view_native,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native extension not built"
)


@pytest.mark.parametrize("filter_id,pil_name", [
    (FILTER_BICUBIC, "BICUBIC"),
    (FILTER_BILINEAR, "BILINEAR"),
    (FILTER_LANCZOS, "LANCZOS"),
])
def test_resample_matches_pil(filter_id, pil_name):
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (217, 340, 3), dtype=np.uint8)
    ours = prep_view_native(img, (96, 128), filter_id=filter_id)
    ref = np.asarray(
        Image.fromarray(img).resize((128, 96), getattr(Image, pil_name)),
        np.float32,
    )
    ref = ((ref / 255 - 0.5) / 0.5).transpose(2, 0, 1)
    # both quantize to uint8 between passes; only rounding ties differ
    diff = np.abs(ours - ref)
    assert diff.max() <= (1.01 / 255) / 0.5, diff.max()
    assert (diff > 1e-6).mean() < 0.05  # <5% of pixels on tie boundaries


def test_pad_view_geometry():
    from lavida_mod.data.anyres import fit_within

    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (300, 500, 3), dtype=np.uint8)
    nw, nh, px, py = fit_within((500, 300), (384, 768))
    out = prep_pad_view_native(
        img, target=(768, 384), inner=(nh, nw), paste=(py, px)
    )
    assert out.shape == (3, 768, 384)
    # pad rows are the normalized-black constant
    pad_val = (0.0 - 0.5) / 0.5
    assert np.allclose(out[:, :py, :], pad_val)
    assert not np.allclose(out[:, py + 2, :], pad_val)


def test_upscale_path():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
    out = prep_view_native(img, (160, 160))
    assert out.shape == (3, 160, 160)
    assert np.isfinite(out).all()
