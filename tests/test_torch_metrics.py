"""The port's evaluation metrics (`nonrigid_nerf_torch/utils/metrics.py`,
`utils/lpips.py`) held against the JAX package's (`utils/metrics.py`,
`utils/lpips_jax.py`) on the same seeded images: PSNR and SSIM (value and
map) to 1e-6, images under the 11 x 11 window included; LPIPS with the
synthetic weight file of tests/test_lpips.py to 1e-5, and None without
weights."""

import numpy as np
import pytest

from nonrigid_nerf_torch.utils import lpips as t_lpips
from nonrigid_nerf_torch.utils import metrics as t_metrics
from nonrigid_nerf_tpu.utils import lpips_jax as j_lpips
from nonrigid_nerf_tpu.utils import metrics as j_metrics
from tests.test_lpips import make_random_weights


def image_pair(seed, h, w):
    rng = np.random.RandomState(seed)
    a = rng.rand(h, w, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(h, w, 3), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("h,w", [(48, 64), (7, 9), (3, 12), (1, 5)])
def test_psnr_and_ssim_match_jax(h, w):
    a, b = image_pair(h * 100 + w, h, w)
    assert t_metrics.psnr(a, b) == pytest.approx(j_metrics.psnr(a, b),
                                                 abs=1e-6)
    got, got_map = t_metrics.ssim(a, b, full=True)
    want, want_map = j_metrics.ssim(a, b, full=True)
    assert np.isfinite(got)
    assert got == pytest.approx(want, abs=1e-6)
    assert got_map.shape == want_map.shape == (h, w, 3)
    np.testing.assert_allclose(got_map, want_map, rtol=0, atol=1e-6)
    assert t_metrics.ssim(a, b) == pytest.approx(want, abs=1e-6)


def test_ssim_of_gray_images_matches_jax():
    rng = np.random.RandomState(5)
    a = rng.rand(20, 24)
    b = np.clip(a + 0.2 * rng.randn(20, 24), 0, 1)
    got, got_map = t_metrics.ssim(a, b, full=True)
    want, want_map = j_metrics.ssim(a, b, full=True)
    assert got == pytest.approx(want, abs=1e-6)
    np.testing.assert_allclose(got_map, want_map, rtol=0, atol=1e-6)
    assert t_metrics.ssim(a, a) == pytest.approx(1.0, abs=1e-12)


@pytest.fixture()
def weight_file(tmp_path, monkeypatch):
    weights = make_random_weights()
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **weights)
    monkeypatch.setenv("NRN_LPIPS_WEIGHTS", str(path))
    j_lpips.reset_cache()
    t_lpips.reset_cache()
    yield weights
    j_lpips.reset_cache()
    t_lpips.reset_cache()


@pytest.mark.parametrize("h,w", [(64, 72), (48, 40)])
def test_lpips_matches_jax(weight_file, h, w):
    a, b = image_pair(7 + h, h, w)
    got = t_lpips.lpips_alex(a, b)
    want = j_lpips.lpips_alex(a, b)
    assert got is not None and want is not None and got > 0
    assert got == pytest.approx(want, abs=1e-5)
    assert t_metrics.lpips_distance(a, b) == pytest.approx(got, abs=0)
    assert t_lpips.lpips_alex(a, a) == pytest.approx(0.0, abs=1e-6)


def test_lpips_schema_and_size_checks_match_jax(weight_file, tmp_path):
    assert t_lpips.weight_spec() == j_lpips.weight_spec()
    assert t_lpips.lpips_available()
    for h, w in ((30, 64), (31, 64), (63, 63), (64, 20)):
        assert t_lpips._pipeline_supports(h, w) == \
            j_lpips._pipeline_supports(h, w)
    small = np.zeros((16, 16, 3), np.float32)
    assert t_lpips.lpips_alex(small, small) is None
    bad = tmp_path / "bad.npz"
    np.savez(bad, conv0_w=np.zeros((2, 2)))
    with pytest.raises(ValueError):
        t_lpips.load_weights(str(bad))


def test_lpips_without_weights_is_none(tmp_path, monkeypatch):
    missing = str(tmp_path / "nonexistent.npz")
    monkeypatch.setenv("NRN_LPIPS_WEIGHTS", missing)
    monkeypatch.setattr(t_lpips, "_candidate_paths", lambda: iter([missing]))
    monkeypatch.setattr(j_lpips, "_candidate_paths", lambda: iter([missing]))
    t_lpips.reset_cache()
    j_lpips.reset_cache()
    a = np.zeros((64, 64, 3), np.float32)
    assert t_lpips.lpips_alex(a, a) is None and j_lpips.lpips_alex(a, a) is None
    assert not t_lpips.lpips_available()
    # the lpips package is not installed either: no value at all
    assert t_metrics.lpips_distance(a, a) is None
    t_lpips.reset_cache()
    j_lpips.reset_cache()
