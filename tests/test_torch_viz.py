"""The port's visualizations (`nonrigid_nerf_torch/utils/viz.py`) against
the JAX package's: jet and Blinn-Phong to 1e-6, with matplotlib's jet and
with the analytic one, and the ray-bending OBJ export line for line."""

import sys

import numpy as np
import pytest

from nonrigid_nerf_torch.utils import viz as t_viz
from nonrigid_nerf_tpu.utils import viz as j_viz


def disparity(seed=0, h=23, w=31):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    d = 0.5 + 0.3 * np.sin(5 * xx) * np.cos(3 * yy) + 0.05 * rng.rand(h, w)
    return (d / d.max()).astype(np.float32)


@pytest.mark.parametrize("table", ["matplotlib", "analytic"])
def test_jet_matches_jax(table, monkeypatch):
    if table == "analytic":
        # both packages fall back to the analytic jet when matplotlib is
        # missing, as on the GPU machine
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = disparity()
    d[0, :4] = [-0.5, 0.0, 1.0, 1.5]       # clipped at both ends
    out = t_viz.disparity_to_jet(d)
    assert out.shape == d.shape + (3,)
    np.testing.assert_allclose(out, j_viz.disparity_to_jet(d), rtol=0,
                               atol=1e-6)
    if table == "analytic":
        np.testing.assert_allclose(out[0, 2], [0.5, 0.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_blinn_phong_matches_jax(seed):
    d = disparity(seed)
    out = t_viz.disparity_to_blinn_phong(d)
    assert out.shape == d.shape + (3,) and np.isfinite(out).all()
    np.testing.assert_allclose(out, j_viz.disparity_to_blinn_phong(d),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("subsample", [3, 100])
def test_ray_bending_objs_match_jax_line_for_line(subsample, tmp_path):
    rng = np.random.RandomState(4)
    initial = rng.randn(2, 5, 6, 3).astype(np.float32)
    bent = initial + 0.01 * rng.randn(*initial.shape).astype(np.float32)
    t_viz.export_ray_bending_objs(initial, bent, str(tmp_path / "t"),
                                  subsample=subsample,
                                  rng=np.random.RandomState(7))
    j_viz.export_ray_bending_objs(initial, bent, str(tmp_path / "j"),
                                  subsample=subsample,
                                  rng=np.random.RandomState(7))
    for suffix in ("_bent.obj", "_not_bent.obj", "_deltas.obj"):
        ours = (tmp_path / f"t{suffix}").read_text().splitlines()
        theirs = (tmp_path / f"j{suffix}").read_text().splitlines()
        assert ours == theirs and len(ours) > 0
    n_rays = min(subsample, 10)
    faces = [line for line in (tmp_path / "t_bent.obj").read_text().splitlines()
             if line.startswith("f ")]
    assert len(faces) == n_rays * 5
