"""The time-conditioned baseline's point query and renderer in the port
against the JAX package's, on the same parameters, rays and random draws
(CPU).

Tolerances:
- fused_kernel="off", f32: 1e-5 on every output, as tests/test_torch_render.py
  (the MLP's f32 sums in another order, then the resampling).
- The 8 x 256 baseline with fused_kernel="on": the port runs `mlp_fwd` /
  `mlp_bwd`'s plain versions at 128 lanes, JAX runs `_mlp_core` in Pallas
  interpret mode on the same 128-lane input: raw within `BF16_TOL_MAX` of
  `ops/kernels/mlp_fwd.py`, rendered outputs within 1e-4 (bf16 rounding
  flips inside the MLP, then the resampling), as at 64 lanes. The kernel
  path against the f32 path ("off"): 3e-2, the JAX package's own bound
  (tests/test_fused_kernel.py:216).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch.apps.render_path import render_path as t_render_path
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.engine.render import render_rays as t_render_rays
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import mlp_fwd_points
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.apps.render_path import render_path as j_render_path
from nonrigid_nerf_tpu.engine import query as j_query
from tests.test_torch_baseline import FLAGSHIP_TC, NARROW_TC
from tests.test_torch_render import (RS, _rays, _render_rays_both, _t_rs,
                                     assert_outputs_close, interpret_pallas,
                                     render_both, render_port)
from tests.torch_parity import jax_params, torch_cfg

assert interpret_pallas      # a fixture, used by name below


def _query_both(cfg, seed=14):
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    rng = np.random.RandomState(seed)
    pts = rng.randn(4, 32, 3).astype(np.float32)
    lat = (0.3 * rng.randn(4, cfg.ray_bending_latent_size)).astype(np.float32)
    with torch.no_grad():
        got = t_query.query_points(model, torch_cfg(cfg), torch.from_numpy(pts),
                                   None, torch.from_numpy(lat))
    want = j_query.query_points(tree, cfg, jnp.asarray(pts), None,
                                jnp.asarray(lat))
    return got.numpy(), np.asarray(want)


def test_query_points_off_matches_jax():
    got, want = _query_both(NARROW_TC)
    assert got.shape == (4, 32, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_query_points_on_matches_pallas_interpret(interpret_pallas):
    got, want = _query_both(FLAGSHIP_TC)
    err = np.abs(got - want)
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN
    # the kernel path against the f32 path
    off, _ = _query_both(dataclasses.replace(FLAGSHIP_TC, fused_kernel="off"))
    np.testing.assert_allclose(got, off, atol=3e-2)


RENDER_CASES = {
    "off": (NARROW_TC, {}, {}),
    "off-requery": (dataclasses.replace(NARROW_TC, stage1_reuse=False), {}, {}),
    "off-detailed": (NARROW_TC, {}, dict(detailed=True)),
    "off-viewdirs": (dataclasses.replace(NARROW_TC, use_viewdirs=True), {}, {}),
    "on": (FLAGSHIP_TC, {}, {}),
    "on-requery": (dataclasses.replace(FLAGSHIP_TC, stage1_reuse=False), {}, {}),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_rays_matches_jax(case, interpret_pallas):
    """Both passes with the training draws handed over (jitter, density
    noise, importance samples), `raw` of the fine pass compared too: the
    fine pass needs every sample's latent, the coarse samples' as well as
    the new ones'."""
    cfg, _, flags = RENDER_CASES[case]
    rs = dataclasses.replace(RS, perturb=1.0, raw_noise_std=1.0)
    n = 12 if cfg.fused_kernel == "off" else 4
    out, ref = _render_rays_both(cfg, rs, n=n, key=jax.random.PRNGKey(4),
                                 retraw=True, **flags)
    assert set(out) == set(ref)
    raw, raw_ref = out.pop("raw"), ref.pop("raw")
    assert raw.shape == (n, 16, 4)
    if cfg.fused_kernel == "off":
        assert_outputs_close(out, ref, 1e-5)
        np.testing.assert_allclose(raw.numpy(), np.asarray(raw_ref),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_outputs_close(out, ref, 1e-4)
        err = np.abs(raw.numpy() - np.asarray(raw_ref))
        assert err.max() <= K.BF16_TOL_MAX


def test_reuse_renders_what_the_requery_renders():
    rs = dataclasses.replace(RS, perturb=1.0, raw_noise_std=1.0)
    a, _ = _render_rays_both(NARROW_TC, rs, key=jax.random.PRNGKey(5))
    b, _ = _render_rays_both(dataclasses.replace(NARROW_TC, stage1_reuse=False),
                             rs, key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(a["rgb_map"].numpy(), b["rgb_map"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_renderer_in_test_mode_matches_jax(interpret_pallas):
    out, ref = render_both(NARROW_TC, RS)
    assert float(out["acc_map"].min()) > 0.05      # the scene is not empty
    assert_outputs_close(out, ref, 1e-5)
    out, ref = render_both(FLAGSHIP_TC, RS, n=6, chunk=4)
    assert_outputs_close(out, ref, 1e-4)


def test_fused_path_reaches_mlp_fwd_at_128_lanes(monkeypatch):
    """Rendering reaches `mlp_fwd`'s kernel on its points input at 128
    lanes: the points and each ray's latent (R, 32), which the kernel places
    in lanes 63-94."""
    calls = []

    def spy(pts, mw, latents=None, samples_per_ray=1):
        calls.append((tuple(pts.shape), pts.dtype, tuple(latents.shape),
                      samples_per_ray, tuple(mw[0].shape)))
        return mlp_fwd_points(pts, mw, latents, samples_per_ray)

    monkeypatch.setattr(t_query, "mlp_fwd_points", spy)
    render_port(FLAGSHIP_TC, RS, n=6, chunk=4)
    # 2 blocks x (coarse 4 x 8 points, fine 4 x 16 points)
    f32 = torch.float32
    assert calls == [((32, 3), f32, (4, 32), 8, (128, 256)),
                     ((64, 3), f32, (4, 32), 16, (128, 256))] * 2


def test_training_render_sends_the_latents_gradient_through_mlp_core(
        monkeypatch):
    """Under autograd the fused path calls `MLPCore` on the f32 128-lane
    input, and the latents get their gradient through it alone (no bender)."""
    from nonrigid_nerf_torch.ops.kernels.mlp_bwd import MLPCore
    seen = []
    orig_apply = MLPCore.apply
    monkeypatch.setattr(t_query.MLPCore, "apply", staticmethod(
        lambda emb, *w: seen.append((tuple(emb.shape[1:]), emb.dtype))
        or orig_apply(emb, *w)))
    tree = jax_params(FLAGSHIP_TC)
    model = params_from_jax(tree, torch_cfg(FLAGSHIP_TC), device="cpu")
    o, d, _ = (torch.from_numpy(a) for a in _rays(3, 32))
    lat = model.latents[torch.tensor([0, 1, 2])]
    out = t_render_rays(model, torch_cfg(FLAGSHIP_TC), _t_rs(RS).test_mode(),
                        o, d, lat)
    assert seen == [((128,), torch.float32)] * 2
    (g,) = torch.autograd.grad(out["rgb_map"].sum(), [model.latents])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_render_path_matches_jax():
    cfg = NARROW_TC
    tree = jax_params(cfg, num_timesteps=2)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    intr = [dict(height=6, width=5, focal_x=6.0, focal_y=6.0, center_x=2.5,
                 center_y=3.0)] * 2
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[1, 0, 3] = 0.1
    rgbs, disps = t_render_path(model, torch_cfg(cfg), _t_rs(RS), poses, intr,
                                tree["latents"], chunk=16, verbose=False,
                                device="cpu")
    jrgbs, jdisps = j_render_path(tree, cfg, RS, poses, intr, tree["latents"],
                                  chunk=16, verbose=False)
    np.testing.assert_allclose(rgbs, jrgbs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(disps, jdisps, rtol=1e-5, atol=1e-5)
    # the two frames' latents differ, and so do the frames
    assert float(np.abs(rgbs[0] - rgbs[1]).max()) > 1e-4
