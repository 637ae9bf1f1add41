"""The view-direction model family of the port against the JAX package, on
the same parameters, rays and random draws (CPU).

Tolerances:
- `sample_viewdirs`: f32, 1e-5 (observed 4e-7): unit vectors from a few f32
  products. `_finite_difference_viewdirs` alone, in f64: 1e-12.
- `render_rays`, fused_kernel="off", f32: 1e-5 on every output (observed
  1.4e-6), as tests/test_torch_render.py. With finite-difference directions
  the per-sample `raw` is held to 1e-4 (observed 3.2e-5): the difference of
  two neighbouring bent points cancels most of their mantissa, and the
  sorted union of a fine pass holds near-duplicates; after compositing the
  outputs agree to 4e-7 again.
- The flagship 8 x 256 with fused_kernel="on": the port runs `mlpv_fwd`'s
  plain version, JAX runs `_mlpv_core` in Pallas interpret mode: 1e-4, as
  for `mlp_fwd` (bf16 rounding flips inside the MLP, then the resampling).

The training step and the entry points are in
tests/test_torch_viewdirs_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import checkpoints as t_ckpt
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.engine import train_state as t_state
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.models.nerf import check_nerf_supported
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import mlp_fwd
from nonrigid_nerf_torch.ops.kernels.mlpv_fwd import mlpv_fwd
from nonrigid_nerf_torch.weights import (params_from_jax, params_to_jax,
                                         tree_from_named)
from nonrigid_nerf_tpu import checkpoints as j_ckpt
from nonrigid_nerf_tpu.config import EditConfig
from nonrigid_nerf_tpu.engine import query as j_query
from nonrigid_nerf_tpu.engine import train_state as j_state
from tests.test_torch_render import (FLAGSHIP, NARROW, RS, _rays,
                                     _render_rays_both, _t_edit,
                                     assert_outputs_close, interpret_pallas,
                                     render_both, render_port)
from tests.test_torch_train_step import TC, _t_tc, assert_tree_rel
from tests.torch_parity import jax_params, torch_cfg

assert interpret_pallas      # a fixture, used by name below

NARROW_V = dataclasses.replace(NARROW, use_viewdirs=True)
FLAGSHIP_V = dataclasses.replace(FLAGSHIP, use_viewdirs=True)
MODES = {"fd": dict(approx_nonrigid_viewdirs=True),
         "exact": dict(approx_nonrigid_viewdirs=False),
         "plain": dict(ray_bending=None)}


def _cfg(base, mode, **kw):
    return dataclasses.replace(base, **MODES[mode], **kw)


# ---- the directions

def _stage1_both(cfg, edit, seed=0, sort=True):
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    rng = np.random.RandomState(seed)
    o, d, lat = _rays(5, cfg.ray_bending_latent_size, seed)
    z = rng.uniform(0.5, 2.5, (5, 7)).astype(np.float32)
    if sort:
        z = np.sort(z, -1)
    pts = o[:, None] + d[:, None] * z[..., None]
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    jst = j_query.bend_encode_stage(tree, cfg, jnp.asarray(pts),
                                    jnp.asarray(lat), edit)
    want = j_query.sample_viewdirs(tree, cfg, jnp.asarray(pts), jst,
                                   jnp.asarray(vd), edit)
    t_pts = torch.from_numpy(pts)
    with torch.no_grad():
        st = t_query.bend_encode_stage(model, torch_cfg(cfg), t_pts,
                                       torch.from_numpy(lat), _t_edit(edit))
        got = t_query.sample_viewdirs(model, torch_cfg(cfg), t_pts, st,
                                      torch.from_numpy(vd), _t_edit(edit))
    return got, want, (st, jst)


@pytest.mark.parametrize("mode,edit", [
    ("fd", EditConfig()), ("exact", EditConfig()), ("plain", EditConfig()),
    ("fd", EditConfig(render_canonical=True)),
    ("exact", EditConfig(rigidity_test_time_cutoff=0.4, test_time_scaling=2.0)),
], ids=["fd", "exact", "plain", "canonical", "exact-edits"])
def test_sample_viewdirs_matches_jax(mode, edit):
    got, want, (st, jst) = _stage1_both(_cfg(NARROW_V, mode), edit)
    assert got.shape == (5, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # unit vectors, up to the 1e-6 beside the norm in the denominator
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-3)
    assert (st["latents_per_pt"] is None) == (jst["latents_per_pt"] is None)
    if mode != "plain" and not edit.render_canonical:
        # a bent ray's directions differ from the straight ray's
        assert float((got - got[:, :1]).abs().max()) > 1e-3


def test_exact_viewdirs_take_samples_in_any_order():
    """Unsorted depths: the jvp is per point, so the exact directions need no
    depth order (the unsorted-union fine pass relies on it)."""
    got, want, _ = _stage1_both(_cfg(NARROW_V, "exact"), EditConfig(),
                                sort=False)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_finite_difference_viewdirs_match_jax_in_f64():
    rng = np.random.RandomState(0)
    bent = rng.randn(4, 9, 3)
    bent[:, 5] = bent[:, 4]           # a duplicate depth: a zero difference
    with jax.enable_x64():
        want = np.asarray(j_query._finite_difference_viewdirs(
            jnp.asarray(bent, jnp.float64)))
    t = torch.from_numpy(bent).requires_grad_(True)
    got = t_query._finite_difference_viewdirs(t)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(got.detach().numpy()[:, 0],
                                  got.detach().numpy()[:, 1])
    np.testing.assert_array_equal(got.detach().numpy()[:, 5], 0.0)
    (g,) = torch.autograd.grad(got.square().sum() + got.sum(), [t])
    assert torch.isfinite(g).all()    # safe_norm: no NaN at the duplicate


# ---- rendering

RENDER_CASES = {
    "fd": ("fd", {}, {}),
    "exact": ("exact", {}, {}),
    "plain": ("plain", {}, {}),
    "fd-requery": ("fd", dict(stage1_reuse=False), {}),
    "exact-requery": ("exact", dict(stage1_reuse=False), {}),
    "fd-detailed": ("fd", {}, dict(detailed=True)),
    "fd-coarse-details": ("fd", {}, dict(detailed=True, fine_detailed=False)),
    "exact-detailed": ("exact", {}, dict(detailed=True)),
    "fd-requery-detailed": ("fd", dict(stage1_reuse=False),
                            dict(detailed=True)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_rays_with_viewdirs_matches_jax(case):
    """Training draws (jitter, density noise, importance samples) handed
    over as tensors; `raw` of the last pass compared too."""
    mode, cfg_kw, flags = RENDER_CASES[case]
    cfg = _cfg(NARROW_V, mode, **cfg_kw)
    rs = dataclasses.replace(RS, perturb=1.0, raw_noise_std=1.0)
    out, ref = _render_rays_both(cfg, rs, key=jax.random.PRNGKey(4),
                                 retraw=True, **flags)
    assert set(out) == set(ref)
    raw, raw_ref = out.pop("raw"), ref.pop("raw")
    assert_outputs_close(out, ref, 1e-5)
    tol = 1e-4 if mode == "fd" else 1e-5
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_ref), rtol=tol,
                               atol=tol)
    if flags.get("detailed") and flags.get("fine_detailed", True):
        assert out["fine_unmasked_offsets"].shape == (12, 16, 3)
        # the fine details come out in depth order, whichever pass sorted
        z = out["fine_initial_input_pts"][..., 2]
        assert bool((z[:, 1:] <= z[:, :-1]).all())     # rays run towards -z
    elif flags.get("detailed"):
        assert not [k for k in out if k.startswith("fine_")]


def test_fd_reuse_renders_what_the_requery_renders():
    """Sort-then-query with the coarse samples bent once against the
    reference's way, up to f32 rounding."""
    rs = dataclasses.replace(RS, perturb=1.0, raw_noise_std=1.0)
    a, _ = _render_rays_both(_cfg(NARROW_V, "fd"), rs,
                             key=jax.random.PRNGKey(5))
    b, _ = _render_rays_both(_cfg(NARROW_V, "fd", stage1_reuse=False), rs,
                             key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(a["rgb_map"].numpy(), b["rgb_map"].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["fd", "exact", "plain"])
def test_renderer_in_test_mode_matches_jax(mode):
    out, ref = render_both(_cfg(NARROW_V, mode), RS)
    assert out["rgb_map"].shape == (37, 3)
    assert float(out["acc_map"].min()) > 0.05      # the scene is not empty
    assert_outputs_close(out, ref, 1e-5)


def test_render_canonical_with_viewdirs_matches_jax():
    cfg = dataclasses.replace(NARROW_V, fused_kernel="auto")
    out, ref = render_both(cfg, RS, EditConfig(render_canonical=True))
    assert_outputs_close(out, ref, 1e-5)


def test_viewdirs_change_the_image():
    """The same weights rendered with both direction estimates: close, not
    equal (as tests/test_engine.py:109-128 of the JAX package)."""
    fd, _ = render_port(_cfg(NARROW_V, "fd"), RS)
    exact, _ = render_port(_cfg(NARROW_V, "exact"), RS)
    assert not torch.equal(fd["rgb_map"], exact["rgb_map"])
    assert float((fd["rgb_map"] - exact["rgb_map"]).abs().max()) < 0.1


@pytest.mark.parametrize("mode", ["fd", "exact"])
def test_flagship_kernel_path_matches_pallas_interpret(mode, interpret_pallas):
    out, ref = render_both(_cfg(FLAGSHIP_V, mode), RS, n=6, chunk=4)
    assert_outputs_close(out, ref, 1e-4)


@pytest.mark.parametrize("mode", ["fd", "exact", "plain"])
def test_fused_path_reaches_mlpv_fwd(monkeypatch, mode):
    calls = []

    def spy(emb, embv, mw):
        calls.append((tuple(emb.shape), tuple(embv.shape), emb.dtype,
                      embv.dtype))
        return mlpv_fwd(emb, embv, mw)

    def no_mlp_fwd(*args):
        raise AssertionError("a view-direction model went through mlp_fwd")

    monkeypatch.setattr(t_query, "mlpv_fwd", spy)
    monkeypatch.setattr(t_query, "mlp_fwd", no_mlp_fwd)
    assert mlp_fwd is not no_mlp_fwd
    render_port(_cfg(FLAGSHIP_V, mode), RS, n=6, chunk=4)
    bf16 = torch.bfloat16
    # 2 blocks x (coarse 4 x 8 points, fine 4 x 16 points)
    assert calls == [((32, 64), (32, 32), bf16, bf16),
                     ((64, 64), (64, 32), bf16, bf16)] * 2


def test_supports_fused_query_with_viewdirs():
    cfg = t_config.ModelConfig(use_viewdirs=True)
    assert t_query.supports_fused_query(cfg)
    assert not t_query.supports_fused_query(
        dataclasses.replace(cfg, multires_views=3))
    cuda = torch.device("cuda")      # a device object only: nothing runs there
    assert t_query.use_fused_kernel(cfg, t_config.EditConfig(), cuda)
    assert not t_query.use_fused_kernel(
        dataclasses.replace(cfg, multires_views=3), t_config.EditConfig(), cuda)
    assert cfg.input_ch_views == 27
    assert t_config.ModelConfig().input_ch_views == 0


def test_what_is_still_not_ported_raises():
    check_nerf_supported(t_config.ModelConfig(use_viewdirs=True))
    # the time-conditioned baseline is ported, with view directions too (on
    # the plain path: its kernel takes the single head only)
    baseline = t_config.ModelConfig(ray_bending=None,
                                    time_conditioned_baseline=True,
                                    use_viewdirs=True)
    check_nerf_supported(baseline)
    assert not t_query.use_fused_kernel(baseline, t_config.EditConfig(),
                                        torch.device("cuda"))
    # compute_dtype="bfloat16" is ported: a view-direction model constructs
    # and runs its MLP in bf16 (raw in f32); an unknown dtype name raises
    bf16 = t_config.ModelConfig(use_viewdirs=True, compute_dtype="bfloat16",
                                netwidth=32, netwidth_fine=32, bending_width=16,
                                rigidity_width=8, ray_bending_latent_size=8)
    check_nerf_supported(bf16)
    net = NRNeRF(bf16, 2, generator=torch.Generator().manual_seed(0),
                 device="cpu").coarse
    raw = net(torch.randn(5, 63), torch.randn(5, 27),
              compute_dtype=torch.bfloat16)
    assert raw.dtype == torch.float32 and raw.shape == (5, 4)
    with pytest.raises(ValueError, match="compute_dtype"):
        check_nerf_supported(t_config.ModelConfig(use_viewdirs=True,
                                                  compute_dtype="float16"))
    # the two opt-in modes are ported for the single-head MLP only: with
    # view directions "pts" raises and "int8" takes the plain f32 MLP
    with pytest.raises(ValueError, match="outside the kernel's support"):
        t_query.use_fused_kernel(
            t_config.ModelConfig(use_viewdirs=True, fused_kernel="pts"),
            t_config.EditConfig(), torch.device("cuda"))
    assert not t_query.use_fused_kernel(
        t_config.ModelConfig(use_viewdirs=True, fused_kernel="int8"),
        t_config.EditConfig(), torch.device("cuda"))


# ---- parameters and checkpoints

def test_params_round_trip_with_the_heads():
    tree = jax_params(NARROW_V)
    model = params_from_jax(tree, torch_cfg(NARROW_V), device="cpu")
    back = params_to_jax(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert set(back["fine"]) == {"pts", "feature", "alpha", "views", "rgb"}
    assert isinstance(back["fine"]["views"], list) and len(back["fine"]["views"]) == 1
    assert back["fine"]["views"][0]["w"].shape == (32 + 27, 16)


def test_params_from_jax_refuses_the_other_family():
    with pytest.raises(ValueError, match="single output head"):
        params_from_jax(jax_params(NARROW), torch_cfg(NARROW_V), device="cpu")
    with pytest.raises(ValueError, match="single output head"):
        params_from_jax(jax_params(NARROW_V), torch_cfg(NARROW), device="cpu")


def test_checkpoint_round_trip_with_the_heads_both_ways(tmp_path):
    """A view-direction checkpoint with optax's Adam state written by the
    JAX package resumes in the port, and the port's resumes there: every
    parameter and both moments of the four heads carry over exactly."""
    cfg = NARROW_V
    tree = jax_params(cfg, num_timesteps=4)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    optimizer = j_state.make_optimizer(TC)
    opt_state = optimizer.init(params)
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), params)
    _, opt_state = optimizer.update(grads, opt_state, params)
    path = str(tmp_path / "000001.npz")
    j_ckpt.save_checkpoint(path, 1, params, opt_state, extras={"near": 0.5})

    state, extras = t_ckpt.load_train_state(path, torch_cfg(cfg), device="cpu")
    assert state.step == 1 and extras == {"near": 0.5}
    assert isinstance(state.model, NRNeRF)
    adam = opt_state[0]
    assert_tree_rel(params_to_jax(state.model), params, 0.0)
    assert_tree_rel(tree_from_named(state.mu), adam.mu, 0.0)
    assert_tree_rel(tree_from_named(state.nu), adam.nu, 0.0)
    assert float(state.mu["fine.views.0.weight"].abs().max()) > 0

    back = str(tmp_path / "latest.npz")
    t_ckpt.save_checkpoint(back, state.step, state.model,
                           (state.mu, state.nu), extras)
    again, _ = t_ckpt.load_train_state(back, torch_cfg(cfg), device="cpu")
    for (name, a), b in zip(state.model.named_parameters(),
                            again.model.parameters()):
        assert torch.equal(a, b), name
    for name in state.mu:
        assert torch.equal(state.mu[name], again.mu[name])
        assert torch.equal(state.nu[name], again.nu[name])
    step, jparams, opt_tree, _ = j_ckpt.load_checkpoint(back)
    jopt = j_ckpt.restore_opt_state(opt_state, opt_tree)
    assert int(step) == 1
    assert_tree_rel(jax.tree_util.tree_map(np.asarray, jparams), params, 0.0)
    assert_tree_rel(jax.tree_util.tree_map(np.asarray, jopt[0].mu), adam.mu, 0.0)
    assert_tree_rel(jax.tree_util.tree_map(np.asarray, jopt[0].nu), adam.nu, 0.0)


def test_fresh_viewdirs_state_has_the_heads():
    cfg = torch_cfg(NARROW_V)
    state = t_state.create_train_state(cfg, _t_tc(TC), 3, device="cpu")
    names = {n for n, _ in state.model.named_parameters()}
    assert {"coarse.alpha.bias", "fine.views.0.weight", "fine.rgb.bias",
            "coarse.feature.weight"} <= names
    assert not [n for n in names if ".output." in n]
    assert set(state.mu) == names
