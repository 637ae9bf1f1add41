"""Training of the view-direction model family of the port against the JAX
package (CPU): one whole step on the same parameters, ray batch and random
draws; the path of the view encoding's gradient into the deformation field;
and the entry points `apps.train.train` and `render_path`.

Tolerances of the step: those of tests/test_torch_train_step.py (`TOL`), for
the same reasons. fused_kernel="on" runs the plain versions of `mlpv_fwd` and
`mlpv_bwd` against `_mlpv_core` in Pallas interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import checkpoints as t_ckpt
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.weights import (params_from_jax, params_to_jax,
                                         tree_from_named)
from nonrigid_nerf_tpu.config import ModelConfig
from nonrigid_nerf_tpu.engine import train_state as j_state
from nonrigid_nerf_tpu.engine import train_step as j_step
from tests.test_torch_render import _rays, interpret_pallas
from tests.test_torch_train_step import (N_RAYS, TC, TOL, _t_rs, _t_tc,
                                         assert_rel, assert_tree_rel,
                                         both_sides, jax_losses_and_grads)
from tests.test_torch_train_step import RS as RS_TRAIN
from tests.test_torch_viewdirs import FLAGSHIP_V, MODES, NARROW_V, _cfg
from tests.torch_parity import jax_params, torch_cfg

assert interpret_pallas      # a fixture, used by name below


STEP_CASES = [pytest.param(_cfg(NARROW_V, "fd"), "float32", id="fd-off-f32"),
              pytest.param(_cfg(NARROW_V, "exact"), "float32",
                           id="exact-off-f32"),
              pytest.param(_cfg(NARROW_V, "exact"), "float64",
                           id="exact-off-f64"),
              pytest.param(_cfg(FLAGSHIP_V, "fd"), "float32", id="fd-on-f32"),
              pytest.param(_cfg(FLAGSHIP_V, "exact"), "float32",
                           id="exact-on-f32")]


@pytest.fixture
def x64_if_needed(request):
    if request.getfixturevalue("dtype") == "float64":
        with jax.enable_x64():
            yield
    else:
        yield


@pytest.mark.parametrize("cfg,dtype", STEP_CASES)
def test_one_viewdirs_step_matches_jax(cfg, dtype, x64_if_needed,
                                       interpret_pallas):
    """Per-ray losses, their components, every gradient leaf (the four heads,
    the bender and the latents among them) and the parameters after Adam."""
    tol_loss, tol_grad, tol_l2 = TOL[(cfg.fused_kernel, dtype)]
    (state, batch, draws), (jstate, jbatch, key, jcfg) = both_sides(cfg, dtype)
    step_args = dict(cfg=torch_cfg(cfg), tc=_t_tc(TC), rs=_t_rs(RS_TRAIN),
                     has_test_split=True, n_rand=N_RAYS)

    losses, aux, grads = t_step.losses_and_grads(
        state.model, state.step, batch, draws=draws, **step_args)
    jlosses, jaux, jgrads = jax_losses_and_grads(
        jstate.params, jbatch, key, 0, jcfg, TC, RS_TRAIN, True, N_RAYS)
    assert_rel(losses, jlosses, tol_loss, "losses")
    assert set(aux) == set(jaux)
    for k in aux:
        assert_rel(aux[k], jaux[k], 5 * tol_loss, k)
    assert set(grads) == {n for n, _ in state.model.named_parameters()}
    for head in ("feature", "alpha", "views.0", "rgb"):
        assert float(grads[f"fine.{head}.weight"].abs().max()) > 0
    assert_tree_rel(tree_from_named(grads), jgrads, tol_grad, tol_l2)

    t_step.train_step_from_batch(state, batch, draws=draws, **step_args)
    new_jstate, _ = j_step.train_step_from_batch(
        jstate, jbatch, key, cfg=jcfg, tc=TC, rs=RS_TRAIN,
        optimizer=j_state.make_optimizer(TC), has_test_split=True,
        n_rand=N_RAYS)
    assert state.step == int(new_jstate.step) == 1
    if cfg.fused_kernel == "on":
        assert_tree_rel(params_to_jax(state.model), new_jstate.params, 0.0,
                        atol=2 * TC.lrate, mean_atol=0.05 * TC.lrate)
    else:
        assert_tree_rel(params_to_jax(state.model), new_jstate.params, 0.0,
                        atol=0.05 * TC.lrate)


@pytest.mark.parametrize("mode", ["fd", "exact"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_view_encoding_gradient_reaches_the_bender(monkeypatch, mode, fused):
    """In both modes the directions depend on the bent points, so the
    gradient of the view encoding (dembv from `mlpv_bwd` with the kernels)
    flows back into the deformation field and the latents. Shown by cutting
    that one path: the bender's and the latents' gradients change, the
    canonical MLP's do not."""
    base = FLAGSHIP_V if fused == "on" else NARROW_V
    cfg = _cfg(base, mode)
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    o, d, _ = (torch.from_numpy(a) for a in
               _rays(4, cfg.ray_bending_latent_size, 2))
    rng = np.random.RandomState(3)
    pts = o[:, None] + d[:, None] * torch.linspace(0.5, 2.5, 6)[None, :, None]
    vd = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    cot = torch.from_numpy(rng.randn(4, 6, 4).astype(np.float32))
    names = ["bender.bend.0.weight", "bender.bend.3.weight",
             "bender.rigidity.0.weight", "latents", "coarse.views.0.weight",
             "coarse.pts.0.weight"]
    params = dict(model.named_parameters())

    def grads():
        lat = model.latents[torch.tensor([0, 1, 2, 0])]
        raw = t_query.query_points(model, torch_cfg(cfg), pts, vd, lat)
        return dict(zip(names, torch.autograd.grad(
            raw, [params[n] for n in names], cot)))

    full = grads()
    embed = t_query._embed_views
    monkeypatch.setattr(t_query, "_embed_views",
                        lambda c, dirs: embed(c, dirs.detach()))
    cut = grads()
    for name in names[:4]:
        gap = float((full[name] - cut[name]).abs().max())
        assert gap > 1e-3 * float(full[name].abs().max()) > 0, name
    for name in names[4:]:
        assert torch.equal(full[name], cut[name]), name


# ---- the entry points: train, resume, render

@pytest.mark.parametrize("mode", ["fd", "exact"])
def test_train_resumes_bit_equal_and_render_path_matches_jax(mode, tmp_path):
    """`apps.train.train` on a view-direction model: a run stopped after a
    save and started again ends bit-equal to one never stopped; the trained
    model goes through `render_path`, and the JAX `render_path` renders the
    same frames from the checkpoint's tree (f32, 1e-5)."""
    from nonrigid_nerf_torch.apps.render_path import render_path as t_render_path
    from nonrigid_nerf_torch.apps.train import train
    from nonrigid_nerf_tpu.apps.render_path import render_path as j_render_path
    from tests.test_torch_train_app import CFG, RS, TC, make_dataset

    ds = make_dataset()
    cfg = dataclasses.replace(CFG, use_viewdirs=True, **MODES[mode])
    tc = dataclasses.replace(TC, N_iters=6)
    whole = train(cfg, tc, RS, ds, str(tmp_path / "whole"), device="cpu",
                  i_print=3, i_weights=3)
    logdir = str(tmp_path / "stopped")
    train(cfg, tc, RS, ds, logdir, device="cpu", i_print=3, i_weights=3,
          max_steps=3)
    resumed = train(cfg, tc, RS, ds, logdir, device="cpu", i_print=3,
                    i_weights=3)
    assert whole.step == resumed.step == 6
    for (name, a), b in zip(whole.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(a, b), name
    for name in whole.mu:
        assert torch.equal(whole.mu[name], resumed.mu[name])
        assert torch.equal(whole.nu[name], resumed.nu[name])
    assert float(whole.mu["coarse.views.0.weight"].abs().max()) > 0
    assert float(whole.mu["bender.bend.0.weight"].abs().max()) > 0

    intr = [dict(height=6, width=5, focal_x=6.0, focal_y=6.0, center_x=2.5,
                 center_y=3.0)] * 2
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[:, 2, 3] = 4.0
    poses[1, 0, 3] = 0.1
    latents = whole.model.latents.detach().numpy()[:2]
    rgbs, disps = t_render_path(whole.model, cfg, RS, poses, intr, latents,
                                chunk=16, verbose=False, device="cpu")
    _, tree, _ = t_ckpt.read_checkpoint(str(tmp_path / "whole" / "latest.npz"))
    jcfg = ModelConfig(**dataclasses.asdict(cfg))
    from nonrigid_nerf_tpu.config import RenderSettings as JRenderSettings
    jrgbs, jdisps = j_render_path(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        JRenderSettings(**dataclasses.asdict(RS)), poses, intr, latents,
        chunk=16, verbose=False)
    assert rgbs.shape == (2, 6, 5, 3) and np.isfinite(rgbs).all()
    np.testing.assert_allclose(rgbs, jrgbs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(disps, jdisps, rtol=1e-5, atol=1e-5)
