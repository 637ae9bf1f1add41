"""Training of the time-conditioned baseline in the port against the JAX
package (CPU): one whole two-phase step on the same parameters, ray batch
and random draws, and the entry points `apps.train.train` and
`render_path`.

Without a bender the latents learn only through the canonical MLPs' input,
so the latents' gradient is held on its own: nonzero, in both phases (the
test rays move the latents alone), and equal to JAX's.

Tolerances of the step: those of tests/test_torch_train_step.py (`TOL`),
for the same reasons. fused_kernel="on" runs the plain versions of
`mlp_fwd` and `mlp_bwd` at 128 lanes against `_mlp_core` in Pallas
interpret mode. The loss weights are those of the baseline's run
(results/r4_baseline_tc/args.txt): offsets, divergence and rigidity 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import checkpoints as t_ckpt
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.weights import params_to_jax, tree_from_named
from nonrigid_nerf_tpu.config import ModelConfig
from nonrigid_nerf_tpu.engine import train_state as j_state
from nonrigid_nerf_tpu.engine import train_step as j_step
from tests.test_torch_baseline import FLAGSHIP_TC, NARROW_TC
from tests.test_torch_render import interpret_pallas
from tests.test_torch_train_step import (N_RAYS, TC, TOL, _t_rs, _t_tc,
                                         assert_rel, assert_tree_rel,
                                         both_sides, jax_losses_and_grads)
from tests.test_torch_train_step import RS as RS_TRAIN
from tests.torch_parity import torch_cfg

assert interpret_pallas      # a fixture, used by name below

TC_TC = dataclasses.replace(TC, offsets_loss_weight=0.0,
                            divergence_loss_weight=0.0,
                            rigidity_loss_weight=0.0)

STEP_CASES = [pytest.param(NARROW_TC, "float32", id="off-f32"),
              pytest.param(NARROW_TC, "float64", id="off-f64"),
              pytest.param(FLAGSHIP_TC, "float32", id="on-f32")]


@pytest.fixture
def x64_if_needed(request):
    if request.getfixturevalue("dtype") == "float64":
        with jax.enable_x64():
            yield
    else:
        yield


@pytest.mark.parametrize("cfg,dtype", STEP_CASES)
def test_one_baseline_step_matches_jax(cfg, dtype, x64_if_needed,
                                       interpret_pallas):
    """Per-ray losses, their components, every gradient leaf (the latents'
    named on its own) and the parameters after Adam."""
    tol_loss, tol_grad, tol_l2 = TOL[(cfg.fused_kernel, dtype)]
    (state, batch, draws), (jstate, jbatch, key, jcfg) = both_sides(cfg, dtype)
    step_args = dict(cfg=torch_cfg(cfg), tc=_t_tc(TC_TC), rs=_t_rs(RS_TRAIN),
                     has_test_split=True, n_rand=N_RAYS)

    losses, aux, grads = t_step.losses_and_grads(
        state.model, state.step, batch, draws=draws, **step_args)
    jlosses, jaux, jgrads = jax_losses_and_grads(
        jstate.params, jbatch, key, 0, jcfg, TC_TC, RS_TRAIN, True, N_RAYS)
    assert_rel(losses, jlosses, tol_loss, "losses")
    assert set(aux) == set(jaux) == {"img_loss", "img_loss0"}
    for k in aux:
        assert_rel(aux[k], jaux[k], 5 * tol_loss, k)
    assert set(grads) == {n for n, _ in state.model.named_parameters()}
    assert not [n for n in grads if n.startswith("bender.")]
    assert float(grads["latents"].abs().max()) > 0
    assert_rel(grads["latents"], jgrads["latents"], tol_grad, "latents")
    assert_tree_rel(tree_from_named(grads), jgrads, tol_grad, tol_l2)

    t_step.train_step_from_batch(state, batch, draws=draws, **step_args)
    new_jstate, _ = j_step.train_step_from_batch(
        jstate, jbatch, key, cfg=jcfg, tc=TC_TC, rs=RS_TRAIN,
        optimizer=j_state.make_optimizer(TC_TC), has_test_split=True,
        n_rand=N_RAYS)
    assert state.step == int(new_jstate.step) == 1
    if cfg.fused_kernel == "on":
        assert_tree_rel(params_to_jax(state.model), new_jstate.params, 0.0,
                        atol=2 * TC.lrate, mean_atol=0.05 * TC.lrate)
    else:
        assert_tree_rel(params_to_jax(state.model), new_jstate.params, 0.0,
                        atol=0.05 * TC.lrate)


@pytest.mark.parametrize("cfg", [NARROW_TC, FLAGSHIP_TC], ids=["off", "on"])
def test_test_rays_give_the_latents_a_gradient_through_the_mlp(
        cfg, interpret_pallas):
    """The second phase (test rays, latents only) against JAX's
    (engine/train_step.py:83-86 of the JAX package): without a bender its
    only path to the latents is the canonical MLPs' input."""
    tol_grad = TOL[(cfg.fused_kernel, "float32")][1]
    (state, batch, draws), (jstate, jbatch, key, jcfg) = both_sides(
        cfg, "float32")
    for b in (batch, jbatch):
        b["train_indicator"] = b["train_indicator"] * 0
    _, _, grads = t_step.losses_and_grads(
        state.model, 0, batch, draws=draws, cfg=torch_cfg(cfg),
        tc=_t_tc(TC_TC), rs=_t_rs(RS_TRAIN), has_test_split=True,
        n_rand=N_RAYS)
    _, _, jgrads = jax_losses_and_grads(jstate.params, jbatch, key, 0, jcfg,
                                        TC_TC, RS_TRAIN, True, N_RAYS)
    for name, g in grads.items():
        if name != "latents":
            assert float(g.abs().max()) == 0.0, name
    assert float(grads["latents"].abs().max()) > 0
    assert_rel(grads["latents"], jgrads["latents"], tol_grad, "latents")


def test_train_resumes_bit_equal_and_render_path_matches_jax(tmp_path):
    """`apps.train.train` on the baseline: a run stopped after a save and
    started again ends bit-equal to one never stopped, the latents have
    moved, and the JAX `render_path` renders the same frames from the
    checkpoint's tree (f32, 1e-5)."""
    from nonrigid_nerf_torch.apps.render_path import render_path as t_render_path
    from nonrigid_nerf_torch.apps.train import train
    from nonrigid_nerf_tpu.apps.render_path import render_path as j_render_path
    from nonrigid_nerf_tpu.config import RenderSettings as JRenderSettings
    from tests.test_torch_train_app import CFG, RS, TC as TC_APP, make_dataset

    ds = make_dataset()
    cfg = dataclasses.replace(CFG, ray_bending=None,
                              time_conditioned_baseline=True)
    tc = dataclasses.replace(TC_APP, N_iters=6, offsets_loss_weight=0.0,
                             divergence_loss_weight=0.0,
                             rigidity_loss_weight=0.0)
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
    assert whole.model.bender is None
    assert float(whole.model.latents.detach().abs().max()) > 0
    assert float(whole.mu["latents"].abs().max()) > 0

    intr = [dict(height=6, width=5, focal_x=6.0, focal_y=6.0, center_x=2.5,
                 center_y=3.0)] * 2
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[:, 2, 3] = 4.0
    latents = whole.model.latents.detach().numpy()[:2]
    rgbs, disps = t_render_path(whole.model, cfg, RS, poses, intr, latents,
                                chunk=16, verbose=False, device="cpu")
    _, tree, _ = t_ckpt.read_checkpoint(str(tmp_path / "whole" / "latest.npz"))
    jrgbs, jdisps = j_render_path(
        jax.tree_util.tree_map(jnp.asarray, tree),
        ModelConfig(**dataclasses.asdict(cfg)),
        JRenderSettings(**dataclasses.asdict(RS)), poses, intr, latents,
        chunk=16, verbose=False)
    assert rgbs.shape == (2, 6, 5, 3) and np.isfinite(rgbs).all()
    np.testing.assert_allclose(rgbs, jrgbs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(disps, jdisps, rtol=1e-5, atol=1e-5)
