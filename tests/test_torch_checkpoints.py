"""Checkpoints across the two packages (CPU).

- A checkpoint written by the JAX package is read by the port, and a block
  of rays renders the same in both (fused_kernel="off", f32: tolerance 1e-5
  as in tests/test_torch_render.py).
- Training resumes across the packages in both directions: parameters,
  Adam's moments and the counts carry over and the next step agrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch.checkpoints import load_checkpoint, read_checkpoint
from nonrigid_nerf_torch.engine.render import make_ray_renderer as t_renderer
from nonrigid_nerf_tpu.checkpoints import save_checkpoint
from nonrigid_nerf_tpu.config import ModelConfig, RenderSettings
from nonrigid_nerf_tpu.engine.render import make_ray_renderer as j_renderer
from nonrigid_nerf_tpu.engine.train_state import make_optimizer
from nonrigid_nerf_tpu.config import TrainConfig
from tests.test_torch_render import _rays, _t_rs
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig(netwidth=32, netwidth_fine=32, bending_width=16,
                  rigidity_width=8, ray_bending_latent_size=8,
                  N_samples=8, N_importance=8, fused_kernel="off")
RS = RenderSettings(N_samples=8, N_importance=8, near=0.5, far=2.5).test_mode()


@pytest.fixture
def ckpt(tmp_path):
    tree = jax_params(CFG, num_timesteps=4)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = make_optimizer(TrainConfig()).init(params)
    path = str(tmp_path / "000123.npz")
    save_checkpoint(path, 123, params, opt_state,
                    extras={"near": 0.5, "far": 2.5})
    return path, tree


def test_read_checkpoint_restores_params_tree(ckpt):
    path, tree = ckpt
    step, params, extras = read_checkpoint(path)
    assert step == 123 and extras == {"near": 0.5, "far": 2.5}
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(got) == len(flat)
    for key, leaf in flat:
        np.testing.assert_array_equal(got[key], leaf)
    assert isinstance(params["coarse"]["pts"], list)


def test_checkpoint_renders_like_jax(ckpt):
    path, tree = ckpt
    step, model, _ = load_checkpoint(path, torch_cfg(CFG), device="cpu")
    o, d, _ = _rays(21, 8, seed=3)
    # per-ray latents gathered from the table, as render_path does per frame
    lat = tree["latents"][np.arange(21) % 4]
    ref = j_renderer(CFG, RS, chunk=8)(tree, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(lat), None)
    out = t_renderer(torch_cfg(CFG), _t_rs(RS), chunk=8, device="cpu")(
        model, torch.from_numpy(o), torch.from_numpy(d),
        model.latents[torch.arange(21) % 4].detach())
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_only_npz_is_read(tmp_path):
    with pytest.raises(ValueError, match="npz"):
        read_checkpoint(str(tmp_path / "latest.orbax"))


# ---- writing, the Adam state both ways, resume across the two packages

import dataclasses

from nonrigid_nerf_torch import checkpoints as t_ckpt
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import train_state as t_state
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.weights import (params_from_jax, params_to_jax,
                                         tree_from_named)
from nonrigid_nerf_tpu import checkpoints as j_ckpt
from nonrigid_nerf_tpu.engine import train_state as j_state
from nonrigid_nerf_tpu.engine import train_step as j_step
from tests.torch_parity import jax_step_draws, ray_batch

TC = TrainConfig(N_rand=16, N_iters=1000, warmup_steps=10,
                 offsets_loss_weight=60.0, divergence_loss_weight=3.0,
                 rigidity_loss_weight=5e-4)
RS_TRAIN = RenderSettings(N_samples=8, N_importance=8, near=0.5, far=2.5,
                          perturb=1.0, raw_noise_std=1.0)
KEY = jax.random.PRNGKey(11)


def _port_step(state, step):
    batch = ray_batch(16, 4, seed=step)
    tb = {k: torch.from_numpy(v).to(torch.int64 if k == "timestep_ids"
                                    else torch.float32)
          for k, v in batch.items()}
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in jax_step_draws(KEY, step, 16, 8, 8).items()}
    t_step.train_step_from_batch(
        state, tb, draws=draws, cfg=torch_cfg(CFG),
        tc=t_config.TrainConfig(**dataclasses.asdict(TC)),
        rs=t_config.RenderSettings(**dataclasses.asdict(RS_TRAIN)),
        has_test_split=True, n_rand=16)


def _jax_step(jstate, step):
    batch = {k: jnp.asarray(v) for k, v in ray_batch(16, 4, seed=step).items()}
    new_state, _ = j_step.train_step_from_batch(
        jstate, batch, KEY, cfg=CFG, tc=TC, rs=RS_TRAIN,
        optimizer=j_state.make_optimizer(TC), has_test_split=True, n_rand=16)
    return new_state


def _assert_trees_close(got, want, atol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, a), b in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _jax_state_after(steps):
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(CFG, num_timesteps=4))
    jstate = j_state.TrainState(
        params=params, opt_state=j_state.make_optimizer(TC).init(params),
        step=jnp.zeros((), jnp.int32))
    for step in range(steps):
        jstate = _jax_step(jstate, step)
    return jstate


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """Two JAX steps, a JAX checkpoint, then step 2 in both packages: the
    moments, the counts and the schedule carry over. Parameters after the
    step within 5% of lrate (an entry with a gradient near 0, see
    tests/test_torch_train_step.py)."""
    jstate = _jax_state_after(2)
    path = str(tmp_path / "latest.npz")
    j_ckpt.save_checkpoint(path, 2, jstate.params, jstate.opt_state,
                           extras={"near": 0.5})
    state, extras = t_ckpt.load_train_state(path, torch_cfg(CFG), device="cpu")
    assert state.step == 2 and extras == {"near": 0.5}
    _assert_trees_close(tree_from_named(state.mu), jstate.opt_state[0].mu, 0)
    _assert_trees_close(tree_from_named(state.nu), jstate.opt_state[0].nu, 0)
    _port_step(state, 2)
    want = _jax_step(jstate, 2)
    assert state.step == 3 == int(want.step)
    _assert_trees_close(params_to_jax(state.model), want.params,
                        0.05 * TC.lrate)
    _assert_trees_close(tree_from_named(state.mu), want.opt_state[0].mu, 1e-6)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port's checkpoint is read by the JAX package's own loader and
    `restore_opt_state`, and one more step agrees."""
    start = params_from_jax(jax_params(CFG, num_timesteps=4), torch_cfg(CFG),
                            device="cpu")
    state = t_state.TrainState(model=start, mu=t_state.zero_moments(start),
                               nu=t_state.zero_moments(start), step=0)
    _port_step(state, 0)
    path = str(tmp_path / "latest.npz")
    t_ckpt.save_checkpoint(path, state.step, state.model,
                           (state.mu, state.nu), {"near": 0.5, "far": 2.5})

    step, params, opt_tree, extras = j_ckpt.load_checkpoint(path)
    assert step == 1 and extras == {"near": 0.5, "far": 2.5}
    template = j_state.make_optimizer(TC).init(
        jax.tree_util.tree_map(jnp.asarray, params))
    opt_state = j_ckpt.restore_opt_state(template, opt_tree)
    assert int(opt_state[0].count) == 1 == int(opt_state[1].count)
    assert opt_state[0].count.dtype == jnp.int32
    _assert_trees_close(params_to_jax(state.model), params, 0)
    resumed = j_state.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=opt_state, step=jnp.asarray(step, jnp.int32))
    want = _jax_step(resumed, 1)
    _port_step(state, 1)
    _assert_trees_close(params_to_jax(state.model), want.params,
                        0.05 * TC.lrate)
    _assert_trees_close(tree_from_named(state.nu), want.opt_state[0].nu, 1e-6)


def test_port_checkpoint_round_trip_is_bit_equal(tmp_path):
    state = t_state.create_train_state(
        torch_cfg(CFG), t_config.TrainConfig(seed=3), 4, device="cpu")
    _port_step(state, 0)
    path = str(tmp_path / "latest.npz")
    t_ckpt.save_checkpoint(path, state.step, state.model, (state.mu, state.nu))
    loaded, extras = t_ckpt.load_train_state(path, torch_cfg(CFG), device="cpu")
    assert extras == {} and loaded.step == 1
    for (n, a), (_, b) in zip(state.model.named_parameters(),
                              loaded.model.named_parameters()):
        assert torch.equal(a, b), n
    for n in state.mu:
        assert torch.equal(state.mu[n], loaded.mu[n]), n
        assert torch.equal(state.nu[n], loaded.nu[n]), n
    _port_step(state, 1)
    _port_step(loaded, 1)
    for (n, a), (_, b) in zip(state.model.named_parameters(),
                              loaded.model.named_parameters()):
        assert torch.equal(a, b), n


def test_checkpoint_without_optimizer_state_loads_zero_moments(tmp_path):
    state = t_state.create_train_state(
        torch_cfg(CFG), t_config.TrainConfig(seed=3), 4, device="cpu")
    path = str(tmp_path / "000007.npz")
    t_ckpt.save_checkpoint(path, 7, state.model)
    loaded, _ = t_ckpt.load_train_state(path, torch_cfg(CFG), device="cpu")
    assert loaded.step == 7
    assert all(float(m.abs().max()) == 0.0 for m in loaded.mu.values())
    with pytest.raises(ValueError, match="npz"):
        t_ckpt.save_checkpoint(str(tmp_path / "x.orbax"), 1, state.model)


def test_find_and_latest_checkpoint_match_jax(tmp_path):
    assert t_ckpt.find_checkpoints(str(tmp_path / "missing")) == []
    assert t_ckpt.latest_checkpoint(str(tmp_path)) is None
    for name in ("000100.npz", "050000.npz", "notes.npz", "000100.tmp.npz",
                 "args.txt"):
        (tmp_path / name).write_bytes(b"")
    assert (t_ckpt.find_checkpoints(str(tmp_path))
            == j_ckpt.find_checkpoints(str(tmp_path)))
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith("050000.npz")
    (tmp_path / "latest.npz").write_bytes(b"")
    assert (t_ckpt.latest_checkpoint(str(tmp_path))
            == j_ckpt.latest_checkpoint(str(tmp_path)))
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith("latest.npz")
