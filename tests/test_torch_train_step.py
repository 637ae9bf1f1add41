"""One training step of the port against one step of the JAX package, on the
same parameters, the same ray batch and the same random draws (CPU).

The JAX draws are reproduced from its keys (`tests/torch_parity.py:
jax_step_draws`) and handed to the port as tensors. Compared: per-ray
losses, their components, the metrics, every gradient leaf, and the
parameters after Adam.

Tolerances (gradients relative to each leaf's max magnitude):
- fused_kernel="off", f32: losses 1e-5 (observed 9e-8), gradients 1e-2.
  All leaves but two agree to 2e-5; the fine network's first layer, whose
  gradient is a sum of large cancelling terms (max magnitude 7e-6 against
  1e-3 elsewhere), is off by 4.8e-3 of its max: the MLP's sums run in
  another order and the inverse-CDF resampling turns that into depth shifts
  of the fine samples. The JAX package's own reference test allows 1e-2 for
  the same reason (tests/test_reference_e2e.py:365), and the f64 run below
  shows that the algorithm agrees.
- "off", f64: losses 2e-6, gradients 5e-6 (observed 5e-9 and 8.2e-7). The
  JAX package's dense layers accumulate in f32 whatever the inputs
  (models/mlp.py:75), so its f64 mode rounds every layer's output to f32;
  the port's f64 is f64 throughout.
- "on" (the port's plain versions of the kernels against `_mlp_core` in
  Pallas interpret mode), bf16 inside the MLP: losses 1e-4, gradients 5e-2
  of max magnitude and 2e-2 in relative L2 (observed 1.6e-6, 1.5e-2 and
  7e-3): bf16 rounding flips and ReLU gate flips, see
  `ops/kernels/mlp_bwd.py`.
- Parameters after Adam: the first step moves every entry by about
  lrate * g / (|g| + 1e-8), so an entry whose gradient is within rounding
  of 0 may move differently: 5% of lrate, absolute. With the kernels' bf16
  gradients such an entry may even change sign, so there every entry is
  held to 2 * lrate (the most a sign flip can do) and each leaf's mean
  difference to 5% of lrate (observed: worst entry 1.46 * lrate, worst
  leaf mean 0.7% of lrate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import train_state as t_state
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.weights import (params_from_jax, params_to_jax,
                                         tree_from_named)
from nonrigid_nerf_tpu.config import ModelConfig, RenderSettings, TrainConfig
from nonrigid_nerf_tpu.engine import train_state as j_state
from nonrigid_nerf_tpu.engine import train_step as j_step
from nonrigid_nerf_tpu.engine.losses import per_ray_losses as j_per_ray_losses
from nonrigid_nerf_tpu.engine.render import render_rays as j_render_rays
from tests.torch_parity import (jax_params, jax_step_draws, ray_batch,
                                torch_cfg)

NARROW = ModelConfig(netwidth=32, netwidth_fine=32, bending_width=16,
                     rigidity_width=8, ray_bending_latent_size=8,
                     N_samples=8, N_importance=8, fused_kernel="off")
FLAGSHIP = ModelConfig(N_samples=8, N_importance=8, fused_kernel="on")
RS = RenderSettings(N_samples=8, N_importance=8, near=0.5, far=2.5,
                    perturb=1.0, raw_noise_std=1.0)
TC = TrainConfig(N_rand=16, N_iters=1000, lrate=5e-4, warmup_steps=10,
                 offsets_loss_weight=60.0, divergence_loss_weight=3.0,
                 rigidity_loss_weight=5e-4)
N_RAYS, T = 16, 3
TOL = {  # mode: (losses rel, gradient max rel, gradient L2 rel or None)
    ("off", "float32"): (1e-5, 1e-2, None),
    ("off", "float64"): (2e-6, 5e-6, None),
    ("on", "float32"): (1e-4, 5e-2, 2e-2),
}


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


def _t_tc(tc):
    return t_config.TrainConfig(**dataclasses.asdict(tc))


def _t_rs(rs):
    return t_config.RenderSettings(**dataclasses.asdict(rs))


def _torch_batch(batch, dtype):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(torch.int64) if k == "timestep_ids" \
            else t.to(getattr(torch, dtype))
    return out


def _torch_draws(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jax_losses_and_grads(params, batch, key, step, cfg, tc, rs,
                         has_test_split, n_rand):
    """Losses, components and two-phase gradients exactly as the JAX step
    forms them (engine/train_step.py:56-86)."""
    _, k_render, k_loss = jax.random.split(jax.random.fold_in(key, step), 3)

    def losses_fn(p):
        latents = p["latents"][batch["timestep_ids"]]
        out = j_render_rays(p, cfg, rs, batch["rays_o"], batch["rays_d"],
                            latents, key=k_render, detailed=True,
                            fine_detailed=False)
        return j_per_ray_losses(k_loss, p, cfg, tc, out, batch["target_rgb"],
                                latents, step)

    losses, vjp_fn, aux = jax.vjp(losses_fn, params, has_aux=True)
    grads, = vjp_fn(batch["train_indicator"] / float(n_rand))
    if has_test_split:
        test_grads, = vjp_fn(batch["test_indicator"] / float(n_rand))
        grads = {**grads, "latents": grads["latents"] + test_grads["latents"]}
    return losses, aux, grads


def both_sides(cfg, dtype, step=0, seed=0, has_test_split=True):
    """(port state, port batch, port draws), (JAX state, JAX batch, key) for
    one step at `step`, built from the same numpy arrays."""
    tree = jax_params(cfg, num_timesteps=T)
    batch = ray_batch(N_RAYS, T, seed=seed, dtype=dtype)
    if not has_test_split:
        batch["train_indicator"][:] = 1.0
        batch["test_indicator"][:] = 0.0
    key = jax.random.PRNGKey(7)
    draws = jax_step_draws(key, step, N_RAYS, RS.N_samples, RS.N_importance,
                           dtype)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    if dtype == "float64":
        model = model.double()
    state = t_state.TrainState(model=model, mu=t_state.zero_moments(model),
                               nu=t_state.zero_moments(model), step=step)
    jcfg = dataclasses.replace(cfg, compute_dtype=dtype)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = j_state.TrainState(
        params=jparams, opt_state=j_state.make_optimizer(TC).init(jparams),
        step=jnp.asarray(step, jnp.int32))
    return ((state, _torch_batch(batch, dtype), _torch_draws(draws)),
            (jstate, jbatch, key, jcfg))


def assert_rel(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err / scale)


def assert_tree_rel(got_tree, want_tree, tol, tol_l2=None, atol=0.0,
                    mean_atol=None):
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        name, b = jax.tree_util.keystr(path), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        scale = max(np.abs(b).max(), 1e-30)
        err = np.abs(a - b).max()
        assert err <= tol * scale + atol, (name, err / scale)
        if tol_l2 is not None:
            l2 = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert l2 <= tol_l2, (name, l2)
        if mean_atol is not None:
            assert np.abs(a - b).mean() <= mean_atol, (name, np.abs(a - b).mean())


CASES = [pytest.param(NARROW, "float32", id="off-f32"),
         pytest.param(NARROW, "float64", id="off-f64"),
         pytest.param(FLAGSHIP, "float32", id="on-f32")]


@pytest.fixture
def x64_if_needed(request):
    dtype = request.getfixturevalue("dtype")
    if dtype == "float64":
        with jax.enable_x64():
            yield
    else:
        yield


@pytest.mark.parametrize("cfg,dtype", CASES)
def test_one_step_matches_jax(cfg, dtype, x64_if_needed, interpret_pallas):
    tol_loss, tol_grad, tol_l2 = TOL[(cfg.fused_kernel, dtype)]
    (state, batch, draws), (jstate, jbatch, key, jcfg) = both_sides(cfg, dtype)
    step_args = dict(cfg=torch_cfg(cfg), tc=_t_tc(TC), rs=_t_rs(RS),
                     has_test_split=True, n_rand=N_RAYS)

    losses, aux, grads = t_step.losses_and_grads(
        state.model, state.step, batch, draws=draws, **step_args)
    jlosses, jaux, jgrads = jax_losses_and_grads(
        jstate.params, jbatch, key, 0, jcfg, TC, RS, True, N_RAYS)
    assert_rel(losses, jlosses, tol_loss, "losses")
    assert set(aux) == set(jaux)
    for k in aux:
        assert_rel(aux[k], jaux[k], 5 * tol_loss, k)
    assert set(grads) == {n for n, _ in state.model.named_parameters()}
    assert_tree_rel(tree_from_named(grads), jgrads, tol_grad, tol_l2)

    metrics = t_step.train_step_from_batch(state, batch, draws=draws,
                                           debug_metrics=True, **step_args)
    new_jstate, jmetrics = j_step.train_step_from_batch(
        jstate, jbatch, key, cfg=jcfg, tc=TC, rs=RS,
        optimizer=j_state.make_optimizer(TC), has_test_split=True,
        n_rand=N_RAYS, debug_metrics=True)
    assert state.step == int(new_jstate.step) == 1
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=max(5 * tol_loss, tol_grad), err_msg=k)
    if cfg.fused_kernel == "on":
        assert_tree_rel(params_to_jax(state.model), new_jstate.params, 0.0,
                        atol=2 * TC.lrate, mean_atol=0.05 * TC.lrate)
    else:
        assert_tree_rel(params_to_jax(state.model), new_jstate.params, 0.0,
                        atol=0.05 * TC.lrate)
    adam = new_jstate.opt_state[0]
    assert_tree_rel(tree_from_named(state.mu), adam.mu, tol_grad, tol_l2)


def test_three_step_adam_trajectory_matches_jax():
    """Steps 0, 1, 2 with fresh draws each: the schedule's alignment (step 0
    at the raw lrate, then the warm-up divisor), the bias correction and the
    moments carry over as in optax."""
    (state, _, _), (jstate, _, key, jcfg) = both_sides(NARROW, "float32")
    optimizer = j_state.make_optimizer(TC)
    step_args = dict(cfg=torch_cfg(NARROW), tc=_t_tc(TC), rs=_t_rs(RS),
                     has_test_split=True, n_rand=N_RAYS)
    for step in range(3):
        batch = ray_batch(N_RAYS, T, seed=10 + step)
        draws = jax_step_draws(key, step, N_RAYS, 8, 8)
        metrics = t_step.train_step_from_batch(
            state, _torch_batch(batch, "float32"), draws=_torch_draws(draws),
            **step_args)
        jstate, jmetrics = j_step.train_step_from_batch(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
            cfg=jcfg, tc=TC, rs=RS, optimizer=optimizer, has_test_split=True,
            n_rand=N_RAYS)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-4)
    assert state.step == 3 == int(jstate.step)
    # three steps of at most lrate each; the steps after the first run at
    # lrate / 21 and lrate / 19: 5% of lrate covers entries near g = 0
    assert_tree_rel(params_to_jax(state.model), jstate.params, 0.0,
                    atol=0.05 * TC.lrate)
    moved = np.abs(np.asarray(jstate.params["coarse"]["pts"][0]["w"])
                   - jax_params(NARROW, num_timesteps=T)["coarse"]["pts"][0]["w"])
    assert moved.max() > 0.9 * TC.lrate          # the comparison is not vacuous


def test_lr_schedule_matches_jax_over_2500_steps():
    tc = TrainConfig(lrate=5e-4, lrate_decay=250000, warmup_steps=1000)
    sched = j_state.lr_schedule(tc)
    want = np.asarray(jax.vmap(sched)(jnp.arange(2501)))
    got = np.array([t_state.lr_schedule(_t_tc(tc), k) for k in range(2501)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 5e-4                                  # the raw lrate
    np.testing.assert_allclose(got[1], 5e-4 / 21.0, rtol=1e-12)
    # the reference's loop (train.py:1631-1643): the rate is recomputed
    # AFTER the step from the pre-increment global step
    ref_lr = 5e-4
    for global_step in range(2500):
        np.testing.assert_allclose(got[global_step], ref_lr, rtol=1e-12)
        ref_lr = 5e-4 * (0.1 ** (global_step / 250000))
        if global_step < 1000:
            ref_lr /= 20.0 * (-(global_step - 1000) / 1000) + 1.0


def test_adam_update_matches_optax_on_given_gradients():
    import optax
    tree = jax_params(NARROW, num_timesteps=T)
    model = params_from_jax(tree, torch_cfg(NARROW), device="cpu")
    state = t_state.TrainState(model=model, mu=t_state.zero_moments(model),
                               nu=t_state.zero_moments(model), step=0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    optimizer = j_state.make_optimizer(TC)
    opt_state = optimizer.init(params)
    rng = np.random.RandomState(0)
    for step in range(4):
        grads = {n: torch.from_numpy(
            (rng.randn(*p.shape) * 10.0 ** rng.randint(-6, 1)).astype(np.float32))
            for n, p in model.named_parameters()}
        jgrads = jax.tree_util.tree_map(jnp.asarray, tree_from_named(grads))
        t_state.adam_update(state, grads, _t_tc(TC))
        updates, opt_state = optimizer.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
    assert state.step == 4 == int(opt_state[0].count) == int(opt_state[1].count)
    assert_tree_rel(params_to_jax(model), params, 0.0, atol=1e-7)
    assert_tree_rel(tree_from_named(state.mu), opt_state[0].mu, 1e-5)
    assert_tree_rel(tree_from_named(state.nu), opt_state[0].nu, 1e-5)


def test_test_rays_move_only_the_latents():
    """A batch of ONLY test rays leaves the networks untouched and moves the
    latent codes (engine/train_step.py:82-86 of the JAX package)."""
    (state, batch, draws), _ = both_sides(NARROW, "float32")
    batch["train_indicator"] = torch.zeros(N_RAYS)
    batch["test_indicator"] = torch.ones(N_RAYS)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    t_step.train_step_from_batch(
        state, batch, draws=draws, cfg=torch_cfg(NARROW), tc=_t_tc(TC),
        rs=_t_rs(RS), has_test_split=True, n_rand=N_RAYS)
    for name, p in state.model.named_parameters():
        if name == "latents":
            assert (p - before[name]).abs().max() > 0
        else:
            assert torch.equal(p, before[name]), name


def test_without_test_split_matches_jax_and_takes_one_backward(monkeypatch):
    (state, batch, draws), (jstate, jbatch, key, jcfg) = both_sides(
        NARROW, "float32", has_test_split=False)
    calls = []
    orig = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    _, _, grads = t_step.losses_and_grads(
        state.model, 0, batch, draws=draws, cfg=torch_cfg(NARROW),
        tc=_t_tc(TC), rs=_t_rs(RS), has_test_split=False, n_rand=N_RAYS)
    assert len(calls) == 1
    _, _, jgrads = jax_losses_and_grads(jstate.params, jbatch, key, 0, jcfg,
                                        TC, RS, False, N_RAYS)
    assert_tree_rel(tree_from_named(grads), jgrads, 1e-2)


def test_step_0_on_a_fresh_model_is_finite():
    """The zero-initialised bender: safe_norm and safe_pow give a finite,
    zero gradient; the latents do not move at step 0 (the zero output layer
    blocks their gradient), the networks do."""
    cfg, tc = torch_cfg(NARROW), _t_tc(TC)
    state = t_state.create_train_state(cfg, tc, T, device="cpu")
    assert float(state.model.bender.bend[-1].weight.detach().abs().max()) == 0.0
    batch = _torch_batch(ray_batch(N_RAYS, T), "float32")
    old = state.model.coarse.pts[0].weight.detach().clone()
    metrics = t_step.train_step_from_batch(
        state, batch, cfg=cfg, tc=tc, rs=_t_rs(RS), has_test_split=True,
        n_rand=N_RAYS, generator=torch.Generator().manual_seed(0),
        debug_metrics=True)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for name, t in list(state.model.named_parameters()) + \
            list(state.mu.items()) + list(state.nu.items()):
        assert torch.isfinite(t).all(), name
    assert float(state.model.latents.abs().max()) == 0.0
    assert not torch.equal(state.model.coarse.pts[0].weight, old)
    assert float(metrics["grad_norm"]) > 0


def test_make_train_step_draws_from_the_generator_and_rejects_int8():
    from nonrigid_nerf_torch.data.dataset import build_ray_dataset
    rng = np.random.RandomState(0)
    n = 4
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    poses[:, 2, 3] = 1.5
    ds = build_ray_dataset(
        rng.randint(0, 256, (n, 6, 8, 3)).astype(np.uint8), poses,
        {0: dict(focal_x=8.0, focal_y=8.0, center_x=4.0, center_y=3.0)},
        {"imageid_to_viewid": [0] * n, "imageid_to_timestepid": [0, 1, 2, 2],
         "raw_timesteps": [0, 1, 2]}, [0, 1, 2], [3], 0.5, 2.5, device="cpu")
    cfg, tc = torch_cfg(NARROW), _t_tc(TC)
    step_fn = t_step.make_train_step(cfg, tc, _t_rs(RS), has_test_split=True)
    finals = []
    for seed in (1, 1, 2):
        state = t_state.create_train_state(cfg, tc, T, device="cpu")
        step_fn(state, ds, torch.Generator().manual_seed(seed))
        finals.append(state.model.coarse.output.weight.detach().clone())
    assert torch.equal(finals[0], finals[1])
    assert not torch.equal(finals[0], finals[2])
    with pytest.raises(ValueError, match="int8"):
        t_step.make_train_step(dataclasses.replace(cfg, fused_kernel="int8"),
                               tc, _t_rs(RS), has_test_split=False)


@pytest.mark.parametrize("name", ["default.txt", "example_sequence.txt"])
def test_train_config_reads_like_jax(name):
    import pathlib

    from nonrigid_nerf_tpu import config as j_config
    path = str(pathlib.Path(__file__).resolve().parent.parent / "configs" / name)
    t_args, j_args = t_config.load_args(path, seed=5), j_config.load_args(path, seed=5)
    assert (dataclasses.asdict(t_config.train_config_from_args(t_args))
            == dataclasses.asdict(j_config.train_config_from_args(j_args)))
    unseeded = t_config.train_config_from_args(t_config.load_args(path))
    assert 0 <= unseeded.seed < 2 ** 31
