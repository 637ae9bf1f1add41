"""compute_dtype="bfloat16" of the port against the JAX package's (CPU).

bf16 outputs are held by their mean error and by the share of elements
beyond one bf16 ulp of the JAX value, not by the max: the two sides sum
their f32 products in another order, XLA fuses bf16 elementwise chains
(tanh, + 1, * 0.5) that PyTorch rounds op by op, and a rounding that flips
one way in one layer moves the next layer's inputs by an ulp. Limits
(observed values in brackets):
- `dense_apply`, the bender (unmasked and masked offsets, mask, bent
  points) and the canonical MLP (F, V, B; raw): at most ULP_SHARE (1e-3) of
  the entries beyond one ulp, the mean error at most MEAN_TOL (1e-4) of the
  mean magnitude [bitwise equal: 0 and 0].
- a render at bf16 (F; V with finite-difference and exact directions; B;
  F with the kernels on, the port's plain versions against Pallas interpret
  mode): rgb, disp, acc within RENDER_TOL (1e-3) absolute and 1e-4 in the
  mean [4.2e-5 and 6.0e-6 at worst, V with exact directions].
- a training step at bf16 (F; V both modes): per-ray losses within
  LOSS_TOL (1e-3) relative [3.4e-5], and each gradient leaf's cosine with
  JAX's at least COS_TOL (0.999) [0.99966, F's fine first layer]. The JAX
  step runs under jax.jit (four times faster than eagerly; it moves
  cancelling leaves, which the cosine does not weigh).
- the bf16-to-f32 gap: the port's bf16 render moves from its f32 render by
  as much as JAX's does from JAX's, within a factor GAP_FACTOR (1.5) either
  way, in RMS of rgb [ratios 0.996-1.000].
- the data-parallel step (world size 1, gloo) and the training and
  free-viewpoint CLIs run at bf16.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.engine.render import make_ray_renderer as t_renderer
from nonrigid_nerf_torch.models.mlp import dense_apply
from nonrigid_nerf_torch.weights import params_from_jax, tree_from_named
from nonrigid_nerf_tpu.config import EditConfig, ModelConfig
from nonrigid_nerf_tpu.engine.render import make_ray_renderer as j_renderer
from nonrigid_nerf_tpu.models.bending import bend_points
from nonrigid_nerf_tpu.models.mlp import dense_apply as j_dense_apply
from nonrigid_nerf_tpu.models.nerf import nerf_mlp_apply
from tests.test_torch_render import NARROW, RS, _rays, _t_edit, _t_rs
from tests.test_torch_train_step import (TC, _t_tc, _torch_batch,
                                         _torch_draws, jax_losses_and_grads)
from tests.torch_parity import (jax_params, jax_step_draws, ray_batch,
                                torch_cfg)

ULP_SHARE = 1e-3
MEAN_TOL = 1e-4
RENDER_TOL = 1e-3
LOSS_TOL = 1e-3
COS_TOL = 0.999
GAP_FACTOR = 1.5
BF16 = dict(compute_dtype="bfloat16")
FAMILIES = {
    "F": dataclasses.replace(NARROW, **BF16),
    "V-fd": dataclasses.replace(NARROW, use_viewdirs=True,
                                approx_nonrigid_viewdirs=True, **BF16),
    "V-exact": dataclasses.replace(NARROW, use_viewdirs=True,
                                   approx_nonrigid_viewdirs=False, **BF16),
    "B": dataclasses.replace(NARROW, ray_bending=None,
                             time_conditioned_baseline=True, **BF16),
}


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(fq.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def bf16_agreement(got, want):
    """(share of entries beyond one bf16 ulp of `want`, mean abs error over
    the mean magnitude)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    share = float(np.mean(np.abs(got - want) > ulp))
    mean = float(np.abs(got - want).mean() / max(np.abs(want).mean(), 1e-30))
    return share, mean


def assert_bf16_close(got, want, what):
    share, mean = bf16_agreement(got, want)
    assert share <= ULP_SHARE and mean <= MEAN_TOL, (what, share, mean)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def test_dense_apply_matches_jax():
    rng = np.random.RandomState(0)
    layer = torch.nn.Linear(40, 24)
    x = rng.randn(500, 40).astype(np.float32)
    jlayer = {"w": layer.weight.detach().numpy().T,
              "b": layer.bias.detach().numpy()}
    got = dense_apply(layer, torch.from_numpy(x), torch.bfloat16)
    want = j_dense_apply(jlayer, jnp.asarray(x), jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_bf16_close(_np(got), _np(want), "dense_apply")
    # f32 is the layer itself
    assert torch.equal(dense_apply(layer, torch.from_numpy(x)),
                       layer(torch.from_numpy(x)))


def test_bender_matches_jax():
    cfg = FAMILIES["F"]
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    lat = (0.3 * rng.randn(300, 8)).astype(np.float32)
    bent, det = model.bender(torch.from_numpy(pts), torch.from_numpy(lat),
                             compute_dtype=torch.bfloat16)
    jbent, jdet = bend_points(tree["bender"], jnp.asarray(pts),
                              jnp.asarray(lat), compute_dtype=jnp.bfloat16)
    assert bent.dtype == torch.float32 and jbent.dtype == jnp.float32
    assert set(det) == set(jdet)
    for k in det:
        assert det[k].dtype == torch.float32
        assert_bf16_close(_np(det[k]), _np(jdet[k]), k)
    # the bent points are f32 sums of the f32 points and offsets
    assert_bf16_close(_np(bent) - pts, _np(jbent) - pts, "bent - pts")
    f32, _ = model.bender(torch.from_numpy(pts), torch.from_numpy(lat))
    assert not torch.equal(f32, bent)


@pytest.mark.parametrize("family", ["F", "V-fd", "B"])
def test_canonical_mlp_matches_jax(family):
    cfg = FAMILIES[family]
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    rng = np.random.RandomState(2)
    emb = rng.uniform(-1, 1, (400, cfg.input_ch)).astype(np.float32)
    ev = rng.uniform(-1, 1, (400, 27)).astype(np.float32) \
        if cfg.use_viewdirs else None
    lat = (0.3 * rng.randn(400, 8)).astype(np.float32)
    for network in ("coarse", "fine"):
        raw = model.network(network)(
            torch.from_numpy(emb), None if ev is None else torch.from_numpy(ev),
            torch.from_numpy(lat), torch.bfloat16)
        jraw = nerf_mlp_apply(tree[network], cfg, jnp.asarray(emb),
                              None if ev is None else jnp.asarray(ev),
                              jnp.asarray(lat))
        assert raw.dtype == torch.float32 and jraw.dtype == jnp.float32
        assert_bf16_close(_np(raw), _np(jraw), (family, network))


def _render(cfg, tree, side, n=24, chunk=12):
    o, d, lat = _rays(n, cfg.ray_bending_latent_size)
    if side == "jax":
        out = j_renderer(cfg, RS.test_mode(), EditConfig(), chunk=chunk)(
            tree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lat), None)
        return {k: np.asarray(v) for k, v in out.items()}
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    out = t_renderer(torch_cfg(cfg), _t_rs(RS).test_mode(),
                     _t_edit(EditConfig()), chunk=chunk, device="cpu")(
        model, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lat))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("family", list(FAMILIES) + ["F-kernel"])
def test_render_matches_jax_and_the_gap_to_f32_is_jaxs(family,
                                                       interpret_pallas):
    if family == "F-kernel":
        cfg = ModelConfig(N_samples=8, N_importance=8, fused_kernel="on",
                          **BF16)
    else:
        cfg = FAMILIES[family]
    tree = jax_params(cfg)
    out, ref = _render(cfg, tree, "torch"), _render(cfg, tree, "jax")
    for k in ("rgb_map", "disp_map", "acc_map"):
        err = np.abs(out[k] - ref[k])
        assert err.max() <= RENDER_TOL and err.mean() <= 0.1 * RENDER_TOL, \
            (k, err.max(), err.mean())
    if family == "F-kernel":
        return
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    gap = np.sqrt(np.mean((out["rgb_map"]
                           - _render(f32, tree, "torch")["rgb_map"]) ** 2))
    jgap = np.sqrt(np.mean((ref["rgb_map"]
                            - _render(f32, tree, "jax")["rgb_map"]) ** 2))
    assert 0 < gap and 0 < jgap
    assert jgap / GAP_FACTOR <= gap <= GAP_FACTOR * jgap, (gap, jgap)


@pytest.mark.parametrize("family", ["F", "V-fd", "V-exact"])
def test_training_step_matches_jax(family):
    cfg = FAMILIES[family]
    n_rays, steps = 16, 3
    tree = jax_params(cfg, num_timesteps=steps)
    batch = ray_batch(n_rays, steps)
    key = jax.random.PRNGKey(7)
    draws = jax_step_draws(key, 0, n_rays, RS.N_samples, RS.N_importance)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    rs = dataclasses.replace(RS, perturb=1.0, raw_noise_std=1.0)
    losses, _, grads = t_step.losses_and_grads(
        model, 0, _torch_batch(batch, "float32"), cfg=torch_cfg(cfg),
        tc=_t_tc(TC), rs=_t_rs(rs), has_test_split=True, n_rand=n_rays,
        draws=_torch_draws(draws))
    jlosses, _, jgrads = jax.jit(lambda p, b: jax_losses_and_grads(
        p, b, key, 0, cfg, TC, rs, True, n_rays))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_TOL)
    got = jax.tree_util.tree_leaves_with_path(tree_from_named(grads))
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
        cos = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)
        assert cos >= COS_TOL, (jax.tree_util.keystr(path), cos)


def test_bf16_data_parallel_step_equals_the_single_process_step(tmp_path):
    """The data-parallel step at bf16, at world size 1 on gloo, against the
    single-process bf16 step on the same generator: the same losses
    (rtol 2e-5, tests/test_torch_parallel.py's) and parameters within
    5% of lrate (an entry whose gradient is within rounding of 0 may
    step otherwise)."""
    from nonrigid_nerf_torch import config as t_config
    from nonrigid_nerf_torch.engine.train_state import create_train_state
    from nonrigid_nerf_torch.parallel import make_parallel_train_step, multihost
    from tests.test_torch_train_app import make_dataset
    cfg = dataclasses.replace(torch_cfg(FAMILIES["F"]), N_samples=4,
                              N_importance=4)
    tc = t_config.TrainConfig(N_rand=16, lrate=5e-3, offsets_loss_weight=60.0,
                              divergence_loss_weight=3.0,
                              rigidity_loss_weight=5e-4, seed=3)
    rs = t_config.RenderSettings(N_samples=4, N_importance=4, near=2.0,
                                 far=6.0, perturb=1.0, raw_noise_std=1.0)
    ds = make_dataset()
    states = [create_train_state(cfg, tc, ds.num_timesteps, device="cpu")
              for _ in range(2)]
    single = t_step.make_train_step(cfg, tc, rs, ds.has_test_split)
    m_single = single(states[0], ds, t_step.step_generator(tc.seed, 0, "cpu"))
    multihost.initialize(0, 1, f"file://{tmp_path}/pg", device="cpu",
                         backend="gloo")
    try:
        step = make_parallel_train_step(cfg, tc, rs, ds.has_test_split)
        m_par = step(states[1], ds, t_step.step_generator(tc.seed, 0, "cpu"))
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(float(m_par["loss"]), float(m_single["loss"]),
                               rtol=2e-5)
    for a, b in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert (a - b).abs().max().item() <= 0.05 * tc.lrate


def test_bf16_through_the_training_and_free_viewpoint_clis(tmp_path):
    """`--compute_dtype bfloat16` trains through the training CLI, and the
    free-viewpoint CLI renders the experiment at bf16 (its args.txt)."""
    from nonrigid_nerf_torch import config as t_config
    from nonrigid_nerf_torch.cli import free_viewpoint_rendering as t_fvr
    from nonrigid_nerf_torch.cli import train as t_cli
    from tests.test_torch_cli import CPU, SMALL, small_scene
    t_cli.main(small_scene(tmp_path) + SMALL + [
        "--expname", "bf16", "--N_iters", "3", "--i_print", "3",
        "--i_weights", "3", "--i_video", "100", "--i_testset", "100",
        "--i_img", "0", "--compute_dtype", "bfloat16"] + CPU)
    exp = tmp_path / "exp" / "bf16"
    args = t_config.parse_config_file(str(exp / "logs" / "args.txt"))
    assert args["compute_dtype"] == "bfloat16"
    out = t_fvr.free_viewpoint_rendering(t_fvr.build_parser().parse_args(
        ["--input", str(exp), "--deformations", "train", "--camera_path",
         "fixed", "--device", "cpu"]))
    assert any(name.startswith("rgb_") for name in os.listdir(out))
