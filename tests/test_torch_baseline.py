"""The time-conditioned baseline (`time_conditioned_baseline=True`,
`ray_bending=None`) of the port against the JAX package (CPU): the network
with the latent in its input, the `_mlp_core` kernel pair at the 128-lane
input, the kernel predicates, parameters and checkpoints.

Tolerances:
- `NeRF` with latents, f32: 1e-5 narrow, 3e-5 at 8 x 256 (the same f32
  products summed in another order, as tests/test_torch_models.py); f64:
  1e-6 (the JAX package's dense layers accumulate in f32 even in f64 mode,
  models/mlp.py:75, so its f64 agrees with the port's to about 1e-7).
- `mlp_fwd_plain` / `mlp_bwd_plain` at 128 lanes against `_mlp_fwd_math` /
  `_mlp_bwd_math` with `pack_mlp_weights(in_ch=95)`: the bf16 tolerances
  pinned in `ops/kernels/mlp_fwd.py` and `ops/kernels/mlp_bwd.py`, as at 64
  lanes (the same arithmetic on 32 more input lanes).

Rendering and the point query are in tests/test_torch_baseline_render.py,
the training step in tests/test_torch_baseline_train.py.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch import checkpoints as t_ckpt
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.engine.render import make_ray_renderer as t_renderer
from nonrigid_nerf_torch.models.nerf import check_nerf_supported
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.weights import (params_from_jax, params_to_jax,
                                         tree_from_named)
from nonrigid_nerf_tpu import checkpoints as j_ckpt
from nonrigid_nerf_tpu import config as j_config
from nonrigid_nerf_tpu.config import EditConfig, ModelConfig, TrainConfig
from nonrigid_nerf_tpu.engine import query as j_query
from nonrigid_nerf_tpu.engine import train_state as j_state
from nonrigid_nerf_tpu.engine.render import make_ray_renderer as j_renderer
from nonrigid_nerf_tpu.models.nerf import nerf_mlp_apply
from tests.test_torch_render import RS, _rays, _t_edit, _t_rs
from tests.test_torch_train_step import assert_tree_rel
from tests.torch_parity import jax_params, torch_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
TC_ARGS = ROOT / "results" / "r4_baseline_tc" / "args.txt"

NARROW_TC = ModelConfig(netwidth=32, netwidth_fine=32, ray_bending=None,
                        time_conditioned_baseline=True,
                        ray_bending_latent_size=8, N_samples=8,
                        N_importance=8, fused_kernel="off")
FLAGSHIP_TC = ModelConfig(ray_bending=None, time_conditioned_baseline=True,
                          N_samples=8, N_importance=8, fused_kernel="on")
IN_CH = 63 + 32         # the flagship baseline's MLP input


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def flagship():
    tree = jax_params(FLAGSHIP_TC)
    return tree, params_from_jax(tree, torch_cfg(FLAGSHIP_TC), device="cpu")


# ---- (a) the network

NERF_CASES = {
    "narrow": NARROW_TC,
    "narrow-viewdirs": dataclasses.replace(NARROW_TC, use_viewdirs=True),
    "flagship": FLAGSHIP_TC,
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("network", ["coarse", "fine"])
@pytest.mark.parametrize("case", sorted(NERF_CASES))
def test_nerf_with_latents_matches_jax(case, network, dtype):
    cfg = NERF_CASES[case]
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    net = model.network(network)
    L = cfg.ray_bending_latent_size
    assert net.pts[0].in_features == 63 + L
    assert net.pts[5].in_features == cfg.netwidth + 63 + L
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (3, 5, 63)).astype(dtype)
    lat = (0.3 * rng.randn(3, 5, L)).astype(dtype)
    views = rng.uniform(-1, 1, (3, 5, cfg.input_ch_views)).astype(dtype) \
        if cfg.use_viewdirs else None
    if dtype == "float64":
        net = net.double()
        with jax.enable_x64():
            ref = np.asarray(nerf_mlp_apply(
                jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       tree[network]),
                dataclasses.replace(cfg, compute_dtype="float64"),
                jnp.asarray(x), None if views is None else jnp.asarray(views),
                jnp.asarray(lat)))
        tol = 1e-6
    else:
        ref = np.asarray(nerf_mlp_apply(
            tree[network], cfg, jnp.asarray(x),
            None if views is None else jnp.asarray(views), jnp.asarray(lat)))
        tol = 3e-5 if case == "flagship" else 1e-5
    t = (lambda a: None if a is None else torch.from_numpy(a))
    out = net(t(x), t(views), t(lat))
    assert out.shape == (3, 5, 4) and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=tol, atol=tol)
    # the latent reaches the output
    other = net(t(x), t(views), t(lat) + 0.5)
    assert float((other - out).detach().abs().max()) > 1e-4


def test_nerf_without_latents_raises():
    model = params_from_jax(jax_params(NARROW_TC), torch_cfg(NARROW_TC),
                            device="cpu")
    with pytest.raises(ValueError, match="needs latents"):
        model.coarse(torch.zeros(2, 63))


# ---- (b) the kernel pair at the 128-lane input

def _emb_tc(n, seed=0):
    """63 encoding lanes, 32 latent lanes, 33 zero pad lanes."""
    rng = np.random.RandomState(seed)
    emb = np.zeros((n, 128), np.float32)
    emb[:, :63] = rng.uniform(-1, 1, (n, 63))
    emb[:, 63:IN_CH] = 0.3 * rng.randn(n, 32)
    return emb


def _packed(net):
    with torch.no_grad():
        return K.pack_mlp_weights(net)


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_pack_at_128_lanes_equals_jax(flagship, network):
    tree, model = flagship
    jp = fq.pack_mlp_weights(tree, network, in_ch=IN_CH)
    tp = _packed(model.network(network))
    assert tp[0].shape == tp[10].shape == (128, 256)
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert b.shape == K._expected_shape(i, 128)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(tp[0][IN_CH:].numpy(), 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_at_128_lanes_matches_jax_math(flagship, seed):
    tree, model = flagship
    jc = fq._cast_matmul_weights(fq.pack_mlp_weights(tree, in_ch=IN_CH))
    tc = K.cast_mlp_weights(_packed(model.coarse))
    emb = _emb_tc(700, seed)
    ref = np.asarray(fq._mlp_fwd_math(jnp.asarray(emb), jc))
    out = K.mlp_fwd_plain(torch.from_numpy(emb), tc)
    assert out.shape == (700, 8)
    err = np.abs(out.numpy() - ref)
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN
    # the latent lanes matter
    shifted = emb.copy()
    shifted[:, 63:IN_CH] += 0.5
    assert float((K.mlp_fwd_plain(torch.from_numpy(shifted), tc)
                  - out).abs().max()) > 1e-3


def test_plain_at_128_lanes_matches_pallas_interpret(flagship, interpret_pallas):
    tree, model = flagship
    emb = _emb_tc(300, 2)
    block = fq.MLP_FWD_BLOCK
    padded = np.pad(emb, ((0, block - 300), (0, 0)))
    ref = np.asarray(fq._mlp_core(jnp.asarray(padded),
                                  fq.pack_mlp_weights(tree, in_ch=IN_CH),
                                  block))[:300]
    out = K.mlp_fwd(torch.from_numpy(emb),
                    K.cast_mlp_weights(_packed(model.coarse)))
    err = np.abs(out.numpy() - ref)
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN


@pytest.mark.parametrize("n", [1, 127, 300])
def test_bwd_plain_at_128_lanes_matches_jax_math(flagship, n):
    tree, model = flagship
    jc = fq._cast_matmul_weights(fq.pack_mlp_weights(tree, "fine",
                                                     in_ch=IN_CH))
    tc = K.cast_mlp_weights(_packed(model.fine))
    emb = _emb_tc(n, n)
    draw = np.random.RandomState(n + 1).randn(n, 8).astype(np.float32)
    demb_j, grads_j = fq._mlp_bwd_math(
        jnp.asarray(emb).astype(jnp.bfloat16), jc, jnp.asarray(draw))
    with torch.no_grad():
        got = KB.mlp_bwd_plain(torch.from_numpy(emb).to(torch.bfloat16), tc,
                               torch.from_numpy(draw))
    assert got[0].shape == (n, 128)
    for i, g in enumerate(got[1]):
        assert g.shape == K._expected_shape(i, 128)
    ref = (torch.from_numpy(np.array(demb_j, np.float32)),
           [torch.from_numpy(np.array(g, np.float32)) for g in grads_j])
    stats = KB.bwd_agreement(got, ref)
    assert stats["ok"], stats
    # the latents' lanes get a gradient; the pad lanes' rows of n0w and n5e
    # a gradient of the zero input
    assert float(got[0][:, 63:IN_CH].abs().max()) > 0
    assert float(got[1][0][IN_CH:].abs().max()) == 0.0


def test_mlp_core_at_128_lanes_matches_jax_vjp_interpret(flagship,
                                                         interpret_pallas):
    """The latents' gradient comes back through `MLPCore` and the padding,
    as through `jax.vjp` of `_mlp_core`."""
    tree, model = flagship
    net = model.coarse
    n, block = 300, fq.MLP_FWD_BLOCK
    emb = _emb_tc(n, 7)
    padded = np.pad(emb, ((0, block - n), (0, 0)))

    def jf(e, params):
        return fq._mlp_core(e, fq.pack_mlp_weights(params, "coarse",
                                                   in_ch=IN_CH), block)

    out_j, vjp = jax.vjp(jf, jnp.asarray(padded), tree)
    x = torch.from_numpy(emb[:, :IN_CH]).requires_grad_(True)
    out_t = KB.MLPCore.apply(torch.nn.functional.pad(x, (0, 128 - IN_CH)),
                             *K.pack_mlp_weights(net))
    err = np.abs(out_t.detach().numpy() - np.asarray(out_j)[:n])
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN
    draw = np.random.RandomState(11).randn(n, 8).astype(np.float32)
    demb_j, gtree = vjp(jnp.asarray(np.pad(draw, ((0, block - n), (0, 0)))))
    grads = torch.autograd.grad(out_t, [x] + list(net.parameters()),
                                torch.from_numpy(draw))
    demb_j = np.asarray(demb_j)[:n, :IN_CH]
    assert (np.linalg.norm(grads[0].numpy() - demb_j)
            <= KB.BWD_TOL_L2 * np.linalg.norm(demb_j))
    lat_j = demb_j[:, 63:]
    assert np.abs(lat_j).max() > 0
    assert (np.linalg.norm(grads[0].numpy()[:, 63:] - lat_j)
            <= KB.BWD_TOL_L2 * np.linalg.norm(lat_j))
    names = [k for k, _ in net.named_parameters()]
    got = tree_from_named({f"coarse.{k}": g
                           for k, g in zip(names, grads[1:])})["coarse"]
    assert_tree_rel(got, gtree["coarse"], KB.grad_max_tol(n), KB.BWD_TOL_L2)


def test_other_widths_raise(flagship):
    _, model = flagship
    mw = K.cast_mlp_weights(_packed(model.coarse))
    for width in (63, 96, 192):
        emb = torch.zeros(4, width)
        with pytest.raises(ValueError, match="lanes"):
            K.mlp_fwd_plain(emb, mw)
        with pytest.raises(ValueError, match="emb must be"):
            K.mlp_fwd(emb, mw)
        with pytest.raises(ValueError, match="lanes"):
            KB.mlp_bwd_plain(emb.to(torch.bfloat16), mw, torch.zeros(4, 8))
    # 64-lane weights with a 128-lane encoding, and the other way round
    with pytest.raises(ValueError, match="rows"):
        K.mlp_fwd(torch.zeros(4, 64), mw)
    # an input that pads to 192 lanes: 63 + 66 latent channels
    wide = dataclasses.replace(NARROW_TC, ray_bending_latent_size=66)
    net = params_from_jax(jax_params(wide), torch_cfg(wide), device="cpu").coarse
    with pytest.raises(ValueError, match="lanes"):
        K.pack_mlp_weights(net)


def test_work_per_point_at_128_lanes():
    # the figures PERF.md's bounds at 128 lanes are computed from
    assert K.macs_per_point(128) == 526_336
    assert KB.bwd_macs_per_point(128) == 1_579_008
    assert sum(s.numel() for s in KB.grad_shapes(128)) == 528_392
    assert K.MACS_PER_POINT == K.macs_per_point(64) == 493_568


# ---- (c) the kernel predicates, against the JAX package's

def _outcome(fn):
    try:
        return bool(fn())
    except ValueError:
        return "raises"


@pytest.mark.parametrize("viewdirs", [False, True])
@pytest.mark.parametrize("latent", [1, 32, 65, 66])
def test_predicates_match_jax(monkeypatch, latent, viewdirs):
    """`supports_fused_query` and `use_fused_kernel` for every mode. The JAX
    predicate keys "auto" and "int8" on a TPU backend; the port's keys
    "auto" on a CUDA device and takes "int8" on either."""
    base = ModelConfig(ray_bending=None, time_conditioned_baseline=True,
                       ray_bending_latent_size=latent, use_viewdirs=viewdirs)
    assert (t_query.supports_fused_query(torch_cfg(base))
            == fq.supports_fused_query(base)
            == (not viewdirs and latent <= 65))
    monkeypatch.setattr(j_query.jax, "default_backend", lambda: "tpu")
    for mode in ("on", "off", "pts", "int8", "auto"):
        cfg = dataclasses.replace(base, fused_kernel=mode)
        got = _outcome(lambda: t_query.use_fused_kernel(
            torch_cfg(cfg), t_config.EditConfig(), torch.device("cuda")))
        want = _outcome(lambda: j_query.use_fused_kernel(cfg, EditConfig()))
        assert got == want, (mode, got, want)
    # the baseline never takes the int8 kernel or the in-kernel encoding
    assert not t_query.use_fused_kernel(
        torch_cfg(dataclasses.replace(base, fused_kernel="int8")),
        t_config.EditConfig(), torch.device("cpu"))
    with pytest.raises(ValueError, match="outside the kernel's support"):
        t_query.use_fused_kernel(
            torch_cfg(dataclasses.replace(base, fused_kernel="pts")),
            t_config.EditConfig(), torch.device("cuda"))


def test_baseline_is_ported():
    cfg = t_config.ModelConfig(ray_bending=None, time_conditioned_baseline=True)
    check_nerf_supported(cfg)
    t_renderer(cfg, t_config.RenderSettings(), device="cpu")
    # compute_dtype="bfloat16" constructs and renders (f32 maps out); only a
    # dtype name the port does not know raises
    bf16 = torch_cfg(dataclasses.replace(NARROW_TC, compute_dtype="bfloat16"))
    check_nerf_supported(bf16)
    model = params_from_jax(jax_params(NARROW_TC), bf16, device="cpu")
    o, d, lat = (torch.from_numpy(a) for a in _rays(16, 8))
    out = t_renderer(bf16, _t_rs(RS), device="cpu")(model, o, d, lat)
    assert out["rgb_map"].dtype == torch.float32
    assert bool(torch.isfinite(out["rgb_map"]).all())
    with pytest.raises(ValueError, match="compute_dtype"):
        check_nerf_supported(dataclasses.replace(cfg, compute_dtype="float16"))


# ---- (f) parameters, checkpoints, the run's args.txt

def test_args_txt_parses_alike():
    t_args, j_args = t_config.load_args(str(TC_ARGS)), j_config.load_args(str(TC_ARGS))
    t_cfg = t_config.model_config_from_args(t_args)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(
        j_config.model_config_from_args(j_args))
    assert t_cfg.ray_bending is None and t_cfg.time_conditioned_baseline
    assert (t_cfg.netwidth, t_cfg.ray_bending_latent_size) == (256, 32)
    assert (dataclasses.asdict(t_config.train_config_from_args(t_args))
            == dataclasses.asdict(j_config.train_config_from_args(j_args)))
    tc = t_config.train_config_from_args(t_args)
    assert (tc.offsets_loss_weight, tc.divergence_loss_weight,
            tc.rigidity_loss_weight) == (0.0, 0.0, 0.0)


def test_params_round_trip_of_a_baseline_tree():
    tree = jax_params(FLAGSHIP_TC, num_timesteps=5)
    assert "bender" not in tree
    assert tree["coarse"]["pts"][0]["w"].shape == (IN_CH, 256)
    assert tree["coarse"]["pts"][5]["w"].shape == (256 + IN_CH, 256)
    assert tree["latents"].shape == (5, 32)
    model = params_from_jax(tree, torch_cfg(FLAGSHIP_TC), device="cpu")
    assert model.bender is None
    back = params_to_jax(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # a flagship (bending) tree does not fit the baseline, nor the other way
    with pytest.raises(ValueError):
        params_from_jax(jax_params(ModelConfig()), torch_cfg(FLAGSHIP_TC),
                        device="cpu")
    with pytest.raises(ValueError):
        params_from_jax(tree, torch_cfg(ModelConfig()), device="cpu")


def test_checkpoint_with_args_txt_both_ways(tmp_path):
    """A JAX run directory of the baseline (its args.txt and an npz
    checkpoint with Adam's state) loads in the port with the configuration
    read from args.txt, renders what JAX renders, and the port's checkpoint
    loads back in the JAX package bit for bit."""
    args = j_config.load_args(str(TC_ARGS), netwidth=32, netwidth_fine=32,
                              ray_bending_latent_size=8, N_samples=8,
                              N_importance=8, fused_kernel="off")
    args.dump(str(tmp_path / "args.txt"))
    jcfg = j_config.model_config_from_args(args)
    tree = jax_params(jcfg, num_timesteps=4)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    optimizer = j_state.make_optimizer(TrainConfig())
    opt_state = optimizer.init(params)
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), params)
    _, opt_state = optimizer.update(grads, opt_state, params)
    path = str(tmp_path / "000001.npz")
    j_ckpt.save_checkpoint(path, 1, params, opt_state, extras={"near": 0.5})

    cfg = t_config.model_config_from_args(
        t_config.load_args(str(tmp_path / "args.txt")))
    assert cfg.time_conditioned_baseline and cfg.ray_bending is None
    state, extras = t_ckpt.load_train_state(path, cfg, device="cpu")
    assert state.step == 1 and extras == {"near": 0.5}
    assert_tree_rel(params_to_jax(state.model), params, 0.0)
    assert_tree_rel(tree_from_named(state.mu), opt_state[0].mu, 0.0)
    assert float(state.mu["latents"].abs().max()) > 0

    o, d, _ = _rays(9, 8)
    lat = state.model.latents.detach()[torch.arange(9) % 4]
    rs = RS.test_mode()
    out = t_renderer(cfg, _t_rs(rs), chunk=8, device="cpu")(
        state.model, torch.from_numpy(o), torch.from_numpy(d), lat)
    ref = j_renderer(jcfg, rs, chunk=8)(params, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(lat.numpy()), None)
    np.testing.assert_allclose(out["rgb_map"].numpy(), np.asarray(ref["rgb_map"]),
                               rtol=1e-5, atol=1e-5)

    back = str(tmp_path / "latest.npz")
    t_ckpt.save_checkpoint(back, state.step, state.model,
                           (state.mu, state.nu), extras)
    step, jparams, opt_tree, _ = j_ckpt.load_checkpoint(back)
    jopt = j_ckpt.restore_opt_state(opt_state, opt_tree)
    assert int(step) == 1
    assert_tree_rel(jax.tree_util.tree_map(np.asarray, jparams), params, 0.0)
    assert_tree_rel(jax.tree_util.tree_map(np.asarray, jopt[0].nu),
                    opt_state[0].nu, 0.0)
    again, _ = t_ckpt.load_train_state(back, cfg, device="cpu")
    for (name, a), b in zip(state.model.named_parameters(),
                            again.model.parameters()):
        assert torch.equal(a, b), name
