"""`fused_kernel="int8"`: the port's int8 module, its calibration state and
its renderer against the JAX package's `ops/pallas/quant_mlp.py` (CPU).

The JAX kernel `mlp_i8_core` runs in Pallas interpret mode, as in
tests/test_quant.py. On the CPU the port runs the kernel's plain version
`mlp_i8_plain`; the CUDA kernel itself is held against it on the card by
`tests/test_torch_kernels_cuda.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.quant_mlp as jq
from nonrigid_nerf_torch import checkpoints as t_ckpt
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.engine.render import make_ray_renderer as t_renderer
from nonrigid_nerf_torch.models.model import QuantState
from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ
from nonrigid_nerf_torch.weights import params_from_jax, params_to_jax
from nonrigid_nerf_tpu import checkpoints as j_ckpt
from nonrigid_nerf_tpu.config import ModelConfig, RenderSettings
from nonrigid_nerf_tpu.engine.render import make_ray_renderer as j_renderer
from tests.torch_parity import jax_params, torch_cfg


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jq.pl, "pallas_call", patched)


CFG = ModelConfig()
CFG_I8 = dataclasses.replace(CFG, fused_kernel="int8")


@pytest.fixture(scope="module")
def weights():
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    return tree, model


def _emb(n, seed=0, ch=63):
    rng = np.random.RandomState(seed)
    return np.clip(rng.randn(n, ch), -1.5, 1.5).astype(np.float32)


def _bits(a):
    """An array's items as integers, whatever type holds its bf16 values."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind == "V" \
        else a


@pytest.mark.parametrize("network", ["coarse", "fine"])
@pytest.mark.parametrize("ch", [63, 64])
def test_calibrate_act_scales_equals_jax(weights, network, ch):
    tree, model = weights
    emb = _emb(700, 1, ch)
    if ch == 64:
        emb[:, 63] = 0.0
    want = np.asarray(jq.calibrate_act_scales(tree, jnp.asarray(emb), network))
    got = KQ.calibrate_act_scales(model.network(network),
                                  torch.from_numpy(emb))
    assert got.shape == (9,) and got.dtype == torch.float32
    assert bool((got > 0).all())
    # maxima of bf16 values: equal unless a sum's order flips the rounding
    # of the one largest entry
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_pack_int8_mlp_weights_equals_jax(weights, network):
    """From the same scales: the int8 matrices and the bf16 head are equal,
    the dequantization rows, folded biases and multipliers agree to the last
    bits (the two libraries round a / b * c chains alike or one ulp apart)."""
    tree, model = weights
    scales = np.asarray(jq.calibrate_act_scales(
        tree, jnp.asarray(_emb(512, 2)), network))
    want = jq.pack_int8_mlp_weights(tree, jnp.asarray(scales), network)
    got = KQ.pack_int8_mlp_weights(model.network(network),
                                   torch.from_numpy(scales))
    assert len(got) == len(want) == KQ.N_QW + 1 == 29
    for i, (a, b) in enumerate(zip(got, want)):
        shape, dtype = KQ._expected_i8(i)
        assert a.shape == shape and a.dtype == dtype and a.is_contiguous(), i
        assert str(b.dtype) == str(dtype).replace("torch.", ""), i
        if dtype == torch.float32:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12, err_msg=f"weight {i}")
        else:
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                err_msg=f"weight {i}")
    assert not any(t.requires_grad for t in got)


def _carried_over(qw):
    """A JAX packed tuple as the port's tensors, every type kept."""
    out = []
    for w in qw:
        a = np.asarray(w)
        if a.dtype.kind == "V":        # bfloat16
            out.append(torch.from_numpy(
                np.asarray(w.astype(jnp.float32))).to(torch.bfloat16))
        else:
            out.append(torch.from_numpy(np.array(a)))
    return tuple(out)


@pytest.mark.parametrize("n", [1, 300, 1024])
def test_plain_matches_pallas_interpret(weights, interpret_pallas, n):
    """`mlp_i8_plain` against `mlp_i8_core` on the SAME packed tuple. The
    integer sums are exact in both; an activation whose h * m lands within an
    f32 rounding of a half-integer may quantize one step apart (XLA's CPU
    backend may contract a * d + b into one fused multiply-add, PyTorch does
    not), which reaches raw at about one int8 step of one unit: 2e-3 of the
    largest |raw| at most, and far less on average."""
    tree, _ = weights
    emb = np.pad(_emb(n, 3), ((0, 0), (0, 1)))
    scales = jq.calibrate_act_scales(tree, jnp.asarray(_emb(2048, 4)))
    qw = jq.pack_int8_mlp_weights(tree, scales)
    block = 256
    n_pad = -(-n // block) * block
    embb = jnp.asarray(np.pad(emb, ((0, n_pad - n), (0, 0)))).astype(
        jnp.bfloat16)
    want = np.asarray(jq.mlp_i8_core(embb, qw, block))[:n]
    emb_t = torch.from_numpy(emb).to(torch.bfloat16)
    before = KQ.mlp_i8.launches
    got = KQ.mlp_i8(emb_t, _carried_over(qw))
    assert KQ.mlp_i8.launches == before            # a CPU tensor: no launch
    assert got.shape == (n, 8) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    scale = np.abs(want).max()
    assert err.max() <= 2e-3 * scale, err.max() / scale
    assert err.mean() <= 2e-5 * scale, err.mean() / scale


def test_int8_forward_close_to_f32(weights):
    """tests/test_quant.py:45-58: mean error under 2% of mean |raw|."""
    _, model = weights
    emb = torch.from_numpy(_emb(1024, 0))
    scales = KQ.calibrate_act_scales(model.coarse, emb)
    qw = KQ.pack_int8_mlp_weights(model.coarse, scales)
    raw_q = KQ.mlp_i8_plain(torch.nn.functional.pad(emb, (0, 1)), qw)
    with torch.no_grad():
        raw_f = model.coarse(emb)
    err = (raw_q[:, :4] - raw_f).abs().mean() / raw_f.abs().mean()
    assert err < 0.02, err


def test_add_quant_scales_covers_both_networks_and_shares_parameters(weights):
    tree, model = weights
    emb = _emb(256, 1)
    mq = KQ.add_quant_scales(model, torch.from_numpy(emb))
    assert set(mq.quant) == {"coarse", "fine"}
    assert mq is not model and model.quant is None
    assert mq.coarse is model.coarse and mq.latents is model.latents
    # non-trainable state that no optimizer sees and that .to() moves
    assert ([n for n, _ in mq.named_parameters()]
            == [n for n, _ in model.named_parameters()])
    buffers = dict(mq.named_buffers())
    assert len(buffers) == 2 * (1 + 29) and "quant.fine.p28" in buffers
    assert buffers["quant.coarse.p0"].dtype == torch.int8
    assert buffers["quant.coarse.p26"].dtype == torch.bfloat16
    assert mq.to("cpu").quant["coarse"].p0.dtype == torch.int8
    jq_tree = jq.add_quant_scales(tree, jnp.asarray(emb))
    for network in ("coarse", "fine"):
        leaf = mq.quant[network]
        assert len(leaf.packed) == KQ.N_QW + 1
        np.testing.assert_allclose(
            leaf.scales.numpy(), np.asarray(jq_tree["quant"][network]["scales"]),
            rtol=1e-6)
        packed = KQ.packed_int8_weights(leaf, model.network(network))
        # a state that holds the scales alone packs at first use, the same
        legacy = KQ.packed_int8_weights(QuantState(leaf.scales),
                                        model.network(network))
        for a, b in zip(packed, legacy):
            assert torch.equal(a, b)


def _scene(n_rays, seed):
    rng = np.random.RandomState(seed)
    rays_o = (rng.randn(n_rays, 3) * 0.1).astype(np.float32)
    rays_d = rng.randn(n_rays, 3).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    lat = (0.05 * rng.randn(n_rays, 32)).astype(np.float32)
    return rays_o, rays_d, lat


def test_quantize_for_inference_then_render_matches_jax_and_f32(
        weights, interpret_pallas, monkeypatch):
    """tests/test_quant.py:78-114 on both sides. The JAX predicate asks for
    a TPU backend, so the probe is patched there; the port takes the plain
    version because the caller chose the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    tree, model = weights
    o, d, lat = _scene(40, 3)
    rs = RenderSettings(near=0.5, far=2.5, N_samples=16,
                        N_importance=8).test_mode()
    t_rs = t_config.RenderSettings(**dataclasses.asdict(rs))
    args = tuple(torch.from_numpy(a) for a in (o, d, lat))

    mq = KQ.quantize_for_inference(model, torch_cfg(CFG), o, d, lat, 0.5, 2.5,
                                   n_rays=16, n_samples=16)
    jparams = jq.quantize_for_inference(tree, CFG, o, d, lat, 0.5, 2.5,
                                        n_rays=16, n_samples=16)
    assert mq.quant is not None and model.quant is None
    for network in ("coarse", "fine"):
        np.testing.assert_allclose(
            mq.quant[network].scales.numpy(),
            np.asarray(jparams["quant"][network]["scales"]), rtol=1e-6)

    out_q = t_renderer(torch_cfg(CFG_I8), t_rs, chunk=64, device="cpu")(
        mq, *args)
    out_f = t_renderer(dataclasses.replace(torch_cfg(CFG), fused_kernel="off"),
                       t_rs, chunk=64, device="cpu")(model, *args)
    jout_q = j_renderer(CFG_I8, rs, chunk=64)(
        jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lat), None)
    rgb_q = out_q["rgb_map"].numpy()
    assert np.isfinite(rgb_q).all()
    # against the f32 renderer: int8-level agreement (test_quant.py:114)
    assert np.abs(rgb_q - out_f["rgb_map"].numpy()).mean() < 0.02
    # against the JAX int8 renderer: the same arithmetic, single activations
    # one quantization step apart at most
    assert np.abs(rgb_q - np.asarray(jout_q["rgb_map"])).mean() < 1e-3
    np.testing.assert_allclose(rgb_q, np.asarray(jout_q["rgb_map"]),
                               atol=2e-2)


def test_int8_without_calibration_raises(weights):
    _, model = weights
    o, d, lat = _scene(8, 1)
    rs = t_config.RenderSettings(near=0.5, far=2.5, N_samples=4,
                                 N_importance=4).test_mode()
    render = t_renderer(torch_cfg(CFG_I8), rs, chunk=8, device="cpu")
    with pytest.raises(ValueError, match="quantize_for_inference"):
        render(model, *(torch.from_numpy(a) for a in (o, d, lat)))


@pytest.mark.parametrize("case", ["viewdirs", "architecture", "scene_edit"])
def test_int8_outside_its_support_takes_the_f32_path(case):
    """tests/test_quant.py:116-123: no error, the plain f32 MLP."""
    cfg, edit = CFG_I8, t_config.EditConfig()
    if case == "viewdirs":
        cfg = dataclasses.replace(cfg, use_viewdirs=True)
        from nonrigid_nerf_tpu.config import EditConfig
        from nonrigid_nerf_tpu.engine.query import _use_fused_kernel
        assert not _use_fused_kernel(cfg, EditConfig())
    elif case == "architecture":
        cfg = dataclasses.replace(cfg, netwidth=128)
    else:
        edit = t_config.EditConfig(test_time_scaling=2.0)
    for device in ("cpu", "cuda"):     # a device object only: nothing runs
        assert not t_query.use_fused_kernel(torch_cfg(cfg), edit,
                                            torch.device(device))
    # the supported configuration takes the kernel's wrapper on both devices
    for device in ("cpu", "cuda"):
        assert t_query.use_fused_kernel(torch_cfg(CFG_I8),
                                        t_config.EditConfig(),
                                        torch.device(device))


def test_int8_viewdirs_renders_without_calibration():
    cfg = ModelConfig(use_viewdirs=True, fused_kernel="int8", netwidth=32,
                      netwidth_fine=32, N_samples=4, N_importance=4)
    model = params_from_jax(jax_params(cfg), torch_cfg(cfg), device="cpu")
    o, d, lat = _scene(8, 2)
    rs = t_config.RenderSettings(near=0.5, far=2.5, N_samples=4,
                                 N_importance=4).test_mode()
    out = t_renderer(torch_cfg(cfg), rs, chunk=8, device="cpu")(
        model, *(torch.from_numpy(a) for a in (o, d, lat)))
    assert torch.isfinite(out["rgb_map"]).all()


def test_train_step_rejects_int8():
    with pytest.raises(ValueError, match="inference-only"):
        t_step.make_train_step(
            torch_cfg(CFG_I8), t_config.TrainConfig(),
            t_config.RenderSettings(near=0.0, far=1.0), has_test_split=False)


def test_mlp_i8_rejects_bad_arguments(weights):
    _, model = weights
    scales = KQ.calibrate_act_scales(model.coarse, torch.from_numpy(_emb(64)))
    qw = KQ.pack_int8_mlp_weights(model.coarse, scales)
    with pytest.raises(ValueError, match="emb must be"):
        KQ.mlp_i8(torch.zeros(4, 63), qw)
    with pytest.raises(ValueError, match="packed int8 weights"):
        KQ.mlp_i8(torch.zeros(4, 64), qw[:-1])
    with pytest.raises(ValueError, match="int8"):
        KQ.mlp_i8(torch.zeros(4, 64), (qw[0].float(),) + qw[1:])
    assert KQ.mlp_i8(torch.zeros(0, 64), qw).shape == (0, 8)
    assert KQ.MACS_PER_POINT == 493_568      # PERF.md's bound: 0.987 MOP


# ---- the quant leaf through weights.py and checkpoints.py

def _assert_quant_equal(got, want):
    assert set(got) == set(want)
    for network in want:
        np.testing.assert_array_equal(np.asarray(got[network]["scales"]),
                                      np.asarray(want[network]["scales"]))
        a, b = got[network]["packed"], want[network]["packed"]
        assert isinstance(a, tuple) and len(a) == len(b) == 29
        for i, (x, y) in enumerate(zip(a, b)):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype.itemsize == y.dtype.itemsize
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=str(i))


def test_jax_tree_with_a_quant_leaf_goes_in_and_comes_back_equal(weights):
    tree, _ = weights
    jtree = jq.add_quant_scales(tree, jnp.asarray(_emb(256, 5)))
    model = params_from_jax(jtree, torch_cfg(CFG), device="cpu")
    assert model.quant["coarse"].p0.dtype == torch.int8        # stays int8
    assert model.quant["coarse"].p26.dtype == torch.bfloat16   # stays bf16
    assert model.quant["fine"].p1.dtype == torch.float32
    np.testing.assert_array_equal(
        model.quant["coarse"].p26.float().numpy(),
        np.asarray(jtree["quant"]["coarse"]["packed"][26].astype(jnp.float32)))
    back = params_to_jax(model)
    _assert_quant_equal(back["quant"], jtree["quant"])
    # the parameters beside it are untouched
    np.testing.assert_array_equal(back["coarse"]["pts"][0]["w"],
                                  tree["coarse"]["pts"][0]["w"])
    # the older form of the leaf, the scales alone, comes back as it went in
    legacy = dict(tree, quant={"coarse": np.asarray(
        jtree["quant"]["coarse"]["scales"])})
    m2 = params_from_jax(legacy, torch_cfg(CFG), device="cpu")
    assert m2.quant["coarse"].packed is None
    np.testing.assert_array_equal(params_to_jax(m2)["quant"]["coarse"],
                                  legacy["quant"]["coarse"])
    # packed at first use by the port, against the tuple that JAX packed
    for a, b in zip(KQ.packed_int8_weights(m2.quant["coarse"], m2.coarse),
                    model.quant["coarse"].packed):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-6 if a.dtype == torch.float32 else 0)


def test_checkpoint_round_trip_keeps_the_quant_state(weights, tmp_path):
    """A calibrated model survives save and load, bit for bit; the JAX
    package's reader reads the port's file, and the port reads the JAX
    package's."""
    tree, model = weights
    mq = KQ.add_quant_scales(model, torch.from_numpy(_emb(256, 6)))
    path = str(tmp_path / "latest.npz")
    t_ckpt.save_checkpoint(path, 7, mq, None, {"near": 0.5})
    step, loaded, extras = t_ckpt.load_checkpoint(path, torch_cfg(CFG),
                                                  device="cpu")
    assert step == 7 and extras == {"near": 0.5}
    for network in ("coarse", "fine"):
        assert torch.equal(loaded.quant[network].scales,
                           mq.quant[network].scales)
        for a, b in zip(loaded.quant[network].packed,
                        mq.quant[network].packed):
            assert a.dtype == b.dtype and torch.equal(a, b)
    state, _ = t_ckpt.load_train_state(path, torch_cfg(CFG), device="cpu")
    assert state.model.quant is not None and "quant.fine.p0" not in state.mu

    jstep, jparams, jopt, _ = j_ckpt.load_checkpoint(path)
    assert jstep == 7 and jopt is None
    _assert_quant_equal(jparams["quant"], params_to_jax(mq)["quant"])
    np.testing.assert_array_equal(jparams["coarse"]["pts"][3]["w"],
                                  tree["coarse"]["pts"][3]["w"])

    jtree = jq.add_quant_scales(tree, jnp.asarray(_emb(256, 6)))
    jpath = str(tmp_path / "jax.npz")
    j_ckpt.save_checkpoint(jpath, 9, jtree)
    _, from_jax, _ = t_ckpt.load_checkpoint(jpath, torch_cfg(CFG),
                                            device="cpu")
    _assert_quant_equal(params_to_jax(from_jax)["quant"], jtree["quant"])

    # without a quant state nothing of it is written
    plain = str(tmp_path / "plain.npz")
    t_ckpt.save_checkpoint(plain, 1, model)
    assert "quant" not in t_ckpt.read_checkpoint(plain)[1]
