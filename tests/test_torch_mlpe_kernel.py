"""`fused_kernel="pts"`, forward: the `_mlpe_core` kernel module of the port
and the engine's routing of it, against the JAX package (CPU).

On the CPU the kernel's plain version `mlpe_fwd_plain` is held against
`_mlpe_core` run in Pallas interpret mode, within the bf16 tolerance
`BF16_TOL_MAX` / `BF16_TOL_MEAN` of `ops/kernels/mlp_fwd.py`, and against the
kernel that reads the bf16 encoding. The CUDA kernel itself is held against
the plain version on the card by `tests/test_torch_kernels_cuda.py`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.ops.embedding import fourier_embed
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels import mlpe_fwd as KE
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig
from nonrigid_nerf_tpu.engine import query as j_query
from tests.torch_parity import jax_params, torch_cfg


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


CFG = ModelConfig()
CFG_PTS = dataclasses.replace(CFG, fused_kernel="pts")
BLOCK = 256


@pytest.fixture(scope="module")
def weights():
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    return tree, model


def _cast(net):
    with torch.no_grad():
        return K.cast_mlp_weights(K.pack_mlp_weights(net))


def _pts(n, seed=0):
    """Bent points a few units around the origin: the sines' arguments reach
    2^9 |x|, thousands of radians."""
    return (np.random.RandomState(seed).randn(n, 3) * 1.5).astype(np.float32)


def _jax_mlpe(tree, pts, network="coarse"):
    """`_mlpe_core` (interpret mode) on pts (n, 3), padded as the engine pads."""
    n = pts.shape[0]
    n_pad = -(-max(n, 1) // BLOCK) * BLOCK
    pts_pad = np.zeros((n_pad, fq.PTS_PAD), np.float32)
    pts_pad[:n, :3] = pts
    raw = fq._mlpe_core(jnp.asarray(pts_pad),
                        fq.pack_mlp_pts_weights(tree, network), BLOCK)
    return np.asarray(raw)[:n]


def test_embedding_projection_equals_jax():
    P, phase = KE.embedding_projection()
    jP, jphase = fq._embedding_projection(10)
    assert P.dtype == phase.dtype == np.float32
    np.testing.assert_array_equal(P, jP)
    np.testing.assert_array_equal(phase, jphase)
    # one entry per column, a power of two; the pad lane has none
    assert ((P != 0).sum(0)[:63] == 1).all() and (P[:, 63] == 0).all()
    assert phase[63] == 0.0
    with pytest.raises(ValueError, match="does not fit"):
        KE.embedding_projection(11)


def test_embed_ew_equals_jax_and_the_fourier_encoding():
    pts = _pts(300, 1)
    jP, jphase = fq._embedding_projection(10)
    pts_pad = np.zeros((300, fq.PTS_PAD), np.float32)
    pts_pad[:, :3] = pts
    jpre, _, jemb = fq._embed_ew(jnp.asarray(pts_pad), jnp.asarray(jP),
                                 jnp.asarray(jphase).reshape(1, -1))
    pre, emb = KE.embed_ew(torch.from_numpy(pts))
    np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))   # exact
    # the two libraries' f32 sines differ by an ulp or two
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=3e-7)
    assert (emb[:, 63] == 0).all()
    # against sin and cos of the port's own encoding: sin(x + pi/2) is cos(x)
    # up to the rounding of the sum, 2^9 |x| * 2^-24 at the top octave
    ref = fourier_embed(torch.from_numpy(pts), 10)
    np.testing.assert_allclose(emb[:, :63].numpy(), ref.numpy(), atol=5e-4)


@pytest.mark.parametrize("network", ["coarse", "fine"])
@pytest.mark.parametrize("n", [1, 255, 700])
def test_plain_matches_pallas_interpret(weights, interpret_pallas, network, n):
    tree, model = weights
    pts = _pts(n, n)
    ref = _jax_mlpe(tree, pts, network)
    before = KE.mlpe_fwd.launches
    out = KE.mlpe_fwd(torch.from_numpy(pts), _cast(model.network(network)))
    assert KE.mlpe_fwd.launches == before          # a CPU tensor: no launch
    assert out.shape == (n, 8) and out.dtype == torch.float32
    err = np.abs(out.numpy() - ref)
    assert err.max() <= K.BF16_TOL_MAX, err.max()
    assert err.mean() <= K.BF16_TOL_MEAN, err.mean()


def test_plain_matches_the_kernel_that_reads_the_encoding(weights):
    """The same math; only the rounding point of the encoding differs (here
    f32 sin(pre + phase) then bf16, there bf16 of sin and cos):
    tests/test_fused_kernel.py:481-483 allows atol 2e-2, rtol 1e-3."""
    _, model = weights
    mw = _cast(model.coarse)
    pts = torch.from_numpy(_pts(512, 8))
    raw_e = KE.mlpe_fwd_plain(pts, mw)
    emb = torch.nn.functional.pad(fourier_embed(pts, 10), (0, 1))
    raw_m = K.mlp_fwd_plain(emb.to(torch.bfloat16), mw)
    np.testing.assert_allclose(raw_e[:, :4].numpy(), raw_m[:, :4].numpy(),
                               atol=2e-2, rtol=1e-3)
    # and against the plain f32 MLP: mean error under 2% of mean |raw|
    raw_x = model.coarse(fourier_embed(pts, 10)).detach()
    err = (raw_e[:, :4] - raw_x).abs().mean() / raw_x.abs().mean()
    assert err < 0.02, err


def test_no_points(weights):
    _, model = weights
    out = KE.mlpe_fwd(torch.zeros(0, 3), _cast(model.coarse))
    assert out.shape == (0, 8) and out.dtype == torch.float32


def test_mlpe_fwd_rejects_bad_arguments(weights):
    _, model = weights
    mw = _cast(model.coarse)
    with pytest.raises(ValueError, match="pts must be"):
        KE.mlpe_fwd(torch.zeros(4, 8), mw)
    with pytest.raises(ValueError, match="packed weights"):
        KE.mlpe_fwd(torch.zeros(4, 3), mw[:-1])
    with torch.no_grad():
        f32 = K.pack_mlp_weights(model.coarse)
    with pytest.raises(ValueError, match="bfloat16"):
        KE.mlpe_fwd(torch.zeros(4, 3), f32)


def test_encode_in_kernel_predicate_equals_jax():
    cases = [CFG, CFG_PTS,
             dataclasses.replace(CFG_PTS, use_viewdirs=True),
             dataclasses.replace(CFG_PTS, multires=8),
             dataclasses.replace(CFG_PTS, i_embed=-1),
             dataclasses.replace(CFG_PTS, ray_bending=None,
                                 time_conditioned_baseline=True)]
    for cfg in cases:
        assert (t_query.encode_in_kernel(torch_cfg(cfg))
                == j_query._encode_in_kernel(cfg)), cfg
    assert t_query.encode_in_kernel(torch_cfg(CFG_PTS))
    assert not t_query.encode_in_kernel(torch_cfg(CFG))     # opt-in only


def test_stage_1_hands_over_raw_points_in_pts_mode(weights):
    """tests/test_fused_kernel.py:427-448 of the JAX package."""
    tree, model = weights
    rng = np.random.RandomState(7)
    pts = rng.randn(4, 8, 3).astype(np.float32)
    lat = (0.1 * rng.randn(4, 32)).astype(np.float32)
    with torch.no_grad():
        st = t_query.bend_encode_stage(model, torch_cfg(CFG_PTS),
                                       torch.from_numpy(pts),
                                       torch.from_numpy(lat), fused=True)
        st_enc = t_query.bend_encode_stage(model, torch_cfg(CFG),
                                           torch.from_numpy(pts),
                                           torch.from_numpy(lat), fused=True)
        st_off = t_query.bend_encode_stage(model, torch_cfg(CFG_PTS),
                                           torch.from_numpy(pts),
                                           torch.from_numpy(lat), fused=False)
    # raw bent points in f32, not the 63-channel encoding
    assert st["embedded"].shape == (4, 8, 3)
    assert st["embedded"].dtype == torch.float32
    assert torch.equal(st["embedded"], st["bent_pts"])
    assert st_enc["embedded"].shape == (4, 8, 63)
    assert st_enc["embedded"].dtype == torch.bfloat16
    assert st_off["embedded"].shape == (4, 8, 63)    # not fused: the encoding
    jst = j_query.bend_encode_stage(tree, CFG_PTS, jnp.asarray(pts),
                                    jnp.asarray(lat), fused=True)
    assert jst["embedded"].shape == (4, 8, 3)
    np.testing.assert_allclose(st["embedded"].numpy(),
                               np.asarray(jst["embedded"]), atol=1e-6)


def test_query_points_pts_mode_matches_off_and_jax(weights, interpret_pallas):
    tree, model = weights
    rng = np.random.RandomState(11)
    pts = rng.randn(8, 16, 3).astype(np.float32)
    lat = (0.1 * rng.randn(8, 32)).astype(np.float32)
    args = (torch.from_numpy(pts), None, torch.from_numpy(lat))
    with torch.no_grad():
        raw_p = t_query.query_points(model, torch_cfg(CFG_PTS), *args)
        raw_x = t_query.query_points(
            model, dataclasses.replace(torch_cfg(CFG), fused_kernel="off"),
            *args)
    assert raw_p.shape == (8, 16, 4)
    # bf16 inside the MLP against f32 (tests/test_fused_kernel.py:450-465)
    rel = (raw_p - raw_x).abs().mean() / raw_x.abs().mean()
    assert rel < 0.02, rel
    jraw = j_query.query_points(tree, CFG_PTS, jnp.asarray(pts), None,
                                jnp.asarray(lat))
    err = np.abs(raw_p.numpy() - np.asarray(jraw))
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN


def test_query_points_pts_mode_records_a_graph_under_autograd(weights):
    """With a gradient being recorded stage 2 goes through `MLPECore`: the
    bent points, and through them the bender and the latents, get one."""
    _, model = weights
    rng = np.random.RandomState(12)
    pts = torch.from_numpy(rng.randn(4, 8, 3).astype(np.float32))
    lat = model.latents[:1].expand(4, -1)
    raw = t_query.query_points(model, torch_cfg(CFG_PTS), pts, None, lat)
    grads = torch.autograd.grad(raw.square().mean(), [
        model.latents, model.bender.bend[0].weight,
        model.coarse.pts[0].weight])
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


@pytest.mark.parametrize("case", ["viewdirs", "multires", "identity",
                                  "scene_edit", "architecture"])
def test_pts_mode_raises_outside_its_support(case):
    cfg = t_config.ModelConfig(fused_kernel="pts")
    edit = t_config.EditConfig()
    if case == "viewdirs":
        cfg = dataclasses.replace(cfg, use_viewdirs=True)
    elif case == "multires":
        cfg = dataclasses.replace(cfg, multires=8)
    elif case == "identity":
        cfg = dataclasses.replace(cfg, i_embed=-1)
    elif case == "scene_edit":
        edit = t_config.EditConfig(render_canonical=True)
    else:
        cfg = dataclasses.replace(cfg, netwidth=128)
    for device in ("cpu", "cuda"):     # a device object only: nothing runs
        with pytest.raises(ValueError, match="outside the kernel's support"):
            t_query.use_fused_kernel(cfg, edit, torch.device(device))


def test_pts_mode_with_the_time_conditioned_baseline_raises():
    """The JAX package raises ValueError from its predicate; the port does
    not build that model at all yet."""
    cfg = ModelConfig(fused_kernel="pts", ray_bending=None,
                      time_conditioned_baseline=True)
    with pytest.raises(ValueError, match="outside the kernel's support"):
        j_query.use_fused_kernel(cfg, j_query.EditConfig())
    with pytest.raises(ValueError, match="outside the kernel's support"):
        t_query.use_fused_kernel(torch_cfg(cfg), t_config.EditConfig(),
                                 torch.device("cpu"))


def test_pts_mode_is_on_for_every_device_and_unknown_modes_raise():
    edit = t_config.EditConfig()
    cfg = t_config.ModelConfig(fused_kernel="pts")
    assert t_query.use_fused_kernel(cfg, edit, torch.device("cpu"))
    assert t_query.use_fused_kernel(cfg, edit, torch.device("cuda"))
    with pytest.raises(ValueError, match="unknown fused_kernel"):
        t_query.use_fused_kernel(t_config.ModelConfig(fused_kernel="fast"),
                                 edit, torch.device("cuda"))


def test_work_per_point():
    # the figures PERF.md's bound is computed from: mlp_fwd's MACs, and 44 B
    # per point (12 B of coordinates in, 32 B of raw out)
    assert K.MACS_PER_POINT == 493_568
    assert KE.PTS * 4 + K.OUT_PAD * 4 == 44
