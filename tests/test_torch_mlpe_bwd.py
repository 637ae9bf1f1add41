"""`fused_kernel="pts"`, backward and end to end: the `_mlpe_core` backward
module of the port, the renderer and one whole training step in that mode,
against the JAX package (CPU).

- `mlpe_bwd_plain` against the VJP of `_mlpe_core` (Pallas interpret mode)
  within the tolerances stated in `ops/kernels/mlp_bwd.py`, and against
  `torch.autograd` of the plain forward's own expression
  (tests/test_fused_kernel.py:490-520 of the JAX package).
- `MLPECore` on the CPU gives what `mlpe_bwd_plain` gives, down to the
  `nn.Linear` parameters.
- `render_rays` in `pts` mode, the fine pass with stage-1 reuse included,
  against the JAX package's in `pts` mode; one training step in `pts` mode
  (`losses_and_grads`, the same draws, both phases) against the JAX
  package's, with the tolerances of `tests/test_torch_train_step.py`.

The CUDA kernel itself is held against the plain version on the card by
`tests/test_torch_kernels_cuda.py`.
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
from nonrigid_nerf_torch.engine import render as t_render
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels import mlpe_bwd as KEB
from nonrigid_nerf_torch.ops.kernels import mlpe_fwd as KE
from nonrigid_nerf_torch.weights import params_from_jax, tree_from_named
from nonrigid_nerf_tpu.config import ModelConfig, RenderSettings
from nonrigid_nerf_tpu.engine.render import render_rays as j_render_rays
from tests.test_torch_train_step import (N_RAYS, RS, TC, TOL, _t_rs, _t_tc,
                                         assert_rel, assert_tree_rel,
                                         both_sides, jax_losses_and_grads)
from tests.torch_parity import jax_params, torch_cfg


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


CFG = ModelConfig()
FLAGSHIP_PTS = ModelConfig(N_samples=8, N_importance=8, fused_kernel="pts")
BLOCK = 256


@pytest.fixture(scope="module")
def weights():
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    return tree, model


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, 3) * 1.5).astype(np.float32),
            rng.randn(n, 8).astype(np.float32))


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


@pytest.mark.parametrize("network", ["coarse", "fine"])
@pytest.mark.parametrize("n", [1, 127, 300])
def test_plain_matches_jax_vjp_interpret(weights, interpret_pallas, network, n):
    tree, model = weights
    pts, draw = _inputs(n, n)
    n_pad = -(-n // BLOCK) * BLOCK
    mw = fq.pack_mlp_pts_weights(tree, network)
    _, vjp = jax.vjp(lambda p, w: fq._mlpe_core(p, w, BLOCK),
                     jnp.asarray(_pad(pts, n_pad, fq.PTS_PAD)), mw)
    jdpts, jgrads = vjp(jnp.asarray(_pad(draw, n_pad, 8)))
    with torch.no_grad():
        tc = K.cast_mlp_weights(K.pack_mlp_weights(model.network(network)))
        before = KEB.mlpe_bwd.launches
        got = KEB.mlpe_bwd(torch.from_numpy(pts), tc, torch.from_numpy(draw))
    assert KEB.mlpe_bwd.launches == before         # a CPU tensor: no launch
    assert got[0].shape == (n, 3) and got[0].dtype == torch.float32
    for i, g in enumerate(got[1]):
        assert g.shape == K._expected_shape(i) and g.dtype == torch.float32
    # the pad lanes of the JAX dpts are zero, and so are the encoding
    # constants' cotangents
    jdpts = np.asarray(jdpts)
    assert np.abs(jdpts[:, 3:]).max() == 0.0
    assert all(np.abs(np.asarray(g)).max() == 0.0 for g in jgrads[fq.N_MLP_W:])
    ref = (torch.from_numpy(jdpts[:n, :3].copy()),
           [torch.from_numpy(np.asarray(g, np.float32))
            for g in jgrads[:fq.N_MLP_W]])
    stats = KEB.bwd_agreement(got, ref)
    assert stats["ok"], stats
    # g_ob is the f32 sum of the UNCAST draw
    np.testing.assert_allclose(got[1][18].numpy()[0], draw.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_autograd_of_the_same_math(weights):
    """The hand-written backward (encoding recomputed, demb folded onto the
    three coordinates) against autograd of the forward's own expression, on a
    mean-of-squares loss at n = 512: dpts atol 2e-5, weight gradients within
    max(5e-4, 5e-3 * max |g|), as tests/test_fused_kernel.py:490-520."""
    _, model = weights
    n = 512
    pts_np = np.random.RandomState(9).randn(n, 3).astype(np.float32)
    packed = [w.detach().clone().requires_grad_(True)
              for w in K.pack_mlp_weights(model.coarse)]

    class RoundBF16(torch.autograd.Function):
        """x -> bf16(x) as a value, the identity as a derivative: what
        jax.grad sees of astype(bfloat16)."""

        @staticmethod
        def forward(ctx, x):
            return x.to(torch.bfloat16).float()

        @staticmethod
        def backward(ctx, g):
            return g

    def rb(x):
        return RoundBF16.apply(x)

    def fwd_math(pts, w):
        (n0w, n0b, n1w, n1b, n2w, n2b, n3w, n3b, n4w, n4b,
         n5e, n5h, n5b, n6w, n6b, n7w, n7b, ow, ob) = w
        emb = rb(KE.embed_ew(pts)[1])
        h = rb(torch.relu(emb @ rb(n0w) + n0b))
        for wi, bi in ((n1w, n1b), (n2w, n2b), (n3w, n3b), (n4w, n4b)):
            h = rb(torch.relu(h @ rb(wi) + bi))
        h = rb(torch.relu(h @ rb(n5h) + emb @ rb(n5e) + n5b))
        for wi, bi in ((n6w, n6b), (n7w, n7b)):
            h = rb(torch.relu(h @ rb(wi) + bi))
        return h @ rb(ow) + ob

    pts = torch.from_numpy(pts_np).requires_grad_(True)
    raw = fwd_math(pts, packed)
    want = torch.autograd.grad(raw.square().mean(), [pts] + packed)
    with torch.no_grad():
        draw = 2.0 * raw.detach() / raw.numel()
        dpts, grads = KEB.mlpe_bwd_plain(
            torch.from_numpy(pts_np), K.cast_mlp_weights(packed), draw)
    np.testing.assert_allclose(dpts.numpy(), want[0].numpy(), atol=2e-5)
    for i, (a, b) in enumerate(zip(want[1:], grads)):
        tol = max(5e-4, 5e-3 * float(a.abs().max()))
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=tol,
                                   err_msg=f"weight grad {i}")


def test_mlpe_core_on_the_cpu_is_the_plain_version(weights):
    """Two cotangents over one graph (the training step's two phases): the
    saved tensors survive the first backward; the gradients of the packed
    weights reach the nn.Linear parameters."""
    _, model = weights
    net = model.coarse
    pts_np, _ = _inputs(200, 3)
    pts = torch.from_numpy(pts_np).requires_grad_(True)
    out = KEB.MLPECore.apply(pts, *K.pack_mlp_weights(net))
    with torch.no_grad():
        mw = K.cast_mlp_weights(K.pack_mlp_weights(net))
        assert torch.equal(out, KE.mlpe_fwd_plain(pts.detach(), mw))
    names = [name for name, _ in net.named_parameters()]
    for seed in (11, 12):
        draw = torch.from_numpy(
            np.random.RandomState(seed).randn(200, 8).astype(np.float32))
        got = torch.autograd.grad(out, [pts] + list(net.parameters()), draw,
                                  retain_graph=True)
        with torch.no_grad():
            dpts, grads = KEB.mlpe_bwd_plain(pts.detach(), mw, draw)
        assert torch.equal(got[0], dpts)
        by_name = dict(zip(names, got[1:]))
        assert torch.equal(by_name["pts.0.weight"], grads[0][:63].t())
        assert torch.equal(by_name["pts.5.weight"],
                           torch.cat([grads[10][:63], grads[11]], 0).t())
        assert torch.equal(by_name["output.bias"][:4], grads[18][0, :4])
    assert len(got) == 1 + 18            # dpts; nothing for P or the phase


def test_mlpe_bwd_rejects_bad_arguments(weights):
    _, model = weights
    with torch.no_grad():
        mw = K.cast_mlp_weights(K.pack_mlp_weights(model.coarse))
    with pytest.raises(ValueError, match="draw must be"):
        KEB.mlpe_bwd(torch.zeros(4, 3), mw, torch.zeros(5, 8))
    with pytest.raises(ValueError, match="pts must be"):
        KEB.mlpe_bwd(torch.zeros(4, 64), mw, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="packed weights"):
        KEB.mlpe_bwd(torch.zeros(4, 3), mw[:-1], torch.zeros(4, 8))
    dpts, grads = KEB.mlpe_bwd(torch.zeros(0, 3), mw, torch.zeros(0, 8))
    assert dpts.shape == (0, 3) and len(grads) == 19


def test_scratch_and_work_per_point():
    # the recomputed encoding sits where mlp_bwd's copy of the encoding
    # sits: 8,320 B per point, 2 GiB at the 2^18 points a call may take
    assert KEB.SCRATCH_PER_POINT * 2 == 8320
    assert KEB.MAX_POINTS_PER_LAUNCH == KB.MAX_POINTS_PER_LAUNCH == 1 << 18
    assert KEB.SCRATCH_PER_POINT * 2 * KEB.MAX_POINTS_PER_LAUNCH <= 2.1 * 2 ** 30
    assert KEB.BWD_MACS_PER_POINT == 1_480_704
    assert KEB.BWD_NAMES[0] == "dpts" and len(KEB.BWD_NAMES) == 20


# ---- the renderer and the training step in pts mode

def _rays(n, seed):
    rng = np.random.RandomState(seed)
    rays_o = (0.1 * rng.randn(n, 3)).astype(np.float32)
    rays_d = np.concatenate([0.4 * rng.randn(n, 2), -np.ones((n, 1))],
                            1).astype(np.float32)
    lat = (0.1 * rng.randn(n, 32)).astype(np.float32)
    return rays_o, rays_d, lat


@pytest.mark.parametrize("reuse", [True, False])
def test_render_rays_pts_mode_matches_jax(interpret_pallas, reuse):
    """Both passes; with stage-1 reuse the fine pass concatenates the coarse
    and the new samples' `embedded`, which in this mode are (R, S, 3) bent
    points, and needs no code of its own for that."""
    cfg = dataclasses.replace(FLAGSHIP_PTS, stage1_reuse=reuse)
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    rs = RenderSettings(N_samples=8, N_importance=8, near=0.5,
                        far=2.5).test_mode()
    o, d, lat = _rays(12, 5)
    before = KE.mlpe_fwd.launches
    with torch.no_grad():
        out = t_render.render_rays(model, torch_cfg(cfg), _t_rs(rs),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(lat), retraw=True)
    assert KE.mlpe_fwd.launches == before
    jout = j_render_rays(tree, cfg, rs, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(lat), key=None, retraw=True)
    assert out["raw"].shape == (12, 16, 4)
    for key in ("rgb_map", "rgb0", "disp_map", "acc_map", "depth_map"):
        # bf16 roundings inside the MLP flip differently in the two
        # libraries: the same 1e-3 as the raw outputs' BF16_TOL_MAX
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   atol=1e-3, rtol=1e-3, err_msg=key)


def test_one_step_in_pts_mode_matches_jax(interpret_pallas):
    """Losses, components and every gradient leaf of one step (both phases),
    the bender's and the latents' included: dpts reaches them. Tolerances of
    the kernels' plain versions against Pallas interpret mode, as
    tests/test_torch_train_step.py states them for fused_kernel="on"."""
    tol_loss, tol_grad, tol_l2 = TOL[("on", "float32")]
    (state, batch, draws), (jstate, jbatch, key, jcfg) = both_sides(
        FLAGSHIP_PTS, "float32")
    step_args = dict(cfg=torch_cfg(FLAGSHIP_PTS), tc=_t_tc(TC), rs=_t_rs(RS),
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
    assert float(grads["latents"].abs().max()) > 0
    assert float(grads["bender.bend.0.weight"].abs().max()) > 0
    assert_tree_rel(tree_from_named(grads), jgrads, tol_grad, tol_l2)


def test_make_train_step_accepts_pts_and_the_step_runs():
    cfg = t_config.ModelConfig(N_samples=4, N_importance=4, fused_kernel="pts")
    (state, batch, draws), _ = both_sides(
        dataclasses.replace(FLAGSHIP_PTS, N_samples=8, N_importance=8),
        "float32")
    t_step.make_train_step(cfg, _t_tc(TC), _t_rs(RS), has_test_split=True)
    old = state.model.coarse.pts[0].weight.detach().clone()
    metrics = t_step.train_step_from_batch(
        state, batch, draws=draws, cfg=torch_cfg(FLAGSHIP_PTS), tc=_t_tc(TC),
        rs=_t_rs(RS), has_test_split=True, n_rand=N_RAYS)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(state.model.coarse.pts[0].weight, old)
