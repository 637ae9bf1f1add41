"""The backward in pieces (`ops/kernels/pieces.py`), on the CPU.

- Each of the five autograd functions (`MLPCore`, `MLPVCore`, `MLPECore`,
  `BendCore`, `FusedCore`) at 300 points in pieces of 64 (the last one
  ragged, 44 points) against the same function in one piece, on the plain
  versions: the outputs are the same call, so equal; the per-point
  cotangents and every weight gradient within PIECES_TOL of the array's max
  magnitude: the pieces' f32 sums run in another order (observed 3.3e-7 at
  worst, with no bf16 rounding flipped); and the pieces bit-equal from run
  to run.
- A flagship training step whose fine pass (16 rays x 16 samples, 256
  points) spans three pieces of 100 points, and whose coarse pass spans
  two, against the JAX package's step on the same draws (Pallas interpret
  mode), within `tests/test_torch_train_step.py`'s tolerances for the
  kernels' plain versions ("on": losses 1e-4, gradients 5e-2 of max
  magnitude and 2e-2 in relative L2), and against the port's own step in
  one piece (losses 1e-6, gradients PIECES_TOL).
"""

import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
from nonrigid_nerf_torch.ops.kernels import bend_fwd as BF
from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels import mlpe_bwd as KEB
from nonrigid_nerf_torch.ops.kernels import mlpv_bwd as KVB
from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as KV
from nonrigid_nerf_torch.ops.kernels import pieces
from nonrigid_nerf_torch.weights import tree_from_named
from tests.test_torch_train_step import (FLAGSHIP, N_RAYS, RS, TC, TOL, _t_rs,
                                         _t_tc, assert_rel, assert_tree_rel,
                                         both_sides, interpret_pallas,  # noqa: F401
                                         jax_losses_and_grads)
from tests.torch_parity import torch_cfg

N, PIECE = 300, 64
PIECES_TOL = 1e-5


def _model(use_viewdirs=False):
    cfg = t_config.ModelConfig(use_viewdirs=use_viewdirs)
    model = NRNeRF(cfg, 3, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    with torch.no_grad():   # bend and rigidity: off their zero start
        g = torch.Generator().manual_seed(1)
        for layer in (model.bender.bend[-1], model.bender.rigidity[-1]):
            layer.weight.copy_(0.3 * torch.randn(layer.weight.shape,
                                                 generator=g))
    return model


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))


def _case(name):
    """(fn(*inputs) -> outputs, inputs, parameters whose gradients count,
    cotangents) of one autograd function at N points."""
    rng = np.random.RandomState(3)
    pts, lat = _f32(rng, N, 3, scale=0.5), _f32(rng, N, 32, scale=0.3)
    if name == "mlpv":
        net = _model(use_viewdirs=True).coarse
        packed = KV.pack_viewdirs_mlp_weights(net)
        inputs = (_f32(rng, N, 64), _f32(rng, N, 32))
        return (lambda e, ev: (KVB.MLPVCore.apply(e, ev, *packed),), inputs,
                list(net.parameters()), (_f32(rng, N, 8),))
    model = _model()
    if name in ("mlp", "mlpe"):
        packed = K.pack_mlp_weights(model.coarse)
        params = list(model.coarse.parameters())
        if name == "mlp":
            return (lambda e: (KB.MLPCore.apply(e, *packed),),
                    (_f32(rng, N, 64),), params, (_f32(rng, N, 8),))
        return (lambda p: (KEB.MLPECore.apply(p, *packed),), (pts,), params,
                (_f32(rng, N, 8),))
    if name == "bend":
        packed = BF.pack_bend_weights(model.bender)
        return (lambda p, la: BB.BendCore.apply(p, la, *packed), (pts, lat),
                list(model.bender.parameters()),
                (_f32(rng, N, 64, scale=0.1), _f32(rng, N, 3),
                 _f32(rng, N, 1)))
    packed = FQ.pack_fused_weights(model)
    return (lambda p, la: FB.FusedCore.apply(p, la, *packed), (pts, lat),
            list(model.bender.parameters()) + list(model.coarse.parameters()),
            (_f32(rng, N, 8), _f32(rng, N, 3), _f32(rng, N, 1)))


def _grads(name):
    fn, inputs, params, cots = _case(name)
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*inputs)
    grads = torch.autograd.grad(outs, inputs + params, cots)
    return [o.detach() for o in outs], list(grads)


@pytest.mark.parametrize("name", ["mlp", "mlpv", "mlpe", "bend", "fused"])
def test_backward_in_pieces_equals_one_piece(name, monkeypatch):
    outs_one, grads_one = _grads(name)
    monkeypatch.setattr(pieces, "PIECE_POINTS", PIECE)
    calls = []
    orig = pieces.backward_in_pieces

    def counted(bwd, *per_point):
        calls.append([t.shape[0] for t in per_point])
        return orig(bwd, *per_point)

    for module in (KB, KVB, KEB, BB, FB):
        monkeypatch.setattr(module, "backward_in_pieces", counted)
    outs, grads = _grads(name)
    assert calls and all(c == [N] * len(c) for c in calls)
    assert all(torch.equal(a, b) for a, b in zip(outs, outs_one))
    assert len(grads) == len(grads_one)
    for a, b in zip(grads, grads_one):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= PIECES_TOL * scale
    _, again = _grads(name)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_pieces_join_rows_and_sum_gradients_in_order():
    """The helper itself: rows in order, gradients piece 0 + piece 1 + ...
    in f32, one call for a single piece."""
    seen = []

    def bwd(x):
        seen.append(x.shape[0])
        return 2 * x, [x.sum(0, keepdim=True), x[:1] * 0 + len(seen)]

    x = torch.arange(10.0).reshape(5, 2)
    rows, grads = pieces.backward_in_pieces(bwd, x)
    assert seen == [5] and torch.equal(rows, 2 * x)
    seen.clear()
    pieces_before = pieces.PIECE_POINTS
    try:
        pieces.PIECE_POINTS = 2
        rows, grads = pieces.backward_in_pieces(bwd, x)
    finally:
        pieces.PIECE_POINTS = pieces_before
    assert seen == [2, 2, 1] and torch.equal(rows, 2 * x)
    assert torch.equal(grads[0], x.sum(0, keepdim=True))
    assert torch.equal(grads[1], torch.full((1, 2), 6.0))


def test_training_step_in_pieces_matches_jax(monkeypatch, interpret_pallas):  # noqa: F811
    (state, batch, draws), (jstate, jbatch, key, jcfg) = both_sides(
        FLAGSHIP, "float32")
    step_args = dict(cfg=torch_cfg(FLAGSHIP), tc=_t_tc(TC), rs=_t_rs(RS),
                     has_test_split=True, n_rand=N_RAYS)
    losses_one, _, grads_one = t_step.losses_and_grads(
        state.model, 0, batch, draws=draws, **step_args)
    monkeypatch.setattr(pieces, "PIECE_POINTS", 100)
    sizes = []
    orig = KB.mlp_bwd
    monkeypatch.setattr(KB, "mlp_bwd", lambda e, mw, d: (
        sizes.append(e.shape[0]), orig(e, mw, d))[1])
    losses, aux, grads = t_step.losses_and_grads(
        state.model, 0, batch, draws=draws, **step_args)
    # two cotangents (train and test rays): fine 100 + 100 + 56, coarse
    # 100 + 28, each twice
    assert sorted(sizes) == sorted([100, 100, 56, 100, 28] * 2)
    assert_rel(losses, losses_one, 1e-6, "losses vs one piece")
    for name, g in grads.items():
        scale = max(grads_one[name].abs().max().item(), 1e-30)
        assert (g - grads_one[name]).abs().max().item() <= PIECES_TOL * scale
    tol_loss, tol_grad, tol_l2 = TOL[("on", "float32")]
    # eager, as tests/test_torch_train_step.py runs it: under jax.jit XLA
    # reorders the sums of the fine net's first bias, whose gradient cancels
    # to 1e-6, and moves it by 8% of its max
    jlosses, _, jgrads = jax_losses_and_grads(
        jstate.params, jbatch, key, 0, jcfg, TC, RS, True, N_RAYS)
    assert_rel(losses, jlosses, tol_loss, "losses")
    assert_tree_rel(tree_from_named(grads), jgrads, tol_grad, tol_l2)
