"""The `_mlpv_core` backward module of the port against the JAX one (CPU).

- `mlpv_bwd_plain` against `jax.vjp` of `_mlpv_core` run in Pallas interpret
  mode (its backward is the Pallas kernel `_mlpv_bwd_kernel`): demb, dembv
  and the 26 gradients, exact up to bf16 rounding flips and ReLU gate flips,
  within the tolerances stated in `ops/kernels/mlp_bwd.py` (`agreement`).
  Observed at n = 300: gradients 1.0e-3 of max and 3.4e-4 in relative L2,
  demb and dembv 3e-4 in L2.
- `MLPVCore` through `torch.autograd.grad` against the same `jax.vjp`, down
  to the `nn.Linear` parameters of the chain and the four heads.

The CUDA kernel itself is held against the plain version on the card by
`tests/test_torch_kernels_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB1
from nonrigid_nerf_torch.ops.kernels import mlpv_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as K
from nonrigid_nerf_torch.weights import params_from_jax, tree_from_named
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg

BLOCK = 256


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


CFG = ModelConfig(use_viewdirs=True)


@pytest.fixture(scope="module")
def weights():
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    return tree, model


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    emb = rng.uniform(-1, 1, (n, 64)).astype(np.float32)
    emb[:, 63] = 0.0          # the pad lane
    embv = rng.uniform(-1, 1, (n, 32)).astype(np.float32)
    embv[:, 27:] = 0.0        # the pad lanes
    return emb, embv, rng.randn(n, 8).astype(np.float32)


def _pad(a, n):
    return jnp.asarray(np.pad(a, ((0, -n % BLOCK), (0, 0))))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("network", ["coarse", "fine"])
@pytest.mark.parametrize("n", [1, 127, 300])
def test_plain_matches_jax_vjp_of_mlpv_core(weights, interpret_pallas,
                                            network, n):
    tree, model = weights
    jp = fq.pack_viewdirs_mlp_weights(tree, network)
    with torch.no_grad():
        tc = K.cast_mlpv_weights(
            K.pack_viewdirs_mlp_weights(model.network(network)))
    emb, embv, draw = _inputs(n, n)
    _, vjp = jax.vjp(lambda e, v, w: fq._mlpv_core(e, v, w, BLOCK),
                     _pad(emb, n), _pad(embv, n), jp)
    demb_j, dembv_j, grads_j = vjp(_pad(draw, n))
    with torch.no_grad():
        got = KB.mlpv_bwd_plain(_t(emb).to(torch.bfloat16),
                                _t(embv).to(torch.bfloat16), tc, _t(draw))
    assert got[0].shape == (n, 64) and got[1].shape == (n, 32)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert len(got[2]) == 26
    for i, g in enumerate(got[2]):
        assert g.shape == K._expected_shape(i) and g.dtype == torch.float32
    ref = (_t(demb_j)[:n], _t(dembv_j)[:n], [_t(g) for g in grads_j])
    stats = KB.bwd_agreement(got, ref)
    assert stats["ok"], stats
    assert set(stats["max_rel"]) == set(KB.BWD_NAMES)
    # g_ab and g_rb are the f32 sum of the UNCAST draw over all 8 lanes
    for i in (20, 25):
        np.testing.assert_allclose(got[2][i].numpy()[0], draw.sum(0),
                                   rtol=1e-5, atol=1e-5)
    # the pad lanes of the view encoding get no gradient
    assert float(got[1][:, 27:].abs().max()) == 0.0


def test_cpu_tensor_takes_plain_version_without_launch(weights):
    _, model = weights
    with torch.no_grad():
        mw = K.cast_mlpv_weights(K.pack_viewdirs_mlp_weights(model.coarse))
    emb, embv, draw = (_t(a) for a in _inputs(33, 1))
    embb, embvb = emb.to(torch.bfloat16), embv.to(torch.bfloat16)
    before = KB.mlpv_bwd.launches
    got = KB.mlpv_bwd(embb, embvb, mw, draw)
    want = KB.mlpv_bwd_plain(embb, embvb, mw, draw)
    assert KB.mlpv_bwd.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_mlpv_bwd_rejects_bad_arguments(weights):
    _, model = weights
    with torch.no_grad():
        mw = K.cast_mlpv_weights(K.pack_viewdirs_mlp_weights(model.coarse))
    z = torch.zeros
    with pytest.raises(ValueError, match="draw must be"):
        KB.mlpv_bwd(z(4, 64), z(4, 32), mw, z(5, 8))
    with pytest.raises(ValueError, match="emb must be"):
        KB.mlpv_bwd(z(4, 63), z(4, 32), mw, z(4, 8))
    with pytest.raises(ValueError, match="embv must be"):
        KB.mlpv_bwd(z(4, 64), z(4, 31), mw, z(4, 8))
    with pytest.raises(ValueError, match="packed weights"):
        KB.mlpv_bwd(z(4, 64), z(4, 32), mw[:-1], z(4, 8))


def test_bwd_work_and_scratch_per_point():
    # 3.58 MFLOP per point and 599,440 gradient floats: the figures PERF.md's
    # bound is computed from; 9,984 B of scratch per point (the view encoding
    # padded to 64 lanes beside the encoding), so the 2^18-point limit of one
    # call keeps the scratch at 2.44 GiB
    assert KB.BWD_MACS_PER_POINT == 1_790_976
    assert KB.GRAD_FLOATS == 599_440
    assert KB.SCRATCH_PER_POINT * 2 == 9_984
    assert KB.MAX_POINTS_PER_LAUNCH == 1 << 18
    assert KB.MAX_POINTS_PER_LAUNCH * KB.SCRATCH_PER_POINT * 2 < 2.5 * 2 ** 30


def test_pack_carries_gradients_to_the_heads(weights):
    """A cotangent on the 9 packed head tensors comes back on nn.Linear's
    (fan_out, fan_in) weights, transposed, with the pad rows and the unused
    raw lanes dropped; alpha reads lane 3, rgb lanes 0:3."""
    _, model = weights
    net = model.coarse
    packed = K.pack_viewdirs_mlp_weights(net)
    rng = np.random.RandomState(0)
    cots = [torch.from_numpy(rng.randn(*w.shape).astype(np.float32))
            for w in packed]
    names = [n for n, _ in net.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        packed, list(net.parameters()), cots)))
    eq = np.testing.assert_array_equal
    eq(grads["pts.0.weight"].numpy(), cots[0].numpy()[:63].T)
    eq(grads["feature.weight"].numpy(), cots[17].numpy().T)
    eq(grads["feature.bias"].numpy(), cots[18].numpy()[0])
    eq(grads["alpha.weight"].numpy(), cots[19].numpy()[:, 3:4].T)
    eq(grads["alpha.bias"].numpy(), cots[20].numpy()[0, 3:4])
    eq(grads["views.0.weight"].numpy(),
       np.concatenate([cots[21].numpy(), cots[22].numpy()[:27]], 0).T)
    eq(grads["views.0.bias"].numpy(), cots[23].numpy()[0])
    eq(grads["rgb.weight"].numpy(), cots[24].numpy()[:, :3].T)
    eq(grads["rgb.bias"].numpy(), cots[25].numpy()[0, :3])


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_mlpv_core_grad_matches_jax_vjp_interpret(weights, interpret_pallas,
                                                  network):
    """Two cotangents over one graph (the training step's two phases): the
    saved tensors survive the first backward. 700 points: the fewer points a
    gradient sums, the more one flipped ReLU gate weighs, and at 300 points
    one flip in the fine network's layer 4 moves n4b by 1.06e-2 in relative
    L2, past the limit of 1e-2 (observed here: 7.3e-3)."""
    tree, model = weights
    net = model.network(network)
    n = 700
    emb, embv, _ = _inputs(n, 7)

    def jf(e, v, params):
        return fq._mlpv_core(
            e, v, fq.pack_viewdirs_mlp_weights(params, network), BLOCK)

    out_j, vjp = jax.vjp(jf, _pad(emb, n), _pad(embv, n), tree)
    emb_t = _t(emb).requires_grad_(True)
    embv_t = _t(embv).requires_grad_(True)
    out_t = KB.MLPVCore.apply(emb_t, embv_t, *K.pack_viewdirs_mlp_weights(net))
    err = np.abs(out_t.detach().numpy() - np.asarray(out_j)[:n])
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN

    names = [name for name, _ in net.named_parameters()]
    for seed in (11, 12):
        draw = np.random.RandomState(seed).randn(n, 8).astype(np.float32)
        demb_j, dembv_j, gtree = vjp(_pad(draw, n))
        grads = torch.autograd.grad(
            out_t, [emb_t, embv_t] + list(net.parameters()), _t(draw),
            retain_graph=True)
        got = tree_from_named({f"{network}.{k}": v for k, v in
                               zip(names, grads[2:])})[network]
        flat_g = jax.tree_util.tree_leaves(got)
        flat_w = jax.tree_util.tree_leaves(gtree[network])
        assert len(flat_g) == len(flat_w) == 24
        for a, b in zip(flat_g, flat_w):
            b = np.asarray(b)
            scale = max(np.abs(b).max(), 1e-30)
            assert np.abs(a - b).max() <= KB1.grad_max_tol(n) * scale
            assert (np.linalg.norm(a - b)
                    <= KB1.BWD_TOL_L2 * max(np.linalg.norm(b), 1e-30))
        for got_d, want_d in ((grads[0], demb_j), (grads[1], dembv_j)):
            want_d = np.asarray(want_d)[:n]
            assert (np.linalg.norm(got_d.numpy() - want_d)
                    <= KB1.BWD_TOL_L2 * np.linalg.norm(want_d))


def test_mlpv_core_refuses_a_wrong_number_of_weights(weights):
    _, model = weights
    packed = K.pack_viewdirs_mlp_weights(model.coarse)
    with pytest.raises(ValueError, match="26 packed weights"):
        KB.MLPVCore.apply(torch.zeros(2, 64), torch.zeros(2, 32), *packed[:-1])
