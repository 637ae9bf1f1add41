"""The `_mlp_core` backward module of the port against the JAX one (CPU).

- `mlp_bwd_plain` against the Pallas kernel's math `_mlp_bwd_math`: demb and
  the 19 gradients, exact up to bf16 rounding flips and ReLU gate flips,
  within the tolerances stated in `ops/kernels/mlp_bwd.py`
  (`bwd_agreement`).
- `MLPCore` through `torch.autograd.grad` against `jax.vjp` of `_mlp_core`
  run in Pallas interpret mode, down to the `nn.Linear` parameters.

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
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.weights import params_from_jax, params_to_jax
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


CFG = ModelConfig()


@pytest.fixture(scope="module")
def weights():
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    return tree, model


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    emb = rng.uniform(-1, 1, (n, 64)).astype(np.float32)
    emb[:, 63] = 0.0          # the pad lane
    return emb, rng.randn(n, 8).astype(np.float32)


def _as_torch(pair):
    demb, grads = pair
    return (torch.from_numpy(np.asarray(demb, np.float32)),
            [torch.from_numpy(np.asarray(g, np.float32)) for g in grads])


@pytest.mark.parametrize("network", ["coarse", "fine"])
@pytest.mark.parametrize("n", [1, 127, 300])
def test_plain_matches_jax_math(weights, network, n):
    tree, model = weights
    jc = fq._cast_matmul_weights(fq.pack_mlp_weights(tree, network))
    tc = K.cast_mlp_weights(K.pack_mlp_weights(model.network(network)))
    emb, draw = _inputs(n, n)
    ref = fq._mlp_bwd_math(jnp.asarray(emb).astype(jnp.bfloat16), jc,
                           jnp.asarray(draw))
    with torch.no_grad():
        got = KB.mlp_bwd_plain(torch.from_numpy(emb).to(torch.bfloat16), tc,
                               torch.from_numpy(draw))
    assert got[0].shape == (n, 64) and got[0].dtype == torch.float32
    for i, g in enumerate(got[1]):
        assert g.shape == K._expected_shape(i) and g.dtype == torch.float32
    stats = KB.bwd_agreement(got, _as_torch(ref))
    assert stats["ok"], stats
    # g_ob is the f32 sum of the UNCAST draw: the bf16-rounded draw would be
    # off by about 2^-9 of each term
    np.testing.assert_allclose(got[1][18].numpy()[0], draw.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensor_takes_plain_version_without_launch(weights):
    _, model = weights
    with torch.no_grad():
        mw = K.cast_mlp_weights(K.pack_mlp_weights(model.coarse))
    emb, draw = _inputs(33, 1)
    embb = torch.from_numpy(emb).to(torch.bfloat16)
    before = KB.mlp_bwd.launches
    got = KB.mlp_bwd(embb, mw, torch.from_numpy(draw))
    want = KB.mlp_bwd_plain(embb, mw, torch.from_numpy(draw))
    assert KB.mlp_bwd.launches == before
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_mlp_bwd_rejects_bad_arguments(weights):
    _, model = weights
    with torch.no_grad():
        mw = K.cast_mlp_weights(K.pack_mlp_weights(model.coarse))
    with pytest.raises(ValueError, match="draw must be"):
        KB.mlp_bwd(torch.zeros(4, 64), mw, torch.zeros(5, 8))
    with pytest.raises(ValueError, match="emb must be"):
        KB.mlp_bwd(torch.zeros(4, 63), mw, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="packed weights"):
        KB.mlp_bwd(torch.zeros(4, 64), mw[:-1], torch.zeros(4, 8))


def test_bwd_work_per_point():
    # 2.96 MFLOP per point and 495,624 gradient floats: the figures PERF.md's
    # bound is computed from
    assert KB.BWD_MACS_PER_POINT == 1_480_704
    assert KB.GRAD_FLOATS == 495_624


def test_pack_mlp_weights_carries_gradients_to_the_linear_layers(weights):
    """A cotangent on the 19 packed tensors comes back on nn.Linear's
    (fan_out, fan_in) weights, transposed, with the pad rows, the pad lanes
    and the unused fifth output channel dropped."""
    _, model = weights
    net = model.coarse
    packed = K.pack_mlp_weights(net)
    rng = np.random.RandomState(0)
    cots = [torch.from_numpy(rng.randn(*w.shape).astype(np.float32))
            for w in packed]
    params = list(net.parameters())
    grads = torch.autograd.grad(packed, params, cots)
    by_name = dict(zip([n for n, _ in net.named_parameters()], grads))
    np.testing.assert_array_equal(by_name["pts.0.weight"].numpy(),
                                  cots[0].numpy()[:63].T)
    np.testing.assert_array_equal(by_name["pts.3.bias"].numpy(),
                                  cots[7].numpy()[0])
    np.testing.assert_array_equal(
        by_name["pts.5.weight"].numpy(),
        np.concatenate([cots[10].numpy()[:63], cots[11].numpy()], 0).T)
    np.testing.assert_array_equal(by_name["output.weight"].numpy()[:4],
                                  cots[17].numpy()[:, :4].T)
    assert by_name["output.weight"][4].abs().max() == 0
    np.testing.assert_array_equal(by_name["output.bias"].numpy(),
                                  np.append(cots[18].numpy()[0, :4], 0.0))


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_mlp_core_grad_matches_jax_vjp_interpret(weights, interpret_pallas,
                                                 network):
    """Two cotangents over one graph (the training step's two phases): the
    saved tensors survive the first backward."""
    tree, model = weights
    net = model.network(network)
    n, block = 300, fq.MLP_FWD_BLOCK
    emb, _ = _inputs(n, 7)
    padded = np.pad(emb, ((0, block - n), (0, 0)))

    def jf(e, params):
        return fq._mlp_core(e, fq.pack_mlp_weights(params, network), block)

    out_j, vjp = jax.vjp(jf, jnp.asarray(padded), tree)
    emb_t = torch.from_numpy(emb).requires_grad_(True)
    out_t = KB.MLPCore.apply(emb_t, *K.pack_mlp_weights(net))
    err = np.abs(out_t.detach().numpy() - np.asarray(out_j)[:n])
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN

    names = [name for name, _ in net.named_parameters()]
    for seed in (11, 12):
        draw = np.random.RandomState(seed).randn(n, 8).astype(np.float32)
        demb_j, gtree = vjp(jnp.asarray(np.pad(draw, ((0, block - n), (0, 0)))))
        grads = torch.autograd.grad(out_t, [emb_t] + list(net.parameters()),
                                    torch.from_numpy(draw), retain_graph=True)
        got = params_to_jax_named(network, dict(zip(names, grads[1:])))
        want = gtree[network]
        flat_g = jax.tree_util.tree_leaves(got)
        flat_w = jax.tree_util.tree_leaves(want)
        assert len(flat_g) == len(flat_w) == 18
        for a, b in zip(flat_g, flat_w):
            b = np.asarray(b)
            scale = max(np.abs(b).max(), 1e-30)
            assert np.abs(a - b).max() <= KB.grad_max_tol(n) * scale
            assert (np.linalg.norm(a - b)
                    <= KB.BWD_TOL_L2 * max(np.linalg.norm(b), 1e-30))
        demb_j = np.asarray(demb_j)[:n]
        assert (np.linalg.norm(grads[0].numpy() - demb_j)
                <= KB.BWD_TOL_L2 * np.linalg.norm(demb_j))


def params_to_jax_named(network, named):
    """Gradients by `NeRF` parameter name as the JAX subtree of `network`."""
    from nonrigid_nerf_torch.weights import tree_from_named
    return tree_from_named({f"{network}.{k}": v for k, v in named.items()})[network]


def test_params_to_jax_inverts_params_from_jax(weights):
    tree, model = weights
    back = params_to_jax(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert isinstance(back["coarse"]["pts"], list)
