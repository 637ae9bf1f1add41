"""The `_mlp_core` forward kernel module of the port against the JAX one.

On the CPU the kernel's plain version `mlp_fwd_plain` is held against the
Pallas kernel's math `_mlp_fwd_math` and against `_mlp_core` run in Pallas
interpret mode, with the bf16 tolerance `BF16_TOL_MAX` / `BF16_TOL_MEAN`
pinned in the module. The CUDA kernel itself is held against the plain
version on the card by `tests/test_torch_kernels_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.weights import params_from_jax
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


def _packed(net):
    """The packed weights as plain values: `pack_mlp_weights` is
    differentiable (training sends gradients through it), these tests
    compare values."""
    with torch.no_grad():
        return K.pack_mlp_weights(net)


def _emb(n, seed=0):
    emb = np.random.RandomState(seed).uniform(-1, 1, (n, 64)).astype(np.float32)
    emb[:, 63] = 0.0          # the pad lane
    return emb


def assert_bf16_close(out, ref):
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert err.max() <= K.BF16_TOL_MAX, err.max()
    assert err.mean() <= K.BF16_TOL_MEAN, err.mean()


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_pack_mlp_weights_equals_jax(weights, network):
    tree, model = weights
    jp = fq.pack_mlp_weights(tree, network)
    tp = _packed(model.network(network))
    assert len(tp) == K.N_MLP_W == len(jp)
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert b.dtype == torch.float32 and b.shape == K._expected_shape(i)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cast_mlp_weights_equals_jax(weights):
    tree, model = weights
    jc = fq._cast_matmul_weights(fq.pack_mlp_weights(tree))
    tc = K.cast_mlp_weights(_packed(model.coarse))
    for a, b in zip(jc, tc):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      b.float().numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_math(weights, seed):
    tree, model = weights
    jc = fq._cast_matmul_weights(fq.pack_mlp_weights(tree))
    tc = K.cast_mlp_weights(_packed(model.coarse))
    emb = _emb(700, seed)
    ref = fq._mlp_fwd_math(jnp.asarray(emb), jc)
    out = K.mlp_fwd_plain(torch.from_numpy(emb), tc)
    assert out.shape == (700, 8) and out.dtype == torch.float32
    assert_bf16_close(out.numpy(), ref)


def test_plain_matches_pallas_interpret(weights, interpret_pallas):
    tree, model = weights
    emb = _emb(700, 2)
    block = fq.MLP_FWD_BLOCK
    padded = np.pad(emb, ((0, block - 700), (0, 0)))
    ref = np.asarray(fq._mlp_core(jnp.asarray(padded),
                                  fq.pack_mlp_weights(tree), block))[:700]
    out = K.mlp_fwd(torch.from_numpy(emb),
                    K.cast_mlp_weights(_packed(model.coarse)))
    assert_bf16_close(out.numpy(), ref)


def test_cpu_tensor_takes_plain_version_without_launch(weights):
    _, model = weights
    mw = K.cast_mlp_weights(_packed(model.coarse))
    emb = torch.from_numpy(_emb(33))
    before = K.mlp_fwd.launches
    out = K.mlp_fwd(emb, mw)
    assert K.mlp_fwd.launches == before
    assert torch.equal(out, K.mlp_fwd_plain(emb, mw))


def test_mlp_fwd_rejects_bad_arguments(weights):
    _, model = weights
    mw = K.cast_mlp_weights(_packed(model.coarse))
    with pytest.raises(ValueError, match="emb must be"):
        K.mlp_fwd(torch.zeros(4, 63), mw)
    with pytest.raises(ValueError, match="packed weights"):
        K.mlp_fwd(torch.zeros(4, 64), mw[:-1])
    f32 = _packed(model.coarse)
    with pytest.raises(ValueError, match="bfloat16"):
        K.mlp_fwd(torch.zeros(4, 64), f32)


def test_macs_per_point():
    # 0.987 MFLOP per point: the figure PERF.md's bound is computed from
    assert K.MACS_PER_POINT == 493_568
