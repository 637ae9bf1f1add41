"""The `_mlpv_core` forward kernel module of the port against the JAX one.

On the CPU the kernel's plain version `mlpv_fwd_plain` is held against the
Pallas kernel's math `_mlpv_fwd_math` and against `_mlpv_core` run in Pallas
interpret mode, with `mlp_fwd`'s bf16 tolerance `BF16_TOL_MAX` /
`BF16_TOL_MEAN` (f32 sums in another order flip an occasional bf16 rounding
between layers; observed here: max 1.2e-7, mean 1e-10). The four heads of
the f32 `NeRF` module are held against `nerf_mlp_apply` at 1e-5 (observed
1.2e-7). The CUDA kernel itself is held against the plain version on the
card by `tests/test_torch_kernels_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.models.nerf import NeRF
from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as K
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig
from nonrigid_nerf_tpu.models.nerf import nerf_mlp_apply
from tests.torch_parity import jax_params, torch_cfg


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


def _packed(net):
    """The packed weights as plain values: `pack_viewdirs_mlp_weights` is
    differentiable (training sends gradients through it), these tests
    compare values."""
    with torch.no_grad():
        return K.pack_viewdirs_mlp_weights(net)


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    emb = rng.uniform(-1, 1, (n, 64)).astype(np.float32)
    emb[:, 63] = 0.0          # the pad lane
    embv = rng.uniform(-1, 1, (n, 32)).astype(np.float32)
    embv[:, 27:] = 0.0        # the pad lanes
    return emb, embv


def assert_bf16_close(out, ref):
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert err.max() <= K.BF16_TOL_MAX, err.max()
    assert err.mean() <= K.BF16_TOL_MEAN, err.mean()


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_pack_viewdirs_mlp_weights_equals_jax(weights, network):
    tree, model = weights
    jp = fq.pack_viewdirs_mlp_weights(tree, network)
    tp = _packed(model.network(network))
    assert len(tp) == K.N_MLPV_W == fq.N_MLPV_W == len(jp)
    assert (K.VEMB, K.VW) == (fq.VEMB, fq.VW)
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert b.dtype == torch.float32 and b.shape == K._expected_shape(i)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # rgb in lanes 0:3, alpha in lane 3, the other lanes zero
    assert tp[19][:, [0, 1, 2, 4, 5, 6, 7]].abs().max() == 0
    assert tp[24][:, 3:].abs().max() == 0 and tp[22][27:].abs().max() == 0


def test_cast_mlpv_weights_equals_jax(weights):
    tree, model = weights
    jc = fq._cast_matmul_weights(fq.pack_viewdirs_mlp_weights(tree))
    tc = K.cast_mlpv_weights(_packed(model.coarse))
    for a, b in zip(jc, tc):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      b.float().numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_math(weights, seed):
    tree, model = weights
    jc = fq._cast_matmul_weights(fq.pack_viewdirs_mlp_weights(tree))
    tc = K.cast_mlpv_weights(_packed(model.coarse))
    emb, embv = _inputs(700, seed)
    ref = fq._mlpv_fwd_math(jnp.asarray(emb), jnp.asarray(embv), jc)
    out = K.mlpv_fwd_plain(torch.from_numpy(emb), torch.from_numpy(embv), tc)
    assert out.shape == (700, 8) and out.dtype == torch.float32
    assert_bf16_close(out.numpy(), ref)
    assert float(out[:, 4:].abs().max()) == 0.0     # the unused lanes


def test_plain_matches_pallas_interpret(weights, interpret_pallas):
    tree, model = weights
    emb, embv = _inputs(700, 2)
    block = 256
    pad = ((0, -700 % block), (0, 0))
    ref = np.asarray(fq._mlpv_core(
        jnp.asarray(np.pad(emb, pad)), jnp.asarray(np.pad(embv, pad)),
        fq.pack_viewdirs_mlp_weights(tree, "fine"), block))[:700]
    out = K.mlpv_fwd(torch.from_numpy(emb), torch.from_numpy(embv),
                     K.cast_mlpv_weights(_packed(model.fine)))
    assert_bf16_close(out.numpy(), ref)


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_nerf_heads_match_nerf_mlp_apply(weights, network):
    """The f32 module: alpha, feature (no activation), views[0], rgb."""
    tree, model = weights
    emb, embv = _inputs(50, 3)
    ref = nerf_mlp_apply(tree[network], CFG, jnp.asarray(emb[:, :63]),
                         jnp.asarray(embv[:, :27]))
    net = model.network(network)
    with torch.no_grad():
        out = net(torch.from_numpy(emb[:, :63]), torch.from_numpy(embv[:, :27]))
    assert out.shape == (50, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert [n for n, _ in net.named_parameters()][-8:] == [
        "feature.weight", "feature.bias", "alpha.weight", "alpha.bias",
        "views.0.weight", "views.0.bias", "rgb.weight", "rgb.bias"]
    with pytest.raises(ValueError, match="embedded_views"):
        net(torch.from_numpy(emb[:, :63]))


def test_plain_is_close_to_the_f32_module(weights):
    """bf16 inside the MLP against f32: the JAX package's own bound for this
    pair (tests/test_fused_kernel.py:305-310) is 3e-2 absolute."""
    _, model = weights
    emb, embv = _inputs(200, 4)
    with torch.no_grad():
        ref = model.coarse(torch.from_numpy(emb[:, :63]),
                           torch.from_numpy(embv[:, :27]))
    out = K.mlpv_fwd_plain(torch.from_numpy(emb), torch.from_numpy(embv),
                           K.cast_mlpv_weights(_packed(model.coarse)))
    np.testing.assert_allclose(out[:, :4].numpy(), ref.numpy(), atol=3e-2)


def test_cpu_tensor_takes_plain_version_without_launch(weights):
    _, model = weights
    mw = K.cast_mlpv_weights(_packed(model.coarse))
    emb, embv = (torch.from_numpy(a) for a in _inputs(33))
    before = K.mlpv_fwd.launches
    out = K.mlpv_fwd(emb, embv, mw)
    assert K.mlpv_fwd.launches == before
    assert torch.equal(out, K.mlpv_fwd_plain(emb, embv, mw))


def test_mlpv_fwd_rejects_bad_arguments(weights):
    _, model = weights
    mw = K.cast_mlpv_weights(_packed(model.coarse))
    with pytest.raises(ValueError, match="emb must be"):
        K.mlpv_fwd(torch.zeros(4, 63), torch.zeros(4, 32), mw)
    with pytest.raises(ValueError, match="embv must be"):
        K.mlpv_fwd(torch.zeros(4, 64), torch.zeros(4, 27), mw)
    with pytest.raises(ValueError, match="embv must be"):
        K.mlpv_fwd(torch.zeros(4, 64), torch.zeros(5, 32), mw)
    with pytest.raises(ValueError, match="packed weights"):
        K.mlpv_fwd(torch.zeros(4, 64), torch.zeros(4, 32), mw[:-1])
    with pytest.raises(ValueError, match="bfloat16"):
        K.mlpv_fwd(torch.zeros(4, 64), torch.zeros(4, 32),
                   _packed(model.coarse))


def test_pack_refuses_another_view_encoding():
    cfg = t_config.ModelConfig(use_viewdirs=True, multires_views=3)
    net = NeRF(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="27-channel"):
        K.pack_viewdirs_mlp_weights(net)


def test_macs_per_point():
    # 1.194 MFLOP per point: the figure PERF.md's bound is computed from
    assert K.MACS_PER_POINT == 596_992
