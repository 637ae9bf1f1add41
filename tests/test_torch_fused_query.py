"""The fused point-query entry points of the port, `fused_point_query` and
`fused_point_query_split`, against the JAX package's (CPU; the JAX side runs
its Pallas kernels in interpret mode, the port its kernels' plain versions).

- values, and the gradients with respect to every parameter (mapped onto the
  JAX tree by name), the points and the latents, within the tolerances of
  `ops/kernels/mlp_fwd.py`, `bend_fwd.py` and `mlp_bwd.py`;
- the split against the monolith: bit-equal in value and every gradient, as
  the JAX package holds its own two (tests/test_fused_kernel.py:397-419);
- the gradients against the port's own f32 modules (`BendingNetwork` and
  `NeRF`): within 6% of each gradient's max magnitude, the JAX package's
  bound (tests/test_fused_kernel.py:132-153);
- ray-shaped inputs, the identity at initialisation, `block`, the
  `ValueError`s outside the flagship architecture.
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
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.ops.embedding import fourier_embed
from nonrigid_nerf_torch.ops.kernels import bend_fwd as BF
from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.weights import params_from_jax, tree_from_named
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig()
N = 300          # a ragged count: the JAX kernels pad to 2 blocks of 256
BLOCK = 256
ENTRIES = {"monolith": FQ.fused_point_query,
           "split": FQ.fused_point_query_split}


def loss_of(raw, off, rig):
    """The JAX tests' loss (tests/test_fused_kernel.py:108-116)."""
    return (raw ** 2).mean() + 10 * (off ** 2).mean() + (rig ** 2).mean()


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, 3) * 1.5).astype(np.float32),
            (0.1 * rng.randn(n, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def case():
    """The parameters, the inputs, and the JAX entry points' values and
    gradients (interpret mode), computed once."""
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    pts, lat = _inputs(N, 5)
    orig = pl.pallas_call
    fq.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        def jloss(p, x, l):
            return loss_of(*fq.fused_point_query(p, x, l, block=BLOCK))

        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        values = {name: [np.asarray(v) for v in fn(
            jparams, jnp.asarray(pts), jnp.asarray(lat), block=BLOCK)]
            for name, fn in (("monolith", fq.fused_point_query),
                             ("split", fq.fused_point_query_split))}
        grads = jax.grad(jloss, argnums=(0, 1, 2))(
            jparams, jnp.asarray(pts), jnp.asarray(lat))
    finally:
        fq.pl.pallas_call = orig
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return dict(tree=tree, model=model, pts=pts, lat=lat, values=values,
                grads=grads)


def _port_grads(entry, model, pts_np, lat_np):
    pts = torch.from_numpy(pts_np).requires_grad_(True)
    lat = torch.from_numpy(lat_np).requires_grad_(True)
    out = entry(model, pts, lat)
    names = [n for n, p in model.named_parameters()
             if n.startswith(("coarse.", "bender."))]
    params = [dict(model.named_parameters())[n] for n in names]
    got = torch.autograd.grad(loss_of(*out), [pts, lat] + params)
    return out, got[0], got[1], dict(zip(names, got[2:]))


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_values_match_jax(case, entry):
    before = (FF.fused_fwd.launches, BF.bend_fwd.launches, K.mlp_fwd.launches)
    with torch.no_grad():
        raw, off, rig = ENTRIES[entry](case["model"], torch.from_numpy(case["pts"]),
                                       torch.from_numpy(case["lat"]))
    assert (FF.fused_fwd.launches, BF.bend_fwd.launches,
            K.mlp_fwd.launches) == before            # CPU tensors: no launch
    jraw, joff, jrig = case["values"][entry]
    assert raw.shape == (N, 4) and off.shape == (N, 3) and rig.shape == (N, 1)
    assert raw.dtype == off.dtype == rig.dtype == torch.float32
    err = np.abs(raw.numpy() - jraw)
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN
    assert np.abs(off.numpy() - joff).max() <= BF.BEND_TOL_OFF
    assert np.abs(rig.numpy() - jrig).max() <= BF.BEND_TOL_RIG
    # the JAX package's two entry points are bit-equal; so are the port's
    np.testing.assert_array_equal(case["values"]["split"][0],
                                  case["values"]["monolith"][0])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    return (np.abs(a - b).max() / scale,
            np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_gradients_match_jax(case, entry):
    """Every parameter's gradient on the JAX tree, leaf by leaf, within
    `grad_max_tol(n)` and `BWD_TOL_L2`; the points' and the latents' held as
    demb is (`BWD_TOL_DEMB_MAX`, `BWD_TOL_L2`)."""
    _, dpts, dlat, by_name = _port_grads(ENTRIES[entry], case["model"],
                                         case["pts"], case["lat"])
    jgrads, jpts, jlat = case["grads"]
    tree = tree_from_named(by_name)
    checked = 0
    for net in ("coarse", "bender"):
        flat = jax.tree_util.tree_flatten_with_path(tree[net])[0]
        jflat = dict(jax.tree_util.tree_flatten_with_path(jgrads[net])[0])
        assert len(flat) == len(jflat)
        for path, g in flat:
            max_rel, l2 = _rel(g, jflat[path])
            where = f"{net}{jax.tree_util.keystr(path)}"
            assert max_rel <= KB.grad_max_tol(N) and l2 <= KB.BWD_TOL_L2, \
                (where, max_rel, l2)
            checked += 1
    assert checked == 18 + 15            # the chain and head, the bender
    for got, want in ((dpts, jpts), (dlat, jlat)):
        max_rel, l2 = _rel(got.numpy(), want)
        assert max_rel <= KB.BWD_TOL_DEMB_MAX and l2 <= KB.BWD_TOL_L2


def test_split_equals_monolith_bit_for_bit(case):
    model, pts, lat = case["model"], case["pts"], case["lat"]
    a = _port_grads(FQ.fused_point_query, model, pts, lat)
    b = _port_grads(FQ.fused_point_query_split, model, pts, lat)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert a[3].keys() == b[3].keys() and len(a[3]) == 33
    for name in a[3]:
        assert torch.equal(a[3][name], b[3][name]), name


@pytest.fixture(scope="module")
def unshifted_model():
    """The JAX test's setup: parameters without the raised density bias.
    With it, the JAX kernel against the JAX package's own f32 path is off by
    15% of max on bend.0's gradient (the port by the same), so the 6% bound
    of that test holds for its setup only."""
    return params_from_jax(jax_params(CFG, density_shift=0.0), torch_cfg(CFG),
                           device="cpu")


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_gradients_match_the_f32_modules(unshifted_model, entry):
    """Against the port's own f32 path (BendingNetwork, then the NeRF on the
    encoding), on the JAX test's inputs and loss: 6% of each gradient's max
    magnitude, the bound of the JAX package's test of its kernels against its
    XLA path (tests/test_fused_kernel.py:132-153)."""
    rng = np.random.RandomState(4)
    pts_np = rng.randn(512, 3).astype(np.float32)
    lat_np = (0.1 * rng.randn(512, 32)).astype(np.float32)

    def f32_path(m, pts, lat):
        bent, det = m.bender(pts, lat)
        raw = m.coarse(fourier_embed(bent, 10))
        return raw, det["unmasked_offsets"], det["rigidity_mask"]

    def grads(fn):
        pts = torch.from_numpy(pts_np)
        lat = torch.from_numpy(lat_np)
        out = fn(unshifted_model, pts, lat)
        loss = sum((t ** 2).mean() for t in out)
        names = [n for n, _ in unshifted_model.named_parameters()
                 if n.startswith(("coarse.", "bender."))]
        params = dict(unshifted_model.named_parameters())
        return dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))

    got, want = grads(ENTRIES[entry]), grads(f32_path)
    assert len(got) == 33
    for name, g in got.items():
        scale = max(float(want[name].abs().max()), 1e-5)
        rel = float((g - want[name]).abs().max()) / scale
        assert rel < 0.06, (name, rel)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_ray_shaped_inputs_and_block(case, entry):
    model = case["model"]
    pts = torch.from_numpy(case["pts"][:128].reshape(8, 16, 3))
    lat = torch.from_numpy(case["lat"][:128].reshape(8, 16, 32))
    with torch.no_grad():
        raw, off, rig = ENTRIES[entry](model, pts, lat, block=128)
        flat = ENTRIES[entry](model, pts.reshape(-1, 3), lat.reshape(-1, 32))
    assert raw.shape == (8, 16, 4) and off.shape == (8, 16, 3)
    assert rig.shape == (8, 16, 1)
    for a, b in zip((raw, off, rig), flat):
        assert torch.equal(a.reshape(b.shape), b)


def test_identity_at_init():
    """A fresh model: the offsets' layer and the rigidity's head start at
    zero, so the offsets are exactly 0, the rigidity exactly 0.5 and raw is
    the canonical NeRF of the unbent points (tests/test_fused_kernel.py:69-83)."""
    cfg = t_config.ModelConfig()
    model = NRNeRF(cfg, num_timesteps=2, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    pts = torch.from_numpy(np.random.RandomState(1).randn(256, 3).astype(np.float32))
    lat = torch.ones(256, 32)
    with torch.no_grad():
        for entry in ENTRIES.values():
            raw, off, rig = entry(model, pts, lat)
            assert float(off.abs().max()) == 0.0
            assert bool((rig == 0.5).all())
            want = model.coarse(fourier_embed(pts, 10))
            np.testing.assert_allclose(raw.numpy(), want.numpy(), atol=3e-2)


@pytest.mark.parametrize("change", [
    dict(bending_activation="sin"), dict(bending_width=32),
    dict(use_rigidity_network=False), dict(ray_bending_latent_size=16),
    dict(use_viewdirs=True), dict(netwidth=128), dict(ray_bending=None),
    "multires"])
def test_outside_the_flagship_raises(change):
    cfg = t_config.ModelConfig()
    multires = 10
    if change == "multires":
        multires = 9
    else:
        cfg = dataclasses.replace(cfg, **change)
    model = NRNeRF(cfg, num_timesteps=1, device="cpu")
    pts, lat = torch.zeros(4, 3), torch.zeros(4, cfg.ray_bending_latent_size)
    for entry in ENTRIES.values():
        with pytest.raises(ValueError):
            entry(model, pts, lat, multires=multires)
    with pytest.raises(ValueError):
        FQ.pack_fused_weights(model, multires)


def test_bad_shapes_raise(case):
    model = case["model"]
    with pytest.raises(ValueError, match="latents"):
        FQ.fused_point_query(model, torch.zeros(4, 3), torch.zeros(5, 32))
    with pytest.raises(ValueError, match="pts must be"):
        FQ.fused_point_query_split(model, torch.zeros(4, 2), torch.zeros(4, 32))


def test_names_of_the_backward_outputs():
    assert FB.FUSED_BWD_NAMES[:2] == ("dpts", "dlat")
    assert FB.FUSED_BWD_NAMES[2:18] == tuple(
        n for n in ("b0p", "b0l", "b0b", "b1w", "b1b", "b2w", "b2b", "b3w",
                    "b3b", "bow", "r0w", "r0b", "r1w", "r1b", "row", "rob"))
    assert FB.FUSED_BWD_NAMES[18:] == KB.BWD_NAMES[1:]
