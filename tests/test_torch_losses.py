"""The port's training losses against `nonrigid_nerf_tpu/engine/losses.py`
on the same numpy inputs, values and gradients, in f32 and f64 (CPU).

Tolerances, relative to each array's max magnitude. Both sides run the same
formulas in the same dtype; sums run in another order.
- Formulas alone (schedule, safe_pow, offsets loss): f32 2e-5 (observed up
  to 3e-6), f64 1e-12 (observed up to 4e-15).
- Through the bender (divergence loss, total loss): f32 1e-4 (observed
  3.4e-5 on a one-element gradient), f64 2e-6 (observed 1.3e-7). The f64
  figure is the JAX package's: its dense layers accumulate in f32 whatever
  the inputs (`preferred_element_type=float32`, models/mlp.py:75), so its
  f64 mode rounds every layer's output to f32; the port's f64 is f64
  throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.engine import losses as t_losses
from nonrigid_nerf_torch.ops.math import safe_norm, safe_pow
from nonrigid_nerf_torch.weights import params_from_jax, tree_from_named
from nonrigid_nerf_tpu.config import ModelConfig, TrainConfig
from nonrigid_nerf_tpu.engine import losses as j_losses
from nonrigid_nerf_tpu.ops import math as j_math
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig(netwidth=32, netwidth_fine=32, bending_width=16,
                  rigidity_width=8, ray_bending_latent_size=8,
                  N_samples=8, N_importance=8, fused_kernel="off")
TC = TrainConfig(N_rand=6, N_iters=1000, offsets_loss_weight=60.0,
                 divergence_loss_weight=3.0, rigidity_loss_weight=5e-4)
TOL = {"float32": 2e-5, "float64": 1e-12}
TOL_BENDER = {"float32": 1e-4, "float64": 2e-6}
R, S = 6, 8


@pytest.fixture(params=["float32", "float64"])
def dtype(request):
    if request.param == "float64":
        with jax.enable_x64():
            yield request.param
    else:
        yield request.param


def assert_close(got, want, dtype, what="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert str(got.dtype) == dtype == str(want.dtype), what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol[dtype] * scale, what


def _render_out(dtype, zero_rows=True, rigidity=True, seed=0):
    rng = np.random.RandomState(seed)
    out = {"unmasked_offsets": (0.05 * rng.randn(R, S, 3)).astype(dtype),
           "visibility_weights": rng.uniform(0, 1, (R, S)).astype(dtype),
           "opacity_alpha": rng.uniform(-0.2, 1, (R, S)).astype(dtype),
           "initial_input_pts": rng.randn(R, S, 3).astype(dtype)}
    if zero_rows:       # a fresh bender gives exactly zero offsets
        out["unmasked_offsets"][:2] = 0.0
    if rigidity:
        out["rigidity_mask"] = rng.uniform(0, 1, (R, S, 1)).astype(dtype)
    return out


def _t(tree, requires_grad=()):
    return {k: torch.from_numpy(v.copy()).requires_grad_(k in requires_grad)
            for k, v in tree.items()}


@pytest.mark.parametrize("step", [0, 1, 499, 1000])
def test_loss_schedule_factor(dtype, step):
    got = t_losses.loss_schedule_factor(step, 1000, getattr(torch, dtype))
    want = j_losses.loss_schedule_factor(step, 1000, jnp.dtype(dtype))
    assert_close(got, want, dtype)
    if step == 1000:
        assert float(got) == 1.0


def test_safe_pow_and_safe_norm_are_finite_at_zero(dtype):
    base = np.array([0.0, 1e-12, 0.3, 2.0], dtype)
    expo = np.array([1.5, 1.0, 1.7, 2.0], dtype)
    tb = torch.from_numpy(base).requires_grad_(True)
    te = torch.from_numpy(expo).requires_grad_(True)
    val = safe_pow(tb, te)
    gb, ge = torch.autograd.grad(val.sum(), [tb, te])
    jval, (jgb, jge) = jax.value_and_grad(
        lambda b, e: jnp.sum(j_math.safe_pow(b, e)), argnums=(0, 1))(
            jnp.asarray(base), jnp.asarray(expo))
    assert torch.isfinite(gb).all() and torch.isfinite(ge).all()
    assert abs(float(ge[0])) < 1e-10       # the exponent's gradient at base 0
    assert_close(val.sum(), jval, dtype)
    assert_close(gb, jgb, dtype, "d base")
    assert_close(ge, jge, dtype, "d exponent")
    v = torch.zeros(3, 3, dtype=getattr(torch, dtype), requires_grad=True)
    (g,) = torch.autograd.grad(safe_norm(v).sum(), [v])
    assert g.abs().max() == 0.0


@pytest.mark.parametrize("rigidity", [True, False])
def test_offsets_and_rigidity_loss(dtype, rigidity):
    out = _render_out(dtype, rigidity=rigidity)
    wrt = ("unmasked_offsets", "rigidity_mask", "visibility_weights")
    wrt = tuple(k for k in wrt if k in out)
    t_out = _t(out, wrt)
    loss = t_losses.offsets_and_rigidity_loss(t_out, 5e-4)
    cot = np.random.RandomState(1).randn(R).astype(dtype)
    grads = torch.autograd.grad(loss, [t_out[k] for k in wrt],
                                torch.from_numpy(cot), allow_unused=True)

    def jf(sub):
        return j_losses.offsets_and_rigidity_loss({**out, **sub}, 5e-4)

    jloss, vjp = jax.vjp(jf, {k: jnp.asarray(out[k]) for k in wrt})
    (jgrads,) = vjp(jnp.asarray(cot))
    assert_close(loss, jloss, dtype)
    for k, g in zip(wrt, grads):
        if k == "visibility_weights":       # detached on both sides
            assert g is None and float(jnp.abs(jgrads[k]).max()) == 0.0
            continue
        assert torch.isfinite(g).all(), k
        assert_close(g, jgrads[k], dtype, k)


def _bender(dtype, zero_init=False):
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    tree = jax_params(CFG)
    if zero_init:
        for name in ("bend", "rigidity"):
            tree["bender"][name][-1]["w"][:] = 0.0
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    if dtype == "float64":
        model = model.double()
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    return cfg, model, jtree


@pytest.mark.parametrize("exact", [False, True], ids=["hutchinson", "exact"])
def test_divergence_loss_value_and_gradients(dtype, exact):
    """e^T J e as a forward-mode jvp inside the autograd graph: the value,
    and the gradients into the bender's parameters and the latents."""
    cfg, model, jtree = _bender(dtype)
    out = _render_out(dtype)
    rng = np.random.RandomState(2)
    lat = (0.1 * rng.randn(R, 8)).astype(dtype)
    e = rng.randn(R, S, 3).astype(dtype)
    cot = rng.randn(R).astype(dtype)

    t_lat = torch.from_numpy(lat).requires_grad_(True)
    loss = t_losses.divergence_loss(model, torch_cfg(CFG), _t(out), t_lat,
                                    exact=exact, e=torch.from_numpy(e))
    names = [n for n, _ in model.bender.named_parameters()]
    grads = torch.autograd.grad(
        loss, [t_lat] + list(model.bender.parameters()), torch.from_numpy(cot))

    def jf(bender, latents):
        if exact:
            return j_losses.divergence_loss(None, {"bender": bender}, cfg, out,
                                            latents, exact=True)
        # the probe the JAX function would draw from its key
        orig = jax.random.normal
        jax.random.normal = lambda key, shape, dt: jnp.asarray(e)
        try:
            return j_losses.divergence_loss(None, {"bender": bender}, cfg,
                                            out, latents)
        finally:
            jax.random.normal = orig

    jloss, vjp = jax.vjp(jf, jtree["bender"], jnp.asarray(lat))
    jg_bender, jg_lat = vjp(jnp.asarray(cot))
    assert float(loss.detach().abs().max()) > 0
    assert_close(loss, jloss, dtype, tol=TOL_BENDER)
    assert_close(grads[0], jg_lat, dtype, "latents", TOL_BENDER)
    got = tree_from_named({f"bender.{n}": g
                           for n, g in zip(names, grads[1:])})["bender"]
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jg_bender)):
        assert_close(a, b, dtype, jax.tree_util.keystr(path), TOL_BENDER)


def test_per_ray_losses_total_and_parts(dtype):
    cfg, model, jtree = _bender(dtype)
    out = _render_out(dtype)
    rng = np.random.RandomState(3)
    out["rgb_map"] = rng.uniform(0, 1, (R, 3)).astype(dtype)
    out["rgb0"] = rng.uniform(0, 1, (R, 3)).astype(dtype)
    target = rng.uniform(0, 1, (R, 3)).astype(dtype)
    lat = (0.1 * rng.randn(R, 8)).astype(dtype)
    e = rng.randn(R, S, 3).astype(dtype)
    tc = t_config.TrainConfig(**dataclasses.asdict(TC))

    loss, aux = t_losses.per_ray_losses(
        model, torch_cfg(CFG), tc, _t(out), torch.from_numpy(target),
        torch.from_numpy(lat), 250, e=torch.from_numpy(e))
    orig = jax.random.normal
    jax.random.normal = lambda key, shape, dt: jnp.asarray(e)
    try:
        jloss, jaux = j_losses.per_ray_losses(
            None, jtree, cfg, TC, out, jnp.asarray(target), jnp.asarray(lat),
            250)
    finally:
        jax.random.normal = orig
    assert set(aux) == set(jaux) == {"img_loss", "img_loss0", "offsets_loss",
                                     "divergence_loss"}
    assert_close(loss, jloss, dtype, "total", TOL_BENDER)
    for k in aux:
        assert_close(aux[k], jaux[k], dtype, k, TOL_BENDER)


def test_losses_at_a_fresh_bender_are_finite_with_zero_gradient(dtype):
    """Step 0: the zero-initialised output layers give zero offsets; the
    offsets loss and its gradient must be finite (a NaN here would poison
    Adam's moments for good)."""
    cfg, model, _ = _bender(dtype, zero_init=True)
    rng = np.random.RandomState(4)
    pts = torch.from_numpy(rng.randn(R, S, 3).astype(dtype))
    lat = torch.from_numpy((0.1 * rng.randn(R, 8)).astype(dtype))
    _, details = model.bender(pts, lat[:, None, :].expand(R, S, 8))
    out = {**details, **_t({k: v for k, v in _render_out(dtype).items()
                            if k in ("visibility_weights", "opacity_alpha",
                                     "initial_input_pts")})}
    assert float(details["unmasked_offsets"].abs().max()) == 0.0
    loss = (t_losses.offsets_and_rigidity_loss(out, 5e-4)
            + t_losses.divergence_loss(model, torch_cfg(CFG), out, lat,
                                       e=torch.ones(R, S, 3,
                                                    dtype=pts.dtype)))
    grads = torch.autograd.grad(loss.sum(), list(model.bender.parameters()),
                                allow_unused=True)
    assert torch.isfinite(loss).all()
    for g in grads:
        assert g is None or torch.isfinite(g).all()
