"""The deformation-field kernels of the port (`bend_fwd`, `bend_bwd`,
`fused_fwd`, `fused_bwd`: `_bend_core`, `_fused_core` and their backwards),
against the JAX package (CPU).

- `pack_fused_weights` of the port equals the JAX packing exactly.
- The plain versions of the two forwards against the pure-jnp math
  (`_bend_fwd_math`, `_forward_math`): raw within `mlp_fwd`'s bf16
  tolerances, offsets, rigidity and the encoding within the limits stated in
  `ops/kernels/bend_fwd.py`.
- The plain versions of the two backwards against the VJPs of `_bend_core`
  and `_fused_core` run in Pallas interpret mode, within the tolerances of
  `ops/kernels/mlp_bwd.py` (`agreement`), dpts and dlat held as demb is.
- On CPU tensors the wrappers are their plain versions and count no launch;
  `BendCore` maps its gradients onto the `nn.Linear` parameters.

The CUDA kernels themselves are held against the plain versions on the card
by `tests/test_torch_kernels_cuda.py`.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
from nonrigid_nerf_torch.ops.kernels import bend_fwd as BF
from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig()
BLOCK = 256
CSRC = (pathlib.Path(__file__).resolve().parent.parent / "nonrigid_nerf_torch"
        / "ops" / "kernels" / "csrc")


def _interpret(call):
    """Run `call()` with every pl.pallas_call of the JAX module in interpret
    mode (what the JAX package's own tests do on the CPU)."""
    orig = pl.pallas_call
    fq.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        return call()
    finally:
        fq.pl.pallas_call = orig


@pytest.fixture(scope="module")
def weights():
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    jw = fq.pack_fused_weights(tree)
    with torch.no_grad():
        tw = FQ.pack_fused_weights(model)
    return tree, model, jw, FF.cast_fused_weights(tw)


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, 3) * 1.5).astype(np.float32),
            (0.1 * rng.randn(n, 32)).astype(np.float32), rng)


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return jnp.asarray(out)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_pack_fused_weights_equals_jax(weights, network):
    tree, model, _, _ = weights
    jw = fq.pack_fused_weights(tree, 10, network)
    with torch.no_grad():
        tw = FQ.pack_fused_weights(model, 10, network)
    assert len(tw) == len(jw) == FF.N_FUSED_W == 37
    for i, (a, b) in enumerate(zip(jw, tw)):
        assert b.dtype == torch.float32 and b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"packed weight {i}")
        assert b.shape == (BF.expected_bend_shape(i) if i < 18
                           else K._expected_shape(i - 18))


def test_work_and_layout_constants():
    # the flat gradient layout the CUDA sources use (mlp_sm90.cuh): each
    # gradient's offset is the sum of the packed shapes before it
    header = (CSRC / "mlp_sm90.cuh").read_text()
    assert f"BEND_GRAD_FLOATS == {BB.BEND_GRAD_FLOATS}" in header
    names = ("B0P", "B0L", "B0B", "B1W", "B1B", "B2W", "B2B", "B3W", "B3B", "BOW",
             "R0W", "R0B", "R1W", "R1B", "ROW", "ROB")
    lines = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int G_(\w+) = ([^;]+);", header)}
    sizes = dict(BEND_W=64, LAT_W=32, RIG_W=32, BEND_WPAD=8)
    offset = 0
    for name, shape in zip(names, BB.BEND_GRAD_SHAPES):
        value = eval(lines[name], {}, {**sizes, **{f"G_{k}": v for k, v in
                                                   done.items()}}) if name != "B0P" else 0
        assert value == offset, name
        done = {**(done if name != "B0P" else {}), name: value}
        offset += shape.numel()
    assert offset == BB.BEND_GRAD_FLOATS
    assert BB.BEND_GRAD_FLOATS == 17224 and BB.N_BEND_GRADS == 16
    assert BF.BEND_MACS_PER_POINT == 15872
    assert FB.FUSED_BWD_MACS_PER_POINT == 3 * (493568 + 15872)
    assert len(FB.FUSED_BWD_NAMES) == 2 + 35


@pytest.fixture(scope="module")
def jax_forward(weights):
    """`_bend_fwd_math` and `_forward_math` (pure jnp) at two ragged sizes."""
    _, _, jw, _ = weights
    wj = fq._cast_matmul_weights(jw, f32_only=fq._P_PHASE_IDX)
    out = {}
    for n in (300, 700):
        pts, lat, _ = _inputs(n, n)
        pp = _pad(pts, n, fq.PTS_PAD)
        emb, off, rig, _ = fq._bend_fwd_math(pp, jnp.asarray(lat), list(wj[:18]))
        raw, off2, rig2 = fq._forward_math(pp, jnp.asarray(lat), list(wj))
        out[n] = {k: np.asarray(v) for k, v in dict(
            emb=emb, off=off, rig=rig, raw=raw, off2=off2, rig2=rig2).items()}
    return out


@pytest.mark.parametrize("n", [300, 700])
def test_bend_fwd_plain_matches_jax_math(weights, jax_forward, n):
    _, _, _, cw = weights
    ref = jax_forward[n]
    pts, lat, _ = _inputs(n, n)
    before = BF.bend_fwd.launches
    with torch.no_grad():
        emb, off, rig = BF.bend_fwd(_t(pts), _t(lat), cw[:18])
    assert BF.bend_fwd.launches == before          # a CPU tensor: no launch
    assert emb.shape == (n, 64) and off.shape == (n, 3) and rig.shape == (n, 1)
    # the JAX kernel pads: offsets' lanes 3..7 are 0, rigidity's 1..7 are 0.5
    assert np.abs(ref["off"][:, 3:]).max() == 0.0
    assert np.all(ref["rig"][:, 1:] == 0.5)
    stats = BF.bend_fwd_agreement(
        (emb, off, rig), (_t(ref["emb"]), _t(ref["off"][:, :3]),
                          _t(ref["rig"][:, :1])))
    assert stats["ok"], stats
    assert emb[:, 63].abs().max() == 0.0           # the pad lane


@pytest.mark.parametrize("n", [300, 700])
def test_fused_fwd_plain_matches_jax_math(weights, jax_forward, n):
    _, _, _, cw = weights
    ref = jax_forward[n]
    pts, lat, _ = _inputs(n, n)
    before = FF.fused_fwd.launches
    with torch.no_grad():
        raw, off, rig = FF.fused_fwd(_t(pts), _t(lat), cw)
        emb, off_b, rig_b = BF.bend_fwd_plain(_t(pts), _t(lat), cw[:18])
    assert FF.fused_fwd.launches == before
    err = np.abs(raw.numpy() - ref["raw"])
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN
    assert np.abs(raw.numpy()[:, 4:]).max() == 0.0
    # the monolith's plain version is the split's: bend_fwd, then mlp_fwd
    assert torch.equal(off, off_b) and torch.equal(rig, rig_b)
    assert torch.equal(raw, K.mlp_fwd_plain(emb, cw[18:]))
    np.testing.assert_array_equal(ref["off2"], ref["off"])


def _cotangents(rng, n, widths):
    return [(rng.randn(n, w) * s).astype(np.float32) for w, s in widths]


@pytest.mark.parametrize("n", [300, 512])
def test_bend_bwd_plain_matches_jax_vjp_interpret(weights, n):
    _, _, jw, cw = weights
    pts, lat, rng = _inputs(n, n + 7)
    demb, doff, drig = _cotangents(rng, n, ((64, 0.1), (3, 1.0), (1, 1.0)))
    n_pad = -(-n // BLOCK) * BLOCK

    def jax_vjp():
        _, vjp = jax.vjp(lambda p, l, w: fq._bend_core(p, l, w, BLOCK),
                         _pad(pts, n_pad, 8), _pad(lat, n_pad, 32), jw[:18])
        return vjp((_pad(demb, n_pad, 64), _pad(doff, n_pad, 8),
                    _pad(drig, n_pad, 8)))

    jd = _interpret(jax_vjp)
    assert np.abs(np.asarray(jd[0])[:, 3:]).max() == 0.0
    assert all(np.abs(np.asarray(g)).max() == 0.0 for g in jd[2][16:])
    with torch.no_grad():
        before = BB.bend_bwd.launches
        got = BB.bend_bwd(_t(pts), _t(lat), cw[:18], _t(demb), _t(doff),
                          _t(drig))
    assert BB.bend_bwd.launches == before
    assert got[0].shape == (n, 3) and got[1].shape == (n, 32)
    for g, shape in zip(got[2], BB.BEND_GRAD_SHAPES):
        assert g.shape == shape and g.dtype == torch.float32
    ref = (_t(np.asarray(jd[0])[:n, :3]), _t(np.asarray(jd[1])[:n]),
           [_t(g) for g in jd[2][:16]])
    stats = BB.bend_bwd_agreement(got, ref)
    assert stats["ok"], stats


@pytest.mark.parametrize("n", [200, 300])
def test_fused_bwd_plain_matches_jax_vjp_interpret(weights, n):
    """A ragged n below 512. The encoding that enters the chain differs from
    the JAX one by a bf16 ulp in a few lanes (the bender's sums in another
    order, amplified by the sines), which flips an occasional ReLU gate of
    the chain: within `grad_max_tol(n)` at these sizes."""
    _, _, jw, cw = weights
    pts, lat, rng = _inputs(n, n + 1)
    draw, doff, drig = _cotangents(rng, n, ((8, 1.0), (3, 1.0), (1, 1.0)))
    n_pad = -(-n // BLOCK) * BLOCK

    def jax_vjp():
        _, vjp = jax.vjp(lambda p, l, w: fq._fused_core(p, l, w, BLOCK),
                         _pad(pts, n_pad, 8), _pad(lat, n_pad, 32), jw)
        return vjp((_pad(draw, n_pad, 8), _pad(doff, n_pad, 8),
                    _pad(drig, n_pad, 8)))

    jd = _interpret(jax_vjp)
    with torch.no_grad():
        before = FB.fused_bwd.launches
        got = FB.fused_bwd(_t(pts), _t(lat), cw, _t(draw), _t(doff), _t(drig))
    assert FB.fused_bwd.launches == before
    assert len(got[2]) == 35
    ref = (_t(np.asarray(jd[0])[:n, :3]), _t(np.asarray(jd[1])[:n]),
           [_t(g) for i, g in enumerate(jd[2]) if i not in (16, 17)])
    stats = FB.fused_bwd_agreement(got, ref)
    assert stats["ok"], stats
    # the monolith's plain backward is the split's: mlp_bwd, then bend_bwd
    with torch.no_grad():
        emb, _, _ = BF.bend_fwd_plain(_t(pts), _t(lat), cw[:18])
        demb, mgrads = FB.KB.mlp_bwd_plain(emb.to(torch.bfloat16), cw[18:],
                                           _t(draw))
        split = BB.bend_bwd_plain(_t(pts), _t(lat), cw[:18], demb, _t(doff),
                                  _t(drig))
    assert torch.equal(got[0], split[0]) and torch.equal(got[1], split[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], split[2] + mgrads))


def test_bend_core_on_the_cpu_maps_gradients_to_the_parameters(weights):
    """BendCore's gradients are bend_bwd_plain's, carried back through the
    packing onto the nn.Linear parameters; an output without a cotangent
    counts as zero; nothing for P and the phase; two backwards over one
    graph (the saved tensors are read, not consumed)."""
    _, model, _, _ = weights
    bender = model.bender
    pts_np, lat_np, rng = _inputs(200, 3)
    pts = _t(pts_np).requires_grad_(True)
    lat = _t(lat_np).requires_grad_(True)
    packed = BF.pack_bend_weights(bender)
    assert not packed[16].requires_grad and not packed[17].requires_grad
    emb, off, rig = BB.BendCore.apply(pts, lat, *packed)
    cw = BF.cast_bend_weights([p.detach() for p in packed])
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(
            (emb, off, rig), BF.bend_fwd_plain(pts.detach(), lat.detach(), cw)))
    params = list(bender.parameters())
    names = [name for name, _ in bender.named_parameters()]
    demb = _t(0.1 * rng.randn(200, 64))
    doff = _t(rng.randn(200, 3))
    for outputs, cots in (((emb, off, rig), (demb, doff, _t(rng.randn(200, 1)))),
                          ((emb, off), (demb, doff))):
        got = torch.autograd.grad(outputs, [pts, lat] + params, cots,
                                  retain_graph=True)
        drig = cots[2] if len(cots) == 3 else torch.zeros(200, 1)
        with torch.no_grad():
            dpts, dlat, grads = BB.bend_bwd_plain(pts.detach(), lat.detach(),
                                                  cw, demb, doff, drig)
        assert torch.equal(got[0], dpts) and torch.equal(got[1], dlat)
        by_name = dict(zip(names, got[2:]))
        assert torch.equal(by_name["bend.0.weight"],
                           torch.cat([grads[0][:3], grads[1]], 0).t())
        assert torch.equal(by_name["bend.4.weight"], grads[9][:, :3].t())
        assert torch.equal(by_name["rigidity.0.weight"], grads[10][:3].t())
        assert torch.equal(by_name["rigidity.2.bias"], grads[15][0, :1])
    assert len(got) == 2 + 15              # 9 weights, 6 biases


def test_wrappers_reject_bad_arguments_and_take_zero_points(weights):
    _, _, _, cw = weights
    z3, z32 = torch.zeros(4, 3), torch.zeros(4, 32)
    with pytest.raises(ValueError, match="pts must be"):
        BF.bend_fwd(torch.zeros(4, 8), z32, cw[:18])
    with pytest.raises(ValueError, match="lat must be"):
        BF.bend_fwd(z3, torch.zeros(5, 32), cw[:18])
    with pytest.raises(ValueError, match="bender weights"):
        BF.bend_fwd(z3, z32, cw[:17])
    with pytest.raises(ValueError, match="packed bender weight 0"):
        BF.bend_fwd(z3, z32, (cw[0].float(),) + cw[1:18])
    with pytest.raises(ValueError, match="packed weights"):
        FF.fused_fwd(z3, z32, cw[:36])
    with pytest.raises(ValueError, match="demb must be"):
        BB.bend_bwd(z3, z32, cw[:18], torch.zeros(4, 63), z3, torch.zeros(4, 1))
    with pytest.raises(ValueError, match="draw must be"):
        FB.fused_bwd(z3, z32, cw, torch.zeros(4, 4), z3, torch.zeros(4, 1))
    e3, e32 = torch.zeros(0, 3), torch.zeros(0, 32)
    emb, off, rig = BF.bend_fwd(e3, e32, cw[:18])
    assert emb.shape == (0, 64) and off.shape == (0, 3) and rig.shape == (0, 1)
    dpts, dlat, grads = FB.fused_bwd(e3, e32, cw, torch.zeros(0, 8), e3,
                                     torch.zeros(0, 1))
    assert dpts.shape == (0, 3) and dlat.shape == (0, 32) and len(grads) == 35
    assert all(float(g.abs().max()) == 0.0 for g in grads)
