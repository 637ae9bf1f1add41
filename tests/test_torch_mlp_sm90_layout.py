"""The Python mirror of the Hopper chain's layouts (`ops/kernels/mlp_sm90.py`,
mirroring `ops/kernels/csrc/mlp_sm90.cuh`) on the CPU.

- The swizzled tile layout (`tile_offset`) is a permutation that keeps each
  row's 16-byte pieces inside its own 128 bytes.
- The chunk schedules read every 64-row chunk of every chain matrix once, in
  the kernels' order, at 64 and 128 lanes.
- Packing the weight image and unpacking it returns every weight.
- A chain that reads its weights out of the image chunk by chunk in the
  kernels' order, on 128-point tiles with a ragged last tile, equals the JAX
  math: `_mlp_fwd_math` for the forward and `_mlp_bwd_math` for the
  backward, within the bf16 tolerances of `ops/kernels/mlp_fwd.py` and
  `ops/kernels/mlp_bwd.py`.

The CUDA kernels that read this image are held against their plain versions
on the card by `tests/test_torch_kernels_cuda.py`.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels import mlp_sm90 as S
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig()
CFG_TC = dataclasses.replace(CFG, ray_bending=None,
                             time_conditioned_baseline=True)
IN_CH = {64: 63, 128: 63 + 32}
HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nonrigid_nerf_torch", "ops", "kernels", "csrc",
    "mlp_sm90.cuh")


@pytest.fixture(scope="module")
def trees():
    return {64: jax_params(CFG), 128: jax_params(CFG_TC)}


def _weights(trees, e, network="coarse"):
    """The JAX package's cast packing and the port's, of one network."""
    tree = trees[e]
    cfg = CFG if e == 64 else CFG_TC
    jc = fq._cast_matmul_weights(fq.pack_mlp_weights(tree, network,
                                                     in_ch=IN_CH[e]))
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    with torch.no_grad():
        tc = K.cast_mlp_weights(K.pack_mlp_weights(model.network(network)))
    return jc, tc


def _random_weights(e, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return K.cast_mlp_weights([torch.randn(K._expected_shape(i, e),
                                           generator=gen)
                               for i in range(K.N_MLP_W)])


def _emb(e, n, seed):
    rng = np.random.RandomState(seed)
    emb = np.zeros((n, e), np.float32)
    emb[:, :63] = rng.uniform(-1, 1, (n, 63))
    if e == 128:
        emb[:, 63:IN_CH[e]] = 0.3 * rng.randn(n, 32)
    return emb


_BIASES = (1, 3, 5, 7, 9, 12, 14, 16)   # n0b .. n4b, n5b, n6b, n7b


@pytest.mark.parametrize("cols", [64, 128, 256])
def test_tile_offset_permutes_each_row_within_its_128_bytes(cols):
    r = np.arange(S.TM)[:, None]
    c = np.arange(cols)[None, :]
    off = S.tile_offset(r, c)
    assert sorted(off.ravel()) == list(range(S.TM * cols))
    # each 64-lane atom row stays at its row's 64 elements, pieces move whole
    atom_row = (c // 64) * S.TILE_ATOM_ELEMS + r * 64
    assert np.all((off >= atom_row) & (off < atom_row + 64))
    assert np.all(off % 8 == c % 8)
    # the 128-byte swizzle: piece q of row r sits at piece q ^ (r % 8)
    assert S.tile_offset(1, 0) == 64 + 8 and S.tile_offset(9, 8) == 9 * 64
    assert S.tile_offset(3, 64 + 16) == S.TILE_ATOM_ELEMS + 3 * 64 + (2 ^ 3) * 8


def test_swizzle_tile_places_every_element_at_tile_offset():
    x = torch.arange(S.TM * 128, dtype=torch.float32).reshape(S.TM, 128)
    flat = S.swizzle_tile(x)
    r, c = 77, 93
    assert flat[S.tile_offset(r, c)] == x[r, c]
    rows = flat[:S.TILE_ATOM_ELEMS].reshape(S.TM, 64)
    assert torch.equal(S._unswizzle(rows), x[:, :64])


@pytest.mark.parametrize("e", [64, 128])
def test_schedules_read_every_chunk_once_in_the_kernels_order(e):
    fwd, bwd = S.fwd_schedule(e), S.bwd_schedule(e)
    assert len(fwd) == len(bwd) == {64: 30, 128: 32}[e]
    rows = [e if m in (0, 5) else S.NW for m in range(9)]
    expected = sorted((m, c) for m in range(9) for c in range(rows[m] // 64))
    assert sorted(fwd) == expected and sorted(bwd) == expected
    # the forward: layer 0 on n0w, layers 1-4, the skip's n5h then n5e,
    # layers 6 and 7, each chunk in row order
    fwd_mats = [m for m, _ in fwd]
    assert fwd_mats == ([0] * (e // 64) + [1] * 4 + [2] * 4 + [3] * 4
                        + [4] * 4 + [6] * 4 + [5] * (e // 64) + [7] * 4
                        + [8] * 4)
    # the backward: the dh chain's steps n7w n6w n5e n5h n4w n3w n2w n1w n0w
    bwd_mats = [m for m, _ in bwd]
    assert bwd_mats == ([8] * 4 + [7] * 4 + [5] * (e // 64) + [6] * 4
                        + [4] * 4 + [3] * 4 + [2] * 4 + [1] * 4
                        + [0] * (e // 64))
    for sched in (fwd, bwd):
        for (m0, c0), (m1, c1) in zip(sched, sched[1:]):
            assert m0 != m1 or c1 == c0 + 1


@pytest.mark.parametrize("parts", [("fwd",), ("fwd", "bwd")])
@pytest.mark.parametrize("e", [64, 128])
def test_pack_then_unpack_returns_every_weight(e, parts):
    mw = _random_weights(e, seed=e)
    image = S.pack_chain_image(mw, parts)
    n_chunks = sum(len(S.fwd_schedule(e) if p == "fwd" else S.bwd_schedule(e))
                   for p in parts)
    assert image.dtype == torch.bfloat16
    assert image.shape == (n_chunks * S.CHUNK_ELEMS,)
    back = S.unpack_chain_image(image, e, parts)
    for got, want in zip(back, S.chain_matrices(mw)):
        assert torch.equal(got, want)
    # both parts of the backward's image hold every weight, each once
    if parts == ("fwd", "bwd"):
        half = len(S.fwd_schedule(e)) * S.CHUNK_ELEMS
        assert torch.equal(image[:half].sort().values,
                           image[half:].sort().values)


@pytest.mark.parametrize("e", [64, 128])
def test_image_chunks_hold_the_scheduled_weight_rows(e):
    mw = _random_weights(e, seed=1)
    mats = S.chain_matrices(mw)
    image = S.pack_chain_image(mw, ("fwd", "bwd")).view(-1, S.CHUNK_ELEMS)
    sched = ([(S.fwd_chunk_matrix, m, c) for m, c in S.fwd_schedule(e)]
             + [(S.bwd_chunk_matrix, m, c) for m, c in S.bwd_schedule(e)])
    assert image.shape[0] == len(sched)
    for chunk, (unpack, m, c) in zip(image, sched):
        assert torch.equal(unpack(chunk), mats[m][c * 64:(c + 1) * 64])
    # a forward chunk is W^T in the swizzled layout: element (n, k) of the
    # first chunk holds n0w[k, n]
    first = image[0]
    assert first[S.tile_offset(5, 17) % (S.NW * 64)] == mats[0][17, 5]


@pytest.mark.parametrize("e", [64, 128])
def test_chain_from_image_matches_jax_math(trees, e):
    jc, tc = _weights(trees, e)
    n = 300                       # two whole tiles and a ragged one
    emb = _emb(e, n, 3)
    ref = np.asarray(fq._mlp_fwd_math(jnp.asarray(emb), jc))
    image = S.pack_chain_image(tc, ("fwd",))
    nh = S.chain_from_image(torch.from_numpy(emb), image,
                            [tc[i] for i in _BIASES])
    assert len(nh) == 8 and all(h.shape == (n, 256) for h in nh)
    raw = K.mm_bf16(nh[-1], tc[17]) + tc[18]
    err = np.abs(raw.numpy() - ref)
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN
    # the same chain as the plain version's, up to bf16 rounding flips
    # (chunk-wise f32 sums in another order; they compound down the chain:
    # about 0.1% of the entries of nh8 here)
    plain = K.chain_plain(torch.from_numpy(emb).to(torch.bfloat16), tc)
    for a, b in zip(nh, plain):
        assert (a != b).float().mean().item() < 1e-2


@pytest.mark.parametrize("e", [64, 128])
def test_dh_chain_from_image_matches_jax_bwd_math(trees, e):
    jc, tc = _weights(trees, e, "fine")
    n = 300
    emb = _emb(e, n, 4)
    draw = np.random.RandomState(5).randn(n, 8).astype(np.float32)
    embb = torch.from_numpy(emb).to(torch.bfloat16)
    demb_j, grads_j = fq._mlp_bwd_math(jnp.asarray(emb).astype(jnp.bfloat16),
                                       jc, jnp.asarray(draw))
    image = S.pack_chain_image(tc, ("fwd", "bwd"))
    nh = S.chain_from_image(embb, image, [tc[i] for i in _BIASES])
    drawt = torch.from_numpy(draw)
    drawb = drawt.to(torch.bfloat16)
    dh8 = KB.masked(KB.mm_nt(drawb, tc[17]), nh[7])
    demb, dh = S.dh_chain_from_image(nh, dh8, image, e)
    assert demb.shape == (n, e) and len(dh) == 8 and torch.equal(dh[7], dh8)
    # the second pass's products from the scratch the chain kernel writes
    acts = [embb] + nh[:7]
    grads = []
    for l in range(8):
        if l == 5:
            grads += [KB.mm_tn(embb, dh[5]), KB.mm_tn(nh[4], dh[5]),
                      KB.bsum(dh[5])]
        else:
            grads += [KB.mm_tn(acts[l], dh[l]), KB.bsum(dh[l])]
    grads += [KB.mm_tn(nh[7], drawb), KB.bsum(drawt)]
    ref = (torch.from_numpy(np.array(demb_j, np.float32)),
           [torch.from_numpy(np.array(g, np.float32)) for g in grads_j])
    stats = KB.bwd_agreement((demb, grads), ref)
    assert stats["ok"], stats


def test_header_budgets_fit_one_hopper_cta():
    """The stage counts and sizes in the header leave each kernel within a
    CTA's 232,448 bytes of shared memory at both widths."""
    with open(HEADER) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    fwd, bwd = const("FWD_STAGES"), const("BWD_STAGES")
    chunk, act, align, bars = 64 * 256 * 2, 128 * 256 * 2, 1024, 128
    for e in (64, 128):
        emb_tile = 128 * e * 2
        assert align + act + emb_tile + fwd * chunk + bars <= 232448
        assert emb_tile <= act
    assert align + 2 * act + bwd * chunk + bars <= 232448
    assert fwd >= 3 and bwd >= 3
