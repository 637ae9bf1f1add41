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
- `mlpv_bwd`'s image (the chain and the view-direction heads, 78 chunks):
  its schedule reads every chunk once, packing and unpacking returns every
  weight, and a reader of the whole backward from the image in the kernel's
  order (recompute, heads, dhv, dfeat, dembv, the dh chain, the second
  pass) equals `jax.vjp` of `_mlpv_core` in Pallas interpret mode.
- `mlpv_fwd`'s image, the forward-only part (the first 39 chunks), and a
  reader of the forward from it in the kernel's order (chain, alpha from
  nh8, feat, hv over vwf then vwv, rgb), against `_mlpv_fwd_math` and the
  Pallas kernel in interpret mode.
- The in-kernel encoding of `mlpe_fwd` and `mlpe_bwd` (one device
  function), written into the swizzled tile by the threads that own its
  rows, through the forward's chain from the image, against
  `_mlpe_pallas_fwd` in interpret mode; and `mlpe_bwd`'s fold of demb onto
  the points in the order the threads sum, against `_embed_ew` and
  `jax.vjp` of `_mlpe_core`.

The CUDA kernels that read this image are held against their plain versions
on the card by `tests/test_torch_kernels_cuda.py`.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels import mlp_sm90 as S
from nonrigid_nerf_torch.ops.kernels import mlpe_bwd as KEB
from nonrigid_nerf_torch.ops.kernels import mlpe_fwd as KE
from nonrigid_nerf_torch.ops.kernels import mlpv_bwd as KVB
from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as KV
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig()
CFG_TC = dataclasses.replace(CFG, ray_bending=None,
                             time_conditioned_baseline=True)
CFG_V = dataclasses.replace(CFG, use_viewdirs=True)
BLOCK = 256                    # the JAX kernels' block in interpret mode
IN_CH = {64: 63, 128: 63 + 32}
HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nonrigid_nerf_torch", "ops", "kernels", "csrc",
    "mlp_sm90.cuh")


@pytest.fixture(scope="module")
def trees():
    return {64: jax_params(CFG), 128: jax_params(CFG_TC)}


@pytest.fixture(scope="module")
def views_tree():
    return jax_params(CFG_V)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


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
    CTA's 232,448 bytes of shared memory at both widths: the forward (row 1;
    row 5 with two encoding tiles), the view-direction forward (row 3: the
    activation tile, emb's and embv's k-atoms, the ring, the barriers), the
    backward's chain kernels (rows 2, 4 and 6 share one plan: two tiles,
    the ring, the barriers), two dW CTAs on an SM; the view layer's chunks
    fit a ring stage, and the dW kernel's job list holds row 4's 39 jobs."""
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
    # rows 3 and 5: two k-atoms beside the activation tile (emb and embv;
    # the double-buffered encoding), 197,760 B each
    atom = 128 * 64 * 2
    two_atoms = align + act + 2 * atom + fwd * chunk + bars
    assert two_atoms == 197760 <= 232448
    assert "fwd_smem_bytes<64, 2> <= SMEM_LIMIT" in src
    # row 1 on points at 128 lanes: two 128-lane encoding tiles fit beside
    # a 3-stage ring (1,024 + 65,536 + 2 x 32,768 + 3 x 32,768 + 128, the
    # backward's own figure), and the kernel runs a 2-stage ring (197,760 B)
    # so that the SM keeps 60 KB of L1
    two_tiles_128 = align + act + 2 * (2 * atom) + fwd * chunk + bars
    assert two_tiles_128 == 230528 <= 232448
    assert two_tiles_128 == align + 2 * act + bwd * chunk + bars
    assert two_tiles_128 - chunk == 197760
    assert "fwd_smem_bytes<128, 2> == 230528" in src
    assert "fwd_smem_bytes<128, 2, 2> == 197760" in src
    assert re.search(r"struct FwdPlan<PointsFwdIn<128>> \{\n  static constexpr "
                     r"int STAGES = 2;", src)
    # row 3 on points: emb and embv double-buffered (four k-atoms) beside a
    # 2-stage ring, the encoding input's size; one embv atom beside a
    # 3-stage ring (the plan measured and left) would take 214,144 B
    assert align + act + 4 * atom + 2 * chunk + bars == 197760
    assert align + act + 3 * atom + fwd * chunk + bars == 214144
    # the ring's full and empty barriers and the forward input's four (row
    # 3's points input: eight)
    assert 2 * 8 * max(fwd, bwd) + 4 * 8 <= bars
    assert 2 * 8 * fwd + 8 * 8 <= bars
    assert align + 2 * act + bwd * chunk + bars <= 232448
    assert fwd >= 3 and bwd >= 3
    # row 4's encodings (64 + 32 lanes, padded) share the second tile
    assert 2 * 128 * 64 * 2 <= act
    box = 64 * 64 * 2
    dw = align + const("DW_STAGES") * (box + 4 * box) + bars
    assert 2 * dw <= 232448
    assert const("MAX_DW_JOBS") >= 30 + 2 * 4 + 1
    sizes = S.views_chunk_bytes()
    assert len(sizes) == 78 and max(sizes) == chunk
    assert all(b % 1024 == 0 for b in sizes)
    assert "static_assert(V_FWD_CHUNKS == 39 && V_CHUNKS == 78" in src
    # the kernels that run these plans launch with them
    csrc = os.path.dirname(HEADER)
    for name, budget in (("mlpv_fwd.cu", "SMEM_BYTES = fwd_smem_bytes<EMB, 2>;"),
                         ("mlpv_fwd.cu",
                          "POINTS_SMEM_BYTES = fwd_smem_bytes<EMB, 4, 2>;"),
                         ("mlpe_fwd.cu", "launch_fwd<sm90::EMB>"),
                         ("mlp_fwd.cu", "launch_fwd<E>")):
        with open(os.path.join(csrc, name)) as f:
            assert budget in f.read(), name
    assert ("constexpr size_t smem =\n      fwd_smem_bytes<E, In::FWD_TILES, "
            "FwdPlan<In>::STAGES> + FwdPlan<In>::EXTRA_BYTES;") in src
    assert "static constexpr int FWD_TILES = 2;" in src    # PtsFwdIn
    # row 1's points input runs the same plan on its two tiles
    assert "struct PointsFwdIn {" in src
    with open(os.path.join(csrc, "mlp_fwd.cu")) as f:
        assert "const PointsFwdIn<E> in{" in f.read()


# ---- row 4: mlpv_bwd's image and its backward read from it


def _views_weights(tree, network="fine"):
    """The JAX package's packing of the view-direction MLP and the port's
    cast packing of the same parameters."""
    jp = fq.pack_viewdirs_mlp_weights(tree, network)
    model = params_from_jax(tree, torch_cfg(CFG_V), device="cpu")
    with torch.no_grad():
        tc = KV.cast_mlpv_weights(
            KV.pack_viewdirs_mlp_weights(model.network(network)))
    return jp, tc


def _random_views_weights(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return KV.cast_mlpv_weights([torch.randn(KV._expected_shape(i),
                                             generator=gen)
                                 for i in range(KV.N_MLPV_W)])


def test_views_schedule_reads_every_chunk_once():
    sched = S.views_schedule()
    assert len(sched) == 78 and len(set(sched)) == 78
    shapes = [(64 if m in (0, 5) else 256, 256) for m in range(9)]
    shapes += [(256, 256), (256, 128), (32, 128)]
    for layout in ("fwd", "bwd"):
        got = sorted((m, c) for l, m, c in sched if l == layout)
        rows_per_chunk = [64 if layout == "fwd" else min(64, r)
                          for r, _ in shapes]
        want = sorted((m, c) for m, (r, _) in enumerate(shapes)
                      for c in range(-(-r // rows_per_chunk[m])))
        assert got == want
    # the kernel's order: the chain's forward, fw, vwf, vwv; vwf, vwv, fw as
    # B operands of the transposed steps; the chain's backward
    assert sched[:30] == [("fwd", m, c) for m, c in S.fwd_schedule(64)]
    assert [m for _, m, _ in sched[30:48]] == [9] * 4 + [10] * 4 + [11] \
        + [10] * 4 + [11] + [9] * 4
    assert sched[48:] == [("bwd", m, c) for m, c in S.bwd_schedule(64)]
    # the bytes each stage receives: 16 KB for the view layer's chunks (8 KB
    # for vwv's 32 rows as a B operand), 32 KB for the others
    sizes = S.views_chunk_bytes()
    assert sizes[34:44] == [16384] * 9 + [8192]
    assert sizes[:34] == [32768] * 34 and sizes[44:] == [32768] * 34


def test_pack_then_unpack_views_image_returns_every_weight():
    mw = _random_views_weights(3)
    image = S.pack_views_image(mw)
    assert image.dtype == torch.bfloat16
    assert image.shape == (78 * S.CHUNK_ELEMS,)
    back = S.unpack_views_image(image)
    for got, i in zip(back, S.VIEWS_MATRIX_IDX):
        assert torch.equal(got, mw[i])
    # what the producer does not copy of a chunk's slot is zero, so the
    # kernel reads nothing it did not receive
    for slot, nbytes in zip(image.view(-1, S.CHUNK_ELEMS),
                            S.views_chunk_bytes()):
        assert not slot[nbytes // 2:].any()
    # each chunk holds the rows it is scheduled to hold
    mats = [mw[i] for i in S.VIEWS_MATRIX_IDX]
    for slot, (layout, m, c) in zip(image.view(-1, S.CHUNK_ELEMS),
                                    S.views_schedule()):
        rows, cols = mats[m].shape
        if layout == "fwd":
            got = S.fwd_chunk_matrix(slot, cols)
            want = torch.zeros(64, cols, dtype=torch.bfloat16)
            part = mats[m][c * 64:(c + 1) * 64]
            want[:part.shape[0]] = part
        else:
            nr = min(64, rows)
            got = S.bwd_chunk_matrix(slot, nr, cols)
            want = mats[m][c * nr:(c + 1) * nr]
        assert torch.equal(got, want)


def test_views_bwd_from_image_matches_jax_vjp(views_tree, interpret_pallas):
    jp, tc = _views_weights(views_tree, "fine")
    n = 300                       # two whole tiles and a ragged one
    rng = np.random.RandomState(9)
    emb = rng.uniform(-1, 1, (n, 64)).astype(np.float32)
    emb[:, 63] = 0.0
    embv = rng.uniform(-1, 1, (n, 32)).astype(np.float32)
    embv[:, 27:] = 0.0
    draw = rng.randn(n, 8).astype(np.float32)
    n_pad = -(-n // BLOCK) * BLOCK

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, n_pad - n), (0, 0))))

    _, vjp = jax.vjp(lambda e, v, w: fq._mlpv_core(e, v, w, BLOCK),
                     pad(emb), pad(embv), jp)
    demb_j, dembv_j, grads_j = vjp(pad(draw))
    image = S.pack_views_image(tc)
    got = S.views_bwd_from_image(torch.from_numpy(emb).to(torch.bfloat16),
                                 torch.from_numpy(embv).to(torch.bfloat16),
                                 image, tc, torch.from_numpy(draw))
    assert got[0].shape == (n, 64) and got[1].shape == (n, 32)
    assert len(got[2]) == 26
    for i, g in enumerate(got[2]):
        assert g.shape == KV._expected_shape(i)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    ref = (t(demb_j)[:n], t(dembv_j)[:n], [t(g) for g in grads_j])
    stats = KVB.bwd_agreement(got, ref)
    assert stats["ok"], stats


# ---- row 6: mlpe_bwd's encoding in the tile and its fold onto the points


def test_mlpe_encoding_tile_and_fold_match_jax(trees, interpret_pallas):
    jc_full = fq.pack_mlp_pts_weights(trees[64], "fine")
    _, tc = _weights(trees, 64, "fine")
    n = 300
    rng = np.random.RandomState(10)
    pts = (rng.randn(n, 3) * 1.5).astype(np.float32)
    draw = rng.randn(n, 8).astype(np.float32)
    P, phase = KE._projection_on(torch.device("cpu"))
    Pj, phasej = jc_full[-2], jc_full[-1]
    n_pad = -(-n // S.TM) * S.TM            # the kernel's tiles
    n_blk = -(-n // BLOCK) * BLOCK          # the JAX kernel's blocks
    pts_t = torch.from_numpy(np.pad(pts, ((0, n_pad - n), (0, 0))))
    # the encoding each tile's threads write, against _embed_ew's
    pts_blk = np.zeros((n_blk, fq.PTS_PAD), np.float32)
    pts_blk[:n, :3] = pts
    emb_j = np.array(fq._embed_ew(jnp.asarray(pts_blk), Pj, phasej)[2])
    emb_j = torch.from_numpy(emb_j[:n_pad]).to(torch.bfloat16)
    emb_j[n:] = 0
    tiles = []
    for k in range(n_pad // S.TM):
        rows = slice(k * S.TM, (k + 1) * S.TM)
        flat = S.encode_tile(pts_t[rows], P, phase, min(S.TM, n - k * S.TM))
        tile = S._unswizzle(flat.view(S.TM, 64))
        # sin in another library: at most one bf16 rounding apart, rarely
        diff = (tile.float() - emb_j[rows].float()).abs()
        assert (diff <= 2.0 ** -7 * emb_j[rows].float().abs() + 1e-30).all()
        assert (diff > 0).float().mean().item() < 1e-2
        tiles.append(tile)
    embb = torch.cat(tiles)[:n]
    assert not torch.cat(tiles)[n:].any()
    # the chain from the image, its two demb products, folded per tile
    image = S.pack_chain_image(tc, ("fwd", "bwd"))
    nh = S.chain_from_image(embb, image, [tc[i] for i in _BIASES])
    drawt = torch.from_numpy(draw)
    drawb = drawt.to(torch.bfloat16)
    dh8 = KB.masked(KB.mm_nt(drawb, tc[17]), nh[7])
    demb, dh = S.dh_chain_from_image(nh, dh8, image, 64)
    prods = [S._tiles(KB.mm_nt(dh[5], tc[10]), n),
             S._tiles(KB.mm_nt(dh[0], tc[0]), n)]
    dpts = torch.cat([S.fold_tile([p[k * S.TM:(k + 1) * S.TM] for p in prods],
                                  pts_t[k * S.TM:(k + 1) * S.TM], P, phase)
                      for k in range(n_pad // S.TM)])[:n]
    # the fold's order moves only f32 roundings of the plain sum
    pre = pts_t[:n] @ P
    lane = torch.arange(64)
    dpre = torch.where(lane < 3, demb, demb * torch.cos(pre + phase))
    plain = dpre @ P.t()
    assert torch.allclose(dpts, plain, rtol=1e-5,
                          atol=1e-5 * plain.abs().max().item())
    # against the JAX kernel's backward, with the gradients of the second pass
    _, vjp = jax.vjp(lambda p, w: fq._mlpe_core(p, w, BLOCK),
                     jnp.asarray(pts_blk), jc_full)
    jdpts, jgrads = vjp(jnp.asarray(np.pad(draw, ((0, n_blk - n), (0, 0)))))
    acts = [embb] + nh[:7]
    grads = []
    for l in range(8):
        if l == 5:
            grads += [KB.mm_tn(embb, dh[5]), KB.mm_tn(nh[4], dh[5]),
                      KB.bsum(dh[5])]
        else:
            grads += [KB.mm_tn(acts[l], dh[l]), KB.bsum(dh[l])]
    grads += [KB.mm_tn(nh[7], drawb), KB.bsum(drawt)]
    ref = (torch.from_numpy(np.array(jdpts, np.float32)[:n, :3]),
           [torch.from_numpy(np.array(g, np.float32))
            for g in jgrads[:fq.N_MLP_W]])
    stats = KEB.bwd_agreement((dpts, grads), ref)
    assert stats["ok"], stats


# ---- row 3: mlpv_fwd's image (the forward-only part) and its forward


def test_views_fwd_image_is_the_first_39_chunks_of_the_views_image():
    sched = S.views_schedule(("fwd",))
    assert len(sched) == 39 and len(set(sched)) == 39
    assert sched == S.views_schedule()[:39]
    assert S.views_schedule(("bwd",)) == S.views_schedule()[39:]
    # every chunk of every matrix once, in the forward layout: the chain's 30
    # in its forward order, then fw (4), vwf (4), vwv (1)
    shapes = [(64 if m in (0, 5) else 256) for m in range(9)] + [256, 256, 32]
    assert sorted((m, c) for _, m, c in sched) == sorted(
        (m, c) for m, r in enumerate(shapes) for c in range(-(-r // 64)))
    assert all(layout == "fwd" for layout, _, _ in sched)
    assert sched[:30] == [("fwd", m, c) for m, c in S.fwd_schedule(64)]
    assert [m for _, m, _ in sched[30:]] == [9] * 4 + [10] * 4 + [11]
    # the bytes each stage expects: 32 KB, then 16 KB for the view layer
    assert S.views_chunk_bytes(("fwd",)) == [32768] * 34 + [16384] * 5
    assert S.views_chunk_bytes(("fwd",)) == S.views_chunk_bytes()[:39]
    mw = _random_views_weights(5)
    image = S.pack_views_image(mw, ("fwd",))
    assert image.dtype == torch.bfloat16
    assert image.shape == (39 * S.CHUNK_ELEMS,)
    assert torch.equal(image, S.pack_views_image(mw)[:39 * S.CHUNK_ELEMS])
    for got, i in zip(S.unpack_views_image(image, ("fwd",)),
                      S.VIEWS_MATRIX_IDX):
        assert torch.equal(got, mw[i])
    with pytest.raises(ValueError, match="image parts"):
        S.views_schedule(("heads",))


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_views_fwd_from_image_matches_jax_math_and_pallas(views_tree,
                                                          interpret_pallas,
                                                          network):
    """The forward read from the image chunk by chunk, on 128-point tiles
    with a ragged last one, against `_mlpv_fwd_math` and `_mlpv_pallas_fwd`
    in interpret mode, within `mlpv_fwd`'s bf16 tolerances (BF16_TOL_MAX /
    BF16_TOL_MEAN: an f32 sum in another order flips an occasional bf16
    rounding)."""
    jp, tc = _views_weights(views_tree, network)
    n = 300                       # two whole tiles and a ragged one
    rng = np.random.RandomState(11)
    emb = rng.uniform(-1, 1, (n, 64)).astype(np.float32)
    emb[:, 63] = 0.0
    embv = rng.uniform(-1, 1, (n, 32)).astype(np.float32)
    embv[:, 27:] = 0.0
    embb = torch.from_numpy(emb).to(torch.bfloat16)
    embvb = torch.from_numpy(embv).to(torch.bfloat16)
    image = S.pack_views_image(tc, ("fwd",))
    raw = S.views_fwd_from_image(embb, embvb, image, tc)
    assert raw.shape == (n, 8) and raw.dtype == torch.float32
    jc = fq._cast_matmul_weights(jp)
    ref_math = np.asarray(fq._mlpv_fwd_math(jnp.asarray(emb),
                                            jnp.asarray(embv), jc))
    n_blk = -(-n // BLOCK) * BLOCK

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, n_blk - n), (0, 0)))).astype(
            jnp.bfloat16)

    ref_pallas = np.asarray(fq._mlpv_pallas_fwd(pad(emb), pad(embv), jc,
                                                BLOCK))[:n]
    for ref in (ref_math, ref_pallas):
        err = np.abs(raw.numpy() - ref)
        assert err.max() <= KV.BF16_TOL_MAX, err.max()
        assert err.mean() <= KV.BF16_TOL_MEAN, err.mean()
    # the heads' lanes: rgb 0:3 and alpha 3 carry signal, the pad lanes none
    assert raw[:, :4].abs().max() > 0 and not raw[:, 4:].any()
    # and against the kernel's plain version (the same arithmetic in
    # another order of the f32 sums)
    plain = KV.mlpv_fwd_plain(embb, embvb, tc)
    err = (raw - plain).abs()
    assert err.max() <= KV.BF16_TOL_MAX and err.mean() <= KV.BF16_TOL_MEAN


# ---- row 5: mlpe_fwd's encoding in the tile, through the forward's chain


@pytest.mark.parametrize("network", ["coarse", "fine"])
def test_mlpe_fwd_encoding_tile_through_the_chain_matches_pallas(
        trees, interpret_pallas, network):
    """Each tile's encoding as the forward's 96 encoding threads write it
    (the device function the backward shares; the same tile as the
    backward's threads write), then row 1's chain from row 1's image and the
    head, against `_mlpe_pallas_fwd` in interpret mode within `mlp_fwd`'s
    bf16 tolerances."""
    jc_full = fq.pack_mlp_pts_weights(trees[64], network)
    _, tc = _weights(trees, 64, network)
    n = 300
    pts = (np.random.RandomState(12).randn(n, 3) * 1.5).astype(np.float32)
    P, phase = KE._projection_on(torch.device("cpu"))
    n_pad = -(-n // S.TM) * S.TM
    pts_t = torch.from_numpy(np.pad(pts, ((0, n_pad - n), (0, 0))))
    flat = [S.encode_tile(pts_t[k * S.TM:(k + 1) * S.TM], P, phase,
                          min(S.TM, n - k * S.TM), "encoders")
            for k in range(n_pad // S.TM)]
    # the forward's 96 encoders write the same tile as the backward's rows
    for k, tile in enumerate(flat):
        assert torch.equal(tile, S.encode_tile(pts_t[k * S.TM:(k + 1) * S.TM],
                                               P, phase, min(S.TM, n - k * S.TM)))
    embb = torch.cat([S._unswizzle(f.view(S.TM, 64)) for f in flat])
    assert not embb[n:].any()          # rows past n are zero
    image = S.pack_chain_image(tc, ("fwd",))
    nh = S.chain_from_image(embb[:n], image, [tc[i] for i in _BIASES])
    raw = K.mm_bf16(nh[-1], tc[17]) + tc[18]
    n_blk = -(-n // BLOCK) * BLOCK
    pts_blk = np.zeros((n_blk, fq.PTS_PAD), np.float32)
    pts_blk[:n, :3] = pts
    ref = np.asarray(fq._mlpe_pallas_fwd(jnp.asarray(pts_blk),
                                         fq._cast_mlpe_weights(jc_full),
                                         BLOCK))[:n]
    err = np.abs(raw.numpy() - ref)
    assert err.max() <= K.BF16_TOL_MAX, err.max()
    assert err.mean() <= K.BF16_TOL_MEAN, err.mean()
    # the same as the kernel's plain version up to the order of the sums
    plain = KE.mlpe_fwd_plain(torch.from_numpy(pts), tc)
    err = (raw - plain).abs()
    assert err.max() <= K.BF16_TOL_MAX and err.mean() <= K.BF16_TOL_MEAN


@pytest.mark.parametrize("writer", ["rows", "encoders"])
def test_encoding_pieces_cover_the_tile_once(writer):
    """The pieces of the encoding tile, by writer: every (row, 8-lane piece)
    once; the forward's 96 encoders take 11 or 10 pieces each, the
    backward's 256 consumer threads 4 of their own warpgroup's rows."""
    pieces = S.encoding_pieces(writer)
    flat = pieces.reshape(-1, 2)
    flat = flat[flat[:, 0] >= 0]
    assert sorted(map(tuple, flat)) == [(r, c) for r in range(S.TM)
                                        for c in range(0, 64, 8)]
    if writer == "encoders":
        assert pieces.shape[:2] == (S.ENCODERS, 11)
        counts = (pieces[:, :, 0] >= 0).sum(1)
        assert set(counts.tolist()) == {10, 11}
    else:
        assert pieces.shape[:2] == (256, 4)
        assert all((pieces[t, :, 0] // 64 == t // 128).all() for t in range(256))
    with pytest.raises(ValueError, match="writer"):
        S.encoding_pieces("warps")


# ---- row 1 on its points input (`mlp_fwd_points`): the tile its encoders
# write is the tile of the engine's encoding


@pytest.mark.parametrize("e,lat_width", [(64, 0), (128, 32), (128, 8)])
def test_points_pieces_cover_the_tile_once_a_lane_column_a_warp(e, lat_width):
    """Every (row, 8-lane piece) of the 128 x e tile once, by the encoder
    that builds its row or, past the data, zeroes it when the kernel
    starts; at each step an aligned warp of 32 encoders stores the same
    lanes of 32 distinct rows (its threads compute the same lane in step)."""
    row_pieces, zero_pieces = S.points_pieces(e, lat_width)
    data = S.points_data_lanes(lat_width)
    assert data == {0: 64, 32: 96, 8: 72}[lat_width]
    flat = np.concatenate([row_pieces.reshape(-1, 2),
                           zero_pieces.reshape(-1, 2)])
    flat = flat[flat[:, 0] >= 0]
    assert sorted(map(tuple, flat)) == [(r, c) for r in range(S.TM)
                                        for c in range(0, e, 8)]
    assert not (zero_pieces[..., 1][zero_pieces[..., 0] >= 0] < data).any()
    assert not (row_pieces[..., 1][row_pieces[..., 0] >= 0] >= data).any()
    for warp in range(3):
        step = row_pieces[32 * warp:32 * (warp + 1)]
        for i in range(step.shape[1]):
            valid = step[:, i, 0] >= 0
            assert len(set(step[valid, i, 1].tolist())) <= 1
            assert len(set(step[valid, i, 0].tolist())) == valid.sum()


@pytest.mark.parametrize("e,samples", [(64, 1), (128, 64), (128, 3)])
def test_points_tile_is_the_engines_encoding(e, samples):
    """The tile `PointsFwdIn<E>` writes (lane by lane: the sines and
    cosines of x * 2^k on the exact product, the rays' latents in lanes
    63-94, zeros) is `swizzle_tile` of `points_encoding`, the bf16 tensor
    the render path's encoding route builds (fourier_embed, the latent cat,
    F.pad), bit for bit, for a tile with a ragged end; at 64 lanes lane 63
    and at 128 lanes 95-127 are zero."""
    n = 300
    rng = np.random.RandomState(e + samples)
    pts = torch.from_numpy((rng.randn(n, 3) * 1.5).astype(np.float32))
    rays = -(-n // samples)
    lat = (torch.from_numpy((0.3 * rng.randn(rays, 32)).astype(np.float32))
           if e == 128 else None)
    want = K.points_encoding(pts, e, lat, samples)
    assert want.shape == (n, e) and want.dtype == torch.bfloat16
    if e == 64:
        assert not want[:, 63].any()
    else:
        assert not want[:, 95:].any() and want[:, 63:95].any()
    lat_rows = (lat.repeat_interleave(samples, 0)[:n] if lat is not None
                else torch.zeros(n, 0))
    for k in range(-(-n // S.TM)):
        sl = slice(k * S.TM, (k + 1) * S.TM)
        rows = min(S.TM, n - k * S.TM)
        tile_pts = torch.nn.functional.pad(pts[sl], (0, 0, 0, S.TM - rows))
        tile_lat = torch.nn.functional.pad(lat_rows[sl],
                                           (0, 0, 0, S.TM - rows))
        got = S.points_tile(tile_pts, tile_lat, rows, e)
        ref = S.swizzle_tile(torch.nn.functional.pad(
            want[sl], (0, 0, 0, S.TM - rows)))
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16)), k
