"""The Python mirror of rows 9 and 10 on the Hopper chain (`fused_fwd`,
`fused_bwd` on `ops/kernels/csrc/mlp_sm90.cuh`) on the CPU.

- The bender's image (`mlp_sm90.pack_bend_image`): packing and unpacking
  return every weight, bias and the encoding's P and phase; each element of
  the five matrices sits at its K-major swizzled offset (`kmajor_offset`),
  a row's pieces stay in its row, and the 8 rows that one wgmma row group
  reads lie in 8 distinct bank groups.
- A reader of the deformation field from that image in the kernel's order
  (`bend_from_image`: k-steps of 16, the 3-lane products as sequential
  sums) against `_bend_fwd_math` of the JAX package and `bend_fwd_plain`,
  within the limits of `ops/kernels/bend_fwd.py`; and row 9 as a whole read
  out of its two images (the bender's, then row 1's chain) against
  `_forward_math`, within `mlp_fwd`'s bf16 tolerances.
- The budgets read from the sources: row 9's shared memory (the chain on a
  2-stage ring, two encoding tiles, the image and its rows) and registers,
  the consumer warpgroups' bender tiles inside their own rows of the
  activation tile, row 10's pre-pass and chain kernel.
- Row 10's pre-pass writes the bf16 encoding into the rows of the chain's
  scratch that the chain kernel loads and the dW products read, zero past
  n: the chain read from there equals the split's.

The CUDA kernels are held against their plain versions on the card by
`tests/test_torch_kernels_cuda.py`.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch.ops.kernels import bend_fwd as BF
from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels import mlp_sm90 as S
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig()
CSRC = (pathlib.Path(__file__).resolve().parent.parent / "nonrigid_nerf_torch"
        / "ops" / "kernels" / "csrc")
SMEM_LIMIT = 232448
IMAGE_NAMES = ("b0l", "b1w", "b2w", "b3w", "r1w")


@pytest.fixture(scope="module")
def weights():
    """The JAX packing (cast as the JAX kernels read it) and the port's cast
    packing of the flagship model from a seed (`jax_params` perturbs the
    zero-initialised output layers of the deformation, so it bends)."""
    tree = jax_params(CFG)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    jw = fq._cast_matmul_weights(fq.pack_fused_weights(tree),
                                 f32_only=fq._P_PHASE_IDX)
    with torch.no_grad():
        tw = FF.cast_fused_weights(FQ.pack_fused_weights(model))
    return jw, tw


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, 3) * 1.5).astype(np.float32),
            (0.1 * rng.randn(n, 32)).astype(np.float32))


def _pad(a, cols):
    out = np.zeros((a.shape[0], cols), np.float32)
    out[:, :a.shape[1]] = a
    return jnp.asarray(out)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_bend_image_pack_then_unpack_returns_every_weight(weights):
    _, tw = weights
    bw = tw[:BF.N_BEND_W]
    image = S.pack_bend_image(bw)
    assert image.dtype == torch.bfloat16
    assert image.numel() * 2 == 34064 == 2 * S.BEND_IMAGE_ELEMS
    got = S.unpack_bend_image(image)
    for name, (i, *_) in zip(IMAGE_NAMES, S.BEND_IMAGE_MATS):
        assert torch.equal(got[name], bw[i]), name
    assert torch.equal(got["bowT"], bw[9][:, :3].t())
    assert torch.equal(got["row"], bw[14][:, 0])
    assert torch.equal(got["b0p"], bw[0][:3])
    assert torch.equal(got["r0w"], bw[10][:3])
    for name, i in (("b0b", 2), ("b1b", 4), ("b2b", 6), ("b3b", 8),
                    ("r0b", 11), ("r1b", 13)):
        assert torch.equal(got[name], bw[i].reshape(-1)), name
    assert got["rob"][0] == bw[15][0, 0] and torch.all(got["rob"][1:] == 0)
    assert torch.equal(got["P"], bw[16][:3])
    assert torch.equal(got["phase"], bw[17].reshape(-1))
    # every element of the bf16 part is written once
    index = S.bend_image_index()
    assert sorted(index.tolist()) == list(range(S.BEND_BF16_ELEMS))


@pytest.mark.parametrize("lanes", [32, 64])
def test_bend_image_matrices_sit_at_their_swizzled_offsets(weights, lanes):
    """Element (n, k) of a K-major matrix of `lanes` k-values holds W[k, n] at
    `kmajor_offset`; a row's 16-byte pieces are a permutation inside its own
    row; the 8 rows of a row group at one piece lie in 8 distinct 16-byte
    bank groups of 128 bytes (the rows wgmma and ldmatrix read together)."""
    _, tw = weights
    image = S.pack_bend_image(tw[:BF.N_BEND_W])
    for i, k_lanes, n_cols, base in S.BEND_IMAGE_MATS:
        if k_lanes != lanes:
            continue
        w = tw[i]
        n = np.arange(n_cols)[:, None]
        k = np.arange(k_lanes)[None, :]
        off = S.kmajor_offset(n, k, k_lanes)
        got = image[torch.from_numpy(base + off.ravel())].view(n_cols, k_lanes)
        assert torch.equal(got, w.t())
        assert np.array_equal(np.sort(off // k_lanes, axis=1),
                              np.broadcast_to(np.arange(n_cols)[:, None], off.shape))
        pieces = off[:, ::8] * 2                   # byte offsets of the pieces
        for n0 in range(0, n_cols, 8):
            for c in range(k_lanes // 8):
                banks = (pieces[n0:n0 + 8, c] % 128) // 16
                assert len(set(banks.tolist())) == 8
    # the swizzle atoms start on their alignment: 1024 bytes at 64 lanes
    # (128-byte swizzle), 512 at 32 (64-byte swizzle)
    for _, k_lanes, _, base in S.BEND_IMAGE_MATS:
        assert (2 * base) % (1024 if k_lanes == 64 else 512) == 0


@pytest.mark.parametrize("n", [300, 700])
def test_bend_from_image_matches_jax_math_and_plain(weights, n):
    jw, tw = weights
    bw = tw[:BF.N_BEND_W]
    pts, lat = _inputs(n, n)
    emb_j, off_j, rig_j, _ = fq._bend_fwd_math(_pad(pts, fq.PTS_PAD),
                                               jnp.asarray(lat), list(jw[:18]))
    got = S.bend_from_image(_t(pts), _t(lat), S.pack_bend_image(bw))
    assert got[0].shape == (n, 64) and got[1].shape == (n, 3)
    assert got[2].shape == (n, 1)
    ref_j = (_t(emb_j), _t(np.asarray(off_j)[:, :3]), _t(np.asarray(rig_j)[:, :1]))
    stats = BF.bend_fwd_agreement(got, ref_j)
    assert stats["ok"], stats
    stats = BF.bend_fwd_agreement(got, BF.bend_fwd_plain(_t(pts), _t(lat), bw))
    assert stats["ok"], stats


def test_row9_read_from_its_images_matches_jax_forward_math(weights):
    """The bender from its image, the bf16 encoding, nh1 .. nh8 from row 1's
    forward image chunk by chunk, the f32 head: `_forward_math`'s raw within
    `mlp_fwd`'s bf16 tolerances, its offsets and rigidity within bend_fwd.py's
    limits."""
    jw, tw = weights
    n = 300
    pts, lat = _inputs(n, 11)
    raw_j, off_j, rig_j = fq._forward_math(_pad(pts, fq.PTS_PAD),
                                           jnp.asarray(lat), list(jw))
    emb, off, rig = S.bend_from_image(_t(pts), _t(lat),
                                      S.pack_bend_image(tw[:BF.N_BEND_W]))
    mw = tw[BF.N_BEND_W:]
    nh = S.chain_from_image(emb.to(torch.bfloat16),
                            S.pack_chain_image(mw, ("fwd",)),
                            [mw[i] for i in (1, 3, 5, 7, 9, 12, 14, 16)])
    raw = nh[7].float() @ mw[17].float() + mw[18].float()
    err = (raw - _t(raw_j)).abs()
    assert err.max().item() <= K.BF16_TOL_MAX
    assert err.mean().item() <= K.BF16_TOL_MEAN
    assert (off - _t(np.asarray(off_j)[:, :3])).abs().max() <= BF.BEND_TOL_OFF
    assert (rig - _t(np.asarray(rig_j)[:, :1])).abs().max() <= BF.BEND_TOL_RIG


def _consts(text):
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr (?:int|uint32_t|size_t) (\w+) = (\d+);", text)}


def test_row9_budgets_fit_one_hopper_cta():
    """Row 9's plan as the header states it: the chain on a 2-stage ring, two
    encoding tiles, the bender's image (34,064 B), two tiles' rigidity and
    bent points, the barriers; the consumers keep the chain's 232 registers
    and the producer warpgroup 40 (all of the CTA's 168 a thread); each
    consumer warpgroup's bender tiles (bf16 lat and rh0, rh1, bh) fit its
    own 8 KB of three k-atoms of the activation tile."""
    src = (CSRC / "mlp_sm90.cuh").read_text()
    c = _consts(src)
    align, act, atom, chunk, bars = 1024, 128 * 256 * 2, 128 * 64 * 2, 64 * 256 * 2, 128
    assert c["FUSED_STAGES"] == 2 and c["TM"] == 128
    image = 2 * S.BEND_IMAGE_ELEMS
    assert "static_assert(BEND_IMAGE_BYTES == 34064" in src
    extra = image + 2 * 128 * 4 + 2 * 128 * 4 * 4
    total = align + act + 2 * atom + c["FUSED_STAGES"] * chunk + bars + extra
    assert total == 204176 <= SMEM_LIMIT
    # a third stage does not fit beside the image
    assert total + chunk > SMEM_LIMIT
    assert "fwd_smem_bytes<EMB, 2, FUSED_STAGES> + FUSED_EXTRA_BYTES <= SMEM_LIMIT" in src
    # the ring's barriers (2 a stage) and the input's five
    assert 2 * 8 * 2 + 5 * 8 <= bars
    assert c["CONSUMER_REGS"] == 232 and c["PRODUCER_REGS"] == 40
    assert 2 * 128 * 232 + 128 * 40 <= 168 * 384
    # lat and rh0 (64 rows x 64 bytes each) share atom 0's 8 KB; rh1 (64 x
    # 64 B) atom 1's; bh (64 x 128 B) atom 2's
    wg_atom = 64 * 128
    assert 2 * 64 * 64 <= wg_atom and 64 * 64 <= wg_atom and 64 * 128 <= wg_atom
    fused = (CSRC / "fused_fwd.cu").read_text()
    assert "launch_fwd<sm90::EMB>(in" in fused and "sm90::FusedFwdIn in{" in fused


def test_row10_budgets_fit_one_hopper_cta():
    """Row 10's pre-pass is bend_fwd.cu's tile with the warp scratch, three
    CTAs an SM; its chain kernel is row 2's (two activation tiles and a
    3-stage ring, 230,528 B)."""
    tile = (CSRC / "bend_tile.cuh").read_text()
    assert "constexpr int LDBH = BW + 8;" in tile and "constexpr int LDR = RW + 8;" in tile
    assert "constexpr int BW = 64;" in tile and "constexpr int RW = 32;" in tile

    def pad128(b):
        return (b + 127) // 128 * 128

    tm, pts = 128, 3
    xs, rowf = pad128(tm * pts * 4), pad128(tm * 4)
    lat = pad128(tm * (32 + 8) * 2)
    bh, rh = pad128(tm * (64 + 8) * 2), pad128(tm * (32 + 8) * 2)
    prepass = 3 * xs + 2 * rowf + lat + bh + rh + 8 * 16 * 16 * 4
    assert prepass == 52736 and 3 * prepass <= SMEM_LIMIT
    bwd = (CSRC / "fused_bwd.cu").read_text()
    assert "PREPASS_SMEM_BYTES = BEND_FWD_TILE_BYTES + WSCR_BYTES;" in bwd
    assert "__launch_bounds__(THREADS, 3)" in bwd
    assert 1024 + 2 * 128 * 256 * 2 + 3 * 64 * 256 * 2 + 128 == 230528 <= SMEM_LIMIT


def test_prepass_writes_the_encoding_where_the_chain_reads_it(weights):
    """The pre-pass writes bf16(the bender's encoding) into rows 0 .. n_pad - 1
    of the scratch's first (n_pad, 64) block, zero past n; that block is the
    chain kernel's encoding (its `EncodingIn<EMB, false>` loads `embp`, the
    scratch's start, and does not store it back) and the dW products' (the
    tensor map `maps.emb` over the same rows). Read from there, the chain
    and the first layer's weight gradient equal the split's, which starts
    from the f32 encoding of `bend_fwd`."""
    _, tw = weights
    bw, mw = tw[:BF.N_BEND_W], tw[BF.N_BEND_W:]
    n = 300
    n_pad = -(-n // 128) * 128
    pts, lat = _inputs(n, 13)
    scratch = torch.full((n_pad * (64 + 2 * 8 * 256),), float("nan"),
                         dtype=torch.bfloat16)
    emb = BF.bend_fwd_plain(_t(pts), _t(lat), bw)[0]
    rows = torch.zeros(n_pad, 64, dtype=torch.bfloat16)
    rows[:n] = emb.to(torch.bfloat16)                 # the pre-pass's stores
    scratch[:n_pad * 64] = rows.reshape(-1)
    enc = scratch[:n_pad * 64].view(n_pad, 64)
    assert torch.all(enc[n:] == 0) and bool(torch.isfinite(enc.float()).all())
    image = S.pack_chain_image(mw, ("fwd",))
    biases = [mw[i] for i in (1, 3, 5, 7, 9, 12, 14, 16)]
    got = S.chain_from_image(enc[:n], image, biases)
    split = S.chain_from_image(emb.to(torch.bfloat16), image, biases)
    assert all(torch.equal(a, b) for a, b in zip(got, split))
    dh1 = torch.randn(n_pad, 256).to(torch.bfloat16)
    dh1[n:] = 0                                      # rows past n: draw = 0
    g_full = enc.float().t() @ dh1.float()
    g_split = emb.to(torch.bfloat16).float().t() @ dh1[:n].float()
    assert torch.equal(g_full, g_split)
    bwd = (CSRC / "fused_bwd.cu").read_text()
    header = (CSRC / "mlp_sm90.cuh").read_text()
    assert "bf16* embp = static_cast<bf16*>(scratch);" in bwd
    assert "sm90::EncodingIn<EMB, false> in{embp, demb_f};" in bwd
    assert "dim3(unsigned(n_pad / TM))" in bwd
    assert "embp + size_t(row0 + r) * EMB + c0" in bwd
    assert "bf16* embp = static_cast<bf16*>(scratch);" in header
    assert "encode_box_map(&maps.emb, embp, n_pad, E)" in header
    assert "if (In::STORE_EMB && t == 0) store_rows(&maps.emb" in header
