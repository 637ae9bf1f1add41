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
- Rows 7 and 8 on the same bender (`bend_fwd_sm90_kernel`,
  `bend_bwd_sm90_kernel`): what the backward stages (the forward's image,
  then b0l's rows) and the transposed weights its products read; the
  forward's two output modes (row 7's f32 rows, the pre-pass's bf16 rows);
  a reader of the backward from its image in the kernel's tile order
  (`bend_bwd_from_image`) against `_bend_core`'s VJP in Pallas interpret
  mode and against `bend_bwd_plain`; the schedule of 64-point tiles over
  the workers; the shared-memory and register budgets read from the header.

The CUDA kernels are held against their plain versions on the card by
`tests/test_torch_kernels_cuda.py`.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from jax.experimental import pallas as pl
from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
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
    # the ring's barriers (2 a stage) and the input's four (full, ready);
    # the image is staged by every thread before the roles split, as rows
    # 7, 8 and 10 stage it, from the 18 weights
    assert 2 * 8 * 2 + 4 * 8 <= bars
    assert "in_args.stage(in_smem, threadIdx.x, THREADS);" in src
    assert "stage_bend_image(extra, bw, false, tid, nthreads);" in src
    assert c["CONSUMER_REGS"] == 232 and c["PRODUCER_REGS"] == 40
    assert 2 * 128 * 232 + 128 * 40 <= 168 * 384
    # lat and rh0 (64 rows x 64 bytes each) share atom 0's 8 KB; rh1 (64 x
    # 64 B) atom 1's; bh (64 x 128 B) atom 2's
    wg_atom = 64 * 128
    assert 2 * 64 * 64 <= wg_atom and 64 * 64 <= wg_atom and 64 * 128 <= wg_atom
    fused = (CSRC / "fused_fwd.cu").read_text()
    assert "launch_fwd<sm90::EMB>(in" in fused and "sm90::FusedFwdIn in{" in fused
    assert "in.bw.w[i] = bend_weights[i];" in fused


def test_row10_budgets_fit_one_hopper_cta():
    """Row 10's pre-pass is row 7's kernel (bf16 rows); its chain kernel is
    row 2's (two activation tiles and a 3-stage ring, 230,528 B)."""
    bwd = (CSRC / "fused_bwd.cu").read_text()
    assert "sm90::launch_bend_forward<true>(bend_weights, pts_f, lat_f, n, n_pad, embp" in bwd
    assert "sm90::launch_bend_backward(bend_weights, pts_f, lat_f, demb_f" in bwd
    assert "__global__" not in bwd
    assert _bend_fwd_smem(_consts((CSRC / "mlp_sm90.cuh").read_text())) <= SMEM_LIMIT
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
    # the pre-pass covers rows 0 .. n_pad - 1 (every tile of the chain) with
    # 16-byte stores of 8 bf16 lanes a row, zero past n
    assert "launch_bend_forward<true>(bend_weights, pts_f, lat_f, n, n_pad, embp" in bwd
    assert "static_cast<bf16*>(emb) + size_t(row0 + r) * EMB + c0" in header
    assert "for (int k = 0; k < L; ++k) y[k] = valid ? y[k] : 0.0f;" in header
    image = S.pack_bend_image(bw)
    rows_b = S.bend_fwd_rows_from_image(_t(pts), _t(lat), image, bf16_rows=True)
    emb_r = S.bend_fwd_rows_from_image(_t(pts), _t(lat), image)
    assert rows_b.shape == (n_pad, 64) and emb_r.shape == (n, 64)
    assert torch.equal(rows_b[:n], emb_r.to(torch.bfloat16))
    assert torch.all(rows_b[n:] == 0)
    assert "bf16* embp = static_cast<bf16*>(scratch);" in header
    assert "encode_box_map(&maps.emb, embp, n_pad, E)" in header
    assert "if (In::STORE_EMB && t == 0) store_rows(&maps.emb" in header


# ---- rows 7 and 8 (`bend_fwd_sm90_kernel`, `bend_bwd_sm90_kernel`)

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
def jax_packed():
    """The JAX packing of the same model, uncast (what `_bend_core` takes)."""
    return fq.pack_fused_weights(jax_params(CFG))


def _bend_fwd_smem(c):
    """Row 7's shared memory from the header's constants: the image padded
    to 1024 B, per pair the consumer's tiles (lat, rh0, rh1 4 KB each, bh 8
    KB), two slots of bh3 (8 KB), rigidity (256 B) and bent points (1 KB),
    the ring's stages (8 KB of latents, 768 B of points), and the barriers."""
    stage = 64 * 32 * 4 + 64 * 3 * 4
    pair = 3 * 4096 + 8192 + 2 * 8192 + 2 * 256 + 2 * 1024 + c["BF_STAGES"] * stage
    pair = -(-pair // 1024) * 1024
    return 1024 + c["BEND_IMAGE_PAD"] + c["BF_PAIRS"] * (pair + 8 * (c["BF_STAGES"] + 4))


def _bend_bwd_smem(c):
    """Row 8's: the backward image, per worker lat, rh0, rh1, drh1 (4 KB
    each), bh0 .. bh3 (8 KB each), lat in a 64-lane tile (8 KB), the two
    8-row B tiles of its m64n8 products (1 KB each), demb's 64 rows (16 KB),
    1,152 f32 row values and 1,860 f32 sums (the CUDA cores' and the
    m64n8 products')."""
    worker = 4 * 4096 + 4 * 8192 + 8192 + 2 * 1024 + 64 * 64 * 4 + 1152 * 4 + 1860 * 4
    worker = -(-worker // 1024) * 1024
    return 1024 + c["BEND_IMAGE_PAD"] + 32 * 64 * 2 + c["BB_WORKERS"] * worker


def test_rows_7_and_8_budgets_fit_an_sm():
    """The plans as the header states them: row 7 three groups a CTA, each
    a consumer and an encoder warpgroup (768 threads, 85 registers a
    thread), its staged image, tiles, slots and 2-stage ring within one
    CTA's 227 KB; row 8 two workers a CTA (256
    threads: up to 255 registers), the 64-lane wgmma gradients in registers
    (four 64 x 64 products: 128 floats a thread, the working 32 and a
    64 x 8 product's 4), the rest in its shared memory. The sums equal the header's
    constants and its static_asserts."""
    src = (CSRC / "mlp_sm90.cuh").read_text()
    c = _consts(src)
    assert c["BEND_IMAGE_PAD"] == 34816 >= 34064
    assert c["BF_PAIRS"] == 3 and c["BF_STAGES"] == 2 and c["BF_ENC_WGS"] == 1
    assert "constexpr int BF_ENCODERS = 128 * BF_ENC_WGS;" in src
    # setmaxnreg: the consumer's 96 and the encoder warpgroup's 64 fit the
    # 80 a thread of 768 threads
    assert c["BF_CONSUMER_REGS"] == 96 and c["BF_ENCODER_REGS"] == 64
    assert 96 + 64 <= 2 * 80
    assert c["BF_CTAS_PER_SM"] == 1 and c["BB_WORKERS"] == 2 and c["BB_CTAS_PER_SM"] == 1
    fwd, bwd = _bend_fwd_smem(c), _bend_bwd_smem(c)
    assert fwd == 208016 <= SMEM_LIMIT and bwd == 216064 <= SMEM_LIMIT
    assert "constexpr size_t SM_SMEM = 233472;" in src
    assert c["BF_CTAS_PER_SM"] * (fwd + 1024) <= 233472
    assert c["BB_CTAS_PER_SM"] * (bwd + 1024) <= 233472
    assert 65536 // (128 * 2 * c["BF_PAIRS"] * c["BF_CTAS_PER_SM"]) == 85
    assert 65536 // (128 * c["BB_WORKERS"] * c["BB_CTAS_PER_SM"]) == 256
    assert "float gw3[32], gw2[32], gw1[32], gl[32];" in src
    assert 4 * 32 + 32 + 4 <= 255 - 64
    # the layouts the kernels index: the row values and the CUDA cores' sums
    c = {**c, **{m.group(1): int(m.group(2)) for m in re.finditer(
        r"\b((?:BR|SG)_\w+) = (\d+)[,;]", src)}}
    assert (c["BR_X"], c["BR_OFF"], c["BR_DBENT"], c["BR_DOFFT"], c["BR_DPRIG"],
            c["BR_TH"], c["BR_RIG"], c["BR_DRIG"], c["BR_FLOATS"]) == (
                0, 192, 384, 576, 768, 960, 1024, 1088, 1152)
    assert (c["SG_R0W"], c["SG_R0B"], c["SG_R1W"], c["SG_R1B"], c["SG_ROW"],
            c["SG_ROB"], c["SG_BB"], c["SG_B0P"], c["SG_BOW"], c["SG_FLOATS"]) == (
                0, 96, 128, 1152, 1184, 1216, 1220, 1476, 1668, 1860)
    # each launch counted against its own kernel; no wmma path left
    assert "bend_fwd_sm90_kernel<BF16_ROWS>" in src
    assert "bend_bwd_sm90_kernel<<<grid, BB_THREADS, BB_SMEM_BYTES, stream>>>(" in src
    for name in ("bend_fwd.cu", "bend_bwd.cu", "fused_bwd.cu", "mlp_tile.cuh"):
        text = (CSRC / name).read_text()
        assert "wmma" not in text and "mma.h" not in text, name
    assert not (CSRC / "bend_tile.cuh").exists()


def test_bend_schedule_covers_every_tile_once():
    """Each 64-point tile goes to one worker, the workers' lists ascending,
    worker w taking w, w + W, ... (W = CTAs x workers a CTA), as the
    kernels' loops `for (b = worker; b < n_blocks; b += workers)` walk them."""
    src = (CSRC / "mlp_sm90.cuh").read_text()
    assert src.count("for (long b = worker; b < n_blocks; b += workers") == 3
    for n_blocks, ctas, per in ((1, 1, 2), (7, 2, 2), (4096, 132, 2), (33, 5, 1)):
        sched = S.bend_schedule(n_blocks, ctas, per)
        flat = sorted(b for w in sched for b in w)
        assert flat == list(range(n_blocks))
        assert all(w == sorted(w) for w in sched)
        assert all(b % (ctas * per) == i for i, w in enumerate(sched) for b in w)


def test_bend_bwd_image_and_its_transposed_operands(weights):
    """Row 8 stages the forward's image, then at 34,816 bytes b0l's rows
    (row i: b0l[i, :], K-major, 128-byte swizzle: `bend_b0l_rows`); the
    operands its transposed products read are b1w^T .. b3w^T (the image's
    rows of W^T read MN-major) and b0l^T (those rows read K-major)."""
    _, tw = weights
    bw = tw[:BF.N_BEND_W]
    image = S.pack_bend_image(bw)
    rows = S.bend_b0l_rows(bw[1])
    assert rows.numel() == 32 * 64 and rows.dtype == torch.bfloat16
    for i in (0, 5, 31):
        for o in (0, 9, 63):
            assert torch.equal(rows[S.kmajor_offset(i, o, 64)], bw[1][i, o])
    # each row holds its 64 values once, its 16-byte pieces XORed with i % 8
    assert torch.equal(rows.view(32, 64).sort(dim=1).values, bw[1].sort(dim=1).values)
    assert torch.equal(rows.view(32, 8, 8)[1, 0], bw[1][1, 8:16])
    tr = S.bend_bwd_transposes(image, rows)
    for name, i in (("b1wT", 3), ("b2wT", 5), ("b3wT", 7)):
        assert torch.equal(tr[name], bw[i].t()), name
    assert torch.equal(tr["b0lT"], bw[1].t())
    assert 2 * S.BEND_IMAGE_PAD == 34816 >= 2 * image.numel()
    src = (CSRC / "mlp_sm90.cuh").read_text()
    assert "constexpr uint32_t BEND_IMAGE_PAD = 34816;" in src
    assert "constexpr uint32_t BIMG_B0L_ROWS = BEND_IMAGE_PAD;" in src
    assert "BEND_BWD_IMAGE_BYTES = BIMG_B0L_ROWS + LAT_W * BEND_W * 2;" in src
    assert "img + BEND_IMAGE_PAD + kmajor_byte(e / BEND_W, e % BEND_W, BEND_W)" in src
    # rows 7-10 stage from the 18 weights: no wrapper packs an image
    assert src.count("stage_bend_image(") == 4
    for name in ("bend_fwd.py", "bend_bwd.py", "fused_fwd.py", "fused_bwd.py"):
        text = (CSRC.parent / name).read_text()
        assert "pack_bend_image(" not in text and "bend_weight_pointers(" in text, name


@pytest.mark.parametrize("n", [300, 700])
def test_bend_fwd_output_modes(weights, n):
    """Row 7's f32 rows (n, 64) and the pre-pass's bf16 rows (n_pad, 64, zero
    past n) from the same reader: the bf16 rows are the f32 rows rounded, and
    both agree with `_bend_fwd_math` within bend_fwd.py's limits."""
    jw, tw = weights
    bw = tw[:BF.N_BEND_W]
    pts, lat = _inputs(n, n + 5)
    image = S.pack_bend_image(bw)
    f32 = S.bend_fwd_rows_from_image(_t(pts), _t(lat), image)
    b16 = S.bend_fwd_rows_from_image(_t(pts), _t(lat), image, bf16_rows=True)
    n_pad = -(-n // 128) * 128
    assert f32.dtype == torch.float32 and f32.shape == (n, 64)
    assert b16.dtype == torch.bfloat16 and b16.shape == (n_pad, 64)
    assert torch.equal(b16[:n], f32.to(torch.bfloat16)) and torch.all(b16[n:] == 0)
    emb_j, off_j, rig_j, _ = fq._bend_fwd_math(_pad(pts, fq.PTS_PAD),
                                               jnp.asarray(lat), list(jw[:18]))
    _, off, rig = S.bend_from_image(_t(pts), _t(lat), image)
    stats = BF.bend_fwd_agreement((f32, off, rig), (
        _t(emb_j), _t(np.asarray(off_j)[:, :3]), _t(np.asarray(rig_j)[:, :1])))
    assert stats["ok"], stats
    src = (CSRC / "mlp_sm90.cuh").read_text()
    assert "if (!BF16_ROWS && !valid) break;" in src
    assert "static_cast<float*>(emb) + size_t(row0 + r) * EMB + c0" in src


@pytest.mark.parametrize("n,ctas", [(300, 2), (512, 1)])
def test_bend_bwd_reader_matches_jax_vjp_and_plain(weights, jax_packed, n, ctas):
    """The backward read out of its image in the kernel's order (64-point
    tiles over the workers of `ctas` CTAs, k-steps of 16, the transposed
    products on `bend_bwd_transposes`) against `_bend_core`'s VJP in Pallas
    interpret mode and against `bend_bwd_plain`, within bend_bwd.py's
    limits (`bend_bwd_agreement`)."""
    _, tw = weights
    bw = tw[:BF.N_BEND_W]
    pts, lat = _inputs(n, n + 9)
    rng = np.random.RandomState(n)
    demb = (0.1 * rng.randn(n, 64)).astype(np.float32)
    doff = rng.randn(n, 3).astype(np.float32)
    drig = rng.randn(n, 1).astype(np.float32)
    got = S.bend_bwd_from_image(_t(pts), _t(lat), bw,
                                _t(demb), _t(doff), _t(drig), ctas=ctas)
    assert got[0].shape == (n, 3) and got[1].shape == (n, 32)
    for g, shape in zip(got[2], BB.BEND_GRAD_SHAPES):
        assert g.shape == shape and g.dtype == torch.float32
    stats = BB.bend_bwd_agreement(got, BB.bend_bwd_plain(_t(pts), _t(lat), bw, _t(demb),
                                                         _t(doff), _t(drig)))
    assert stats["ok"], stats
    block = 256
    n_pad = -(-n // block) * block
    jw = jax_packed

    def padded(a, cols):
        out = np.zeros((n_pad, cols), np.float32)
        out[:n, :a.shape[1]] = a
        return jnp.asarray(out)

    def jax_vjp():
        _, vjp = jax.vjp(lambda p, l, w: fq._bend_core(p, l, w, block),
                         padded(pts, 8), padded(lat, 32), jw[:18])
        return vjp((padded(demb, 64), padded(doff, 8), padded(drig, 8)))

    jd = _interpret(jax_vjp)
    ref = (_t(np.asarray(jd[0])[:n, :3]), _t(np.asarray(jd[1])[:n]),
           [_t(g) for g in jd[2][:16]])
    stats = BB.bend_bwd_agreement(got, ref)
    assert stats["ok"], stats
