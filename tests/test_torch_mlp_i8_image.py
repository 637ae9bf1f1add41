"""Row 11's layouts on the CPU: the int8 image that `mlp_i8`'s kernel
(`ops/kernels/csrc/mlp_i8.cu` on `mlp_sm90.cuh`) reads, its epilogue
parameters, and a reader of the int8 chain from them
(`ops/kernels/mlp_sm90.py`).

- The int8 swizzled tile layout (`tile_offset_i8`) keeps each row's 16-byte
  pieces inside its own 128 bytes.
- The schedule reads every element of the nine int8 matrices once in 17
  chunks, copies 16 KB of qw5e's two halves and 32 KB of every other chunk,
  and the kernel's source states the same count, skip chunk and byte counts.
- Packing the image and unpacking it returns the 29-tuple's int8 matrices;
  each chunk holds the weight rows the schedule names, and its pad bytes
  are zero.
- The kernel's roundings by 1.5 * 2^23 equal the plain version's, ties
  included.
- The chain read out of the image in the kernel's order (layer 5 in halves
  of 128 columns) equals `mlp_i8_plain` bit for bit up to h8 and within
  `I8_TOL_MAX` at raw, on tiles with ragged tails, and the JAX kernel
  `mlp_i8_core` (Pallas interpret mode) within the tolerance that
  `tests/test_torch_quant.py` holds the plain version to.

The CUDA kernel that reads this image is held against `mlp_i8_plain` on the
card by `tests/test_torch_kernels_cuda.py`.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.quant_mlp as jq
from nonrigid_nerf_torch.ops.kernels import mlp_sm90 as S
from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig
from tests.torch_parity import jax_params, torch_cfg

CFG = ModelConfig()
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nonrigid_nerf_torch", "ops", "kernels", "csrc", "mlp_i8.cu")


@pytest.fixture(scope="module")
def weights():
    tree = jax_params(CFG)
    return tree, params_from_jax(tree, torch_cfg(CFG), device="cpu")


def _emb(n, seed=0):
    """(n, 64) encodings with the zero pad lane, wide enough to clip."""
    rng = np.random.RandomState(seed)
    emb = np.clip(rng.randn(n, 64), -1.5, 1.5).astype(np.float32)
    emb[:, 63] = 0.0
    return emb


def _qw(model, network="coarse", seed=4):
    scales = KQ.calibrate_act_scales(model.network(network),
                                     torch.from_numpy(_emb(2048, seed)))
    return KQ.pack_int8_mlp_weights(model.network(network), scales)


def _kernel_args(qw):
    """The image, the epilogue parameters, qm, ow, ob as the wrapper passes
    them."""
    image = S.pack_i8_image([qw[i] for i in KQ._I8_MATRIX_IDX])
    epi = S.pack_i8_epilogue([qw[i] for i in KQ._I8_DEQ_IDX],
                             [qw[i] for i in KQ._I8_BIAS_IDX])
    return image, epi, qw[KQ._I8_QM], qw[KQ._I8_OW], qw[KQ._I8_OB]


@pytest.mark.parametrize("cols", [128, 256])
def test_i8_tile_offset_permutes_each_row_within_its_128_bytes(cols):
    r = np.arange(128)[:, None]
    c = np.arange(cols)[None, :]
    off = S.tile_offset_i8(r, c)
    assert sorted(off.ravel().tolist()) == list(range(128 * cols))
    # a 16-byte piece stays whole, in its row's 128 bytes of its k-atom
    atom_row = (c // 128) * 128 * 128 + r * 128
    assert ((off - atom_row >= 0) & (off - atom_row < 128)).all()
    assert (off % 16 == c % 16).all()


def test_i8_schedule_reads_every_weight_once_and_its_bytes():
    sched = S.i8_schedule()
    assert len(sched) == 17
    seen = [np.zeros((r, 256), np.int64) for r in S.I8_ROWS]
    for m, k0, n0, cols, atoms in sched:
        k1 = min(k0 + 128 * atoms, S.I8_ROWS[m])
        seen[m][k0:k1, n0:n0 + cols] += 1
    assert all((s == 1).all() for s in seen)
    # the layers in the kernel's order: qw0, qw1 .. qw4, then layer 5's
    # halves (qw5e's, qw5h's), qw6, qw7
    assert [m for m, *_ in sched] == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 6, 5, 6,
                                      7, 7, 8, 8]
    sizes = S.i8_chunk_bytes()
    assert sizes == [32768] * 9 + [16384, 32768, 16384, 32768] + [32768] * 4
    assert sum(sizes) == 15 * 32768 + 2 * 16384 == 524288
    assert all(b % 1024 == 0 for b in sizes)


def test_i8_kernel_source_states_the_same_schedule_and_budget():
    """The kernel's constants agree with the Python mirror: 17 chunks, the
    skip's first chunk, the byte counts the stages expect, and a shared
    memory plan within one Hopper CTA's 232,448 bytes."""
    with open(SOURCE) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("I8_CHUNKS") == len(S.i8_schedule())
    skip = const("I8_SKIP")
    assert S.i8_schedule()[skip][0] == 5 and S.i8_schedule()[skip - 1][0] == 4
    sizes = S.i8_chunk_bytes()
    assert [i for i, b in enumerate(sizes) if b != 32768] == [skip, skip + 2]
    assert "c == I8_SKIP || c == I8_SKIP + 2 ? I8_HALF_BYTES : CHUNK_BYTES" \
        in src
    stages = const("I8_STAGES")
    tile, emb_tile, chunk, align, bars = 128 * 256, 128 * 128, 32768, 1024, 128
    owt, epi = 256 * 8 * 2, 9 * 128 * 16     # ow^T; a float4 per column pair
    assert align + 2 * tile + 2 * emb_tile + stages * chunk + owt + epi \
        + bars == 220288 <= 232448
    assert 2 * 8 * stages + 4 * 8 <= bars
    assert "constexpr int EPI_ROWS = N_LAYERS + 1;" in src     # 9 rows
    assert 2 * tile == 128 * 256 * 2     # h8's bf16 tile over the two int8 tiles
    # no per-launch transposes, no mma.sync: wgmma on the weight ring
    assert "mma.sync" not in src and "wgmma_m64n256_s8" in src
    with open(os.path.join(os.path.dirname(SOURCE), "..", "quant_mlp.py")) as f:
        assert ".t().contiguous()" not in f.read()


def test_pack_then_unpack_i8_image_returns_every_int8_matrix(weights):
    _, model = weights
    qw = _qw(model)
    mats = [qw[i] for i in KQ._I8_MATRIX_IDX]
    image = S.pack_i8_image(mats)
    assert image.dtype == torch.int8 and image.shape == (17 * 32768,)
    back = S.unpack_i8_image(image)
    assert len(back) == 9
    for a, b in zip(back, mats):
        assert a.shape == b.shape and torch.equal(a, b)


def test_i8_chunks_hold_the_scheduled_rows_and_zero_pads(weights):
    _, model = weights
    mats = [m for m in (_qw(model)[i] for i in KQ._I8_MATRIX_IDX)]
    image = S.pack_i8_image(mats)
    slots = image.view(17, 32768)
    for slot, size, (m, k0, n0, cols, atoms) in zip(
            slots, S.i8_chunk_bytes(), S.i8_schedule()):
        got = S.i8_chunk_matrix(slot, cols, atoms)
        want = torch.zeros(128 * atoms, cols, dtype=torch.int8)
        rows = mats[m][k0:k0 + 128 * atoms, n0:n0 + cols]
        want[:rows.shape[0]] = rows
        assert torch.equal(got, want), (m, k0, n0)
        # what the producer does not copy is zero
        assert not slot[size:].any()
    # qw0's and qw5e's 64 rows in 128-deep atoms: lanes 64 .. 127 of each
    # 128-byte row are zero and never read (two k-steps of 32)
    for i in (0, 9, 11):
        m = S.i8_chunk_matrix(slots[i], 256 if i == 0 else 128)
        assert not m[64:].any()


def test_i8_epilogue_parameters_are_one_float4_per_column_pair(weights):
    _, model = weights
    qw = _qw(model)
    epi = S.pack_i8_epilogue([qw[i] for i in KQ._I8_DEQ_IDX],
                             [qw[i] for i in KQ._I8_BIAS_IDX])
    assert epi.shape == (9, 128, 4) and epi.dtype == torch.float32
    assert epi.is_contiguous()
    deq = dict(zip(("d0", "d1", "d2", "d3", "d4", "d5e", "d5h", "d6", "d7"),
                   (qw[i].reshape(256) for i in KQ._I8_DEQ_IDX)))
    bias = [qw[i].reshape(256) for i in KQ._I8_BIAS_IDX]
    rows = ["d0", "d1", "d2", "d3", "d4", "d5h", "d6", "d7", "d5e"]
    for layer, name in enumerate(rows):
        d = epi[layer, :, :2].reshape(256)
        b = epi[layer, :, 2:].reshape(256)
        assert torch.equal(d, deq[name]), name
        assert torch.equal(b, bias[layer] if layer < 8 else torch.zeros(256))


def test_i8_roundings_equal_the_plain_ones():
    """The kernel's roundings by adding 1.5 * 2^23 (the requantization with
    its shift and clip read off the float's bits, the encoders' symmetric
    quantization off its low byte) equal torch.round (half to even), exact
    ties, negative pre-activations, huge ones and the clips included."""
    rng = np.random.RandomState(0)
    m = torch.tensor(2.0)
    ties = torch.arange(-20, 300, dtype=torch.float32) / 2.0 + 0.25
    v = torch.cat([ties, torch.from_numpy(rng.uniform(-50, 200, 100000)
                                          .astype(np.float32)),
                   torch.tensor([0.0, -0.0, 127.0, 1e9, -1e9, 3e38,
                                 float("inf"), -float("inf")])])
    assert torch.equal(S.requant_i8(v, m), KQ._quant_relu(torch.relu(v), m))
    x = torch.cat([ties - 80.0, torch.from_numpy(
        rng.uniform(-100, 100, 100000).astype(np.float32))])
    assert torch.equal(S.quant_sym_i8(x, m), KQ._quant_sym(x, m))
    # every tie rounded to even
    assert (KQ._quant_relu(torch.tensor([0.25, 0.75]), m) + 127).tolist() \
        == [0, 2]


@pytest.mark.parametrize("network", ["coarse", "fine"])
@pytest.mark.parametrize("n", [1, 127, 129])
def test_i8_chain_from_image_equals_plain_bit_for_bit(weights, network, n):
    """qemb, q1 .. q7 and h8 bit-equal to `i8_chain_plain`, raw within
    `I8_TOL_MAX` of `mlp_i8_plain` (the kernel's head sums in another
    order), on one or two tiles with a ragged tail."""
    _, model = weights
    qw = _qw(model, network)
    emb = torch.from_numpy(_emb(n, 7 + n)).to(torch.bfloat16)
    acts, h8, raw = S.i8_chain_from_image(emb, *_kernel_args(qw))
    want_acts, want_h8 = KQ.i8_chain_plain(emb, qw)
    assert len(acts) == len(want_acts) == 8
    for i, (a, b) in enumerate(zip(acts, want_acts)):
        assert a.dtype == b.dtype == torch.int8 and torch.equal(a, b), i
    assert torch.equal(h8, want_h8)
    want = KQ.mlp_i8_plain(emb, qw)
    assert raw.shape == (n, 8)
    assert (raw - want).abs().max().item() <= KQ.I8_TOL_MAX
    # the activations reach the clips and the zero point
    assert any(bool((a == -127).any()) for a in acts[1:])


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jq.pl, "pallas_call", patched)


def test_i8_chain_from_image_matches_pallas_interpret(weights,
                                                      interpret_pallas):
    """The image's chain against the JAX kernel `mlp_i8_core` on the JAX
    package's packed tuple, within the limits of
    `test_plain_matches_pallas_interpret` (an activation within an f32
    rounding of a half-integer may quantize one step apart: XLA's CPU backend
    may contract a * d + b into one fused multiply-add)."""
    tree, _ = weights
    n, block = 300, 256
    emb = _emb(n, 3)
    scales = jq.calibrate_act_scales(tree, jnp.asarray(_emb(2048, 4)[:, :63]))
    qw_j = jq.pack_int8_mlp_weights(tree, scales)
    embb = jnp.asarray(np.pad(emb, ((0, 2 * block - n), (0, 0)))).astype(
        jnp.bfloat16)
    want = np.asarray(jq.mlp_i8_core(embb, qw_j, block))[:n]
    qw = []
    for w in qw_j:
        a = np.asarray(w)
        qw.append(torch.from_numpy(np.array(w.astype(jnp.float32))).to(
            torch.bfloat16) if a.dtype.kind == "V" else torch.from_numpy(
                np.array(a)))
    _, _, raw = S.i8_chain_from_image(
        torch.from_numpy(emb).to(torch.bfloat16), *_kernel_args(tuple(qw)))
    err = np.abs(raw.numpy() - want)
    scale = np.abs(want).max()
    assert err.max() <= 2e-3 * scale, err.max() / scale
    assert err.mean() <= 2e-5 * scale, err.mean() / scale
