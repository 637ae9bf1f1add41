// Canonical NeRF MLP forward in int8 (8 x 256, skip at layer 4), inference
// only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mlp_i8_core` / `_i8_fwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/quant_mlp.py:238-257), whose math is
// `_i8_fwd_math` (quant_mlp.py:212-235):
//
//   qemb = int8(round(clip(emb * qm[0], -127, 127)))          (symmetric)
//   h1   = relu(f32(qemb @ qw0) * d0 + b0)
//   q_l  = int8(round(clip(h_l * qm[l], 0, 254)) - 127)       (zero-point -127)
//   h_l+1 = relu(f32(q_l @ qw_l) * d_l + b_l)                 l = 1..4, 6, 7
//   h6   = relu(f32(q5 @ qw5h) * d5h + f32(qemb @ qw5e) * d5e + b5)
//   raw  = bf16(h8) @ owb + ob                                (f32, 8 lanes)
//
// int8 x int8 products accumulate in int32 (exact: at most 256 * 127 * 127 <
// 2^22, so the conversion to f32 is exact too). d_l are per-output-channel
// dequantization rows with the previous layer's activation step folded in,
// b_l the biases with the zero-point correction folded in, qm the nine
// quantization multipliers. The rounding is to nearest even, after the clip,
// before the shift by 127.
//
// Contract: the epilogues multiply and add with __fmul_rn / __fadd_rn, never
// a fused multiply-add, in the order of the formula above, so every layer up
// to h8 is bit-equal to the plain PyTorch version (ops/kernels/quant_mlp.py:
// mlp_i8_plain); only the order of the f32 sums of the bf16 head differs.
//
// What bounds it: 493,568 MACs per point = 0.987 MOP, against 160 bytes of
// HBM traffic per point (128 B of bf16 encoding in, 32 B of raw out): the
// tensor cores at the card's int8 rate, 1,979 TOP/s.
//
// Design: row 1's skeleton (mlp_sm90.cuh): persistent CTAs on a static tile
// schedule, two consumer warpgroups of 64 rows each for the whole chain, a
// producer warpgroup whose first thread streams a pre-packed weight image
// through the mbarrier ring, setmaxnreg 232 / 40. What is int8's own:
// - products: wgmma m64n256k32 s8 x s8 -> s32, both operands K-major in the
//   128-byte swizzle, whose rows hold 128 k-values at this width: a weight
//   chunk is 128 k-values of all 256 columns, 32 KB, one ring stage. The
//   image (ops/kernels/mlp_sm90.py:pack_i8_image, 17 chunks) holds element
//   (n, k) of a chunk as W[k0 + k, n], so no weight is transposed per launch;
//   one `int acc[128]` a thread serves every product;
// - the two consumer warpgroups take turns at the tensor cores (a named
//   barrier pair), so one's epilogue runs under the other's products;
// - shared memory (220,288 B): two int8 activation tiles (32 KB each, half
//   of bf16's), two encoding tiles, a 3-stage ring (2 stages run as fast,
//   chip_variants.py; 4 leave no room for the next two), ow^T for the head
//   and the epilogues' parameters;
// - the 64-lane encoding is quantized (symmetric, qm[0]) by the producer
//   warpgroup's three idle warps into two int8 encoding tiles taken in turn,
//   as row 5 encodes its points (PtsFwdIn): ALU work on the consumers stays on
//   the chain's critical path (quantized by the consumers when their tile
//   starts, the kernel runs 1.16x as long: chip_variants.py). A tile is one
//   128-lane atom of which the products read the first 64 lanes (two k-steps):
//   no zero padding is multiplied, and the 128-byte swizzle serves every
//   operand. qw0's chunk and qw5e's likewise hold 64 k-values in 128-byte
//   rows;
// - layer 5's two integer products have different dequantization rows, so
//   they cannot share an s32 sum, and a second m64n256 accumulator does not
//   fit the registers: the layer runs in two halves of 128 output columns.
//   In each, e = qemb @ qw5e[:, half] on m64n128k32 into acc[0..63], kept as
//   the f32 bits of f32(e) d5e in acc[64..127]; then a = q5 @ qw5h[:, half]
//   into acc[0..63]; the epilogue adds in the plain version's order,
//   ((f32(a) d5h) + (f32(e) d5e)) + b5. (Products into acc[64..127] made
//   ptxas serialize every wgmma of the kernel, C7511.) The first half's q6
//   must not overwrite q5, which the second half still reads, so q1 .. q5
//   live in tile 0 and q6, q7 in tile 1. Layer 5's chunks are qw5e's half
//   (16 KB copied) and qw5h's half (two k-atoms, 32 KB), twice;
// - the requantizing epilogue works from the accumulator layout, about eight
//   instructions an element: the int-to-float conversion (exact below 2^24),
//   dequantization, bias, ReLU, * qm, the rounding by adding 1.5 * 2^23
//   (ties to even, as rintf), one DPX instruction for the shift by 127 and
//   the clip at 254, and the low bytes of a thread's two neighbouring columns
//   packed into one 16-bit store into the next layer's swizzled A tile. (A
//   lane exchange to 32-bit stores would put rows r and r + 8 of a warp on
//   the same banks: no fewer wavefronts.) The epilogue's d and b are one
//   float4 per column pair (pack_i8_epilogue), copied into shared memory
//   when the CTA starts: one LDS a column pair, its offset an immediate,
//   issued two column groups ahead (at the point of use, the LDS latency
//   stalled every group);
// - the 8-lane head on the tensor cores: h8 as a bf16 tile laid over the two
//   int8 tiles (both are free by then), 16 m64n8k16 against ow^T, which the
//   CTA lays out in shared memory when it starts. Its f32 sums run in the
//   tensor cores' order, within I8_TOL_MAX of the plain version's; with
//   the per-thread dot product of rows 1 and 5 (raw_head) the kernel runs
//   1.29x as long (chip_variants.py);
// - rows past n are zero-filled by the encoders and not stored. No atomics:
//   the result is deterministic.
//
// Plain C interface, bound with ctypes (see ../quant_mlp.py).

#include "mlp_sm90.cuh"

namespace sm90 {
namespace {

constexpr int I8_STAGES = 3;
constexpr int I8_K = 128;                                   // k-values of a swizzle row
constexpr uint32_t I8_TILE_BYTES = (NW / I8_K) * TILE_ATOM_BYTES;   // 128 x 256 int8
constexpr uint32_t I8_EMB_BYTES = TILE_ATOM_BYTES;          // 128 rows x 64 (of 128) lanes
constexpr uint32_t I8_HALF_BYTES = (NW / 2) * ATOM_ROW_BYTES;  // qw5e's half: 128 columns
constexpr int I8_CHUNKS = 17;      // qw0; qw1..qw4 x 2; (qw5e, qw5h) halves; qw6, qw7 x 2
constexpr int I8_SKIP = 9;        // layer 5's first chunk: after qw0's 1, qw1..qw4's 8
constexpr int ENCODERS = 96;       // the producer warpgroup's three idle warps
constexpr int EMB_PIECES = TM * EMB / 16;   // 16-lane pieces of an encoding tile
constexpr float MAGIC = 12582912.0f;        // 1.5 * 2^23
constexpr uint32_t OWT_BYTES = (NW / 64) * 8 * ATOM_ROW_BYTES;   // ow^T: 4 k-atoms of 8 rows
constexpr int EPI_ROWS = N_LAYERS + 1;                     // d, b of layers 0 .. 7; d5e
constexpr uint32_t EPI_ROW_BYTES = (NW / 2) * 16;          // a float4 per column pair
constexpr size_t I8_SMEM_BYTES = SMEM_ALIGN + 2 * I8_TILE_BYTES + 2 * I8_EMB_BYTES +
                                 I8_STAGES * CHUNK_BYTES + OWT_BYTES +
                                 EPI_ROWS * EPI_ROW_BYTES + BAR_BYTES;
static_assert(I8_SMEM_BYTES <= SMEM_LIMIT, "row 11 fits one Hopper CTA");
static_assert(2 * I8_TILE_BYTES == ACT_BYTES, "h8's bf16 tile covers the two int8 tiles");
static_assert(2 * 8 * I8_STAGES + 4 * 8 <= BAR_BYTES, "the ring's barriers and the encoders'");
static_assert(I8_HALF_BYTES % 1024 == 0 && 2 * I8_HALF_BYTES == CHUNK_BYTES,
              "a half of layer 5's columns in 128-byte rows");

struct I8Args {
  const float4* epi;   // (9, 128): per layer and column pair (d, d', b, b'); row 8 d5e
  const float* qm;     // (16,): 127/s_emb, 254/s_1 .. 254/s_8
  const bf16* ow;      // (256, 8) bf16
  const float* ob;     // (8,) f32
};

// byte offset of element (row, col) of an int8 tile of 128 rows: k-atoms of
// 128 lanes, 16-byte pieces XOR row % 8 (tile_offset in bytes of int8)
__device__ __forceinline__ uint32_t i8_offset(int row, int col) {
  return uint32_t(col >> 7) * TILE_ATOM_BYTES + uint32_t(row) * ATOM_ROW_BYTES +
         ((uint32_t((col >> 4) & 7) ^ uint32_t(row & 7)) << 4) + uint32_t(col & 15);
}

// q = rint(clip(relu(v) * m, 0, 254)) - 127 (zero-point -127), as an int in
// [-127, 127] whose low byte is the int8: adding 1.5 * 2^23 to relu(v) * m
// rounds it to an integer (to even on a tie, as rintf) held in the low
// mantissa bits, and one DPX instruction subtracts 1.5 * 2^23 + 127 from
// those bits and clips above at 127 (past 254 the rounding need not be
// exact: rint is monotone, 254 is an integer, and the bits of a positive
// float order as the float does)
__device__ __forceinline__ int requant(float v, float m) {
  const int bits = __float_as_int(__fadd_rn(__fmul_rn(fmaxf(v, 0.0f), m), MAGIC));
  return __viaddmin_s32(bits, -(0x4B400000 + 127), 127);
}

// 16 bytes of shared memory as a float4
__device__ __forceinline__ float4 ld_shared16f(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// rint(clip(x * m, -127, 127)) in the low byte (two's complement)
__device__ __forceinline__ uint32_t quant_sym(float x, float m) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(__fmul_rn(x, m), -127.0f), 127.0f), MAGIC));
}

// four bf16 lanes (two words) -> four int8 lanes (one word)
__device__ __forceinline__ uint32_t quant_sym4(uint32_t w0, uint32_t w1, float m) {
  const uint32_t a = __byte_perm(quant_sym(__uint_as_float(w0 << 16), m),
                                 quant_sym(__uint_as_float(w0 & 0xffff0000u), m), 0x0040);
  const uint32_t b = __byte_perm(quant_sym(__uint_as_float(w1 << 16), m),
                                 quant_sym(__uint_as_float(w1 & 0xffff0000u), m), 0x0040);
  return __byte_perm(a, b, 0x5410);
}

// lanes c0 .. c0 + 15 of row r of a tile's encoding (rows past n zero),
// quantized into the int8 encoding tile
__device__ __forceinline__ void quantize_piece(uint32_t embt, const bf16* __restrict__ emb,
                                              long row0, int n, float m, int r, int c0) {
  uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
  if (row0 + r < n) {
    const uint4* src = reinterpret_cast<const uint4*>(emb + size_t(row0 + r) * EMB + c0);
    lo = __ldg(src);
    hi = __ldg(src + 1);
  }
  st_shared16(embt + i8_offset(r, c0),
              make_uint4(quant_sym4(lo.x, lo.y, m), quant_sym4(lo.z, lo.w, m),
                         quant_sym4(hi.x, hi.y, m), quant_sym4(hi.z, hi.w, m)));
}

// Encoder e (0 .. 95): its pieces of every tile of this CTA (piece q = row q
// / 4, lanes (q % 4) * 16), the i-th tile into encoding tile i % 2 once the
// consumers are done with what it held. Two mbarriers a tile: "full" (96
// arrivals, after each encoder's fence.proxy.async) and "empty" (one
// arrival per consumer warpgroup once layer 5 has read the tile).
__device__ __forceinline__ void quantize_encodings(const bf16* __restrict__ emb, float m,
                                                   uint32_t emb0, uint32_t bars, int n,
                                                   int n_tiles, int e) {
  int i = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int b = i % 2;
    const uint32_t embt = emb0 + uint32_t(b) * I8_EMB_BYTES;
    mbar_wait(bars + 8 * (2 + b), ((i / 2) & 1) ^ 1);
#pragma unroll 1
    for (int q = e; q < EMB_PIECES; q += ENCODERS) {
      quantize_piece(embt, emb, long(tile) * TM, n, m, q / 4, (q % 4) * 16);
    }
    fence_proxy_async();
    mbar_arrive(bars + 8 * b);
  }
}

// The two consumer warpgroups take turns at the tensor cores: a warpgroup
// issues a layer's products once the other has issued its previous ones
// (named barriers of both warpgroups' 256 threads, one per warpgroup), so
// one warpgroup's epilogue runs under the other's products. Left alone, the
// two start a tile together and stay in step, both issuing, then both in
// their epilogues. Warpgroup 1 passes the first turn before its first tile;
// warpgroup 0 takes one more turn after its last.
constexpr int BAR_TURN0 = BAR_WG0 + CONSUMERS;

__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(BAR_TURN0 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(BAR_TURN0 + 1 - wg) : "memory");
}

// acc = this warpgroup's rows of A @ W over CHUNKS chunks from g: A's k-atom
// c at a + c * 16 KB (rows already offset), KSTEPS 32-deep steps a chunk (4;
// layer 0: 2, the encoding's 64 lanes). One chunk's products stay in flight
// while the next chunk's issue. (Every count is a constant: a wgmma under a
// runtime condition makes ptxas serialize the pipeline.)
template <int S, int CHUNKS, int KSTEPS>
__device__ __forceinline__ void i8_products(int (&acc)[128], uint32_t a, uint32_t ring,
                                            uint32_t bars, uint32_t& g, int wg, bool signal) {
  turn_wait(wg);
#pragma unroll 1
  for (int c = 0; c < CHUNKS; ++c, ++g) {
    const uint32_t b = ring_acquire<S>(ring, bars, g);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      wgmma_m64n256_s8(acc, desc_sw128(a + c * TILE_ATOM_BYTES + kk * 32),
                       desc_sw128(b + kk * 32), (c | kk) != 0);
    }
    wgmma_commit();
    if (c == CHUNKS - 1) turn_pass(wg);
    if (c > 0) {
      wgmma_wait<1>();
      ring_release<S>(bars, g - 1, signal);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring_release<S>(bars, g - 1, signal);
}

// layer 5's half of 128 columns, two products on acc[0..63]: e = qemb @
// qw5e[:, half] (chunk g), kept as the f32 bits of f32(e) * d5e in
// acc[64..127] (epi_e: d5e's row of the parameters), then a = q5 @ qw5h[:,
// half] (chunk g + 1: two k-atoms of 128 rows). Each product takes its own
// turn at the tensor cores.
template <int S>
__device__ __forceinline__ void i8_skip_products(int (&acc)[128], uint32_t q5, uint32_t embt,
                                                 uint32_t epi_e, int half, uint32_t ring,
                                                 uint32_t bars, uint32_t& g, int wg, int t) {
  const bool signal = t == 0;
  turn_wait(wg);
  uint32_t b = ring_acquire<S>(ring, bars, g);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < EMB / 32; ++kk) {
    wgmma_m64n128_s8(acc, desc_sw128(embt + kk * 32), desc_sw128(b + kk * 32), kk != 0);
  }
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_acc(acc);
  ring_release<S>(bars, g, signal);
  epi_e += (half * (NW / 4) + t % 4) * 16;
  float4 next[2] = {ld_shared16f(epi_e), ld_shared16f(epi_e + 64)};
#pragma unroll
  for (int j = 0; j < NW / 16; ++j) {
    const float4 pe = next[j % 2];
    if (j + 2 < NW / 16) next[j % 2] = ld_shared16f(epi_e + (j + 2) * 64);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      acc[64 + i] = __float_as_int(__fmul_rn(__int2float_rn(acc[i]), pe.x));
      acc[64 + i + 1] = __float_as_int(__fmul_rn(__int2float_rn(acc[i + 1]), pe.y));
    }
  }
  turn_wait(wg);
  b = ring_acquire<S>(ring, bars, g + 1);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NW / I8_K; ++c) {
#pragma unroll
    for (int kk = 0; kk < I8_K / 32; ++kk) {
      wgmma_m64n128_s8(acc, desc_sw128(q5 + c * TILE_ATOM_BYTES + kk * 32),
                       desc_sw128(b + c * I8_HALF_BYTES + kk * 32), (c | kk) != 0);
    }
  }
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_acc(acc);
  ring_release<S>(bars, g + 1, signal);
  g += 2;
}

// The epilogue from the accumulator layout (thread t of the warpgroup holds
// rows w*16 + t%32/4 (+8) and columns 8j + 2(t%4) (+1), acc[4j + 2h + e]):
// q = requant(f32(acc) * d + b, m) into this warpgroup's rows of the int8
// tile `dst`, which the layer's products have finished reading.
__device__ __forceinline__ void i8_epilogue(const int (&acc)[128], uint32_t epi, float m,
                                            unsigned char* dst, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
  epi += (lane % 4) * 16;
  float4 next[2] = {ld_shared16f(epi), ld_shared16f(epi + 64)};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    const float4 p = next[j % 2];
    if (j + 2 < NW / 8) next[j % 2] = ld_shared16f(epi + (j + 2) * 64);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), p.x), p.z);
      const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), p.y), p.w);
      *reinterpret_cast<uint16_t*>(dst + i8_offset(r0 + 8 * h, col)) =
          uint16_t(__byte_perm(uint32_t(requant(v0, m)), uint32_t(requant(v1, m)), 0x0040));
    }
  }
}

// layer 5's half: q6 = requant((f32(a) * d5h + f32(e) * d5e) + b5, m) for
// columns half * 128 .. + 127 (a = acc[0..63], f32(e) * d5e in acc[64..])
__device__ __forceinline__ void i8_skip_epilogue(const int (&acc)[128], uint32_t epi, float m,
                                                 int half, unsigned char* dst, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
  epi += (half * (NW / 4) + lane % 4) * 16;
  float4 next[2] = {ld_shared16f(epi), ld_shared16f(epi + 64)};
#pragma unroll
  for (int j = 0; j < NW / 16; ++j) {
    const int col = half * (NW / 2) + j * 8 + (lane % 4) * 2;
    const float4 p = next[j % 2];
    if (j + 2 < NW / 16) next[j % 2] = ld_shared16f(epi + (j + 2) * 64);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      const float v0 = __fadd_rn(
          __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), p.x), __int_as_float(acc[64 + i])), p.z);
      const float v1 = __fadd_rn(
          __fadd_rn(__fmul_rn(__int2float_rn(acc[i + 1]), p.y), __int_as_float(acc[64 + i + 1])),
          p.w);
      *reinterpret_cast<uint16_t*>(dst + i8_offset(r0 + 8 * h, col)) =
          uint16_t(__byte_perm(uint32_t(requant(v0, m)), uint32_t(requant(v1, m)), 0x0040));
    }
  }
}

// h8 = bf16(relu(f32(acc) * d7 + b7)) into this warpgroup's rows of the bf16
// tile laid over both int8 tiles (row 1's layout)
__device__ __forceinline__ void i8_h8_epilogue(const int (&acc)[128], uint32_t epi,
                                               unsigned char* act, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
  epi += (lane % 4) * 16;
  float4 next[2] = {ld_shared16f(epi), ld_shared16f(epi + 64)};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    const float4 p = next[j % 2];
    if (j + 2 < NW / 8) next[j % 2] = ld_shared16f(epi + (j + 2) * 64);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), p.x), p.z);
      const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), p.y), p.w);
      *reinterpret_cast<__nv_bfloat162*>(act + tile_offset(r0 + 8 * h, col)) =
          __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    }
  }
}

// ow^T (8 x 256 bf16) as the K-major B operand of the head: 4 k-atoms of 8
// rows in the 128-byte swizzle, element (o, k) at (k / 64) * 1 KB + o * 128
// + (((k / 8) % 8) ^ o) * 16 + (k % 8) * 2. Thread k (of 256) writes column
// k of it from row k of ow.
__device__ __forceinline__ void load_owt(unsigned char* owt, const bf16* __restrict__ ow, int k) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(ow + k * OUT));
  const bf16* e = reinterpret_cast<const bf16*>(&w);
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    *reinterpret_cast<bf16*>(owt + (k / 64) * (8 * ATOM_ROW_BYTES) + o * ATOM_ROW_BYTES +
                             ((((k / 8) % 8) ^ o) << 4) + (k % 8) * 2) = e[o];
  }
}

// raw = h8 @ ow + ob for this warpgroup's 64 rows: 16 m64n8k16 on its rows of
// the bf16 h8 tile (the f32 sums in the tensor cores' order), then the bias
// and the store of rows below n (thread t holds rows w*16 + t%32/4 (+8),
// lanes 2(t%4) (+1))
__device__ __forceinline__ void i8_head(uint32_t h8_rows, uint32_t owt, const float* __restrict__ ob,
                                        float* __restrict__ out, long row0, int n, int wg,
                                        int t) {
  float h[4];
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < NW / 64; ++q) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n8(h, desc_sw128(h8_rows + q * TILE_ATOM_BYTES + kk * 32),
                  desc_sw128(owt + q * 8 * ATOM_ROW_BYTES + kk * 32), (q | kk) != 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(h);
  const int lane = t % 32;
  const int c = (lane % 4) * 2;
  const long r = row0 + wg * WG_ROWS + (t / 32) * 16 + lane / 4;
  const float2 b = __ldg(reinterpret_cast<const float2*>(ob + c));
  if (r < n) {
    *reinterpret_cast<float2*>(out + size_t(r) * OUT + c) = make_float2(h[0] + b.x, h[1] + b.y);
  }
  if (r + 8 < n) {
    *reinterpret_cast<float2*>(out + size_t(r + 8) * OUT + c) =
        make_float2(h[2] + b.x, h[3] + b.y);
  }
}

// Persistent CTAs walk 128-point tiles. Per tile, a consumer warpgroup waits
// for the tile's int8 encoding, runs q1 .. q5 in tile 0 (in place), layer 5
// in two halves into tile 1, q7 in tile 1 (in place), h8 as a bf16 tile over
// both, and the head; it releases the encoding tile once layer 5 has read it.
__global__ void __launch_bounds__(THREADS, 1)
mlp_i8_kernel(const bf16* __restrict__ emb, int n, int n_tiles, const void* __restrict__ image,
              I8Args p, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align_smem(smem_raw);   // tile 0, tile 1 (or h8, bf16)
  unsigned char* act1 = act + I8_TILE_BYTES;
  const uint32_t act_s = smem_u32(act);
  const uint32_t emb0 = act_s + 2 * I8_TILE_BYTES;   // two int8 encoding tiles
  const uint32_t ring = emb0 + 2 * I8_EMB_BYTES;
  unsigned char* owt = act + 2 * I8_TILE_BYTES + 2 * I8_EMB_BYTES + I8_STAGES * CHUNK_BYTES;
  const uint32_t epi = smem_u32(owt) + OWT_BYTES;        // the epilogues' parameters
  const uint32_t bars = epi + EPI_ROWS * EPI_ROW_BYTES;
  const uint32_t enc_bars = bars + 2 * 8 * I8_STAGES;   // full[0], full[1], empty[0], empty[1]
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    ring_init<I8_STAGES>(bars);
    for (int b = 0; b < 2; ++b) {
      mbar_init(enc_bars + 8 * b, ENCODERS);
      mbar_init(enc_bars + 8 * (2 + b), CONSUMERS);
    }
    mbar_init_fence();
  }
  if (threadIdx.x < NW) load_owt(owt, p.ow, threadIdx.x);
  for (int i = threadIdx.x; i < EPI_ROWS * NW / 2; i += THREADS) {
    st_shared16(epi + i * 16, __ldg(reinterpret_cast<const uint4*>(p.epi) + i));
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      produce<I8_STAGES>(image, I8_CHUNKS, n_tiles, ring, bars, [](int c) {
        return c == I8_SKIP || c == I8_SKIP + 2 ? I8_HALF_BYTES : CHUNK_BYTES;
      });
    } else if (t >= 32) {
      quantize_encodings(emb, __ldg(p.qm), emb0, enc_bars, n, n_tiles, t - 32);
    }
  } else {                 // a consumer: 64 rows of every tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const uint32_t rows = uint32_t(wg) * WG_ROWS * ATOM_ROW_BYTES;
    const bool signal = t == 0;
    int acc[128];
    uint32_t g = 0;
    int i = 0;
    if (wg == 1) turn_pass(wg);   // warpgroup 0 issues first
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const long row0 = long(tile) * TM;
      const uint32_t embt = emb0 + uint32_t(i % 2) * I8_EMB_BYTES + rows;
      mbar_wait(enc_bars + 8 * (i % 2), (i / 2) & 1);   // the encoding is in its tile
      fence_proxy_async();
      wg_barrier(wg);   // ... and the last tile's head is done
      // one copy of each epilogue in the code: the layers are a rolled loop
#pragma unroll 1
      for (int layer = 0; layer < N_LAYERS; ++layer) {
        if (layer == 5) {
#pragma unroll 1
          for (int half = 0; half < 2; ++half) {
            i8_skip_products<I8_STAGES>(acc, act_s + rows, embt, epi + 8 * EPI_ROW_BYTES, half,
                                        ring, bars, g, wg, t);
            if (half == 1 && signal) mbar_arrive(enc_bars + 8 * (2 + i % 2));
            i8_skip_epilogue(acc, epi + 5 * EPI_ROW_BYTES, __ldg(p.qm + 6), half, act1, wg, t);
          }
        } else {
          // the layer's A: the encoding (64 lanes), or tile 0 (q1 .. q4), or
          // tile 1 (q6, q7)
          if (layer == 0) {
            i8_products<I8_STAGES, 1, EMB / 32>(acc, embt, ring, bars, g, wg, signal);
          } else {
            i8_products<I8_STAGES, NW / I8_K, I8_K / 32>(
                acc, act_s + (layer > 5 ? I8_TILE_BYTES : 0) + rows, ring, bars, g, wg, signal);
          }
          if (layer == N_LAYERS - 1) {
            i8_h8_epilogue(acc, epi + layer * EPI_ROW_BYTES, act, wg, t);
          } else {
            i8_epilogue(acc, epi + layer * EPI_ROW_BYTES, __ldg(p.qm + layer + 1),
                        layer > 5 ? act1 : act, wg, t);
          }
        }
        fence_proxy_async();
        wg_barrier(wg);
      }
      i8_head(act_s + rows, smem_u32(owt), p.ob, out, row0, n, wg, t);
    }
    if (wg == 0) turn_wait(wg);   // warpgroup 1's last pass
  }
}

}  // namespace
}  // namespace sm90

// emb (n, 64) bf16, out (n, 8) f32;
// image: the int8 chain's 17 chunks, 32 KB apart (ops/kernels/mlp_sm90.py:
//   pack_i8_image, from qw0, qw1..qw4, qw5e, qw5h, qw6, qw7);
// epi: (9, 128, 4) f32 (mlp_sm90.py:pack_i8_epilogue): for layers 0..7 and
//   each column pair (d, d', b, b') with d5h in layer 5's; then (d5e, d5e', 0, 0);
// ow (256x8) bf16, ob (8 f32), qm (16 f32).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlp_i8(const void* emb, int n, const void* image, const void* epi,
                             const void* ow, const void* ob, const void* qm, void* out,
                             void* stream) {
  sm90::I8Args p;
  p.epi = static_cast<const float4*>(epi);
  p.qm = static_cast<const float*>(qm);
  p.ow = static_cast<const sm90::bf16*>(ow);
  p.ob = static_cast<const float*>(ob);
  cudaError_t err = cudaFuncSetAttribute(sm90::mlp_i8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sm90::I8_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const int n_tiles = (n + sm90::TM - 1) / sm90::TM;
  sm90::mlp_i8_kernel<<<sm90::persistent_grid(n_tiles), sm90::THREADS, sm90::I8_SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sm90::bf16*>(emb), n, n_tiles, image, p, static_cast<float*>(out));
  return int(cudaGetLastError());
}
