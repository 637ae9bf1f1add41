// Canonical NeRF MLP forward in int8 (8 x 256, skip at layer 4), inference
// only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mlp_i8_core` / `_i8_fwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/quant_mlp.py:238-257), whose math is
// `_i8_fwd_math` (quant_mlp.py:198-235):
//
//   qemb = int8(round(clip(emb * qm[0], -127, 127)))          (symmetric)
//   h1   = relu(f32(qemb @ qw0) * d0 + b0)
//   q_l  = int8(round(clip(h_l * qm[l], 0, 254)) - 127)       (zero-point -127)
//   h_l+1 = relu(f32(q_l @ qw_l) * d_l + b_l)                 l = 1..4, 6, 7
//   h6   = relu(f32(q5 @ qw5h) * d5h + f32(qemb @ qw5e) * d5e + b5)
//   raw  = bf16(h8) @ owb + ob                                (f32, 8 lanes)
//
// int8 x int8 products accumulate in int32 (exact: at most 256 * 127 * 127 <
// 2^24, so the conversion to f32 is exact too). d_l are per-output-channel
// dequantization rows with the previous layer's activation step folded in,
// b_l the biases with the zero-point correction folded in, qm the nine
// quantization multipliers. The rounding is to nearest even (rintf), after
// the clip, before the shift by 127.
//
// The epilogue multiplies and adds with __fmul_rn / __fadd_rn, never a fused
// multiply-add, in the order of the formula above: every layer up to h8 is
// then bit-equal to the plain PyTorch version, and only the order of the f32
// sums of the bf16 head differs.
//
// What bounds it: 493,568 MACs per point = 0.987 MOP, 160 bytes of HBM
// traffic per point (128 B of bf16 encoding in, 32 B of raw out): the tensor
// cores bound it, at the card's int8 rate.
//
// Design (simple and correct first):
// - one CTA of 8 warps owns 128 points for all layers; each warp owns a
//   64 x 64 block of a layer's 128 x 256 output as 4 x 8 tiles of 16 x 8
//   int32 accumulators. The products are `mma.sync.m16n8k32` on s8 operands,
//   written as PTX: the 32-deep instruction is the one that runs at the int8
//   rate (nvcuda::wmma offers int8 only 16 deep, at the bf16 instruction
//   rate);
// - the int8 activation tile (128 x 256, 32 KB) and the int8 encoding tile
//   (128 x 64, kept for layer 0 and for the skip) stay in shared memory. Both
//   are stored in blocks of 16 k-values, [k / 16][row][16], and so is a weight
//   chunk, [k / 16][output column][16]: a thread's four consecutive k-values
//   of either operand are one aligned 32-bit word, which is how the
//   instruction takes them, and the 8 rows (or columns) that a warp reads at
//   once are 128 contiguous bytes, so no bank is hit twice;
// - for that the weights come TRANSPOSED, (out, in) with the k-values of an
//   output column contiguous (the wrapper transposes the packed (in, out)
//   matrices; cp.async moves 16-byte pieces and cannot). They are 0.49 MB in
//   all, L2-resident, and stream through mlp_tile.cuh's cp.async ring in
//   chunks of 64 k-values (16 KB), one schedule of 30 chunks across all
//   layers;
// - a layer's epilogue works on the accumulators where they are (a thread
//   holds two neighbouring columns of two rows of each tile): it dequantizes,
//   adds the bias, applies ReLU, requantizes and overwrites the activation
//   tile in place, two int8 values per store (after a barrier: the
//   accumulators live in registers);
// - layer 5 sums two integer products with different dequantization rows, so
//   they cannot be added as integers, and a second set of accumulators does
//   not fit the registers. The 64-deep product of the skip is one chunk, the
//   last of layer 5's schedule: it is not accumulated in the main loop but
//   stays in its stage through the epilogue, where each 16 x 8 tile of it is
//   formed (2 instructions) right before that tile is dequantized;
// - h8 is written as a bf16 tile and the 8-lane head is mlp_tile.cuh's
//   per-thread dot product;
// - rows past n are zero-filled on load and masked on store. No atomics.
//
// Plain C interface, bound with ctypes (see ../quant_mlp.py).

#include "mlp_tile.cuh"

namespace {

using i8 = signed char;

constexpr int BLK = 16;                     // bytes of one blocked row
constexpr int N_MATS = 9;                   // n0w n1w..n4w n5e n5h n6w n7w
constexpr int SKIP_LAYER = 5;
constexpr int G_SKIP = 1 + 4 * 4 + 4;       // the skip's chunk in the schedule
constexpr int MT = 4;                       // 16-row tiles of a warp's block
constexpr int NT = 8;                       // 8-column tiles of a warp's block
constexpr size_t Q_BYTES = size_t(TM) * NW;          // int8 activations
constexpr size_t QEMB_BYTES = size_t(TM) * EMB;      // int8 encoding
constexpr size_t QSTAGE_BYTES = size_t(KC) * NW;     // one int8 weight chunk
constexpr size_t SMEM_BYTES = ACT_BYTES + Q_BYTES + QEMB_BYTES + 2 * QSTAGE_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");
static_assert(ACT_BYTES % 128 == 0 && Q_BYTES % 128 == 0 && QEMB_BYTES % 128 == 0 &&
                  QSTAGE_BYTES % 128 == 0,
              "shared-memory regions stay aligned");

struct I8Params {
  const i8* chunk[N_FWD_CHUNKS];   // source of each chunk of 64 k-values
  const float* deq[N_MATS];        // (256,) f32 dequantization row per matrix
  const float* bias[N_LAYERS];     // (256,) f32 folded bias per hidden layer
  const bf16* ow;                  // (256, 8) bf16
  const float* ob;                 // (8,) f32
  const float* qm;                 // (16,) f32: 127/s_emb, 254/s_1 .. 254/s_8
};

// 64 k-values of all 256 output columns of a transposed int8 matrix (row
// stride `ldk`: the matrix's depth, 64 or 256) into a stage, blocked by 16
// k-values: 1024 16-byte pieces, 4 per thread
__device__ __forceinline__ void load_chunk_i8(i8* dst, const i8* src, int ldk, int tid) {
#pragma unroll
  for (int i = tid; i < KC * NW / BLK; i += THREADS) {
    const int col = i / (KC / BLK);
    const int kb = i % (KC / BLK);
    cp_async16(dst + (kb * NW + col) * BLK, src + col * ldk + kb * BLK);
  }
}

// d (16 x 8, s32) += a (16 x 32, s8, row) @ b (32 x 8, s8, col). With
// gid = lane / 4 and tig = lane % 4 a thread holds
//   a[0]: row gid, k tig*4..+3    a[1]: row gid + 8, same k
//   a[2], a[3]: the same rows, k + 16
//   b[0]: k tig*4..+3, column gid    b[1]: k + 16
//   d[0], d[1]: row gid, columns tig*2, tig*2 + 1    d[2], d[3]: row gid + 8
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the A operand of rows row .. and row + 8 .., k-values 32 * ks .. + 32, from a
// tile blocked by 16 k-values
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4], const i8* tile, int row,
                                          int ks, int tig) {
  const i8* lo = tile + ((2 * ks) * TM + row) * BLK + tig * 4;
  const i8* hi = lo + TM * BLK;
  a[0] = *reinterpret_cast<const uint32_t*>(lo);
  a[1] = *reinterpret_cast<const uint32_t*>(lo + 8 * BLK);
  a[2] = *reinterpret_cast<const uint32_t*>(hi);
  a[3] = *reinterpret_cast<const uint32_t*>(hi + 8 * BLK);
}

// the B operand of output column col, k-values 32 * ks .. + 32 of a staged chunk
__device__ __forceinline__ void load_b_s8(uint32_t (&b)[2], const i8* chunk, int col,
                                          int ks, int tig) {
  const i8* lo = chunk + ((2 * ks) * NW + col) * BLK + tig * 4;
  b[0] = *reinterpret_cast<const uint32_t*>(lo);
  b[1] = *reinterpret_cast<const uint32_t*>(lo + NW * BLK);
}

// acc (this warp's 64 x 64 block: rows wm*64, cols wn*64) +=
//   A[:, k0 : k0 + 64] @ (the staged chunk)
__device__ __forceinline__ void mma_chunk_i8(int (&acc)[MT][NT][4], const i8* a_src,
                                             int k0, const i8* b_src, int wm, int wn,
                                             int lane) {
  const int gid = lane / 4;
  const int tig = lane % 4;
#pragma unroll
  for (int ks = 0; ks < KC / 32; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      load_a_s8(a[i], a_src, wm * 64 + i * 16 + gid, k0 / 32 + ks, tig);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[2];
      load_b_s8(b, b_src, wn * 64 + j * 8 + gid, ks, tig);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b);
    }
  }
}

// A layer's epilogue for this warp's 64 x 64 block:
//   h = relu(f32(acc) * d + [f32(qemb @ skip_w) * skip_d] + b)
// then, with `qdst`, q = int8(rint(clip(h * m, 0, 254)) - 127) into the
// blocked activation tile, else bf16(h) into the tile `hdst`. `skip_w`: the
// staged chunk of the skip's weight, or nullptr. All reads of `qdst` by the
// layer's products must have finished (a barrier) before.
__device__ __forceinline__ void store_layer_i8(int (&acc)[MT][NT][4],
                                               const float* __restrict__ d,
                                               const float* __restrict__ bias,
                                               const i8* qemb, const i8* skip_w,
                                               const float* __restrict__ skip_d,
                                               float m, i8* qdst, bf16* hdst, int wm,
                                               int wn, int lane) {
  const int gid = lane / 4;
  const int tig = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn * 64 + j * 8 + tig * 2;   // this thread's two columns
    const float d0 = __ldg(d + col), d1 = __ldg(d + col + 1);
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
    float e0 = 0.0f, e1 = 0.0f;
    if (skip_w != nullptr) {
      e0 = __ldg(skip_d + col);
      e1 = __ldg(skip_d + col + 1);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      int acc_e[4] = {0, 0, 0, 0};
      if (skip_w != nullptr) {
#pragma unroll
        for (int ks = 0; ks < EMB / 32; ++ks) {
          uint32_t a[4], b[2];
          load_a_s8(a, qemb, wm * 64 + i * 16 + gid, ks, tig);
          load_b_s8(b, skip_w, wn * 64 + j * 8 + gid, ks, tig);
          mma_s8(acc_e, a, b);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {     // rows gid and gid + 8
        const int row = wm * 64 + i * 16 + gid + half * 8;
        float v0 = __fmul_rn(float(acc[i][j][half * 2]), d0);
        float v1 = __fmul_rn(float(acc[i][j][half * 2 + 1]), d1);
        if (skip_w != nullptr) {
          v0 = __fadd_rn(v0, __fmul_rn(float(acc_e[half * 2]), e0));
          v1 = __fadd_rn(v1, __fmul_rn(float(acc_e[half * 2 + 1]), e1));
        }
        const float h0 = fmaxf(__fadd_rn(v0, b0), 0.0f);
        const float h1 = fmaxf(__fadd_rn(v1, b1), 0.0f);
        if (qdst != nullptr) {
          const int q0 = int(rintf(fminf(fmaxf(__fmul_rn(h0, m), 0.0f), 254.0f))) - 127;
          const int q1 = int(rintf(fminf(fmaxf(__fmul_rn(h1, m), 0.0f), 254.0f))) - 127;
          *reinterpret_cast<uint16_t*>(qdst + ((col / 16) * TM + row) * BLK + col % 16) =
              uint16_t((q0 & 0xff) | ((q1 & 0xff) << 8));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(hdst + row * LDA + col) =
              __halves2bfloat162(__float2bfloat16(h0), __float2bfloat16(h1));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mlp_i8_kernel(const bf16* __restrict__ emb, int n, I8Params p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h8 = reinterpret_cast<bf16*>(smem);
  i8* q = reinterpret_cast<i8*>(smem + ACT_BYTES);
  i8* qemb = q + Q_BYTES;
  i8* stage = qemb + QEMB_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;   // rows wm*64 .. +64
  const int wn = warp % 4;   // cols wn*64 .. +64
  const long row0 = long(blockIdx.x) * TM;

  auto stage_i8 = [&](int g) { return stage + (g & 1) * QSTAGE_BYTES; };
  auto prefetch = [&](int g) {
    if (g >= N_FWD_CHUNKS) return;
    // the two products on the encoding are 64 deep, all others 256
    load_chunk_i8(stage_i8(g), p.chunk[g], (g == 0 || g == G_SKIP) ? EMB : NW, tid);
  };
  prefetch(0);
  cp_async_commit();

  // qemb = int8(rint(clip(emb * qm[0], -127, 127))), blocked; rows past n zero
  {
    const float m0 = __ldg(p.qm);
    for (int i = tid; i < TM * EMB / 8; i += THREADS) {
      const int r = i / (EMB / 8);
      const int c0 = (i % (EMB / 8)) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row0 + r < n) {
        raw = *reinterpret_cast<const uint4*>(emb + size_t(row0 + r) * EMB + c0);
      }
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      __align__(8) i8 ov[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float t = __fmul_rn(__bfloat162float(x[e]), m0);
        ov[e] = i8(int(rintf(fminf(fmaxf(t, -127.0f), 127.0f))));
      }
      *reinterpret_cast<uint2*>(qemb + ((c0 / 16) * TM + r) * BLK + c0 % 16) =
          *reinterpret_cast<const uint2*>(ov);
    }
  }

  int acc[MT][NT][4];
  int g = 0;
  for (int layer = 0; layer < N_LAYERS; ++layer) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    const int n_chunks = layer == 0 ? 1 : NW / KC;
    for (int c = 0; c < n_chunks; ++c, ++g) {
      ring_next(prefetch, g);   // its barrier also covers qemb's stores
      mma_chunk_i8(acc, layer == 0 ? qemb : q, c * KC, stage_i8(g), wm, wn, lane);
      __syncthreads();          // all reads of this stage and of q are done
    }
    const i8* skip_w = nullptr;
    if (layer == SKIP_LAYER) {
      // the skip's chunk: it lands now and stays through the epilogue; the
      // next prefetch into its stage comes after the epilogue's barrier
      ring_next(prefetch, g);
      skip_w = stage_i8(g);
      ++g;
    }
    const bool last = layer == N_LAYERS - 1;
    // deq[] follows the order of the matrices: d5e sits before d5h
    store_layer_i8(acc, p.deq[layer < SKIP_LAYER ? layer : layer + 1],
                   p.bias[layer], qemb, skip_w, p.deq[SKIP_LAYER],
                   last ? 0.0f : __ldg(p.qm + layer + 1),
                   last ? nullptr : q, h8, wm, wn, lane);
    __syncthreads();
  }

  // head: raw = bf16(h8) @ owb + ob, in f32
  raw_head(h8, p.ow, p.ob, out, row0, n, tid);
}

}  // namespace

// emb (n, 64) bf16, out (n, 8) f32.
// mats: the int8 matrices TRANSPOSED, row-major (out, in): qw0 (256x64),
//       qw1..qw4 (256x256), qw5e (256x64), qw5h, qw6, qw7 (256x256);
// deqs: their dequantization rows d0, d1..d4, d5e, d5h, d6, d7 (256 f32 each);
// biases: b0..b4, b5, b6, b7 (256 f32 each, zero-point correction folded in);
// ow (256x8) bf16, ob (8 f32), qm (16 f32).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlp_i8(const void* emb, int n, const void* const* mats,
                             const void* const* deqs, const void* const* biases,
                             const void* ow, const void* ob, const void* qm,
                             void* out, void* stream) {
  I8Params p;
  const i8* m[N_MATS];
  for (int i = 0; i < N_MATS; ++i) {
    m[i] = static_cast<const i8*>(mats[i]);
    p.deq[i] = static_cast<const float*>(deqs[i]);
  }
  // the schedule: qw0; qw1..qw4; qw5h, then qw5e; qw6, qw7. A chunk of a
  // transposed matrix is a range of 64 columns.
  int g = 0;
  p.chunk[g++] = m[0];
  const int deep[7] = {1, 2, 3, 4, 6, 7, 8};
  for (int d = 0; d < 7; ++d) {
    for (int c = 0; c < NW / KC; ++c) p.chunk[g++] = m[deep[d]] + c * KC;
    if (deep[d] == 6) p.chunk[g++] = m[5];
  }
  if (g != N_FWD_CHUNKS || p.chunk[G_SKIP] != m[5]) return int(cudaErrorInvalidValue);
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = static_cast<const bf16*>(ow);
  p.ob = static_cast<const float*>(ob);
  p.qm = static_cast<const float*>(qm);

  cudaError_t err = cudaFuncSetAttribute(
      mlp_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const dim3 grid((n + TM - 1) / TM);
  mlp_i8_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(emb), n, p, static_cast<float*>(out));
  return int(cudaGetLastError());
}
