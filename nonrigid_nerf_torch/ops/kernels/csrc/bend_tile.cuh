// Shared device code of the deformation kernels for Hopper (sm_90a):
// bend_fwd.cu, bend_bwd.cu and fused_bwd.cu. The split (bend_fwd + mlp_fwd,
// mlp_bwd + bend_bwd) and the monolith's backward (fused_bwd) run this same
// code for the bender; the monolith's forward (fused_fwd.cu) runs the same
// arithmetic in registers on mlp_sm90.cuh (`FusedFwdIn`). So their results
// agree bit for bit on the card, as the JAX package holds its two variants
// (tests/test_fused_kernel.py:397-419).
//
// The math, per point, of the flagship deformation field (bending 5 x 64 with
// ReLU on [pts, latent], rigidity 3 x 32 on pts, latent 32), as
// `_bend_fwd_math` (nonrigid_nerf_tpu/ops/pallas/fused_query.py:511-530):
//
//   bh0  = bf16(relu(pts @ b0p + lat @ b0l + b0b))      (bf16 inputs, f32 sums)
//   bh_l = bf16(relu(bh_{l-1} @ b_lw + b_lb))           l = 1 .. 3
//   off  = bh3 @ bow                                     (f32, no bias)
//   rh0  = bf16(relu(pts @ r0w + r0b)),  rh1 = bf16(relu(rh0 @ r1w + r1b))
//   t    = tanh(rh1 @ row + rob),  rig = (t + 1) * 0.5
//   bent = pts + rig[0] * off                            (two f32 roundings)
//   emb  = mlp_tile.cuh's encoding of bent (multires 10)
//
// and its backward, `_bend_bwd_kernel` (fused_query.py:542-627): the
// encoding's gradient is folded onto the three coordinates (dbent), then
//   doff_total = dbent * rig0 + doff,  drig0 = sum(dbent * off)
//   drig_raw   = (drig + drig0) * 0.5 * (1 - t * t)
// and the rigidity and bending chains run back with bf16 cotangents (cast
// where the JAX math casts them: inside each product) and f32 bias sums.
//
// Shapes. One CTA of 8 warps owns 128-point tiles; warp w owns rows
// w*16 .. +16 of every activation tile, so a layer may overwrite its own
// input. Products with 32 or 64 inner lanes run on the tensor cores (wmma
// 16x16x16 bf16, f32 accumulators); the products with 3 inner or 3 outer
// lanes (pts @ b0p, pts @ r0w, bh3 @ bow, rh1 @ row and their transposes) run
// on the CUDA cores, reading those small weights from global memory (L1).
// The 64-lane weights (b0l, b1w..b3w) are read from global memory too.
//
// The weight gradients are summed over the points with no atomics:
// `bend_bwd_kernel` walks a split of BEND_SPLIT_TILES tiles, adds each tile's
// products into an f32 accumulator of all 16 gradients in shared memory
// (tensor-core fragments loaded, advanced and stored back), writes it to its
// split's slot of a partials buffer, and `mlp_reduce_kernel` sums the slots in
// ascending order. Chosen over the canonical MLP's split-K second pass
// (mlp_sm90.cuh) because the bender's activations are narrow (64 lanes): storing them and
// their gradients (1.2 KB per point) would cost more HBM traffic than
// recomputing the bender, which is 3% of the chain's work. The same inputs
// give bit-equal outputs.

#pragma once

#include "mlp_tile.cuh"

namespace {

constexpr int BW = 64;        // bending hidden width
constexpr int RW = 32;        // rigidity hidden width
constexpr int LAT = 32;       // latent size
constexpr int WPAD = 8;       // padded lanes of the packed 3- and 1-lane weights
constexpr int LDBH = BW + 8;  // shared-memory row strides (halves)
constexpr int LDR = RW + 8;
constexpr int LDL = LAT + 8;
constexpr int BEND_SPLIT_TILES = 4;   // tiles per CTA of the backward
constexpr int BEND_SPLIT_ROWS = BEND_SPLIT_TILES * TM;

// offsets (in floats) of the 16 gradients in one flat pack-order buffer:
// b0p b0l b0b b1w b1b b2w b2b b3w b3b bow r0w r0b r1w r1b row rob
constexpr int G_B0P = 0;
constexpr int G_B0L = G_B0P + WPAD * BW;
constexpr int G_B0B = G_B0L + LAT * BW;
constexpr int G_B1W = G_B0B + BW;
constexpr int G_B1B = G_B1W + BW * BW;
constexpr int G_B2W = G_B1B + BW;
constexpr int G_B2B = G_B2W + BW * BW;
constexpr int G_B3W = G_B2B + BW;
constexpr int G_B3B = G_B3W + BW * BW;
constexpr int G_BOW = G_B3B + BW;
constexpr int G_R0W = G_BOW + BW * WPAD;
constexpr int G_R0B = G_R0W + WPAD * RW;
constexpr int G_R1W = G_R0B + RW;
constexpr int G_R1B = G_R1W + RW * RW;
constexpr int G_ROW = G_R1B + RW;
constexpr int G_ROB = G_ROW + RW * WPAD;
constexpr int BEND_GRAD_FLOATS = G_ROB + WPAD;
static_assert(BEND_GRAD_FLOATS == 17224, "pack-order layout");
static_assert(G_B0L % 8 == 0 && G_B1W % 8 == 0 && G_B2W % 8 == 0 &&
              G_B3W % 8 == 0 && G_R1W % 8 == 0,
              "fragment accumulators stay 32-byte aligned");

struct BendParams {
  // bf16, row-major (in, out), as packed: b0p (8, 64), b0l (32, 64),
  // b1w b2w b3w (64, 64), bow (64, 8), r0w (8, 32), r1w (32, 32), row (32, 8)
  const bf16* b0p;
  const bf16* b0l;
  const bf16* bw[3];
  const bf16* bow;
  const bf16* r0w;
  const bf16* r1w;
  const bf16* row;
  // f32: b0b b1b b2b b3b (64), r0b r1b (32), rob (8)
  const float* bb[4];
  const float* r0b;
  const float* r1b;
  const float* rob;
};

// mats: b0p, b0l, b1w, b2w, b3w, bow, r0w, r1w, row (bf16);
// biases: b0b, b1b, b2b, b3b, r0b, r1b, rob (f32)
inline BendParams fill_bend_params(const void* const* mats, const void* const* biases) {
  BendParams p;
  auto m = [&](int i) { return static_cast<const bf16*>(mats[i]); };
  auto b = [&](int i) { return static_cast<const float*>(biases[i]); };
  p.b0p = m(0);
  p.b0l = m(1);
  for (int i = 0; i < 3; ++i) p.bw[i] = m(2 + i);
  p.bow = m(5);
  p.r0w = m(6);
  p.r1w = m(7);
  p.row = m(8);
  for (int i = 0; i < 4; ++i) p.bb[i] = b(i);
  p.r0b = b(4);
  p.r1b = b(5);
  p.rob = b(6);
  return p;
}

// The bender's shared-memory tiles of one 128-point tile, and where its
// 64-lane weights are read (global memory, row stride ldw). A forward-only
// kernel may point bh[0..3] at one tile and rh[0..1] at another: each layer
// then overwrites its input.
struct BendTile {
  float* xs;       // 128 x 3 f32 points (rows past n zero)
  bf16* lat;       // 128 x LDL bf16 latents
  bf16* bh[4];     // 128 x LDBH bf16 each
  bf16* rh[2];     // 128 x LDR bf16 each
  float* off;      // 128 x 3 f32 unmasked offsets
  float* tanh_rr;  // 128 f32: tanh of the rigidity's raw output
  float* rig0;     // 128 f32 rigidity
  float* bent;     // 128 x 3 f32 bent points
  const bf16* b0l;
  const bf16* bw[3];
  int ldw;
};

constexpr size_t pad128(size_t b) { return (b + 127) / 128 * 128; }
constexpr size_t XS_BYTES = pad128(size_t(TM) * PTS * sizeof(float));
constexpr size_t ROWF_BYTES = pad128(size_t(TM) * sizeof(float));
constexpr size_t LAT_BYTES = pad128(size_t(TM) * LDL * sizeof(bf16));
constexpr size_t BH_BYTES = pad128(size_t(TM) * LDBH * sizeof(bf16));
constexpr size_t RH_BYTES = pad128(size_t(TM) * LDR * sizeof(bf16));
// a forward-only tile: one bh and one rh tile
constexpr size_t BEND_FWD_TILE_BYTES =
    3 * XS_BYTES + 2 * ROWF_BYTES + LAT_BYTES + BH_BYTES + RH_BYTES;

// b0l and b1w..b3w read from global memory
__device__ __forceinline__ void point_big_weights(BendTile& t, const BendParams& p) {
  t.b0l = p.b0l;
  for (int i = 0; i < 3; ++i) t.bw[i] = p.bw[i];
  t.ldw = BW;
}

// carve a forward-only tile out of `base` (BEND_FWD_TILE_BYTES)
__device__ __forceinline__ BendTile forward_tile(unsigned char* base, const BendParams& p) {
  BendTile t;
  t.xs = reinterpret_cast<float*>(base);
  t.off = reinterpret_cast<float*>(base + XS_BYTES);
  t.bent = reinterpret_cast<float*>(base + 2 * XS_BYTES);
  t.tanh_rr = reinterpret_cast<float*>(base + 3 * XS_BYTES);
  t.rig0 = reinterpret_cast<float*>(base + 3 * XS_BYTES + ROWF_BYTES);
  unsigned char* q = base + 3 * XS_BYTES + 2 * ROWF_BYTES;
  t.lat = reinterpret_cast<bf16*>(q);
  bf16* bh = reinterpret_cast<bf16*>(q + LAT_BYTES);
  for (int i = 0; i < 4; ++i) t.bh[i] = bh;
  t.rh[0] = t.rh[1] = reinterpret_cast<bf16*>(q + LAT_BYTES + BH_BYTES);
  point_big_weights(t, p);
  return t;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// acc[j] = A[warp rows, 0:K] @ B[0:K, j*16 : j*16 + 16], j < NJ. A row-major
// (lda) in shared memory, B row-major (ldb) in global or shared memory.
template <int K, int NJ>
__device__ __forceinline__ void warp_mm_nn(AccFrag (&acc)[NJ], const bf16* a, int lda,
                                           const bf16* b, int ldb, int warp) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + (warp * 16) * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * ldb + j * 16, ldb);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// acc[j] = A[warp rows, 0:K] @ W[j*16 : j*16 + 16, 0:K]^T, j < NJ: W row-major
// (ldw) is the col-major B operand (nothing is transposed in memory).
template <int K, int NJ>
__device__ __forceinline__ void warp_mm_nt(AccFrag (&acc)[NJ], const bf16* a, int lda,
                                           const bf16* w, int ldw, int warp) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + (warp * 16) * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, w + (j * 16) * ldw + kk, ldw);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

struct NoPre {
  __device__ __forceinline__ float operator()(int, int) const { return 0.0f; }
};

// The warp's 16 x (16*NJ) block as bf16(act((pre + acc) + bias)) into its
// rows of `dst` (row stride ld), `pre(row, col)` a term summed before the
// product (0 but in bh0), or, without a bias, with the ReLU gate of `mask`
// (same stride) in place of an activation: dst = bf16(acc * (mask > 0)).
template <int NJ, bool RELU, class Pre = NoPre>
__device__ __forceinline__ void warp_store_bf16(AccFrag (&acc)[NJ], float* wscr,
                                                const float* __restrict__ bias,
                                                const bf16* mask, bf16* dst, int ld,
                                                int warp, int lane, Pre pre = Pre()) {
  __syncwarp();   // the warp's reads of its rows (maybe `dst` itself) are done
  auto run = [&](int row, int col, const float* v) {
    __align__(16) bf16 ov[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float x = v[e];
      if (bias != nullptr) x = __fadd_rn(__fadd_rn(pre(row, col + e), x), __ldg(bias + col + e));
      if (RELU) x = fmaxf(x, 0.0f);
      if (mask != nullptr && !(__bfloat162float(mask[row * ld + col + e]) > 0.0f)) x = 0.0f;
      ov[e] = __float2bfloat16(x);
    }
    *reinterpret_cast<uint4*>(dst + row * ld + col) = *reinterpret_cast<const uint4*>(ov);
  };
  for_each_run<NJ>(acc, wscr, warp, lane, run);
}

// The forward of the tile starting at row0: fills the activation members of
// `t`. Rows past n carry zero points and latents; their outputs are not
// stored by the callers, and their cotangents are zero in a backward. Ends
// with a barrier.
//
// The products with 32 or 64 inner lanes run on the tensor cores. The ones
// with 3 useful lanes (pts @ b0p, pts @ r0w, bh3 @ bow, rh1 @ row) run on the
// CUDA cores as sequential f32 sums of exact bf16 products: the order cuBLAS
// takes for them, so that the plain version's offsets come out bit-equal in
// all but about one point in a thousand (measured on an H100: with those
// products on zero-padded tensor-core tiles a quarter of the points differ
// in the last bit, and the sines' 2^9 carries that into the encoding).
// mlp_sm90.cuh's `FusedFwdIn` repeats this arithmetic and order in registers:
// a change here must be made there too.
__device__ __forceinline__ void bend_forward(const BendTile& t, const BendParams& p,
                                             const float* __restrict__ pts,
                                             const float* __restrict__ lat, long row0,
                                             int n, float* wscr, int tid, int warp,
                                             int lane) {
  const long rows_left = long(n) - row0;
  for (int i = tid; i < TM * PTS; i += THREADS) {
    t.xs[i] = (i / PTS < rows_left) ? pts[size_t(row0) * PTS + i] : 0.0f;
  }
  for (int i = tid; i < TM * LAT / 4; i += THREADS) {
    const int r = i / (LAT / 4), c = (i % (LAT / 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows_left) v = reinterpret_cast<const float4*>(lat + size_t(row0) * LAT)[i];
    __align__(8) bf16 ov[4] = {__float2bfloat16(v.x), __float2bfloat16(v.y),
                               __float2bfloat16(v.z), __float2bfloat16(v.w)};
    *reinterpret_cast<uint2*>(t.lat + r * LDL + c) = *reinterpret_cast<const uint2*>(ov);
  }
  __syncthreads();

  AccFrag acc[4];
  // bh0 = relu((pts @ b0p + lat @ b0l) + b0b), summed in JAX's order
  warp_mm_nn<LAT, 4>(acc, t.lat, LDL, t.b0l, t.ldw, warp);
  const bf16* b0p = p.b0p;
  const float* xs = t.xs;
  auto pts_product = [&](int row, int c) {
    float s = 0.0f;
    for (int j = 0; j < PTS; ++j) {
      s += bf16r(xs[row * PTS + j]) * __bfloat162float(b0p[j * BW + c]);
    }
    return s;
  };
  warp_store_bf16<4, true>(acc, wscr, p.bb[0], nullptr, t.bh[0], LDBH, warp, lane,
                           pts_product);
  for (int l = 1; l < 4; ++l) {
    warp_mm_nn<BW, 4>(acc, t.bh[l - 1], LDBH, t.bw[l - 1], t.ldw, warp);
    warp_store_bf16<4, true>(acc, wscr, p.bb[l], nullptr, t.bh[l], LDBH, warp, lane);
  }
  __syncthreads();

  // off = bh3 @ bow (lanes 0..2) and rh0 = relu(pts @ r0w + r0b)
  for (int i = tid; i < TM * PTS; i += THREADS) {
    const int r = i / PTS, j = i % PTS;
    float s = 0.0f;
    for (int k = 0; k < BW; ++k) {
      s += __bfloat162float(t.bh[3][r * LDBH + k]) * __bfloat162float(p.bow[k * WPAD + j]);
    }
    t.off[i] = s;
  }
  for (int i = tid; i < TM * RW; i += THREADS) {
    const int r = i / RW, c = i % RW;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      s += bf16r(t.xs[r * PTS + j]) * __bfloat162float(p.r0w[j * RW + c]);
    }
    t.rh[0][r * LDR + c] = __float2bfloat16(fmaxf(__fadd_rn(s, __ldg(p.r0b + c)), 0.0f));
  }
  __syncthreads();

  // rh1 = relu(rh0 @ r1w + r1b)
  AccFrag acc2[2];
  warp_mm_nn<RW, 2>(acc2, t.rh[0], LDR, p.r1w, RW, warp);
  warp_store_bf16<2, true>(acc2, wscr, p.r1b, nullptr, t.rh[1], LDR, warp, lane);
  __syncthreads();

  // the rigidity (lane 0 of rh1 @ row + rob), then the bent point
  if (tid < TM) {
    const int r = tid;
    float s = 0.0f;
    for (int k = 0; k < RW; ++k) {
      s += __bfloat162float(t.rh[1][r * LDR + k]) * __bfloat162float(p.row[k * WPAD]);
    }
    const float th = tanhf(__fadd_rn(s, __ldg(p.rob)));
    const float rig0 = __fmul_rn(__fadd_rn(th, 1.0f), 0.5f);
    t.tanh_rr[r] = th;
    t.rig0[r] = rig0;
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      t.bent[r * PTS + j] = __fadd_rn(t.xs[r * PTS + j], __fmul_rn(rig0, t.off[r * PTS + j]));
    }
  }
  __syncthreads();
}

// off (n, 3) and rig (n, 1) of the tile's rows below n
__device__ __forceinline__ void store_bend_outputs(const BendTile& t, float* __restrict__ off,
                                                   float* __restrict__ rig, long row0,
                                                   int n, int tid) {
  const long rows_left = long(n) - row0;
  for (int i = tid; i < TM * PTS; i += THREADS) {
    if (i / PTS < rows_left) off[size_t(row0) * PTS + i] = t.off[i];
  }
  if (tid < TM && tid < rows_left) rig[row0 + tid] = t.rig0[tid];
}

// lane c of the f32 encoding of the point x (3 f32), multires 10 (see
// `encoding_lane`)
__device__ __forceinline__ float encoding_value(const float* x, int c) {
  if (c < PTS) return x[c];
  if (c >= EMB - 1) return 0.0f;
  int j;
  float scale, phase;
  encoding_lane(c, j, scale, phase);
  return sinf(__fadd_rn(__fmul_rn(x[j], scale), phase));
}

// ---- the backward of one tile

// shared memory of `bend_bwd_kernel`: the gradient accumulator, the forward's
// tiles (four bh, two rh), two cotangent tiles, the per-point f32 values and
// the warp scratch
constexpr size_t BEND_ACC_BYTES = pad128(size_t(BEND_GRAD_FLOATS) * sizeof(float));
constexpr size_t BEND_BWD_SMEM_BYTES =
    BEND_ACC_BYTES + 6 * XS_BYTES + 3 * ROWF_BYTES + LAT_BYTES + 4 * BH_BYTES +
    2 * RH_BYTES + 2 * BH_BYTES + WSCR_BYTES;
static_assert(BEND_BWD_SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");

struct BendGradTile {
  float* dbent;     // 128 x 3 f32
  float* doff_t;    // 128 x 3 f32: dbent * rig0 + doff
  float* dpts_rig;  // 128 x 3 f32
  float* drig_raw;  // 128 f32
  bf16* da;         // 128 x LDBH bf16: cotangent tiles (also 128 x LDR)
  bf16* db;
};

// acc_s (M x N, row stride N, f32, shared) += act[0:128, 0:M]^T @ g[0:128, 0:N]
// on the tensor cores: act^T is the col-major A operand of the row-major
// tile. The warps share the (M/16) * (N/16) fragments.
template <int M, int N>
__device__ __forceinline__ void dw_accumulate(float* acc_s, const bf16* act, int lda,
                                              const bf16* g, int ldg, int warp) {
  constexpr int FN = N / 16;
  for (int f = warp; f < (M / 16) * FN; f += THREADS / 32) {
    const int mi = f / FN, nj = f % FN;
    float* dst = acc_s + (mi * 16) * N + nj * 16;
    AccFrag c;
    wmma::load_matrix_sync(c, dst, N, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < TM; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, act + kk * lda + mi * 16, lda);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, g + kk * ldg + nj * 16, ldg);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(dst, c, N, wmma::mem_row_major);
  }
}

// acc_s[0:NC] += the f32 column sums of the bf16 tile g over its 128 rows
// (one thread per column, rows in ascending order)
template <int NC>
__device__ __forceinline__ void bias_accumulate(float* acc_s, const bf16* g, int ldg,
                                                int tid) {
  if (tid < NC) {
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) s += __bfloat162float(g[r * ldg + tid]);
    acc_s[tid] += s;
  }
}

// The backward of the tile starting at row0, after `bend_forward` filled `t`
// (four distinct bh tiles, two rh tiles). demb (n, 64), doff (n, 3), drig
// (n, 1) f32 cotangents; adds the tile's weight gradients to `acc_s`, writes
// dpts (n, 3) and dlat (n, 32) of the rows below n. Ends with a barrier.
__device__ __forceinline__ void bend_backward(const BendTile& t, const BendGradTile& d,
                                              const BendParams& p,
                                              const float* __restrict__ demb,
                                              const float* __restrict__ doff,
                                              const float* __restrict__ drig, long row0,
                                              int n, float* acc_s, float* __restrict__ dpts,
                                              float* __restrict__ dlat, float* wscr,
                                              int tid, int warp, int lane) {
  const long rows_left = long(n) - row0;
  // dbent: dpre = where(lane < 3, demb, demb * cos(pre + phase)) folded onto
  // the coordinates (dpre @ P^T), lanes of a coordinate in ascending order
  for (int i = tid; i < TM * PTS; i += THREADS) {
    const int r = i / PTS, j = i % PTS;
    float s = 0.0f;
    if (r < rows_left) {
      const float* dr = demb + size_t(row0 + r) * EMB;
      const float x = t.bent[r * PTS + j];
      s = dr[j];
      for (int m = 0; m < 20; ++m) {
        const int c = 3 + 3 * m + j;
        int jj;
        float scale, phase;
        encoding_lane(c, jj, scale, phase);
        const float pre = __fadd_rn(__fmul_rn(x, scale), phase);
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(dr[c], cosf(pre)), scale));
      }
    }
    d.dbent[i] = s;
  }
  __syncthreads();
  // doff_total = dbent * rig0 + doff; drig_raw = (drig + dbent . off) * 0.5
  // * (1 - t^2), every product and sum rounded as the JAX math rounds it
  if (tid < TM) {
    const int r = tid;
    const bool in = r < rows_left;
    const float rig0 = t.rig0[r];
    float drig0 = 0.0f;
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      const float db = d.dbent[r * PTS + j];
      const float dof = in ? doff[size_t(row0 + r) * PTS + j] : 0.0f;
      d.doff_t[r * PTS + j] = __fadd_rn(__fmul_rn(db, rig0), dof);
      drig0 = __fadd_rn(drig0, __fmul_rn(db, t.off[r * PTS + j]));
    }
    const float dr = __fadd_rn(in ? drig[row0 + r] : 0.0f, drig0);
    const float th = t.tanh_rr[r];
    d.drig_raw[r] = __fmul_rn(__fmul_rn(dr, 0.5f), __fsub_rn(1.0f, __fmul_rn(th, th)));
  }
  __syncthreads();

  // ---- rigidity: g_row, g_rob, drh1 = bf16((bf16(drig_raw) x row^T) * (rh1 > 0))
  if (tid < RW) {
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) {
      s += __bfloat162float(t.rh[1][r * LDR + tid]) * bf16r(d.drig_raw[r]);
    }
    acc_s[G_ROW + tid * WPAD] += s;
  } else if (tid == RW) {
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) s += d.drig_raw[r];
    acc_s[G_ROB] += s;
  }
  for (int i = tid; i < TM * RW; i += THREADS) {
    const int r = i / RW, c = i % RW;
    const float v = bf16r(d.drig_raw[r]) * __bfloat162float(p.row[c * WPAD]);
    const bool on = __bfloat162float(t.rh[1][r * LDR + c]) > 0.0f;
    d.da[r * LDR + c] = __float2bfloat16(on ? v : 0.0f);
  }
  __syncthreads();
  // g_r1w = rh0^T @ drh1, g_r1b; drh0 = bf16((drh1 @ r1w^T) * (rh0 > 0))
  dw_accumulate<RW, RW>(acc_s + G_R1W, t.rh[0], LDR, d.da, LDR, warp);
  bias_accumulate<RW>(acc_s + G_R1B, d.da, LDR, tid);
  {
    AccFrag acc2[2];
    warp_mm_nt<RW, 2>(acc2, d.da, LDR, p.r1w, RW, warp);
    warp_store_bf16<2, false>(acc2, wscr, nullptr, t.rh[0], d.db, LDR, warp, lane);
  }
  __syncthreads();
  // g_r0w = bf16(pts)^T @ drh0 (rows 0..2), g_r0b; dpts_rig = drh0 @ r0w^T
  if (tid < PTS * RW) {
    const int j = tid / RW, c = tid % RW;
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) {
      s += bf16r(t.xs[r * PTS + j]) * __bfloat162float(d.db[r * LDR + c]);
    }
    acc_s[G_R0W + j * RW + c] += s;
  } else if (tid < PTS * RW + RW) {
    const int c = tid - PTS * RW;
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) s += __bfloat162float(d.db[r * LDR + c]);
    acc_s[G_R0B + c] += s;
  }
  for (int i = tid; i < TM * PTS; i += THREADS) {
    const int r = i / PTS, j = i % PTS;
    float s = 0.0f;
    for (int k = 0; k < RW; ++k) {
      s += __bfloat162float(d.db[r * LDR + k]) * __bfloat162float(p.r0w[j * RW + k]);
    }
    d.dpts_rig[i] = s;
  }
  __syncthreads();

  // ---- bending: g_bow = bh3^T @ bf16(doff_total); dbh3 = bf16((bf16(doff_total)
  // @ bow^T) * (bh3 > 0))
  if (tid < BW * PTS) {
    const int k = tid / PTS, j = tid % PTS;
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) {
      s += __bfloat162float(t.bh[3][r * LDBH + k]) * bf16r(d.doff_t[r * PTS + j]);
    }
    acc_s[G_BOW + k * WPAD + j] += s;
  }
  for (int i = tid; i < TM * BW; i += THREADS) {
    const int r = i / BW, c = i % BW;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      s += bf16r(d.doff_t[r * PTS + j]) * __bfloat162float(p.bow[c * WPAD + j]);
    }
    const bool on = __bfloat162float(t.bh[3][r * LDBH + c]) > 0.0f;
    d.da[r * LDBH + c] = __float2bfloat16(on ? s : 0.0f);
  }
  __syncthreads();
  // layers 3, 2, 1: g_W = bh_{l-1}^T @ dbh_l, g_b; dbh_{l-1} = bf16((dbh_l @
  // W^T) * (bh_{l-1} > 0)), ping-ponging between the two cotangent tiles
  const int g_w[3] = {G_B1W, G_B2W, G_B3W};
  const int g_b[3] = {G_B1B, G_B2B, G_B3B};
  bf16* cur = d.da;
  bf16* oth = d.db;
  AccFrag acc[4];
  for (int l = 3; l >= 1; --l) {
    dw_accumulate<BW, BW>(acc_s + g_w[l - 1], t.bh[l - 1], LDBH, cur, LDBH, warp);
    bias_accumulate<BW>(acc_s + g_b[l - 1], cur, LDBH, tid);
    warp_mm_nt<BW, 4>(acc, cur, LDBH, p.bw[l - 1], BW, warp);
    warp_store_bf16<4, false>(acc, wscr, nullptr, t.bh[l - 1], oth, LDBH, warp, lane);
    __syncthreads();
    bf16* tmp = cur;
    cur = oth;
    oth = tmp;
  }
  // cur = dbh0: g_b0p = bf16(pts)^T @ dbh0 (rows 0..2), g_b0l = bf16(lat)^T @
  // dbh0, g_b0b; dpts = (dbent + dpts_rig) + dbh0 @ b0p^T; dlat = dbh0 @ b0l^T
  dw_accumulate<LAT, BW>(acc_s + G_B0L, t.lat, LDL, cur, LDBH, warp);
  bias_accumulate<BW>(acc_s + G_B0B, cur, LDBH, tid);
  if (tid >= BW && tid < BW + PTS * BW) {
    const int j = (tid - BW) / BW, c = (tid - BW) % BW;
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) {
      s += bf16r(t.xs[r * PTS + j]) * __bfloat162float(cur[r * LDBH + c]);
    }
    acc_s[G_B0P + j * BW + c] += s;
  }
  for (int i = tid; i < TM * PTS; i += THREADS) {
    const int r = i / PTS, j = i % PTS;
    if (r >= rows_left) continue;
    float s = 0.0f;
    for (int k = 0; k < BW; ++k) {
      s += __bfloat162float(cur[r * LDBH + k]) * __bfloat162float(p.b0p[j * BW + k]);
    }
    dpts[size_t(row0) * PTS + i] = __fadd_rn(__fadd_rn(d.dbent[i], d.dpts_rig[i]), s);
  }
  {
    AccFrag acc2[2];
    warp_mm_nt<BW, 2>(acc2, cur, LDBH, p.b0l, BW, warp);
    auto store_dlat = [&](int row, int col, const float* v) {
      if (row >= rows_left) return;
      float* dst = dlat + size_t(row0 + row) * LAT + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = v[e];
    };
    for_each_run<2>(acc2, wscr, warp, lane, store_dlat);
  }
  __syncthreads();
}

// One CTA per split of BEND_SPLIT_TILES tiles: forward, backward, and the
// split's gradients into its slot of `partials` (BEND_GRAD_FLOATS each).
__global__ void __launch_bounds__(THREADS, 1)
bend_bwd_kernel(BendParams p, const float* __restrict__ pts, const float* __restrict__ lat,
                const float* __restrict__ demb, const float* __restrict__ doff,
                const float* __restrict__ drig, int n, float* __restrict__ partials,
                float* __restrict__ dpts, float* __restrict__ dlat) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);
  unsigned char* q = smem + BEND_ACC_BYTES;
  BendTile t;
  BendGradTile d;
  t.xs = reinterpret_cast<float*>(q);
  t.off = reinterpret_cast<float*>(q + XS_BYTES);
  t.bent = reinterpret_cast<float*>(q + 2 * XS_BYTES);
  d.dbent = reinterpret_cast<float*>(q + 3 * XS_BYTES);
  d.doff_t = reinterpret_cast<float*>(q + 4 * XS_BYTES);
  d.dpts_rig = reinterpret_cast<float*>(q + 5 * XS_BYTES);
  q += 6 * XS_BYTES;
  t.tanh_rr = reinterpret_cast<float*>(q);
  t.rig0 = reinterpret_cast<float*>(q + ROWF_BYTES);
  d.drig_raw = reinterpret_cast<float*>(q + 2 * ROWF_BYTES);
  q += 3 * ROWF_BYTES;
  t.lat = reinterpret_cast<bf16*>(q);
  q += LAT_BYTES;
  for (int i = 0; i < 4; ++i) t.bh[i] = reinterpret_cast<bf16*>(q + i * BH_BYTES);
  q += 4 * BH_BYTES;
  for (int i = 0; i < 2; ++i) t.rh[i] = reinterpret_cast<bf16*>(q + i * RH_BYTES);
  q += 2 * RH_BYTES;
  d.da = reinterpret_cast<bf16*>(q);
  d.db = reinterpret_cast<bf16*>(q + BH_BYTES);
  q += 2 * BH_BYTES;
  float* scratch = reinterpret_cast<float*>(q);
  point_big_weights(t, p);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* wscr = scratch + warp * 256;
  for (int i = tid; i < BEND_GRAD_FLOATS; i += THREADS) acc_s[i] = 0.0f;
  __syncthreads();
  for (int k = 0; k < BEND_SPLIT_TILES; ++k) {
    const long row0 = (long(blockIdx.x) * BEND_SPLIT_TILES + k) * TM;
    if (row0 >= n) break;
    bend_forward(t, p, pts, lat, row0, n, wscr, tid, warp, lane);
    bend_backward(t, d, p, demb, doff, drig, row0, n, acc_s, dpts, dlat, wscr, tid,
                  warp, lane);
  }
  __syncthreads();
  float* out = partials + size_t(blockIdx.x) * BEND_GRAD_FLOATS;
  for (int i = tid; i < BEND_GRAD_FLOATS; i += THREADS) out[i] = acc_s[i];
}

inline int bend_split_count(int n) { return (n + BEND_SPLIT_ROWS - 1) / BEND_SPLIT_ROWS; }

// The bender's backward on `stream`: per-split gradients, then their
// fixed-order sum into grads (BEND_GRAD_FLOATS f32, pack order). partials:
// bend_split_count(n) * BEND_GRAD_FLOATS f32. Returns the CUDA error code of
// the first failing call (0 on success).
inline int launch_bend_backward(const BendParams& p, const float* pts, const float* lat,
                                const float* demb, const float* doff, const float* drig,
                                int n, float* partials, float* dpts, float* dlat,
                                float* grads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bend_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(BEND_BWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int n_splits = bend_split_count(n);
  bend_bwd_kernel<<<dim3(n_splits), THREADS, BEND_BWD_SMEM_BYTES, stream>>>(
      p, pts, lat, demb, doff, drig, n, partials, dpts, dlat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mlp_reduce_kernel<<<dim3((BEND_GRAD_FLOATS + THREADS - 1) / THREADS), THREADS, 0,
                      stream>>>(partials, n_splits, BEND_GRAD_FLOATS, grads);
  return int(cudaGetLastError());
}

}  // namespace
