// Shared device code of the canonical-MLP kernels for Hopper (sm_90a):
// mlpv_fwd.cu, mlpe_fwd.cu and (the cp.async ring only) mlp_i8.cu, the
// fused point query's (bend_*.cu, fused_*.cu), and from mlp_bwd.cu,
// mlpe_bwd.cu and mlpv_bwd.cu the single-head gradient layout, the buffer
// sizes and the reduction over the splits. Rows 1-2, 4 and 6 (mlp_fwd.cu,
// mlp_bwd.cu, mlpv_bwd.cu, mlpe_bwd.cu) run their own chain on wgmma,
// csrc/mlp_sm90.cuh; the design below is the one they had before, and the
// one the other kernels keep. What they share:
//
// - the tile: one CTA of 8 warps owns 128 points; a 128 x 256 bf16 activation
//   tile stays in shared memory and each layer's accumulators live in
//   registers, so a layer's output overwrites its own input after a barrier;
// - the weight ring: weights stream from global memory (L2-resident) through
//   a double-buffered pair of shared-memory stages filled with cp.async, one
//   schedule of chunks (64 weight rows as a rule) across all layers of a
//   kernel, so the next chunk is in flight while the current one is used;
// - the chain: nh1 .. nh8 of the 8 x 256 MLP with the skip at layer 4 as a
//   split weight (n5h on the hidden tile, n5e on the encoding tile), for an
//   encoding of E lanes: 64 (the 63-channel Fourier encoding) or 128 (the
//   time-conditioned input: the encoding and the 32-lane latent, 95
//   channels). The chain's device code, its chunk schedules, the single-head
//   gradient layout and the second pass are templates on E; the kernels
//   here run the 64-lane instantiation, mlp_bwd.cu reads the gradient
//   layout at both;
// - the transposed step `cur @ W^T` of the backward's dh chain, which reads
//   the same row chunks of W as col-major B operands;
// - the backward's second pass: split-K dW products, column sums and the
//   8-lane head products, and the fixed-order reduction over the splits;
// - the in-kernel Fourier encoding of mlpe_fwd.cu and fused_*.cu;
// - what fused_bwd.cu needs of a single head: the gradient layout, the dh8
//   step and the second pass's job list (mlp_bwd.cu and mlpe_bwd.cu read the
//   gradient layout, the sizes and the reduction).
//
// Products use warp-level bf16 tensor-core MMA (nvcuda::wmma 16x16x16) with
// f32 accumulators. No atomics anywhere: the same inputs give bit-equal
// outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TM = 128;        // points per CTA
constexpr int NW = 256;        // hidden width
constexpr int EMB = 64;        // encoding width (63 channels + 1 zero lane)
constexpr int EMB_TC = 128;    // time-conditioned input width (63 + 32 + 33 zero lanes)
constexpr int VEMB = 32;       // view-encoding width (27 channels + 5 zero lanes)
constexpr int VW = 128;        // width of the view-conditioned layer
constexpr int OUT = 8;         // head width (4 lanes used)
constexpr int KC = 64;         // weight rows per staged chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int LDA = NW + 8;    // padded shared-memory row strides (halves)
constexpr int LDE = EMB + 8;
constexpr int LDV = VEMB + 8;
constexpr int LDW = NW + 8;
constexpr int N_LAYERS = 8;
// forward chunks: E/64 (n0w) + 4*4 + (4 + E/64) + 2*4: 30 at 64 lanes, 32 at 128
template <int E> constexpr int n_fwd_chunks = 2 * (E / KC) + 7 * (NW / KC);
constexpr int N_FWD_CHUNKS = n_fwd_chunks<EMB>;
constexpr int N_BWD_STEPS = 9;     // n7w n6w n5e n5h n4w n3w n2w n1w n0w
// backward chunks: 4*7 + 2 * E/64: 30 at 64 lanes, 32 at 128
template <int E> constexpr int n_bwd_chunks = 7 * (NW / KC) + 2 * (E / KC);
constexpr int N_BWD_CHUNKS = n_bwd_chunks<EMB>;
constexpr int SPLIT_ROWS = 2048;   // points per split of the dW products
constexpr int RK = 64;             // points per staged chunk of the dW kernel
constexpr int SMALL_GROUPS = 4;    // row groups per block of the small kernel
constexpr int MAX_DW_TILES = 30;   // fused_bwd.cu's 9 products in 64-row tiles
constexpr int MAX_SMALL_JOBS = 9;  // its 8 bias sums and the head's job

constexpr size_t ACT_BYTES = size_t(TM) * LDA * sizeof(bf16);
// the encoding tile of E lanes: row stride E + 8 halves
template <int E> constexpr int ld_emb = E + 8;
template <int E> constexpr size_t emb_tile_bytes = size_t(TM) * ld_emb<E> * sizeof(bf16);
constexpr size_t EMB_BYTES = emb_tile_bytes<EMB>;
constexpr size_t VEMB_BYTES = size_t(TM) * LDV * sizeof(bf16);
constexpr size_t STAGE_BYTES = size_t(KC) * LDW * sizeof(bf16);
constexpr size_t WSCR_BYTES = size_t(THREADS / 32) * 16 * 16 * sizeof(float);
constexpr size_t DRAW_BYTES = size_t(TM) * OUT * sizeof(float);
constexpr size_t SMEM_LIMIT = 232448;   // what one Hopper CTA can use

constexpr int LDAS = EMB + 8;      // dW kernel: act chunk (RK x 64)
constexpr int LDBS = NW + 8;       //            dh chunk  (RK x 256)
constexpr size_t DW_A_BYTES = size_t(RK) * LDAS * sizeof(bf16);
constexpr size_t DW_B_BYTES = size_t(RK) * LDBS * sizeof(bf16);
constexpr size_t DW_SMEM_BYTES = 2 * (DW_A_BYTES + DW_B_BYTES);

static_assert(ACT_BYTES % 128 == 0 && EMB_BYTES % 128 == 0 &&
              emb_tile_bytes<EMB_TC> % 128 == 0 &&
              VEMB_BYTES % 128 == 0 && STAGE_BYTES % 128 == 0 &&
              WSCR_BYTES % 128 == 0 && DRAW_BYTES % 128 == 0 &&
              DW_A_BYTES % 128 == 0 && DW_B_BYTES % 128 == 0,
              "shared-memory regions stay aligned");

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ROWS x COLS bf16 weight rows (contiguous, row stride COLS) into a stage
// (row stride LDW), in 16-byte pieces
template <int ROWS, int COLS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * COLS / 8; i += THREADS) {
    const int r = i / (COLS / 8);
    const int c = (i % (COLS / 8)) * 8;
    cp_async16(dst + r * LDW + c, src + r * COLS + c);
  }
}

// one 64 x 256 bf16 chunk (32 KB) = 2048 16-byte pieces, 8 per thread
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int tid) {
  load_rows<KC, NW>(dst, src, tid);
}

__device__ __forceinline__ bf16* stage_of(bf16* stage, int g) {
  return stage + (g & 1) * KC * LDW;
}

// a 128-point tile of a (n, COLS) bf16 input into shared memory (row stride
// LD); rows past n are zero
template <int COLS, int LD>
__device__ __forceinline__ void load_points(bf16* dst, const bf16* __restrict__ src,
                                            long row0, int n, int tid) {
  for (int i = tid; i < TM * COLS / 8; i += THREADS) {
    const int r = i / (COLS / 8);
    const int c = (i % (COLS / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) {
      v = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * COLS + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// Wait for chunk g of the schedule, with chunk g + 1 put in flight first.
// `prefetch(g)` starts the cp.async loads of chunk g into its stage, and
// nothing past the schedule's end.
template <class Prefetch>
__device__ __forceinline__ void ring_next(Prefetch& prefetch, int g) {
  prefetch(g + 1);
  cp_async_commit();   // an empty group at the end keeps the count even
  cp_async_wait_1();   // chunk g has landed
  __syncthreads();     // ... for every thread, and so have the input tiles
}

__device__ __forceinline__ void zero_acc(AccFrag (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc (this warp's 64 x 64 block of the 128 x 256 output: rows wm*64,
// cols wn*64) += A[:, k0 : k0 + 64] @ (the staged 64 x 256 chunk)
__device__ __forceinline__ void mma_chunk(AccFrag (&acc)[4][4], const bf16* a_src,
                                          int lda, int k0, const bf16* b_src,
                                          int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::load_matrix_sync(a[i], a_src + (wm * 64 + i * 16) * lda + k0 + kk, lda);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, b_src + kk * LDW + wn * 64 + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
}

// A layer's epilogue: dst = bf16(act(acc + bias)) for this warp's 64 x 64
// block, RELU or no activation; with `gdst` (row row0 of a row-padded
// (n_pad, 256) global array) the block is stored there too. All reads of
// `dst` by the layer's products must have finished (a barrier) before.
template <bool RELU>
__device__ __forceinline__ void store_layer(AccFrag (&acc)[4][4], float* wscr,
                                            const float* __restrict__ bias,
                                            bf16* dst, bf16* gdst, int wm, int wn,
                                            int lane) {
  const int er = lane / 2;          // row within a 16 x 16 fragment
  const int ec = (lane % 2) * 8;    // first of this lane's 8 columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(wscr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = wm * 64 + i * 16 + er;
      const int gcol = wn * 64 + j * 16 + ec;
      __align__(16) bf16 ov[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = wscr[er * 16 + ec + e] + __ldg(bias + gcol + e);
        ov[e] = __float2bfloat16(RELU ? fmaxf(v, 0.0f) : v);
      }
      const uint4 pk = *reinterpret_cast<const uint4*>(ov);
      *reinterpret_cast<uint4*>(dst + grow * LDA + gcol) = pk;
      if (gdst != nullptr) {
        *reinterpret_cast<uint4*>(gdst + size_t(grow) * NW + gcol) = pk;
      }
      __syncwarp();
    }
  }
}

// forward chunks of layer l at an encoding of E lanes: layer 0 reads E/64
// chunks of n0w on emb; layer 5 reads 4 chunks of n5h, then E/64 of n5e on emb
template <int E>
__device__ __forceinline__ int layer_chunks(int layer) {
  return layer == 0 ? E / KC : (layer == 5 ? NW / KC + E / KC : NW / KC);
}

// nh1 .. nh8 of the tile from the encoding tile `embs` of E lanes (row
// stride ld_emb<E>): chunks g .. g + n_fwd_chunks<E> - 1 of the schedule.
// `act` ends as nh8. With `nh` (the row-padded (8, n_pad, 256) global
// scratch, offset to the tile's first row) every layer is stored there too.
//   nh1 = bf16(relu(emb @ n0w + n0b));  nh2..nh5, nh7, nh8 alike;
//   nh6 = bf16(relu(nh5 @ n5h + emb @ n5e + n5b))
template <int E = EMB, class Prefetch>
__device__ __forceinline__ void chain_forward(bf16* act, const bf16* embs, bf16* stage,
                                              float* wscr, const float* const* bias,
                                              int& g, Prefetch& prefetch, bf16* nh,
                                              size_t layer_stride, int warp, int lane) {
  const int wm = warp / 4;   // rows wm*64 .. +64
  const int wn = warp % 4;   // cols wn*64 .. +64
  AccFrag acc[4][4];
  for (int layer = 0; layer < N_LAYERS; ++layer) {
    zero_acc(acc);
    const int n_chunks = layer_chunks<E>(layer);
    for (int c = 0; c < n_chunks; ++c, ++g) {
      ring_next(prefetch, g);
      const bool skip = layer == 5 && c >= NW / KC;   // n5e's chunks
      const bool from_emb = layer == 0 || skip;
      const int k0 = (skip ? c - NW / KC : c) * KC;
      mma_chunk(acc, from_emb ? embs : act, from_emb ? ld_emb<E> : LDA, k0,
                stage_of(stage, g), wm, wn);
      __syncthreads();   // all reads of this stage and of act are done
    }
    store_layer<true>(acc, wscr, bias[layer], act,
                      nh != nullptr ? nh + size_t(layer) * layer_stride : nullptr,
                      wm, wn, lane);
    __syncthreads();
  }
}

// dst = bf16(src @ W + bias) with no activation, W (256, 256) as chunks
// g .. g + 3 of the schedule (the feature head of the view-direction MLP).
// `dst` may be `src`.
template <class Prefetch>
__device__ __forceinline__ void linear_256(const bf16* src, bf16* dst, bf16* stage,
                                           float* wscr, const float* bias, int& g,
                                           Prefetch& prefetch, int warp, int lane) {
  const int wm = warp / 4;
  const int wn = warp % 4;
  AccFrag acc[4][4];
  zero_acc(acc);
  for (int c = 0; c < NW / KC; ++c, ++g) {
    ring_next(prefetch, g);
    mma_chunk(acc, src, LDA, c * KC, stage_of(stage, g), wm, wn);
    __syncthreads();
  }
  store_layer<false>(acc, wscr, bias, dst, nullptr, wm, wn, lane);
  __syncthreads();
}

// hv = bf16(relu(feat @ vwf + embv @ vwv + vb)), 128 wide, into columns
// 0 .. 127 of `dst` (which may be `feat`): chunks g .. g + 4 of the schedule,
// four 64 x 128 chunks of vwf and the 32 x 128 vwv. Each warp owns a 64 x 32
// block.
template <class Prefetch>
__device__ __forceinline__ void views_forward(const bf16* feat, const bf16* embvs,
                                              bf16* dst, bf16* stage, float* wscr,
                                              const float* __restrict__ vb, int& g,
                                              Prefetch& prefetch, int warp, int lane) {
  const int wm = warp / 4;   // rows wm*64 .. +64
  const int wn = warp % 4;   // cols wn*32 .. +32
  AccFrag acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int c = 0; c < NW / KC + 1; ++c, ++g) {
    ring_next(prefetch, g);
    const bool from_v = (c == NW / KC);
    const bf16* a_src = from_v ? embvs : feat;
    const int lda = from_v ? LDV : LDA;
    const int k0 = from_v ? 0 : c * KC;
    const int k_len = from_v ? VEMB : KC;
    const bf16* b_src = stage_of(stage, g);
    for (int kk = 0; kk < k_len; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::load_matrix_sync(a[i], a_src + (wm * 64 + i * 16) * lda + k0 + kk, lda);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_src + kk * LDW + wn * 32 + j * 16, LDW);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(wscr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = wm * 64 + i * 16 + er;
      const int gcol = wn * 32 + j * 16 + ec;
      __align__(16) bf16 ov[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = wscr[er * 16 + ec + e] + __ldg(vb + gcol + e);
        ov[e] = __float2bfloat16(fmaxf(v, 0.0f));
      }
      *reinterpret_cast<uint4*>(dst + grow * LDA + gcol) =
          *reinterpret_cast<const uint4*>(ov);
      __syncwarp();
    }
  }
  __syncthreads();
}

// acc (16 rows of this warp x 16*NJ columns) = cur[:, 0:K] @ Wc^T for the
// staged chunk Wc of 16*NJ weight rows x K columns: the chunk holds
// W[i0 : i0 + 16*NJ, :], which is the col-major B operand of output columns
// i0 .. (the wmma fragment is loaded with the col_major tag; nothing is
// transposed in memory). Warp w owns rows w*16 .. +16.
template <int K, int NJ>
__device__ __forceinline__ void mma_nt(AccFrag (&acc)[NJ], const bf16* cur,
                                       const bf16* b_src, int warp) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll 4
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, cur + (warp * 16) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, b_src + (j * 16) * LDW + kk, LDW);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// Hand the warp's fragments out in runs of 8 values: f(row, col, v) gets the
// row within the tile, the first of 8 consecutive columns within the
// chunk's 16*NJ output columns, and the 8 f32 values.
template <int NJ, class F>
__device__ __forceinline__ void for_each_run(AccFrag (&acc)[NJ], float* wscr, int warp,
                                             int lane, F&& f) {
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::store_matrix_sync(wscr, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    f(warp * 16 + er, j * 16 + ec, wscr + er * 16 + ec);
    __syncwarp();
  }
}

// 8 values -> bf16, masked by the recomputed activation where `mask` is
// given (the ReLU gate: act > 0), to a shared-memory tile and to global
__device__ __forceinline__ void store_run(const float* v, const bf16* mask, bf16* sdst,
                                          bf16* gdst) {
  __align__(16) bf16 ov[8];
  if (mask != nullptr) {
    const uint4 mk = *reinterpret_cast<const uint4*>(mask);
    const bf16* mv = reinterpret_cast<const bf16*>(&mk);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool on = __bfloat162float(mv[e]) > 0.0f;
      ov[e] = __float2bfloat16(on ? v[e] : 0.0f);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) ov[e] = __float2bfloat16(v[e]);
  }
  const uint4 pk = *reinterpret_cast<const uint4*>(ov);
  *reinterpret_cast<uint4*>(sdst) = pk;
  *reinterpret_cast<uint4*>(gdst) = pk;
}

// backward steps of the chain: the layer l whose dh_l the step produces (its
// mask is nh_l), or 0 for the two products that give demb
__device__ __forceinline__ int bwd_layer(int step) {
  return step == 0 ? 7 : step == 1 ? 6 : step == 2 ? 0 : step == 8 ? 0 : 8 - step;
}

// dh_chain's sink that writes demb to the tile's rows of the (n, 64) f32
// output: step 2 stores, step 8 adds. rows_left = n - row0.
struct DembToGlobal {
  float* demb;
  long rows_left;
  __device__ __forceinline__ void operator()(int step, int row, int col,
                                             const float* v) const {
    if (row >= rows_left) return;
    float* dst = demb + size_t(row) * EMB + col;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = (step == 2) ? v[e] : dst[e] + v[e];
  }
};

// The dh chain from dh8 (in `cur`) down: chunks g .. g + n_bwd_chunks<E> - 1
// of the schedule (n7w n6w n5e n5h n4w n3w n2w n1w n0w; n5e and n0w as E/64
// chunks each, one per 64 columns of demb).
//   dh_l = bf16((dh_{l+1} @ W_l^T) * (nh_l > 0))   l = 7 .. 1
//   demb = dh6 @ n5e^T + dh1 @ n0w^T               (f32, no mask)
// nh, dh: the tile's rows of the row-padded (8, n_pad, 256) scratch arrays.
// The two products of demb (step 2, then step 8) are handed to
// `demb_run(step, row, col, v)` in runs of 8 columns; the same lane gets the
// same elements in both steps.
template <int E = EMB, class Prefetch, class DembRun>
__device__ __forceinline__ void dh_chain(bf16* cur, bf16* oth, bf16* stage, float* wscr,
                                         int& g, Prefetch& prefetch, const bf16* nh,
                                         bf16* dh, size_t layer_stride,
                                         DembRun&& demb_run, int warp, int lane) {
  AccFrag acc[4];
  for (int step = 0; step < N_BWD_STEPS; ++step) {
    const int layer = bwd_layer(step);          // 0: a demb product
    const int n_chunks = layer ? NW / KC : E / KC;
    for (int c = 0; c < n_chunks; ++c, ++g) {
      ring_next(prefetch, g);
      mma_nt<NW, 4>(acc, cur, stage_of(stage, g), warp);
      for_each_run<4>(acc, wscr, warp, lane, [&](int row, int col, const float* v) {
        const int gcol = c * KC + col;
        if (layer) {
          const size_t goff = size_t(layer - 1) * layer_stride + size_t(row) * NW + gcol;
          store_run(v, nh + goff, oth + row * LDA + gcol, dh + goff);
        } else {
          demb_run(step, row, gcol, v);
        }
      });
      __syncthreads();   // this stage and `cur` are read, `oth` is written
    }
    if (layer) {
      bf16* t = cur;
      cur = oth;
      oth = t;
    }
  }
}

// The n_fwd_chunks<E> forward chunks of the chain from the matrices n0w,
// n1w..n4w, n5e, n5h, n6w, n7w (m[0..8]; n0w and n5e E x 256); returns the
// next free slot.
template <int E = EMB>
inline int fill_forward_chunks(const bf16* const* m, const bf16** chunk, int g) {
  for (int c = 0; c < E / KC; ++c) chunk[g++] = m[0] + c * KC * NW;   // n0w
  for (int layer = 1; layer <= 4; ++layer)
    for (int c = 0; c < 4; ++c) chunk[g++] = m[layer] + c * KC * NW;
  for (int c = 0; c < 4; ++c) chunk[g++] = m[6] + c * KC * NW;        // n5h
  for (int c = 0; c < E / KC; ++c) chunk[g++] = m[5] + c * KC * NW;   // n5e
  for (int layer = 7; layer <= 8; ++layer)
    for (int c = 0; c < 4; ++c) chunk[g++] = m[layer] + c * KC * NW;
  return g;
}

// The n_bwd_chunks<E> backward chunks: n7w n6w n5e n5h n4w n3w n2w n1w n0w.
template <int E = EMB>
inline int fill_backward_chunks(const bf16* const* m, const bf16** chunk, int g) {
  const int bwd_mat[N_BWD_STEPS] = {8, 7, 5, 6, 4, 3, 2, 1, 0};
  for (int s = 0; s < N_BWD_STEPS; ++s) {
    const int n_chunks = (bwd_mat[s] == 5 || bwd_mat[s] == 0) ? E / KC : 4;
    for (int c = 0; c < n_chunks; ++c) chunk[g++] = m[bwd_mat[s]] + c * KC * NW;
  }
  return g;
}

// ---- the backward's second pass

struct DwTile {
  const bf16* a;     // activations, row-major (n_pad, lda)
  const bf16* b;     // dh, row-major (n_pad, 256)
  int lda;           // 64 or 256
  int a_col;         // first of the tile's 64 activation columns
  int out_off;       // offset of the tile's 64 x 256 block in the grads
};

struct DwParams {
  DwTile tile[MAX_DW_TILES];
};

// dW partials: CTA (tile, split) forms the 64 x 256 block
//   act[rows, a_col : a_col + 64]^T @ dh[rows, :]  over the split's rows
// (act^T is the col-major A operand of the row-major scratch) and writes it
// to its own slot of the partials buffer.
__global__ void __launch_bounds__(THREADS)
mlp_dw_kernel(DwParams p, long n_pad, int grad_floats, float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);                       // 2 stages
  bf16* bs = reinterpret_cast<bf16*>(smem + 2 * DW_A_BYTES);      // 2 stages

  const DwTile t = p.tile[blockIdx.x];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;   // output rows wm*32 .. +32
  const int wn = warp % 4;   // output cols wn*64 .. +64
  const long r_begin = long(blockIdx.y) * SPLIT_ROWS;
  const long r_end = (r_begin + SPLIT_ROWS < n_pad) ? r_begin + SPLIT_ROWS : n_pad;
  const int n_k = int((r_end - r_begin) / RK);

  auto load_stage = [&](int s, int k) {
    const long r0 = r_begin + long(k) * RK;
    bf16* a_dst = as + s * RK * LDAS;
    bf16* b_dst = bs + s * RK * LDBS;
    constexpr int A_PIECES = EMB / 8, B_PIECES = NW / 8;
    for (int i = tid; i < RK * A_PIECES; i += THREADS) {
      const int r = i / A_PIECES;
      const int c = (i % A_PIECES) * 8;
      cp_async16(a_dst + r * LDAS + c, t.a + size_t(r0 + r) * t.lda + t.a_col + c);
    }
    for (int i = tid; i < RK * B_PIECES; i += THREADS) {
      const int r = i / B_PIECES;
      const int c = (i % B_PIECES) * 8;
      cp_async16(b_dst + r * LDBS + c, t.b + size_t(r0 + r) * NW + c);
    }
  };

  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_k; ++k) {
    if (k + 1 < n_k) load_stage((k + 1) & 1, k + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    {
      const bf16* a_src = as + (k & 1) * RK * LDAS;
      const bf16* b_src = bs + (k & 1) * RK * LDBS;
#pragma unroll
      for (int kk = 0; kk < RK; kk += 16) {
        // act^T: element (m, k) sits at a_src[k * LDAS + m], so col_major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(a[i], a_src + kk * LDAS + wm * 32 + i * 16, LDAS);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, b_src + kk * LDBS + wn * 64 + j * 16, LDBS);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* out = partials + size_t(blockIdx.y) * grad_floats + t.out_off;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(out + (wm * 32 + i * 16) * NW + wn * 64 + j * 16,
                              acc[i][j], NW, wmma::mem_row_major);
    }
}

struct SmallJob {
  const bf16* src;    // row-major (n_pad, 256)
  int out_off;        // where the job's result goes in the flat grads
  int draw_sum_off;   // -1: the job sums src's columns over the points.
                      // else: the job forms src^T @ bf16(draw) (256 x 8),
                      // and columns 0..7 also sum the UNCAST draw to here
};

struct SmallParams {
  SmallJob job[MAX_SMALL_JOBS];
};

// Bias sums and the 8-lane head products of one split, on the CUDA cores:
// block (split, job). The block's SMALL_GROUPS row groups each take every
// SMALL_GROUPS-th row of the split and are added in ascending order.
__global__ void __launch_bounds__(SMALL_GROUPS * NW)
mlp_small_kernel(SmallParams p, const float* __restrict__ draw, int n, long n_pad,
             int grad_floats, float* __restrict__ partials) {
  __shared__ float red[SMALL_GROUPS][NW][OUT + 1];
  const SmallJob job = p.job[blockIdx.y];
  const int col = threadIdx.x % NW;
  const int grp = threadIdx.x / NW;
  const long r_begin = long(blockIdx.x) * SPLIT_ROWS;
  const long r_end = (r_begin + SPLIT_ROWS < n_pad) ? r_begin + SPLIT_ROWS : n_pad;
  float* out = partials + size_t(blockIdx.x) * grad_floats;
  if (job.draw_sum_off < 0) {
    float s = 0.0f;
    for (long r = r_begin + grp; r < r_end; r += SMALL_GROUPS) {
      s += __bfloat162float(job.src[size_t(r) * NW + col]);
    }
    red[grp][col][0] = s;
    __syncthreads();
    if (grp == 0) {
      float t = red[0][col][0];
#pragma unroll
      for (int q = 1; q < SMALL_GROUPS; ++q) t += red[q][col][0];
      out[job.out_off + col] = t;
    }
    return;
  }
  float acc[OUT + 1];   // 8 lanes of the product's row `col`, then sum(draw)[col]
#pragma unroll
  for (int o = 0; o <= OUT; ++o) acc[o] = 0.0f;
  const long r_last = (r_end < n) ? r_end : n;   // rows past n have draw = 0
  for (long r = r_begin + grp; r < r_last; r += SMALL_GROUPS) {
    const float a = __bfloat162float(job.src[size_t(r) * NW + col]);
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      const float d = __ldg(draw + size_t(r) * OUT + o);   // one address per warp
      acc[o] += a * __bfloat162float(__float2bfloat16(d));
    }
    if (col < OUT) acc[OUT] += __ldg(draw + size_t(r) * OUT + col);
  }
#pragma unroll
  for (int o = 0; o <= OUT; ++o) red[grp][col][o] = acc[o];
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int o = 0; o <= OUT; ++o) {
      float t = red[0][col][o];
#pragma unroll
      for (int q = 1; q < SMALL_GROUPS; ++q) t += red[q][col][o];
      if (o < OUT) {
        out[job.out_off + col * OUT + o] = t;
      } else if (col < OUT) {
        out[job.draw_sum_off + col] = t;
      }
    }
  }
}

// grads[i] = sum over the splits, in ascending order, of partials[s][i]
__global__ void __launch_bounds__(THREADS)
mlp_reduce_kernel(const float* __restrict__ partials, int n_splits, int grad_floats,
              float* __restrict__ grads) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= grad_floats) return;
  float s = 0.0f;
  for (int k = 0; k < n_splits; ++k) s += partials[size_t(k) * grad_floats + i];
  grads[i] = s;
}

inline long padded_rows(int n) { return (long(n) + TM - 1) / TM * TM; }
inline int split_count(int n) {
  return int((padded_rows(n) + SPLIT_ROWS - 1) / SPLIT_ROWS);
}

// The second pass on `stream`: dW products, small jobs, reduction. Returns
// the CUDA error code of the first failing call (0 on success).
inline int launch_second_pass(const DwParams& dp, int n_tiles, const SmallParams& sp,
                              int n_jobs, const float* draw, int n, int grad_floats,
                              float* partials, float* grads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(DW_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const long n_pad = padded_rows(n);
  const int n_splits = split_count(n);
  mlp_dw_kernel<<<dim3(n_tiles, n_splits), THREADS, DW_SMEM_BYTES, stream>>>(
      dp, n_pad, grad_floats, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mlp_small_kernel<<<dim3(n_splits, n_jobs), SMALL_GROUPS * NW, 0, stream>>>(
      sp, draw, n, n_pad, grad_floats, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mlp_reduce_kernel<<<dim3((grad_floats + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partials, n_splits, grad_floats, grads);
  return int(cudaGetLastError());
}


// ---- the single-head forward kernels (mlp_fwd.cu, mlpe_fwd.cu)

// activation tile + encoding tile + ring + warp scratch: 162,816 B at 64
// lanes, 178,176 B at 128
template <int E>
constexpr size_t fwd_smem_bytes =
    ACT_BYTES + emb_tile_bytes<E> + 2 * STAGE_BYTES + WSCR_BYTES;
constexpr size_t FWD_SMEM_BYTES = fwd_smem_bytes<EMB>;
static_assert(fwd_smem_bytes<EMB> <= SMEM_LIMIT && fwd_smem_bytes<EMB_TC> <= SMEM_LIMIT,
              "the forward fits one Hopper CTA at both widths");

template <int E>
struct FwdParamsT {
  const bf16* chunk[n_fwd_chunks<E>];   // source of each 64-row weight chunk
  const float* bias[N_LAYERS];          // (256,) f32 per hidden layer
  const bf16* ow;                       // (256, 8) bf16
  const float* ob;                      // (8,) f32
};
using FwdParams = FwdParamsT<EMB>;

// mats: n0w (E x 256), n1w, n2w, n3w, n4w (256x256), n5e (E x 256),
//       n5h, n6w, n7w (256x256), ow (256x8), all bf16 row-major (in, out);
// biases: n0b .. n4b, n5b, n6b, n7b (256 f32 each), ob (8 f32).
template <int E>
inline bool fill_fwd_params(const void* const* mats, const void* const* biases,
                            FwdParamsT<E>& p) {
  const bf16* m[10];
  for (int i = 0; i < 10; ++i) m[i] = static_cast<const bf16*>(mats[i]);
  const int g = fill_forward_chunks<E>(m, p.chunk, 0);
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = m[9];
  p.ob = static_cast<const float*>(biases[8]);
  return g == n_fwd_chunks<E>;
}


// raw[p, o] = sum_k nh8[p, k] * ow[k, o] + ob[o] in f32, a per-thread dot
// product (1/256 of the work): two threads per point, 4 lanes each. Rows
// past n are not stored.
__device__ __forceinline__ void raw_head(const bf16* act, const bf16* __restrict__ ow,
                                         const float* __restrict__ ob,
                                         float* __restrict__ out, long row0, int n,
                                         int tid) {
  const int pt = tid / 2;
  const int o0 = (tid % 2) * 4;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < NW; ++k) {
    const float a = __bfloat162float(act[pt * LDA + k]);
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += a * __bfloat162float(ow[k * OUT + o0 + q]);
  }
  if (row0 + pt < n) {
    float* dst = out + size_t(row0 + pt) * OUT + o0;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = s[q] + __ldg(ob + o0 + q);
  }
}

// ---- the in-kernel Fourier encoding (mlpe_fwd.cu, mlpe_bwd.cu)
//
// Lane c of the 64-lane encoding of a point x (3 f32), multires 10:
//   c < 3:        x[c]
//   3 <= c < 63:  sin(x[j] * 2^k + phase), k = (c - 3) / 6, j = (c - 3) % 3,
//                 phase = pi/2 on the cosine lanes ((c - 3) % 6 >= 3), else 0
//   c == 63:      0 (the pad lane)
// x[j] * 2^k is exact, the sum with the phase is one f32 rounding, and the
// sine is sinf (the arguments reach 2^9 |x|: no fast-math intrinsic).

constexpr int PTS = 3;                          // coordinates per point
constexpr float HALF_PI = 1.57079632679489661923f;   // float32(pi / 2)
static_assert(WSCR_BYTES >= size_t(TM) * PTS * sizeof(float),
              "the coordinate tile borrows the warp scratch");

// lanes 3 .. 62: the coordinate, the frequency and the phase of lane c
__device__ __forceinline__ void encoding_lane(int c, int& j, float& scale,
                                              float& phase) {
  const int rem = (c - 3) % 6;
  j = rem % 3;
  scale = float(1 << ((c - 3) / 6));
  phase = rem >= 3 ? HALF_PI : 0.0f;
}

// the tile's 128 x 3 f32 coordinates of pts (n, 3) into shared memory; rows
// past n are zero
__device__ __forceinline__ void load_coords(float* xs, const float* __restrict__ pts,
                                            long row0, int n, int tid) {
  for (int i = tid; i < TM * PTS; i += THREADS) {
    xs[i] = (row0 + i / PTS < n) ? pts[size_t(row0) * PTS + i] : 0.0f;
  }
}

// the bf16 encoding tile (row stride LDE) from the coordinate tile; rows at
// and past rows_left are zero. With `copy` (the tile's rows of a row-padded
// (n_pad, 64) global array) the tile is stored there too, for the dW products.
__device__ __forceinline__ void encode_tile(bf16* embs, const float* xs, long rows_left,
                                            int tid, bf16* copy) {
  for (int i = tid; i < TM * EMB / 8; i += THREADS) {
    const int r = i / (EMB / 8);
    const int c0 = (i % (EMB / 8)) * 8;
    __align__(16) bf16 ov[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      float v = 0.0f;
      if (r < rows_left && c < 3) {
        v = xs[r * PTS + c];
      } else if (r < rows_left && c < EMB - 1) {
        int j;
        float scale, phase;
        encoding_lane(c, j, scale, phase);
        v = sinf(__fadd_rn(__fmul_rn(xs[r * PTS + j], scale), phase));
      }
      ov[e] = __float2bfloat16(v);
    }
    const uint4 pk = *reinterpret_cast<const uint4*>(ov);
    *reinterpret_cast<uint4*>(embs + r * LDE + c0) = pk;
    if (copy != nullptr) {
      *reinterpret_cast<uint4*>(copy + size_t(r) * EMB + c0) = pk;
    }
  }
}

// ---- what the single-head backward kernels share (mlp_bwd.cu, mlpe_bwd.cu),
// in a namespace of its own: mlpv_bwd.cu has another gradient layout

namespace single_head {

static_assert(WSCR_BYTES >= DRAW_BYTES, "the draw tile borrows the warp scratch");

// offsets (in floats) of the 19 gradients in one flat pack-order buffer at an
// encoding of E lanes:
// n0w n0b n1w n1b n2w n2b n3w n3b n4w n4b n5e n5h n5b n6w n6b n7w n7b ow ob
template <int E>
struct GradLayout {
  static constexpr int WW = NW * NW, EW = E * NW;
  static constexpr int OFF_N0W = 0;
  static constexpr int OFF_N0B = OFF_N0W + EW;
  static constexpr int OFF_N1W = OFF_N0B + NW;
  static constexpr int OFF_N1B = OFF_N1W + WW;
  static constexpr int OFF_N2W = OFF_N1B + NW;
  static constexpr int OFF_N2B = OFF_N2W + WW;
  static constexpr int OFF_N3W = OFF_N2B + NW;
  static constexpr int OFF_N3B = OFF_N3W + WW;
  static constexpr int OFF_N4W = OFF_N3B + NW;
  static constexpr int OFF_N4B = OFF_N4W + WW;
  static constexpr int OFF_N5E = OFF_N4B + NW;
  static constexpr int OFF_N5H = OFF_N5E + EW;
  static constexpr int OFF_N5B = OFF_N5H + WW;
  static constexpr int OFF_N6W = OFF_N5B + NW;
  static constexpr int OFF_N6B = OFF_N6W + WW;
  static constexpr int OFF_N7W = OFF_N6B + NW;
  static constexpr int OFF_N7B = OFF_N7W + WW;
  static constexpr int OFF_OW = OFF_N7B + NW;
  static constexpr int OFF_OB = OFF_OW + NW * OUT;
  static constexpr int FLOATS = OFF_OB + OUT;
  // 64-row blocks of the 9 weight gradients: 28 + 2 * E/64
  static constexpr int DW_TILES = 7 * (NW / 64) + 2 * (E / 64);
};
constexpr int GRAD_FLOATS = GradLayout<EMB>::FLOATS;
static_assert(GRAD_FLOATS == 495624 && GradLayout<EMB_TC>::FLOATS == 528392,
              "pack-order layout");

// the chain kernel's schedule: the recompute's chunks, then the dh chain's
template <int E> constexpr int n_chain_chunks = n_fwd_chunks<E> + n_bwd_chunks<E>;
constexpr int N_CHAIN_CHUNKS = n_chain_chunks<EMB>;

template <int E>
struct ChainParamsT {
  const bf16* chunk[n_chain_chunks<E>];   // source of each 64-row weight chunk
  const float* bias[N_LAYERS];            // (256,) f32 per hidden layer
  const bf16* ow;                         // (256, 8) bf16
};
using ChainParams = ChainParamsT<EMB>;

// mats: n0w (E x 256), n1w..n4w (256x256), n5e (E x 256), n5h, n6w, n7w
//       (256x256), ow (256x8), bf16 row-major (in, out);
// biases: n0b..n4b, n5b, n6b, n7b (256 f32 each), ob (unused in a backward).
template <int E>
inline bool fill_chain_params(const void* const* mats, const void* const* biases,
                              ChainParamsT<E>& p) {
  const bf16* m[10];
  for (int i = 0; i < 10; ++i) m[i] = static_cast<const bf16*>(mats[i]);
  int g = fill_forward_chunks<E>(m, p.chunk, 0);
  g = fill_backward_chunks<E>(m, p.chunk, g);
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = m[9];
  return g == n_chain_chunks<E>;
}

// dh8 = bf16((bf16(draw) @ ow^T) * (nh8 > 0)) into `dst` and to global; K = 8,
// on the CUDA cores, one thread per column. `drs`: room for the (128, 8) draw
// tile (rounded to bf16, rows past n zero); nh8 is the tile `act`.
__device__ __forceinline__ void dh8_from_draw(const float* __restrict__ draw, long row0,
                                              int n, const bf16* __restrict__ ow,
                                              float* drs, const bf16* act, bf16* dst,
                                              bf16* dh8, int tid) {
  for (int i = tid; i < TM * OUT; i += THREADS) {
    const long r = row0 + i / OUT;
    drs[i] = (r < n) ? __bfloat162float(__float2bfloat16(draw[size_t(r) * OUT + i % OUT]))
                     : 0.0f;
  }
  float w8[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) w8[o] = __bfloat162float(ow[tid * OUT + o]);
  __syncthreads();
  for (int r = 0; r < TM; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int o = 0; o < OUT; ++o) s += drs[r * OUT + o] * w8[o];
    const bool on = __bfloat162float(act[r * LDA + tid]) > 0.0f;
    const bf16 v = __float2bfloat16(on ? s : 0.0f);
    dst[r * LDA + tid] = v;
    dh8[size_t(r) * NW + tid] = v;
  }
  __syncthreads();
}

// Sizes of the buffers a single-head backward needs for n points at an
// encoding of E lanes: the bf16 scratch (emb copy + nh1..nh8 + dh1..dh8, rows
// padded to 128) in elements, and the f32 partials (one flat pack-order
// gradient per 2048-point split).
template <int E = EMB>
inline void chain_bwd_sizes(int n, long long* scratch_elems, long long* partial_floats) {
  *scratch_elems = (long long)padded_rows(n) * (E + 2 * N_LAYERS * NW);
  *partial_floats = (long long)split_count(n) * GradLayout<E>::FLOATS;
}

// The second pass over a chain kernel's scratch (embp of E lanes, then
// nh1..nh8, then dh1..dh8): the 9 products g_W = act^T @ dh in 64-row tiles,
// the bias sums of dh1 .. dh8, g_ow = nh8^T @ bf16(draw) with g_ob, and the
// reduction.
template <int E = EMB>
inline int launch_chain_second_pass(bf16* scratch, const float* draw, int n,
                                    float* partials, float* grads,
                                    cudaStream_t stream) {
  using L = GradLayout<E>;
  static_assert(L::DW_TILES <= MAX_DW_TILES, "the job list holds every tile");
  const long n_pad = padded_rows(n);
  const size_t layer_stride = size_t(n_pad) * NW;
  const bf16* embp = scratch;
  const bf16* nh = embp + size_t(n_pad) * E;
  const bf16* dh = nh + N_LAYERS * layer_stride;
  DwParams dp;
  struct Prod { const bf16* a; int lda; const bf16* b; int off; };
  auto nh_l = [&](int l) { return nh + size_t(l - 1) * layer_stride; };
  auto dh_l = [&](int l) { return dh + size_t(l - 1) * layer_stride; };
  const Prod prods[9] = {
      {embp, E, dh_l(1), L::OFF_N0W},     {nh_l(1), NW, dh_l(2), L::OFF_N1W},
      {nh_l(2), NW, dh_l(3), L::OFF_N2W}, {nh_l(3), NW, dh_l(4), L::OFF_N3W},
      {nh_l(4), NW, dh_l(5), L::OFF_N4W}, {embp, E, dh_l(6), L::OFF_N5E},
      {nh_l(5), NW, dh_l(6), L::OFF_N5H}, {nh_l(6), NW, dh_l(7), L::OFF_N6W},
      {nh_l(7), NW, dh_l(8), L::OFF_N7W}};
  constexpr int ROWS = 64;   // activation columns (rows of a dW) per tile
  int t = 0;
  for (const Prod& pr : prods) {
    for (int c = 0; c < pr.lda; c += ROWS) {
      dp.tile[t++] = DwTile{pr.a, pr.b, pr.lda, c, pr.off + c * NW};
    }
  }
  if (t != L::DW_TILES) return int(cudaErrorInvalidValue);

  SmallParams sp;
  const int bias_off[N_LAYERS] = {L::OFF_N0B, L::OFF_N1B, L::OFF_N2B, L::OFF_N3B,
                                  L::OFF_N4B, L::OFF_N5B, L::OFF_N6B, L::OFF_N7B};
  for (int l = 0; l < N_LAYERS; ++l) sp.job[l] = SmallJob{dh_l(l + 1), bias_off[l], -1};
  sp.job[N_LAYERS] = SmallJob{nh_l(8), L::OFF_OW, L::OFF_OB};

  return launch_second_pass(dp, L::DW_TILES, sp, N_LAYERS + 1, draw, n, L::FLOATS,
                            partials, grads, stream);
}

}  // namespace single_head

}  // namespace
