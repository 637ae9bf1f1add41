// Canonical NeRF MLP backward (8 x 256, skip at layer 4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlp_core_bwd` / `_mlp_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:786-793,833-858), whose math is
// `_mlp_bwd_math` (fused_query.py:702-767). It is NOT the autograd of the
// forward; the arithmetic it reproduces:
//
//   nh1..nh8 recomputed in bf16 from the bf16 encoding, as in mlp_fwd.cu;
//   drawb = bf16(draw);  g_ob = sum(draw) over the points, in f32, uncast;
//   g_ow  = nh8^T @ drawb
//   dh8   = bf16((drawb @ ow^T) * (nh8 > 0))
//   dh_l  = bf16((dh_{l+1} @ W_l^T) * (nh_l > 0))        l = 7 .. 1
//   g_W_l = nh_l^T @ dh_{l+1},  g_b_l = sum(dh_{l+1})    (f32 sums of the
//                                                          rounded values)
//   skip:  g_n5h = nh5^T @ dh6,  g_n5e = emb^T @ dh6,
//          demb  = dh6 @ n5e^T + dh1 @ n0w^T             (f32, no mask)
//
// All products are bf16 x bf16 with f32 accumulation. Outputs: demb (n, 64)
// f32 and the 19 weight gradients in pack order, f32, summed over all points.
//
// What bounds it: 1,480,704 MACs per point (recompute + dh chain + dW)
// against 416 bytes of HBM traffic that the function must move, so the
// tensor cores bound it.
//
// Design. The TPU kernel walks a sequential grid and adds each block's dW
// into 2.0 MB of VMEM accumulators. Here blocks run in parallel and a CTA has
// 227 KB, and the eight activations of one 128-point tile alone are 512 KB,
// so a single fused kernel would have to spill them to global memory anyway.
// Hence two passes with a fixed-order reduction (simple and right first):
//
// 1. `mlp_bwd_chain_kernel`, one CTA per 128-point tile: recomputes nh1..nh8
//    as mlp_fwd.cu does (activation tile in shared memory, weights streamed
//    in 64-row chunks through a cp.async double buffer), then runs the dh
//    chain back. `dh @ W^T` reads the same contiguous 64-row weight chunks:
//    a chunk holds W[i0:i0+64, :], which is the col-major B operand of the
//    64 output columns i0.. (the wmma fragment is loaded with the col_major
//    tag; nothing is transposed in memory). The ReLU mask comes from the
//    recomputed bf16 activation. It writes demb and stores emb, nh_l and
//    dh_l in bf16 to a scratch buffer (8.1 KB per point). Rows past n carry
//    draw = 0, so their dh is exactly 0 and they add nothing below.
// 2. `mlp_bwd_dw_kernel`: every dW = act^T @ dh as a split-K product. CTA
//    (tile, split) forms a 64 x 256 block of one dW over 2048 points (act^T
//    is the col-major A operand of the row-major scratch) and writes it to
//    its own slot of a partials buffer. `mlp_bwd_small_kernel` does the same
//    for the bias sums, g_ow and g_ob on the CUDA cores.
// 3. `mlp_bwd_reduce_kernel` sums the partials of each output element over
//    the splits in ascending order.
//
// No atomics anywhere: the same inputs give bit-equal outputs.
//
// Plain C interface, bound with ctypes (see ../mlp_bwd.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TM = 128;        // points per CTA of the chain kernel
constexpr int NW = 256;        // hidden width
constexpr int EMB = 64;        // encoding width (63 channels + 1 zero lane)
constexpr int OUT = 8;         // head width
constexpr int KC = 64;         // weight rows per staged chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int LDA = NW + 8;    // padded shared-memory row strides (halves)
constexpr int LDE = EMB + 8;
constexpr int LDW = NW + 8;
constexpr int N_LAYERS = 8;
constexpr int N_BWD_STEPS = 9;     // n7w n6w n5e n5h n4w n3w n2w n1w n0w
constexpr int N_CHUNKS = 60;       // forward 1 + 4*4 + (4 + 1) + 2*4 = 30,
                                   // backward 4*7 + 2 = 30
constexpr int SPLIT_ROWS = 2048;   // points per split of the dW products
constexpr int RK = 64;             // points per staged chunk of the dW kernel
constexpr int N_DW_TILES = 30;     // 64-row blocks of the 9 weight gradients
constexpr int GRAD_FLOATS = 495624;
constexpr int SMALL_GROUPS = 4;    // row groups per block of the small kernel

constexpr size_t ACT_BYTES = size_t(TM) * LDA * sizeof(bf16);
constexpr size_t EMB_BYTES = size_t(TM) * LDE * sizeof(bf16);
constexpr size_t STAGE_BYTES = size_t(KC) * LDW * sizeof(bf16);
constexpr size_t SCRATCH_BYTES = size_t(THREADS / 32) * 16 * 16 * sizeof(float);
constexpr size_t SMEM_BYTES =
    2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES + SCRATCH_BYTES;

constexpr int LDAS = EMB + 8;      // dW kernel: act chunk (RK x 64)
constexpr int LDBS = NW + 8;       //            dh chunk  (RK x 256)
constexpr size_t DW_A_BYTES = size_t(RK) * LDAS * sizeof(bf16);
constexpr size_t DW_B_BYTES = size_t(RK) * LDBS * sizeof(bf16);
constexpr size_t DW_SMEM_BYTES = 2 * (DW_A_BYTES + DW_B_BYTES);

static_assert(ACT_BYTES % 128 == 0 && EMB_BYTES % 128 == 0 &&
              STAGE_BYTES % 128 == 0 && DW_A_BYTES % 128 == 0 &&
              DW_B_BYTES % 128 == 0, "shared-memory regions stay aligned");
static_assert(SMEM_BYTES <= 232448, "fits one Hopper CTA");
static_assert(SCRATCH_BYTES >= size_t(TM) * OUT * sizeof(float),
              "the draw tile borrows the warp scratch");

// offsets (in floats) of the 19 gradients in one flat pack-order buffer:
// n0w n0b n1w n1b n2w n2b n3w n3b n4w n4b n5e n5h n5b n6w n6b n7w n7b ow ob
constexpr int WW = NW * NW, EW = EMB * NW;
constexpr int OFF_N0W = 0;
constexpr int OFF_N0B = OFF_N0W + EW;
constexpr int OFF_N1W = OFF_N0B + NW;
constexpr int OFF_N1B = OFF_N1W + WW;
constexpr int OFF_N2W = OFF_N1B + NW;
constexpr int OFF_N2B = OFF_N2W + WW;
constexpr int OFF_N3W = OFF_N2B + NW;
constexpr int OFF_N3B = OFF_N3W + WW;
constexpr int OFF_N4W = OFF_N3B + NW;
constexpr int OFF_N4B = OFF_N4W + WW;
constexpr int OFF_N5E = OFF_N4B + NW;
constexpr int OFF_N5H = OFF_N5E + EW;
constexpr int OFF_N5B = OFF_N5H + WW;
constexpr int OFF_N6W = OFF_N5B + NW;
constexpr int OFF_N6B = OFF_N6W + WW;
constexpr int OFF_N7W = OFF_N6B + NW;
constexpr int OFF_N7B = OFF_N7W + WW;
constexpr int OFF_OW = OFF_N7B + NW;
constexpr int OFF_OB = OFF_OW + NW * OUT;
static_assert(OFF_OB + OUT == GRAD_FLOATS, "pack-order layout");

struct ChainParams {
  const bf16* chunk[N_CHUNKS];   // source of each 64-row weight chunk
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const bf16* ow;                // (256, 8) bf16
};

// forward chunks per layer; layer 5 reads 4 chunks of n5h, then n5e on emb
__constant__ int kLayerChunks[N_LAYERS] = {1, 4, 4, 4, 4, 5, 4, 4};
// backward steps: the layer l whose dh_l the step produces (its mask is
// nh_l), or 0 for the two products that give demb
__constant__ int kBwdLayer[N_BWD_STEPS] = {7, 6, 0, 5, 4, 3, 2, 1, 0};

struct DwTile {
  const bf16* a;     // activations, row-major (n_pad, lda)
  const bf16* b;     // dh, row-major (n_pad, 256)
  int lda;           // 64 (emb) or 256
  int a_col;         // first of the 64 activation columns of this tile
  int out_off;       // offset of the tile's 64 x 256 block in the flat grads
};

struct DwParams {
  DwTile tile[N_DW_TILES];
};

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

// one 64 x 256 bf16 chunk (32 KB) = 2048 16-byte pieces, 8 per thread
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int tid) {
#pragma unroll
  for (int i = tid; i < KC * NW / 8; i += THREADS) {
    const int r = i / (NW / 8);
    const int c = (i % (NW / 8)) * 8;
    cp_async16(dst + r * LDW + c, src + r * NW + c);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_chain_kernel(const bf16* __restrict__ emb, const float* __restrict__ draw,
                     int n, long n_pad, ChainParams p, bf16* __restrict__ embp,
                     bf16* nh, bf16* dh, float* demb) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf_a = reinterpret_cast<bf16*>(smem);
  bf16* buf_b = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* embs = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES);
  bf16* stage = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES + EMB_BYTES);
  float* scratch = reinterpret_cast<float*>(
      smem + 2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long row0 = long(blockIdx.x) * TM;
  const size_t layer_stride = size_t(n_pad) * NW;   // one nh_l or dh_l array

  load_chunk(stage, p.chunk[0], tid);
  cp_async_commit();

  // emb tile: rows past n are zero; the padded copy feeds the dW products
  for (int i = tid; i < TM * EMB / 8; i += THREADS) {
    const int r = i / (EMB / 8);
    const int c = (i % (EMB / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) {
      v = *reinterpret_cast<const uint4*>(emb + size_t(row0 + r) * EMB + c);
    }
    *reinterpret_cast<uint4*>(embs + r * LDE + c) = v;
    *reinterpret_cast<uint4*>(embp + size_t(row0 + r) * EMB + c) = v;
  }

  float* wscr = scratch + warp * 256;
  const int er = lane / 2;          // epilogue: row within a 16 x 16 fragment
  const int ec = (lane % 2) * 8;    //           first of this lane's 8 columns
  int g = 0;

  // ---- recompute nh1 .. nh8 (as mlp_fwd.cu), each stored to the scratch
  {
    bf16* act = buf_a;
    const int wm = warp / 4;   // rows wm*64 .. +64
    const int wn = warp % 4;   // cols wn*64 .. +64
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
    for (int layer = 0; layer < N_LAYERS; ++layer) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

      const int n_chunks = kLayerChunks[layer];
      for (int c = 0; c < n_chunks; ++c, ++g) {
        load_chunk(stage + ((g + 1) & 1) * KC * LDW, p.chunk[g + 1], tid);
        cp_async_commit();
        cp_async_wait_1();   // chunk g has landed
        __syncthreads();     // ... for every thread, and so has the emb tile

        const bool from_emb = (layer == 0) || (layer == 5 && c == 4);
        const bf16* a_src = from_emb ? embs : act;
        const int lda = from_emb ? LDE : LDA;
        const int k0 = from_emb ? 0 : c * KC;
        const bf16* b_src = stage + (g & 1) * KC * LDW;

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
        __syncthreads();   // all reads of this stage and of act are done
      }

      // epilogue: act = bf16(relu(acc + bias)), in place, and to the scratch
      const float* bias = p.bias[layer];
      bf16* nh_l = nh + size_t(layer) * layer_stride;
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
            ov[e] = __float2bfloat16(fmaxf(v, 0.0f));
          }
          const uint4 pk = *reinterpret_cast<const uint4*>(ov);
          *reinterpret_cast<uint4*>(act + grow * LDA + gcol) = pk;
          *reinterpret_cast<uint4*>(nh_l + size_t(row0 + grow) * NW + gcol) = pk;
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }

  // ---- dh8 = bf16((bf16(draw) @ ow^T) * (nh8 > 0)); K = 8, on the CUDA cores
  {
    float* drs = scratch;   // (128, 8) draw tile, rounded to bf16, rows past n zero
    for (int i = tid; i < TM * OUT; i += THREADS) {
      const long r = row0 + i / OUT;
      drs[i] = (r < n) ? __bfloat162float(__float2bfloat16(draw[size_t(r) * OUT + i % OUT]))
                       : 0.0f;
    }
    float w8[OUT];
#pragma unroll
    for (int o = 0; o < OUT; ++o) w8[o] = __bfloat162float(p.ow[tid * OUT + o]);
    __syncthreads();
    bf16* dh8 = dh + size_t(7) * layer_stride;
    for (int r = 0; r < TM; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int o = 0; o < OUT; ++o) s += drs[r * OUT + o] * w8[o];
      const bool on = __bfloat162float(buf_a[r * LDA + tid]) > 0.0f;
      const bf16 v = __float2bfloat16(on ? s : 0.0f);
      buf_b[r * LDA + tid] = v;
      dh8[size_t(row0 + r) * NW + tid] = v;
    }
    __syncthreads();
  }

  // ---- the dh chain: each step takes the 128 x 256 tile `cur` times W^T
  {
    bf16* cur = buf_b;   // dh8
    bf16* oth = buf_a;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
    for (int step = 0; step < N_BWD_STEPS; ++step) {
      const int layer = kBwdLayer[step];          // 0: a demb product
      const int n_chunks = layer ? NW / KC : 1;
      for (int c = 0; c < n_chunks; ++c, ++g) {
        if (g + 1 < N_CHUNKS) {
          load_chunk(stage + ((g + 1) & 1) * KC * LDW, p.chunk[g + 1], tid);
        }
        cp_async_commit();   // an empty group at the end keeps the count even
        cp_async_wait_1();   // chunk g has landed
        __syncthreads();

        // out[:, c*64 + (0..64)] = cur (128 x 256) @ W[c*64 + (0..64), :]^T;
        // warp w owns rows w*16 .. +16
        const bf16* b_src = stage + (g & 1) * KC * LDW;
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll 4
        for (int kk = 0; kk < NW; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, cur + (warp * 16) * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
            wmma::load_matrix_sync(b, b_src + (j * 16) * LDW + kk, LDW);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }

        const int grow = warp * 16 + er;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(wscr, acc[j], 16, wmma::mem_row_major);
          __syncwarp();
          const int gcol = c * KC + j * 16 + ec;
          if (layer) {
            // dh_l = bf16(acc * (nh_l > 0)) -> the other tile and the scratch
            const size_t goff =
                size_t(layer - 1) * layer_stride + size_t(row0 + grow) * NW + gcol;
            const uint4 mk = *reinterpret_cast<const uint4*>(nh + goff);
            const bf16* mv = reinterpret_cast<const bf16*>(&mk);
            __align__(16) bf16 ov[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const bool on = __bfloat162float(mv[e]) > 0.0f;
              ov[e] = __float2bfloat16(on ? wscr[er * 16 + ec + e] : 0.0f);
            }
            const uint4 pk = *reinterpret_cast<const uint4*>(ov);
            *reinterpret_cast<uint4*>(oth + grow * LDA + gcol) = pk;
            *reinterpret_cast<uint4*>(dh + goff) = pk;
          } else if (row0 + grow < n) {
            // demb = dh6 @ n5e^T (step 2), + dh1 @ n0w^T (step 8): the same
            // lane owns the same elements both times
            float* dst = demb + size_t(row0 + grow) * EMB + gcol;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float v = wscr[er * 16 + ec + e];
              dst[e] = (step == 2) ? v : dst[e] + v;
            }
          }
          __syncwarp();
        }
        __syncthreads();   // this stage and `cur` are read, `oth` is written
      }
      if (layer) {
        bf16* t = cur;
        cur = oth;
        oth = t;
      }
    }
  }
}

// dW partials: CTA (tile, split) forms the 64 x 256 block
//   act[rows, a_col : a_col + 64]^T @ dh[rows, :]  over the split's rows
__global__ void __launch_bounds__(THREADS)
mlp_bwd_dw_kernel(DwParams p, long n_pad, float* __restrict__ partials) {
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
    for (int i = tid; i < RK * EMB / 8; i += THREADS) {
      const int r = i / (EMB / 8);
      const int c = (i % (EMB / 8)) * 8;
      cp_async16(a_dst + r * LDAS + c, t.a + size_t(r0 + r) * t.lda + t.a_col + c);
    }
    for (int i = tid; i < RK * NW / 8; i += THREADS) {
      const int r = i / (NW / 8);
      const int c = (i % (NW / 8)) * 8;
      cp_async16(b_dst + r * LDBS + c, t.b + size_t(r0 + r) * NW + c);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
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
    __syncthreads();
  }

  float* out = partials + size_t(blockIdx.y) * GRAD_FLOATS + t.out_off;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(out + (wm * 32 + i * 16) * NW + wn * 64 + j * 16,
                              acc[i][j], NW, wmma::mem_row_major);
    }
}

// Bias sums, g_ow and g_ob partials of one split, on the CUDA cores. The
// block's SMALL_GROUPS row groups each take every SMALL_GROUPS-th row of the
// split and are added in ascending order. blockIdx.y = 0..7: column j of
// dh_{y+1} is summed; blockIdx.y = 8: row k of g_ow = nh8^T @ bf16(draw) is
// formed, and columns 0..7 also sum the uncast draw.
__global__ void __launch_bounds__(SMALL_GROUPS * NW)
mlp_bwd_small_kernel(const bf16* __restrict__ nh8, const bf16* __restrict__ dh,
                     const float* __restrict__ draw, int n, long n_pad,
                     float* __restrict__ partials) {
  __shared__ float red[SMALL_GROUPS][NW][OUT + 1];
  const int col = threadIdx.x % NW;
  const int grp = threadIdx.x / NW;
  const long r_begin = long(blockIdx.x) * SPLIT_ROWS;
  const long r_end = (r_begin + SPLIT_ROWS < n_pad) ? r_begin + SPLIT_ROWS : n_pad;
  float* out = partials + size_t(blockIdx.x) * GRAD_FLOATS;
  if (blockIdx.y < N_LAYERS) {
    const int bias_off[N_LAYERS] = {OFF_N0B, OFF_N1B, OFF_N2B, OFF_N3B,
                                    OFF_N4B, OFF_N5B, OFF_N6B, OFF_N7B};
    const bf16* src = dh + size_t(blockIdx.y) * size_t(n_pad) * NW;
    float s = 0.0f;
    for (long r = r_begin + grp; r < r_end; r += SMALL_GROUPS) {
      s += __bfloat162float(src[size_t(r) * NW + col]);
    }
    red[grp][col][0] = s;
    __syncthreads();
    if (grp == 0) {
      float t = red[0][col][0];
#pragma unroll
      for (int q = 1; q < SMALL_GROUPS; ++q) t += red[q][col][0];
      out[bias_off[blockIdx.y] + col] = t;
    }
    return;
  }
  float acc[OUT + 1];   // 8 lanes of g_ow's row `col`, then g_ob[col]
#pragma unroll
  for (int o = 0; o <= OUT; ++o) acc[o] = 0.0f;
  const long r_last = (r_end < n) ? r_end : n;   // rows past n have draw = 0
  for (long r = r_begin + grp; r < r_last; r += SMALL_GROUPS) {
    const float a = __bfloat162float(nh8[size_t(r) * NW + col]);
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
        out[OFF_OW + col * OUT + o] = t;
      } else if (col < OUT) {
        out[OFF_OB + col] = t;
      }
    }
  }
}

// grads[i] = sum over the splits, in ascending order, of partials[s][i]
__global__ void __launch_bounds__(THREADS)
mlp_bwd_reduce_kernel(const float* __restrict__ partials, int n_splits,
                      float* __restrict__ grads) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= GRAD_FLOATS) return;
  float s = 0.0f;
  for (int k = 0; k < n_splits; ++k) s += partials[size_t(k) * GRAD_FLOATS + i];
  grads[i] = s;
}

inline long padded_rows(int n) { return (long(n) + TM - 1) / TM * TM; }
inline int split_count(int n) {
  return int((padded_rows(n) + SPLIT_ROWS - 1) / SPLIT_ROWS);
}

}  // namespace

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// (emb copy + nh1..nh8 + dh1..dh8, rows padded to 128) in elements, and the
// f32 partials (one flat pack-order gradient per 2048-point split) in floats.
extern "C" void nrnerf_mlp_bwd_sizes(int n, long long* scratch_elems,
                                     long long* partial_floats) {
  *scratch_elems = (long long)padded_rows(n) * (EMB + 2 * N_LAYERS * NW);
  *partial_floats = (long long)split_count(n) * GRAD_FLOATS;
}

// emb (n, 64) bf16, draw (n, 8) f32; mats and biases as in nrnerf_mlp_fwd:
// mats: n0w (64x256), n1w..n4w (256x256), n5e (64x256), n5h, n6w, n7w
//       (256x256), ow (256x8), bf16 row-major (in, out);
// biases: n0b..n4b, n5b, n6b, n7b (256 f32 each), ob (unused here).
// scratch, partials: sized by nrnerf_mlp_bwd_sizes; demb (n, 64) f32;
// grads: GRAD_FLOATS f32, the 19 gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_mlp_bwd(const void* emb, const void* draw, int n,
                              const void* const* mats, const void* const* biases,
                              void* scratch, void* partials, void* demb,
                              void* grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* m[10];
  for (int i = 0; i < 10; ++i) m[i] = static_cast<const bf16*>(mats[i]);

  ChainParams p;
  int g = 0;
  p.chunk[g++] = m[0];
  for (int layer = 1; layer <= 4; ++layer)
    for (int c = 0; c < 4; ++c) p.chunk[g++] = m[layer] + c * KC * NW;
  for (int c = 0; c < 4; ++c) p.chunk[g++] = m[6] + c * KC * NW;   // n5h
  p.chunk[g++] = m[5];                                               // n5e
  for (int layer = 7; layer <= 8; ++layer)
    for (int c = 0; c < 4; ++c) p.chunk[g++] = m[layer] + c * KC * NW;
  // backward: n7w n6w n5e n5h n4w n3w n2w n1w n0w
  const int bwd_mat[N_BWD_STEPS] = {8, 7, 5, 6, 4, 3, 2, 1, 0};
  for (int s = 0; s < N_BWD_STEPS; ++s) {
    const int n_chunks = (bwd_mat[s] == 5 || bwd_mat[s] == 0) ? 1 : 4;
    for (int c = 0; c < n_chunks; ++c) p.chunk[g++] = m[bwd_mat[s]] + c * KC * NW;
  }
  if (g != N_CHUNKS) return int(cudaErrorInvalidValue);
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = m[9];

  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(
      mlp_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(DW_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaErrorInvalidValue);

  const long n_pad = padded_rows(n);
  const int n_splits = split_count(n);
  const size_t layer_stride = size_t(n_pad) * NW;
  bf16* embp = static_cast<bf16*>(scratch);
  bf16* nh = embp + size_t(n_pad) * EMB;
  bf16* dh = nh + N_LAYERS * layer_stride;

  mlp_bwd_chain_kernel<<<dim3(unsigned(n_pad / TM)), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const float*>(draw), n, n_pad, p,
      embp, nh, dh, static_cast<float*>(demb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  // g_W = act^T @ dh: (act, dh, offset) per weight, in 64-row tiles
  DwParams dp;
  struct Prod { const bf16* a; int lda; const bf16* b; int off; };
  auto nh_l = [&](int l) { return nh + size_t(l - 1) * layer_stride; };
  auto dh_l = [&](int l) { return dh + size_t(l - 1) * layer_stride; };
  const Prod prods[9] = {
      {embp, EMB, dh_l(1), OFF_N0W},  {nh_l(1), NW, dh_l(2), OFF_N1W},
      {nh_l(2), NW, dh_l(3), OFF_N2W}, {nh_l(3), NW, dh_l(4), OFF_N3W},
      {nh_l(4), NW, dh_l(5), OFF_N4W}, {embp, EMB, dh_l(6), OFF_N5E},
      {nh_l(5), NW, dh_l(6), OFF_N5H}, {nh_l(6), NW, dh_l(7), OFF_N6W},
      {nh_l(7), NW, dh_l(8), OFF_N7W}};
  int t = 0;
  for (const Prod& pr : prods) {
    for (int c = 0; c < pr.lda; c += EMB) {
      dp.tile[t++] = DwTile{pr.a, pr.b, pr.lda, c, pr.off + c * NW};
    }
  }
  if (t != N_DW_TILES) return int(cudaErrorInvalidValue);
  mlp_bwd_dw_kernel<<<dim3(N_DW_TILES, n_splits), THREADS, DW_SMEM_BYTES, stream>>>(
      dp, n_pad, static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  mlp_bwd_small_kernel<<<dim3(n_splits, N_LAYERS + 1), SMALL_GROUPS * NW, 0, stream>>>(
      nh_l(8), dh, static_cast<const float*>(draw), n, n_pad,
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  mlp_bwd_reduce_kernel<<<dim3((GRAD_FLOATS + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(partials), n_splits, static_cast<float*>(grads));
  return int(cudaGetLastError());
}
