// View-direction canonical NeRF MLP backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlpv_core_bwd` / `_mlpv_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:1080-1177,1215-1237). It is
// NOT the autograd of the forward; the arithmetic it reproduces:
//
//   nh1..nh8, feat, hv recomputed in bf16 as in mlpv_fwd.cu;
//   drawb = bf16(draw);  g_rb = g_ab = sum(draw) over the points, f32, uncast;
//   g_rw  = hv^T @ drawb;       dhv = bf16((drawb @ rw^T) * (hv > 0))
//   g_vwf = feat^T @ dhv;  g_vwv = embv^T @ dhv;  g_vb = sum(dhv)
//   dfeat = bf16(dhv @ vwf^T)                     (feat has no activation)
//   dembv = dhv @ vwv^T                           (f32, no mask)
//   g_fw  = nh8^T @ dfeat;  g_fb = sum(dfeat);    g_aw = nh8^T @ drawb
//   dh8   = bf16((dfeat @ fw^T + drawb @ aw^T) * (nh8 > 0))
//   then the chain as in mlp_bwd.cu, down to demb.
//
// All products are bf16 x bf16 with f32 accumulation. Outputs: demb (n, 64)
// and dembv (n, 32) f32, and the 26 weight gradients in pack order, f32,
// summed over all points.
//
// What bounds it: 1,790,976 MACs per point (recompute + dh chain + dW)
// against 608 bytes of HBM traffic that the function must move, so the
// tensor cores bound it.
//
// Design: mlp_bwd.cu's two passes, from mlp_tile.cuh.
//
// 1. `mlpv_bwd_chain_kernel`, one CTA per 128-point tile: recomputes nh1..nh8
//    (tile A), feat (tile B) and hv (over columns 0..127 of tile B), then
//    walks back: dhv on the CUDA cores (K = 8) in place over hv; dfeat into
//    tile A (nh8's mask is read back from the scratch, as every mask is);
//    dembv; dh8 into tile B with the alpha path's 8-lane product added in the
//    epilogue; then mlp_bwd.cu's dh chain. One schedule of 78 weight chunks
//    feeds all of it: `dhv @ vwf^T` reads the forward's 64 x 128 chunks of
//    vwf as col-major operands, `dhv @ vwv^T` the 32 x 128 chunk. The
//    encoding tile's shared memory is dead after layer 5 of the recompute, so
//    the view-encoding tile and the draw tile are loaded into it after the
//    chain. The scratch holds emb, embv, nh1..nh8, feat, hv, dh1..dh8, dfeat
//    and dhv in bf16: 9,920 B per point.
// 2. `mlp_dw_kernel`: 39 blocks of the 12 dW products per 2048-point split
//    (the view-conditioned layer's are 128 wide, g_vwv is 32 rows);
//    `mlp_small_kernel`: ten bias sums, g_aw with g_ab, g_rw with g_rb;
//    `mlp_reduce_kernel` adds the splits in ascending order.
//
// No atomics anywhere: the same inputs give bit-equal outputs.
//
// Plain C interface, bound with ctypes (see ../mlpv_bwd.py).

#include "mlp_tile.cuh"

namespace {

// forward: chain 30, fw 4, vwf 4, vwv 1; backward: vwf 4, vwv 1, fw 4, chain 30
constexpr int G_VWF = N_FWD_CHUNKS + 4;
constexpr int G_VWV = G_VWF + 4;
constexpr int G_BWD_VWF = G_VWV + 1;
constexpr int G_BWD_VWV = G_BWD_VWF + 4;
constexpr int G_BWD_FW = G_BWD_VWV + 1;
constexpr int N_CHUNKS = G_BWD_FW + 4 + N_BWD_CHUNKS;
constexpr int N_DW_TILES = 39;
constexpr int N_SMALL_JOBS = 12;
constexpr int GRAD_FLOATS = 599440;
// bf16 elements of scratch per point
constexpr int SCRATCH_PER_POINT = EMB + VEMB + 2 * (N_LAYERS * NW + NW + VW);

constexpr size_t SMEM_BYTES =
    2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES + WSCR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");
static_assert(N_DW_TILES <= MAX_DW_TILES && N_SMALL_JOBS <= MAX_SMALL_JOBS,
              "the second pass's parameter blocks hold every job");

// offsets (in floats) of the 26 gradients in one flat pack-order buffer:
// n0w n0b n1w n1b n2w n2b n3w n3b n4w n4b n5e n5h n5b n6w n6b n7w n7b
// fw fb aw ab vwf vwv vb rw rb
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
constexpr int OFF_FW = OFF_N7B + NW;
constexpr int OFF_FB = OFF_FW + WW;
constexpr int OFF_AW = OFF_FB + NW;
constexpr int OFF_AB = OFF_AW + NW * OUT;
constexpr int OFF_VWF = OFF_AB + OUT;
constexpr int OFF_VWV = OFF_VWF + NW * VW;
constexpr int OFF_VB = OFF_VWV + VEMB * VW;
constexpr int OFF_RW = OFF_VB + VW;
constexpr int OFF_RB = OFF_RW + VW * OUT;
static_assert(OFF_RB + OUT == GRAD_FLOATS, "pack-order layout");

struct ChainParams {
  const bf16* chunk[N_CHUNKS];   // source of each weight chunk
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const float* fb;               // (256,) f32
  const float* vb;               // (128,) f32
  const bf16* aw;                // (256, 8) bf16
  const bf16* rw;                // (128, 8) bf16
};

// the row-padded scratch arrays of one call
struct Scratch {
  bf16* embp;    // (n_pad, 64)
  bf16* embvp;   // (n_pad, 32)
  bf16* nh;      // (8, n_pad, 256)
  bf16* feat;    // (n_pad, 256)
  bf16* hv;      // (n_pad, 128)
  bf16* dh;      // (8, n_pad, 256)
  bf16* dfeat;   // (n_pad, 256)
  bf16* dhv;     // (n_pad, 128)
};

__global__ void __launch_bounds__(THREADS, 1)
mlpv_bwd_chain_kernel(const bf16* __restrict__ emb, const bf16* __restrict__ embv,
                      const float* __restrict__ draw, int n, long n_pad,
                      ChainParams p, Scratch sc, float* demb, float* dembv) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf_a = reinterpret_cast<bf16*>(smem);
  bf16* buf_b = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* embs = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES);
  // after the recompute of the chain, in the encoding tile's place:
  bf16* embvs = embs;
  float* drs = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + VEMB_BYTES);
  bf16* stage = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES + EMB_BYTES);
  float* scratch = reinterpret_cast<float*>(
      smem + 2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long row0 = long(blockIdx.x) * TM;
  const long rows_left = long(n) - row0;
  const size_t layer_stride = size_t(n_pad) * NW;   // one nh_l or dh_l array
  bf16* nh_t = sc.nh + size_t(row0) * NW;           // this tile's rows
  bf16* dh_t = sc.dh + size_t(row0) * NW;
  bf16* dfeat_t = sc.dfeat + size_t(row0) * NW;
  bf16* dhv_t = sc.dhv + size_t(row0) * VW;
  const bf16* nh8_t = nh_t + size_t(7) * layer_stride;
  bf16* dh8_t = dh_t + size_t(7) * layer_stride;

  auto prefetch = [&](int g) {
    if (g >= N_CHUNKS) return;
    const bool narrow = g >= G_VWF && g < G_BWD_FW;
    if (!narrow) {
      load_chunk(stage_of(stage, g), p.chunk[g], tid);
    } else if (g == G_VWV || g == G_BWD_VWV) {
      load_rows<VEMB, VW>(stage_of(stage, g), p.chunk[g], tid);
    } else {
      load_rows<KC, VW>(stage_of(stage, g), p.chunk[g], tid);
    }
  };
  prefetch(0);
  cp_async_commit();
  // emb tile: rows past n are zero; the padded copy feeds the dW products
  load_points<EMB, LDE>(embs, emb, row0, n, tid, sc.embp);

  float* wscr = scratch + warp * 256;
  int g = 0;

  // ---- recompute nh1 .. nh8, feat and hv, each stored to the scratch
  chain_forward(buf_a, embs, stage, wscr, p.bias, g, prefetch, nh_t, layer_stride,
                warp, lane);
  // the encoding tile is read no more: embv and draw (rounded to bf16, rows
  // past n zero) take its place. The barriers of the next layer come before
  // their first use.
  load_points<VEMB, LDV>(embvs, embv, row0, n, tid, sc.embvp);
  for (int i = tid; i < TM * OUT; i += THREADS) {
    const long r = row0 + i / OUT;
    drs[i] = (r < n) ? __bfloat162float(__float2bfloat16(draw[size_t(r) * OUT + i % OUT]))
                     : 0.0f;
  }
  linear_256(buf_a, buf_b, stage, wscr, p.fb, g, prefetch,
             sc.feat + size_t(row0) * NW, warp, lane);
  views_forward(buf_b, embvs, buf_b, stage, wscr, p.vb, g, prefetch,
                sc.hv + size_t(row0) * VW, warp, lane);

  // ---- dhv = bf16((bf16(draw) @ rw^T) * (hv > 0)), in place over hv;
  // K = 8, on the CUDA cores: two threads per column, 64 rows each
  {
    const int col = tid % VW;
    const int r_begin = (tid / VW) * (TM / 2);
    float w8[OUT];
#pragma unroll
    for (int o = 0; o < OUT; ++o) w8[o] = __bfloat162float(p.rw[col * OUT + o]);
    for (int r = r_begin; r < r_begin + TM / 2; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int o = 0; o < OUT; ++o) s += drs[r * OUT + o] * w8[o];
      const bool on = __bfloat162float(buf_b[r * LDA + col]) > 0.0f;
      const bf16 v = __float2bfloat16(on ? s : 0.0f);
      buf_b[r * LDA + col] = v;
      dhv_t[size_t(r) * VW + col] = v;
    }
    __syncthreads();
  }

  AccFrag acc[4];
  // ---- dfeat = bf16(dhv @ vwf^T) into tile A: no mask, feat has no activation
  for (int c = 0; c < NW / KC; ++c, ++g) {
    ring_next(prefetch, g);
    mma_nt<VW, 4>(acc, buf_b, stage_of(stage, g), warp);
    for_each_run<4>(acc, wscr, warp, lane, [&](int row, int col, const float* v) {
      const int gcol = c * KC + col;
      store_run(v, nullptr, buf_a + row * LDA + gcol, dfeat_t + size_t(row) * NW + gcol);
    });
    __syncthreads();
  }

  // ---- dembv = dhv @ vwv^T (f32, no mask)
  {
    AccFrag acc2[2];
    ring_next(prefetch, g);
    mma_nt<VW, 2>(acc2, buf_b, stage_of(stage, g), warp);
    for_each_run<2>(acc2, wscr, warp, lane, [&](int row, int col, const float* v) {
      if (row < rows_left) {
        float* dst = dembv + size_t(row0 + row) * VEMB + col;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = v[e];
      }
    });
    __syncthreads();
    ++g;
  }

  // ---- dh8 = bf16((dfeat @ fw^T + bf16(draw) @ aw^T) * (nh8 > 0)) into tile B
  for (int c = 0; c < NW / KC; ++c, ++g) {
    ring_next(prefetch, g);
    mma_nt<NW, 4>(acc, buf_a, stage_of(stage, g), warp);
    for_each_run<4>(acc, wscr, warp, lane, [&](int row, int col, const float* v) {
      const int gcol = c * KC + col;
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float s = 0.0f;
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          s += drs[row * OUT + o] * __bfloat162float(p.aw[(gcol + e) * OUT + o]);
        }
        sum[e] = v[e] + s;
      }
      const size_t goff = size_t(row) * NW + gcol;
      store_run(sum, nh8_t + goff, buf_b + row * LDA + gcol, dh8_t + goff);
    });
    __syncthreads();
  }

  // ---- the dh chain: each step takes the 128 x 256 tile `cur` times W^T
  dh_chain(buf_b, buf_a, stage, wscr, g, prefetch, nh_t, dh_t, layer_stride,
           DembToGlobal{demb + size_t(row0) * EMB, rows_left}, warp, lane);
}

inline Scratch carve_scratch(void* base, long n_pad) {
  const size_t layer_stride = size_t(n_pad) * NW;
  Scratch sc;
  sc.embp = static_cast<bf16*>(base);
  sc.embvp = sc.embp + size_t(n_pad) * EMB;
  sc.nh = sc.embvp + size_t(n_pad) * VEMB;
  sc.feat = sc.nh + N_LAYERS * layer_stride;
  sc.hv = sc.feat + layer_stride;
  sc.dh = sc.hv + size_t(n_pad) * VW;
  sc.dfeat = sc.dh + N_LAYERS * layer_stride;
  sc.dhv = sc.dfeat + layer_stride;
  return sc;
}

}  // namespace

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// (rows padded to 128) in elements, and the f32 partials (one flat
// pack-order gradient per 2048-point split) in floats.
extern "C" void nrnerf_mlpv_bwd_sizes(int n, long long* scratch_elems,
                                      long long* partial_floats) {
  *scratch_elems = (long long)padded_rows(n) * SCRATCH_PER_POINT;
  *partial_floats = (long long)split_count(n) * GRAD_FLOATS;
}

// emb (n, 64) and embv (n, 32) bf16, draw (n, 8) f32; mats and biases as in
// nrnerf_mlpv_fwd:
// mats: n0w (64x256), n1w..n4w (256x256), n5e (64x256), n5h, n6w, n7w
//       (256x256), fw (256x256), aw (256x8), vwf (256x128), vwv (32x128),
//       rw (128x8), bf16 row-major (in, out);
// biases: n0b..n4b, n5b, n6b, n7b, fb (256 f32 each), ab, vb (128), rb; ab
//       and rb are unused here.
// scratch, partials: sized by nrnerf_mlpv_bwd_sizes; demb (n, 64) and dembv
// (n, 32) f32; grads: GRAD_FLOATS f32, the 26 gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_mlpv_bwd(const void* emb, const void* embv, const void* draw,
                               int n, const void* const* mats,
                               const void* const* biases, void* scratch,
                               void* partials, void* demb, void* dembv, void* grads,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* m[14];
  for (int i = 0; i < 14; ++i) m[i] = static_cast<const bf16*>(mats[i]);

  ChainParams p;
  int g = fill_forward_chunks(m, p.chunk, 0);
  for (int c = 0; c < 4; ++c) p.chunk[g++] = m[9] + c * KC * NW;    // fw
  for (int c = 0; c < 4; ++c) p.chunk[g++] = m[11] + c * KC * VW;   // vwf
  p.chunk[g++] = m[12];                                              // vwv
  for (int c = 0; c < 4; ++c) p.chunk[g++] = m[11] + c * KC * VW;   // vwf^T
  p.chunk[g++] = m[12];                                              // vwv^T
  for (int c = 0; c < 4; ++c) p.chunk[g++] = m[9] + c * KC * NW;    // fw^T
  g = fill_backward_chunks(m, p.chunk, g);
  if (g != N_CHUNKS) return int(cudaErrorInvalidValue);
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.fb = static_cast<const float*>(biases[8]);
  p.vb = static_cast<const float*>(biases[10]);
  p.aw = m[10];
  p.rw = m[13];

  cudaError_t err = cudaFuncSetAttribute(
      mlpv_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaErrorInvalidValue);

  const long n_pad = padded_rows(n);
  const size_t layer_stride = size_t(n_pad) * NW;
  const Scratch sc = carve_scratch(scratch, n_pad);

  mlpv_bwd_chain_kernel<<<dim3(unsigned(n_pad / TM)), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const bf16*>(embv),
      static_cast<const float*>(draw), n, n_pad, p, sc, static_cast<float*>(demb),
      static_cast<float*>(dembv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  // g_W = act^T @ dh: (act, its width, dh, its width, offset) per weight
  DwParams dp;
  struct Prod { const bf16* a; int lda; const bf16* b; int b_cols; int off; };
  auto nh_l = [&](int l) { return sc.nh + size_t(l - 1) * layer_stride; };
  auto dh_l = [&](int l) { return sc.dh + size_t(l - 1) * layer_stride; };
  const Prod prods[12] = {
      {sc.embp, EMB, dh_l(1), NW, OFF_N0W},  {nh_l(1), NW, dh_l(2), NW, OFF_N1W},
      {nh_l(2), NW, dh_l(3), NW, OFF_N2W},   {nh_l(3), NW, dh_l(4), NW, OFF_N3W},
      {nh_l(4), NW, dh_l(5), NW, OFF_N4W},   {sc.embp, EMB, dh_l(6), NW, OFF_N5E},
      {nh_l(5), NW, dh_l(6), NW, OFF_N5H},   {nh_l(6), NW, dh_l(7), NW, OFF_N6W},
      {nh_l(7), NW, dh_l(8), NW, OFF_N7W},   {nh_l(8), NW, sc.dfeat, NW, OFF_FW},
      {sc.feat, NW, sc.dhv, VW, OFF_VWF},    {sc.embvp, VEMB, sc.dhv, VW, OFF_VWV}};
  int t = 0;
  for (const Prod& pr : prods) {
    const int a_rows = pr.lda < EMB ? pr.lda : EMB;
    for (int c = 0; c < pr.lda; c += a_rows) {
      dp.tile[t++] = DwTile{pr.a, pr.b, pr.lda, c, a_rows, pr.b_cols,
                            pr.off + c * pr.b_cols};
    }
  }
  if (t != N_DW_TILES) return int(cudaErrorInvalidValue);

  // bias sums of dh1 .. dh8, dfeat and dhv; g_aw with g_ab; g_rw with g_rb
  SmallParams sp;
  const int bias_off[N_LAYERS] = {OFF_N0B, OFF_N1B, OFF_N2B, OFF_N3B,
                                  OFF_N4B, OFF_N5B, OFF_N6B, OFF_N7B};
  int j = 0;
  for (int l = 0; l < N_LAYERS; ++l) sp.job[j++] = SmallJob{dh_l(l + 1), NW, bias_off[l], -1};
  sp.job[j++] = SmallJob{sc.dfeat, NW, OFF_FB, -1};
  sp.job[j++] = SmallJob{sc.dhv, VW, OFF_VB, -1};
  sp.job[j++] = SmallJob{nh_l(8), NW, OFF_AW, OFF_AB};
  sp.job[j++] = SmallJob{sc.hv, VW, OFF_RW, OFF_RB};
  if (j != N_SMALL_JOBS) return int(cudaErrorInvalidValue);

  return launch_second_pass(dp, N_DW_TILES, sp, N_SMALL_JOBS,
                            static_cast<const float*>(draw), n, GRAD_FLOATS,
                            static_cast<float*>(partials),
                            static_cast<float*>(grads), stream);
}
