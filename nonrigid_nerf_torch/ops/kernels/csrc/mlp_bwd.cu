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
//    as mlp_fwd.cu does (mlp_tile.cuh: activation tile in shared memory,
//    weights streamed in 64-row chunks through a cp.async double buffer),
//    then runs the dh chain back. `dh @ W^T` reads the same contiguous
//    64-row weight chunks: a chunk holds W[i0:i0+64, :], which is the
//    col-major B operand of the 64 output columns i0.. (the wmma fragment is
//    loaded with the col_major tag; nothing is transposed in memory). The
//    ReLU mask comes from the recomputed bf16 activation. It writes demb and
//    stores emb, nh_l and dh_l in bf16 to a scratch buffer (8.1 KB per
//    point). Rows past n carry draw = 0, so their dh is exactly 0 and they
//    add nothing below.
// 2. `mlp_dw_kernel` (mlp_tile.cuh): every dW = act^T @ dh as a split-K product.
//    CTA (tile, split) forms a 64 x 256 block of one dW over 2048 points
//    (act^T is the col-major A operand of the row-major scratch) and writes
//    it to its own slot of a partials buffer. `mlp_small_kernel` does the same
//    for the bias sums, g_ow and g_ob on the CUDA cores.
// 3. `mlp_reduce_kernel` sums the partials of each output element over the
//    splits in ascending order.
//
// No atomics anywhere: the same inputs give bit-equal outputs.
//
// Plain C interface, bound with ctypes (see ../mlp_bwd.py).

#include "mlp_tile.cuh"

namespace {

constexpr int N_CHUNKS = N_FWD_CHUNKS + N_BWD_CHUNKS;
constexpr int N_DW_TILES = 30;     // 64-row blocks of the 9 weight gradients
constexpr int GRAD_FLOATS = 495624;

constexpr size_t SMEM_BYTES =
    2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES + WSCR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");
static_assert(WSCR_BYTES >= DRAW_BYTES, "the draw tile borrows the warp scratch");

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
  bf16* nh_t = nh + size_t(row0) * NW;              // this tile's rows
  bf16* dh_t = dh + size_t(row0) * NW;

  auto prefetch = [&](int g) {
    if (g < N_CHUNKS) load_chunk(stage_of(stage, g), p.chunk[g], tid);
  };
  prefetch(0);
  cp_async_commit();
  // emb tile: rows past n are zero; the padded copy feeds the dW products
  load_points<EMB, LDE>(embs, emb, row0, n, tid, embp);

  float* wscr = scratch + warp * 256;
  int g = 0;

  // ---- recompute nh1 .. nh8 (as mlp_fwd.cu), each stored to the scratch
  chain_forward(buf_a, embs, stage, wscr, p.bias, g, prefetch, nh_t, layer_stride,
                warp, lane);

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
    bf16* dh8 = dh_t + size_t(7) * layer_stride;
    for (int r = 0; r < TM; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int o = 0; o < OUT; ++o) s += drs[r * OUT + o] * w8[o];
      const bool on = __bfloat162float(buf_a[r * LDA + tid]) > 0.0f;
      const bf16 v = __float2bfloat16(on ? s : 0.0f);
      buf_b[r * LDA + tid] = v;
      dh8[size_t(r) * NW + tid] = v;
    }
    __syncthreads();
  }

  // ---- the dh chain: each step takes the 128 x 256 tile `cur` times W^T
  dh_chain(buf_b, buf_a, stage, wscr, g, prefetch, nh_t, dh_t, layer_stride,
           demb + size_t(row0) * EMB, long(n) - row0, warp, lane);
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
  int g = fill_forward_chunks(m, p.chunk, 0);
  g = fill_backward_chunks(m, p.chunk, g);
  if (g != N_CHUNKS) return int(cudaErrorInvalidValue);
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = m[9];

  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaErrorInvalidValue);

  const long n_pad = padded_rows(n);
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
      dp.tile[t++] = DwTile{pr.a, pr.b, pr.lda, c, EMB, NW, pr.off + c * NW};
    }
  }
  if (t != N_DW_TILES) return int(cudaErrorInvalidValue);

  // bias sums of dh1 .. dh8, then g_ow = nh8^T @ bf16(draw) with g_ob
  SmallParams sp;
  const int bias_off[N_LAYERS] = {OFF_N0B, OFF_N1B, OFF_N2B, OFF_N3B,
                                  OFF_N4B, OFF_N5B, OFF_N6B, OFF_N7B};
  for (int l = 0; l < N_LAYERS; ++l) sp.job[l] = SmallJob{dh_l(l + 1), NW, bias_off[l], -1};
  sp.job[N_LAYERS] = SmallJob{nh_l(8), NW, OFF_OW, OFF_OB};

  return launch_second_pass(dp, N_DW_TILES, sp, N_LAYERS + 1,
                            static_cast<const float*>(draw), n, GRAD_FLOATS,
                            static_cast<float*>(partials),
                            static_cast<float*>(grads), stream);
}
