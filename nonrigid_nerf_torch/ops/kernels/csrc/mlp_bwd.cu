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

using namespace single_head;   // the gradient layout, ChainParams, dh8, pass 2

constexpr size_t SMEM_BYTES =
    2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES + WSCR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");

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
    if (g < N_CHAIN_CHUNKS) load_chunk(stage_of(stage, g), p.chunk[g], tid);
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

  // ---- dh8 = bf16((bf16(draw) @ ow^T) * (nh8 > 0)); the draw tile borrows
  // the warp scratch
  dh8_from_draw(draw, row0, n, p.ow, scratch, buf_a, buf_b,
                dh_t + size_t(7) * layer_stride, tid);

  // ---- the dh chain: each step takes the 128 x 256 tile `cur` times W^T
  dh_chain(buf_b, buf_a, stage, wscr, g, prefetch, nh_t, dh_t, layer_stride,
           DembToGlobal{demb + size_t(row0) * EMB, long(n) - row0}, warp, lane);
}

}  // namespace

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// (emb copy + nh1..nh8 + dh1..dh8, rows padded to 128) in elements, and the
// f32 partials (one flat pack-order gradient per 2048-point split) in floats.
extern "C" void nrnerf_mlp_bwd_sizes(int n, long long* scratch_elems,
                                     long long* partial_floats) {
  chain_bwd_sizes(n, scratch_elems, partial_floats);
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
  ChainParams p;
  if (!fill_chain_params(mats, biases, p)) return int(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaErrorInvalidValue);

  const long n_pad = padded_rows(n);
  bf16* embp = static_cast<bf16*>(scratch);
  bf16* nh = embp + size_t(n_pad) * EMB;
  bf16* dh = nh + N_LAYERS * size_t(n_pad) * NW;

  mlp_bwd_chain_kernel<<<dim3(unsigned(n_pad / TM)), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const float*>(draw), n, n_pad, p,
      embp, nh, dh, static_cast<float*>(demb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  return launch_chain_second_pass(embp, static_cast<const float*>(draw), n,
                                  static_cast<float*>(partials),
                                  static_cast<float*>(grads), stream);
}
