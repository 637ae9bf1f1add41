// The fused point query backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_core_bwd` / `_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:317-456,463-494): the
// canonical MLP's backward (`_mlp_bwd_math`, as mlp_bwd.cu) on the encoding
// of the recomputed bent points, then the deformation field's backward
// (`_bend_bwd_kernel`, as bend_bwd.cu) from the encoding's gradient.
//
// Outputs: dpts (n, 3), dlat (n, 32) f32, the canonical MLP's 19 weight
// gradients in pack order (mlp_tile.cuh's layout) and the bender's 16
// (bend_tile.cuh's layout), f32, summed over all points.
//
// What bounds it: 1,531,392 padded MACs per point (the chain's 1,480,704,
// the bender's 3 x 16,896) against 328 bytes per point that the function
// must move (pts, lat, draw, doff, drig in; dpts, dlat out): the tensor
// cores.
//
// Design: four launches on one stream, no atomics, bit-equal from run to
// run.
// 1. `fused_bwd_chain_kernel`: mlp_bwd.cu's chain kernel with a prologue in
//    place of the encoding's load: bend_tile.cuh's forward in the activation
//    tile, then `encode_tile` into the encoding tile and its padded copy in
//    the scratch (where mlp_bwd.cu stores its copy: the same 8,320 B per
//    point). demb goes to an (n, 64) f32 buffer, as in mlp_bwd.cu.
// 2. mlp_tile.cuh's second pass: the chain's dW products and bias sums.
// 3. bend_tile.cuh's `bend_bwd_kernel` on demb, doff and drig, and its
//    reduction.
// Why demb goes through HBM (256 B per point each way, about 0.02 ms at
// 131,072 points, under 1% of the call), where mlpe_bwd.cu folds it onto
// the coordinates in registers: the JAX package holds this kernel and the
// split variant (`mlp_bwd` then `bend_bwd`) bit-equal in value and gradient
// (tests/test_fused_kernel.py:397-419). The fold must then see demb =
// dh6 @ n5e^T + dh1 @ n0w^T as one f32 sum, as the split's bend_bwd.cu sees
// it, and holding the first product on chip until the second comes would
// take 32 KB of shared memory where the chain kernel has 3 KB left. The
// bender's backward needs its four activation tiles and its gradient
// accumulator (225 KB) besides, which is why it is a kernel of its own.
//
// Plain C interface, bound with ctypes (see ../fused_bwd.py).

#include "mlp_tile.cuh"
#include "bend_tile.cuh"

namespace {

using namespace single_head;   // the gradient layout, ChainParams, dh8, pass 2

constexpr size_t SMEM_BYTES =
    2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES + WSCR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");

__global__ void __launch_bounds__(THREADS, 1)
fused_bwd_chain_kernel(BendParams bp, ChainParams p, const float* __restrict__ pts,
                       const float* __restrict__ lat, const float* __restrict__ draw,
                       int n, long n_pad, bf16* __restrict__ embp, bf16* nh, bf16* dh,
                       float* demb) {
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
  float* wscr = scratch + warp * 256;

  auto prefetch = [&](int g) {
    if (g < N_CHAIN_CHUNKS) load_chunk(stage_of(stage, g), p.chunk[g], tid);
  };
  prefetch(0);
  cp_async_commit();
  // the bender in the first activation tile (its 64-lane weights in the
  // ring's second stage, as in fused_fwd.cu), then the encoding (rows past n
  // zero) and its padded copy for the dW products
  const BendTile t = forward_tile(smem, bp, stage_of(stage, 1));
  stage_big_weights(stage_of(stage, 1), bp, tid);
  cp_async_commit();
  bend_forward(t, bp, pts, lat, row0, n, wscr, tid, warp, lane);
  encode_tile(embs, t.bent, long(n) - row0, tid, embp + size_t(row0) * EMB);

  int g = 0;
  // ---- recompute nh1 .. nh8, each stored to the scratch (as mlp_bwd.cu)
  chain_forward(buf_a, embs, stage, wscr, p.bias, g, prefetch, nh_t, layer_stride,
                warp, lane);
  // ---- dh8, then the dh chain and demb (as mlp_bwd.cu)
  dh8_from_draw(draw, row0, n, p.ow, scratch, buf_a, buf_b,
                dh_t + size_t(7) * layer_stride, tid);
  dh_chain(buf_b, buf_a, stage, wscr, g, prefetch, nh_t, dh_t, layer_stride,
           DembToGlobal{demb + size_t(row0) * EMB, long(n) - row0}, warp, lane);
}

}  // namespace

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// of the chain (as mlp_bwd.cu's) in elements, the chain's f32 partials, and
// the bender's f32 partials, in floats. demb is (n, 64) f32 besides.
extern "C" void nrnerf_fused_bwd_sizes(int n, long long* scratch_elems,
                                       long long* partial_floats,
                                       long long* bend_partial_floats) {
  chain_bwd_sizes(n, scratch_elems, partial_floats);
  *bend_partial_floats = (long long)bend_split_count(n) * BEND_GRAD_FLOATS;
}

// pts (n, 3), lat (n, 32), draw (n, 8), doff (n, 3), drig (n, 1) f32;
// bend_mats / bend_biases as `fill_bend_params` (bend_tile.cuh), mats /
// biases as `fill_chain_params` (mlp_tile.cuh) list them; scratch,
// partials, bend_partials sized by nrnerf_fused_bwd_sizes; demb (n, 64) f32
// (a buffer); dpts (n, 3), dlat (n, 32) f32; grads: the chain's 495,624 f32,
// bend_grads: the bender's 17,224 f32, both in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_fused_bwd(const void* pts, const void* lat, const void* draw,
                                const void* doff, const void* drig, int n,
                                const void* const* bend_mats,
                                const void* const* bend_biases,
                                const void* const* mats, const void* const* biases,
                                void* scratch, void* partials, void* demb,
                                void* bend_partials, void* dpts, void* dlat,
                                void* grads, void* bend_grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ChainParams p;
  if (!fill_chain_params(mats, biases, p)) return int(cudaErrorInvalidValue);
  const BendParams bp = fill_bend_params(bend_mats, bend_biases);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaErrorInvalidValue);

  const long n_pad = padded_rows(n);
  bf16* embp = static_cast<bf16*>(scratch);
  bf16* nh = embp + size_t(n_pad) * EMB;
  bf16* dh = nh + N_LAYERS * size_t(n_pad) * NW;
  const float* pts_f = static_cast<const float*>(pts);
  const float* lat_f = static_cast<const float*>(lat);
  const float* draw_f = static_cast<const float*>(draw);
  float* demb_f = static_cast<float*>(demb);

  fused_bwd_chain_kernel<<<dim3(unsigned(n_pad / TM)), THREADS, SMEM_BYTES, stream>>>(
      bp, p, pts_f, lat_f, draw_f, n, n_pad, embp, nh, dh, demb_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int e = launch_chain_second_pass(embp, draw_f, n, static_cast<float*>(partials),
                                         static_cast<float*>(grads), stream);
  if (e != 0) return e;
  return launch_bend_backward(bp, pts_f, lat_f, demb_f, static_cast<const float*>(doff),
                              static_cast<const float*>(drig), n,
                              static_cast<float*>(bend_partials),
                              static_cast<float*>(dpts), static_cast<float*>(dlat),
                              static_cast<float*>(bend_grads), stream);
}
