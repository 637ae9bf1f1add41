// The fused point query backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_core_bwd` / `_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:317-456,463-494): the
// canonical MLP's backward (`_mlp_bwd_math`, as mlp_bwd.cu) on the encoding
// of the recomputed bent points, then the deformation field's backward
// (`_bend_bwd_kernel`, as bend_bwd.cu) from the encoding's gradient.
//
// Outputs: dpts (n, 3), dlat (n, 32) f32, the canonical MLP's 19 weight
// gradients in pack order (mlp_tile.cuh's single_head::GradLayout) and the
// bender's 16 (mlp_sm90.cuh's layout), f32, summed over all points.
//
// What bounds it: 1,531,392 padded MACs per point (the chain's 1,480,704,
// the bender's 3 x 16,896) against 328 bytes per point that the function
// must move (pts, lat, draw, doff, drig in; dpts, dlat out): the tensor
// cores.
//
// Design: one C entry, on one stream, no atomics, bit-equal from run to run:
// 1. The bender's pre-pass: row 7's kernel (mlp_sm90.cuh's
//    `bend_fwd_sm90_kernel<true>`, row 9's bender on wgmma) writes the bf16
//    encoding of the bent points (zero past n) straight into the encoding
//    rows of the chain's scratch, where the dW products read it: no f32
//    encoding, no copy.
// 2. Row 2's kernels on mlp_sm90.cuh (`launch_single_head_bwd`): the chain
//    kernel on `EncodingIn<EMB, false>`, which loads the tile's encoding
//    from the scratch and does not store it back; demb goes to an (n, 64)
//    f32 buffer; then the dW products on wgmma with the bias sums and the
//    head sums; then mlp_reduce_kernel over the splits.
// 3. Row 8's `launch_bend_backward` on demb, doff and drig, and its
//    reduction.
// Why demb goes through HBM (256 B per point each way, under 2% of the
// call), where mlpe_bwd.cu folds it onto the coordinates in registers: the
// JAX package holds this kernel and the split variant (`mlp_bwd` then
// `bend_bwd`) bit-equal in value and gradient (tests/test_fused_kernel.py:
// 397-419). The fold must then see demb = dh6 @ n5e^T + dh1 @ n0w^T as one
// f32 sum, as the split's bend_bwd.cu sees it; and row 2's chain kernel
// has 1,920 B of shared memory left, no room for the bender's tiles, which
// is why the bender's forward and backward run as kernels of their own (the
// JAX package split its variant for the same kind of reason,
// fused_query.py:500-505). Steps 1 and 3 are the split's own kernels (rows
// 7 and 8), so the two variants share the bender's device code.
//
// Plain C interface, bound with ctypes (see ../fused_bwd.py).

#include "mlp_sm90.cuh"
#include "mlp_tile.cuh"

namespace {

using namespace single_head;   // the gradient layout, the sizes

}  // namespace

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// of the chain (the encoding, nh1..nh8, dh1..dh8, as mlp_bwd.cu's) in
// elements, the chain's f32 partials, and the bender's f32 partials, in
// floats. demb is (n, 64) f32 besides.
extern "C" void nrnerf_fused_bwd_sizes(int n, long long* scratch_elems,
                                       long long* partial_floats,
                                       long long* bend_partial_floats) {
  chain_bwd_sizes(n, scratch_elems, partial_floats);
  *bend_partial_floats = (long long)sm90::bend_bwd_grid(n) * sm90::BEND_GRAD_FLOATS;
}

// pts (n, 3), lat (n, 32) (16-byte aligned), draw (n, 8), doff (n, 3), drig
// (n, 1) f32; bend_weights: the 18 cast bender weights
// (ops/kernels/bend_fwd.py:cast_bend_weights, contiguous), which rows 7 and
// 8's kernels stage as the bender's image; image: the chain's forward then
// backward chunks
// (ops/kernels/mlp_sm90.py:pack_chain_image(mw, ("fwd", "bwd"))), 60 x 32
// KB; mats / biases as nrnerf_mlp_bwd lists them (of mats only ow is read);
// scratch, partials, bend_partials sized by nrnerf_fused_bwd_sizes; demb
// (n, 64) f32 (a buffer); dpts (n, 3), dlat (n, 32) f32; grads: the chain's
// 495,624 f32, bend_grads: the bender's 17,224 f32, both in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_fused_bwd(const void* pts, const void* lat, const void* draw,
                                const void* doff, const void* drig, int n,
                                const void* const* bend_weights, const void* image,
                                const void* const* mats, const void* const* biases,
                                void* scratch, void* partials, void* demb,
                                void* bend_partials, void* dpts, void* dlat,
                                void* grads, void* bend_grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return int(cudaErrorInvalidValue);
  const float* pts_f = static_cast<const float*>(pts);
  const float* lat_f = static_cast<const float*>(lat);
  const float* draw_f = static_cast<const float*>(draw);
  float* demb_f = static_cast<float*>(demb);
  const long n_pad = padded_rows(n);
  const int n_splits = split_count(n);
  bf16* embp = static_cast<bf16*>(scratch);   // the scratch's encoding rows

  // the pre-pass: rows 0 .. n_pad - 1 of the scratch's (n_pad, 64) encoding
  int rc = sm90::launch_bend_forward<true>(bend_weights, pts_f, lat_f, n, n_pad, embp, nullptr,
                                           nullptr, stream);
  if (rc != 0) return rc;

  const sm90::EncodingIn<EMB, false> in{embp, demb_f};
  rc = sm90::launch_single_head_bwd<EMB, GradLayout<EMB>>(
      in, draw_f, n, n_pad, n_splits, image, mats, biases, scratch,
      static_cast<float*>(partials), stream);
  if (rc != 0) return rc;
  mlp_reduce_kernel<<<dim3((GRAD_FLOATS + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(partials), n_splits, GRAD_FLOATS, static_cast<float*>(grads));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return sm90::launch_bend_backward(bend_weights, pts_f, lat_f, demb_f,
                                    static_cast<const float*>(doff),
                                    static_cast<const float*>(drig), n,
                                    static_cast<float*>(bend_partials),
                                    static_cast<float*>(dpts), static_cast<float*>(dlat),
                                    static_cast<float*>(bend_grads), stream);
}
