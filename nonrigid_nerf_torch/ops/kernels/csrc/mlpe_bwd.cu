// Canonical NeRF MLP backward on bent POINTS: the Fourier encoding is
// recomputed inside the kernel and its gradient is folded onto the three
// coordinates on the chip (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_mlpe_core_bwd` / `_mlpe_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:909-926,960-985):
//
//   pre = pts @ P (three exact products: the entries of P are 0 or powers
//   of two);  emb = where(lane < 3, pre, sin(pre + phase));  embb = bf16(emb)
//   demb and the 19 weight gradients: mlp_bwd.cu's arithmetic on embb
//   dpre = where(lane < 3, demb, demb * cos(pre + phase))
//   dpts[:, d] = sum over the lanes of dpre * P[d]
//
// Outputs: dpts (n, 3) f32 and the 19 weight gradients in pack order, f32,
// summed over all points. Nothing comes back for P or the phase: they are
// constants of the encoding.
//
// What bounds it: mlp_bwd.cu's 1,480,704 MACs per point, 60 sines and 120
// cosines, against 56 bytes per point that the function must move (12 B of
// coordinates, 32 B of draw, 12 B of dpts) and the weights and gradients: the
// tensor cores bound it.
//
// Design: row 2's kernels (mlp_bwd.cu) on mlp_sm90.cuh, the same template
// instantiated on another input, `sm90::PtsIn`:
// - Prologue: each thread encodes its row's 32 lanes from the point it
//   loaded a tile ahead (three FMAs against P, sinf past lane 2), rounds to
//   bf16 and writes them into the encoding's place in tile B in the swizzled
//   layout. The bulk tensor store that row 2 uses for its copy of the
//   encoding sends it to the scratch, where the dW products g_n0w and g_n5e
//   read it: the scratch has row 2's layout, 8,320 B per point.
// - Sink: demb (128 x 64 f32 per tile) never reaches HBM. The dh chain hands
//   its two products (dh6 @ n5e^T, then dh1 @ n0w^T) over in the wgmma
//   accumulator layout; each value is multiplied by cosf(pre + phase) (the
//   identity on lanes 0-2) and by P's power of two and summed per row and
//   coordinate by its thread, the two products one after the other (the
//   fold is linear), then over the four threads that share a row by a
//   fixed-order shuffle. Bit-equal from run to run.
// - Second pass: row 2's, unchanged (the same 19 gradients and scratch):
//   dW on wgmma with the bias sums, the head sums, the fixed-order
//   reduction. No atomics anywhere.
// The weight image is row 2's at 64 lanes (ops/kernels/mlp_sm90.py:
// pack_chain_image(mw, ("fwd", "bwd"))); P and phase are f32 arguments.
//
// Plain C interface, bound with ctypes (see ../mlpe_bwd.py).

#include "mlp_sm90.cuh"
#include "mlp_tile.cuh"

namespace {

using namespace single_head;   // the gradient layout, the sizes, the reduce kernel

}  // namespace

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// (encoding + nh1..nh8 + dh1..dh8, rows padded to 128) in elements, and the
// f32 partials (one flat pack-order gradient per 2048-point split) in floats.
extern "C" void nrnerf_mlpe_bwd_sizes(int n, long long* scratch_elems,
                                      long long* partial_floats) {
  chain_bwd_sizes(n, scratch_elems, partial_floats);
}

// pts (n, 3) f32, draw (n, 8) f32; image: the chain's forward then backward
// chunks at 64 lanes (ops/kernels/mlp_sm90.py:pack_chain_image), 60 x 32 KB;
// P (3, 64) and phase (64,) f32: the encoding's projection; mats and biases
// as nrnerf_mlp_bwd lists them (of mats only ow is read). scratch,
// partials: sized by nrnerf_mlpe_bwd_sizes; dpts (n, 3) f32; grads:
// GRAD_FLOATS f32, the 19 gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_mlpe_bwd(const void* pts, const void* draw, int n, const void* image,
                               const void* P, const void* phase, const void* const* mats,
                               const void* const* biases, void* scratch, void* partials,
                               void* dpts, void* grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return int(cudaErrorInvalidValue);
  const int n_splits = split_count(n);
  const sm90::PtsIn in{static_cast<const float*>(pts), static_cast<const float*>(P),
                       static_cast<const float*>(phase), static_cast<float*>(dpts), {}, {}};
  const int rc = sm90::launch_single_head_bwd<EMB, GradLayout<EMB>>(
      in, static_cast<const float*>(draw), n, padded_rows(n), n_splits, image, mats, biases,
      scratch, static_cast<float*>(partials), stream);
  if (rc != 0) return rc;
  mlp_reduce_kernel<<<dim3((GRAD_FLOATS + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(partials), n_splits, GRAD_FLOATS, static_cast<float*>(grads));
  return int(cudaGetLastError());
}
