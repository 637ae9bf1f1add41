// The deformation field backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bend_core_bwd` / `_bend_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:542-627,651-671); the math is
// in bend_tile.cuh. Inputs: pts (n, 3), lat (n, 32), and the cotangents of
// the forward's outputs: demb (n, 64) (from `mlp_bwd` in the split variant),
// doff (n, 3), drig (n, 1), all f32. Outputs: dpts (n, 3), dlat (n, 32) and
// the 16 weight gradients in pack order (b0p b0l b0b b1w b1b b2w b2b b3w b3b
// bow r0w r0b r1w r1b row rob), f32, summed over all points. Nothing comes
// back for P or the phase: they are constants of the encoding.
//
// What bounds it: 3 x 16,896 padded MACs per point (the forward recomputed,
// the cotangent chain and the weight products) against 552 bytes per point
// that the function must move (pts, lat, demb, doff, drig in; dpts, dlat
// out): the memory bounds it, demb's 256 B first.
//
// Design: `bend_bwd_kernel` of bend_tile.cuh, one CTA per 512 points, which
// recomputes the bender's activations of each 128-point tile in shared
// memory, folds demb onto the coordinates, runs the chains back and adds the
// tile's weight products into an f32 accumulator in shared memory; then
// `mlp_reduce_kernel` sums the CTAs' slots in ascending order. No atomics:
// bit-equal from run to run.
//
// Plain C interface, bound with ctypes (see ../bend_bwd.py).

#include "mlp_tile.cuh"
#include "bend_tile.cuh"

// The f32 partials the caller allocates for n points (one flat pack-order
// gradient per 512-point split).
extern "C" void nrnerf_bend_bwd_sizes(int n, long long* partial_floats) {
  *partial_floats = (long long)bend_split_count(n) * BEND_GRAD_FLOATS;
}

// pts (n, 3), lat (n, 32), demb (n, 64), doff (n, 3), drig (n, 1) f32; mats
// and biases as `fill_bend_params` (bend_tile.cuh) lists them; partials
// sized by nrnerf_bend_bwd_sizes; dpts (n, 3), dlat (n, 32) f32; grads:
// 17,224 f32, the 16 gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_bend_bwd(const void* pts, const void* lat, const void* demb,
                               const void* doff, const void* drig, int n,
                               const void* const* mats, const void* const* biases,
                               void* partials, void* dpts, void* dlat, void* grads,
                               void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  return launch_bend_backward(
      fill_bend_params(mats, biases), static_cast<const float*>(pts),
      static_cast<const float*>(lat), static_cast<const float*>(demb),
      static_cast<const float*>(doff), static_cast<const float*>(drig), n,
      static_cast<float*>(partials), static_cast<float*>(dpts),
      static_cast<float*>(dlat), static_cast<float*>(grads),
      static_cast<cudaStream_t>(stream));
}
