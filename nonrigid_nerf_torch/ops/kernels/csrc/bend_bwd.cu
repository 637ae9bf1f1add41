// The deformation field backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bend_core_bwd` / `_bend_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:542-627,651-671). Inputs: pts
// (n, 3), lat (n, 32), and the cotangents of the forward's outputs: demb
// (n, 64) (from `mlp_bwd` in the split variant), doff (n, 3), drig (n, 1),
// all f32. Outputs: dpts (n, 3), dlat (n, 32) and the 16 weight gradients
// in pack order (b0p b0l b0b b1w b1b b2w b2b b3w b3b bow r0w r0b r1w r1b row
// rob), f32, summed over all points. Nothing comes back for P or the phase:
// they are constants of the encoding.
//
// What bounds it: 552 bytes per point that the function must move (pts,
// lat, demb, doff, drig in; dpts, dlat out) against 3 x 16,896 padded MACs
// per point (the forward recomputed, the cotangent chain, the weight
// products): the memory, demb's 256 B first. What holds it back is the
// chain of dependent steps a tile takes.
//
// Design: mlp_sm90.cuh's `bend_bwd_sm90_kernel`, persistent CTAs of two
// warpgroups, each on 64-point tiles of its own: the forward recomputed
// with rows 7 and 9's device code (`bender_rows`), the 64-lane products of
// the cotangent chain and the weight gradients on wgmma (the gradients kept
// in registers across the tiles), the 3- and 32-lane work on the CUDA
// cores; one partial per CTA, then `mlp_reduce_kernel` sums the partials in
// ascending order. No atomics: bit-equal from run to run.
//
// Plain C interface, bound with ctypes (see ../bend_bwd.py).

#include "mlp_sm90.cuh"

// The f32 partials the caller allocates for n points (one flat pack-order
// gradient per CTA).
extern "C" void nrnerf_bend_bwd_sizes(int n, long long* partial_floats) {
  *partial_floats = (long long)sm90::bend_bwd_grid(n) * sm90::BEND_GRAD_FLOATS;
}

// pts (n, 3), lat (n, 32) (16-byte aligned), demb (n, 64), doff (n, 3),
// drig (n, 1) f32; weights: the 18 cast bender weights
// (ops/kernels/bend_fwd.py:cast_bend_weights, contiguous), which each CTA
// stages as the bender's backward image (mlp_sm90.py:pack_bend_image(bw,
// backward=True)); partials sized by nrnerf_bend_bwd_sizes; dpts (n, 3),
// dlat (n, 32) f32; grads: 17,224 f32, the 16 gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_bend_bwd(const void* pts, const void* lat, const void* demb,
                               const void* doff, const void* drig, int n,
                               const void* const* weights, void* partials, void* dpts,
                               void* dlat, void* grads, void* stream) {
  return sm90::launch_bend_backward(
      weights, static_cast<const float*>(pts), static_cast<const float*>(lat),
      static_cast<const float*>(demb), static_cast<const float*>(doff),
      static_cast<const float*>(drig), n, static_cast<float*>(partials),
      static_cast<float*>(dpts), static_cast<float*>(dlat), static_cast<float*>(grads),
      static_cast<cudaStream_t>(stream));
}
