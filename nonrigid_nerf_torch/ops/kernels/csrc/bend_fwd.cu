// The deformation field forward (bending and rigidity networks, bent points,
// Fourier encoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bend_core` / `_bend_fwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:533-540,630-644), whose math is
// `_bend_fwd_math` (fused_query.py:511-530).
//
// Outputs: emb (n, 64) f32, the encoding of the bent points, for `mlp_fwd`
// (the split variant, `fused_point_query_split`); the unmasked offsets
// (n, 3) f32 and the rigidity (n, 1) f32. The TPU kernel pads offsets and
// rigidity to 8 lanes; only lanes 0..2 and 0 carry values, and only those
// are written here.
//
// What bounds it: 412 bytes per point that the function must move (12 B of
// points and 128 B of latents in, 256 B of encoding and 16 B of offsets and
// rigidity out) against 16,896 padded MACs and 60 sines per point: at the
// card's ratio of 295 operations per byte the memory bounds it, and the
// encoding's 256 B dominate.
//
// Design: mlp_sm90.cuh's `bend_fwd_sm90_kernel<false>`, persistent CTAs of
// three groups on 64-point tiles: a consumer warpgroup runs row 9's bender
// (`bender_rows`: wgmma from the bender's image, staged once per CTA from
// the weights) on tiles that arrive by bulk copy into a 2-stage ring, and an
// encoder warpgroup sums the offsets, bends the points and writes the
// encoding with 16-byte stores while the consumer runs the next tile's
// products (chip_variants.py's bend_groups_* time the other splits). The
// bender's device code is row 9's and row 10's pre-pass's, so the split and
// the monolith give bit-equal bent points.
//
// Plain C interface, bound with ctypes (see ../bend_fwd.py).

#include "mlp_sm90.cuh"

// pts (n, 3) f32, lat (n, 32) f32 (16-byte aligned); weights: the 18 cast
// bender weights (ops/kernels/bend_fwd.py:cast_bend_weights, contiguous),
// which each CTA stages as the bender's image (mlp_sm90.py:pack_bend_image);
// emb (n, 64), off (n, 3), rig (n, 1) f32. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int nrnerf_bend_fwd(const void* pts, const void* lat, int n,
                               const void* const* weights, void* emb, void* off, void* rig,
                               void* stream) {
  return sm90::launch_bend_forward<false>(
      weights, static_cast<const float*>(pts), static_cast<const float*>(lat), n, n, emb,
      static_cast<float*>(off), static_cast<float*>(rig), static_cast<cudaStream_t>(stream));
}
