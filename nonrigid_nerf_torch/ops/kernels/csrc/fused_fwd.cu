// The fused point query forward: deformation field, encoding and canonical
// 8 x 256 MLP in one kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_core` / `_fwd_pallas`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:263-304), whose math is
// `_forward_math` (fused_query.py:218-260): `_bend_fwd_math` (bend_tile.cuh),
// the bf16 encoding of the bent points, then mlp_fwd.cu's chain and raw head.
//
// Outputs: raw (n, 8) f32 (lanes 4..7 zero), the unmasked offsets (n, 3) and
// the rigidity (n, 1) f32.
//
// What bounds it: 510,464 padded MACs per point (16,896 of the bender, the
// chain's 493,568) against 188 bytes per point that the function must move
// (12 B of points and 128 B of latents in, 48 B out): the tensor cores.
//
// Design: row 1's kernel (mlp_sm90.cuh's `mlp_fwd_kernel<E, In>`: persistent
// CTAs, two consumer warpgroups of 64 rows, wgmma, the mbarrier weight ring of
// row 1's 30-chunk image) on the input `sm90::FusedFwdIn`, on a 2-stage ring:
// - each consumer warpgroup runs the bender's products for its 64 rows of
//   the next tile on wgmma (m64n32k16, m64n64k16) before it waits for this
//   tile's encoding; bh3 goes into its rows of the next tile's encoding tile,
//   the rigidity to shared memory and to rig;
// - the producer warpgroup's three idle warps, once both warpgroups are done
//   with a tile, sum the offsets (the 3-lane product bh3 @ bow), bend the
//   points and write the encoding over bh3 (row 5's handshake on two
//   encoding tiles);
// - the chain and the head are row 1's.
// Everything the bender reads but the points and latents is staged once per
// CTA from the 18 weights (`stage_bend_image`, 34,064 B, as rows 7, 8 and 10
// stage it); 204,176 B of shared memory in all, which leaves no room
// for a third stage (rows 1 and 5 run about 3% slower on two stages than on
// three on an H100, chip_variants.py fwd_2_stages).
// The bender is one device function (`bender_rows`) that bend_fwd.cu and
// fused_bwd.cu's pre-pass run too, and the encoding one (`encoding_of`), so
// this kernel and the split variant (bend_fwd.cu, then mlp_fwd.cu) give
// bit-equal outputs.
//
// Plain C interface, bound with ctypes (see ../fused_fwd.py).

#include "mlp_sm90.cuh"

// pts (n, 3) f32, lat (n, 32) f32 (16-byte aligned); bend_weights: the 18
// cast bender weights (ops/kernels/bend_fwd.py:cast_bend_weights,
// contiguous), which each CTA stages as the bender's image;
// image: the chain's forward chunks (pack_chain_image(mw, ("fwd",))), 30 x
// 32 KB; mats and biases as nrnerf_mlp_fwd lists them (of mats only ow is
// read); raw (n, 8), off (n, 3), rig (n, 1) f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_fused_fwd(const void* pts, const void* lat, int n,
                                const void* const* bend_weights, const void* image,
                                const void* const* mats, const void* const* biases,
                                void* raw, void* off, void* rig, void* stream) {
  sm90::FusedFwdIn in{static_cast<const float*>(pts), static_cast<const float*>(lat), {},
                      static_cast<float*>(off), static_cast<float*>(rig)};
  for (int i = 0; i < 18; ++i) in.bw.w[i] = bend_weights[i];
  return sm90::launch_fwd<sm90::EMB>(in, n, image, mats, biases, static_cast<float*>(raw),
                                     static_cast<cudaStream_t>(stream));
}
