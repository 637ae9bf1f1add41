// Canonical NeRF MLP forward on bent POINTS: the Fourier encoding is computed
// inside the kernel (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_mlpe_core` / `_mlpe_pallas_fwd`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:902-947), whose math is
// `_embed_ew` (fused_query.py:891-899) followed by `_mlp_fwd_math`:
//
//   pre = pts @ P          (each column of P has one entry, a power of two)
//   emb = where(lane < 3, pre, sin(pre + phase))      in f32, then bf16
//   raw = the 8 x 256 chain and the raw head of mlp_fwd.cu on emb
//
// The cosine lanes are sin(pre + pi/2), as in `_embed_ew`: cos(pre) would
// differ by the rounding of the sum and flip bf16 roundings.
//
// What bounds it: mlp_fwd.cu's 493,568 MACs per point, 60 sines, and 44 bytes
// of HBM traffic per point (12 B of f32 coordinates in, 32 B of raw out)
// against mlp_fwd.cu's 160: the tensor cores bound it. What the mode saves is
// outside the kernel: no encoding tensor between the stages.
//
// Design: row 1's kernel (mlp_sm90.cuh's `mlp_fwd_kernel<E, In>`: persistent
// CTAs, two consumer warpgroups of 64 rows, wgmma, the mbarrier weight ring
// of row 1's 30-chunk image) on another input, `sm90::PtsFwdIn`:
// - the encoding runs off the consumers' warps: the producer warpgroup's
//   three warps that the weight stream leaves idle encode each tile into
//   one of two encoding tiles (three FMAs against P, sinf past lane 2,
//   bf16), a tile or two ahead, with a full / empty mbarrier pair per tile.
//   197,760 B of shared memory. On the consumers' warps, before the chain
//   or once layer 5 had read the tile, the sines stayed on the chain's
//   critical path (see PERF.md);
// - the arithmetic is `encode_piece`, which row 6 (mlpe_bwd.cu) recomputes
//   for the same points: the backward sees the forward's encoding bit for
//   bit. The coordinates are read one f32 at a time, as they stand (the
//   TPU kernel pads them to 8 lanes; no pad copy here, any alignment).
//
// Plain C interface, bound with ctypes (see ../mlpe_fwd.py).

#include "mlp_sm90.cuh"

// pts (n, 3) f32, out (n, 8) f32; image: the chain's forward chunks at 64
// lanes (ops/kernels/mlp_sm90.py:pack_chain_image(mw, ("fwd",))), 30 x 32
// KB; P (3, 64) and phase (64,) f32: the encoding's projection; mats and
// biases as nrnerf_mlp_fwd lists them (of mats only ow is read).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlpe_fwd(const void* pts, int n, const void* image, const void* P,
                               const void* phase, const void* const* mats,
                               const void* const* biases, void* out, void* stream) {
  const sm90::PtsFwdIn in{static_cast<const float*>(pts), static_cast<const float*>(P),
                          static_cast<const float*>(phase)};
  return sm90::launch_fwd<sm90::EMB>(in, n, image, mats, biases, static_cast<float*>(out),
                                     static_cast<cudaStream_t>(stream));
}
