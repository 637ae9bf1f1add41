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
// Design: mlpe_fwd.cu with a bender prologue. Before the chain starts, the
// activation tile (66 KB) and the second stage of the weight ring (33 KB)
// are free: bend_tile.cuh's forward runs in the first (44 KB), its 64-lane
// weights are staged into the second, the bent points go through
// mlp_tile.cuh's `encode_tile` into the encoding tile, and the chain and the
// head follow unchanged. The chain's first weight chunk is in flight during
// the prologue. The encoding is bit-equal to the one bend_fwd.cu writes and
// mlp_fwd.cu rounds, so this kernel and the split variant give bit-equal
// outputs.
//
// Plain C interface, bound with ctypes (see ../fused_fwd.py).

#include "mlp_tile.cuh"
#include "bend_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 1)
fused_fwd_kernel(BendParams bp, FwdParams p, const float* __restrict__ pts,
                 const float* __restrict__ lat, int n, float* __restrict__ raw,
                 float* __restrict__ off, float* __restrict__ rig) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* embs = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* stage = reinterpret_cast<bf16*>(smem + ACT_BYTES + EMB_BYTES);
  float* scratch =
      reinterpret_cast<float*>(smem + ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long row0 = long(blockIdx.x) * TM;
  float* wscr = scratch + warp * 256;

  auto prefetch = [&](int g) {
    if (g < N_FWD_CHUNKS) load_chunk(stage_of(stage, g), p.chunk[g], tid);
  };
  prefetch(0);
  cp_async_commit();
  // the bender in the activation tile, its 64-lane weights in the ring's
  // second stage (chunk 1 goes there when the chain starts); the chain's
  // first barrier comes after the bender's last read of either
  const BendTile t = forward_tile(smem, bp, stage_of(stage, 1));
  stage_big_weights(stage_of(stage, 1), bp, tid);
  cp_async_commit();
  bend_forward(t, bp, pts, lat, row0, n, wscr, tid, warp, lane);
  store_bend_outputs(t, off, rig, row0, n, tid);
  encode_tile(embs, t.bent, long(n) - row0, tid, nullptr);

  int g = 0;
  chain_forward(act, embs, stage, wscr, p.bias, g, prefetch, nullptr, 0, warp, lane);
  raw_head(act, p.ow, p.ob, raw, row0, n, tid);
}

}  // namespace

// pts (n, 3) f32, lat (n, 32) f32; bend_mats and bend_biases as
// `fill_bend_params` (bend_tile.cuh) lists them, mats and biases as
// `fill_fwd_params` (mlp_tile.cuh); raw (n, 8), off (n, 3), rig (n, 1) f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_fused_fwd(const void* pts, const void* lat, int n,
                                const void* const* bend_mats,
                                const void* const* bend_biases,
                                const void* const* mats, const void* const* biases,
                                void* raw, void* off, void* rig, void* stream) {
  FwdParams p;
  if (!fill_fwd_params(mats, biases, p)) return int(cudaErrorInvalidValue);
  const BendParams bp = fill_bend_params(bend_mats, bend_biases);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(FWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  fused_fwd_kernel<<<dim3((n + TM - 1) / TM), THREADS, FWD_SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      bp, p, static_cast<const float*>(pts), static_cast<const float*>(lat), n,
      static_cast<float*>(raw), static_cast<float*>(off), static_cast<float*>(rig));
  return int(cudaGetLastError());
}
