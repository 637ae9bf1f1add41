// Canonical NeRF MLP forward (8 x 256, skip at layer 4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlp_core` / `_mlp_pallas_fwd`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:804-822), whose math is
// `_mlp_fwd_math` (fused_query.py:677-694):
//
//   nh1 = bf16(relu(emb @ n0w + n0b))
//   nh2..nh5 = bf16(relu(nh_i @ n_iw + n_ib))
//   nh6 = bf16(relu(nh5 @ n5h + emb @ n5e + n5b))      (the skip at layer 4)
//   nh7, nh8 as nh2
//   raw = nh8 @ ow + ob                                 (f32, 8 lanes)
//
// bf16 x bf16 products accumulate in f32; the f32 bias is added to the f32
// sum, ReLU is applied, and the result is rounded to bf16 before the next
// layer. The head stays f32.
//
// What bounds it: 493,568 MACs per point against 160 bytes of HBM traffic
// (128 B of bf16 encoding in, 32 B of f32 raw out), about 6,200 FLOP per
// byte, so the tensor cores bound it, never the memory.
//
// Design (simple and correct first; wgmma/TMA/persistent CTAs come later).
// The tile, the weight ring and the chain are mlp_tile.cuh's, shared with
// the other canonical-MLP kernels:
// - one CTA of 8 warps owns a tile of 128 points for all 9 layers;
// - the 128 x 256 bf16 activation tile stays in shared memory the whole
//   time. Each layer's accumulators live in registers, so the layer's
//   output overwrites its own input after a barrier (no ping-pong buffer);
// - the weights stream from global memory (L2-resident: 0.99 MB in all)
//   through a double-buffered ring of 64-row shared-memory chunks filled
//   with cp.async, one schedule of 30 chunks across all layers, so the next
//   layer's first chunk is in flight during the current layer's epilogue;
// - products use warp-level bf16 tensor-core MMA (nvcuda::wmma 16x16x16)
//   with f32 accumulators; each warp owns a 64 x 64 output block;
// - the 8-lane head is a per-thread f32 dot product (1/256 of the work);
// - rows past n are zero-filled on load and masked on store, so the caller
//   does not pad. No atomics: the result is deterministic.
//
// Plain C interface, bound with ctypes (see ../mlp_fwd.py).

#include "mlp_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const bf16* __restrict__ emb, int n, FwdParams p,
               float* __restrict__ out) {
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

  auto prefetch = [&](int g) {
    if (g < N_FWD_CHUNKS) load_chunk(stage_of(stage, g), p.chunk[g], tid);
  };
  prefetch(0);
  cp_async_commit();
  load_points<EMB, LDE>(embs, emb, row0, n, tid, nullptr);

  int g = 0;
  chain_forward(act, embs, stage, scratch + warp * 256, p.bias, g, prefetch, nullptr,
                0, warp, lane);

  // head: raw[p, o] = sum_k nh8[p, k] * ow[k, o] + ob[o], in f32
  raw_head(act, p.ow, p.ob, out, row0, n, tid);
}

}  // namespace

// emb (n, 64) bf16, out (n, 8) f32; mats and biases as `fill_fwd_params`
// (mlp_tile.cuh) lists them.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlp_fwd(const void* emb, int n, const void* const* mats,
                              const void* const* biases, void* out,
                              void* stream) {
  FwdParams p;
  if (!fill_fwd_params(mats, biases, p)) return int(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(FWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const dim3 grid((n + TM - 1) / TM);
  mlp_fwd_kernel<<<grid, THREADS, FWD_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(emb), n, p, static_cast<float*>(out));
  return int(cudaGetLastError());
}
