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

constexpr size_t SMEM_BYTES = ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES + WSCR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");

struct Params {
  const bf16* chunk[N_FWD_CHUNKS];   // source of each 64-row weight chunk
  const float* bias[N_LAYERS];       // (256,) f32 per hidden layer
  const bf16* ow;                    // (256, 8) bf16
  const float* ob;                   // (8,) f32
};

__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const bf16* __restrict__ emb, int n, Params p,
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
  const int pt = tid / 2;
  const int o0 = (tid % 2) * 4;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < NW; ++k) {
    const float a = __bfloat162float(act[pt * LDA + k]);
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += a * __bfloat162float(p.ow[k * OUT + o0 + q]);
  }
  if (row0 + pt < n) {
    float* dst = out + size_t(row0 + pt) * OUT + o0;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = s[q] + __ldg(p.ob + o0 + q);
  }
}

}  // namespace

// mats: n0w (64x256), n1w, n2w, n3w, n4w (256x256), n5e (64x256),
//       n5h, n6w, n7w (256x256), ow (256x8), all bf16 row-major (in, out);
// biases: n0b .. n4b, n5b, n6b, n7b (256 f32 each), ob (8 f32).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlp_fwd(const void* emb, int n, const void* const* mats,
                              const void* const* biases, void* out,
                              void* stream) {
  Params p;
  const bf16* m[10];
  for (int i = 0; i < 10; ++i) m[i] = static_cast<const bf16*>(mats[i]);
  if (fill_forward_chunks(m, p.chunk, 0) != N_FWD_CHUNKS) {
    return int(cudaErrorInvalidValue);
  }
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = m[9];
  p.ob = static_cast<const float*>(biases[8]);

  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const dim3 grid((n + TM - 1) / TM);
  mlp_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(emb), n, p, static_cast<float*>(out));
  return int(cudaGetLastError());
}
