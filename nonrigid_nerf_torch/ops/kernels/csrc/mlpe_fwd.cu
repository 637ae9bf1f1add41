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
// Design: mlp_fwd.cu with another prologue. The tile's 128 x 3 coordinates
// are read as they stand (the TPU kernel pads them to 8 lanes; no pad copy
// here) into the warp scratch, each thread then computes 8 lanes of one row
// at a time and stores them as one 16-byte piece of the shared-memory
// encoding tile. Everything after that is mlp_tile.cuh's chain and head.
//
// Plain C interface, bound with ctypes (see ../mlpe_fwd.py).

#include "mlp_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 1)
mlpe_fwd_kernel(const float* __restrict__ pts, int n, FwdParams p,
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
  // the encoding: coordinates into the warp scratch, then the tile. The
  // chain's first barrier comes before the scratch is written again.
  load_coords(scratch, pts, row0, n, tid);
  __syncthreads();
  encode_tile(embs, scratch, long(n) - row0, tid, nullptr);

  int g = 0;
  chain_forward(act, embs, stage, scratch + warp * 256, p.bias, g, prefetch, nullptr,
                0, warp, lane);
  raw_head(act, p.ow, p.ob, out, row0, n, tid);
}

}  // namespace

// pts (n, 3) f32, out (n, 8) f32; mats and biases as `fill_fwd_params`
// (mlp_tile.cuh) lists them.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlpe_fwd(const void* pts, int n, const void* const* mats,
                               const void* const* biases, void* out,
                               void* stream) {
  FwdParams p;
  if (!fill_fwd_params(mats, biases, p)) return int(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(
      mlpe_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(FWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const dim3 grid((n + TM - 1) / TM);
  mlpe_fwd_kernel<<<grid, THREADS, FWD_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n, p, static_cast<float*>(out));
  return int(cudaGetLastError());
}
