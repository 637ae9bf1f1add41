// The deformation field forward (bending and rigidity networks, bent points,
// Fourier encoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bend_core` / `_bend_fwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:533-540,630-644), whose math is
// `_bend_fwd_math` (fused_query.py:511-530); see bend_tile.cuh.
//
// Outputs: emb (n, 64) f32, the encoding of the bent points, for `mlp_fwd`
// (the split variant, `fused_point_query_split`); the unmasked offsets
// (n, 3) f32 and the rigidity (n, 1) f32. The TPU kernel pads offsets and
// rigidity to 8 lanes; only lanes 0..2 and 0 carry values, and only those
// are written here.
//
// What bounds it: 16,896 padded MACs per point (about 15,900 of them nonzero)
// against 412 bytes per point that the function must move (12 B of points
// and 128 B of latents in, 256 B of encoding and 16 B of offsets and
// rigidity out): at the card's ratio of 295 operations per byte the memory
// bounds it, and the encoding's 256 B dominate. No design choice changes
// that: the encoding is this kernel's output.
//
// Design: bend_tile.cuh's forward on a 128-point tile per CTA, its weights
// read from global memory (L1/L2; 52 KB of shared memory and 76 registers
// leave room for three CTAs per SM, which hide each other's latencies: a
// persistent grid that stages the weights into shared memory once per CTA
// took 255 registers, one CTA per SM, and was 18% slower on an H100), then
// every thread writes lanes of the f32 encoding, consecutive threads on
// consecutive lanes.
//
// Plain C interface, bound with ctypes (see ../bend_fwd.py).

#include "mlp_tile.cuh"
#include "bend_tile.cuh"

namespace {

constexpr size_t SMEM_BYTES = BEND_FWD_TILE_BYTES + WSCR_BYTES;

__global__ void __launch_bounds__(THREADS)
bend_fwd_kernel(BendParams p, const float* __restrict__ pts, const float* __restrict__ lat,
                int n, float* __restrict__ emb, float* __restrict__ off,
                float* __restrict__ rig) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BendTile t = forward_tile(smem, p);
  float* scratch = reinterpret_cast<float*>(smem + BEND_FWD_TILE_BYTES);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long row0 = long(blockIdx.x) * TM;
  const long rows_left = long(n) - row0;

  bend_forward(t, p, pts, lat, row0, n, scratch + warp * 256, tid, warp, lane);
  store_bend_outputs(t, off, rig, row0, n, tid);
  for (int i = tid; i < TM * EMB; i += THREADS) {
    const int r = i / EMB, c = i % EMB;
    if (r < rows_left) emb[size_t(row0) * EMB + i] = encoding_value(t.bent + r * PTS, c);
  }
}

}  // namespace

// pts (n, 3) f32, lat (n, 32) f32; mats and biases as `fill_bend_params`
// (bend_tile.cuh) lists them; emb (n, 64), off (n, 3), rig (n, 1) f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_bend_fwd(const void* pts, const void* lat, int n,
                               const void* const* mats, const void* const* biases,
                               void* emb, void* off, void* rig, void* stream) {
  const BendParams p = fill_bend_params(mats, biases);
  cudaError_t err = cudaFuncSetAttribute(
      bend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  bend_fwd_kernel<<<dim3((n + TM - 1) / TM), THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(pts), static_cast<const float*>(lat), n,
      static_cast<float*>(emb), static_cast<float*>(off), static_cast<float*>(rig));
  return int(cudaGetLastError());
}
