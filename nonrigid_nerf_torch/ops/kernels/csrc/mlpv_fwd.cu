// View-direction canonical NeRF MLP forward for Hopper (sm_90a): the 8 x 256
// chain with the skip at layer 4, then the feature, alpha, views and rgb
// heads.
//
// Replaces the Pallas TPU kernel `_mlpv_core` / `_mlpv_pallas_fwd`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:1180-1200), whose math is
// `_mlpv_fwd_math` (fused_query.py:1050-1072):
//
//   nh1 .. nh8 as in mlp_fwd.cu
//   feat = bf16(nh8 @ fw + fb)                          (NO activation)
//   hv   = bf16(relu(feat @ vwf + embv @ vwv + vb))     (128 wide)
//   raw  = hv @ rw + rb + nh8 @ aw + ab                 (f32, 8 lanes: the
//                                        packing puts rgb in 0:3, alpha in 3)
//
// bf16 x bf16 products accumulate in f32. Inputs: emb (n, 64) and embv
// (n, 32) bf16 (27 view-encoding channels + 5 zero lanes).
//
// What bounds it: 596,992 MACs per point against 224 bytes of HBM traffic
// (128 + 64 B in, 32 B of f32 raw out), so the tensor cores bound it.
//
// Design: mlp_fwd.cu's, from mlp_tile.cuh (one CTA of 8 warps per 128-point
// tile, the activation tile in shared memory, one weight ring across all
// layers), and for the heads:
// - the schedule grows to 39 chunks: the chain's 30, four 64 x 256 chunks of
//   fw, four 64 x 128 chunks of vwf and the 32 x 128 vwv;
// - nh8 feeds two heads, and the feature layer overwrites it in place. So
//   the alpha product nh8 @ aw (a per-thread f32 dot product, as mlp_fwd's
//   head) is taken right after the chain and parked, with both biases, in a
//   4 KB shared-memory tile that the same thread reads back at the end;
// - the views layer accumulates feat @ vwf (4 chunks) and embv @ vwv (the
//   short chunk, 2 k-steps) into the same fragments, each warp a 64 x 32
//   block, and writes hv over columns 0..127 of the tile;
// - the rgb product hv @ rw is the same per-thread dot product over 128.
// Rows past n are zero-filled on load and masked on store. No atomics.
//
// Plain C interface, bound with ctypes (see ../mlpv_fwd.py).

#include "mlp_tile.cuh"

namespace {

constexpr int N_CHUNKS = N_FWD_CHUNKS + 4 + 4 + 1;
constexpr int G_VWF = N_FWD_CHUNKS + 4;   // first chunk of vwf
constexpr int G_VWV = G_VWF + 4;          // the chunk of vwv

constexpr size_t SMEM_BYTES = ACT_BYTES + EMB_BYTES + VEMB_BYTES +
                              2 * STAGE_BYTES + WSCR_BYTES + DRAW_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");

struct Params {
  const bf16* chunk[N_CHUNKS];   // source of each weight chunk
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const float* fb;               // (256,) f32
  const float* vb;               // (128,) f32
  const bf16* aw;                // (256, 8) bf16
  const bf16* rw;                // (128, 8) bf16
  const float* ab;               // (8,) f32
  const float* rb;               // (8,) f32
};

__global__ void __launch_bounds__(THREADS, 1)
mlpv_fwd_kernel(const bf16* __restrict__ emb, const bf16* __restrict__ embv, int n,
                Params p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  bf16* act = reinterpret_cast<bf16*>(at);
  at += ACT_BYTES;
  bf16* embs = reinterpret_cast<bf16*>(at);
  at += EMB_BYTES;
  bf16* embvs = reinterpret_cast<bf16*>(at);
  at += VEMB_BYTES;
  bf16* stage = reinterpret_cast<bf16*>(at);
  at += 2 * STAGE_BYTES;
  float* scratch = reinterpret_cast<float*>(at);
  at += WSCR_BYTES;
  float* raw_s = reinterpret_cast<float*>(at);   // (128, 8) f32

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long row0 = long(blockIdx.x) * TM;

  auto prefetch = [&](int g) {
    if (g < G_VWF) {
      load_chunk(stage_of(stage, g), p.chunk[g], tid);
    } else if (g < G_VWV) {
      load_rows<KC, VW>(stage_of(stage, g), p.chunk[g], tid);
    } else if (g < N_CHUNKS) {
      load_rows<VEMB, VW>(stage_of(stage, g), p.chunk[g], tid);
    }
  };
  prefetch(0);
  cp_async_commit();
  load_points<EMB, LDE>(embs, emb, row0, n, tid);
  load_points<VEMB, LDV>(embvs, embv, row0, n, tid);

  float* wscr = scratch + warp * 256;
  int g = 0;
  chain_forward(act, embs, stage, wscr, p.bias, g, prefetch, nullptr, 0, warp, lane);

  // alpha head, taken while the tile still holds nh8:
  // raw_s[p, o] = sum_k nh8[p, k] * aw[k, o] + ab[o] + rb[o], in f32
  const int pt = tid / 2;
  const int o0 = (tid % 2) * 4;
  {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < NW; ++k) {
      const float a = __bfloat162float(act[pt * LDA + k]);
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] += a * __bfloat162float(p.aw[k * OUT + o0 + q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      raw_s[pt * OUT + o0 + q] = s[q] + __ldg(p.ab + o0 + q) + __ldg(p.rb + o0 + q);
    }
  }

  // feat = bf16(nh8 @ fw + fb), in place; hv over columns 0..127
  linear_256(act, act, stage, wscr, p.fb, g, prefetch, warp, lane);
  views_forward(act, embvs, act, stage, wscr, p.vb, g, prefetch, warp, lane);

  // rgb head: raw[p, o] = raw_s[p, o] + sum_k hv[p, k] * rw[k, o]
  float s[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] = raw_s[pt * OUT + o0 + q];
  for (int k = 0; k < VW; ++k) {
    const float a = __bfloat162float(act[pt * LDA + k]);
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += a * __bfloat162float(p.rw[k * OUT + o0 + q]);
  }
  if (row0 + pt < n) {
    float* dst = out + size_t(row0 + pt) * OUT + o0;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = s[q];
  }
}

}  // namespace

// mats: n0w (64x256), n1w..n4w (256x256), n5e (64x256), n5h, n6w, n7w
//       (256x256), fw (256x256), aw (256x8), vwf (256x128), vwv (32x128),
//       rw (128x8), all bf16 row-major (in, out);
// biases: n0b..n4b, n5b, n6b, n7b, fb (256 f32 each), ab (8), vb (128),
//       rb (8).
// emb (n, 64) and embv (n, 32) bf16; out (n, 8) f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlpv_fwd(const void* emb, const void* embv, int n,
                               const void* const* mats, const void* const* biases,
                               void* out, void* stream) {
  Params p;
  const bf16* m[14];
  for (int i = 0; i < 14; ++i) m[i] = static_cast<const bf16*>(mats[i]);
  int g = fill_forward_chunks(m, p.chunk, 0);
  for (int c = 0; c < 4; ++c) p.chunk[g++] = m[9] + c * KC * NW;    // fw
  for (int c = 0; c < 4; ++c) p.chunk[g++] = m[11] + c * KC * VW;   // vwf
  p.chunk[g++] = m[12];                                              // vwv
  if (g != N_CHUNKS) return int(cudaErrorInvalidValue);
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.fb = static_cast<const float*>(biases[8]);
  p.ab = static_cast<const float*>(biases[9]);
  p.vb = static_cast<const float*>(biases[10]);
  p.rb = static_cast<const float*>(biases[11]);
  p.aw = m[10];
  p.rw = m[13];

  cudaError_t err = cudaFuncSetAttribute(
      mlpv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const dim3 grid((n + TM - 1) / TM);
  mlpv_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(emb), static_cast<const bf16*>(embv), n, p,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}
