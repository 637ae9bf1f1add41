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
// Design: mlp_fwd.cu's (mlp_sm90.cuh: persistent CTAs on a static tile
// schedule, two consumer warpgroups of 64 rows each, one producer thread
// that streams a pre-packed weight image through the mbarrier ring of 3
// stages of 32 KB, wgmma from the 128-byte-swizzled tiles, epilogues from
// the accumulator layout), with the heads after the chain:
// - the image is the forward-only part of mlpv_bwd.cu's: its first 39
//   chunks (ops/kernels/mlp_sm90.py:pack_views_image(mw, ("fwd",))), the
//   chain's 30, fw's 4, vwf's 4 and vwv's 1; a view-layer stage expects the
//   16 KB its copy moves (views_chunk_bytes);
// - shared memory: the 128 x 256 activation tile, emb (one k-atom) and embv
//   zero-padded to 64 lanes (another), the ring, the barriers: 197,760 B;
// - nh1 .. nh8 on the header's chain_tile; the next tile's emb is loaded
//   by cp.async once layer 5 has read the tile's, as in row 1;
// - the alpha product nh8 @ aw + ab + rb is a per-thread f32 dot product
//   (two threads a point, 4 lanes each) taken while the tile holds nh8, its
//   4 sums kept in registers until the same thread adds the rgb terms of the
//   same point: nothing is parked in shared memory. (Taken under fw's
//   products, 64 lanes a chunk, it ran 1% slower: chip_variants.py.);
// - feat = bf16(nh8 @ fw + fb) in place over nh8 (m64n256k16, fw's 4
//   chunks), then hv on m64n128k16 over vwf's 4 chunks and vwv's K = 32 on
//   the embv atom, into the first 64 floats of the same accumulator array
//   (a second array makes ptxas spill and serialize the wgmma); hv's
//   epilogue writes it into the tile's atoms 0-1;
// - embv is read only by hv's products, so the next tile's embv is loaded
//   into the same atom once they have completed: it has the rgb head and a
//   whole chain to land, and no second atom is needed. The two loads are
//   cp.async groups of their own, waited for with wait_group 1 (the other,
//   newer group may still be in flight);
// - the rgb product hv @ rw is the same per-thread dot product over 128
//   lanes, added to the alpha sums, then stored.
// Rows past n are zero-filled on load and masked on store. No atomics: the
// result is deterministic.
//
// Plain C interface, bound with ctypes (see ../mlpv_fwd.py).

#include "mlp_sm90.cuh"

namespace sm90 {
namespace {

// the activation tile, emb and embv (zero-padded to 64 lanes) as two
// k-atoms, the ring: the forward's plan with two encoding tiles
constexpr size_t SMEM_BYTES = fwd_smem_bytes<EMB, 2>;

struct ViewFwdArgs {
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const float* fb;               // (256,) f32
  const float* vb;               // (128,) f32
  const float* ab;               // (8,) f32
  const float* rb;               // (8,) f32
  const bf16* aw;                // (256, 8) bf16
  const bf16* rw;                // (128, 8) bf16
};

// hv = bf16(relu(acc + vb)) (acc[0 .. 63]: this warpgroup's rows, 128
// columns) into columns 0 .. 127 of `act`, whose feat the products have read
__device__ __forceinline__ void hv_epilogue(const float (&acc)[128], const float* __restrict__ vb,
                                            unsigned char* act, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < VW / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    const float2 b = __ldg(reinterpret_cast<const float2*>(vb + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<__nv_bfloat162*>(act + tile_offset(r0 + 8 * h, col)) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h] + b.x, 0.0f),
                                fmaxf(acc[4 * j + 2 * h + 1] + b.y, 0.0f));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mlpv_fwd_kernel(const bf16* __restrict__ emb, const bf16* __restrict__ embv, int n, int n_tiles,
                const bf16* __restrict__ image, ViewFwdArgs p, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align_smem(smem_raw);
  const uint32_t act_s = smem_u32(act);
  const uint32_t embt = act_s + uint32_t(ACT_BYTES);   // emb, one k-atom
  const uint32_t embvt = embt + TILE_ATOM_BYTES;       // embv, zero-padded to 64 lanes
  const uint32_t ring = embvt + TILE_ATOM_BYTES;
  const uint32_t bars = ring + FWD_STAGES * CHUNK_BYTES;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) ring_init<FWD_STAGES>(bars);
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      produce<FWD_STAGES>(image, V_FWD_CHUNKS, n_tiles, ring, bars,
                          [](int c) { return views_chunk_bytes(c); });
    }
  } else {                 // a consumer: 64 rows of every tile
    setmaxnreg_inc<CONSUMER_REGS>();
    // one accumulator array for every product (hv's use its first floats)
    float acc[128];
    uint32_t g = 0;
    // cp.async groups, oldest first: emb, embv of the first tile; then per
    // tile the next tile's emb (at layer 5) and embv (after hv's products)
    load_emb_rows<EMB>(embt, emb, long(blockIdx.x) * TM, n, wg, t);
    cp_async_commit();
    load_emb_rows<VEMB, KC>(embvt, embv, long(blockIdx.x) * TM, n, wg, t);
    cp_async_commit();
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long row0 = long(tile) * TM;
      const int next = tile + gridDim.x;
      cp_async_wait<1>();   // emb has landed (embv, the newest group, may not)
      fence_proxy_async();
      wg_barrier(wg);       // ... and the last tile's rgb head is done

      // ---- nh1 .. nh8; the next tile's emb once layer 5 has read this one's
      chain_tile<FWD_STAGES, EMB>(acc, act, embt, p.bias, ring, bars, g, wg, t, nullptr, 0, 0,
                                  nullptr, [&] {
                                    if (next < n_tiles) {
                                      load_emb_rows<EMB>(embt, emb, long(next) * TM, n, wg, t);
                                    }
                                    cp_async_commit();
                                  });

      // ---- alpha: s = nh8 @ aw + ab + rb, this thread's point and 4 lanes
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      head_dot<NW>(act, p.aw, wg, t, s);
      {
        const float4 ab = __ldg(reinterpret_cast<const float4*>(p.ab + (t % 2) * 4));
        const float4 rb = __ldg(reinterpret_cast<const float4*>(p.rb + (t % 2) * 4));
        s[0] = s[0] + ab.x + rb.x;
        s[1] = s[1] + ab.y + rb.y;
        s[2] = s[2] + ab.z + rb.z;
        s[3] = s[3] + ab.w + rb.w;
      }

      // ---- feat = bf16(nh8 @ fw + fb) (no activation) in place: fw's 4
      // chunks read the tile as a hidden layer's do
      layer_products<FWD_STAGES, EMB>(acc, 1, act_s, embt, ring, bars, g, wg, t == 0);
      wg_barrier(wg);       // the warpgroup's alpha products have read nh8
      layer_epilogue<false>(acc, p.fb, act, nullptr, wg, t);
      cp_async_wait<1>();   // embv has landed (the next tile's emb may not)
      fence_proxy_async();
      wg_barrier(wg);

      // ---- hv = bf16(relu(feat @ vwf + embv @ vwv + vb)) into atoms 0-1
      views_products<FWD_STAGES>(acc, act_s, embvt, ring, bars, g, wg, t == 0);
      if (next < n_tiles) load_emb_rows<VEMB, KC>(embvt, embv, long(next) * TM, n, wg, t);
      cp_async_commit();
      hv_epilogue(acc, p.vb, act, wg, t);
      wg_barrier(wg);

      // ---- rgb: raw = s + hv @ rw
      head_dot<VW>(act, p.rw, wg, t, s);
      store_raw(out, s, row0, n, wg, t);
    }
  }
}

}  // namespace
}  // namespace sm90

// emb (n, 64) and embv (n, 32) bf16; out (n, 8) f32; image: the first 39
// chunks of the view-direction image (ops/kernels/mlp_sm90.py:
// pack_views_image(mw, ("fwd",))), 32 KB apart;
// mats: n0w (64x256), n1w..n4w (256x256), n5e (64x256), n5h, n6w, n7w
//       (256x256), fw (256x256), aw (256x8), vwf (256x128), vwv (32x128),
//       rw (128x8), all bf16 row-major (in, out), of which only aw and rw
//       are read (the image holds the others);
// biases: n0b..n4b, n5b, n6b, n7b, fb (256 f32 each), ab (8), vb (128),
//       rb (8).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlpv_fwd(const void* emb, const void* embv, int n, const void* image,
                               const void* const* mats, const void* const* biases,
                               void* out, void* stream) {
  sm90::ViewFwdArgs p;
  for (int i = 0; i < sm90::N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.fb = static_cast<const float*>(biases[8]);
  p.ab = static_cast<const float*>(biases[9]);
  p.vb = static_cast<const float*>(biases[10]);
  p.rb = static_cast<const float*>(biases[11]);
  p.aw = static_cast<const sm90::bf16*>(mats[10]);
  p.rw = static_cast<const sm90::bf16*>(mats[13]);

  cudaError_t err = cudaFuncSetAttribute(sm90::mlpv_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sm90::SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const int n_tiles = (n + sm90::TM - 1) / sm90::TM;
  sm90::mlpv_fwd_kernel<<<sm90::persistent_grid(n_tiles), sm90::THREADS,
                          sm90::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const sm90::bf16*>(emb), static_cast<const sm90::bf16*>(embv), n, n_tiles,
      static_cast<const sm90::bf16*>(image), p, static_cast<float*>(out));
  return int(cudaGetLastError());
}
