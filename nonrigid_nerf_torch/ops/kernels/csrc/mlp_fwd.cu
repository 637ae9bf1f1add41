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
// The encoding has E lanes: 64 (the 63-channel Fourier encoding) or 128 (the
// time-conditioned baseline's input, the encoding and the 32-lane latent,
// 95 channels; its n0w and n5e have 128 rows, zero past row 95). The kernel
// is a template on E, instantiated at both.
//
// What bounds it: 493,568 MACs per point at 64 lanes (526,336 at 128)
// against 160 bytes of HBM traffic (288 at 128: 2E B of bf16 encoding in,
// 32 B of f32 raw out), 3,600 FLOP per byte or more, so the tensor cores
// bound it, never the memory.
//
// Design (mlp_sm90.cuh's chain; the other canonical-MLP kernels keep
// mlp_tile.cuh's):
// - persistent CTAs, one per SM, each walking 128-point tiles on a static
//   schedule; two consumer warpgroups own 64 rows of a tile each for all 9
//   layers, a producer warp streams the weights;
// - the 128 x 256 bf16 activation tile and the 128 x E encoding tile stay in
//   shared memory in the 128-byte-swizzled K-major layout wgmma reads; each
//   layer's m64n256k16 accumulators live in registers, and its epilogue
//   (bias, ReLU, bf16) writes them straight into the same tile;
// - the weights (0.99 MB, L2-resident) stream through a 3-stage ring of 32 KB
//   chunks filled by cp.async.bulk from an image the wrapper pre-packed in
//   that layout, with full / empty mbarriers: 30 chunks a tile (32 at 128
//   lanes), no CTA-wide barrier inside the chain. The two warpgroups drift
//   apart by up to the ring's depth, so one's epilogue overlaps the other's
//   products;
// - the next tile's encoding is loaded with cp.async as soon as layer 5 has
//   read the current one;
// - the 8-lane head is a per-thread f32 dot product from the final tile
//   (1/256 of the work);
// - rows past n are zero-filled on load and masked on store, so the caller
//   does not pad. No atomics: the result is deterministic.
//
// What bounds the design now (measured on the H100, see PERF.md): not the
// L2 stream of weights (a variant that skips the copies runs 2% faster) and
// not the epilogue's stores (skipping them gains nothing), but the products'
// issue and each layer's drain: a warpgroup waits for all of a layer's
// products before its epilogue, and the two warpgroups tend to drain
// together.
//
// Plain C interface, bound with ctypes (see ../mlp_fwd.py).

#include "mlp_sm90.cuh"

namespace {

using namespace sm90;

struct FwdArgs {
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const bf16* ow;                // (256, 8) bf16
  const float* ob;               // (8,) f32
};

template <int E>
__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const bf16* __restrict__ emb, int n, int n_tiles,
               const bf16* __restrict__ image, FwdArgs p, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align_smem(smem_raw);
  const uint32_t embt = smem_u32(act + ACT_BYTES);
  const uint32_t ring = embt + uint32_t(emb_tile_bytes<E>);
  const uint32_t bars = ring + FWD_STAGES * CHUNK_BYTES;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) ring_init<FWD_STAGES>(bars);
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) produce<FWD_STAGES>(image, n_fwd_chunks<E>, n_tiles, ring, bars);
  } else {                 // a consumer: 64 rows of every tile
    setmaxnreg_inc<CONSUMER_REGS>();
    uint32_t g = 0;
    load_emb_rows<E>(embt, emb, long(blockIdx.x) * TM, n, wg, t);
    cp_async_commit();
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long row0 = long(tile) * TM;
      const int next = tile + gridDim.x;
      cp_async_wait_all();
      fence_proxy_async();
      wg_barrier(wg);   // the encoding has landed; the last tile's head is done
      float acc[128];
      chain_tile<FWD_STAGES, E>(acc, act, embt, p.bias, ring, bars, g, wg, t, nullptr, 0, 0,
                                nullptr, [&] {
                                  if (next < n_tiles) {
                                    load_emb_rows<E>(embt, emb, long(next) * TM, n, wg, t);
                                  }
                                  cp_async_commit();
                                });
      raw_head(act, p.ow, p.ob, out, row0, n, wg, t);
    }
  }
}

// mats: n0w .. n7w, ow as `nrnerf_mlp_fwd` lists them (only ow is read: the
// image holds the chain's weights); biases: n0b .. n7b, ob
template <int E>
int launch_mlp_fwd(const void* emb, int n, const void* image, const void* const* mats,
                   const void* const* biases, void* out, void* stream) {
  FwdArgs p;
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = static_cast<const bf16*>(mats[9]);
  p.ob = static_cast<const float*>(biases[8]);

  constexpr size_t smem = fwd_smem_bytes<E>;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const int n_tiles = (n + TM - 1) / TM;
  mlp_fwd_kernel<E><<<persistent_grid(n_tiles), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(emb), n, n_tiles, static_cast<const bf16*>(image), p,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace

// emb (n, emb_width) bf16 with emb_width 64 or 128, out (n, 8) f32;
// image: the forward chunks of the chain pre-packed as mlp_sm90.cuh lays them
// out (ops/kernels/mlp_sm90.py:pack_chain_image), n_fwd_chunks x 32 KB;
// mats: n0w (emb_width x 256), n1w .. n4w, n5e (emb_width x 256), n5h, n6w,
// n7w, ow (256 x 8), bf16 row-major (in, out), of which only ow is read;
// biases: n0b .. n4b, n5b, n6b, n7b (256 f32 each), ob (8 f32).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlp_fwd(const void* emb, int n, int emb_width, const void* image,
                              const void* const* mats, const void* const* biases,
                              void* out, void* stream) {
  switch (emb_width) {
    case 64:
      return launch_mlp_fwd<64>(emb, n, image, mats, biases, out, stream);
    case 128:
      return launch_mlp_fwd<128>(emb, n, image, mats, biases, out, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
