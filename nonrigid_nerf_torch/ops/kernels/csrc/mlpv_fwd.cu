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
// A second input, for the render path (`mlpv_fwd_points`): the bent points
// (n, 3) and each point's view direction (n, 3) f32, from which the
// producer warpgroup's three idle warps build both encoding tiles, bit for
// bit the tiles of the encoding input (`ViewPointsIn`, row 1's points
// handshake with a second tile). The caller then writes, joins, casts and
// pads no encoding; the kernel moves 56 B per point (24 B in, 32 B out).
// The kernel is a template on its input, so the encoding input (training's
// forward, `MLPVCore`) keeps its code.
//
// Plain C interface, bound with ctypes (see ../mlpv_fwd.py).

#include "mlp_sm90.cuh"

namespace sm90 {
namespace {

// the activation tile, emb and embv (zero-padded to 64 lanes) as two
// k-atoms, the ring: the forward's plan with two encoding tiles
constexpr size_t SMEM_BYTES = fwd_smem_bytes<EMB, 2>;
// the points input: emb and embv double-buffered, a 2-stage ring. (One embv
// tile, refilled once hv's products have read it, beside a 3-stage ring
// takes 214,144 B, the 228 KB carveout that leaves the SM 28 KB of L1
// against this plan's 60 KB, and ran 5-6 % slower; PERF.md.)
constexpr size_t POINTS_SMEM_BYTES = fwd_smem_bytes<EMB, 4, 2>;
static_assert(SMEM_BYTES == 197760 && POINTS_SMEM_BYTES == 197760 &&
                  fwd_smem_bytes<EMB, 3, 3> == 214144,
              "row 3's plans: the encoding input's, and the points input's");

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

// ---- the kernel's inputs, a policy each. EMB_TILES emb tiles and
// EMBV_TILES embv tiles, which the kernel takes in turn tile by tile, and
// a ring of STAGES; thread 0 calls `init` with room for eight mbarriers; the
// producer warpgroup's threads 32 .. 127 call `encode` once; a consumer
// calls `first` for its first tile, `wait_emb` when its i-th tile starts
// (its part of the tile's emb must then be in the tile), `emb_done` once
// layer 5 has read it, `wait_embv` before hv's products (the same for
// embv) and `embv_done` once they have completed.

// The encodings emb (n, 64) and embv (n, 32) bf16, loaded by cp.async by
// the threads that read them. cp.async groups, oldest first: emb, embv of
// the first tile; then per tile the next tile's emb (at layer 5) and embv
// (after hv's products), each waited for with wait_group 1 (the other,
// newer group may still be in flight).
struct ViewEncodingIn {
  static constexpr int EMB_TILES = 1;
  static constexpr int EMBV_TILES = 1;
  static constexpr int STAGES = FWD_STAGES;
  static constexpr size_t SMEM = SMEM_BYTES;
  const bf16* emb;
  const bf16* embv;

  __device__ __forceinline__ void init(uint32_t) const {}
  __device__ __forceinline__ void encode(uint32_t, uint32_t, uint32_t, int, int, int) const {}
  __device__ __forceinline__ void first(uint32_t embt, uint32_t embvt, long row0, int n, int wg,
                                        int t) const {
    load_emb_rows<EMB>(embt, emb, row0, n, wg, t);
    cp_async_commit();
    load_emb_rows<VEMB, KC>(embvt, embv, row0, n, wg, t);
    cp_async_commit();
  }
  __device__ __forceinline__ void wait_emb(uint32_t, int) const { cp_async_wait<1>(); }
  // the next tile's emb (next_row0 < 0: there is none) into `embt`
  __device__ __forceinline__ void emb_done(uint32_t embt, uint32_t, int, long next_row0, int n,
                                           int wg, int t) const {
    if (next_row0 >= 0) load_emb_rows<EMB>(embt, emb, next_row0, n, wg, t);
    cp_async_commit();
  }
  __device__ __forceinline__ void wait_embv(uint32_t, int) const { cp_async_wait<1>(); }
  __device__ __forceinline__ void embv_done(uint32_t embvt, uint32_t, int, long next_row0, int n,
                                            int wg, int t) const {
    if (next_row0 >= 0) load_emb_rows<VEMB, KC>(embvt, embv, next_row0, n, wg, t);
    cp_async_commit();
  }
};

// The render path's input (`mlpv_fwd_points`): the bent points pts (n, 3)
// and the view directions dirs (n, 3) f32, from which the producer's three
// idle warps (96 encoders) build the tiles the encoding input would load
// from F.pad(fourier_embed(pts, 10).to(bfloat16)) and F.pad(fourier_embed(
// dirs, 4).to(bfloat16)), bit for bit (`push_fourier`, each value rounded to
// bf16 to nearest even):
//   emb:  lanes 0 .. 2 x, lane 3 + 6k + j sinf(x_j 2^k), lane 6 + 6k + j
//         cosf(x_j 2^k) for k < 10, lane 63 zero;
//   embv: the same of d for k < 4 (27 lanes), lanes 27 .. 63 zero;
//   every row past n zero.
// Both tiles are double-buffered, beside a 2-stage ring: the encoding
// input's 197,760 B (POINTS_SMEM_BYTES). The work is split so that each warp
// computes about the same sines: encoder e builds emb rows e and e + 96
// (< 128), encoders 32 .. 95 embv rows e - 32 and e + 32, a row lane by lane
// (`RowPieces`), so a warp's threads compute the same lane in step. Per tile, an emb "full" barrier
// (96 arrivals) and "empty" barrier (one a consumer warpgroup, once layer 5
// has read the tile), and an embv pair alike (64 arrivals). Lanes 32 .. 63
// of every embv tile, which hv's K = 32 products do not read, are zeroed
// once, when the kernel starts.
struct ViewPointsIn {
  static constexpr int EMB_TILES = 2;
  static constexpr int EMBV_TILES = 2;
  static constexpr int STAGES = 2;
  static constexpr size_t SMEM = POINTS_SMEM_BYTES;
  static constexpr int ENCODERS = 96;
  static constexpr int VIEW_ENCODERS = 64;   // encoders 32 .. 95: warps 2 and 3
  const float* pts;
  const float* dirs;

  // bars: emb full[0], full[1], empty[0], empty[1]; embv full[0], full[1],
  // empty[0], empty[1]
  __device__ __forceinline__ void init(uint32_t bars) const {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars + 8 * b, ENCODERS);
      mbar_init(bars + 8 * (2 + b), CONSUMERS);
      mbar_init(bars + 8 * (4 + b), VIEW_ENCODERS);
      mbar_init(bars + 8 * (6 + b), CONSUMERS);
    }
    mbar_init_fence();
  }
  // row r of a tile of the `multires`-octave encoding of src's point p
  static __device__ __forceinline__ void row(uint32_t tile, const float* __restrict__ src, long p,
                                             int n, int r, int multires) {
    RowPieces out{tile, r};
    if (p >= n) {
      while (out.c < 3 * (1 + 2 * multires)) out.push(0.0f);
    } else {
      float x[3];
      load_point(src, p, n, x);
      push_fourier(out, x, multires);
    }
    while (out.c & 7) out.push(0.0f);
  }
  // encoder e (0 .. 95): builds its rows of every tile of this CTA; the i-th
  // tile's emb and embv go to tiles i % 2 once the consumers are done with
  // what they held. Both encodings go through one call of `row`, so the
  // sines are inlined once.
  __device__ __forceinline__ void encode(uint32_t emb0, uint32_t embv0, uint32_t bars, int n,
                                         int n_tiles, int e) const {
    const bool views = e >= ENCODERS - VIEW_ENCODERS;   // warp-uniform
    const int ve = e - (ENCODERS - VIEW_ENCODERS);
    constexpr int ZERO_PIECES = TM * (KC - VEMB) / 8;   // of an embv tile
    if (views) {
      for (int q = ve; q < 2 * ZERO_PIECES; q += VIEW_ENCODERS) {
        const int v = q / ZERO_PIECES, z = q % ZERO_PIECES;
        st_shared16(embv0 + uint32_t(v) * TILE_ATOM_BYTES + tile_offset(z % TM, VEMB + (z / TM) * 8),
                    make_uint4(0u, 0u, 0u, 0u));
      }
    }
    int i = 0;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const long row0 = long(tile) * TM;
#pragma unroll 1
      for (int part = 0; part < (views ? 2 : 1); ++part) {
        // part 0: emb, by all 96 encoders; part 1: embv, by the last 64
        const uint32_t full = bars + 8 * (4 * part + i % 2);
        const uint32_t tile_s = (part == 0 ? emb0 : embv0) + uint32_t(i % 2) * TILE_ATOM_BYTES;
        mbar_wait(full + 16, ((i / 2) & 1) ^ 1);   // its "empty" barrier
#pragma unroll 1
        for (int r = part == 0 ? e : ve; r < TM; r += part == 0 ? ENCODERS : VIEW_ENCODERS) {
          row(tile_s, part == 0 ? pts : dirs, row0 + r, n, r, part == 0 ? 10 : 4);
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
  }
  __device__ __forceinline__ void first(uint32_t, uint32_t, long, int, int, int) const {}
  __device__ __forceinline__ void wait_emb(uint32_t bars, int i) const {
    mbar_wait(bars + 8 * (i % 2), (i / 2) & 1);
  }
  __device__ __forceinline__ void emb_done(uint32_t, uint32_t bars, int i, long, int, int,
                                           int t) const {
    if (t == 0) mbar_arrive(bars + 8 * (2 + i % 2));
  }
  __device__ __forceinline__ void wait_embv(uint32_t bars, int i) const {
    mbar_wait(bars + 8 * (4 + i % 2), (i / 2) & 1);
  }
  __device__ __forceinline__ void embv_done(uint32_t, uint32_t bars, int i, long, int, int,
                                            int t) const {
    if (t == 0) mbar_arrive(bars + 8 * (6 + i % 2));
  }
};

static_assert(2 * 8 * FWD_STAGES + 8 * 8 <= BAR_BYTES,
              "the ring's barriers and the points input's eight fit");

template <class In>
__global__ void __launch_bounds__(THREADS, 1)
mlpv_fwd_kernel(const In in_args, int n, int n_tiles, const bf16* __restrict__ image,
                ViewFwdArgs p, float* __restrict__ out) {
  constexpr int S = In::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align_smem(smem_raw);
  const uint32_t act_s = smem_u32(act);
  const uint32_t emb0 = act_s + uint32_t(ACT_BYTES);                    // emb, a k-atom a tile
  const uint32_t embv0 = emb0 + In::EMB_TILES * TILE_ATOM_BYTES;        // embv, 64 lanes a tile
  const uint32_t ring = embv0 + In::EMBV_TILES * TILE_ATOM_BYTES;
  const uint32_t bars = ring + S * CHUNK_BYTES;
  const uint32_t in_bars = bars + 2 * 8 * S;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    ring_init<S>(bars);
    in_args.init(in_bars);
  }
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      produce<S>(image, V_FWD_CHUNKS, n_tiles, ring, bars,
                 [](int c) { return views_chunk_bytes(c); });
    } else if (t >= 32) {
      in_args.encode(emb0, embv0, in_bars, n, n_tiles, t - 32);
    }
  } else {                 // a consumer: 64 rows of every tile
    setmaxnreg_inc<CONSUMER_REGS>();
    In in = in_args;
    // one accumulator array for every product (hv's use its first floats)
    float acc[128];
    uint32_t g = 0;
    in.first(emb0, embv0, long(blockIdx.x) * TM, n, wg, t);
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const long row0 = long(tile) * TM;
      const int next = tile + gridDim.x;
      const long next_row0 = next < n_tiles ? long(next) * TM : -1;
      const uint32_t embt = emb0 + uint32_t(i % In::EMB_TILES) * TILE_ATOM_BYTES;
      const uint32_t embvt = embv0 + uint32_t(i % In::EMBV_TILES) * TILE_ATOM_BYTES;
      in.wait_emb(in_bars, i);   // emb is in its tile
      fence_proxy_async();
      wg_barrier(wg);            // ... and the last tile's rgb head is done

      // ---- nh1 .. nh8; `emb_done` once layer 5 has read emb
      chain_tile<S, EMB>(acc, act, embt, p.bias, ring, bars, g, wg, t, nullptr, 0, 0, nullptr,
                         [&] { in.emb_done(embt, in_bars, i, next_row0, n, wg, t); });

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
      layer_products<S, EMB>(acc, 1, act_s, embt, ring, bars, g, wg, t == 0);
      wg_barrier(wg);       // the warpgroup's alpha products have read nh8
      layer_epilogue<false>(acc, p.fb, act, nullptr, wg, t);
      in.wait_embv(in_bars, i);   // embv is in its tile
      fence_proxy_async();
      wg_barrier(wg);

      // ---- hv = bf16(relu(feat @ vwf + embv @ vwv + vb)) into atoms 0-1;
      // `embv_done` once its products have read embv
      views_products<S>(acc, act_s, embvt, ring, bars, g, wg, t == 0);
      in.embv_done(embvt, in_bars, i, next_row0, n, wg, t);
      hv_epilogue(acc, p.vb, act, wg, t);
      wg_barrier(wg);

      // ---- rgb: raw = s + hv @ rw
      head_dot<VW>(act, p.rw, wg, t, s);
      store_raw(out, s, row0, n, wg, t);
    }
  }
}

// the forward on the input `in` (ViewEncodingIn or ViewPointsIn), with
// image, mats and biases as nrnerf_mlpv_fwd takes them
template <class In>
int launch_mlpv_fwd(const In& in, int n, const void* image, const void* const* mats,
                    const void* const* biases, void* out, void* stream) {
  ViewFwdArgs p;
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.fb = static_cast<const float*>(biases[8]);
  p.ab = static_cast<const float*>(biases[9]);
  p.vb = static_cast<const float*>(biases[10]);
  p.rb = static_cast<const float*>(biases[11]);
  p.aw = static_cast<const bf16*>(mats[10]);
  p.rw = static_cast<const bf16*>(mats[13]);
  static_assert(In::SMEM <= SMEM_LIMIT, "the forward and its input fit one Hopper CTA");
  cudaError_t err = cudaFuncSetAttribute(mlpv_fwd_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(In::SMEM));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const int n_tiles = (n + TM - 1) / TM;
  mlpv_fwd_kernel<In><<<persistent_grid(n_tiles), THREADS, In::SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      in, n, n_tiles, static_cast<const bf16*>(image), p, static_cast<float*>(out));
  return int(cudaGetLastError());
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
  const sm90::ViewEncodingIn in{static_cast<const sm90::bf16*>(emb),
                                static_cast<const sm90::bf16*>(embv)};
  return sm90::launch_mlpv_fwd(in, n, image, mats, biases, out, stream);
}

// pts (n, 3) and dirs (n, 3) f32; image, mats, biases and out as
// nrnerf_mlpv_fwd takes them.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nrnerf_mlpv_fwd_points(const void* pts, const void* dirs, int n,
                                      const void* image, const void* const* mats,
                                      const void* const* biases, void* out, void* stream) {
  const sm90::ViewPointsIn in{static_cast<const float*>(pts), static_cast<const float*>(dirs)};
  return sm90::launch_mlpv_fwd(in, n, image, mats, biases, out, stream);
}
