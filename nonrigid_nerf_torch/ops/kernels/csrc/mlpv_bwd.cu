// View-direction canonical NeRF MLP backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlpv_core_bwd` / `_mlpv_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:1080-1177,1215-1237). It is
// NOT the autograd of the forward; the arithmetic it reproduces:
//
//   nh1..nh8, feat, hv recomputed in bf16 as in mlpv_fwd.cu;
//   drawb = bf16(draw);  g_rb = g_ab = sum(draw) over the points, f32, uncast;
//   g_rw  = hv^T @ drawb;       dhv = bf16((drawb @ rw^T) * (hv > 0))
//   g_vwf = feat^T @ dhv;  g_vwv = embv^T @ dhv;  g_vb = sum(dhv)
//   dfeat = bf16(dhv @ vwf^T)                     (feat has no activation)
//   dembv = dhv @ vwv^T                           (f32, no mask)
//   g_fw  = nh8^T @ dfeat;  g_fb = sum(dfeat);    g_aw = nh8^T @ drawb
//   dh8   = bf16((dfeat @ fw^T + drawb @ aw^T) * (nh8 > 0))
//   then the chain as in mlp_bwd.cu, down to demb.
//
// All products are bf16 x bf16 with f32 accumulation. Outputs: demb (n, 64)
// and dembv (n, 32) f32, and the 26 weight gradients in pack order, f32,
// summed over all points.
//
// What bounds it: 1,790,976 MACs per point (recompute + dh chain + dW)
// against 608 bytes of HBM traffic that the function must move, so the
// tensor cores bound it; the two passes add the scratch's round trip
// through HBM (9,984 B per point written and read back).
//
// Design: mlp_bwd.cu's two passes on mlp_sm90.cuh, with the four heads in
// the chain kernel.
//
// 1. `mlpv_bwd_chain_kernel`: persistent CTAs, two consumer warpgroups of 64
//    rows each and a producer thread that streams a weight image of 78
//    chunks through the 3-stage ring of 32 KB (the wrapper pre-packs it,
//    ops/kernels/mlp_sm90.py:pack_views_image; a chunk of the view layer is
//    16 or 8 KB, and the stage expects the bytes its copy moves). Shared
//    memory is mlp_bwd.cu's: two 128 x 256 tiles X and Y, the ring, the
//    barriers, 230,528 B. Per tile (X, Y: what each holds at each step):
//    - Y: emb (atom 0) and embv zero-padded to 64 lanes (atom 1), loaded by
//      cp.async a tile ahead; one bulk tensor store copies both to the
//      scratch's (n_pad, 128) encoding array.
//    - X: nh1 .. nh8 (mlp_sm90.cuh's chain_tile, each layer to the scratch,
//      the gates of all eight layers kept as bits).
//    - X: feat = bf16(nh8 @ fw + fb) in place once fw's 4 chunks have
//      completed (wgmma m64n256k16); to the scratch as a ninth layer of nh.
//    - hv = relu(feat @ vwf + embv @ vwv + vb) on wgmma m64n128k16 (64
//      accumulators a thread: vwf's 4 chunks on X, vwv's K = 32 on Y's
//      atom 1). Its epilogue, from the accumulator layout: hv into X's
//      atoms 2-3, dhv = bf16((drawb @ rw^T) * (hv > 0)) (K = 8, CUDA cores)
//      into X's atoms 0-1; both to the scratch by bulk tensor stores. hv
//      has no tile of its own.
//    - Y: dfeat = bf16(dhv @ vwf^T) (m64n64k16, K = 128, 4 chunks of vwf's
//      rows; no mask); to the scratch as a ninth layer of dh.
//    - dembv = dhv @ vwv^T (m64n32k16, K = 128) straight to global, f32.
//    - X: dh8 = bf16((dfeat @ fw^T + drawb @ aw^T) * gate(nh8)) (the alpha
//      term on the CUDA cores in the epilogue), then mlp_sm90.cuh's dh chain
//      from X down to demb (f32 to global). Its seven swaps leave dh1 in Y,
//      so X, free for the chain's last step, takes the next tile's
//      encodings, and the next tile runs with X and Y swapped.
// 2. `mlp_dw_sm90_kernel`: the 12 dW products in 39 jobs of 64 rows (the
//    chain's 9, g_fw with g_fb's column sums, g_vwf with g_vb's on dhv,
//    which is 128 lanes wide, and g_vwv, whose job writes 32 rows) from TMA
//    boxes of the scratch; `mlp_head_grad_kernel`: g_aw with g_ab over nh8's
//    two 128-column blocks, g_rw with g_rb over hv's; `mlp_reduce_kernel`
//    (mlp_tile.cuh) adds the splits in ascending order.
//
// No atomics anywhere: the same inputs give bit-equal outputs.
//
// Plain C interface, bound with ctypes (see ../mlpv_bwd.py).

#include "mlp_sm90.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int GRAD_FLOATS = 599440;
// bf16 elements of scratch per point: the encodings (64 + 32, padded to
// 128), nh1..nh8 and feat, dh1..dh8 and dfeat (256 each), hv and dhv (128)
constexpr int SCRATCH_PER_POINT = 2 * KC + 2 * (N_LAYERS + 1) * NW + 2 * VW;
static_assert(SCRATCH_PER_POINT == 4992, "the scratch's layout");
static_assert(SPLIT_ROWS == sm90::DW_SPLIT, "the partials hold one slot per split");

// offsets (in floats) of the 26 gradients in one flat pack-order buffer:
// n0w n0b n1w n1b n2w n2b n3w n3b n4w n4b n5e n5h n5b n6w n6b n7w n7b
// fw fb aw ab vwf vwv vb rw rb
constexpr int WW = NW * NW, EW = EMB * NW;
constexpr int OFF_N0W = 0;
constexpr int OFF_N0B = OFF_N0W + EW;
constexpr int OFF_N1W = OFF_N0B + NW;
constexpr int OFF_N1B = OFF_N1W + WW;
constexpr int OFF_N2W = OFF_N1B + NW;
constexpr int OFF_N2B = OFF_N2W + WW;
constexpr int OFF_N3W = OFF_N2B + NW;
constexpr int OFF_N3B = OFF_N3W + WW;
constexpr int OFF_N4W = OFF_N3B + NW;
constexpr int OFF_N4B = OFF_N4W + WW;
constexpr int OFF_N5E = OFF_N4B + NW;
constexpr int OFF_N5H = OFF_N5E + EW;
constexpr int OFF_N5B = OFF_N5H + WW;
constexpr int OFF_N6W = OFF_N5B + NW;
constexpr int OFF_N6B = OFF_N6W + WW;
constexpr int OFF_N7W = OFF_N6B + NW;
constexpr int OFF_N7B = OFF_N7W + WW;
constexpr int OFF_FW = OFF_N7B + NW;
constexpr int OFF_FB = OFF_FW + WW;
constexpr int OFF_AW = OFF_FB + NW;
constexpr int OFF_AB = OFF_AW + NW * OUT;
constexpr int OFF_VWF = OFF_AB + OUT;
constexpr int OFF_VWV = OFF_VWF + NW * VW;
constexpr int OFF_VB = OFF_VWV + VEMB * VW;
constexpr int OFF_RW = OFF_VB + VW;
constexpr int OFF_RB = OFF_RW + VW * OUT;
static_assert(OFF_RB + OUT == GRAD_FLOATS, "pack-order layout");

}  // namespace

namespace sm90 {
namespace {

// the weight image's schedule: the chain's forward chunks; fw (4 chunks,
// forward layout), vwf (4, 128 columns), vwv (1, its 32 rows padded to 64);
// vwf as the B operand of dhv @ vwf^T (4 chunks of 64 rows, 2 k-atoms each),
// vwv (1: 32 rows), fw (4, as the chain's backward chunks); the chain's
// backward chunks. mlp_sm90.py:views_schedule mirrors it.
constexpr int V_FW = n_fwd_chunks<EMB>;
constexpr int V_VWF = V_FW + NW / KC;
constexpr int V_VWV = V_VWF + NW / KC;
constexpr int V_BVWF = V_VWV + 1;
constexpr int V_BVWV = V_BVWF + NW / KC;
constexpr int V_BFW = V_BVWV + 1;
constexpr int V_BWD = V_BFW + NW / KC;
constexpr int V_CHUNKS = V_BWD + n_bwd_chunks<EMB>;
static_assert(V_CHUNKS == 78, "the view-direction schedule");
constexpr uint32_t VIEW_CHUNK_BYTES = VW * ATOM_ROW_BYTES;           // 16 KB
constexpr uint32_t VWV_BWD_BYTES = 2 * VEMB * ATOM_ROW_BYTES;        // 8 KB
static_assert(VIEW_CHUNK_BYTES <= CHUNK_BYTES && VIEW_CHUNK_BYTES % 1024 == 0 &&
              VWV_BWD_BYTES % 1024 == 0, "the view layer's chunks fit a stage");

// the bytes of chunk c that its stage receives
__device__ __forceinline__ uint32_t views_chunk_bytes(int c) {
  return c >= V_VWF && c < V_BVWV ? VIEW_CHUNK_BYTES
                                  : (c == V_BVWV ? VWV_BWD_BYTES : CHUNK_BYTES);
}

struct ViewArgs {
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const float* fb;               // (256,) f32
  const float* vb;               // (128,) f32
  const bf16* aw;                // (256, 8) bf16
  const bf16* rw;                // (128, 8) bf16
};

// emb (atom 0) and embv, zero-padded to 64 lanes (atom 1), of this
// warpgroup's rows of the tile at row0 into the tile `dst` (cp.async, zero
// past n)
__device__ __forceinline__ void load_inputs(uint32_t dst, const bf16* __restrict__ emb,
                                            const bf16* __restrict__ embv, long row0, int n,
                                            int wg, int t) {
  load_emb_rows<EMB>(dst, emb, row0, n, wg, t);
  load_emb_rows<VEMB, KC>(dst + TILE_ATOM_BYTES, embv, row0, n, wg, t);
}

// bf16(draw) of this thread's two rows of the accumulator layout, zero past n
__device__ __forceinline__ void draw_rows(const float* __restrict__ draw, long row0, int n,
                                          int wg, int t, float (&db)[2][OUT]) {
  const long r0 = row0 + wg * WG_ROWS + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long r = r0 + 8 * h;
    const float4* src = reinterpret_cast<const float4*>(draw + size_t(r) * OUT);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a = r < n ? __ldg(src) : zero;
    const float4 b = r < n ? __ldg(src + 1) : zero;
    const float v[OUT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int o = 0; o < OUT; ++o) db[h][o] = __bfloat162float(__float2bfloat16(v[o]));
  }
}

// row `row` of an (rows, 8) bf16 head matrix, in f32
__device__ __forceinline__ void head_row(const bf16* __restrict__ w, int row, float (&out)[OUT]) {
  const uint4 v = *reinterpret_cast<const uint4*>(w + row * OUT);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int o = 0; o < OUT; ++o) out[o] = __bfloat162float(e[o]);
}

// acc[0 .. 63] = this warpgroup's 64 rows of feat @ vwf + embv @ vwv (128
// columns, f32): vwf's 4 chunks on the k-atoms of `feat`, then vwv's on
// `embv` (K = 32: the rest of its atom is zero). One chunk's products stay in
// flight while the next chunk's issue.
template <int S>
__device__ __forceinline__ void views_products(float (&acc)[128], uint32_t feat, uint32_t embv,
                                               uint32_t ring, uint32_t bars, uint32_t& g,
                                               int wg, bool signal) {
  const uint32_t rows = uint32_t(wg) * WG_ROWS * ATOM_ROW_BYTES;
#pragma unroll 1
  for (int c = 0; c < NW / KC; ++c, ++g) {
    const uint32_t a = feat + uint32_t(c) * TILE_ATOM_BYTES + rows;
    const uint32_t b = ring_acquire<S>(ring, bars, g);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      wgmma_m64n128(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32), (c | kk) != 0);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      ring_release<S>(bars, g - 1, signal);
    }
  }
  const uint32_t b = ring_acquire<S>(ring, bars, g);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < VEMB / 16; ++kk) {
    wgmma_m64n128(acc, desc_sw128(embv + rows + kk * 32), desc_sw128(b + kk * 32), 1);
  }
  wgmma_commit();
  wgmma_wait<1>();
  ring_release<S>(bars, g - 1, signal);
  ++g;
  wgmma_wait<0>();
  fence_acc<64>(acc);
  ring_release<S>(bars, g - 1, signal);
}

// From hv's accumulators (acc[0 .. 63]: this warpgroup's rows, 128 columns):
// hv = bf16(relu(acc + vb)) into columns 128 .. 255 of `tile`, and dhv =
// bf16((bf16(draw) @ rw^T) * (hv > 0)) (K = 8, CUDA cores) into columns 0 ..
// 127. The products have finished reading the tile (feat).
__device__ __forceinline__ void hv_epilogue(const float (&acc)[128], const float* __restrict__ vb,
                                            const bf16* __restrict__ rw,
                                            const float (&db)[2][OUT], unsigned char* tile,
                                            int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < VW / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    const float2 b = *reinterpret_cast<const float2*>(vb + col);
    float w0[OUT], w1[OUT];
    head_row(rw, col, w0);
    head_row(rw, col + 1, w1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h] + b.x, 0.0f),
                                                      fmaxf(acc[4 * j + 2 * h + 1] + b.y, 0.0f));
      *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset(r0 + 8 * h, VW + col)) = hv;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        s0 += db[h][o] * w0[o];
        s1 += db[h][o] * w1[o];
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset(r0 + 8 * h, col)) =
          __floats2bfloat162_rn(__bfloat162float(hv.x) > 0.0f ? s0 : 0.0f,
                                __bfloat162float(hv.y) > 0.0f ? s1 : 0.0f);
    }
  }
}

// dh8's columns c*64 .. +64 for this warpgroup's rows: bf16((acc +
// bf16(draw) @ aw^T) * gate) into `dst`, the alpha term (K = 8) on the CUDA
// cores; `gate`: word c of nh8's gates (see dh_epilogue)
__device__ __forceinline__ void dh8_views_epilogue(const float (&acc)[128], uint32_t gate, int c,
                                                   const bf16* __restrict__ aw,
                                                   const float (&db)[2][OUT],
                                                   unsigned char* dst, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const int col = c * KC + j * 8 + (lane % 4) * 2;
    float w0[OUT], w1[OUT];
    head_row(aw, col, w0);
    head_row(aw, col + 1, w1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        a0 += db[h][o] * w0[o];
        a1 += db[h][o] * w1[o];
      }
      const uint32_t bit = j * 4 + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dst + tile_offset(r0 + 8 * h, col)) =
          __floats2bfloat162_rn((gate >> bit) & 1u ? acc[4 * j + 2 * h] + a0 : 0.0f,
                                (gate >> (bit + 1)) & 1u ? acc[4 * j + 2 * h + 1] + a1 : 0.0f);
    }
  }
}

// this warpgroup's products of one chunk of a transposed step (see nt_issue)
// into acc[0 .. N/2 - 1], completed, and the chunk's stage released
template <int KA, int N>
__device__ __forceinline__ void nt_chunk(float (&acc)[128], uint32_t cur, uint32_t ring,
                                         uint32_t bars, uint32_t g, int wg, int t) {
  nt_issue<BWD_STAGES, KA, N>(acc, cur, ring, bars, g, wg);
  wgmma_wait<0>();
  fence_acc<N / 2>(acc);
  ring_release<BWD_STAGES>(bars, g, t == 0);
}

__global__ void __launch_bounds__(THREADS, 1)
mlpv_bwd_chain_kernel(const __grid_constant__ ScratchMaps maps, const bf16* __restrict__ emb,
                      const bf16* __restrict__ embv, const float* __restrict__ draw, int n,
                      int n_tiles, long n_pad, const bf16* __restrict__ image, ViewArgs p,
                      float* demb, float* dembv) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* x = align_smem(smem_raw);   // tile X (see the top of the file)
  unsigned char* y = x + ACT_BYTES;          // tile Y
  const uint32_t ring = smem_u32(x) + uint32_t(2 * ACT_BYTES);
  const uint32_t bars = ring + BWD_STAGES * CHUNK_BYTES;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) ring_init<BWD_STAGES>(bars);
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      produce<BWD_STAGES>(image, V_CHUNKS, n_tiles, ring, bars,
                          [](int c) { return views_chunk_bytes(c); });
    }
  } else {                 // a consumer: 64 rows of every tile
    setmaxnreg_inc<CONSUMER_REGS>();
    uint32_t gates[N_LAYERS][4];   // nh1 .. nh8's ReLU gates of this thread's values
    // one accumulator array for every product of the tile (the narrower ones
    // use its first floats): an array per product shape takes registers of
    // its own, and the consumers then spill
    float acc[128];
    uint32_t g = 0;
    load_inputs(smem_u32(y), emb, embv, long(blockIdx.x) * TM, n, wg, t);
    cp_async_commit();
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long row0 = long(tile) * TM;
      const int next = tile + gridDim.x;
      const int wrow = int(row0) + wg * WG_ROWS;   // this warpgroup's first row
      const uint32_t xs = smem_u32(x), ys = smem_u32(y);
      cp_async_wait_all();
      fence_proxy_async();
      wg_barrier(wg);   // the encodings have landed; the last tile is done
      // the copy of both encodings that the dW products read
      if (t == 0) store_rows(&maps.emb, ys, 2, wrow, wg);

      // ---- nh1 .. nh8 in X, each to the scratch, the gates of all eight kept
      chain_tile<BWD_STAGES, EMB, N_LAYERS>(acc, x, ys, p.bias, ring, bars, g, wg, t, &maps, n_pad,
                                            row0, gates, [] {});

      // ---- feat = bf16(nh8 @ fw + fb) (no activation) over nh8 in X: fw's 4
      // chunks read X as a hidden layer's do
      {
        layer_products<BWD_STAGES, EMB>(acc, 1, xs, ys, ring, bars, g, wg, t == 0);
        if (t == 0) bulk_wait_read<0>();
        wg_barrier(wg);   // nh8's store has read X
        layer_epilogue<false>(acc, p.fb, x, nullptr, wg, t);
        fence_proxy_async();
        wg_barrier(wg);
        if (t == 0) store_rows(&maps.nh, xs, NW / BOX, int(N_LAYERS * n_pad) + wrow, wg);
      }

      // ---- hv into X's atoms 2-3, dhv into its atoms 0-1, both to the scratch
      {
        float db[2][OUT];
        draw_rows(draw, row0, n, wg, t, db);
        views_products<BWD_STAGES>(acc, xs, ys + TILE_ATOM_BYTES, ring, bars, g, wg, t == 0);
        if (t == 0) bulk_wait_read<0>();
        wg_barrier(wg);   // feat's store has read X
        hv_epilogue(acc, p.vb, p.rw, db, x, wg, t);
        fence_proxy_async();
        wg_barrier(wg);
        if (t == 0) {
          store_rows(&maps.hv, xs + 2 * TILE_ATOM_BYTES, VW / BOX, wrow, wg);
          store_rows(&maps.hv, xs, VW / BOX, int(n_pad) + wrow, wg);
        }
      }

      // ---- dfeat = bf16(dhv @ vwf^T) (no mask) into Y, whose encodings are
      // read; to the scratch as dh's ninth layer
#pragma unroll 1
      for (int c = 0; c < NW / KC; ++c, ++g) {
        nt_chunk<VW / KC, KC>(acc, xs, ring, bars, g, wg, t);
        dh_epilogue(acc, ~0u, c, y, wg, t);
      }
      fence_proxy_async();
      wg_barrier(wg);
      if (t == 0) store_rows(&maps.dh, ys, NW / BOX, int(N_LAYERS * n_pad) + wrow, wg);

      // ---- dembv = dhv @ vwv^T (f32, no mask) to global
      {
        nt_chunk<VW / KC, VEMB>(acc, xs, ring, bars, g, wg, t);
        ++g;
        f32_epilogue<VEMB, VEMB>(acc, 0, dembv + size_t(row0) * VEMB, long(n) - row0, false,
                                 wg, t);
      }

      // ---- dh8 = bf16((dfeat @ fw^T + bf16(draw) @ aw^T) * gate(nh8)) into X
      {
        float db[2][OUT];
        draw_rows(draw, row0, n, wg, t, db);
        if (t == 0) bulk_wait_read<1>();
        wg_barrier(wg);   // hv's and dhv's stores have read X (the newest reads Y)
#pragma unroll 1
        for (int c = 0; c < NW / KC; ++c, ++g) {
          nt_chunk<NW / KC, KC>(acc, ys, ring, bars, g, wg, t);
          dh8_views_epilogue(acc, gates[N_LAYERS - 1][c], c, p.aw, db, x, wg, t);
        }
        fence_proxy_async();
        wg_barrier(wg);
        if (t == 0) store_rows(&maps.dh, xs, NW / BOX, int(7 * n_pad) + wrow, wg);
      }

      // ---- the dh chain from X down to demb; X, free before its last step,
      // takes the next tile's encodings
      dh_chain<BWD_STAGES, EMB>(
          acc, x, y, gates, &maps, n_pad, wrow, ring, bars, g, wg, t,
          [&](const float (&a)[128], int c, bool last) {
            f32_epilogue<KC, EMB>(a, c * KC, demb + size_t(row0) * EMB, long(n) - row0, last,
                                  wg, t);
          },
          [&](unsigned char* spare) {
            if (next < n_tiles) load_inputs(smem_u32(spare), emb, embv, long(next) * TM, n, wg, t);
            cp_async_commit();
          });
      unsigned char* tmp = x;
      x = y;
      y = tmp;
    }
    if (t == 0) bulk_wait_all();
  }
}

}  // namespace
}  // namespace sm90

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// (rows padded to 128) in elements, and the f32 partials (one flat
// pack-order gradient per 2048-point split) in floats.
extern "C" void nrnerf_mlpv_bwd_sizes(int n, long long* scratch_elems,
                                      long long* partial_floats) {
  *scratch_elems = (long long)padded_rows(n) * SCRATCH_PER_POINT;
  *partial_floats = (long long)split_count(n) * GRAD_FLOATS;
}

// emb (n, 64) and embv (n, 32) bf16, draw (n, 8) f32; image: the 78 chunks
// of ops/kernels/mlp_sm90.py:pack_views_image, 32 KB apart; mats and biases
// as in nrnerf_mlpv_fwd (of mats only aw and rw are read):
// mats: n0w (64x256), n1w..n4w (256x256), n5e (64x256), n5h, n6w, n7w
//       (256x256), fw (256x256), aw (256x8), vwf (256x128), vwv (32x128),
//       rw (128x8), bf16 row-major (in, out);
// biases: n0b..n4b, n5b, n6b, n7b, fb (256 f32 each), ab, vb (128), rb; ab
//       and rb are unused here.
// scratch, partials: sized by nrnerf_mlpv_bwd_sizes; demb (n, 64) and dembv
// (n, 32) f32; grads: GRAD_FLOATS f32, the 26 gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_mlpv_bwd(const void* emb, const void* embv, const void* draw, int n,
                               const void* image, const void* const* mats,
                               const void* const* biases, void* scratch, void* partials,
                               void* demb, void* dembv, void* grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return int(cudaErrorInvalidValue);
  sm90::ViewArgs p;
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.fb = static_cast<const float*>(biases[8]);
  p.vb = static_cast<const float*>(biases[10]);
  p.aw = static_cast<const bf16*>(mats[10]);
  p.rw = static_cast<const bf16*>(mats[13]);

  // the scratch: the encodings (n_pad, 128); nh1..nh8, feat (9 n_pad, 256);
  // dh1..dh8, dfeat (9 n_pad, 256); hv, dhv (2 n_pad, 128)
  const long n_pad = padded_rows(n);
  const int np = int(n_pad);
  const int n_splits = split_count(n);
  bf16* encp = static_cast<bf16*>(scratch);
  bf16* nh = encp + size_t(n_pad) * 2 * KC;
  bf16* dh = nh + size_t(N_LAYERS + 1) * n_pad * NW;
  bf16* hv = dh + size_t(N_LAYERS + 1) * n_pad * NW;
  sm90::ScratchMaps maps{};
  int rc = sm90::encode_box_map(&maps.emb, encp, n_pad, 2 * KC);
  if (rc == 0) rc = sm90::encode_box_map(&maps.nh, nh, (N_LAYERS + 1) * n_pad, NW);
  if (rc == 0) rc = sm90::encode_box_map(&maps.dh, dh, (N_LAYERS + 1) * n_pad, NW);
  if (rc == 0) rc = sm90::encode_box_map(&maps.hv, hv, 2 * n_pad, VW);
  if (rc != 0) return rc;

  cudaError_t err = cudaFuncSetAttribute(sm90::mlpv_bwd_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sm90::BWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int n_tiles = int(n_pad / TM);
  sm90::mlpv_bwd_chain_kernel<<<sm90::persistent_grid(n_tiles), sm90::THREADS,
                                sm90::BWD_SMEM_BYTES, stream>>>(
      maps, static_cast<const bf16*>(emb), static_cast<const bf16*>(embv),
      static_cast<const float*>(draw), n, n_tiles, n_pad, static_cast<const bf16*>(image), p,
      static_cast<float*>(demb), static_cast<float*>(dembv));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  // the 12 dW products: the chain's 9, then g_fw = nh8^T @ dfeat (with g_fb),
  // g_vwf = feat^T @ dhv (with g_vb), g_vwv = embv^T @ dhv (32 rows)
  sm90::DwJobs jobs;
  const int w_off[9] = {OFF_N0W, OFF_N1W, OFF_N2W, OFF_N3W, OFF_N4W,
                        OFF_N5E, OFF_N5H, OFF_N6W, OFF_N7W};
  const int b_off[9] = {OFF_N0B, OFF_N1B, OFF_N2B, OFF_N3B, OFF_N4B,
                        -1,      OFF_N5B, OFF_N6B, OFF_N7B};
  int n_jobs = sm90::chain_dw_jobs<EMB>(jobs, 0, np, w_off, b_off);
  if (n_jobs < 0 || n_jobs + 2 * NW / KC + 1 > sm90::MAX_DW_JOBS) {
    return int(cudaErrorInvalidValue);
  }
  for (int c = 0; c < NW; c += KC) {
    jobs.job[n_jobs++] = sm90::DwJob{1, 7 * np, c, KC, 0, N_LAYERS * np, NW,
                                     OFF_FW + c * NW, c == 0 ? OFF_FB : -1};
    jobs.job[n_jobs++] = sm90::DwJob{1, N_LAYERS * np, c, KC, 1, np, VW,
                                     OFF_VWF + c * VW, c == 0 ? OFF_VB : -1};
  }
  jobs.job[n_jobs++] = sm90::DwJob{0, 0, KC, VEMB, 1, np, VW, OFF_VWV, -1};

  // g_aw with g_ab over nh8's two blocks of 128 columns, g_rw with g_rb over hv's
  const bf16* nh8 = nh + size_t(N_LAYERS - 1) * n_pad * NW;
  const sm90::HeadBlocks heads = {{{nh8, NW, 0, OFF_AW, OFF_AB},
                                   {nh8, NW, VW, OFF_AW + VW * OUT, -1},
                                   {hv, VW, 0, OFF_RW, OFF_RB}}};
  rc = sm90::launch_dw_heads(maps, jobs, n_jobs, heads, 3, static_cast<const float*>(draw), n,
                             n_pad, n_splits, GRAD_FLOATS, static_cast<float*>(partials),
                             stream);
  if (rc != 0) return rc;
  mlp_reduce_kernel<<<dim3((GRAD_FLOATS + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(partials), n_splits, GRAD_FLOATS, static_cast<float*>(grads));
  return int(cudaGetLastError());
}
