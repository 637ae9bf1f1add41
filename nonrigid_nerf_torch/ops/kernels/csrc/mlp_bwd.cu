// Canonical NeRF MLP backward (8 x 256, skip at layer 4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlp_core_bwd` / `_mlp_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:786-793,833-858), whose math is
// `_mlp_bwd_math` (fused_query.py:702-767). It is NOT the autograd of the
// forward; the arithmetic it reproduces:
//
//   nh1..nh8 recomputed in bf16 from the bf16 encoding, as in mlp_fwd.cu;
//   drawb = bf16(draw);  g_ob = sum(draw) over the points, in f32, uncast;
//   g_ow  = nh8^T @ drawb
//   dh8   = bf16((drawb @ ow^T) * (nh8 > 0))
//   dh_l  = bf16((dh_{l+1} @ W_l^T) * (nh_l > 0))        l = 7 .. 1
//   g_W_l = nh_l^T @ dh_{l+1},  g_b_l = sum(dh_{l+1})    (f32 sums of the
//                                                          rounded values)
//   skip:  g_n5h = nh5^T @ dh6,  g_n5e = emb^T @ dh6,
//          demb  = dh6 @ n5e^T + dh1 @ n0w^T             (f32, no mask)
//
// All products are bf16 x bf16 with f32 accumulation. Outputs: demb (n, E)
// f32 and the 19 weight gradients in pack order, f32, summed over all points.
// E, the encoding's width, is 64 or 128 (the time-conditioned baseline's
// input: there lanes 63 .. 94 of demb are the latents' gradient); the
// kernels are templates on E, instantiated at both.
//
// What bounds it: 1,480,704 MACs per point at 64 lanes, 1,579,008 at 128
// (recompute + dh chain + dW) against 416 bytes of HBM traffic at 64 lanes
// (800 at 128) that the function must move, so the tensor cores bound it.
//
// Design. The TPU kernel walks a sequential grid and adds each block's dW
// into 2.0 MB of VMEM accumulators. Here blocks run in parallel and a CTA has
// 227 KB, and the eight activations of one 128-point tile alone are 512 KB,
// so a single fused kernel would have to spill them to global memory anyway.
// Hence two passes with a fixed-order reduction, all on mlp_sm90.cuh:
//
// 1. `mlp_bwd_chain_kernel`: persistent CTAs, one per SM, walk 128-point
//    tiles; two consumer warpgroups own 64 rows each, a producer warp streams
//    the weights through a 3-stage ring of 32 KB chunks (cp.async.bulk, full /
//    empty mbarriers) from an image the wrapper pre-packed: the recompute's
//    30 chunks (32 at 128 lanes), then the dh chain's 30 (32). The recompute
//    runs nh1..nh8 as mlp_fwd.cu does (wgmma m64n256k16), keeps each layer's
//    ReLU gates as bits (4 words a thread and layer) and stores the layer to
//    the scratch with bulk tensor stores (TMA) from the swizzled tile. dh8
//    comes from draw on the CUDA cores. Then the dh chain: `dh @ W^T` reads
//    64-row chunks W[i0 : i0 + 64, :], packed as the K-major B operand of the
//    64 output columns i0.. (wgmma m64n64k16, K = 256; one warpgroup's
//    epilogue overlaps the other's products); the ReLU
//    mask is the recompute's gate bits (the same thread holds the same
//    elements in both accumulator layouts). demb goes out in f32; dh_l goes
//    to the scratch by TMA like nh_l. The scratch (emb, nh_l, dh_l in bf16)
//    is 8,320 B per point at 64 lanes, 8,448 at 128. Shared memory: two 128
//    x 256 activation tiles, the ring and its barriers, 230,528 B with the 1
//    KB of alignment slack. The encoding tile (16 or 32 KB) is read only by
//    the recompute's layers 0 and 5, while the second activation tile is not
//    yet in use, so it lives there: a tile of its own would not fit beside a
//    ring of 3 stages. The next tile's encoding is loaded into it during the
//    dh chain's last step, which reads only the first tile. Rows past n
//    carry draw = 0, so their dh is exactly 0 and they add nothing below.
// 2. `mlp_dw_sm90_kernel`: every dW = act^T @ dh as a split-K product on
//    wgmma. CTA (job, split) forms a 64 x 256 block of one dW over 2048
//    points from a 2-stage TMA ring of 64-point boxes of the scratch (both
//    operands MN-major: the points, the contraction axis, are the scratch's
//    rows) and writes it to its own slot of a partials buffer; the job of a
//    product's first 64 columns also sums dh_l's columns (the bias
//    gradient) while the products run. `mlp_head_grad_kernel` forms g_ow and
//    g_ob on the CUDA cores.
// 3. `mlp_reduce_kernel` (mlp_tile.cuh) sums the partials of each output
//    element over the splits in ascending order.
//
// What bounds it now: the scratch written by pass 1 and read back by pass 2
// (2.2 GB of HBM traffic at 131,072 points, 0.65 ms at 3.35 TB/s, against
// an operations bound of 0.39 ms). See PERF.md for the measured times.
//
// No atomics anywhere: the same inputs give bit-equal outputs.
//
// Plain C interface, bound with ctypes (see ../mlp_bwd.py).

#include "mlp_sm90.cuh"
#include "mlp_tile.cuh"

namespace sm90 {
namespace {

struct ChainArgs {
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const bf16* ow;                // (256, 8) bf16
};

template <int E>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_chain_kernel(const __grid_constant__ ScratchMaps maps, const bf16* __restrict__ emb,
                     const float* __restrict__ draw, int n, int n_tiles, long n_pad,
                     const bf16* __restrict__ image, ChainArgs p, float* demb) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* buf_a = align_smem(smem_raw);
  unsigned char* buf_b = buf_a + ACT_BYTES;
  const uint32_t a_s = smem_u32(buf_a);
  const uint32_t b_s = smem_u32(buf_b);   // the encoding tile until dh8 (see above)
  const uint32_t ring = b_s + uint32_t(ACT_BYTES);
  const uint32_t bars = ring + BWD_STAGES * CHUNK_BYTES;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) ring_init<BWD_STAGES>(bars);
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) produce<BWD_STAGES>(image, n_chain_chunks<E>, n_tiles, ring, bars);
  } else {                 // a consumer: 64 rows of every tile
    setmaxnreg_inc<CONSUMER_REGS>();
    uint32_t gates[N_LAYERS - 1][4];   // nh1 .. nh7's ReLU gates of this thread's values
    uint32_t g = 0;
    load_emb_rows<E>(b_s, emb, long(blockIdx.x) * TM, n, wg, t);
    cp_async_commit();
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long row0 = long(tile) * TM;
      const int next = tile + gridDim.x;
      const int wrow = int(row0) + wg * WG_ROWS;   // this warpgroup's first row
      cp_async_wait_all();
      fence_proxy_async();
      wg_barrier(wg);   // the encoding has landed; the last tile is done
      // the padded copy of the encoding that the dW products read
      if (t == 0) store_rows(&maps.emb, b_s, E / BOX, wrow, wg);

      // ---- recompute nh1 .. nh8 (as mlp_fwd.cu), each stored to the scratch
      chain_tile<BWD_STAGES, E>(buf_a, b_s, p.bias, ring, bars, g, wg, t, &maps, n_pad, row0,
                                gates, [] {});

      // ---- dh8 into buf_b, over the encoding tile that layers 0 and 5 (and
      // the copy, waited for before layer 0's epilogue) have read
      dh8_rows(draw, row0, n, p.ow, buf_a, buf_b, wg, t);
      fence_proxy_async();
      wg_barrier(wg);
      if (t == 0) store_rows(&maps.dh, b_s, NW / BOX, int(7 * n_pad) + wrow, wg);

      // ---- the dh chain: each step takes the tile `cur` times W^T
      //   dh_l = bf16((dh_{l+1} @ W_l^T) * (nh_l > 0))   l = 7 .. 1
      //   demb = dh6 @ n5e^T + dh1 @ n0w^T               (f32, no mask)
      // A step that writes `oth` first waits until the bulk store that last
      // read it has (it is never the newest one: that read `cur`).
      unsigned char* cur = buf_b;
      unsigned char* oth = buf_a;
#pragma unroll 1
      for (int step = 0; step < 9; ++step) {
        const int layer = bwd_layer(step);   // 0: a demb product
        if (layer) {
          if (t == 0) bulk_wait_read<1>();
          wg_barrier(wg);
          dh_step<BWD_STAGES, E, NW / KC>(smem_u32(cur), oth, gates[layer - 1], nullptr, 0,
                                          false, ring, bars, g, wg, t);
          fence_proxy_async();
          wg_barrier(wg);
          if (t == 0) {
            store_rows(&maps.dh, smem_u32(oth), NW / BOX, int((layer - 1) * n_pad) + wrow, wg);
          }
          unsigned char* tmp = cur;
          cur = oth;
          oth = tmp;
        } else {
          if (step == 8) {   // cur is buf_a: buf_b takes the next tile's encoding
            if (t == 0) bulk_wait_read<1>();
            wg_barrier(wg);
            if (next < n_tiles) load_emb_rows<E>(b_s, emb, long(next) * TM, n, wg, t);
            cp_async_commit();
          }
          dh_step<BWD_STAGES, E, E / KC>(smem_u32(cur), nullptr, nullptr,
                                         demb + size_t(row0) * E, long(n) - row0, step == 8,
                                         ring, bars, g, wg, t);
        }
      }
    }
    if (t == 0) bulk_wait_all();
  }
}

// ---- the second pass's products: dW = act^T @ dh on wgmma

constexpr int DW_RK = 64;           // points per staged chunk
constexpr int DW_STAGES = 2;
constexpr int DW_SPLIT = 2048;      // points per split (mlp_tile.cuh's SPLIT_ROWS)
constexpr int DW_THREADS = 128;
constexpr int SUM_GROUPS = 4;       // mlp_tile.cuh's SMALL_GROUPS
constexpr int MAX_DW_JOBS = 32;
constexpr uint32_t DW_A_BYTES = BOX_BYTES;                   // 64 points x 64 act lanes
constexpr uint32_t DW_B_BYTES = (NW / BOX) * BOX_BYTES;      // 64 points x 256 dh lanes
constexpr uint32_t DW_STAGE_BYTES = DW_A_BYTES + DW_B_BYTES;
constexpr size_t DW_SMEM_BYTES = SMEM_ALIGN + DW_STAGES * DW_STAGE_BYTES + BAR_BYTES;
static_assert(2 * DW_SMEM_BYTES <= SMEM_LIMIT, "two dW CTAs share an SM");
static_assert(DW_STAGE_BYTES % SMEM_ALIGN == 0 && DW_A_BYTES % SMEM_ALIGN == 0,
              "every staged box starts on the swizzle's 1024 bytes");

struct DwJob {
  int a_emb;      // 1: the activation is the encoding copy; 0: an nh layer
  int a_row0;     // the activation layer's first row in its map
  int a_col;      // the first of the job's 64 activation columns
  int b_row0;     // dh_l's first row in the dh map
  int out_off;    // the job's 64 x 256 block of a weight gradient, in the flat grads
  int bias_off;   // -1, or where dh_l's column sums (the bias gradient) go
};

struct DwJobs {
  DwJob job[MAX_DW_JOBS];
};

// CTA (job, split) forms act[rows, a_col : a_col + 64]^T @ dh_l[rows, :] over
// the split's rows on wgmma (both operands MN-major: the boxes are the
// scratch's point-major rows as TMA lays them out) and writes it to the
// split's slot of the partials; with bias_off, also dh_l's column sums over
// the split's rows, in ascending order of the points, on the CUDA cores
// while the products run. TMA fills a ring of DW_STAGES chunks.
__global__ void __launch_bounds__(DW_THREADS, 2)
mlp_dw_sm90_kernel(const __grid_constant__ ScratchMaps maps, const DwJobs jobs, long n_pad,
                   int grad_floats, float* __restrict__ partials) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  const uint32_t stages = smem_u32(base);
  const uint32_t bars = stages + DW_STAGES * DW_STAGE_BYTES;
  const DwJob job = jobs.job[blockIdx.x];
  const int t = threadIdx.x;
  const long r_begin = long(blockIdx.y) * DW_SPLIT;
  const long r_end = (r_begin + DW_SPLIT < n_pad) ? r_begin + DW_SPLIT : n_pad;
  const int n_k = int((r_end - r_begin) / DW_RK);
  const CUtensorMap* amap = job.a_emb ? &maps.emb : &maps.nh;
  if (t == 0) {
    for (int s = 0; s < DW_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto issue = [&](int k) {   // thread 0: chunk k into its stage
    const uint32_t s = k % DW_STAGES;
    const uint32_t bar = bars + 8 * s;
    const uint32_t a = stages + s * DW_STAGE_BYTES;
    const int row = int(r_begin) + k * DW_RK;
    mbar_expect_tx(bar, DW_STAGE_BYTES);
    tma_load_2d(a, amap, job.a_col, job.a_row0 + row, bar);
    for (int q = 0; q < NW / BOX; ++q) {
      tma_load_2d(a + DW_A_BYTES + q * BOX_BYTES, &maps.dh, q * BOX, job.b_row0 + row, bar);
    }
  };
  if (t == 0) {
    for (int k = 0; k < DW_STAGES && k < n_k; ++k) issue(k);
  }

  float acc[128];
  // the column sums in mlp_tile.cuh's order (mlp_small_kernel): SUM_GROUPS
  // partial sums, point p of the split into sum p % SUM_GROUPS, added in
  // ascending order at the end, so mlp_bwd's bias gradients are bit-equal to
  // those of the kernels that keep that second pass (fused_bwd.cu)
  float bsum[2][SUM_GROUPS] = {};
  const bool bias = job.bias_off >= 0;
  const int bcol = 2 * t;   // this thread's two dh columns of the sums
#pragma unroll 1
  for (int k = 0; k < n_k; ++k) {
    const uint32_t s = k % DW_STAGES;
    const uint32_t a = stages + s * DW_STAGE_BYTES;
    const uint32_t b = a + DW_A_BYTES;
    mbar_wait(bars + 8 * s, (k / DW_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_RK / 16; ++kk) {   // 16 points = 2 K-groups of 8 rows
      wgmma_m64n256_mn(acc, desc_mn_sw128(a + kk * 16 * ATOM_ROW_BYTES, BOX_BYTES),
                       desc_mn_sw128(b + kk * 16 * ATOM_ROW_BYTES, BOX_BYTES), (k | kk) != 0);
    }
    wgmma_commit();
    if (bias) {
      const unsigned char* bp = base + (b - stages) + (bcol / BOX) * BOX_BYTES;
      const int cc = bcol % BOX;
#pragma unroll 8
      for (int pt = 0; pt < DW_RK; ++pt) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            bp + pt * ATOM_ROW_BYTES + ((((cc >> 3) ^ (pt & 7))) << 4) + ((cc & 7) << 1));
        bsum[0][pt % SUM_GROUPS] += __bfloat162float(v.x);
        bsum[1][pt % SUM_GROUPS] += __bfloat162float(v.y);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();   // every thread is done with the stage
    if (t == 0 && k + DW_STAGES < n_k) issue(k + DW_STAGES);
  }

  float* out = partials + size_t(blockIdx.y) * grad_floats;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(out + job.out_off + (r0 + 8 * h) * NW + col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if (bias) {
    float s0 = bsum[0][0], s1 = bsum[1][0];
#pragma unroll
    for (int q = 1; q < SUM_GROUPS; ++q) {
      s0 += bsum[0][q];
      s1 += bsum[1][q];
    }
    *reinterpret_cast<float2*>(out + job.bias_off + bcol) = make_float2(s0, s1);
  }
}

// g_ow = nh8^T @ bf16(draw) (256 x 8) and g_ob = sum(draw) (uncast) over one
// split's rows, on the CUDA cores: block (split, 128-column half), one column
// a thread in each of HG_GROUPS row groups; the rows pass through shared
// memory HG_ROWS at a time (coalesced 16-byte loads). Group g takes every
// HG_GROUPS-th row from g on, in ascending order, and the groups are added
// in order: the order of mlp_tile.cuh's head job. Rows past n have draw = 0
// and are skipped.
constexpr int HG_COLS = 128;
constexpr int HG_GROUPS = SUM_GROUPS;
constexpr int HG_ROWS = 64;
constexpr int HG_THREADS = HG_COLS * HG_GROUPS;
static_assert(HG_ROWS % HG_GROUPS == 0 && DW_SPLIT % HG_ROWS == 0,
              "a staged block of rows keeps every group's order");

__global__ void __launch_bounds__(HG_THREADS)
mlp_head_grad_kernel(const bf16* __restrict__ nh8, const float* __restrict__ draw, int n,
                     int grad_floats, int ow_off, int ob_off, float* __restrict__ partials) {
  __shared__ __align__(16) bf16 rows[HG_ROWS][HG_COLS];
  __shared__ float draws[HG_ROWS][OUT];
  __shared__ float red[HG_GROUPS][HG_COLS][OUT + 1];
  const int lane = threadIdx.x % HG_COLS;   // this thread's column of the block's
  const int grp = threadIdx.x / HG_COLS;
  const int col0 = blockIdx.y * HG_COLS;
  const bool sums_draw = blockIdx.y == 0 && lane < OUT;   // g_ob's lanes
  const long r_begin = long(blockIdx.x) * DW_SPLIT;
  const long r_last = (r_begin + DW_SPLIT < n) ? r_begin + DW_SPLIT : n;
  float acc[OUT + 1];
#pragma unroll
  for (int o = 0; o <= OUT; ++o) acc[o] = 0.0f;
  for (long r0 = r_begin; r0 < r_last; r0 += HG_ROWS) {
    for (int i = threadIdx.x; i < HG_ROWS * HG_COLS / 8; i += HG_THREADS) {
      const int r = i / (HG_COLS / 8);
      const int q = i % (HG_COLS / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < r_last) {
        v = *reinterpret_cast<const uint4*>(nh8 + size_t(r0 + r) * NW + col0 + q * 8);
      }
      *reinterpret_cast<uint4*>(&rows[r][q * 8]) = v;
    }
    for (int i = threadIdx.x; i < HG_ROWS * OUT; i += HG_THREADS) {
      const long r = r0 + i / OUT;
      draws[i / OUT][i % OUT] = r < r_last ? __ldg(draw + size_t(r) * OUT + i % OUT) : 0.0f;
    }
    __syncthreads();
    const int rows_here = int((r_last - r0 < HG_ROWS) ? r_last - r0 : HG_ROWS);
    for (int r = grp; r < rows_here; r += HG_GROUPS) {
      const float a = __bfloat162float(rows[r][lane]);
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        acc[o] += a * __bfloat162float(__float2bfloat16(draws[r][o]));
      }
      if (sums_draw) acc[OUT] += draws[r][lane];
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = 0; o <= OUT; ++o) red[grp][lane][o] = acc[o];
  __syncthreads();
  if (grp != 0) return;
  float* out = partials + size_t(blockIdx.x) * grad_floats;
#pragma unroll
  for (int o = 0; o <= OUT; ++o) {
    float s = red[0][lane][o];
#pragma unroll
    for (int q = 1; q < HG_GROUPS; ++q) s += red[q][lane][o];
    if (o < OUT) {
      out[ow_off + (col0 + lane) * OUT + o] = s;
    } else if (sums_draw) {
      out[ob_off + lane] = s;
    }
  }
}

}  // namespace
}  // namespace sm90

namespace {

using namespace single_head;   // the gradient layout, the reduce kernel

static_assert(sm90::DW_SPLIT == SPLIT_ROWS, "the partials hold one slot per split");
static_assert(sm90::SUM_GROUPS == SMALL_GROUPS && sm90::DW_RK % SMALL_GROUPS == 0,
              "the sums over the points keep the second pass's order");

// The second pass over the chain kernel's scratch: the 9 products g_W =
// act^T @ dh in 64-row jobs with the bias sums of dh1 .. dh8 (on wgmma,
// mlp_dw_sm90_kernel), g_ow = nh8^T @ bf16(draw) with g_ob
// (mlp_head_grad_kernel), and the fixed-order reduction over the splits
// (mlp_tile.cuh's mlp_reduce_kernel).
template <int E>
int launch_second_pass_sm90(const sm90::ScratchMaps& maps, const bf16* nh8, const float* draw,
                            int n, float* partials, float* grads, cudaStream_t stream) {
  using L = GradLayout<E>;
  const long n_pad = padded_rows(n);
  const int n_splits = split_count(n);
  const int np = int(n_pad);
  sm90::DwJobs jobs;
  struct Prod { int a_emb, a_layer, lda, dh_layer, off, bias_off; };
  const Prod prods[9] = {
      {1, 0, E, 1, L::OFF_N0W, L::OFF_N0B},  {0, 1, NW, 2, L::OFF_N1W, L::OFF_N1B},
      {0, 2, NW, 3, L::OFF_N2W, L::OFF_N2B}, {0, 3, NW, 4, L::OFF_N3W, L::OFF_N3B},
      {0, 4, NW, 5, L::OFF_N4W, L::OFF_N4B}, {1, 0, E, 6, L::OFF_N5E, -1},
      {0, 5, NW, 6, L::OFF_N5H, L::OFF_N5B}, {0, 6, NW, 7, L::OFF_N6W, L::OFF_N6B},
      {0, 7, NW, 8, L::OFF_N7W, L::OFF_N7B}};
  int n_jobs = 0;
  for (const Prod& pr : prods) {
    for (int c = 0; c < pr.lda; c += sm90::BOX) {
      if (n_jobs == sm90::MAX_DW_JOBS) return int(cudaErrorInvalidValue);
      jobs.job[n_jobs++] = sm90::DwJob{pr.a_emb, pr.a_emb ? 0 : (pr.a_layer - 1) * np, c,
                                       (pr.dh_layer - 1) * np, pr.off + c * NW,
                                       c == 0 ? pr.bias_off : -1};
    }
  }
  if (n_jobs != L::DW_TILES) return int(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(sm90::mlp_dw_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sm90::DW_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  sm90::mlp_dw_sm90_kernel<<<dim3(n_jobs, n_splits), sm90::DW_THREADS, sm90::DW_SMEM_BYTES,
                             stream>>>(maps, jobs, n_pad, L::FLOATS, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  sm90::mlp_head_grad_kernel<<<dim3(n_splits, NW / sm90::HG_COLS), sm90::HG_THREADS, 0,
                               stream>>>(
      nh8, draw, n, L::FLOATS, L::OFF_OW, L::OFF_OB, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mlp_reduce_kernel<<<dim3((L::FLOATS + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partials, n_splits, L::FLOATS, grads);
  return int(cudaGetLastError());
}

template <int E>
int launch_mlp_bwd(const void* emb, const void* draw, int n, const void* image,
                   const void* const* mats, const void* const* biases, void* scratch,
                   void* partials, void* demb, void* grads, cudaStream_t stream) {
  sm90::ChainArgs p;
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = static_cast<const bf16*>(mats[9]);

  cudaError_t err = cudaFuncSetAttribute(sm90::mlp_bwd_chain_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sm90::BWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaErrorInvalidValue);

  const long n_pad = padded_rows(n);
  const int n_tiles = int(n_pad / TM);
  bf16* embp = static_cast<bf16*>(scratch);
  bf16* nh = embp + size_t(n_pad) * E;
  bf16* dh = nh + N_LAYERS * size_t(n_pad) * NW;
  sm90::ScratchMaps maps;
  int rc = sm90::encode_box_map(&maps.emb, embp, n_pad, E);
  if (rc == 0) rc = sm90::encode_box_map(&maps.nh, nh, N_LAYERS * n_pad, NW);
  if (rc == 0) rc = sm90::encode_box_map(&maps.dh, dh, N_LAYERS * n_pad, NW);
  if (rc != 0) return rc;

  sm90::mlp_bwd_chain_kernel<E>
      <<<sm90::persistent_grid(n_tiles), sm90::THREADS, sm90::BWD_SMEM_BYTES, stream>>>(
          maps, static_cast<const bf16*>(emb), static_cast<const float*>(draw), n, n_tiles,
          n_pad, static_cast<const bf16*>(image), p, static_cast<float*>(demb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  return launch_second_pass_sm90<E>(maps, nh + size_t(N_LAYERS - 1) * n_pad * NW,
                                    static_cast<const float*>(draw), n,
                                    static_cast<float*>(partials), static_cast<float*>(grads),
                                    stream);
}

}  // namespace

// Sizes of the buffers the caller allocates for n points at an encoding of
// emb_width (64 or 128) lanes: the bf16 scratch (emb copy + nh1..nh8 +
// dh1..dh8, rows padded to 128) in elements, and the f32 partials (one flat
// pack-order gradient per 2048-point split) in floats. Returns the CUDA
// error code (0 on success; another width is an invalid value).
extern "C" int nrnerf_mlp_bwd_sizes(int n, int emb_width, long long* scratch_elems,
                                    long long* partial_floats) {
  switch (emb_width) {
    case EMB:
      chain_bwd_sizes<EMB>(n, scratch_elems, partial_floats);
      return 0;
    case EMB_TC:
      chain_bwd_sizes<EMB_TC>(n, scratch_elems, partial_floats);
      return 0;
    default:
      return int(cudaErrorInvalidValue);
  }
}

// emb (n, emb_width) bf16 with emb_width 64 or 128, draw (n, 8) f32; image:
// the chain's forward then backward chunks pre-packed as mlp_sm90.cuh lays
// them out (ops/kernels/mlp_sm90.py:pack_chain_image), n_chain_chunks x 32
// KB; mats and biases as in nrnerf_mlp_fwd (of mats only ow is read):
// mats: n0w (emb_width x 256), n1w..n4w (256x256), n5e (emb_width x 256),
//       n5h, n6w, n7w (256x256), ow (256x8), bf16 row-major (in, out);
// biases: n0b..n4b, n5b, n6b, n7b (256 f32 each), ob (unused here).
// scratch, partials: sized by nrnerf_mlp_bwd_sizes; demb (n, emb_width) f32;
// grads: GradLayout<emb_width>::FLOATS f32, the 19 gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_mlp_bwd(const void* emb, const void* draw, int n, int emb_width,
                              const void* image, const void* const* mats,
                              const void* const* biases, void* scratch, void* partials,
                              void* demb, void* grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (emb_width) {
    case EMB:
      return launch_mlp_bwd<EMB>(emb, draw, n, image, mats, biases, scratch, partials,
                                 demb, grads, stream);
    case EMB_TC:
      return launch_mlp_bwd<EMB_TC>(emb, draw, n, image, mats, biases, scratch,
                                    partials, demb, grads, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
