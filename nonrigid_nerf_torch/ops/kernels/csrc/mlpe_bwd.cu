// Canonical NeRF MLP backward on bent POINTS: the Fourier encoding is
// recomputed inside the kernel and its gradient is folded onto the three
// coordinates on the chip (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_mlpe_core_bwd` / `_mlpe_bwd_kernel`
// (nonrigid_nerf_tpu/ops/pallas/fused_query.py:909-926,960-985):
//
//   pre, emb as in mlpe_fwd.cu;  embb = bf16(emb)
//   demb and the 19 weight gradients: mlp_bwd.cu's arithmetic on embb
//   dpre = where(lane < 3, demb, demb * cos(pre + phase))
//   dpts[:, d] = sum over the lanes of dpre * P[d]
//
// Outputs: dpts (n, 3) f32 and the 19 weight gradients in pack order, f32,
// summed over all points. Nothing comes back for P or the phase: they are
// constants of the encoding.
//
// What bounds it: mlp_bwd.cu's 1,480,704 MACs per point, 60 sines and 60
// cosines, against 56 bytes per point that the function must move (12 B of
// coordinates, 32 B of draw, 12 B of dpts) and the weights and gradients: the
// tensor cores bound it.
//
// Design: mlp_bwd.cu's two passes (see there) with another prologue and
// another sink for demb.
// - Prologue: mlpe_fwd.cu's encoding. No encoding exists in HBM in this
//   mode, and the dW products g_n0w = embb^T @ dh1 and g_n5e = embb^T @ dh6 of
//   the second pass read their activations from the scratch: the recomputed
//   bf16 tile is stored there, where mlp_bwd.cu stores its copy of the
//   encoding, so the scratch has the same size (8,320 B per point).
// - demb (128 x 64 f32 per tile) never reaches HBM. The dh chain hands out
//   the two products of demb (dh6 @ n5e^T, then dh1 @ n0w^T) in runs of 8
//   lanes, and a lane always gets the same row. It keeps its row's three
//   coordinates and three partial sums in registers, multiplies each value
//   by cos(pre + phase) (recomputed with cosf) and by the lane's 2^k, and adds
//   it to the coordinate's sum. The fold is linear in demb, so the two
//   products are folded one after the other and never added as a tile. The
//   two lanes that share a row exchange their sums with one shuffle. The
//   order is fixed: bit-equal from run to run.
// - Second pass: mlp_tile.cuh's, as in mlp_bwd.cu. No atomics anywhere.
//
// Plain C interface, bound with ctypes (see ../mlpe_bwd.py).

#include "mlp_tile.cuh"

namespace {

using namespace single_head;   // the gradient layout, ChainParams, dh8, pass 2

constexpr size_t SMEM_BYTES =
    2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES + WSCR_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "fits one Hopper CTA");

__global__ void __launch_bounds__(THREADS, 1)
mlpe_bwd_chain_kernel(const float* __restrict__ pts, const float* __restrict__ draw,
                      int n, long n_pad, ChainParams p, bf16* __restrict__ embp,
                      bf16* nh, bf16* dh, float* __restrict__ dpts) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf_a = reinterpret_cast<bf16*>(smem);
  bf16* buf_b = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* embs = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES);
  bf16* stage = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES + EMB_BYTES);
  float* scratch = reinterpret_cast<float*>(
      smem + 2 * ACT_BYTES + EMB_BYTES + 2 * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long row0 = long(blockIdx.x) * TM;
  const long rows_left = long(n) - row0;
  const size_t layer_stride = size_t(n_pad) * NW;   // one nh_l or dh_l array
  bf16* nh_t = nh + size_t(row0) * NW;              // this tile's rows
  bf16* dh_t = dh + size_t(row0) * NW;

  auto prefetch = [&](int g) {
    if (g < N_CHAIN_CHUNKS) load_chunk(stage_of(stage, g), p.chunk[g], tid);
  };
  prefetch(0);
  cp_async_commit();
  // the encoding (rows past n are zero); the padded copy feeds the dW products
  load_coords(scratch, pts, row0, n, tid);
  __syncthreads();
  encode_tile(embs, scratch, rows_left, tid, embp + size_t(row0) * EMB);
  // the row whose runs of demb this lane gets from dh_chain, and its point
  const int my_row = warp * 16 + lane / 2;
  const float x0 = scratch[my_row * PTS + 0];
  const float x1 = scratch[my_row * PTS + 1];
  const float x2 = scratch[my_row * PTS + 2];

  float* wscr = scratch + warp * 256;
  int g = 0;

  // ---- recompute nh1 .. nh8 (as mlp_fwd.cu), each stored to the scratch.
  // Its first barrier comes before the warp scratch is written again.
  chain_forward(buf_a, embs, stage, wscr, p.bias, g, prefetch, nh_t, layer_stride,
                warp, lane);

  // ---- dh8 = bf16((bf16(draw) @ ow^T) * (nh8 > 0)); the draw tile borrows
  // the warp scratch
  dh8_from_draw(draw, row0, n, p.ow, scratch, buf_a, buf_b,
                dh_t + size_t(7) * layer_stride, tid);

  // ---- the dh chain; demb is folded onto the coordinates as it comes
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  auto fold = [&](int, int, int col, const float* v) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = col + e;
      if (c == EMB - 1) continue;          // the pad lane: P has no entry
      int j = c;
      float t = v[e];                      // lanes 0..2: dpre = demb, P = 1
      if (c >= 3) {
        float scale, phase;
        encoding_lane(c, j, scale, phase);
        const float x = j == 0 ? x0 : (j == 1 ? x1 : x2);
        const float pre = __fadd_rn(__fmul_rn(x, scale), phase);
        t = __fmul_rn(__fmul_rn(v[e], cosf(pre)), scale);
      }
      d0 += j == 0 ? t : 0.0f;
      d1 += j == 1 ? t : 0.0f;
      d2 += j == 2 ? t : 0.0f;
    }
  };
  dh_chain(buf_b, buf_a, stage, wscr, g, prefetch, nh_t, dh_t, layer_stride, fold,
           warp, lane);
  // lanes 2r and 2r + 1 hold the two halves of row r's sums
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d2 += __shfl_xor_sync(0xffffffffu, d2, 1);
  if (lane % 2 == 0 && my_row < rows_left) {
    float* dst = dpts + size_t(row0 + my_row) * PTS;
    dst[0] = d0;
    dst[1] = d1;
    dst[2] = d2;
  }
}

}  // namespace

// Sizes of the buffers the caller allocates for n points: the bf16 scratch
// (encoding + nh1..nh8 + dh1..dh8, rows padded to 128) in elements, and the
// f32 partials (one flat pack-order gradient per 2048-point split) in floats.
extern "C" void nrnerf_mlpe_bwd_sizes(int n, long long* scratch_elems,
                                      long long* partial_floats) {
  chain_bwd_sizes(n, scratch_elems, partial_floats);
}

// pts (n, 3) f32, draw (n, 8) f32; mats and biases as `fill_chain_params`
// (mlp_tile.cuh) lists them. scratch, partials: sized by
// nrnerf_mlpe_bwd_sizes; dpts (n, 3) f32; grads: GRAD_FLOATS f32, the 19
// gradients in pack order.
// Returns the CUDA error code of the first failing call (0 on success).
extern "C" int nrnerf_mlpe_bwd(const void* pts, const void* draw, int n,
                               const void* const* mats, const void* const* biases,
                               void* scratch, void* partials, void* dpts,
                               void* grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ChainParams p;
  if (!fill_chain_params(mats, biases, p)) return int(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(
      mlpe_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaErrorInvalidValue);

  const long n_pad = padded_rows(n);
  bf16* embp = static_cast<bf16*>(scratch);
  bf16* nh = embp + size_t(n_pad) * EMB;
  bf16* dh = nh + N_LAYERS * size_t(n_pad) * NW;

  mlpe_bwd_chain_kernel<<<dim3(unsigned(n_pad / TM)), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(draw), n, n_pad, p,
      embp, nh, dh, static_cast<float*>(dpts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  return launch_chain_second_pass(embp, static_cast<const float*>(draw), n,
                                  static_cast<float*>(partials),
                                  static_cast<float*>(grads), stream);
}
