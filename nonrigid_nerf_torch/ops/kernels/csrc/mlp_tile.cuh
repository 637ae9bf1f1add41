// Shared device code of the kernels that keep the first design: the
// deformation field's (bend_tile.cuh, for bend_fwd.cu, bend_bwd.cu and
// fused_bwd.cu's pre-pass), and what every backward shares besides its chain
// (mlp_bwd.cu, mlpe_bwd.cu, mlpv_bwd.cu, fused_bwd.cu): the single-head
// gradient layout, the buffer sizes and the fixed-order reduction over the
// splits. Every chain of the canonical MLP runs on wgmma, csrc/mlp_sm90.cuh.
//
// - the tile: one CTA of 8 warps owns 128 points, warp w rows w*16 .. +16 of
//   each tile in shared memory; products on warp-level bf16 tensor-core MMA
//   (nvcuda::wmma 16x16x16) with f32 accumulators (`for_each_run` hands a
//   warp's fragments out through a scratch of 16 x 16 floats per warp);
// - the 64-lane Fourier encoding of the bent points (`encoding_lane`);
// - the reduction: the sum of each output element over the splits' partial
//   gradients, in ascending order of the splits.
//
// No atomics anywhere: the same inputs give bit-equal outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TM = 128;        // points per CTA
constexpr int NW = 256;        // hidden width
constexpr int EMB = 64;        // encoding width (63 channels + 1 zero lane)
constexpr int EMB_TC = 128;    // time-conditioned input width (63 + 32 + 33 zero lanes)
constexpr int VEMB = 32;       // view-encoding width (27 channels + 5 zero lanes)
constexpr int VW = 128;        // width of the view-conditioned layer
constexpr int OUT = 8;         // head width (4 lanes used)
constexpr int KC = 64;         // lanes of a k-atom (mlp_sm90.cuh's chunks)
constexpr int THREADS = 256;   // 8 warps
constexpr int N_LAYERS = 8;
constexpr int SPLIT_ROWS = 2048;   // points per split of the dW products
constexpr size_t WSCR_BYTES = size_t(THREADS / 32) * 16 * 16 * sizeof(float);
constexpr size_t SMEM_LIMIT = 232448;   // what one Hopper CTA can use

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Hand the warp's fragments out in runs of 8 values: f(row, col, v) gets the
// row within the tile, the first of 8 consecutive columns within the
// chunk's 16*NJ output columns, and the 8 f32 values.
template <int NJ, class F>
__device__ __forceinline__ void for_each_run(AccFrag (&acc)[NJ], float* wscr, int warp,
                                             int lane, F&& f) {
  const int er = lane / 2;
  const int ec = (lane % 2) * 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::store_matrix_sync(wscr, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    f(warp * 16 + er, j * 16 + ec, wscr + er * 16 + ec);
    __syncwarp();
  }
}

// grads[i] = sum over the splits, in ascending order, of partials[s][i]
__global__ void __launch_bounds__(THREADS)
mlp_reduce_kernel(const float* __restrict__ partials, int n_splits, int grad_floats,
                  float* __restrict__ grads) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= grad_floats) return;
  float s = 0.0f;
  for (int k = 0; k < n_splits; ++k) s += partials[size_t(k) * grad_floats + i];
  grads[i] = s;
}

inline long padded_rows(int n) { return (long(n) + TM - 1) / TM * TM; }
inline int split_count(int n) {
  return int((padded_rows(n) + SPLIT_ROWS - 1) / SPLIT_ROWS);
}

// ---- the Fourier encoding of the bent points (bend_tile.cuh)
//
// Lane c of the 64-lane encoding of a point x (3 f32), multires 10:
//   c < 3:        x[c]
//   3 <= c < 63:  sin(x[j] * 2^k + phase), k = (c - 3) / 6, j = (c - 3) % 3,
//                 phase = pi/2 on the cosine lanes ((c - 3) % 6 >= 3), else 0
//   c == 63:      0 (the pad lane)
// x[j] * 2^k is exact, the sum with the phase is one f32 rounding, and the
// sine is sinf (the arguments reach 2^9 |x|: no fast-math intrinsic).

constexpr int PTS = 3;                          // coordinates per point
constexpr float HALF_PI = 1.57079632679489661923f;   // float32(pi / 2)

// lanes 3 .. 62: the coordinate, the frequency and the phase of lane c
__device__ __forceinline__ void encoding_lane(int c, int& j, float& scale,
                                              float& phase) {
  const int rem = (c - 3) % 6;
  j = rem % 3;
  scale = float(1 << ((c - 3) / 6));
  phase = rem >= 3 ? HALF_PI : 0.0f;
}

// ---- what the single-head backward kernels share (mlp_bwd.cu, mlpe_bwd.cu,
// fused_bwd.cu), in a namespace of its own: mlpv_bwd.cu has another gradient
// layout

namespace single_head {

// offsets (in floats) of the 19 gradients in one flat pack-order buffer at an
// encoding of E lanes:
// n0w n0b n1w n1b n2w n2b n3w n3b n4w n4b n5e n5h n5b n6w n6b n7w n7b ow ob
template <int E>
struct GradLayout {
  static constexpr int WW = NW * NW, EW = E * NW;
  static constexpr int OFF_N0W = 0;
  static constexpr int OFF_N0B = OFF_N0W + EW;
  static constexpr int OFF_N1W = OFF_N0B + NW;
  static constexpr int OFF_N1B = OFF_N1W + WW;
  static constexpr int OFF_N2W = OFF_N1B + NW;
  static constexpr int OFF_N2B = OFF_N2W + WW;
  static constexpr int OFF_N3W = OFF_N2B + NW;
  static constexpr int OFF_N3B = OFF_N3W + WW;
  static constexpr int OFF_N4W = OFF_N3B + NW;
  static constexpr int OFF_N4B = OFF_N4W + WW;
  static constexpr int OFF_N5E = OFF_N4B + NW;
  static constexpr int OFF_N5H = OFF_N5E + EW;
  static constexpr int OFF_N5B = OFF_N5H + WW;
  static constexpr int OFF_N6W = OFF_N5B + NW;
  static constexpr int OFF_N6B = OFF_N6W + WW;
  static constexpr int OFF_N7W = OFF_N6B + NW;
  static constexpr int OFF_N7B = OFF_N7W + WW;
  static constexpr int OFF_OW = OFF_N7B + NW;
  static constexpr int OFF_OB = OFF_OW + NW * OUT;
  static constexpr int FLOATS = OFF_OB + OUT;
  // 64-row blocks of the 9 weight gradients: 28 + 2 * E/64
  static constexpr int DW_TILES = 7 * (NW / 64) + 2 * (E / 64);
};
constexpr int GRAD_FLOATS = GradLayout<EMB>::FLOATS;
static_assert(GRAD_FLOATS == 495624 && GradLayout<EMB_TC>::FLOATS == 528392,
              "pack-order layout");

// Sizes of the buffers a single-head backward needs for n points at an
// encoding of E lanes: the bf16 scratch (emb copy + nh1..nh8 + dh1..dh8, rows
// padded to 128) in elements, and the f32 partials (one flat pack-order
// gradient per 2048-point split).
template <int E = EMB>
inline void chain_bwd_sizes(int n, long long* scratch_elems, long long* partial_floats) {
  *scratch_elems = (long long)padded_rows(n) * (E + 2 * N_LAYERS * NW);
  *partial_floats = (long long)split_count(n) * GradLayout<E>::FLOATS;
}

}  // namespace single_head

}  // namespace
