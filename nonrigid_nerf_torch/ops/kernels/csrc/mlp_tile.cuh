// What every backward of the canonical MLP shares besides its chain
// (mlp_bwd.cu, mlpe_bwd.cu, mlpv_bwd.cu, fused_bwd.cu): the widths, the
// single-head gradient layout, the buffer sizes, and the fixed-order
// reduction over the splits (mlp_sm90.cuh's `mlp_reduce_kernel`, the sum of
// each output element over the splits' partial gradients in ascending order
// of the splits). Every kernel runs on csrc/mlp_sm90.cuh.
//
// No atomics anywhere: the same inputs give bit-equal outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 128;        // points per tile
constexpr int NW = 256;        // hidden width
constexpr int EMB = 64;        // encoding width (63 channels + 1 zero lane)
constexpr int EMB_TC = 128;    // time-conditioned input width (63 + 32 + 33 zero lanes)
constexpr int VEMB = 32;       // view-encoding width (27 channels + 5 zero lanes)
constexpr int VW = 128;        // width of the view-conditioned layer
constexpr int OUT = 8;         // head width (4 lanes used)
constexpr int KC = 64;         // lanes of a k-atom (mlp_sm90.cuh's chunks)
constexpr int THREADS = 256;   // the reduction's block
constexpr int N_LAYERS = 8;
constexpr int SPLIT_ROWS = 2048;   // points per split of the dW products
static_assert(THREADS == sm90::REDUCE_THREADS, "the reduction's block");

using sm90::mlp_reduce_kernel;

inline long padded_rows(int n) { return (long(n) + TM - 1) / TM * TM; }
inline int split_count(int n) {
  return int((padded_rows(n) + SPLIT_ROWS - 1) / SPLIT_ROWS);
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
