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
// Hence two passes with a fixed-order reduction, all on mlp_sm90.cuh, which
// holds the kernels: the chain kernel is a template on its input
// (`EncodingIn<E>` here; mlpe_bwd.cu's `PtsIn` computes the encoding from
// points and folds demb onto them):
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

namespace {

using namespace single_head;   // the gradient layout, the reduce kernel

static_assert(sm90::DW_SPLIT == SPLIT_ROWS, "the partials hold one slot per split");

template <int E>
int launch_mlp_bwd(const void* emb, const void* draw, int n, const void* image,
                   const void* const* mats, const void* const* biases, void* scratch,
                   void* partials, void* demb, void* grads, cudaStream_t stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  using L = GradLayout<E>;
  const int n_splits = split_count(n);
  const sm90::EncodingIn<E> in{static_cast<const bf16*>(emb), static_cast<float*>(demb)};
  const int rc = sm90::launch_single_head_bwd<E, L>(
      in, static_cast<const float*>(draw), n, padded_rows(n), n_splits, image, mats, biases,
      scratch, static_cast<float*>(partials), stream);
  if (rc != 0) return rc;
  mlp_reduce_kernel<<<dim3((L::FLOATS + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(partials), n_splits, L::FLOATS, static_cast<float*>(grads));
  return int(cudaGetLastError());
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
