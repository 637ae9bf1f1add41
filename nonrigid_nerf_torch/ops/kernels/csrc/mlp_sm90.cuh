// The chain of the canonical 8 x 256 NeRF MLP on Hopper's own machinery
// (sm_90a), for the forwards mlp_fwd.cu (row 1, at an encoding of E = 64 or
// 128 lanes), mlpv_fwd.cu (row 3), mlpe_fwd.cu (row 5), fused_fwd.cu (row 9)
// and mlp_i8.cu (row 11, int8) and the backwards mlp_bwd.cu (row 2, E = 64
// or 128), mlpv_bwd.cu (row 4), mlpe_bwd.cu (row 6) and fused_bwd.cu (row
// 10). It holds the kernels rows 1, 5 and 9 share (the forward's chain
// kernel, a template on its input; row 9's input runs the deformation field
// beside the chain), those rows 2, 6 and 10 share (the backward's), the
// view-direction image's schedule and the views layer's products (rows 3 and
// 4), the int8 products (row 11), the second pass all four backwards
// launch, and the deformation field's own kernels (bend_fwd.cu and
// bend_bwd.cu, rows 7 and 8, which row 10 runs as its pre-pass and its
// bender backward) on row 9's bender (`bender_rows`).
//
// - Persistent CTAs: about one per SM, each walking 128-point tiles on a
//   static schedule (tile = blockIdx.x + k * gridDim.x), so the same inputs
//   give bit-equal outputs from launch to launch. No atomics anywhere.
// - Three warpgroups: two consumers, each owning 64 rows of the tile for the
//   whole chain, and one producer whose first thread streams the weights.
//   setmaxnreg gives the consumers 232 registers, the producer 40.
// - Products: wgmma.mma_async bf16 x bf16 -> f32, A and B both read from
//   shared memory in the 128-byte-swizzled K-major layout. The forward's
//   layers are m64n256k16 (128 accumulator floats a thread); the backward's
//   transposed steps dh @ W^T are m64n64k16 over 64-column chunks (the
//   view-direction heads add m64n128k16, row 4's also m64n32k16). Row 11
//   runs s8 x s8 -> s32 (m64n256k32, and m64n128k32 for its layer 5).
// - The weight ring: 32 KB stages with a "full" and an "empty" mbarrier each.
//   The producer fills a stage with one 1-D cp.async.bulk of a chunk that the
//   Python wrapper pre-packed into the exact swizzled image wgmma reads
//   (ops/kernels/mlp_sm90.py mirrors the layout and the schedule); consumers
//   wait on "full" and release on "empty" once their products on the stage
//   have completed. No CTA-wide barrier inside the chain: a consumer
//   warpgroup reads and writes only its own 64 rows of the activation tiles,
//   so between layers it takes a named barrier of its 128 threads.
// - Epilogue straight from the wgmma accumulator layout: bias, ReLU, rounding
//   to bf16, stored into the next layer's A tile in the swizzled layout (and
//   to global memory where the backward needs it). Nothing goes through
//   scratch.
// - The next tile's encoding is loaded with cp.async (zero-filled past n) as
//   soon as the current tile has read its own (after layer 5 in the forward,
//   at the last step of the backward's dh chain), so the load overlaps the
//   tile's last products. Row 5 computes its encoding from the points on the
//   producer warpgroup's three idle warps instead, into two encoding tiles
//   in turn, and row 9 the deformation field and the encoding of the bent
//   points there; row 6 on the consumers, when its tile starts.
// - The backward keeps each layer's ReLU gates as bits, moves its bf16
//   scratch (the encoding copy, nh and dh) between the swizzled tiles and
//   global memory with TMA bulk tensor copies in boxes of 64 rows x 64
//   lanes, and runs its dW products on MN-major wgmma (wgmma_m64n256_mn,
//   m64n128 where dh is 128 lanes wide).
//
// Layouts (bytes; mirrored in ops/kernels/mlp_sm90.py and pinned by
// tests/test_torch_mlp_sm90_layout.py):
// - an activation or encoding tile of 128 rows is E/64 (or 4) "k-atoms" of
//   128 rows x 64 lanes; element (row, col) sits at
//     (col / 64) * 16384 + row * 128 + (((col / 8) % 8) ^ (row % 8)) * 16
//     + (col % 8) * 2;
// - a forward chunk (weight rows k0 .. k0 + 63 of W, all 256 columns) is the
//   256 x 64 matrix W[k0 : k0 + 64, :]^T in that layout (one k-atom of 256
//   rows): element (n, k) holds W[k0 + k, n];
// - a backward chunk (W[i0 : i0 + 64, :], the B operand of output columns
//   i0 .. of dh @ W^T) is four k-atoms of 64 rows: element (n, k) holds
//   W[i0 + n, k].
// Every k-atom starts on a 1024-byte boundary, as the swizzle requires.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int TM = 128;            // points per tile
constexpr int NW = 256;            // hidden width
constexpr int KC = 64;             // weight rows per chunk
constexpr int OUT = 8;             // head width (4 lanes used)
constexpr int EMB = 64;            // the Fourier encoding's lanes (63 + 1 zero)
constexpr int VEMB = 32;           // the view encoding's lanes (27 + 5 zero)
constexpr int VW = 128;            // width of the view-conditioned layer
constexpr int N_LAYERS = 8;
constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 tile rows each
constexpr int WG_ROWS = TM / CONSUMERS;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int CHUNK_ELEMS = KC * NW;                  // 16,384 bf16
constexpr uint32_t CHUNK_BYTES = CHUNK_ELEMS * 2;     // 32 KB
constexpr uint32_t ATOM_ROW_BYTES = 128;              // 64 bf16 lanes
constexpr uint32_t SW_GROUP_BYTES = 8 * ATOM_ROW_BYTES;   // the swizzle's 8 rows
constexpr uint32_t TILE_ATOM_BYTES = TM * ATOM_ROW_BYTES; // 16 KB
constexpr uint32_t BWD_ATOM_BYTES = KC * ATOM_ROW_BYTES;  // 8 KB
constexpr size_t ACT_BYTES = 4 * TILE_ATOM_BYTES;         // 128 x 256 bf16
template <int E> constexpr size_t emb_tile_bytes = (E / 64) * TILE_ATOM_BYTES;
constexpr size_t SMEM_LIMIT = 232448;   // what one Hopper CTA can use
constexpr size_t SMEM_ALIGN = 1024;     // slack to align the base for the swizzle
constexpr size_t BAR_BYTES = 128;
constexpr int FWD_STAGES = 3;
constexpr int BWD_STAGES = 3;
constexpr int BAR_WG0 = 1;              // named barrier of consumer warpgroup 0 (+1)

// the chunk schedules: forward E/64 (n0w) + 4*4 + (4 + E/64) + 2*4: 30 at 64
// lanes, 32 at 128; backward (n7w n6w n5e n5h n4w n3w n2w n1w n0w) 4*7 + 2*E/64
template <int E> constexpr int n_fwd_chunks = 2 * (E / KC) + 7 * (NW / KC);
template <int E> constexpr int n_bwd_chunks = 7 * (NW / KC) + 2 * (E / KC);
template <int E> constexpr int n_chain_chunks = n_fwd_chunks<E> + n_bwd_chunks<E>;

// the forward: the activation tile, TILES encoding tiles (2: row 5's double
// buffer, or row 3's emb and embv), a ring of S stages
template <int E, int TILES = 1, int S = FWD_STAGES>
constexpr size_t fwd_smem_bytes = SMEM_ALIGN + ACT_BYTES + TILES * emb_tile_bytes<E> +
                                  S * CHUNK_BYTES + BAR_BYTES;
// two activation tiles (the encoding tile lives in the second until dh8)
constexpr size_t BWD_SMEM_BYTES =
    SMEM_ALIGN + 2 * ACT_BYTES + BWD_STAGES * CHUNK_BYTES + BAR_BYTES;
static_assert(fwd_smem_bytes<64> <= SMEM_LIMIT && fwd_smem_bytes<128> <= SMEM_LIMIT &&
                  fwd_smem_bytes<64, 2> <= SMEM_LIMIT,
              "the forward fits one Hopper CTA at both widths and with two encoding tiles");
static_assert(BWD_SMEM_BYTES <= SMEM_LIMIT, "the backward fits one Hopper CTA");
static_assert(emb_tile_bytes<128> <= ACT_BYTES,
              "the encoding tile fits the second activation tile at both widths");
static_assert(2 * 8 * (FWD_STAGES > BWD_STAGES ? FWD_STAGES : BWD_STAGES) + 5 * 8 <= BAR_BYTES,
              "the ring's barriers fit, and the forward input's (up to five)");

// ---- addresses and layouts

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (row, col) of a swizzled 128-row tile
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return uint32_t(col >> 6) * TILE_ATOM_BYTES + uint32_t(row) * ATOM_ROW_BYTES +
         ((uint32_t((col >> 3) & 7) ^ uint32_t(row & 7)) << 4) + (uint32_t(col & 7) << 1);
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: start
// address, leading offset 1 (unused by this layout), stride 1024 bytes from
// one group of 8 rows to the next, layout type 1 (B128)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(SW_GROUP_BYTES >> 4) << 32) | (uint64_t(1) << 62);
}

// wgmma descriptor of an MN-major operand in the 128-byte swizzle: rows of
// 64 MN lanes (128 bytes) along K, 8-row groups 1024 bytes apart (SBO), the
// next 64 MN lanes `mn_stride` bytes on (LBO)
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t saddr, uint32_t mn_stride) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(mn_stride >> 4) << 16) |
         (uint64_t(SW_GROUP_BYTES >> 4) << 32) | (uint64_t(1) << 62);
}

// ---- synchronisation

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait until the barrier's current phase is not `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// `bytes` contiguous bytes from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's cp.async groups, all but the newest N, have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes to a shared-memory address
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// shared-memory writes of this thread become visible to the async proxy
// (wgmma, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(BAR_WG0 + wg) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators (the
// first N of the array, or all of it) across a wgmma issue or wait
template <int N = 0, int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
  static_assert(N <= R, "the fence covers the array");
#pragma unroll
  for (int i = 0; i < (N ? N : R); ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N = 0, int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
  static_assert(N <= R, "the fence covers the array");
#pragma unroll
  for (int i = 0; i < (N ? N : R); ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- products: d (+)= A (64 x 16, K-major) @ B (16 x N, K-major), scale_d 0
// overwrites d. The narrower products take the first N/2 floats of a larger
// array as well: a kernel whose sections all share one accumulator array
// keeps ptxas from giving each wgmma shape registers of its own.

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int M>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[M], uint64_t da, uint64_t db,
                                             int scale_d) {
  static_assert(M >= 32, "32 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same product with both operands MN-major (trans-a = trans-b = 1):
// the backward's dW = act^T @ dh reads row-major (point-major) tiles of the
// scratch, whose contraction axis (the points) is the slow one
__device__ __forceinline__ void wgmma_m64n256_mn(float (&d)[128], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n128k16, both operands K-major: the view-conditioned layer's 128 columns
template <int M>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[M], uint64_t da, uint64_t db,
                                              int scale_d) {
  static_assert(M >= 64, "64 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n8k16, both operands K-major: row 11's 8-lane head on the tensor cores
__device__ __forceinline__ void wgmma_m64n8(float (&d)[4], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n32k16, both operands K-major: the 32 lanes of the view encoding's gradient
template <int M>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[M], uint64_t da, uint64_t db,
                                             int scale_d) {
  static_assert(M >= 16, "16 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n128k16 with both operands MN-major on the first 64 accumulators of a
// 128-float array: the dW products whose dh is 128 lanes wide
__device__ __forceinline__ void wgmma_m64n128_mn(float (&d)[128], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the bender's backward (row 8, bend_bwd_sm90_kernel): m64n64k16 with A
// K-major and B MN-major (dh @ W^T, B the forward image's K-major rows of
// W^T read transposed), with both MN-major (dW = act^T @ dh from point-major
// tiles), and m64n8k16 with A MN-major (dh^T @ ones: dh's column sums)

template <int M>
__device__ __forceinline__ void wgmma_m64n64_tb(float (&d)[M], uint64_t da, uint64_t db,
                                                int scale_d) {
  static_assert(M >= 32, "32 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int M>
__device__ __forceinline__ void wgmma_m64n64_mn(float (&d)[M], uint64_t da, uint64_t db,
                                                int scale_d) {
  static_assert(M >= 32, "32 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n8_ta(float (&d)[4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- int8 products (mlp_i8.cu, row 11): d (+)= A (64 x 32, s8, K-major) @
// B (32 x N, s8, K-major), exact in s32; scale_d 0 overwrites d. Both
// operands are read from shared memory in the 128-byte swizzle, whose rows
// hold 128 k-values at this width: a 32-byte k-step is one instruction at
// either width, so desc_sw128(a + kk * 32) carries over. s8 operands have no
// transpose, and the integer form takes no scale or transpose immediates.
// A kernel keeps one `int acc[128]` for both shapes: m64n128 takes its
// first 64, so ptxas gives the two shapes the same registers (products on
// the second 64 made it serialize the wgmma pipeline).

__device__ __forceinline__ void wgmma_m64n256_s8(int (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128_s8(int (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the weight ring: stages of CHUNK_BYTES from `ring`; at `bars`, S "full"
// barriers (one producer arrival plus the chunk's bytes), then S "empty"
// barriers (one arrival per consumer warpgroup). Chunk g of a CTA's run
// (counted over all its tiles) takes stage g % S in round g / S.

template <int S>
__device__ __forceinline__ void ring_init(uint32_t bars) {
  for (int s = 0; s < S; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (S + s), CONSUMERS);
  }
  mbar_init_fence();
}

// the producer: every chunk of the schedule for every tile of this CTA.
// Chunk c sits at c * CHUNK_BYTES of the image (bf16, or int8 for row 11)
// and `bytes(c)` of it (a multiple of 16, at most CHUNK_BYTES) are copied:
// the byte count the stage expects is the copy's, or the consumers wait for
// ever.
template <int S, class Bytes>
__device__ __forceinline__ void produce(const void* __restrict__ image, int n_chunks,
                                        int n_tiles, uint32_t ring, uint32_t bars,
                                        Bytes&& bytes) {
  const unsigned char* chunks = static_cast<const unsigned char*>(image);
  uint32_t g = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int c = 0; c < n_chunks; ++c, ++g) {
      const uint32_t s = g % S;
      const uint32_t nb = bytes(c);
      mbar_wait(bars + 8 * (S + s), ((g / S) & 1) ^ 1);   // the stage is free
      mbar_expect_tx(bars + 8 * s, nb);
      bulk_load(ring + s * CHUNK_BYTES, chunks + size_t(c) * CHUNK_BYTES, nb, bars + 8 * s);
    }
  }
}

// ... every chunk whole
template <int S>
__device__ __forceinline__ void produce(const void* __restrict__ image, int n_chunks,
                                        int n_tiles, uint32_t ring, uint32_t bars) {
  produce<S>(image, n_chunks, n_tiles, ring, bars, [](int) { return CHUNK_BYTES; });
}

// a consumer: the stage of chunk g, once it has landed
template <int S>
__device__ __forceinline__ uint32_t ring_acquire(uint32_t ring, uint32_t bars, uint32_t g) {
  const uint32_t s = g % S;
  mbar_wait(bars + 8 * s, (g / S) & 1);
  return ring + s * CHUNK_BYTES;
}

// a consumer warpgroup's products on chunk g's stage have completed
template <int S>
__device__ __forceinline__ void ring_release(uint32_t bars, uint32_t g, bool signal) {
  if (signal) mbar_arrive(bars + 8 * (S + g % S));
}

// ---- tensor maps (TMA): the backward's scratch arrays as 2-D bf16 tensors
// read and written in boxes of 64 rows x 64 lanes in the 128-byte swizzle,
// which is one k-atom of a warpgroup's 64 rows of a tile

constexpr int BOX = 64;
constexpr uint32_t BOX_BYTES = BOX * ATOM_ROW_BYTES;   // 8 KB

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int col,
                                            int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int col,
                                             int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(map), "r"(src), "r"(col), "r"(row)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores, all but the newest N, have read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ... and have completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// one thread of warpgroup wg stores the warpgroup's 64 rows of the first
// `atoms` k-atoms of a tile to rows row .. row + 63 of a tensor map's array
__device__ __forceinline__ void store_rows(const CUtensorMap* map, uint32_t tile, int atoms,
                                           int row, int wg) {
  for (int q = 0; q < atoms; ++q) {
    tma_store_2d(map, tile + q * TILE_ATOM_BYTES + wg * BOX_BYTES, q * BOX, row);
  }
  bulk_commit();
}

// the tensor maps of the backward's scratch: the encoding copy (n_pad, E),
// nh1..nh8 and dh1..dh8 each as (8 * n_pad, 256), layer l at rows
// (l - 1) * n_pad. With view directions (mlpv_bwd.cu) the encoding copy is
// (n_pad, 128), the view encoding in lanes 64 .., nh and dh hold a ninth
// layer (feat, dfeat) at rows 8 * n_pad, and `hv` is hv then dhv, each
// (n_pad, 128); the single-head kernels leave `hv` unset.
struct ScratchMaps {
  CUtensorMap emb;
  CUtensorMap nh;
  CUtensorMap dh;
  CUtensorMap hv;
};

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// a (rows, cols) row-major bf16 array as a tensor map of 64 x 64 boxes in
// the 128-byte swizzle; cuTensorMapEncodeTiled comes from the driver through
// the runtime, so nothing links against libcuda. Returns a CUDA error code.
inline int encode_box_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return int(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return int(cudaErrorNotSupported);
    }
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX, BOX};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// ---- tiles

// the shared-memory base rounded up to the swizzle's 1024 bytes
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((SMEM_ALIGN - (smem_u32(p) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

// cp.async of this warpgroup's 64 rows of a 128-point tile of the (n, E)
// bf16 encoding into the swizzled encoding tile, LANES (>= E) lanes a row;
// rows past n and lanes past E are zero
template <int E, int LANES = E>
__device__ __forceinline__ void load_emb_rows(uint32_t embt, const bf16* __restrict__ emb,
                                              long row0, int n, int wg, int t) {
  constexpr int PIECES = LANES / 8;   // 16-byte pieces per row
  for (int i = t; i < WG_ROWS * PIECES; i += 128) {
    const int r = wg * WG_ROWS + i / PIECES;
    const int q = i % PIECES;
    const bool valid = row0 + r < n && q < E / 8;
    const bf16* src = valid ? emb + size_t(row0 + r) * E + q * 8 : emb;
    cp_async16_zfill(embt + tile_offset(r, q * 8), src, valid);
  }
}

// acc = this warpgroup's 64 rows of one layer's pre-activation sum, from the
// layer's chunks (g onwards): layer 0 reads E/64 chunks of n0w on the
// encoding tile; layer 5 reads 4 chunks of n5h on the activation tile, then
// E/64 of n5e on the encoding tile; the others 4 chunks on the activation
// tile. One chunk's products stay in flight while the next chunk's issue.
template <int S, int E>
__device__ __forceinline__ void layer_products(float (&acc)[128], int layer, uint32_t act,
                                               uint32_t embt, uint32_t ring, uint32_t bars,
                                               uint32_t& g, int wg, bool signal) {
  const int n_chunks = layer == 0 ? E / KC : (layer == 5 ? NW / KC + E / KC : NW / KC);
  const uint32_t rows = uint32_t(wg) * WG_ROWS * ATOM_ROW_BYTES;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c, ++g) {
    const bool skip = layer == 5 && c >= NW / KC;
    const uint32_t a = (layer == 0 || skip ? embt : act) +
                       uint32_t(skip ? c - NW / KC : c) * TILE_ATOM_BYTES + rows;
    const uint32_t b = ring_acquire<S>(ring, bars, g);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      wgmma_m64n256(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32), (c | kk) != 0);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      ring_release<S>(bars, g - 1, signal);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring_release<S>(bars, g - 1, signal);
}

// the layer's epilogue from the accumulator layout (thread t of the
// warpgroup holds rows w*16 + t%32/4 (+8) and columns 8j + 2(t%4) (+1)):
// bf16(relu(acc + bias)) (without RELU: bf16(acc + bias)) into this
// warpgroup's rows of the activation tile, which the layer's products have
// finished reading. With `gate`, the ReLU gates (value > 0) of this thread's
// 128 values as 4 words: word j / 8, bit (j % 8) * 4 + 2h + e for row +8h,
// column +e of group j.
template <bool RELU = true>
__device__ __forceinline__ void layer_epilogue(const float (&acc)[128],
                                               const float* __restrict__ bias,
                                               unsigned char* act, uint32_t* gate, int wg,
                                               int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * j + 2 * h] + b.x;
      const float v1 = acc[4 * j + 2 * h + 1] + b.y;
      const __nv_bfloat162 v = RELU ? __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f))
                                    : __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(act + tile_offset(r0 + 8 * h, col)) = v;
      bits[j / 8] |= (uint32_t(__bfloat162float(v.x) > 0.0f) << ((j % 8) * 4 + 2 * h)) |
                     (uint32_t(__bfloat162float(v.y) > 0.0f) << ((j % 8) * 4 + 2 * h + 1));
    }
  }
  if (gate != nullptr) {
#pragma unroll
    for (int w = 0; w < 4; ++w) gate[w] = bits[w];
  }
}

// nh1 .. nh8 of this warpgroup's rows of the tile (in `acc`), chunks g .. g +
// n_fwd_chunks<E> - 1; the encoding tile must have landed (and a barrier
// passed). `act` ends as nh8, and the warpgroup's barrier has passed.
// With `maps` (the backward) thread 0 stores every layer to the nh scratch
// (rows row0 + wg * 64 .. of layer l at (l - 1) * n_pad) with bulk tensor
// stores, and `gates` receives the ReLU gates (4 words each) of the first NG
// layers: nh1 .. nh7 (NG = 7) or nh1 .. nh8 (8). `after_skip()` runs once
// layer 5 has read the encoding tile.
//   nh1 = bf16(relu(emb @ n0w + n0b));  nh2..nh5, nh7, nh8 alike;
//   nh6 = bf16(relu(nh5 @ n5h + emb @ n5e + n5b))
template <int S, int E, int NG = N_LAYERS - 1, class AfterSkip>
__device__ __forceinline__ void chain_tile(float (&acc)[128], unsigned char* act, uint32_t embt,
                                           const float* const* bias, uint32_t ring,
                                           uint32_t bars, uint32_t& g, int wg, int t,
                                           const ScratchMaps* maps, long n_pad, long row0,
                                           uint32_t (*gates)[4], AfterSkip&& after_skip) {
  const uint32_t act_s = smem_u32(act);
#pragma unroll 1
  for (int layer = 0; layer < N_LAYERS; ++layer) {
    layer_products<S, E>(acc, layer, act_s, embt, ring, bars, g, wg, t == 0);
    if (maps != nullptr) {   // the last layer's store has read the tile
      if (t == 0) bulk_wait_read<0>();
      wg_barrier(wg);
    }
    layer_epilogue(acc, bias[layer], act,
                   gates != nullptr && layer < NG ? gates[layer] : nullptr, wg, t);
    if (layer == 5) after_skip();
    fence_proxy_async();
    wg_barrier(wg);
    if (maps != nullptr && t == 0) {
      store_rows(&maps->nh, act_s, NW / BOX, int(layer * n_pad + row0) + wg * WG_ROWS, wg);
    }
  }
}

// An 8-lane head on the CUDA cores, two threads per point: thread t of
// warpgroup wg takes point wg * 64 + t / 2 and lanes (t % 2) * 4 .. + 4, and
// adds sum_k tile[pt, k] * w[k, o] over the first K lanes of the swizzled
// tile to s, in f32, k ascending. w: (K, 8) bf16.
template <int K>
__device__ __forceinline__ void head_dot(const unsigned char* tile, const bf16* __restrict__ w,
                                         int wg, int t, float (&s)[4]) {
  const int pt = wg * WG_ROWS + t / 2;
  const int o0 = (t % 2) * 4;
#pragma unroll 2
  for (int q = 0; q < K / 8; ++q) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + tile_offset(pt, q * 8));
    const bf16* a = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = __bfloat162float(a[e]);
      const uint2 wv = __ldg(reinterpret_cast<const uint2*>(w + (q * 8 + e) * OUT + o0));
      const bf16* wr = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += x * __bfloat162float(wr[i]);
    }
  }
}

// this thread's 4 lanes of its point's raw row (see head_dot), unless the
// point is past n
__device__ __forceinline__ void store_raw(float* __restrict__ out, const float (&s)[4], long row0,
                                          int n, int wg, int t) {
  const long r = row0 + wg * WG_ROWS + t / 2;
  if (r < n) {
    *reinterpret_cast<float4*>(out + size_t(r) * OUT + (t % 2) * 4) =
        make_float4(s[0], s[1], s[2], s[3]);
  }
}

// raw[p, o] = sum_k nh8[p, k] * ow[k, o] + ob[o] in f32 for this warpgroup's
// rows (head_dot). Rows past n are not stored.
__device__ __forceinline__ void raw_head(const unsigned char* act, const bf16* __restrict__ ow,
                                         const float* __restrict__ ob,
                                         float* __restrict__ out, long row0, int n, int wg,
                                         int t) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  head_dot<NW>(act, ow, wg, t, s);
  const float4 b = __ldg(reinterpret_cast<const float4*>(ob + (t % 2) * 4));
  s[0] += b.x;
  s[1] += b.y;
  s[2] += b.z;
  s[3] += b.w;
  store_raw(out, s, row0, n, wg, t);
}

// ---- the backward's dh chain

// dh8 = bf16((bf16(draw) @ ow^T) * (nh8 > 0)) for this warpgroup's rows into
// `dst`; K = 8, on the CUDA cores, two columns a thread, the draw rows read 8
// at a time. nh8 is the tile `act`. Rows past n have draw = 0.
__device__ __forceinline__ void dh8_rows(const float* __restrict__ draw, long row0, int n,
                                         const bf16* __restrict__ ow,
                                         const unsigned char* act, unsigned char* dst, int wg,
                                         int t) {
  constexpr int BATCH = 8;
  const int col = 2 * t;
  float w0[OUT], w1[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    w0[o] = __bfloat162float(ow[col * OUT + o]);
    w1[o] = __bfloat162float(ow[(col + 1) * OUT + o]);
  }
#pragma unroll 1
  for (int r8 = 0; r8 < WG_ROWS; r8 += BATCH) {
    float4 d[BATCH][2];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const long grow = row0 + wg * WG_ROWS + r8 + i;
      const float4* dr = reinterpret_cast<const float4*>(draw + size_t(grow) * OUT);
      const bool valid = grow < n;
      d[i][0] = valid ? __ldg(dr) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      d[i][1] = valid ? __ldg(dr + 1) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int row = wg * WG_ROWS + r8 + i;
      const float dv[OUT] = {d[i][0].x, d[i][0].y, d[i][0].z, d[i][0].w,
                             d[i][1].x, d[i][1].y, d[i][1].z, d[i][1].w};
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        const float db = __bfloat162float(__float2bfloat16(dv[o]));
        s0 += db * w0[o];
        s1 += db * w1[o];
      }
      const uint32_t off = tile_offset(row, col);
      const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(act + off);
      *reinterpret_cast<__nv_bfloat162*>(dst + off) =
          __floats2bfloat162_rn(__bfloat162float(m.x) > 0.0f ? s0 : 0.0f,
                                __bfloat162float(m.y) > 0.0f ? s1 : 0.0f);
    }
  }
}

// issue this warpgroup's products of cur (128 rows of KA k-atoms of 64 lanes,
// the activation layout) times the chunk of g, which holds W[i0 : i0 + N, :]
// as KA k-atoms of N rows (the B operand of cur @ W^T): N output columns, K =
// 64 * KA, one commit group. The dh chain's steps: KA = 4, N = 64.
template <int S, int KA = NW / KC, int N = KC, int M>
__device__ __forceinline__ void nt_issue(float (&acc)[M], uint32_t cur, uint32_t ring,
                                         uint32_t bars, uint32_t g, int wg) {
  static_assert(N == 64 || N == 32, "a transposed step gives 64 or 32 columns");
  const uint32_t rows = uint32_t(wg) * WG_ROWS * ATOM_ROW_BYTES;
  const uint32_t b = ring_acquire<S>(ring, bars, g);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < KA * KC / 16; ++k) {
    const uint32_t atom = k / 4, kk = k % 4;
    const uint64_t da = desc_sw128(cur + atom * TILE_ATOM_BYTES + rows + kk * 32);
    const uint64_t db = desc_sw128(b + atom * N * ATOM_ROW_BYTES + kk * 32);
    if constexpr (N == 64) {
      wgmma_m64n64(acc, da, db, k != 0);
    } else {
      wgmma_m64n32(acc, da, db, k != 0);
    }
  }
  wgmma_commit();
}

// dh_l's columns c*64 .. +64 for this warpgroup's rows: bf16(acc * gate)
// into `oth`. `gate` is word c of nh_l's gates that this thread's layer
// epilogue kept: the forward's and this chunk's accumulator layouts give a
// thread the same rows and columns (group j of the chunk is group 8c + j).
// A gate of all ones stores bf16(acc). acc: 32 floats (the first of an array).
template <int M>
__device__ __forceinline__ void dh_epilogue(const float (&acc)[M], uint32_t gate, int c,
                                            unsigned char* oth, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const int col = c * KC + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t bit = j * 4 + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(oth + tile_offset(r0 + 8 * h, col)) =
          __floats2bfloat162_rn((gate >> bit) & 1u ? acc[4 * j + 2 * h] : 0.0f,
                                (gate >> (bit + 1)) & 1u ? acc[4 * j + 2 * h + 1] : 0.0f);
    }
  }
}

// N f32 columns col0 .. col0 + N - 1 (no mask, the first N/2 floats of acc)
// of this warpgroup's rows of the tile's block of `out` (rows LD floats
// apart; rows at and past rows_left are left alone): stored, or added to
// what is there
template <int N, int LD, int M>
__device__ __forceinline__ void f32_epilogue(const float (&acc)[M], int col0, float* out,
                                             long rows_left, bool add, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= rows_left) continue;
      float2* dst = reinterpret_cast<float2*>(out + size_t(row) * LD + col);
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (add) {
        const float2 o = *dst;
        v = make_float2(o.x + v.x, o.y + v.y);
      }
      *dst = v;
    }
  }
}

// One step of the dh chain for this warpgroup: the step's N chunks (from g)
// of cur @ W^T into the first 32 floats of acc, each chunk's products then
// its epilogue (the other warpgroup's products overlap it). With `gate`
// (nh_l's 4 words): dh_l into `oth`; else `sink(acc, c)` takes chunk c (64
// columns of demb, f32). (Two accumulators in flight, one chunk's products
// under the other's epilogue, measured slower on the H100: the registers
// they take spill.)
template <int S, int N, int M, class Sink>
__device__ __forceinline__ void dh_step(float (&acc)[M], uint32_t cur, unsigned char* oth,
                                        const uint32_t* gate, uint32_t ring, uint32_t bars,
                                        uint32_t& g, int wg, int t, Sink&& sink) {
#pragma unroll 1
  for (int c = 0; c < N; ++c, ++g) {
    nt_issue<S>(acc, cur, ring, bars, g, wg);
    wgmma_wait<0>();
    fence_acc<32>(acc);
    ring_release<S>(bars, g, t == 0);
    if (gate != nullptr) {
      dh_epilogue(acc, gate[c], c, oth, wg, t);
    } else {
      sink(acc, c);
    }
  }
}

// the layer l whose dh_l a backward step produces (its mask is nh_l), or 0
// for the two products that give demb; steps read n7w n6w n5e n5h n4w n3w
// n2w n1w n0w
__device__ __forceinline__ int bwd_layer(int step) {
  return step == 0 ? 7 : step == 1 ? 6 : step == 2 ? 0 : step == 8 ? 0 : 8 - step;
}

// The dh chain of a tile for this warpgroup, from dh8 in `cur` down: the
// steps n7w n6w n5e n5h n4w n3w n2w n1w n0w, chunks g .. g + n_bwd_chunks<E>
// - 1 of the ring.
//   dh_l = bf16((dh_{l+1} @ W_l^T) * (nh_l > 0))   l = 7 .. 1, into the other
//          tile, then to the dh map's rows (l - 1) * n_pad + wrow
//   demb = dh6 @ n5e^T + dh1 @ n0w^T               (f32, no mask)
// gates[l - 1]: nh_l's gate words. The two products of demb go to
// `sink(acc, c, last)` chunk by chunk (`last`: dh1 @ n0w^T). A step that
// writes a tile first waits until the bulk store that last read it has (it is
// never the newest one: that read the tile the step reads). Seven steps swap
// the tiles, so dh1 ends in the tile that did not hold dh8; before the last
// step, which reads only dh1, `before_last(spare)` gets the tile that held dh8,
// which nothing reads any more. acc: the steps' accumulators (32 floats, the
// first of an array).
template <int S, int E, int M, class Sink, class BeforeLast>
__device__ __forceinline__ void dh_chain(float (&acc)[M], unsigned char* cur,
                                         unsigned char* oth, uint32_t (*gates)[4],
                                         const ScratchMaps* maps, long n_pad, int wrow,
                                         uint32_t ring, uint32_t bars, uint32_t& g, int wg,
                                         int t, Sink&& sink, BeforeLast&& before_last) {
#pragma unroll 1
  for (int step = 0; step < 9; ++step) {
    const int layer = bwd_layer(step);   // 0: a demb product
    if (layer) {
      if (t == 0) bulk_wait_read<1>();
      wg_barrier(wg);
      dh_step<S, NW / KC>(acc, smem_u32(cur), oth, gates[layer - 1], ring, bars, g, wg, t,
                          [](const float (&)[M], int) {});
      fence_proxy_async();
      wg_barrier(wg);
      if (t == 0) {
        store_rows(&maps->dh, smem_u32(oth), NW / BOX, int((layer - 1) * n_pad) + wrow, wg);
      }
      unsigned char* tmp = cur;
      cur = oth;
      oth = tmp;
    } else {
      const bool last = step == 8;
      if (last) {
        if (t == 0) bulk_wait_read<1>();
        wg_barrier(wg);
        before_last(oth);
      }
      dh_step<S, E / KC>(acc, smem_u32(cur), nullptr, nullptr, ring, bars, g, wg, t,
                         [&](const float (&a)[M], int c) { sink(a, c, last); });
    }
  }
}

// the persistent grid: one CTA per SM, or one per tile where there are fewer
// (any grid gives the same result: a CTA walks its tiles on a static schedule)
inline int persistent_grid(int n_tiles) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0 || sms > n_tiles) {
    return n_tiles;
  }
  return sms;
}

// grads[i] = sum over the splits, in ascending order, of partials[s][i]:
// the fixed-order reduction every backward launches last (mlp_tile.cuh
// names it for the canonical MLP's)
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(REDUCE_THREADS)
mlp_reduce_kernel(const float* __restrict__ partials, int n_splits, int grad_floats,
                  float* __restrict__ grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= grad_floats) return;
  float s = 0.0f;
  for (int k = 0; k < n_splits; ++k) s += partials[size_t(k) * grad_floats + i];
  grads[i] = s;
}

// ---- the chain kernels' inputs, a policy each: the encoding (rows 1 and 2),
// or points encoded in the kernel (rows 5 and 6).
//
// The backward's: a consumer calls `first` for its first tile, `begin` when
// a tile starts (the encoding tile must then hold this thread's part of the
// tile's encoding), `next` for the next tile (row0 < 0: none) before the dh
// chain's last step, when the encoding tile is free; `sink` takes demb.
//
// The forward's: FWD_TILES encoding tiles, which the kernel takes in turn
// tile by tile; thread 0 calls `init` with room for four mbarriers; the
// producer warpgroup's threads 32 .. 127 (three warps the weight stream
// leaves idle) call `encode` once, with FwdPlan<In>::EXTRA_BYTES of shared
// memory of the input's own; a consumer calls `first` for its first tile,
// (with FwdPlan<In>::AHEAD) `ahead` for the next tile before it waits for
// its i-th, `wait` when its i-th tile starts (its part of the tile's
// encoding must then be in the tile), `done` once layer 5 has read the tile.
// FwdPlan<In> also holds the ring's depth.

// mlp_fwd.cu's and mlp_bwd.cu's input: the (n, E) bf16 encoding, loaded into
// the encoding tile by cp.async by the threads that read it (the forward's
// next tile once layer 5 has read the tile); the backward's demb (n, E) f32
// goes to global memory as it comes. The backward copies the tile to the
// scratch's encoding rows for the dW products unless STORE_EMB is false:
// fused_bwd.cu's pre-pass writes the encoding there, and `emb` points at it.
template <int E, bool STORE = true>
struct EncodingIn {
  static constexpr int FWD_TILES = 1;
  static constexpr bool STORE_EMB = STORE;
  const bf16* emb;
  float* demb;

  __device__ __forceinline__ void first(uint32_t embt, long row0, int n, int wg, int t) {
    next(embt, row0, n, wg, t);
  }
  __device__ __forceinline__ void init(uint32_t) const {}
  __device__ __forceinline__ void encode(uint32_t, uint32_t, uint32_t, int, int, int) const {}
  __device__ __forceinline__ void wait(uint32_t, int) { cp_async_wait_all(); }
  __device__ __forceinline__ void done(uint32_t embt, uint32_t, int, long next_row0, int n,
                                       int wg, int t) {
    next(embt, next_row0, n, wg, t);
  }
  // the tile's encoding is in `embt` (this thread's part of it)
  __device__ __forceinline__ void begin(unsigned char*, long, int, int, int) {
    cp_async_wait_all();
  }
  // the next tile's encoding (row0 < 0: there is none) into `embt`
  __device__ __forceinline__ void next(uint32_t embt, long row0, int n, int wg, int t) {
    if (row0 >= 0) load_emb_rows<E>(embt, emb, row0, n, wg, t);
    cp_async_commit();
  }
  __device__ __forceinline__ void sink(const float (&acc)[32], int c, bool add, long row0,
                                       int n, int wg, int t) {
    f32_epilogue<KC, E>(acc, c * KC, demb + size_t(row0) * E, long(n) - row0, add, wg, t);
  }
  __device__ __forceinline__ void end(long, int, int, int) {}
};

// lane c of the encoding of the point x, from P's column c and the phase
// (p[0 .. 3]): pre = x0 P0 + x1 P1 + x2 P2 (three f32 FMAs, exact: P's
// entries are 0 or powers of two), lane < 3 ? pre : sinf(pre + phase).
// Rows 5, 7 and 9 and row 10's pre-pass encode with it.
__device__ __forceinline__ float encoding_of(const float (&x)[3], const float (&p)[4], int c) {
  const float pre = fmaf(x[2], p[2], fmaf(x[1], p[1], x[0] * p[0]));
  return c < 3 ? pre : sinf(pre + p[3]);
}

// The in-kernel Fourier encoding of points (n, 3) f32 with the projection P
// (3, 64) and phase (64,) f32, whose entries are 0 or powers of two: lanes
// c0 .. c0 + 7 of row r of the encoding tile, from the row's point x,
//   pre = x0 * P[0] + x1 * P[1] + x2 * P[2]   (three f32 FMAs, exact)
//   emb = bf16(lane < 3 ? pre : sinf(pre + phase)),  zero where !valid
// (past n). The forward (PtsFwdIn) and the backward (PtsIn) share it, so
// the backward recomputes the forward's encoding bit for bit.
// `coef(c, p)` gives P[0 .. 2][c] and phase[c] as p[0 .. 3].
template <class Coef>
__device__ __forceinline__ void encode_piece_with(uint32_t embt, const float (&x)[3], bool valid,
                                                  Coef&& coef, int r, int c0) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + e;
    float p[4];
    coef(c, p);
    const float y = encoding_of(x, p, c);
    v[e] = __float2bfloat16(valid ? y : 0.0f);
  }
  st_shared16(embt + tile_offset(r, c0), *reinterpret_cast<const uint4*>(v));
}

// ... P and phase read from global memory
__device__ __forceinline__ void encode_piece(uint32_t embt, const float (&x)[3], bool valid,
                                             const float* __restrict__ P,
                                             const float* __restrict__ phase, int r, int c0) {
  encode_piece_with(embt, x, valid, [&](int c, float (&p)[4]) {
    p[0] = __ldg(P + c);
    p[1] = __ldg(P + EMB + c);
    p[2] = __ldg(P + 2 * EMB + c);
    p[3] = __ldg(phase + c);
  }, r, c0);
}

// PtsIn's part of a tile: thread t of warpgroup wg encodes row wg * 64 + t /
// 2, lanes (t % 2) * 32 .. + 32, 8 at a time. The loop stays rolled: 32
// inlined sines are more code than the instruction cache holds (see
// PERF.md).
__device__ __forceinline__ void encode_rows(uint32_t embt, const float (&x)[3], bool valid,
                                            const float* __restrict__ P,
                                            const float* __restrict__ phase, int wg, int t) {
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    encode_piece(embt, x, valid, P, phase, wg * WG_ROWS + t / 2, (t % 2) * 32 + q * 8);
  }
}

// point r's coordinates, zero past n
__device__ __forceinline__ void load_point(const float* __restrict__ pts, long r, int n,
                                           float (&x)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = r < n ? __ldg(pts + size_t(r) * 3 + k) : 0.0f;
}

// mlpe_fwd.cu's input: the points, encoded off the consumers' warps. The
// producer warpgroup's three warps that the weight stream leaves idle (96
// threads) encode each tile into one of two encoding tiles, a tile or two
// ahead of the consumers: 1,024 pieces of 8 lanes a tile, each thread every
// 96th piece, loading its row's point itself. Two mbarriers a tile: "full"
// (96 arrivals, after each encoder's fence.proxy.async) and "empty" (one
// arrival per consumer warpgroup once layer 5 has read the tile). With the
// encoding on the consumers' warps, wherever it sat in the chain, row 5 ran
// 11% slower than row 1; this way 3% (PERF.md).
struct PtsFwdIn {
  static constexpr int FWD_TILES = 2;
  static constexpr int ENCODERS = 96;
  static constexpr int PIECES = TM * EMB / 8;   // 16-byte pieces of a tile
  const float* pts;
  const float* P;
  const float* phase;

  // bars: full[0], full[1], empty[0], empty[1]
  __device__ __forceinline__ void init(uint32_t bars) const {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars + 8 * b, ENCODERS);
      mbar_init(bars + 8 * (2 + b), CONSUMERS);
    }
    mbar_init_fence();
  }
  // encoder e (0 .. 95): its pieces of every tile of this CTA; the i-th tile
  // goes to tile i % 2 once the consumers are done with what it held
  __device__ __forceinline__ void encode(uint32_t emb0, uint32_t bars, uint32_t, int n,
                                         int n_tiles, int e) const {
    int i = 0;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int b = i % 2;
      const uint32_t embt = emb0 + uint32_t(b) * TILE_ATOM_BYTES;
      mbar_wait(bars + 8 * (2 + b), ((i / 2) & 1) ^ 1);
#pragma unroll 1
      for (int q = e; q < PIECES; q += ENCODERS) {
        const int r = q / (EMB / 8);
        const long row = long(tile) * TM + r;
        float x[3];
        load_point(pts, row, n, x);
        encode_piece(embt, x, row < n, P, phase, r, (q % (EMB / 8)) * 8);
      }
      fence_proxy_async();
      mbar_arrive(bars + 8 * b);
    }
  }
  __device__ __forceinline__ void first(uint32_t, long, int, int, int) {}
  __device__ __forceinline__ void wait(uint32_t bars, int i) {
    mbar_wait(bars + 8 * (i % 2), (i / 2) & 1);
  }
  __device__ __forceinline__ void done(uint32_t, uint32_t bars, int i, long, int, int, int t) {
    if (t == 0) mbar_arrive(bars + 8 * (2 + i % 2));
  }
};

// mlpe_bwd.cu's input: the points, encoded (encode_rows) at the start of
// their tile from the point loaded into registers one tile ahead. demb
// never reaches HBM: each value of the two products the dh chain hands over
// (in the accumulator layout) is folded onto its point,
//   dpts[:, d] += (lane < 3 ? demb : demb * cosf(pre + phase)) * P[d],
// summed by the thread per row and coordinate, the two products one after
// the other (the fold is linear), then over the four threads that share a
// row by a fixed-order shuffle: bit-equal from run to run.
struct PtsIn {
  static constexpr bool STORE_EMB = true;
  const float* pts;
  const float* P;
  const float* phase;
  float* dpts;
  float x[3];      // the point of the row this thread encodes
  float d[2][3];   // the sums of this thread's two rows of the accumulator layout

  __device__ __forceinline__ void first(uint32_t embt, long row0, int n, int wg, int t) {
    next(embt, row0, n, wg, t);
  }
  __device__ __forceinline__ void begin(unsigned char* embt, long row0, int n, int wg, int t) {
    encode_rows(smem_u32(embt), x, row0 + wg * WG_ROWS + t / 2 < n, P, phase, wg, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) d[h][0] = d[h][1] = d[h][2] = 0.0f;
  }
  __device__ __forceinline__ void next(uint32_t, long row0, int n, int wg, int t) {
    if (row0 < 0) return;
    load_point(pts, row0 + wg * WG_ROWS + t / 2, n, x);
  }
  __device__ __forceinline__ void sink(const float (&acc)[32], int c, bool, long row0, int n,
                                       int wg, int t) {
    const int lane = t % 32;
    const long r0 = row0 + wg * WG_ROWS + (t / 32) * 16 + lane / 4;
    float xr[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xr[h][k] = r0 + 8 * h < n ? __ldg(pts + size_t(r0 + 8 * h) * 3 + k) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * KC + j * 8 + (lane % 4) * 2 + e;
        const float p0 = __ldg(P + col), p1 = __ldg(P + EMB + col);
        const float p2 = __ldg(P + 2 * EMB + col), ph = __ldg(phase + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = acc[4 * j + 2 * h + e];
          if (col >= 3) {
            const float pre = fmaf(xr[h][2], p2, fmaf(xr[h][1], p1, xr[h][0] * p0));
            v *= cosf(pre + ph);
          }
          d[h][0] = fmaf(v, p0, d[h][0]);
          d[h][1] = fmaf(v, p1, d[h][1]);
          d[h][2] = fmaf(v, p2, d[h][2]);
        }
      }
    }
  }
  __device__ __forceinline__ void end(long row0, int n, int wg, int t) {
    const int lane = t % 32;
    const long r0 = row0 + wg * WG_ROWS + (t / 32) * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float s = d[h][k];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        d[h][k] = s;
      }
      if (lane % 4 == 0 && r0 + 8 * h < n) {
        float* dst = dpts + size_t(r0 + 8 * h) * 3;
        dst[0] = d[h][0];
        dst[1] = d[h][1];
        dst[2] = d[h][2];
      }
    }
  }
};

// ---- row 9's input (fused_fwd.cu): the deformation field and the encoding of
// the bent points, split between the consumers and the producer's idle warps.
//
// The arithmetic is fused_query.py's `_bend_fwd_math`, in one device
// function with rows 7 and 8 (`bender_rows`, below), so the encoding is
// bit-equal to the one bend_fwd.cu writes and mlp_fwd.cu reads, and this
// kernel equals the split variant bit for bit:
// - each consumer warpgroup runs the products of its 64 rows of the NEXT
//   tile (`ahead`, before it waits for this tile's encoding) on wgmma: rh1 =
//   relu(rh0 @ r1w + r1b) (m64n32k16), bh0 = relu((pts @ b0p + lat @ b0l) +
//   b0b) (m64n64k16, pts @ b0p on the CUDA cores in the epilogue), bh1 ..
//   bh3 (m64n64k16 over the bh tile, in place); f32 sums over ascending
//   k-steps of 16 (`bender_rows`). Its A
//   tiles (bf16 lat, rh0, rh1, bh) live in its own rows of the activation
//   tile, free between the last tile's head and this tile's first layer;
//   bh3 goes into its rows of the next tile's encoding tile, and the
//   rigidity (tanh of the sequential sum rh1 @ row, its thread a row) to a
//   row of shared memory and to rig (n, 1). Then one arrival a warpgroup on
//   the tile's "ready" mbarrier;
// - the producer warpgroup's three idle warps, once a tile is ready: off =
//   bh3 @ bow (each (row, lane) a sequential f32 sum over the 64 lanes),
//   bent = x + rig0 * off (rounded twice) into shared memory and off to (n,
//   3); then the encoding of the bent points (`encode_piece_with` on
//   `encoding_of`, as row 7 writes it) over bh3,
//   and one arrival each on the tile's "full" mbarrier (row 5's handshake).
// Every weight, bias and P and the phase are staged once per CTA, by all
// its threads before the roles split, from the 18 weights into shared
// memory (`stage_bend_image`: pack_bend_image's 34,064 B), as rows 7, 8 and
// 10 stage them; the 32- and 64-lane matrices
// as the K-major B operands wgmma reads (128-byte swizzle at 64 lanes,
// 64-byte at 32). The kernel runs a 2-stage ring, which leaves room for the
// image beside the chain.
// The consumers' chain is row 1's. No "empty" barrier is needed: a consumer
// warpgroup writes a tile's bh3 into its own rows of an encoding tile only
// after it has waited for that tile's encoding two tiles back, so the
// encoders and its own products are done with it.

constexpr int BEND_W = 64;        // the bending network's hidden width
constexpr int RIG_W = 32;         // the rigidity network's hidden width
constexpr int LAT_W = 32;         // the latent's lanes
constexpr int FUSED_STAGES = 2;   // row 9's weight ring
constexpr int BAR_ENCODERS = BAR_WG0 + CONSUMERS;   // named barrier of the 96 encoders
// the bender's image (bytes): W^T of b0l (64 x 32 lanes), b1w, b2w, b3w (64 x
// 64) and r1w (32 x 32), each as K-major rows (row n holds column n of W) in
// wgmma's swizzle; then bf16 bow^T's rows 0 .. 2 (64 lanes each), row's lane
// 0 (32), b0p's rows 0 .. 2 (64 each) and r0w's rows 0 .. 2 (32 each); then
// f32 b0b .. b3b (64 each), r0b, r1b (32 each), rob's lane 0 (padded to 16
// bytes), P's rows 0 .. 2 and the phase (64 each)
constexpr uint32_t BIMG_B0L = 0;
constexpr uint32_t BIMG_BW = BIMG_B0L + BEND_W * LAT_W * 2;
constexpr uint32_t BIMG_R1W = BIMG_BW + 3 * BEND_W * BEND_W * 2;
constexpr uint32_t BIMG_BOWT = BIMG_R1W + RIG_W * RIG_W * 2;
constexpr uint32_t BIMG_ROWT = BIMG_BOWT + 3 * BEND_W * 2;
constexpr uint32_t BIMG_B0P = BIMG_ROWT + RIG_W * 2;
constexpr uint32_t BIMG_R0W = BIMG_B0P + 3 * BEND_W * 2;
constexpr uint32_t BIMG_BB = BIMG_R0W + 3 * RIG_W * 2;
constexpr uint32_t BIMG_R0B = BIMG_BB + 4 * BEND_W * 4;
constexpr uint32_t BIMG_R1B = BIMG_R0B + RIG_W * 4;
constexpr uint32_t BIMG_ROB = BIMG_R1B + RIG_W * 4;
constexpr uint32_t BIMG_P = BIMG_ROB + 16;
constexpr uint32_t BIMG_PHASE = BIMG_P + 3 * EMB * 4;
constexpr uint32_t BEND_IMAGE_BYTES = BIMG_PHASE + EMB * 4;
static_assert(BEND_IMAGE_BYTES == 34064 && BIMG_BW % 1024 == 0 && BIMG_R1W % 512 == 0 &&
                  BIMG_BOWT % 16 == 0 && BIMG_ROWT % 16 == 0 && BIMG_B0P % 16 == 0 &&
                  BIMG_R0W % 16 == 0 && BIMG_BB % 16 == 0 && BIMG_P % 16 == 0,
              "the bender's image: the swizzled matrices on their atoms' alignment");
// after the image: rig0 of two tiles (128 f32 each), the bent points of two
// tiles (128 x 4 f32 each)
constexpr uint32_t FUSED_RIG_BYTES = 2 * TM * 4;
constexpr uint32_t FUSED_BENT_BYTES = 2 * TM * 4 * 4;
constexpr uint32_t FUSED_EXTRA_BYTES = BEND_IMAGE_BYTES + FUSED_RIG_BYTES + FUSED_BENT_BYTES;
static_assert(fwd_smem_bytes<EMB, 2, FUSED_STAGES> + FUSED_EXTRA_BYTES <= SMEM_LIMIT,
              "row 9 fits one Hopper CTA: the chain on a 2-stage ring, two encoding "
              "tiles, the bender's image and its rows");
// a consumer warpgroup's bender tiles in its own rows of the activation
// tile (its 8 KB of each 16 KB k-atom): bf16 lat and rh0 (64 rows x 32
// lanes, 64-byte swizzle) in atom 0, rh1 (64 x 32, row-major) in atom 1,
// the bh tile (64 x 64, 128-byte swizzle) in atom 2
constexpr uint32_t WG_ATOM_BYTES = WG_ROWS * ATOM_ROW_BYTES;   // 8 KB

__device__ __forceinline__ uint32_t ld_shared32(uint32_t src) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(src) : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t src) {
  return __uint_as_float(ld_shared32(src));
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f32(uint32_t dst, float v) {
  st_shared32(dst, __float_as_uint(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the low (the lower lane) and high bf16 of a packed pair, exactly
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void encoders_barrier() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_ENCODERS), "n"(96) : "memory");
}

// wgmma descriptor of a K-major operand of 32 lanes (64-byte rows) in the
// 64-byte swizzle: 8-row groups 512 bytes apart, layout type 2 (B64)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t((8 * 64) >> 4) << 32) | (uint64_t(2) << 62);
}

// byte offset of (row, lane) in a 64-byte-swizzled tile of 32 lanes: pieces
// of 8 lanes XORed with (row / 2) % 4
__device__ __forceinline__ uint32_t sw64_offset(int row, int col) {
  return uint32_t(row) * 64 + ((uint32_t((col >> 3) ^ ((row >> 1) & 3))) << 4) +
         (uint32_t(col & 7) << 1);
}

// sum over k ascending of act[r][k] * wt[k], k < K, in f32 from 0: row r of a
// 128-byte-swizzled tile (bf16), wt K bf16 in shared memory; exact products
template <int K>
__device__ __forceinline__ float row_dot(uint32_t tile, int r, uint32_t wt) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < K / 8; ++c) {
    const uint4 av = ld_shared16(tile + tile_offset(r, c * 8));
    const uint4 wv = ld_shared16(wt + c * 16);
    const uint32_t ap[4] = {av.x, av.y, av.z, av.w};
    const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s += bf16_lo(ap[e]) * bf16_lo(wp[e]);
      s += bf16_hi(ap[e]) * bf16_hi(wp[e]);
    }
  }
  return s;
}

// The epilogue of a bender layer on a consumer warpgroup: N columns of the
// wgmma accumulators (acc[4 j + 2 h + e]: row w * 16 + l / 4 + 8 h, column
// 8 j + 2 (l % 4) + e of its 64 rows), bf16(relu((pre(h, col) + acc) +
// bias)), each pair of columns to `store(h, col, packed)`
template <int N, int M, class Pre, class Store>
__device__ __forceinline__ void bend_epilogue(const float (&acc)[M], uint32_t bias, int t,
                                              Pre&& pre, Store&& store) {
  const int q = t % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + 2 * q;
    const float b0 = ld_shared_f32(bias + 4 * col), b1 = ld_shared_f32(bias + 4 * col + 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = fmaxf(__fadd_rn(__fadd_rn(pre(h, col), acc[4 * j + 2 * h]), b0), 0.0f);
      const float v1 =
          fmaxf(__fadd_rn(__fadd_rn(pre(h, col + 1), acc[4 * j + 2 * h + 1]), b1), 0.0f);
      store(h, col, pack_bf16(v0, v1));
    }
  }
}

// bar.sync of the 128 threads of named barrier `id` (a warpgroup)
__device__ __forceinline__ void bar_sync128(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// float32(pi / 2): the phase of the encoding's cosine lanes (the image's)
constexpr float HALF_PI = 1.57079632679489661923f;

// P's column c and the phase of lane c from a staged bender image
__device__ __forceinline__ void image_encoding_coef(uint32_t img, int c, float (&p)[4]) {
  p[0] = ld_shared_f32(img + BIMG_P + 4 * c);
  p[1] = ld_shared_f32(img + BIMG_P + 4 * (EMB + c));
  p[2] = ld_shared_f32(img + BIMG_P + 4 * (2 * EMB + c));
  p[3] = ld_shared_f32(img + BIMG_PHASE + 4 * c);
}

// Where `bender_rows` reads a warpgroup's 64 rows of points (3 f32 a row)
// and latents (32 f32 a row, 16-byte aligned), zero past n: `valid(r)`,
// `pt(r, k)`, `lat4(r, c)` (lanes c .. c + 3). Rows 8 and 9 read global
// memory from row0 through the read-only path; row 7 a tile anywhere (its
// ring's stage in shared memory, or a ragged tile in global memory), with
// generic loads and `rows` valid rows.
struct GlobalBendRows {
  const float* pts;
  const float* lat;
  long row0;
  int n;
  __device__ __forceinline__ bool valid(int r) const { return row0 + r < n; }
  __device__ __forceinline__ float pt(int r, int k) const {
    return __ldg(pts + size_t(row0 + r) * 3 + k);
  }
  __device__ __forceinline__ float4 lat4(int r, int c) const {
    return __ldg(reinterpret_cast<const float4*>(lat + size_t(row0 + r) * LAT_W + c));
  }
};

struct TileBendRows {
  const float* pts;
  const float* lat;
  int rows;
  __device__ __forceinline__ bool valid(int r) const { return r < rows; }
  __device__ __forceinline__ float pt(int r, int k) const { return pts[r * 3 + k]; }
  __device__ __forceinline__ float4 lat4(int r, int c) const {
    return *reinterpret_cast<const float4*>(lat + r * LAT_W + c);
  }
};

// Where a caller keeps a warpgroup's bender tiles of 64 rows, as byte
// offsets from the base it passes (bf16 lat there, 64 x 32, 64-byte
// swizzle): rh0 (the same), rh1 (64 x 32, row-major), bh_l (64 x 64,
// 128-byte swizzle, 1024-byte aligned) at BH + l * BH_STEP for l < 3
// (BH_STEP 0: each layer over its input), bh3 at an address of its own.
// Constant offsets keep the tiles' addresses out of the registers.
template <uint32_t RH0, uint32_t RH1, uint32_t BH, uint32_t BH_STEP>
struct BendLayout {
  static constexpr uint32_t rh0 = RH0, rh1 = RH1, bh = BH, bh_step = BH_STEP;
};

// The deformation field's products for a warpgroup's 64 rows (its tiles at
// `base` as the layout L places them), from the staged bender image `img` (row 9's `FusedFwdIn`, row 7's and row 10's
// pre-pass `bend_fwd_sm90_kernel`, row 8's recompute `bend_bwd_sm90_kernel`;
// one device function, so their bent points agree bit for bit):
//   rh0 = bf16(relu(bf16(pts) @ r0w + r0b))   (sequential f32 sums, CUDA cores)
//   rh1 = bf16(relu(rh0 @ r1w + r1b))          (m64n32k16 x 2)
//   bh0 = bf16(relu((pts @ b0p + lat @ b0l) + b0b))   (m64n64k16 x 2; pts @ b0p
//                                              in the epilogue, sequential)
//   bh_l = bf16(relu(bh_{l-1} @ b_lw + b_lb))  l = 1 .. 3 (m64n64k16 x 4)
//   t = tanh(rh1 @ row + rob) (sequential), rig0 = (t + 1) * 0.5
// f32 sums over ascending k-steps of 16. `rig(r, t, rig0)` takes row r's
// rigidity (even threads, row t / 2); `after_inputs()` runs once every
// thread has read `src` (a staged tile may then be refilled). Starts with a
// barrier of the warpgroup (`bar`: the tiles' last readers are done) and
// ends with one (bh3 is written). acc: the caller's accumulators (the
// products use the first 32).
template <class L, class Src, int R, class Rig, class AfterInputs>
__device__ __forceinline__ void bender_rows(float (&acc)[R], uint32_t img, const Src& src,
                                            uint32_t base, uint32_t bh3, int bar, int t,
                                            Rig&& rig, AfterInputs&& after_inputs) {
  const uint32_t lat_t = base, rh0_t = base + L::rh0, rh1_t = base + L::rh1;
  const int lane = t % 32;
  const int rw = (t / 32) * 16 + lane / 4;   // the accumulators' first row (of 64)

  bar_sync128(bar);
  // ---- the A tiles: thread t takes row t / 2, lanes (t % 2) * 16 .. + 15 of
  // bf16(lat) and of rh0 = relu(bf16(pts) @ r0w + r0b)
  {
    const int r = t / 2, c0 = (t % 2) * 16;
    const bool valid = src.valid(r);
    float xb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) xb[k] = round_bf16(valid ? src.pt(r, k) : 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 8 * h;
      float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0;
      if (valid) {
        v0 = src.lat4(r, c);
        v1 = src.lat4(r, c + 4);
      }
      st_shared16(lat_t + sw64_offset(r, c),
                  make_uint4(pack_bf16(v0.x, v0.y), pack_bf16(v0.z, v0.w),
                             pack_bf16(v1.x, v1.y), pack_bf16(v1.z, v1.w)));
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s[2] = {0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const uint32_t wv = ld_shared32(img + BIMG_R0W + 2 * (k * RIG_W + c + 2 * e));
          s[0] += xb[k] * bf16_lo(wv);
          s[1] += xb[k] * bf16_hi(wv);
        }
        w[e] = pack_bf16(
            fmaxf(__fadd_rn(s[0], ld_shared_f32(img + BIMG_R0B + 4 * (c + 2 * e))), 0.0f),
            fmaxf(__fadd_rn(s[1], ld_shared_f32(img + BIMG_R0B + 4 * (c + 2 * e + 1))), 0.0f));
      }
      st_shared16(rh0_t + sw64_offset(r, c), make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
  // bf16(pts) of the accumulators' two rows, for bh0's pts @ b0p
  float xa[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) xa[h][k] = round_bf16(src.valid(r) ? src.pt(r, k) : 0.0f);
  }
  fence_proxy_async();
  bar_sync128(bar);
  after_inputs();

  // ---- rh1 = relu(rh0 @ r1w + r1b) (m64n32k16 x 2) into rh1
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < RIG_W / 16; ++kk) {
    wgmma_m64n32(acc, desc_sw64(rh0_t + kk * 32), desc_sw64(img + BIMG_R1W + kk * 32),
                 kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<16>(acc);
  bend_epilogue<RIG_W>(acc, img + BIMG_R1B, t, [](int, int) { return 0.0f; },
                       [&](int h, int col, uint32_t v) {
                         st_shared32(rh1_t + uint32_t(rw + 8 * h) * (RIG_W * 2) + col * 2, v);
                       });
  // ---- bh0 = relu((pts @ b0p + lat @ b0l) + b0b) (m64n64k16 x 2) into bh[0]
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < LAT_W / 16; ++kk) {
    wgmma_m64n64(acc, desc_sw64(lat_t + kk * 32), desc_sw64(img + BIMG_B0L + kk * 32),
                 kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<32>(acc);
  bend_epilogue<BEND_W>(acc, img + BIMG_BB, t,
                        [&](int h, int col) {
                          const uint32_t pair = img + BIMG_B0P + 2 * (col & ~1);
                          float s = 0.0f;
#pragma unroll
                          for (int k = 0; k < 3; ++k) {
                            const uint32_t wv = ld_shared32(pair + 2 * k * BEND_W);
                            s += xa[h][k] * (col & 1 ? bf16_hi(wv) : bf16_lo(wv));
                          }
                          return s;
                        },
                        [&](int h, int col, uint32_t v) {
                          st_shared32(base + L::bh + tile_offset(rw + 8 * h, col), v);
                        });
  fence_proxy_async();
  bar_sync128(bar);   // bh0 and rh1 are written

  // ---- the rigidity of row t / 2 (even threads): tanh(rh1 @ row + rob),
  // a sequential sum, then (t + 1) * 0.5
  if (t % 2 == 0) {
    const int r = t / 2;
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < RIG_W / 8; ++c) {
      const uint4 av = ld_shared16(rh1_t + uint32_t(r) * (RIG_W * 2) + c * 16);
      const uint4 wv = ld_shared16(img + BIMG_ROWT + c * 16);
      const uint32_t ap[4] = {av.x, av.y, av.z, av.w};
      const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s += bf16_lo(ap[e]) * bf16_lo(wp[e]);
        s += bf16_hi(ap[e]) * bf16_hi(wp[e]);
      }
    }
    const float th = tanhf(__fadd_rn(s, ld_shared_f32(img + BIMG_ROB)));
    rig(r, th, __fmul_rn(__fadd_rn(th, 1.0f), 0.5f));
  }

  // ---- bh1 .. bh3 (m64n64k16 x 4 each), bh_l from bh_{l-1}
#pragma unroll 1
  for (int l = 1; l < 4; ++l) {
    const uint32_t a = base + L::bh + uint32_t(l - 1) * L::bh_step;
    const uint32_t dst = l < 3 ? base + L::bh + uint32_t(l) * L::bh_step : bh3;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BEND_W / 16; ++kk) {
      wgmma_m64n64(acc, desc_sw128(a + kk * 32),
                   desc_sw128(img + BIMG_BW + uint32_t(l - 1) * BEND_W * BEND_W * 2 + kk * 32),
                   kk != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<32>(acc);
    bend_epilogue<BEND_W>(acc, img + BIMG_BB + uint32_t(l) * BEND_W * 4, t,
                          [](int, int) { return 0.0f; },
                          [&](int h, int col, uint32_t v) {
                            st_shared32(dst + tile_offset(rw + 8 * h, col), v);
                          });
    fence_proxy_async();
    bar_sync128(bar);
  }
}

constexpr uint32_t BEND_IMAGE_PAD = 34816;   // the forward image, rounded up to 1024 bytes
static_assert(BEND_IMAGE_PAD >= BEND_IMAGE_BYTES && BEND_IMAGE_PAD % 1024 == 0,
              "what follows the image starts on the swizzle's 1024 bytes");
// The 18 cast bender weights as the wrappers pass them (pack order: b0p b0l
// b0b b1w b1b b2w b2b b3w b3b bow r0w r0b r1w r1b row rob P phase; the
// matrices bf16, the rest f32, contiguous in their packed shapes)
struct BendWeights {
  const void* w[18];
};

__device__ __forceinline__ void st_shared_u16(uint32_t dst, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
}

// byte offset of (n, k) in a K-major image matrix of `lanes` (32 or 64)
// k-values a row (mlp_sm90.py's kmajor_offset)
__device__ __forceinline__ uint32_t kmajor_byte(int n, int k, int lanes) {
  const int sw = lanes == 64 ? (n & 7) : ((n >> 1) & 3);
  return uint32_t(n * lanes + (((k >> 3) ^ sw) << 3) + (k & 7)) * 2;
}

// One region of the staged image: thread tid of nthreads takes elements
// tid, tid + nthreads, ... of `count`, the 16-bit value src(e) to the shared
// address dst(e). Four loads go out before their stores (the stores are
// volatile, so one at a time each would wait out a load's latency).
template <class Src, class Dst>
__device__ __forceinline__ void stage_region(int count, int tid, int nthreads, Src&& src,
                                             Dst&& dst) {
  constexpr int U = 4;
  for (int e0 = tid; e0 < count; e0 += U * nthreads) {
    unsigned short v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nthreads;
      v[u] = e < count ? src(e) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nthreads;
      if (e < count) st_shared_u16(dst(e), v[u]);
    }
  }
}

// Rows 7-10 stage the bender's image (pack_bend_image's bytes, with
// `backward` b0l's rows after it at BEND_IMAGE_PAD: mlp_sm90.py's
// bend_b0l_rows) into shared memory at `img` straight from the weights: no
// call packs an image. The CTA's nthreads threads share the work; the
// caller fences and synchronizes.
__device__ __forceinline__ void stage_bend_image(uint32_t img, const BendWeights& bw,
                                                 bool backward, int tid, int nthreads) {
  auto h = [&](int i, int e) {   // bf16 element e (or f32 half e) of weight i
    return __ldg(static_cast<const unsigned short*>(bw.w[i]) + e);
  };
  // b0l (32 x 64), b1w .. b3w (64 x 64), r1w (32 x 32): element (n, k) holds W[k][n]
  stage_region(
      LAT_W * BEND_W, tid, nthreads, [&](int e) { return h(1, e); },
      [&](int e) { return img + BIMG_B0L + kmajor_byte(e % BEND_W, e / BEND_W, LAT_W); });
  stage_region(
      3 * BEND_W * BEND_W, tid, nthreads,
      [&](int e) { return h(3 + 2 * (e / (BEND_W * BEND_W)), e % (BEND_W * BEND_W)); },
      [&](int e) {
        const int l = e / (BEND_W * BEND_W), k = (e / BEND_W) % BEND_W, n = e % BEND_W;
        return img + BIMG_BW + l * BEND_W * BEND_W * 2 + kmajor_byte(n, k, BEND_W);
      });
  stage_region(
      RIG_W * RIG_W, tid, nthreads, [&](int e) { return h(12, e); },
      [&](int e) { return img + BIMG_R1W + kmajor_byte(e % RIG_W, e / RIG_W, RIG_W); });
  // the 3-lane rows: bow^T (3 x 64), row's lane 0 (32), b0p's and r0w's rows 0 .. 2
  stage_region(
      3 * BEND_W, tid, nthreads, [&](int e) { return h(9, (e % BEND_W) * 8 + e / BEND_W); },
      [&](int e) { return img + BIMG_BOWT + 2 * e; });
  stage_region(
      RIG_W, tid, nthreads, [&](int e) { return h(14, e * 8); },
      [&](int e) { return img + BIMG_ROWT + 2 * e; });
  stage_region(
      3 * BEND_W, tid, nthreads, [&](int e) { return h(0, e); },
      [&](int e) { return img + BIMG_B0P + 2 * e; });
  stage_region(
      3 * RIG_W, tid, nthreads, [&](int e) { return h(10, e); },
      [&](int e) { return img + BIMG_R0W + 2 * e; });
  // the f32 part, a half at a time: b0b .. b3b, r0b, r1b, rob's lane 0 (then
  // zeros), P's rows 0 .. 2, the phase
  stage_region(
      2 * (4 * BEND_W + 2 * RIG_W + 4 + 4 * EMB), tid, nthreads,
      [&](int e) -> unsigned short {
        const int f = e / 2, half = e % 2;
        if (f < 4 * BEND_W) return h(2 + 2 * (f / BEND_W), 2 * (f % BEND_W) + half);
        if (f < 4 * BEND_W + 2 * RIG_W) {
          const int g = f - 4 * BEND_W;
          return h(11 + 2 * (g / RIG_W), 2 * (g % RIG_W) + half);
        }
        if (f < 4 * BEND_W + 2 * RIG_W + 4) return f == 4 * BEND_W + 2 * RIG_W ? h(15, half) : 0;
        if (f < 4 * BEND_W + 2 * RIG_W + 4 + 3 * EMB) {
          return h(16, 2 * (f - 4 * BEND_W - 2 * RIG_W - 4) + half);
        }
        return h(17, 2 * (f - 4 * BEND_W - 2 * RIG_W - 4 - 3 * EMB) + half);
      },
      [&](int e) { return img + BIMG_BB + 2 * e; });
  if (backward) {   // b0l's rows: element (i, o) holds b0l[i][o]
    stage_region(
        LAT_W * BEND_W, tid, nthreads, [&](int e) { return h(1, e); },
        [&](int e) { return img + BEND_IMAGE_PAD + kmajor_byte(e / BEND_W, e % BEND_W, BEND_W); });
  }
}

struct FusedFwdIn {
  static constexpr int FWD_TILES = 2;
  static constexpr int ENCODERS = 96;
  static constexpr int PIECES = TM * EMB / 8;   // 16-byte pieces of a tile
  const float* pts;      // (n, 3)
  const float* lat;      // (n, 32), 16-byte aligned
  BendWeights bw;        // the 18 cast bender weights
  float* off;            // (n, 3) out
  float* rig;            // (n, 1) out

  // every thread of the CTA, before the roles split: the bender's image
  // into `extra`, once per CTA
  __device__ __forceinline__ void stage(uint32_t extra, int tid, int nthreads) const {
    stage_bend_image(extra, bw, false, tid, nthreads);
  }

  // shared memory after the image (the kernel's `in_smem`)
  static __device__ __forceinline__ uint32_t rig_row(uint32_t extra, int slot, int r) {
    return extra + BEND_IMAGE_BYTES + uint32_t(slot * TM + r) * 4;
  }
  static __device__ __forceinline__ uint32_t bent_row(uint32_t extra, int slot, int r) {
    return extra + BEND_IMAGE_BYTES + FUSED_RIG_BYTES + uint32_t(slot * TM + r) * 16;
  }

  // bars: full[0], full[1] (the encoders), ready[0], ready[1] (the
  // consumers)
  __device__ __forceinline__ void init(uint32_t bars) const {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars + 8 * b, ENCODERS);
      mbar_init(bars + 8 * (2 + b), CONSUMERS);
    }
    mbar_init_fence();
  }

  // encoder e (0 .. 95): for the i-th tile of this CTA, once it is ready
  // (the image is in `extra`): the offsets and bent points of
  // (row, lane) pairs e, e + 96, ... of the 384, a barrier of the encoders,
  // then pieces e, e + 96, ... of the tile's 1,024 encoding pieces
  __device__ __forceinline__ void encode(uint32_t emb0, uint32_t bars, uint32_t extra, int n,
                                         int n_tiles, int e) const {
    int i = 0;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int b = i % 2;
      const uint32_t embt = emb0 + uint32_t(b) * TILE_ATOM_BYTES;   // bh3, then the encoding
      const long row0 = long(tile) * TM;
      mbar_wait(bars + 8 * (2 + b), (i / 2) & 1);
#pragma unroll 1
      for (int p = e; p < TM * 3; p += ENCODERS) {
        const int r = p / 3, j = p % 3;
        const float o = row_dot<BEND_W>(embt, r, extra + BIMG_BOWT + j * BEND_W * 2);
        const bool valid = row0 + r < n;
        const float x = valid ? __ldg(pts + size_t(row0 + r) * 3 + j) : 0.0f;
        st_shared_f32(bent_row(extra, b, r) + 4 * j,
                      __fadd_rn(x, __fmul_rn(ld_shared_f32(rig_row(extra, b, r)), o)));
        if (valid) off[size_t(row0 + r) * 3 + j] = o;
      }
      encoders_barrier();   // every bh3 row is read, every bent point written
#pragma unroll 1
      for (int q = e; q < PIECES; q += ENCODERS) {
        const int r = q / (EMB / 8);
        const uint4 bv = ld_shared16(bent_row(extra, b, r));
        const float x[3] = {__uint_as_float(bv.x), __uint_as_float(bv.y), __uint_as_float(bv.z)};
        encode_piece_with(embt, x, row0 + r < n,
                          [&](int c, float (&pc)[4]) { image_encoding_coef(extra, c, pc); }, r,
                          (q % (EMB / 8)) * 8);
      }
      fence_proxy_async();
      mbar_arrive(bars + 8 * b);
    }
  }

  // a consumer: the bender's products of its rows of the CTA's j-th tile
  // (rows from row0; past the last tile every row is past n and the
  // products run on zeros: a wgmma under a branch would serialize them all),
  // `bender_rows` on its A tiles in its own rows of the activation tile
  // (lat and rh0 in atom 0, rh1 in atom 1, bh in atom 2), bh3 into encoding
  // tile j % 2. acc: the chain's accumulators (the products use the first 32).
  template <int R>
  __device__ __forceinline__ void ahead(float (&acc)[R], unsigned char* act, uint32_t emb0,
                                        uint32_t bars, uint32_t extra, int j, long row0, int n,
                                        int wg, int t) {
    const int slot = j % 2;
    const uint32_t lat_t = smem_u32(act) + uint32_t(wg) * WG_ATOM_BYTES;   // atom 0
    const long wrow0 = row0 + wg * WG_ROWS;
    // wg_barrier(wg) first: the last tile's head has read the activation tile
    bender_rows<BendLayout<WG_ATOM_BYTES / 2, TILE_ATOM_BYTES, 2 * TILE_ATOM_BYTES, 0>>(
        acc, extra, GlobalBendRows{pts, lat, wrow0, n}, lat_t,
        emb0 + uint32_t(slot) * TILE_ATOM_BYTES + uint32_t(wg) * WG_ATOM_BYTES, BAR_WG0 + wg, t,
        [&](int r, float, float rig0) {
          st_shared_f32(rig_row(extra, slot, wg * WG_ROWS + r), rig0);
          if (wrow0 + r < n) rig[wrow0 + r] = rig0;
        },
        [] {});
    if (t == 0) mbar_arrive(bars + 8 * (2 + slot));
  }

  __device__ __forceinline__ void first(uint32_t, long, int, int, int) {}
  __device__ __forceinline__ void wait(uint32_t bars, int i) {
    mbar_wait(bars + 8 * (i % 2), (i / 2) & 1);
  }
  __device__ __forceinline__ void done(uint32_t, uint32_t, int, long, int, int, int) {}
};

// What the forward kernel gives its input beyond the tiles: the ring's
// stages, shared memory of the input's own, and whether its consumers run
// `ahead` for the next tile before they wait for a tile (row 9's only)
template <class In>
struct FwdPlan {
  static constexpr int STAGES = FWD_STAGES;
  static constexpr size_t EXTRA_BYTES = 0;
  static constexpr bool AHEAD = false;
};

template <>
struct FwdPlan<FusedFwdIn> {
  static constexpr int STAGES = FUSED_STAGES;
  static constexpr size_t EXTRA_BYTES = FUSED_EXTRA_BYTES;
  static constexpr bool AHEAD = true;
};

// ---- the forward's chain kernel: mlp_fwd.cu (row 1) on the encoding,
// mlpe_fwd.cu (row 5) on points, fused_fwd.cu (row 9) on points and latents

struct FwdArgs {
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const bf16* ow;                // (256, 8) bf16
  const float* ob;               // (8,) f32
};

// Persistent CTAs walk 128-point tiles; two consumer warpgroups own 64 rows
// each for all 9 layers, the producer's first thread streams the image's
// n_fwd_chunks<E> forward chunks a tile through a ring of FWD_STAGES, and
// the input policy `In` (see above) may use its other three warps. Per
// tile: `In::wait` until the tile's encoding is in its encoding tile; nh1
// .. nh8 in the activation tile (chain_tile), during which, once layer 5
// has read the encoding tile, `In::done`; the f32 head.
template <int E, class In>
__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const In in_args, int n, int n_tiles, const bf16* __restrict__ image,
               FwdArgs p, float* __restrict__ out) {
  constexpr int S = FwdPlan<In>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* act = align_smem(smem_raw);
  const uint32_t emb0 = smem_u32(act + ACT_BYTES);
  const uint32_t ring = emb0 + uint32_t(In::FWD_TILES * emb_tile_bytes<E>);
  const uint32_t in_smem = ring + S * CHUNK_BYTES;   // the input's own shared memory
  const uint32_t bars = in_smem + uint32_t(FwdPlan<In>::EXTRA_BYTES);
  const uint32_t in_bars = bars + 2 * 8 * S;         // ... and barriers
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    ring_init<S>(bars);
    in_args.init(in_bars);
  }
  if constexpr (FwdPlan<In>::AHEAD) {
    in_args.stage(in_smem, threadIdx.x, THREADS);
    fence_proxy_async();   // the consumers' wgmma read what was staged
  }
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      produce<S>(image, n_fwd_chunks<E>, n_tiles, ring, bars);
    } else if (t >= 32) {
      in_args.encode(emb0, in_bars, in_smem, n, n_tiles, t - 32);
    }
  } else {                 // a consumer: 64 rows of every tile
    setmaxnreg_inc<CONSUMER_REGS>();
    In in = in_args;
    uint32_t g = 0;
    float acc[128];
    in.first(emb0, long(blockIdx.x) * TM, n, wg, t);
    if constexpr (FwdPlan<In>::AHEAD) {
      in.ahead(acc, act, emb0, in_bars, in_smem, 0, long(blockIdx.x) * TM, n, wg, t);
    }
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const long row0 = long(tile) * TM;
      const int next = tile + gridDim.x;
      const uint32_t embt = emb0 + uint32_t(i % In::FWD_TILES) * uint32_t(emb_tile_bytes<E>);
      if constexpr (FwdPlan<In>::AHEAD) {
        in.ahead(acc, act, emb0, in_bars, in_smem, i + 1, long(next) * TM, n, wg, t);
      }
      in.wait(in_bars, i);
      fence_proxy_async();
      wg_barrier(wg);   // the encoding is in its tile; the last tile's head is done
      chain_tile<S, E>(acc, act, embt, p.bias, ring, bars, g, wg, t, nullptr, 0, 0, nullptr,
                       [&] {
                         in.done(embt, in_bars, i, next < n_tiles ? long(next) * TM : -1, n,
                                 wg, t);
                       });
      raw_head(act, p.ow, p.ob, out, row0, n, wg, t);
    }
  }
}

// Rows 1, 5 and 9: the forward on the input `in` (EncodingIn<E>, PtsFwdIn or
// FusedFwdIn).
// image: the chain's forward chunks (pack_chain_image(mw, ("fwd",)),
// n_fwd_chunks<E> x 32 KB); mats: n0w .. n7w, ow as nrnerf_mlp_fwd lists
// them (only ow is read: the image holds the chain's weights); biases: n0b
// .. n7b, ob. Returns the CUDA error code of the launch (0 on success).
template <int E, class In>
inline int launch_fwd(const In& in, int n, const void* image, const void* const* mats,
                      const void* const* biases, float* out, cudaStream_t stream) {
  FwdArgs p;
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = static_cast<const bf16*>(mats[9]);
  p.ob = static_cast<const float*>(biases[8]);
  constexpr size_t smem =
      fwd_smem_bytes<E, In::FWD_TILES, FwdPlan<In>::STAGES> + FwdPlan<In>::EXTRA_BYTES;
  static_assert(smem <= SMEM_LIMIT, "the forward and its input fit one Hopper CTA");
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel<E, In>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return 0;
  const int n_tiles = (n + TM - 1) / TM;
  mlp_fwd_kernel<E, In><<<persistent_grid(n_tiles), THREADS, smem, stream>>>(
      in, n, n_tiles, static_cast<const bf16*>(image), p, out);
  return int(cudaGetLastError());
}

// ---- the view-direction heads: mlpv_fwd.cu (row 3) and mlpv_bwd.cu (row 4)

// The view-direction image's schedule: the chain's forward chunks; fw (4
// chunks, forward layout), vwf (4, 128 columns), vwv (1, its 32 rows padded
// to 64) -- the first V_FWD_CHUNKS, all the forward reads; vwf as the B
// operand of dhv @ vwf^T (4 chunks of 64 rows, 2 k-atoms each), vwv (1: 32
// rows), fw (4, as the chain's backward chunks); the chain's backward
// chunks. mlp_sm90.py:views_schedule mirrors it.
constexpr int V_FW = n_fwd_chunks<EMB>;
constexpr int V_VWF = V_FW + NW / KC;
constexpr int V_VWV = V_VWF + NW / KC;
constexpr int V_FWD_CHUNKS = V_VWV + 1;
constexpr int V_BVWF = V_FWD_CHUNKS;
constexpr int V_BVWV = V_BVWF + NW / KC;
constexpr int V_BFW = V_BVWV + 1;
constexpr int V_BWD = V_BFW + NW / KC;
constexpr int V_CHUNKS = V_BWD + n_bwd_chunks<EMB>;
static_assert(V_FWD_CHUNKS == 39 && V_CHUNKS == 78, "the view-direction schedule");
constexpr uint32_t VIEW_CHUNK_BYTES = VW * ATOM_ROW_BYTES;           // 16 KB
constexpr uint32_t VWV_BWD_BYTES = 2 * VEMB * ATOM_ROW_BYTES;        // 8 KB
static_assert(VIEW_CHUNK_BYTES <= CHUNK_BYTES && VIEW_CHUNK_BYTES % 1024 == 0 &&
              VWV_BWD_BYTES % 1024 == 0, "the view layer's chunks fit a stage");

// the bytes of chunk c that its stage receives
__device__ __forceinline__ uint32_t views_chunk_bytes(int c) {
  return c >= V_VWF && c < V_BVWV ? VIEW_CHUNK_BYTES
                                  : (c == V_BVWV ? VWV_BWD_BYTES : CHUNK_BYTES);
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

// ---- the single-head backward's chain kernel: mlp_bwd.cu (row 2) and
// fused_bwd.cu (row 10) on the encoding, mlpe_bwd.cu (row 6) on points

struct ChainArgs {
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const bf16* ow;                // (256, 8) bf16
};

// Persistent CTAs walk 128-point tiles; two consumer warpgroups own 64 rows
// each, the producer streams the image (the chain's forward then backward
// chunks) through a ring of BWD_STAGES. Per tile: the input policy `In`
// puts the encoding into tile B, which a bulk tensor store copies to the
// scratch for the dW products; nh1 .. nh8 are recomputed in tile A (each
// stored to the scratch, nh1 .. nh7's ReLU gates kept as bits); dh8 comes
// from draw on the CUDA cores into tile B (over the encoding, which the
// recompute has read); then the dh chain, whose two demb products go to
// `In::sink`, and during whose last step `In::next` starts the next tile's
// input. Rows past n carry draw = 0, so their dh is exactly 0 and they add
// nothing to the second pass.
template <int E, class In>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_chain_kernel(const __grid_constant__ ScratchMaps maps, const In in_args,
                     const float* __restrict__ draw, int n, int n_tiles, long n_pad,
                     const bf16* __restrict__ image, ChainArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* buf_a = align_smem(smem_raw);
  unsigned char* buf_b = buf_a + ACT_BYTES;
  const uint32_t b_s = smem_u32(buf_b);   // the encoding tile until dh8
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
    In in = in_args;
    uint32_t gates[N_LAYERS - 1][4];   // nh1 .. nh7's ReLU gates of this thread's values
    uint32_t g = 0;
    in.first(b_s, long(blockIdx.x) * TM, n, wg, t);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long row0 = long(tile) * TM;
      const int next = tile + gridDim.x;
      const int wrow = int(row0) + wg * WG_ROWS;   // this warpgroup's first row
      in.begin(buf_b, row0, n, wg, t);
      fence_proxy_async();
      wg_barrier(wg);   // the encoding is in its tile; the last tile is done
      // the padded copy of the encoding that the dW products read
      if (In::STORE_EMB && t == 0) store_rows(&maps.emb, b_s, E / BOX, wrow, wg);

      // ---- recompute nh1 .. nh8 (as mlp_fwd.cu), each stored to the scratch
      {
        float acc[128];
        chain_tile<BWD_STAGES, E>(acc, buf_a, b_s, p.bias, ring, bars, g, wg, t, &maps, n_pad,
                                  row0, gates, [] {});
      }

      // ---- dh8 into buf_b, over the encoding tile that layers 0 and 5 (and
      // the copy, waited for before layer 0's epilogue) have read
      dh8_rows(draw, row0, n, p.ow, buf_a, buf_b, wg, t);
      fence_proxy_async();
      wg_barrier(wg);
      if (t == 0) store_rows(&maps.dh, b_s, NW / BOX, int(7 * n_pad) + wrow, wg);

      // ---- the dh chain; buf_b takes the next tile's input before its last step
      float dacc[32];
      dh_chain<BWD_STAGES, E>(
          dacc, buf_b, buf_a, gates, &maps, n_pad, wrow, ring, bars, g, wg, t,
          [&](const float (&acc)[32], int c, bool last) {
            in.sink(acc, c, last, row0, n, wg, t);
          },
          [&](unsigned char* spare) {
            in.next(smem_u32(spare), next < n_tiles ? long(next) * TM : -1, n, wg, t);
          });
      in.end(row0, n, wg, t);
    }
    if (t == 0) bulk_wait_all();
  }
}

// ---- the second pass's products: dW = act^T @ dh on wgmma

constexpr int DW_RK = 64;           // points per staged chunk
constexpr int DW_STAGES = 2;
constexpr int DW_SPLIT = 2048;      // points per split (mlp_tile.cuh's SPLIT_ROWS)
constexpr int DW_THREADS = 128;
constexpr int SUM_GROUPS = 4;       // partial sums of the bias and head gradients
constexpr int MAX_DW_JOBS = 40;
constexpr uint32_t DW_A_BYTES = BOX_BYTES;                   // 64 points x 64 act lanes
constexpr uint32_t DW_B_BYTES = (NW / BOX) * BOX_BYTES;      // 64 points x 256 dh lanes
constexpr uint32_t DW_STAGE_BYTES = DW_A_BYTES + DW_B_BYTES;
constexpr size_t DW_SMEM_BYTES = SMEM_ALIGN + DW_STAGES * DW_STAGE_BYTES + BAR_BYTES;
static_assert(2 * DW_SMEM_BYTES <= SMEM_LIMIT, "two dW CTAs share an SM");
static_assert(DW_RK % SUM_GROUPS == 0, "point p of a split goes to sum p % SUM_GROUPS");
static_assert(DW_STAGE_BYTES % SMEM_ALIGN == 0 && DW_A_BYTES % SMEM_ALIGN == 0,
              "every staged box starts on the swizzle's 1024 bytes");

struct DwJob {
  int a_map;      // the activation's map: 0 the encoding copy, 1 nh
  int a_row0;     // the activation layer's first row in its map
  int a_col;      // the first of the job's 64 activation columns
  int a_rows;     // rows of the job's block that are written: 64, or 32 (the view encoding's)
  int b_map;      // dh's map: 0 dh, 1 hv (dhv)
  int b_row0;     // dh's first row in its map
  int b_width;    // dh's lanes: 256, or 128 (dhv)
  int out_off;    // the job's a_rows x b_width block of a weight gradient, in the flat grads
  int bias_off;   // -1, or where dh's column sums (the bias gradient) go
};

struct DwJobs {
  DwJob job[MAX_DW_JOBS];
};

// the products of a dW job over its split's n_k staged chunks: dh WIDE (256
// lanes, m64n256k16) or not (128, m64n128k16 into acc[0 .. 63]), both
// operands MN-major; with `bias`, thread t also sums dh's columns 2t, 2t + 1
// of each chunk on the CUDA cores while the products run. `issue(k)` (thread
// 0) stages chunk k.
template <bool WIDE, class Issue>
__device__ __forceinline__ void dw_products(float (&acc)[128], float (&bsum)[2][SUM_GROUPS],
                                            bool bias, int n_k, unsigned char* base,
                                            uint32_t stages, uint32_t bars, int t,
                                            Issue&& issue) {
  const int bcol = 2 * t;
#pragma unroll 1
  for (int k = 0; k < n_k; ++k) {
    const uint32_t s = k % DW_STAGES;
    const uint32_t a = stages + s * DW_STAGE_BYTES;
    const uint32_t b = a + DW_A_BYTES;
    mbar_wait(bars + 8 * s, (k / DW_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_RK / 16; ++kk) {   // 16 points = 2 K-groups of 8 rows
      const uint64_t da = desc_mn_sw128(a + kk * 16 * ATOM_ROW_BYTES, BOX_BYTES);
      const uint64_t db = desc_mn_sw128(b + kk * 16 * ATOM_ROW_BYTES, BOX_BYTES);
      if constexpr (WIDE) {
        wgmma_m64n256_mn(acc, da, db, (k | kk) != 0);
      } else {
        wgmma_m64n128_mn(acc, da, db, (k | kk) != 0);
      }
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
}

// CTA (job, split) forms act[rows, a_col : a_col + 64]^T @ dh[rows, :] over
// the split's rows on wgmma (both operands MN-major: the boxes are the
// scratch's point-major rows as TMA lays them out; m64n256k16, or m64n128k16
// where dh is 128 lanes wide) and writes it to the split's slot of the
// partials; with bias_off, also dh's column sums over the split's rows, in
// ascending order of the points, on the CUDA cores while the products run.
// TMA fills a ring of DW_STAGES chunks.
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
  const CUtensorMap* amap = job.a_map == 0 ? &maps.emb : &maps.nh;
  const CUtensorMap* bmap = job.b_map == 0 ? &maps.dh : &maps.hv;
  const int b_boxes = job.b_width / BOX;
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
    mbar_expect_tx(bar, DW_A_BYTES + b_boxes * BOX_BYTES);
    tma_load_2d(a, amap, job.a_col, job.a_row0 + row, bar);
    for (int q = 0; q < b_boxes; ++q) {
      tma_load_2d(a + DW_A_BYTES + q * BOX_BYTES, bmap, q * BOX, job.b_row0 + row, bar);
    }
  };
  if (t == 0) {
    for (int k = 0; k < DW_STAGES && k < n_k; ++k) issue(k);
  }

  float acc[128];
  // the column sums: SUM_GROUPS partial sums, point p of the split into sum
  // p % SUM_GROUPS, added in ascending order at the end (every backward
  // sums in this order)
  float bsum[2][SUM_GROUPS] = {};
  const int bcol = 2 * t;   // this thread's two dh columns of the sums
  const bool bias = job.bias_off >= 0 && bcol < job.b_width;
  if (job.b_width == NW) {
    dw_products<true>(acc, bsum, bias, n_k, base, stages, bars, t, issue);
  } else {
    dw_products<false>(acc, bsum, bias, n_k, base, stages, bars, t, issue);
  }

  float* out = partials + size_t(blockIdx.y) * grad_floats + job.out_off;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    if (col >= job.b_width) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r0 + 8 * h >= job.a_rows) continue;
      *reinterpret_cast<float2*>(out + (r0 + 8 * h) * job.b_width + col) =
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
    *reinterpret_cast<float2*>(partials + size_t(blockIdx.y) * grad_floats + job.bias_off +
                               bcol) = make_float2(s0, s1);
  }
}

// The 8-lane heads' gradients over one split's rows, on the CUDA cores: a
// block of 128 columns of src (nh8 or hv) gives rows col0 .. col0 + 127 of
// src^T @ bf16(draw) and, with sum_off, sum(draw) (uncast)
struct HeadBlock {
  const bf16* src;   // row-major (n_pad, ld)
  int ld;            // 256 or 128
  int col0;
  int w_off;         // where row col0 of the head's weight gradient goes
  int sum_off;       // -1, or where sum(draw) goes
};
constexpr int MAX_HEAD_BLOCKS = 3;
struct HeadBlocks {
  HeadBlock block[MAX_HEAD_BLOCKS];
};

// CTA (split, block): one column a thread in each of HG_GROUPS row groups;
// the rows pass through shared memory HG_ROWS at a time (coalesced 16-byte
// loads). Group g takes every HG_GROUPS-th row from g on, in ascending order,
// and the groups are added in order (the dW products' order of the sums).
// Rows past n have draw = 0 and are skipped.
constexpr int HG_COLS = 128;
constexpr int HG_GROUPS = SUM_GROUPS;
constexpr int HG_ROWS = 64;
constexpr int HG_THREADS = HG_COLS * HG_GROUPS;
static_assert(HG_ROWS % HG_GROUPS == 0 && DW_SPLIT % HG_ROWS == 0,
              "a staged block of rows keeps every group's order");

__global__ void __launch_bounds__(HG_THREADS)
mlp_head_grad_kernel(const HeadBlocks heads, const float* __restrict__ draw, int n,
                     int grad_floats, float* __restrict__ partials) {
  __shared__ __align__(16) bf16 rows[HG_ROWS][HG_COLS];
  __shared__ float draws[HG_ROWS][OUT];
  __shared__ float red[HG_GROUPS][HG_COLS][OUT + 1];
  const HeadBlock blk = heads.block[blockIdx.y];
  const int lane = threadIdx.x % HG_COLS;   // this thread's column of the block's
  const int grp = threadIdx.x / HG_COLS;
  const bool sums_draw = blk.sum_off >= 0 && lane < OUT;
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
        v = *reinterpret_cast<const uint4*>(blk.src + size_t(r0 + r) * blk.ld + blk.col0 +
                                            q * 8);
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
      out[blk.w_off + lane * OUT + o] = s;
    } else if (sums_draw) {
      out[blk.sum_off + lane] = s;
    }
  }
}

// ---- host side of the backward

// The chain's 9 products g_W = act^T @ dh_l as 64-row jobs, appended from
// `n_jobs` on (the encoding copy's E lanes; nh1 .. nh7 and dh1 .. dh8 at
// n_pad rows a layer, `np`): w_off and b_off say where n0w n1w n2w n3w n4w
// n5e n5h n6w n7w and their biases (-1: n5e has none) go in the flat
// gradient. Returns the new job count, or -1 past MAX_DW_JOBS.
template <int E>
inline int chain_dw_jobs(DwJobs& jobs, int n_jobs, int np, const int (&w_off)[9],
                         const int (&b_off)[9]) {
  struct Prod { int a_map, a_layer, lda, dh_layer; };
  const Prod prods[9] = {{0, 0, E, 1},  {1, 1, NW, 2}, {1, 2, NW, 3},
                         {1, 3, NW, 4}, {1, 4, NW, 5}, {0, 0, E, 6},
                         {1, 5, NW, 6}, {1, 6, NW, 7}, {1, 7, NW, 8}};
  for (int i = 0; i < 9; ++i) {
    const Prod& pr = prods[i];
    for (int c = 0; c < pr.lda; c += BOX) {
      if (n_jobs == MAX_DW_JOBS) return -1;
      jobs.job[n_jobs++] = DwJob{pr.a_map, pr.a_map ? (pr.a_layer - 1) * np : 0, c, BOX, 0,
                                 (pr.dh_layer - 1) * np, NW, w_off[i] + c * NW,
                                 c == 0 ? b_off[i] : -1};
    }
  }
  return n_jobs;
}

// The second pass on `stream` but for the fixed-order reduction over the
// splits, which the caller launches (mlp_reduce_kernel): the
// dW jobs with their bias sums (mlp_dw_sm90_kernel) and the heads' blocks
// (mlp_head_grad_kernel), each CTA into its split's slot of the partials
// (grad_floats a split). Returns the CUDA error code (0 on success).
inline int launch_dw_heads(const ScratchMaps& maps, const DwJobs& jobs, int n_jobs,
                           const HeadBlocks& heads, int n_heads, const float* draw, int n,
                           long n_pad, int n_splits, int grad_floats, float* partials,
                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_dw_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(DW_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  mlp_dw_sm90_kernel<<<dim3(n_jobs, n_splits), DW_THREADS, DW_SMEM_BYTES, stream>>>(
      maps, jobs, n_pad, grad_floats, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mlp_head_grad_kernel<<<dim3(n_splits, n_heads), HG_THREADS, 0, stream>>>(
      heads, draw, n, grad_floats, partials);
  return int(cudaGetLastError());
}

// Rows 2, 6 and 10 but for the reduction over the splits (the caller's):
// the chain kernel on the input `in` (EncodingIn<E>, PtsIn, or row 10's
// EncodingIn<EMB, false> on the scratch's encoding), then the second
// pass, with the gradient layout L (mlp_tile.cuh's single_head::GradLayout<E>):
// the 9 products with the bias sums of dh1 .. dh8, g_ow = nh8^T @ bf16(draw)
// with g_ob. scratch: the encoding copy, nh1 .. nh8, dh1 .. dh8 (n_pad rows
// each, bf16); image: the chain's forward and backward chunks (n_chain_chunks
// x 32 KB); mats, biases as nrnerf_mlp_bwd lists them (of mats only ow is
// read). Returns the CUDA error code of the first failing call (0 on success).
template <int E, class L, class In>
inline int launch_single_head_bwd(const In& in, const float* draw, int n, long n_pad,
                                  int n_splits, const void* image, const void* const* mats,
                                  const void* const* biases, void* scratch, float* partials,
                                  cudaStream_t stream) {
  ChainArgs p;
  for (int i = 0; i < N_LAYERS; ++i) p.bias[i] = static_cast<const float*>(biases[i]);
  p.ow = static_cast<const bf16*>(mats[9]);
  const int n_tiles = int(n_pad / TM);
  bf16* embp = static_cast<bf16*>(scratch);
  bf16* nh = embp + size_t(n_pad) * E;
  bf16* dh = nh + N_LAYERS * size_t(n_pad) * NW;
  ScratchMaps maps{};
  int rc = encode_box_map(&maps.emb, embp, n_pad, E);
  if (rc == 0) rc = encode_box_map(&maps.nh, nh, N_LAYERS * n_pad, NW);
  if (rc == 0) rc = encode_box_map(&maps.dh, dh, N_LAYERS * n_pad, NW);
  if (rc != 0) return rc;

  cudaError_t err = cudaFuncSetAttribute(mlp_bwd_chain_kernel<E, In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(BWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  mlp_bwd_chain_kernel<E, In>
      <<<persistent_grid(n_tiles), THREADS, BWD_SMEM_BYTES, stream>>>(
          maps, in, draw, n, n_tiles, n_pad, static_cast<const bf16*>(image), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  DwJobs jobs;
  const int w_off[9] = {L::OFF_N0W, L::OFF_N1W, L::OFF_N2W, L::OFF_N3W, L::OFF_N4W,
                        L::OFF_N5E, L::OFF_N5H, L::OFF_N6W, L::OFF_N7W};
  const int b_off[9] = {L::OFF_N0B, L::OFF_N1B, L::OFF_N2B, L::OFF_N3B, L::OFF_N4B,
                        -1,         L::OFF_N5B, L::OFF_N6B, L::OFF_N7B};
  const int n_jobs = chain_dw_jobs<E>(jobs, 0, int(n_pad), w_off, b_off);
  if (n_jobs != L::DW_TILES) return int(cudaErrorInvalidValue);
  const bf16* nh8 = nh + size_t(N_LAYERS - 1) * n_pad * NW;
  const HeadBlocks heads = {{{nh8, NW, 0, L::OFF_OW, L::OFF_OB},
                             {nh8, NW, HG_COLS, L::OFF_OW + HG_COLS * OUT, -1}}};
  return launch_dw_heads(maps, jobs, n_jobs, heads, 2, draw, n, n_pad, n_splits, L::FLOATS,
                         partials, stream);
}

// ---- rows 7 and 8 (bend_fwd.cu, bend_bwd.cu) and row 10's pre-pass and
// bender backward (fused_bwd.cu): the deformation field on its own, on row
// 9's bender (`bender_rows`), the bender's image staged once per CTA.
//
// Replace `_bend_core` / `_bend_fwd_kernel` and `_bend_core_bwd` /
// `_bend_bwd_kernel` (nonrigid_nerf_tpu/ops/pallas/fused_query.py:533-671).
// Tiles of 64 points; each warpgroup that owns tiles walks its own on a
// static schedule (worker w of W: tiles w, w + W, ...), so the same inputs
// give bit-equal outputs from launch to launch.

constexpr size_t SM_SMEM = 233472;   // an SM's shared memory (a CTA also takes 1 KB of it)

// the grid of a persistent kernel: `per_cta` workers a CTA over `blocks`
// tiles, `ctas_per_sm` CTAs an SM, or fewer where there are fewer tiles
inline int bend_grid(int blocks, int per_cta, int ctas_per_sm) {
  const int ctas = (blocks + per_cta - 1) / per_cta;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0) {
    return ctas;
  }
  return ctas < sms * ctas_per_sm ? ctas : sms * ctas_per_sm;
}

// ---- row 7's forward, and row 10's pre-pass: bend_fwd_sm90_kernel
//
// What bounds it: the bytes (12 B of points and 128 B of latents a point
// in, 256 B of f32 encoding and 16 B of offsets and rigidity out; the
// pre-pass writes 128 B of bf16 encoding). A CTA holds BF_PAIRS pairs of
// warpgroups, each pair on tiles of its own:
// - the consumer warpgroup runs `bender_rows` on wgmma, from a tile of
//   points and latents that its first thread copied into a ring of
//   BF_STAGES stages with two bulk copies (a ragged tile, or points off a
//   16-byte boundary, are read from global memory instead), and hands bh3
//   and the rigidity over in one of two slots ("ready");
// - the encoder warpgroup (BF_ENCODERS threads of it) sums the offsets (bh3
//   @ bow, sequential, as row 9's encoders), bends the points, and writes
//   the encoding (`encoding_of`, the loop rolled) with 16-byte stores,
//   consecutive threads on consecutive bytes, then frees the slot ("free").
// So the loads, the products and the sines and stores of three tiles
// overlap. Row 7 writes f32 rows below n; row 10's pre-pass bf16 rows up to
// n_pad, zero past n (the chain's scratch).

constexpr int BF_PAIRS = 3;          // consumer + encoders groups a CTA
constexpr int BF_ENC_WGS = 1;        // encoder warpgroups of a group
constexpr int BF_STAGES = 2;         // the input ring's stages a group
constexpr int BF_CTAS_PER_SM = 1;
constexpr int BF_ENCODERS = 128 * BF_ENC_WGS;   // the encoder threads of a group that work
constexpr int BF_GROUP_THREADS = 128 * (1 + BF_ENC_WGS);
constexpr int BF_THREADS = BF_GROUP_THREADS * BF_PAIRS;
// setmaxnreg: the consumers' bender takes 96 registers, the encoders 64;
// the CTA starts with 65536 / BF_THREADS a thread (rounded down to 8)
constexpr int BF_CONSUMER_REGS = 96;
constexpr int BF_ENCODER_REGS = 64;
constexpr int BF_LAUNCH_REGS = (65536 / (BF_THREADS * BF_CTAS_PER_SM)) / 8 * 8;
static_assert(BF_CONSUMER_REGS + BF_ENC_WGS * BF_ENCODER_REGS <= (1 + BF_ENC_WGS) * BF_LAUNCH_REGS,
              "the encoders free what the consumer takes");
constexpr uint32_t BF_LAT_STAGE = WG_ROWS * LAT_W * 4;   // 8 KB of f32 latents
constexpr uint32_t BF_PTS_STAGE = WG_ROWS * 3 * 4;       // 768 B of points
constexpr uint32_t BF_STAGE_BYTES = BF_LAT_STAGE + BF_PTS_STAGE;
// a pair's shared memory: the consumer's tiles, two slots of bh3, rigidity
// and bent points (x, y, z, pad), the ring
constexpr uint32_t BFP_LAT = 0;
constexpr uint32_t BFP_RH0 = BFP_LAT + WG_ROWS * LAT_W * 2;
constexpr uint32_t BFP_RH1 = BFP_RH0 + WG_ROWS * RIG_W * 2;
constexpr uint32_t BFP_BH = BFP_RH1 + WG_ROWS * RIG_W * 2;
constexpr uint32_t BFP_BH3 = BFP_BH + WG_ATOM_BYTES;
constexpr uint32_t BFP_RIG = BFP_BH3 + 2 * WG_ATOM_BYTES;
constexpr uint32_t BFP_BENT = BFP_RIG + 2 * WG_ROWS * 4;
constexpr uint32_t BFP_RING = BFP_BENT + 2 * WG_ROWS * 16;
constexpr uint32_t BF_PAIR_BYTES = (BFP_RING + BF_STAGES * BF_STAGE_BYTES + 1023) / 1024 * 1024;
constexpr uint32_t BF_PAIR_BARS = 8 * (BF_STAGES + 4);   // full[S], ready[2], free[2]
constexpr size_t BF_SMEM_BYTES =
    SMEM_ALIGN + BEND_IMAGE_PAD + BF_PAIRS * (BF_PAIR_BYTES + BF_PAIR_BARS);
static_assert(BFP_RH0 % 512 == 0 && BFP_BH % 1024 == 0 && BFP_BH3 % 1024 == 0 &&
                  BFP_RING % 16 == 0 && BF_STAGE_BYTES % 16 == 0,
              "the swizzled tiles on their atoms' alignment, the ring on the bulk copies'");
static_assert(BF_SMEM_BYTES <= SMEM_LIMIT && BF_CTAS_PER_SM * (BF_SMEM_BYTES + 1024) <= SM_SMEM,
              "row 7's CTAs fit an SM");
static_assert(BF_ENCODERS % 32 == 0 && BF_ENCODERS <= 128 * BF_ENC_WGS && BF_THREADS <= 1024,
              "whole warps of the group's encoder warpgroups; a CTA of at most 1,024 threads");

__device__ __forceinline__ void encoders_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(BF_ENCODERS) : "memory");
}

// a whole tile whose points sit on a 16-byte boundary goes through the ring
__device__ __forceinline__ bool bend_tile_staged(const float* pts, long row0, int n) {
  return row0 + WG_ROWS <= n && (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
}

// the consumer's first thread: the group's i-th tile into stage i % S (or,
// for a tile that is not staged, the stage's arrival alone)
__device__ __forceinline__ void bend_fwd_issue(uint32_t ring, uint32_t bars, int i, long worker,
                                               long workers, int n_blocks,
                                               const float* pts, const float* lat, int n) {
  const long b = worker + long(i) * workers;
  if (b >= n_blocks) return;
  const uint32_t s = uint32_t(i % BF_STAGES);
  const long row0 = b * WG_ROWS;
  if (bend_tile_staged(pts, row0, n)) {
    const uint32_t st = ring + s * BF_STAGE_BYTES;
    mbar_expect_tx(bars + 8 * s, BF_STAGE_BYTES);
    bulk_load(st, lat + size_t(row0) * LAT_W, BF_LAT_STAGE, bars + 8 * s);
    bulk_load(st + BF_LAT_STAGE, pts + size_t(row0) * 3, BF_PTS_STAGE, bars + 8 * s);
  } else {
    mbar_arrive(bars + 8 * s);
  }
}

// encoder e: the encoding of a tile's bent points (bent: 64 rows of 16
// bytes), 16 bytes a store: f32 rows below n, or bf16 rows (zero past n)
template <bool BF16_ROWS>
__device__ __forceinline__ void bend_encode_rows(uint32_t img, uint32_t bent, long row0, int n,
                                                 void* emb, int e) {
  constexpr int L = BF16_ROWS ? 8 : 4;   // lanes a store
#pragma unroll 1
  for (int q = e; q < WG_ROWS * EMB / L; q += BF_ENCODERS) {
    const int r = q / (EMB / L), c0 = (q % (EMB / L)) * L;
    const bool valid = row0 + r < n;
    if (!BF16_ROWS && !valid) break;   // later pieces lie on later rows
    const uint4 bv = ld_shared16(bent + r * 16);
    const float x[3] = {__uint_as_float(bv.x), __uint_as_float(bv.y), __uint_as_float(bv.z)};
    float y[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      float pc[4];
      image_encoding_coef(img, c0 + k, pc);
      y[k] = encoding_of(x, pc, c0 + k);
    }
    if constexpr (BF16_ROWS) {
#pragma unroll
      for (int k = 0; k < L; ++k) y[k] = valid ? y[k] : 0.0f;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(emb) + size_t(row0 + r) * EMB + c0) =
          make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                     pack_bf16(y[6], y[7]));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(emb) + size_t(row0 + r) * EMB + c0) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

template <bool BF16_ROWS>
__global__ void __launch_bounds__(BF_THREADS, BF_CTAS_PER_SM)
bend_fwd_sm90_kernel(const BendWeights bw, const float* __restrict__ pts,
                     const float* __restrict__ lat, int n, int n_blocks, void* __restrict__ emb,
                     float* __restrict__ off, float* __restrict__ rig) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  const uint32_t img = smem_u32(base);
  const int pair = threadIdx.x / BF_GROUP_THREADS;
  const int gt = threadIdx.x % BF_GROUP_THREADS;   // the group's thread: the consumer's first
  const bool encoder = gt >= 128;
  const int t = encoder ? gt - 128 : gt;
  unsigned char* pb = base + BEND_IMAGE_PAD + pair * BF_PAIR_BYTES;
  const uint32_t ps = smem_u32(pb);
  const uint32_t bars = img + BEND_IMAGE_PAD + BF_PAIRS * BF_PAIR_BYTES + pair * BF_PAIR_BARS;
  const uint32_t ready = bars + 8 * BF_STAGES;   // ready[2], then free[2]
  const uint32_t freed = ready + 16;
  stage_bend_image(img, bw, false, threadIdx.x, BF_THREADS);
  if (!encoder && t == 0) {
    for (int s = 0; s < BF_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(ready + 8 * b, 1);
      mbar_init(freed + 8 * b, BF_ENCODERS);
    }
    mbar_init_fence();
  }
  fence_proxy_async();   // wgmma reads the image
  __syncthreads();
  const long worker = long(blockIdx.x) * BF_PAIRS + pair;
  const long workers = long(gridDim.x) * BF_PAIRS;

  if (!encoder) {   // the consumer
    setmaxnreg_inc<BF_CONSUMER_REGS>();
    const uint32_t ring = ps + BFP_RING;
    if (t == 0) {
      for (int i = 0; i < BF_STAGES; ++i) {
        bend_fwd_issue(ring, bars, i, worker, workers, n_blocks, pts, lat, n);
      }
    }
    float acc[32];
    int i = 0;
#pragma unroll 1
    for (long b = worker; b < n_blocks; b += workers, ++i) {
      const long row0 = b * WG_ROWS;
      const int s = i % BF_STAGES, slot = i % 2;
      const float* st = reinterpret_cast<const float*>(pb + BFP_RING + s * BF_STAGE_BYTES);
      mbar_wait(bars + 8 * s, (i / BF_STAGES) & 1);
      const long left = long(n) - row0;
      const TileBendRows src = bend_tile_staged(pts, row0, n)
                                   ? TileBendRows{st + BF_LAT_STAGE / 4, st, WG_ROWS}
                                   : TileBendRows{pts + size_t(row0) * 3, lat + size_t(row0) * LAT_W,
                                                  int(left < WG_ROWS ? left : WG_ROWS)};
      mbar_wait(freed + 8 * slot, ((i / 2) & 1) ^ 1);   // the encoders are done with the slot
      const uint32_t rigs = ps + BFP_RIG + uint32_t(slot) * WG_ROWS * 4;
      bender_rows<BendLayout<BFP_RH0 - BFP_LAT, BFP_RH1 - BFP_LAT, BFP_BH - BFP_LAT, 0>>(
                  acc, img, src, ps + BFP_LAT, ps + BFP_BH3 + uint32_t(slot) * WG_ATOM_BYTES,
                  BAR_WG0 + 2 * pair, t,
                  [&](int r, float, float rig0) {
                    st_shared_f32(rigs + 4 * r, rig0);
                    if (rig != nullptr && row0 + r < n) rig[row0 + r] = rig0;
                  },
                  [&] {
                    if (t == 0) {
                      bend_fwd_issue(ring, bars, i + BF_STAGES, worker, workers, n_blocks, pts,
                                     lat, n);
                    }
                  });
      if (t == 0) mbar_arrive(ready + 8 * slot);
    }
  } else {   // the encoders
    setmaxnreg_dec<BF_ENCODER_REGS>();
    if (t >= BF_ENCODERS) return;
    int i = 0;
#pragma unroll 1
    for (long b = worker; b < n_blocks; b += workers, ++i) {
      const long row0 = b * WG_ROWS;
      const int slot = i % 2;
      const uint32_t bh3 = ps + BFP_BH3 + uint32_t(slot) * WG_ATOM_BYTES;
      const uint32_t rigs = ps + BFP_RIG + uint32_t(slot) * WG_ROWS * 4;
      const uint32_t bent = ps + BFP_BENT + uint32_t(slot) * WG_ROWS * 16;
      mbar_wait(ready + 8 * slot, (i / 2) & 1);
#pragma unroll 1
      for (int p = t; p < WG_ROWS * 3; p += BF_ENCODERS) {
        const int r = p / 3, j = p % 3;
        const float o = row_dot<BEND_W>(bh3, r, img + BIMG_BOWT + j * BEND_W * 2);
        const bool valid = row0 + r < n;
        const float x = valid ? __ldg(pts + size_t(row0 + r) * 3 + j) : 0.0f;
        st_shared_f32(bent + r * 16 + 4 * j, __fadd_rn(x, __fmul_rn(ld_shared_f32(rigs + 4 * r), o)));
        if (valid && off != nullptr) off[size_t(row0 + r) * 3 + j] = o;
      }
      encoders_bar(BAR_WG0 + 2 * pair + 1);   // every bent point is written
      bend_encode_rows<BF16_ROWS>(img, bent, row0, n, emb, t);
      mbar_arrive(freed + 8 * slot);
    }
  }
}

// Row 7 (f32 rows of emb (n, 64), off (n, 3) and rig (n, 1) below n) or,
// with BF16_ROWS, row 10's pre-pass (bf16 rows of emb (n_rows, 64), zero
// past n; off and rig may be null). weights: the 18 cast bender weights
// (BendWeights); lat 16-byte aligned. Returns the CUDA error code of the
// launch (0 on success).
template <bool BF16_ROWS>
inline int launch_bend_forward(const void* const* weights, const float* pts, const float* lat,
                               int n, long n_rows, void* emb, float* off, float* rig,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bend_fwd_sm90_kernel<BF16_ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(BF_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  if (n_rows <= 0) return 0;
  BendWeights bw;
  for (int i = 0; i < 18; ++i) bw.w[i] = weights[i];
  const int n_blocks = int((n_rows + WG_ROWS - 1) / WG_ROWS);
  bend_fwd_sm90_kernel<BF16_ROWS>
      <<<bend_grid(n_blocks, BF_PAIRS, BF_CTAS_PER_SM), BF_THREADS, BF_SMEM_BYTES, stream>>>(
          bw, pts, lat, n, n_blocks, emb, off, rig);
  return int(cudaGetLastError());
}

// ---- row 8's backward (and row 10's bender backward): bend_bwd_sm90_kernel
//
// The 16 gradients in one flat pack-order buffer (floats): b0p (8, 64) b0l
// (32, 64) b0b b1w (64, 64) b1b b2w b2b b3w b3b bow (64, 8) r0w (8, 32) r0b
// r1w (32, 32) r1b row (32, 8) rob (8), the 3- and 1-lane ones padded as
// packed
constexpr int BEND_WPAD = 8;
constexpr int G_B0P = 0;
constexpr int G_B0L = G_B0P + BEND_WPAD * BEND_W;
constexpr int G_B0B = G_B0L + LAT_W * BEND_W;
constexpr int G_B1W = G_B0B + BEND_W;
constexpr int G_B1B = G_B1W + BEND_W * BEND_W;
constexpr int G_B2W = G_B1B + BEND_W;
constexpr int G_B2B = G_B2W + BEND_W * BEND_W;
constexpr int G_B3W = G_B2B + BEND_W;
constexpr int G_B3B = G_B3W + BEND_W * BEND_W;
constexpr int G_BOW = G_B3B + BEND_W;
constexpr int G_R0W = G_BOW + BEND_W * BEND_WPAD;
constexpr int G_R0B = G_R0W + BEND_WPAD * RIG_W;
constexpr int G_R1W = G_R0B + RIG_W;
constexpr int G_R1B = G_R1W + RIG_W * RIG_W;
constexpr int G_ROW = G_R1B + RIG_W;
constexpr int G_ROB = G_ROW + RIG_W * BEND_WPAD;
constexpr int BEND_GRAD_FLOATS = G_ROB + BEND_WPAD;
static_assert(BEND_GRAD_FLOATS == 17224, "pack-order layout");

// What bounds it: latency, not bytes (552 B a point) or products (3 x
// 16,896 padded MACs a point). BB_WORKERS warpgroups a CTA, each on tiles
// of its own, with everything of a tile in its shared memory. Per tile:
// - the forward, `bender_rows` (rows 7 and 9's device code), into four bh
//   tiles, rh0, rh1, lat; the offsets and bent points as row 7's encoders;
// - on the CUDA cores: dbent (demb folded onto the coordinates, two threads
//   a row), doff_t and drig_raw a row, the rigidity's backward (32 lanes:
//   g_row, drh1, g_r1w, drh0 = drh1 @ r1w^T, g_r0w, dpts_rig) and dbh3 (3
//   lanes);
// - on wgmma: g_bow += bh3^T @ bf16(doff_t) (m64n8k16, while the rigidity's
//   backward runs); for l = 3, 2, 1, one commit group: g_blw += bh_{l-1}^T @
//   dbh_l (both operands MN-major from the point-major tiles, m64n64k16),
//   g_blb += dbh_l^T @ [1] (m64n8k16: column sums), dbh_{l-1} = dbh_l @
//   b_lw^T (B the forward image's rows of b_lw^T, MN-major), then
//   bf16(dbh_{l-1} * (bh_{l-1} > 0)) over bh_{l-1}; for layer 0 g_b0l (lat
//   in lanes 0 .. 31 of a 64-lane tile), g_b0b and g_b0p (dbh0^T @ [1,
//   bf16(pts)]) and dlat = dbh0 @ b0l^T (B b0l's rows, the backward image's
//   own part, m64n32k16);
// - dpts on the CUDA cores.
// The wgmma gradients stay in registers across the worker's tiles (an
// array each, every product from its first float), the CUDA cores' in its
// shared memory; at the end the CTA writes one partial (its workers' sums
// added in order) and `mlp_reduce_kernel` sums the partials in ascending
// order. No atomics: bit-equal on relaunch.

constexpr int BB_WORKERS = 2;        // warpgroups a CTA, each on tiles of its own
constexpr int BB_CTAS_PER_SM = 1;
constexpr int BB_THREADS = 128 * BB_WORKERS;
// the backward's image: the forward's, then b0l's rows (row i holds b0l[i,
// :], K-major, 128-byte swizzle)
constexpr uint32_t BIMG_B0L_ROWS = BEND_IMAGE_PAD;
constexpr uint32_t BEND_BWD_IMAGE_BYTES = BIMG_B0L_ROWS + LAT_W * BEND_W * 2;
constexpr uint32_t BB_NTILE_BYTES = 8 * ATOM_ROW_BYTES;   // a K-major B of 8 rows x 64 points
// a worker's shared memory: lat, rh0 (64-byte swizzle), rh1 and drh1
// (row-major), bh0 .. bh3 (then dbh3 .. dbh0 over them), lat in a 64-lane
// tile, the B operands of the m64n8 products ([1, bf16(pts)] and
// bf16(doff_t), rows 0 .. 3 and 0 .. 2 of 8), demb's rows of the tile, the
// f32 values of its rows, the CUDA cores' gradient sums
constexpr uint32_t BBW_LAT = 0;
constexpr uint32_t BBW_RH0 = BBW_LAT + WG_ROWS * LAT_W * 2;
constexpr uint32_t BBW_RH1 = BBW_RH0 + WG_ROWS * RIG_W * 2;
constexpr uint32_t BBW_DRH = BBW_RH1 + WG_ROWS * RIG_W * 2;
constexpr uint32_t BBW_BH = BBW_DRH + WG_ROWS * RIG_W * 2;
constexpr uint32_t BBW_LAT64 = BBW_BH + 4 * WG_ATOM_BYTES;
constexpr uint32_t BBW_BX = BBW_LAT64 + WG_ATOM_BYTES;
constexpr uint32_t BBW_BD = BBW_BX + BB_NTILE_BYTES;
constexpr uint32_t BBW_DEMB = BBW_BD + BB_NTILE_BYTES;   // demb's 64 rows, f32
constexpr uint32_t BBW_ROWS = BBW_DEMB + WG_ROWS * EMB * 4;
// f32 values of the rows (floats from BBW_ROWS): x, off, dbent, doff_t,
// dpts_rig (64 x 3 each), t, rig0, drig_raw (64 each)
constexpr int BR_X = 0, BR_OFF = 192, BR_DBENT = 384, BR_DOFFT = 576, BR_DPRIG = 768,
              BR_TH = 960, BR_RIG = 1024, BR_DRIG = 1088, BR_FLOATS = 1152;
// the sums kept in shared memory (floats from BBW_SG): r0w (3, 32), r0b,
// r1w (32, 32), r1b, row (32), rob (an f64; the CUDA cores'); b0b .. b3b (64 each),
// b0p (3, 64), bow (64, 3) (the m64n8 products', added tile by tile)
constexpr int SG_R0W = 0, SG_R0B = 96, SG_R1W = 128, SG_R1B = 1152, SG_ROW = 1184,
              SG_ROB = 1216, SG_BB = 1220, SG_B0P = 1476, SG_BOW = 1668, SG_FLOATS = 1860;
constexpr uint32_t BBW_SG = BBW_ROWS + BR_FLOATS * 4;
constexpr uint32_t BB_WORKER_BYTES = (BBW_SG + SG_FLOATS * 4 + 1023) / 1024 * 1024;
constexpr size_t BB_SMEM_BYTES = SMEM_ALIGN + BEND_BWD_IMAGE_BYTES + BB_WORKERS * BB_WORKER_BYTES;
static_assert(BEND_BWD_IMAGE_BYTES % 1024 == 0 && BBW_RH0 % 512 == 0 && BBW_BH % 1024 == 0 &&
                  BBW_LAT64 % 1024 == 0 && BBW_BX % 1024 == 0 && BBW_BD % 1024 == 0,
              "the swizzled tiles on their atoms' alignment");
static_assert(BB_SMEM_BYTES <= SMEM_LIMIT && BB_CTAS_PER_SM * (BB_SMEM_BYTES + 1024) <= SM_SMEM,
              "row 8's CTAs fit an SM");
static_assert((BBW_SG + SG_ROB * 4) % 8 == 0 && SG_ROB + 2 <= SG_BB, "rob's f64 sum");

// where the worker's CUDA-core sum i goes in the pack-order layout
__device__ __forceinline__ int bend_sg_offset(int i) {
  if (i < SG_R0B) return G_R0W + (i - SG_R0W);
  if (i < SG_R1W) return G_R0B + (i - SG_R0B);
  if (i < SG_R1B) return G_R1W + (i - SG_R1W);
  if (i < SG_ROW) return G_R1B + (i - SG_R1B);
  if (i < SG_ROB) return G_ROW + (i - SG_ROW) * BEND_WPAD;
  if (i == SG_ROB) return G_ROB;
  if (i < SG_BB) return -1;   // padding
  if (i < SG_B0P) {
    const int l = (i - SG_BB) / BEND_W, c = (i - SG_BB) % BEND_W;
    return (l == 0 ? G_B0B : l == 1 ? G_B1B : l == 2 ? G_B2B : G_B3B) + c;
  }
  if (i < SG_BOW) return G_B0P + (i - SG_B0P);
  return G_BOW + ((i - SG_BOW) / 3) * BEND_WPAD + (i - SG_BOW) % 3;
}

// an element of a bf16 tile in shared memory (a generic pointer: the
// compiler may batch these loads, which the barriers order)
__device__ __forceinline__ float bf16_at(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(p));
}

// acc's values are dead: zero them, so that the compiler keeps no registers
// for them between products (a product's first k-step reads them)
__device__ __forceinline__ void clear_acc(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
}

// One bending layer back, l = 3, 2, 1, in one commit group: gw += act^T @ g
// (act = bh_{l-1}, g = dbh_l, both MN-major), the tile's g^T @ bx (column 0
// of bx is ones: the bias gradient, added to sgb[0 .. 63]), acc = g @ W^T
// (w: b_lw's rows of the forward image, MN-major). Every warp's part of the
// products reads all of act's rows, so a barrier passes before dbh_{l-1} =
// bf16(acc * (bh_{l-1} > 0)) goes over bh_{l-1}, each thread its own
// values; then another.
__device__ __forceinline__ void bend_back_layer(float (&acc)[32], float (&gw)[32], float* sgb,
                                                uint32_t act, uint32_t g, uint32_t w,
                                                uint32_t bx, int bar, int t) {
  float gb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  clear_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
    wgmma_m64n64_mn(gw, desc_mn_sw128(act + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES),
                    desc_mn_sw128(g + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES), 1);
  }
#pragma unroll
  for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
    wgmma_m64n8_ta(gb, desc_mn_sw128(g + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES),
                   desc_sw128(bx + kk * 32), kk != 0);
  }
#pragma unroll
  for (int kk = 0; kk < BEND_W / 16; ++kk) {
    wgmma_m64n64_tb(acc, desc_sw128(g + kk * 32),
                    desc_mn_sw128(w + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES), kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(gw);
  fence_acc(gb);
  fence_acc(acc);
  const int lane = t % 32;
  const int rw = (t / 32) * 16 + lane / 4;
  const int q = lane % 4;
  if (q == 0) {   // column 0: rows rw, rw + 8
    sgb[rw] += gb[0];
    sgb[rw + 8] += gb[2];
  }
  bar_sync128(bar);   // every warp's products have read act
#pragma unroll
  for (int j = 0; j < BEND_W / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t a = act + tile_offset(rw + 8 * h, 8 * j + 2 * q);
      const uint32_t m = ld_shared32(a);
      st_shared32(a, pack_bf16(bf16_lo(m) > 0.0f ? acc[4 * j + 2 * h] : 0.0f,
                               bf16_hi(m) > 0.0f ? acc[4 * j + 2 * h + 1] : 0.0f));
    }
  }
  fence_proxy_async();
  bar_sync128(bar);
}

__global__ void __launch_bounds__(BB_THREADS, BB_CTAS_PER_SM)
bend_bwd_sm90_kernel(const BendWeights bw, const float* __restrict__ pts,
                     const float* __restrict__ lat, const float* __restrict__ demb,
                     const float* __restrict__ doff, const float* __restrict__ drig, int n,
                     int n_blocks, float* __restrict__ partials, float* __restrict__ dpts,
                     float* __restrict__ dlat) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  const uint32_t img = smem_u32(base);
  const unsigned char* imgp = base;
  const int wid = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  unsigned char* wb = base + BEND_BWD_IMAGE_BYTES + wid * BB_WORKER_BYTES;
  const uint32_t ws = smem_u32(wb);
  const uint32_t lat_t = ws + BBW_LAT, lat64 = ws + BBW_LAT64;
  const uint32_t bh0 = ws + BBW_BH, bh1 = bh0 + WG_ATOM_BYTES, bh2 = bh1 + WG_ATOM_BYTES,
                 bh3 = bh2 + WG_ATOM_BYTES;
  const uint32_t bx = ws + BBW_BX, bd = ws + BBW_BD;
  const unsigned char* rh0p = wb + BBW_RH0;   // 64-byte swizzle
  const bf16* rh1p = reinterpret_cast<const bf16*>(wb + BBW_RH1);   // row-major (64, 32)
  bf16* drhp = reinterpret_cast<bf16*>(wb + BBW_DRH);
  float* rf = reinterpret_cast<float*>(wb + BBW_ROWS);
  float* sg = reinterpret_cast<float*>(wb + BBW_SG);

  stage_bend_image(img, bw, true, threadIdx.x, BB_THREADS);
  // the worker's constant parts: lanes 32 .. 63 of lat64, bx's row 0 (ones)
  // and rows 4 .. 7, bd's rows 3 .. 7 (zero); its sums
  for (int i = t; i < WG_ROWS * 4; i += 128) {
    st_shared16(lat64 + tile_offset(i / 4, LAT_W + (i % 4) * 8), make_uint4(0u, 0u, 0u, 0u));
  }
  for (int i = t; i < 8 * 8; i += 128) {   // 16-byte pieces of the 8-row tiles' rows
    const int row = i / 8, piece = i % 8;
    const uint32_t one = row == 0 ? 0x3F803F80u : 0u;
    if (row == 0 || row >= 4) st_shared16(bx + row * ATOM_ROW_BYTES + piece * 16, make_uint4(one, one, one, one));
    if (row >= 3) st_shared16(bd + row * ATOM_ROW_BYTES + piece * 16, make_uint4(0u, 0u, 0u, 0u));
  }
  for (int i = t; i < SG_FLOATS; i += 128) sg[i] = 0.0f;
  fence_proxy_async();
  __syncthreads();

  float acc[32];
  float gw3[32], gw2[32], gw1[32], gl[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) gw3[i] = gw2[i] = gw1[i] = gl[i] = 0.0f;
  const int bar = BAR_WG0 + wid;
  const int lane = t % 32;
  const int rw = (t / 32) * 16 + lane / 4;   // the accumulators' first row (of 64)
  const int q = lane % 4;
  const long worker = long(blockIdx.x) * BB_WORKERS + wid;
  const long workers = long(gridDim.x) * BB_WORKERS;

#pragma unroll 1
  for (long b = worker; b < n_blocks; b += workers) {
    const long row0 = b * WG_ROWS;
    const long left = long(n) - row0;
    const int rows = int(left < WG_ROWS ? left : WG_ROWS);
    // demb's rows of the tile into the worker's staging tile (cp.async,
    // zero past n): the cosine loop below reads them there
#pragma unroll
    for (int i = t; i < WG_ROWS * EMB / 4; i += 128) {
      const int r = i / (EMB / 4);
      const bool valid = r < rows;
      cp_async16_zfill(ws + BBW_DEMB + 16 * i,
                       valid ? demb + size_t(row0 + r) * EMB + (i % (EMB / 4)) * 4 : demb, valid);
    }
    cp_async_commit();
    clear_acc(acc);
    // ---- the forward, as rows 7 and 9 run it
    bender_rows<BendLayout<BBW_RH0 - BBW_LAT, BBW_RH1 - BBW_LAT, BBW_BH - BBW_LAT,
                           WG_ATOM_BYTES>>(acc, img, GlobalBendRows{pts, lat, row0, n}, lat_t,
                                           bh3, bar, t,
                [&](int r, float th, float rig0) {
                  rf[BR_TH + r] = th;
                  rf[BR_RIG + r] = rig0;
                },
                [] {});
    // the points (f32, and bf16 into rows 1 .. 3 of bx), the offsets; lat
    // into lanes 0 .. 31 of lat64 (thread t: row t / 2, 16 lanes)
#pragma unroll 1
    for (int p = t; p < WG_ROWS * 3; p += 128) {
      const int r = p / 3, j = p % 3;
      const float x = r < rows ? __ldg(pts + size_t(row0) * 3 + p) : 0.0f;
      rf[BR_X + p] = x;
      rf[BR_OFF + p] = row_dot<BEND_W>(bh3, r, img + BIMG_BOWT + j * BEND_W * 2);
      *reinterpret_cast<bf16*>(wb + BBW_BX + tile_offset(1 + j, r)) = __float2bfloat16(x);
    }
    {
      const int r = t / 2, c = (t % 2) * 16;
      st_shared16(lat64 + tile_offset(r, c), ld_shared16(lat_t + sw64_offset(r, c)));
      st_shared16(lat64 + tile_offset(r, c + 8), ld_shared16(lat_t + sw64_offset(r, c + 8)));
    }
    cp_async_wait_all();
    bar_sync128(bar);   // the offsets are written, demb's rows have landed
    // ---- dbent: demb folded onto each coordinate, its own lane then its 20
    // sine lanes in ascending order. First every term demb * cos(pre) *
    // scale over its demb value (thread t: row t / 2, lanes 3 + 30 (t % 2)
    // .. + 29, three cosines at a time), then thread t the sums of (row,
    // coordinate) pairs t and t + 128, in order.
    {
      const int r = t / 2;
      float* dr = reinterpret_cast<float*>(wb + BBW_DEMB) + r * EMB;
      float bent[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        bent[j] = __fadd_rn(rf[BR_X + 3 * r + j], __fmul_rn(rf[BR_RIG + r], rf[BR_OFF + 3 * r + j]));
      }
#pragma unroll 1
      for (int m = 10 * (t % 2); m < 10 * (t % 2) + 10; ++m) {
        // lanes 3 + 3m + j: coordinate j times 2^(m / 2), a cosine lane (phase
        // pi / 2) for odd m: the image's P and phase, computed
        const float scale = __int_as_float((127 + m / 2) << 23);
        const float phase = m & 1 ? HALF_PI : 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int c = 3 + 3 * m + j;
          const float pre = __fadd_rn(__fmul_rn(bent[j], scale), phase);
          dr[c] = __fmul_rn(__fmul_rn(dr[c], cosf(pre)), scale);
        }
      }
    }
    bar_sync128(bar);
#pragma unroll 1
    for (int p = t; p < WG_ROWS * 3; p += 128) {
      const int r = p / 3, j = p % 3;
      const float* dr = reinterpret_cast<const float*>(wb + BBW_DEMB) + r * EMB;
      float s = dr[j];
#pragma unroll
      for (int m = 0; m < 20; ++m) s = __fadd_rn(s, dr[3 + 3 * m + j]);
      rf[BR_DBENT + p] = s;   // zero past n: demb's rows are zero there
    }
    bar_sync128(bar);
    // a row's doff_t = dbent * rig0 + doff (and bf16 into rows 0 .. 2 of
    // bd) and drig_raw = (drig + dbent . off) * 0.5 * (1 - t^2), rounded as
    // the JAX math rounds them
    if (t < WG_ROWS) {
      const int r = t;
      const bool in = r < rows;
      const float rig0 = rf[BR_RIG + r];
      float drig0 = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float db = rf[BR_DBENT + 3 * r + j];
        const float dof = in ? __ldg(doff + size_t(row0 + r) * 3 + j) : 0.0f;
        const float dt = __fadd_rn(__fmul_rn(db, rig0), dof);
        rf[BR_DOFFT + 3 * r + j] = dt;
        *reinterpret_cast<bf16*>(wb + BBW_BD + tile_offset(j, r)) = __float2bfloat16(dt);
        drig0 = __fadd_rn(drig0, __fmul_rn(db, rf[BR_OFF + 3 * r + j]));
      }
      const float d = __fadd_rn(in ? __ldg(drig + row0 + r) : 0.0f, drig0);
      const float th = rf[BR_TH + r];
      rf[BR_DRIG + r] = __fmul_rn(__fmul_rn(d, 0.5f), __fsub_rn(1.0f, __fmul_rn(th, th)));
    }
    fence_proxy_async();
    bar_sync128(bar);
    // ---- g_bow += bh3^T @ bf16(doff_t) on wgmma, while the rigidity's
    // backward runs on the CUDA cores
    float gbow[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
      wgmma_m64n8_ta(gbow, desc_mn_sw128(bh3 + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES),
                     desc_sw128(bd + kk * 32), kk != 0);
    }
    wgmma_commit();
    // g_row, g_rob; drh1 = bf16((bf16(drig_raw) x row) * (rh1 > 0)) (thread
    // t: row t / 2, lanes (t % 2) * 16 .. + 15)
    if (t < RIG_W) {
      float s = 0.0f;
#pragma unroll 8
      for (int r = 0; r < WG_ROWS; ++r) {
        s += __bfloat162float(rh1p[r * RIG_W + t]) * round_bf16(rf[BR_DRIG + r]);
      }
      sg[SG_ROW + t] += s;
    } else if (t == RIG_W) {
      // rob: a sum of every point's drig_raw, which cancel; in f64
      double s = 0.0;
      for (int r = 0; r < WG_ROWS; ++r) s += double(rf[BR_DRIG + r]);
      *reinterpret_cast<double*>(sg + SG_ROB) += s;
    }
    {
      const int r = t / 2;
      const float d = round_bf16(rf[BR_DRIG + r]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (t % 2) * 16 + 8 * h;
        const uint4 mv = *reinterpret_cast<const uint4*>(rh1p + r * RIG_W + c);
        const uint4 wv = *reinterpret_cast<const uint4*>(imgp + BIMG_ROWT + c * 2);
        const uint32_t mp[4] = {mv.x, mv.y, mv.z, mv.w};
        const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = pack_bf16(bf16_lo(mp[e]) > 0.0f ? d * bf16_lo(wp[e]) : 0.0f,
                           bf16_hi(mp[e]) > 0.0f ? d * bf16_hi(wp[e]) : 0.0f);
        }
        *reinterpret_cast<uint4*>(drhp + r * RIG_W + c) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    bar_sync128(bar);
    // g_r1w[k][c] += sum_r rh0[r][k] drh1[r][c] (thread t: k = t / 4, c =
    // (t % 4) * 8 .. + 7); g_r1b
    {
      const int k = t / 4, c0 = (t % 4) * 8;
      float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int r = 0; r < WG_ROWS; ++r) {
        const float a = bf16_at(rh0p + sw64_offset(r, k));
        const uint4 dv = *reinterpret_cast<const uint4*>(drhp + r * RIG_W + c0);
        const uint32_t dp[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * e] += a * bf16_lo(dp[e]);
          s[2 * e + 1] += a * bf16_hi(dp[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sg[SG_R1W + k * RIG_W + c0 + e] += s[e];
      if (t < RIG_W) {
        float sb = 0.0f;
#pragma unroll 8
        for (int r = 0; r < WG_ROWS; ++r) sb += __bfloat162float(drhp[r * RIG_W + t]);
        sg[SG_R1B + t] += sb;
      }
    }
    bar_sync128(bar);
    // drh0 = bf16((drh1 @ r1w^T) * (rh0 > 0)) over rh0 (thread t: row t / 2,
    // lanes (t % 2) * 16 .. + 15, 8 at a time; r1w^T's rows are the image's
    // r1w rows)
    {
      const int r = t / 2;
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const int i0 = (t % 2) * 16 + 8 * h;
        float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
        for (int o8 = 0; o8 < RIG_W / 8; ++o8) {
          const uint4 dv = *reinterpret_cast<const uint4*>(drhp + r * RIG_W + o8 * 8);
          const uint32_t dp[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = e % 2 ? bf16_hi(dp[e / 2]) : bf16_lo(dp[e / 2]);
            const uint4 wv =
                *reinterpret_cast<const uint4*>(imgp + BIMG_R1W + sw64_offset(o8 * 8 + e, i0));
            const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              s[2 * f] += d * bf16_lo(wp[f]);
              s[2 * f + 1] += d * bf16_hi(wp[f]);
            }
          }
        }
        uint4* a = reinterpret_cast<uint4*>(wb + BBW_RH0 + sw64_offset(r, i0));
        const uint4 mv = *a;
        const uint32_t mp[4] = {mv.x, mv.y, mv.z, mv.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = pack_bf16(bf16_lo(mp[e]) > 0.0f ? s[2 * e] : 0.0f,
                           bf16_hi(mp[e]) > 0.0f ? s[2 * e + 1] : 0.0f);
        }
        *a = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    bar_sync128(bar);
    // g_r0w (threads 0 .. 95: j = t / 32, c = t % 32), g_r0b (96 .. 127);
    // dpts_rig = drh0 @ r0w^T (pairs)
    if (t < 3 * RIG_W) {
      const int j = t / RIG_W, c = t % RIG_W;
      float s = 0.0f;
#pragma unroll 8
      for (int r = 0; r < WG_ROWS; ++r) {
        s += round_bf16(rf[BR_X + 3 * r + j]) * bf16_at(rh0p + sw64_offset(r, c));
      }
      sg[SG_R0W + j * RIG_W + c] += s;
    } else {
      const int c = t - 3 * RIG_W;
      float s = 0.0f;
#pragma unroll 8
      for (int r = 0; r < WG_ROWS; ++r) s += bf16_at(rh0p + sw64_offset(r, c));
      sg[SG_R0B + c] += s;
    }
#pragma unroll 1
    for (int p = t; p < WG_ROWS * 3; p += 128) {
      const int r = p / 3, j = p % 3;
      float s = 0.0f;
#pragma unroll
      for (int c8 = 0; c8 < RIG_W / 8; ++c8) {
        const uint4 av = *reinterpret_cast<const uint4*>(rh0p + sw64_offset(r, c8 * 8));
        const uint4 wv = *reinterpret_cast<const uint4*>(imgp + BIMG_R0W + 2 * (j * RIG_W + c8 * 8));
        const uint32_t ap[4] = {av.x, av.y, av.z, av.w};
        const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s += bf16_lo(ap[e]) * bf16_lo(wp[e]);
          s += bf16_hi(ap[e]) * bf16_hi(wp[e]);
        }
      }
      rf[BR_DPRIG + p] = s;
    }
    // ---- g_bow's products are done (every warp's: they read all of bh3);
    // then dbh3 = bf16((bf16(doff_t) @ bow^T) * (bh3 > 0)) over bh3 (thread
    // t: row t / 2, lanes (t % 2) * 32 .. + 31)
    wgmma_wait<0>();
    fence_acc(gbow);
    if (q < 2) {   // columns 2q, 2q + 1 = j of rows rw, rw + 8
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sg[SG_BOW + (rw + 8 * h) * 3 + 2 * q] += gbow[2 * h];
        if (q == 0) sg[SG_BOW + (rw + 8 * h) * 3 + 1] += gbow[2 * h + 1];
      }
    }
    bar_sync128(bar);
    {
      const int r = t / 2;
      float db[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) db[j] = round_bf16(rf[BR_DOFFT + 3 * r + j]);
      const bf16* bowt = reinterpret_cast<const bf16*>(imgp + BIMG_BOWT);
#pragma unroll 1
      for (int pc = 0; pc < 4; ++pc) {
        const int c0 = (t % 2) * 32 + pc * 8;
        uint4* a = reinterpret_cast<uint4*>(wb + BBW_BH + 3 * WG_ATOM_BYTES + tile_offset(r, c0));
        const uint4 mv = *a;
        const uint32_t mp[4] = {mv.x, mv.y, mv.z, mv.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = c0 + 2 * e + hh;
            float s = 0.0f;
#pragma unroll
            for (int j = 0; j < 3; ++j) s += db[j] * __bfloat162float(bowt[j * BEND_W + c]);
            v[hh] = s;
          }
          o[e] = pack_bf16(bf16_lo(mp[e]) > 0.0f ? v[0] : 0.0f,
                           bf16_hi(mp[e]) > 0.0f ? v[1] : 0.0f);
        }
        *a = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    fence_proxy_async();
    bar_sync128(bar);
    // ---- the bending layers back on wgmma
    bend_back_layer(acc, gw3, sg + SG_BB + 3 * BEND_W, bh2, bh3,
                    img + BIMG_BW + 2 * BEND_W * BEND_W * 2, bx, bar, t);
    bend_back_layer(acc, gw2, sg + SG_BB + 2 * BEND_W, bh1, bh2,
                    img + BIMG_BW + BEND_W * BEND_W * 2, bx, bar, t);
    bend_back_layer(acc, gw1, sg + SG_BB + BEND_W, bh0, bh1, img + BIMG_BW, bx, bar, t);
    // layer 0: g_b0l += lat64^T @ dbh0; g_b0b and g_b0p^T += dbh0^T @ [1,
    // bf16(pts)]; dlat = dbh0 @ b0l^T
    float gb0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    clear_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
      wgmma_m64n64_mn(gl, desc_mn_sw128(lat64 + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES),
                      desc_mn_sw128(bh0 + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES), 1);
    }
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
      wgmma_m64n8_ta(gb0, desc_mn_sw128(bh0 + kk * 16 * ATOM_ROW_BYTES, WG_ATOM_BYTES),
                     desc_sw128(bx + kk * 32), kk != 0);
    }
#pragma unroll
    for (int kk = 0; kk < BEND_W / 16; ++kk) {
      wgmma_m64n32(acc, desc_sw128(bh0 + kk * 32), desc_sw128(img + BIMG_B0L_ROWS + kk * 32),
                   kk != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(gl);
    fence_acc(gb0);
    fence_acc<16>(acc);
    // columns 2q, 2q + 1 of rows rw, rw + 8: column 0 g_b0b, 1 .. 3 g_b0p^T
    if (q < 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * q + e, row = rw + 8 * h;
          sg[col == 0 ? SG_BB + row : SG_B0P + (col - 1) * BEND_W + row] += gb0[2 * h + e];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LAT_W / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + 8 * h;
        if (row < rows) {
          *reinterpret_cast<float2*>(dlat + size_t(row0 + row) * LAT_W + 8 * j + 2 * q) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
    // dpts = (dbent + dpts_rig) + dbh0 @ b0p^T (pairs, rows below n)
#pragma unroll 1
    for (int p = t; p < WG_ROWS * 3; p += 128) {
      const int r = p / 3, j = p % 3;
      if (r >= rows) break;
      const float s = row_dot<BEND_W>(bh0, r, img + BIMG_B0P + j * BEND_W * 2);
      dpts[size_t(row0) * 3 + p] = __fadd_rn(__fadd_rn(rf[BR_DBENT + p], rf[BR_DPRIG + p]), s);
    }
  }

  // ---- the CTA's partial: zeroed, then each worker's sums added in order
  __syncthreads();
  float* out = partials + size_t(blockIdx.x) * BEND_GRAD_FLOATS;
  for (int i = threadIdx.x; i < BEND_GRAD_FLOATS; i += BB_THREADS) out[i] = 0.0f;
  __syncthreads();
#pragma unroll 1
  for (int w = 0; w < BB_WORKERS; ++w) {
    if (wid == w) {
#pragma unroll
      for (int j = 0; j < BEND_W / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = rw + 8 * h, col = 8 * j + 2 * q + e, a = 4 * j + 2 * h + e;
            out[G_B3W + row * BEND_W + col] += gw3[a];
            out[G_B2W + row * BEND_W + col] += gw2[a];
            out[G_B1W + row * BEND_W + col] += gw1[a];
            if (row < LAT_W) out[G_B0L + row * BEND_W + col] += gl[a];
          }
        }
      }
      for (int i = t; i < SG_FLOATS; i += 128) {
        const int o = bend_sg_offset(i);
        if (o >= 0 && i != SG_ROB) out[o] += sg[i];
      }
      if (t == 0) out[G_ROB] += float(*reinterpret_cast<const double*>(sg + SG_ROB));
    }
    __syncthreads();
  }
}

// the CTAs of row 8's kernel for n points: one partial gradient each
inline int bend_bwd_grid(int n) {
  return bend_grid((n + WG_ROWS - 1) / WG_ROWS, BB_WORKERS, BB_CTAS_PER_SM);
}

// The bender's backward on `stream`: bend_bwd_sm90_kernel's partials, then
// their fixed-order sum into grads (BEND_GRAD_FLOATS f32, pack order).
// weights: the 18 cast bender weights (BendWeights), which the kernel stages
// as the backward image (pack_bend_image(bw, backward=True)); partials:
// bend_bwd_grid(n) * BEND_GRAD_FLOATS f32.
// Returns the CUDA error code of the first failing call (0 on success).
inline int launch_bend_backward(const void* const* weights, const float* pts, const float* lat,
                                const float* demb, const float* doff, const float* drig,
                                int n, float* partials, float* dpts, float* dlat,
                                float* grads, cudaStream_t stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bend_bwd_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(BB_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  BendWeights bw;
  for (int i = 0; i < 18; ++i) bw.w[i] = weights[i];
  const int grid = bend_bwd_grid(n);
  bend_bwd_sm90_kernel<<<grid, BB_THREADS, BB_SMEM_BYTES, stream>>>(
      bw, pts, lat, demb, doff, drig, n,
      (n + WG_ROWS - 1) / WG_ROWS, partials, dpts, dlat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  mlp_reduce_kernel<<<(BEND_GRAD_FLOATS + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS,
                      0, stream>>>(partials, grid, BEND_GRAD_FLOATS, grads);
  return int(cudaGetLastError());
}

}  // namespace sm90
