// The chain of the canonical 8 x 256 NeRF MLP on Hopper's own machinery
// (sm_90a), for mlp_fwd.cu (row 1) and the backwards mlp_bwd.cu (row 2, at an
// encoding of E = 64 or 128 lanes), mlpe_bwd.cu (row 6) and mlpv_bwd.cu (row
// 4). It holds the kernels rows 2 and 6 share (the chain kernel, a template
// on its input) and the second pass all three backwards launch. The other
// canonical-MLP kernels keep mlp_tile.cuh's design.
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
//   transposed steps dh @ W^T are m64n64k16 over 64-column chunks (row 4's
//   view-direction heads add m64n128k16 and m64n32k16).
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
//   tile's last products.
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

template <int E>
constexpr size_t fwd_smem_bytes =
    SMEM_ALIGN + ACT_BYTES + emb_tile_bytes<E> + FWD_STAGES * CHUNK_BYTES + BAR_BYTES;
// two activation tiles (the encoding tile lives in the second until dh8)
constexpr size_t BWD_SMEM_BYTES =
    SMEM_ALIGN + 2 * ACT_BYTES + BWD_STAGES * CHUNK_BYTES + BAR_BYTES;
static_assert(fwd_smem_bytes<64> <= SMEM_LIMIT && fwd_smem_bytes<128> <= SMEM_LIMIT,
              "the forward fits one Hopper CTA at both widths");
static_assert(BWD_SMEM_BYTES <= SMEM_LIMIT, "the backward fits one Hopper CTA");
static_assert(emb_tile_bytes<128> <= ACT_BYTES,
              "the encoding tile fits the second activation tile at both widths");
static_assert(2 * 8 * (FWD_STAGES > BWD_STAGES ? FWD_STAGES : BWD_STAGES) <= BAR_BYTES,
              "the ring's barriers fit");

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
// Chunk c sits at c * CHUNK_ELEMS of the image and `bytes(c)` of it (a
// multiple of 16, at most CHUNK_BYTES) are copied: the byte count the stage
// expects is the copy's, or the consumers wait for ever.
template <int S, class Bytes>
__device__ __forceinline__ void produce(const bf16* __restrict__ image, int n_chunks,
                                        int n_tiles, uint32_t ring, uint32_t bars,
                                        Bytes&& bytes) {
  uint32_t g = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int c = 0; c < n_chunks; ++c, ++g) {
      const uint32_t s = g % S;
      const uint32_t nb = bytes(c);
      mbar_wait(bars + 8 * (S + s), ((g / S) & 1) ^ 1);   // the stage is free
      mbar_expect_tx(bars + 8 * s, nb);
      bulk_load(ring + s * CHUNK_BYTES, image + size_t(c) * CHUNK_ELEMS, nb, bars + 8 * s);
    }
  }
}

// ... every chunk whole
template <int S>
__device__ __forceinline__ void produce(const bf16* __restrict__ image, int n_chunks,
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

// raw[p, o] = sum_k nh8[p, k] * ow[k, o] + ob[o] in f32 for this warpgroup's
// rows: two threads per point, 4 lanes each, k ascending. Rows past n are not
// stored.
__device__ __forceinline__ void raw_head(const unsigned char* act, const bf16* __restrict__ ow,
                                         const float* __restrict__ ob,
                                         float* __restrict__ out, long row0, int n, int wg,
                                         int t) {
  const int pt = wg * WG_ROWS + t / 2;
  const int o0 = (t % 2) * 4;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
  for (int q = 0; q < NW / 8; ++q) {
    const uint4 v = *reinterpret_cast<const uint4*>(act + tile_offset(pt, q * 8));
    const bf16* a = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = __bfloat162float(a[e]);
      const uint2 wv = __ldg(reinterpret_cast<const uint2*>(ow + (q * 8 + e) * OUT + o0));
      const bf16* w = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += x * __bfloat162float(w[i]);
    }
  }
  if (row0 + pt < n) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(ob + o0));
    *reinterpret_cast<float4*>(out + size_t(row0 + pt) * OUT + o0) =
        make_float4(s[0] + b.x, s[1] + b.y, s[2] + b.z, s[3] + b.w);
  }
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

// ---- the single-head backward's chain kernel: mlp_bwd.cu (row 2) on the
// encoding, mlpe_bwd.cu (row 6) on points

struct ChainArgs {
  const float* bias[N_LAYERS];   // (256,) f32 per hidden layer
  const bf16* ow;                // (256, 8) bf16
};

// mlp_bwd.cu's input: the (n, E) bf16 encoding, loaded into the encoding
// tile by cp.async (the next tile's during the last step of the dh chain);
// demb (n, E) f32 goes to global memory as it comes.
template <int E>
struct EncodingIn {
  const bf16* emb;
  float* demb;

  __device__ __forceinline__ void first(uint32_t embt, long row0, int n, int wg, int t) {
    next(embt, row0, n, wg, t);
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

// mlpe_bwd.cu's input: points (n, 3) f32 and the encoding's projection P
// (3, 64) and phase (64,) f32, whose entries are 0 or powers of two. Thread
// t encodes row wg * 64 + t / 2, lanes (t % 2) * 32 .. + 32, of the tile:
//   pre = x0 * P[0] + x1 * P[1] + x2 * P[2]   (three f32 FMAs, exact)
//   emb = bf16(lane < 3 ? pre : sinf(pre + phase)),  zero past n;
// its point is loaded into registers one tile ahead. demb never reaches
// HBM: each value of the two products the dh chain hands over (in the
// accumulator layout) is folded onto its point,
//   dpts[:, d] += (lane < 3 ? demb : demb * cosf(pre + phase)) * P[d],
// summed by the thread per row and coordinate, the two products one after
// the other (the fold is linear), then over the four threads that share a
// row by a fixed-order shuffle: bit-equal from run to run.
struct PtsIn {
  static constexpr int LANES = 64;
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
    const int r = wg * WG_ROWS + t / 2;
    const bool valid = row0 + r < n;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c0 = (t % 2) * 32 + q * 8;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + e;
        const float pre = fmaf(x[2], __ldg(P + 2 * LANES + c),
                               fmaf(x[1], __ldg(P + LANES + c), x[0] * __ldg(P + c)));
        const float y = c < 3 ? pre : sinf(pre + __ldg(phase + c));
        v[e] = __float2bfloat16(valid ? y : 0.0f);
      }
      *reinterpret_cast<uint4*>(embt + tile_offset(r, c0)) = *reinterpret_cast<const uint4*>(v);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) d[h][0] = d[h][1] = d[h][2] = 0.0f;
  }
  __device__ __forceinline__ void next(uint32_t, long row0, int n, int wg, int t) {
    if (row0 < 0) return;
    const long r = row0 + wg * WG_ROWS + t / 2;
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = r < n ? __ldg(pts + size_t(r) * 3 + k) : 0.0f;
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
        const float p0 = __ldg(P + col), p1 = __ldg(P + LANES + col);
        const float p2 = __ldg(P + 2 * LANES + col), ph = __ldg(phase + col);
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
      if (t == 0) store_rows(&maps.emb, b_s, E / BOX, wrow, wg);

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
constexpr int SUM_GROUPS = 4;       // mlp_tile.cuh's SMALL_GROUPS
constexpr int MAX_DW_JOBS = 40;
constexpr uint32_t DW_A_BYTES = BOX_BYTES;                   // 64 points x 64 act lanes
constexpr uint32_t DW_B_BYTES = (NW / BOX) * BOX_BYTES;      // 64 points x 256 dh lanes
constexpr uint32_t DW_STAGE_BYTES = DW_A_BYTES + DW_B_BYTES;
constexpr size_t DW_SMEM_BYTES = SMEM_ALIGN + DW_STAGES * DW_STAGE_BYTES + BAR_BYTES;
static_assert(2 * DW_SMEM_BYTES <= SMEM_LIMIT, "two dW CTAs share an SM");
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
  // the column sums in mlp_tile.cuh's order (mlp_small_kernel): SUM_GROUPS
  // partial sums, point p of the split into sum p % SUM_GROUPS, added in
  // ascending order at the end, so mlp_bwd's bias gradients are bit-equal to
  // those of the kernels that keep that second pass (fused_bwd.cu)
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
// and the groups are added in order: the order of mlp_tile.cuh's head job.
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
// splits, which the caller launches (mlp_tile.cuh's mlp_reduce_kernel): the
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

// Rows 2 and 6 but for the reduction over the splits (the caller's): the
// chain kernel on the input `in` (EncodingIn<E> or PtsIn), then the second
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

}  // namespace sm90
