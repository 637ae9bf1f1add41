// The chain of the canonical 8 x 256 NeRF MLP on Hopper's own machinery
// (sm_90a), for mlp_fwd.cu (row 1) and mlp_bwd.cu's chain kernel (row 2), at
// an encoding of E = 64 or 128 lanes. The other canonical-MLP kernels keep
// mlp_tile.cuh's design.
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
//   transposed steps dh @ W^T are m64n64k16 over 64-column chunks.
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
// - The backward (mlp_bwd.cu) keeps each layer's ReLU gates as bits, moves
//   its bf16 scratch (the encoding copy, nh and dh) between the swizzled
//   tiles and global memory with TMA bulk tensor copies in boxes of 64 rows x
//   64 lanes, and runs its dW products on MN-major wgmma (wgmma_m64n256_mn).
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

// keeps the compiler from moving reads or writes of the accumulators across
// a wgmma issue or wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- products: d (+)= A (64 x 16, K-major) @ B (16 x N, K-major), scale_d 0
// overwrites d

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

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                    int scale_d) {
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

// the producer: every chunk of the schedule for every tile of this CTA
template <int S>
__device__ __forceinline__ void produce(const bf16* __restrict__ image, int n_chunks,
                                        int n_tiles, uint32_t ring, uint32_t bars) {
  uint32_t g = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int c = 0; c < n_chunks; ++c, ++g) {
      const uint32_t s = g % S;
      mbar_wait(bars + 8 * (S + s), ((g / S) & 1) ^ 1);   // the stage is free
      mbar_expect_tx(bars + 8 * s, CHUNK_BYTES);
      bulk_load(ring + s * CHUNK_BYTES, image + size_t(c) * CHUNK_ELEMS, CHUNK_BYTES,
                bars + 8 * s);
    }
  }
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
// (l - 1) * n_pad
struct ScratchMaps {
  CUtensorMap emb;
  CUtensorMap nh;
  CUtensorMap dh;
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
// bf16 encoding into the swizzled encoding tile; rows past n are zero
template <int E>
__device__ __forceinline__ void load_emb_rows(uint32_t embt, const bf16* __restrict__ emb,
                                              long row0, int n, int wg, int t) {
  constexpr int PIECES = E / 8;   // 16-byte pieces per row
  for (int i = t; i < WG_ROWS * PIECES; i += 128) {
    const int r = wg * WG_ROWS + i / PIECES;
    const int q = i % PIECES;
    const bool valid = row0 + r < n;
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
// bf16(relu(acc + bias)) into this warpgroup's rows of the activation tile,
// which the layer's products have finished reading. With `gate`, the ReLU
// gates (value > 0) of this thread's 128 values as 4 words: word j / 8, bit
// (j % 8) * 4 + 2h + e for row +8h, column +e of group j.
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
      const float v0 = fmaxf(acc[4 * j + 2 * h] + b.x, 0.0f);
      const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b.y, 0.0f);
      const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
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

// nh1 .. nh8 of this warpgroup's rows of the tile, chunks g .. g +
// n_fwd_chunks<E> - 1; the encoding tile must have landed (and a barrier
// passed). `act` ends as nh8, and the warpgroup's barrier has passed.
// With `maps` (the backward) thread 0 stores every layer to the nh scratch
// (rows row0 + wg * 64 .. of layer l at (l - 1) * n_pad) with bulk tensor
// stores, and `gates` receives nh1 .. nh7's ReLU gates (4 words each).
// `after_skip()` runs once layer 5 has read the encoding tile.
//   nh1 = bf16(relu(emb @ n0w + n0b));  nh2..nh5, nh7, nh8 alike;
//   nh6 = bf16(relu(nh5 @ n5h + emb @ n5e + n5b))
template <int S, int E, class AfterSkip>
__device__ __forceinline__ void chain_tile(unsigned char* act, uint32_t embt,
                                           const float* const* bias, uint32_t ring,
                                           uint32_t bars, uint32_t& g, int wg, int t,
                                           const ScratchMaps* maps, long n_pad, long row0,
                                           uint32_t (*gates)[4], AfterSkip&& after_skip) {
  const uint32_t act_s = smem_u32(act);
  float acc[128];
#pragma unroll 1
  for (int layer = 0; layer < N_LAYERS; ++layer) {
    layer_products<S, E>(acc, layer, act_s, embt, ring, bars, g, wg, t == 0);
    if (maps != nullptr) {   // the last layer's store has read the tile
      if (t == 0) bulk_wait_read<0>();
      wg_barrier(wg);
    }
    layer_epilogue(acc, bias[layer], act,
                   gates != nullptr && layer < N_LAYERS - 1 ? gates[layer] : nullptr, wg, t);
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

// issue this warpgroup's products of cur (128 x 256, the activation layout)
// times chunk g's W[i0 : i0 + 64, :]^T: 64 output columns, K = 256, one
// commit group
template <int S>
__device__ __forceinline__ void nt_issue(float (&acc)[32], uint32_t cur, uint32_t ring,
                                         uint32_t bars, uint32_t g, int wg) {
  const uint32_t rows = uint32_t(wg) * WG_ROWS * ATOM_ROW_BYTES;
  const uint32_t b = ring_acquire<S>(ring, bars, g);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < NW / 16; ++k) {
    const uint32_t atom = k / 4, kk = k % 4;
    wgmma_m64n64(acc, desc_sw128(cur + atom * TILE_ATOM_BYTES + rows + kk * 32),
                 desc_sw128(b + atom * BWD_ATOM_BYTES + kk * 32), k != 0);
  }
  wgmma_commit();
}

// dh_l's columns c*64 .. +64 for this warpgroup's rows: bf16(acc * gate)
// into `oth`. `gate` is word c of nh_l's gates that this thread's layer
// epilogue kept: the forward's and this chunk's accumulator layouts give a
// thread the same rows and columns (group j of the chunk is group 8c + j).
__device__ __forceinline__ void dh_epilogue(const float (&acc)[32], uint32_t gate, int c,
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

// demb's columns c*64 .. +64 (f32, no mask) for this warpgroup's rows of the
// tile's (rows_left, E) block: stored, or added to what is there
template <int E>
__device__ __forceinline__ void demb_epilogue(const float (&acc)[32], int c, float* demb,
                                              long rows_left, bool add, int wg, int t) {
  const int lane = t % 32;
  const int r0 = wg * WG_ROWS + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const int col = c * KC + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= rows_left) continue;
      float2* dst = reinterpret_cast<float2*>(demb + size_t(row) * E + col);
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
// of cur @ W^T, each chunk's products then its epilogue (the other
// warpgroup's products overlap it). With `gate` (nh_l's 4 words): dh_l into
// `oth`; else demb, stored or added. (Two accumulators in flight, one
// chunk's products under the other's epilogue, measured slower on the
// H100: the registers they take spill.)
template <int S, int E, int N>
__device__ __forceinline__ void dh_step(uint32_t cur, unsigned char* oth, const uint32_t* gate,
                                        float* demb, long rows_left, bool add, uint32_t ring,
                                        uint32_t bars, uint32_t& g, int wg, int t) {
  float acc[32];
#pragma unroll 1
  for (int c = 0; c < N; ++c, ++g) {
    nt_issue<S>(acc, cur, ring, bars, g, wg);
    wgmma_wait<0>();
    fence_acc(acc);
    ring_release<S>(bars, g, t == 0);
    if (gate != nullptr) {
      dh_epilogue(acc, gate[c], c, oth, wg, t);
    } else {
      demb_epilogue<E>(acc, c, demb, rows_left, add, wg, t);
    }
  }
}

// the layer l whose dh_l a backward step produces (its mask is nh_l), or 0
// for the two products that give demb; steps read n7w n6w n5e n5h n4w n3w
// n2w n1w n0w
__device__ __forceinline__ int bwd_layer(int step) {
  return step == 0 ? 7 : step == 1 ? 6 : step == 2 ? 0 : step == 8 ? 0 : 8 - step;
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

}  // namespace sm90
