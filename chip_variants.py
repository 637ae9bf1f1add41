#!/usr/bin/env python3
"""Time variants of rows 1-3, 5, 7-9 and 11's CUDA sources on one NVIDIA GPU.

    python3 chip_variants.py                  # every variant below
    python3 chip_variants.py base no_epilogue_stores
    python3 chip_variants.py base fused_bender_in_registers fused_bender_on_encoders
    python3 chip_variants.py --steps OTHER    # training steps, two trees
    python3 chip_variants.py --steps OTHER I  # int8 frames and mlp_i8, two trees
    python3 chip_variants.py --steps OTHER F B R  # and the flagship, the baseline, row 9

A variant is a list of text substitutions applied to a copy of
`nonrigid_nerf_torch/ops/kernels/csrc/` (the sources in this checkout stay
as they are; a substitution whose text is a pair (start, end) replaces
everything from start up to end). Each copy's `mlp_fwd.cu`, `mlp_bwd.cu`,
`mlpv_fwd.cu`, `mlpe_fwd.cu`, `mlp_i8.cu`, `fused_fwd.cu`, `fused_bwd.cu`,
`bend_fwd.cu` and `bend_bwd.cu` (a variant of row 11: `mlp_i8.cu` alone; of
row 9: `fused_fwd.cu` alone; of rows 7 and 8: `bend_fwd.cu` and `bend_bwd.cu`)
are built with the port's nvcc flags, one nvcc per source and all started
together, into a temporary directory; a variant that does not build is
reported and skipped. Then, one child process per variant
(so that a variant that hangs is cut off after `CHILD_TIMEOUT_S` without
taking the others with it), the script:

- times `bend_fwd` (row 7) at 2^21 and 65,536 points and `bend_bwd` (row
  8) at 65,536 and 131,072, and for a variant of rows 7 and 8 nothing else;
- times `mlp_i8` at a render block's two passes (2^21 and 2^22 points), and
  for a variant of row 11 nothing else;
- times `fused_fwd` (row 9) at 2^21 and 65,536 points and `fused_bwd` (row
  10) at 65,536 and 131,072, row 10 by kernel, on the flagship's fine
  network with its deformation perturbed (a variant of row 9: row 9
  alone), through the port's wrappers on the variant's libraries;
- times `mlp_fwd` at a render block's coarse pass (2^21 points) and a
  training step's (65,536) and `mlp_bwd` at a training step's two passes
  (65,536 and 131,072), at the 64-lane and the 128-lane encoding, and
  `mlpv_fwd` and `mlpe_fwd` at 2^21 and 65,536 points, as the device time
  of each kernel under torch.profiler over 5 calls, twice (a variant of
  rows 3 and 5 alone times those two and row 1 at 64 lanes);
- holds the variant's outputs against the plain versions (a variant that
  cuts work out of a kernel is expected to disagree: it measures what that
  work costs).

It prints the card's name and power limit first and one line per variant,
size and repetition. It exits non-zero when no CUDA device is present.

With `--steps OTHER`, where OTHER is another checkout of the repository
(an unpacked `git archive` of another commit, say), it compares whole
frames and training steps instead: in turns OTHER, this checkout, this
checkout, OTHER, one child process each (each builds its own tree's
kernels), for the flagship with view directions (V) and in
`fused_kernel="pts"` mode (P), or the modes named after OTHER (also F, the
flagship as configured, and B, the time-conditioned baseline of
`results/r4_baseline_tc/args.txt`), it renders
`chip_smoke.py`'s two 384 x 512 frames through `render_path` (s per frame,
host clock, each ending in a copy to the host), trains on its synthetic
stack for 30 steps, times 50 more (steps/s, host clock), and profiles 5
(`chip_smoke.profile_run` of that tree: device ms a step, the card's idle
share, the top kernels). In `fused_kernel="int8"` mode (I), which does not
train, it calibrates on the first pose as `chip_smoke.py` does, renders the
frames and times the tree's `mlp_i8` at 2^21 and 2^22 points (CUDA events,
10 calls) on the coarse network's packed weights. R renders and trains
nothing: it times the tree's row 9 (`fused_fwd`) through its own wrapper,
device ms at 2^21 points and ms with the host at 65,536 (`time_row9`).
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "nonrigid_nerf_torch", "ops", "kernels", "csrc")
SOURCES = ("mlp_fwd.cu", "mlp_bwd.cu", "mlpv_fwd.cu", "mlpe_fwd.cu",
           "mlp_i8.cu", "fused_fwd.cu", "fused_bwd.cu", "bend_fwd.cu", "bend_bwd.cu")
CHILD_TIMEOUT_S = 180
# variants that change rows 3 and 5 only: the child times rows 3 and 5 and,
# as the yardstick, row 1 at 64 lanes
HEADS_ONLY = ("pts_encode_on_consumers", "pts_no_sines", "pts_no_encoding")
# variants that change row 11 only: the child times row 11 alone
I8_ONLY = ("i8_2_stages", "i8_quantize_on_consumers", "i8_head_on_cuda_cores")
# variants that change row 9 only: the child times row 9 alone
FUSED_ONLY = ("fused_bender_on_encoders", "fused_bender_in_registers",
              "fused_regs_216_72", "fused_no_sines", "fused_ahead_no_loads",
              "fused_ahead_no_products", "fused_ahead_handshake_only",
              "fused_no_offsets", "fused_zero_accumulators", "fused_parent_ahead")
# variants that change rows 7 and 8 only: the child times rows 7 and 8 alone
BEND_ONLY = ("bend_groups_2x2", "bend_groups_2x1", "bend_groups_1x2_2ctas",
             "bend_ring_1", "bend_encoders_64",
             "bend_bwd_workers_1", "bend_bwd_tiles_x2")

# row 9 with the consumers' `ahead` as it was before the bender became a
# function of its own: the deformation field's products inline in
# FusedFwdIn, not through `bender_rows` (the same arithmetic; what sharing
# the bender with rows 7, 8 and 10 costs)
INLINE_AHEAD = r"""  template <int R>
  __device__ __forceinline__ void ahead(float (&acc)[R], unsigned char* act, uint32_t emb0,
                                        uint32_t bars, uint32_t extra, int j, long row0, int n,
                                        int wg, int t) {
    const int slot = j % 2;
    const uint32_t act_s = smem_u32(act);
    const uint32_t lat_t = act_s + uint32_t(wg) * WG_ATOM_BYTES;   // atom 0
    const uint32_t rh0_t = lat_t + WG_ATOM_BYTES / 2;
    const uint32_t rh1_t = lat_t + TILE_ATOM_BYTES;                  // atom 1
    const uint32_t bh_t = lat_t + 2 * TILE_ATOM_BYTES;               // atom 2
    const uint32_t bh3_t = emb0 + uint32_t(slot) * TILE_ATOM_BYTES + uint32_t(wg) * WG_ATOM_BYTES;
    const int lane = t % 32;
    const int rw = (t / 32) * 16 + lane / 4;   // the accumulators' first row (of 64)

    wg_barrier(wg);   // the last tile's head has read the activation tile
    // ---- the A tiles: thread t takes row t / 2, lanes (t % 2) * 16 .. + 15 of
    // bf16(lat) and of rh0 = relu(bf16(pts) @ r0w + r0b)
    {
      const int r = t / 2, c0 = (t % 2) * 16;
      const long row = row0 + wg * WG_ROWS + r;
      const bool valid = row < n;
      float xb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) xb[k] = round_bf16(valid ? __ldg(pts + size_t(row) * 3 + k) : 0.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 8 * h;
        float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0;
        if (valid) {
          v0 = __ldg(reinterpret_cast<const float4*>(lat + size_t(row) * LAT_W + c));
          v1 = __ldg(reinterpret_cast<const float4*>(lat + size_t(row) * LAT_W + c + 4));
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
            const uint32_t wv = ld_shared32(extra + BIMG_R0W + 2 * (k * RIG_W + c + 2 * e));
            s[0] += xb[k] * bf16_lo(wv);
            s[1] += xb[k] * bf16_hi(wv);
          }
          w[e] = pack_bf16(
              fmaxf(__fadd_rn(s[0], ld_shared_f32(extra + BIMG_R0B + 4 * (c + 2 * e))), 0.0f),
              fmaxf(__fadd_rn(s[1], ld_shared_f32(extra + BIMG_R0B + 4 * (c + 2 * e + 1))),
                    0.0f));
        }
        st_shared16(rh0_t + sw64_offset(r, c), make_uint4(w[0], w[1], w[2], w[3]));
      }
    }
    // bf16(pts) of the accumulators' two rows, for bh0's pts @ b0p
    float xa[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = row0 + wg * WG_ROWS + rw + 8 * h;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xa[h][k] = round_bf16(row < n ? __ldg(pts + size_t(row) * 3 + k) : 0.0f);
      }
    }
    fence_proxy_async();
    wg_barrier(wg);

    // ---- rh1 = relu(rh0 @ r1w + r1b) (m64n32k16 x 2) into rh1_t
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RIG_W / 16; ++kk) {
      wgmma_m64n32(acc, desc_sw64(rh0_t + kk * 32), desc_sw64(extra + BIMG_R1W + kk * 32),
                   kk != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<16>(acc);
    bend_epilogue<RIG_W>(acc, extra + BIMG_R1B, t, [](int, int) { return 0.0f; },
                         [&](int h, int col, uint32_t v) {
                           st_shared32(rh1_t + uint32_t(rw + 8 * h) * (RIG_W * 2) + col * 2, v);
                         });
    // ---- bh0 = relu((pts @ b0p + lat @ b0l) + b0b) (m64n64k16 x 2) into bh_t
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < LAT_W / 16; ++kk) {
      wgmma_m64n64(acc, desc_sw64(lat_t + kk * 32), desc_sw64(extra + BIMG_B0L + kk * 32),
                   kk != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<32>(acc);
    bend_epilogue<BEND_W>(acc, extra + BIMG_BB, t,
                          [&](int h, int col) {
                            const uint32_t pair = extra + BIMG_B0P + 2 * (col & ~1);
                            float s = 0.0f;
#pragma unroll
                            for (int k = 0; k < 3; ++k) {
                              const uint32_t wv = ld_shared32(pair + 2 * k * BEND_W);
                              s += xa[h][k] * (col & 1 ? bf16_hi(wv) : bf16_lo(wv));
                            }
                            return s;
                          },
                          [&](int h, int col, uint32_t v) {
                            st_shared32(bh_t + tile_offset(rw + 8 * h, col), v);
                          });
    fence_proxy_async();
    wg_barrier(wg);   // bh0 and rh1 are written

    // ---- the rigidity of row t / 2 (even threads): tanh(rh1 @ row + rob),
    // a sequential sum, then (t + 1) * 0.5
    if (t % 2 == 0) {
      const int r = t / 2;
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < RIG_W / 8; ++c) {
        const uint4 av = ld_shared16(rh1_t + uint32_t(r) * (RIG_W * 2) + c * 16);
        const uint4 wv = ld_shared16(extra + BIMG_ROWT + c * 16);
        const uint32_t ap[4] = {av.x, av.y, av.z, av.w};
        const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s += bf16_lo(ap[e]) * bf16_lo(wp[e]);
          s += bf16_hi(ap[e]) * bf16_hi(wp[e]);
        }
      }
      const float th = tanhf(__fadd_rn(s, ld_shared_f32(extra + BIMG_ROB)));
      const float rig0 = __fmul_rn(__fadd_rn(th, 1.0f), 0.5f);
      st_shared_f32(rig_row(extra, slot, wg * WG_ROWS + r), rig0);
      const long row = row0 + wg * WG_ROWS + r;
      if (row < n) rig[row] = rig0;
    }

    // ---- bh1 .. bh3 (m64n64k16 x 4 each) over the bh tile; bh3 into this
    // warpgroup's rows of the tile's encoding tile
#pragma unroll 1
    for (int l = 1; l < 4; ++l) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BEND_W / 16; ++kk) {
        wgmma_m64n64(acc, desc_sw128(bh_t + kk * 32),
                     desc_sw128(extra + BIMG_BW + uint32_t(l - 1) * BEND_W * BEND_W * 2 + kk * 32),
                     kk != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<32>(acc);
      const uint32_t dst = l < 3 ? bh_t : bh3_t;
      bend_epilogue<BEND_W>(acc, extra + BIMG_BB + uint32_t(l) * BEND_W * 4, t,
                            [](int, int) { return 0.0f; },
                            [&](int h, int col, uint32_t v) {
                              st_shared32(dst + tile_offset(rw + 8 * h, col), v);
                            });
      fence_proxy_async();
      wg_barrier(wg);
    }
    if (t == 0) mbar_arrive(bars + 8 * (2 + slot));
  }
"""

# row 9 with the whole deformation field on the producer warpgroup's three
# idle warps (mma.sync m16n8k16, a warp 16 rows at a time, the activations
# in those rows of the encoding tile, the producer's 40 registers) and
# nothing on the consumers: it replaces FusedFwdIn, from its struct to the
# plan that follows it
FUSED_ON_ENCODERS = r"""// variant (c): the whole bender on the producer warpgroup's three idle warps
// (mma.sync m16n8k16, a warp 16 rows at a time, its activations in those
// rows of the encoding tile, 40 registers), nothing on the consumers
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int K>
__device__ __forceinline__ uint32_t kmajor_offset(int n, int k) {
  const uint32_t sw = K == 64 ? uint32_t(n & 7) : uint32_t((n >> 1) & 3);
  return uint32_t(n) * (2 * K) + (((uint32_t(k) >> 3) ^ sw) << 4) + (uint32_t(k & 7) << 1);
}
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], uint32_t rows, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldmatrix_x4(a[ks], rows + tile_offset(lane % 16, ks * 16 + (lane / 16) * 8));
  }
}
template <int K, int N, class Pre>
__device__ __forceinline__ void warp_layer(const uint32_t (&a)[K / 16][4], uint32_t rows,
                                           uint32_t w, uint32_t bias, int lane, Pre&& pre) {
  const int q = lane % 4;
#pragma unroll 1
  for (int j = 0; j < N / 8; ++j) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t b[2];
      ldmatrix_x2(b, w + kmajor_offset<K>(j * 8 + (lane & 7), ks * 16 + ((lane >> 3) & 1) * 8));
      mma_16816(acc, a[ks], b[0], b[1]);
    }
    const int col = j * 8 + 2 * q;
    const float b0 = ld_shared_f32(bias + 4 * col), b1 = ld_shared_f32(bias + 4 * col + 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = fmaxf(__fadd_rn(__fadd_rn(pre(h, col), acc[2 * h]), b0), 0.0f);
      const float v1 = fmaxf(__fadd_rn(__fadd_rn(pre(h, col + 1), acc[2 * h + 1]), b1), 0.0f);
      st_shared32(rows + tile_offset(lane / 4 + 8 * h, col), pack_bf16(v0, v1));
    }
  }
}

struct FusedFwdIn {
  static constexpr int FWD_TILES = 2;
  static constexpr int ENCODERS = 96;
  static constexpr int WARPS = ENCODERS / 32;
  static constexpr int BLOCKS = TM / 16;
  const float* pts;
  const float* lat;
  BendWeights bw;
  float* off;
  float* rig;

  __device__ __forceinline__ void stage(uint32_t wimg, int tid, int nthreads) const {
    stage_bend_image(wimg, bw, false, tid, nthreads);
  }
  __device__ __forceinline__ void init(uint32_t bars) const {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars + 8 * b, ENCODERS);
      mbar_init(bars + 8 * (2 + b), CONSUMERS);
    }
    mbar_init_fence();
  }
  __device__ __forceinline__ void encode(uint32_t emb0, uint32_t bars, uint32_t wimg, int n,
                                         int n_tiles, int e) const {
    const int warp = e / 32;
    const int lane = e % 32;
    int i = 0;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int b = i % 2;
      const uint32_t embt = emb0 + uint32_t(b) * TILE_ATOM_BYTES;
      mbar_wait(bars + 8 * (2 + b), ((i / 2) & 1) ^ 1);
#pragma unroll 1
      for (int blk = (warp + i) % WARPS; blk < BLOCKS; blk += WARPS) {
        bend_block(embt, wimg, long(tile) * TM, blk * 16, n, lane);
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
  template <int R>
  __device__ __forceinline__ void ahead(float (&)[R], unsigned char*, uint32_t, uint32_t,
                                        uint32_t, int, long, int, int, int) {}

  __device__ __forceinline__ void bend_block(uint32_t embt, uint32_t wimg, long row0,
                                             int r_blk, int n, int lane) const {
    const int q = lane % 4;
    const uint32_t rows = embt + uint32_t(r_blk) * ATOM_ROW_BYTES;
    const long r0 = row0 + r_blk + lane / 4;
    const long r1 = r0 + 8;
    float xb[2][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      xb[0][j] = round_bf16(r0 < n ? __ldg(pts + size_t(r0) * 3 + j) : 0.0f);
      xb[1][j] = round_bf16(r1 < n ? __ldg(pts + size_t(r1) * 3 + j) : 0.0f);
    }
    auto nopre = [](int, int) { return 0.0f; };
    {
      uint32_t a[RIG_W / 16][4];
#pragma unroll
      for (int ks = 0; ks < RIG_W / 16; ++ks) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int c = ks * 16 + (f / 2) * 8 + 2 * q;
          float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const uint32_t wv = ld_shared32(wimg + BIMG_R0W + 2 * (j * RIG_W + c));
            s0 += xb[f % 2][j] * bf16_lo(wv);
            s1 += xb[f % 2][j] * bf16_hi(wv);
          }
          a[ks][f] = pack_bf16(fmaxf(__fadd_rn(s0, ld_shared_f32(wimg + BIMG_R0B + 4 * c)), 0.0f),
                               fmaxf(__fadd_rn(s1, ld_shared_f32(wimg + BIMG_R0B + 4 * c + 4)),
                                     0.0f));
        }
      }
      warp_layer<RIG_W, RIG_W>(a, rows, wimg + BIMG_R1W, wimg + BIMG_R1B, lane, nopre);
    }
    __syncwarp();
    const int r = lane % 16;
    const float th = tanhf(
        __fadd_rn(row_dot<RIG_W>(rows, r, wimg + BIMG_ROWT), ld_shared_f32(wimg + BIMG_ROB)));
    const float rig0 = __fmul_rn(__fadd_rn(th, 1.0f), 0.5f);
    __syncwarp();
    {
      uint32_t al[LAT_W / 16][4];
#pragma unroll
      for (int ks = 0; ks < LAT_W / 16; ++ks) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const long rf = f % 2 ? r1 : r0;
          const int c = ks * 16 + (f / 2) * 8 + 2 * q;
          const float2 v = rf < n ? __ldg(reinterpret_cast<const float2*>(lat + size_t(rf) * LAT_W + c))
                                  : make_float2(0.0f, 0.0f);
          al[ks][f] = pack_bf16(v.x, v.y);
        }
      }
      warp_layer<LAT_W, BEND_W>(al, rows, wimg + BIMG_B0L, wimg + BIMG_BB, lane, [&](int h, int col) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint32_t wv = ld_shared32(wimg + BIMG_B0P + 2 * (j * BEND_W + (col & ~1)));
          s += xb[h][j] * (col & 1 ? bf16_hi(wv) : bf16_lo(wv));
        }
        return s;
      });
    }
#pragma unroll 1
    for (int l = 1; l < 4; ++l) {
      uint32_t a[BEND_W / 16][4];
      __syncwarp();
      load_a(a, rows, lane);
      __syncwarp();
      warp_layer<BEND_W, BEND_W>(a, rows, wimg + BIMG_BW + uint32_t(l - 1) * BEND_W * BEND_W * 2,
                                 wimg + BIMG_BB + uint32_t(l) * BEND_W * 4, lane, nopre);
    }
    __syncwarp();
    const float o_lane = row_dot<BEND_W>(rows, r, wimg + BIMG_BOWT + (lane / 16) * BEND_W * 2);
    const float o2 = row_dot<BEND_W>(rows, r, wimg + BIMG_BOWT + 2 * BEND_W * 2);
    const float offs[3] = {__shfl_sync(0xffffffffu, o_lane, r),
                           __shfl_sync(0xffffffffu, o_lane, r + 16), o2};
    const long row = row0 + r_blk + r;
    const bool valid = row < n;
    float bent[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float x = valid ? __ldg(pts + size_t(row) * 3 + j) : 0.0f;
      bent[j] = __fadd_rn(x, __fmul_rn(rig0, offs[j]));
      if (valid && lane < 16) off[size_t(row) * 3 + j] = offs[j];
    }
    if (valid && lane < 16) rig[row] = rig0;
    __syncwarp();
#pragma unroll 1
    for (int p = 0; p < 4; ++p) {
      encode_piece_with(embt, bent, valid, [&](int c, float (&pc)[4]) {
        pc[0] = ld_shared_f32(wimg + BIMG_P + 4 * c);
        pc[1] = ld_shared_f32(wimg + BIMG_P + 4 * (EMB + c));
        pc[2] = ld_shared_f32(wimg + BIMG_P + 4 * (2 * EMB + c));
        pc[3] = ld_shared_f32(wimg + BIMG_PHASE + 4 * c);
      }, r_blk + r, ((lane / 16) * 4 + p) * 8);
    }
  }
};

"""

# row 9, variant (a): FUSED_ON_ENCODERS with the activations in registers: a
# layer's accumulator fragments, rounded to bf16, are the next layer's A
# fragments (m16n8k16: n-tiles 2 ks and 2 ks + 1 make k-step ks); only rh1
# and bh3 go to the warp's rows of the encoding tile, for the sequential
# 3-lane sums. Inserted before `bend_block`; the encoders call it instead.
FUSED_IN_REGISTERS = r"""  // acc[j] (n-tile j of N / 8) = a (K / 16 k-steps) @ the K-major matrix at w,
  // the k-steps in ascending order from 0
  template <int K, int N, int NA, int NJ>
  static __device__ __forceinline__ void reg_products(float (&acc)[NJ][4],
                                                      const uint32_t (&a)[NA][4], uint32_t w,
                                                      int lane) {
    static_assert(NA >= K / 16 && NJ >= N / 8, "the fragments hold the layer");
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks) {
        uint32_t b[2];
        ldmatrix_x2(b, w + kmajor_offset<K>(j * 8 + (lane & 7), ks * 16 + ((lane >> 3) & 1) * 8));
        mma_16816(acc[j], a[ks], b[0], b[1]);
      }
    }
  }
  // bf16(relu((pre(h, col) + acc) + bias)) of N columns, each pair to
  // put(j, h, col, packed)
  template <int N, int NJ, class Pre, class Put>
  static __device__ __forceinline__ void reg_epilogue(const float (&acc)[NJ][4], uint32_t bias,
                                                      int lane, Pre&& pre, Put&& put) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      const float b0 = ld_shared_f32(bias + 4 * col), b1 = ld_shared_f32(bias + 4 * col + 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fmaxf(__fadd_rn(__fadd_rn(pre(h, col), acc[j][2 * h]), b0), 0.0f);
        const float v1 =
            fmaxf(__fadd_rn(__fadd_rn(pre(h, col + 1), acc[j][2 * h + 1]), b1), 0.0f);
        put(j, h, col, pack_bf16(v0, v1));
      }
    }
  }

  __device__ __forceinline__ void bend_block_regs(uint32_t embt, uint32_t wimg, long row0,
                                                  int r_blk, int n, int lane) const {
    const int q = lane % 4;
    const uint32_t rows = embt + uint32_t(r_blk) * ATOM_ROW_BYTES;
    const long r0 = row0 + r_blk + lane / 4;
    const long r1 = r0 + 8;
    float xb[2][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      xb[0][j] = round_bf16(r0 < n ? __ldg(pts + size_t(r0) * 3 + j) : 0.0f);
      xb[1][j] = round_bf16(r1 < n ? __ldg(pts + size_t(r1) * 3 + j) : 0.0f);
    }
    auto nopre = [](int, int) { return 0.0f; };
    auto to_rows = [&](int, int h, int col, uint32_t v) {
      st_shared32(rows + tile_offset(lane / 4 + 8 * h, col), v);
    };
    auto to_a = [&](uint32_t (&a)[BEND_W / 16][4]) {
      return [&a](int j, int h, int, uint32_t v) { a[j / 2][2 * (j % 2) + h] = v; };
    };
    uint32_t a[BEND_W / 16][4];
    float acc[BEND_W / 8][4];
    // rh0 (CUDA cores) as A fragments, rh1 to the rows, the rigidity
#pragma unroll
    for (int ks = 0; ks < RIG_W / 16; ++ks) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int c = ks * 16 + (f / 2) * 8 + 2 * q;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint32_t wv = ld_shared32(wimg + BIMG_R0W + 2 * (j * RIG_W + c));
          s0 += xb[f % 2][j] * bf16_lo(wv);
          s1 += xb[f % 2][j] * bf16_hi(wv);
        }
        a[ks][f] = pack_bf16(fmaxf(__fadd_rn(s0, ld_shared_f32(wimg + BIMG_R0B + 4 * c)), 0.0f),
                             fmaxf(__fadd_rn(s1, ld_shared_f32(wimg + BIMG_R0B + 4 * c + 4)),
                                   0.0f));
      }
    }
    reg_products<RIG_W, RIG_W>(acc, a, wimg + BIMG_R1W, lane);
    reg_epilogue<RIG_W>(acc, wimg + BIMG_R1B, lane, nopre, to_rows);
    __syncwarp();
    const int r = lane % 16;
    const float th = tanhf(
        __fadd_rn(row_dot<RIG_W>(rows, r, wimg + BIMG_ROWT), ld_shared_f32(wimg + BIMG_ROB)));
    const float rig0 = __fmul_rn(__fadd_rn(th, 1.0f), 0.5f);
    // bh0 from the latents' A fragments, bh1, bh2 in registers, bh3 to the rows
#pragma unroll
    for (int ks = 0; ks < LAT_W / 16; ++ks) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const long rf = f % 2 ? r1 : r0;
        const int c = ks * 16 + (f / 2) * 8 + 2 * q;
        const float2 v = rf < n ? __ldg(reinterpret_cast<const float2*>(lat + size_t(rf) * LAT_W + c))
                                : make_float2(0.0f, 0.0f);
        a[ks][f] = pack_bf16(v.x, v.y);
      }
    }
    reg_products<LAT_W, BEND_W>(acc, a, wimg + BIMG_B0L, lane);
    reg_epilogue<BEND_W>(acc, wimg + BIMG_BB, lane, [&](int h, int col) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint32_t wv = ld_shared32(wimg + BIMG_B0P + 2 * (j * BEND_W + (col & ~1)));
        s += xb[h][j] * (col & 1 ? bf16_hi(wv) : bf16_lo(wv));
      }
      return s;
    }, to_a(a));
#pragma unroll 1
    for (int l = 1; l < 3; ++l) {
      reg_products<BEND_W, BEND_W>(acc, a, wimg + BIMG_BW + uint32_t(l - 1) * BEND_W * BEND_W * 2,
                                   lane);
      reg_epilogue<BEND_W>(acc, wimg + BIMG_BB + uint32_t(l) * BEND_W * 4, lane, nopre, to_a(a));
    }
    reg_products<BEND_W, BEND_W>(acc, a, wimg + BIMG_BW + 2u * BEND_W * BEND_W * 2, lane);
    __syncwarp();   // every lane has read rh1
    reg_epilogue<BEND_W>(acc, wimg + BIMG_BB + 3u * BEND_W * 4, lane, nopre, to_rows);
    __syncwarp();
    const float o_lane = row_dot<BEND_W>(rows, r, wimg + BIMG_BOWT + (lane / 16) * BEND_W * 2);
    const float o2 = row_dot<BEND_W>(rows, r, wimg + BIMG_BOWT + 2 * BEND_W * 2);
    const float offs[3] = {__shfl_sync(0xffffffffu, o_lane, r),
                           __shfl_sync(0xffffffffu, o_lane, r + 16), o2};
    const long row = row0 + r_blk + r;
    const bool valid = row < n;
    float bent[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float x = valid ? __ldg(pts + size_t(row) * 3 + j) : 0.0f;
      bent[j] = __fadd_rn(x, __fmul_rn(rig0, offs[j]));
      if (valid && lane < 16) off[size_t(row) * 3 + j] = offs[j];
    }
    if (valid && lane < 16) rig[row] = rig0;
    __syncwarp();
#pragma unroll 1
    for (int p = 0; p < 4; ++p) {
      encode_piece_with(embt, bent, valid, [&](int c, float (&pc)[4]) {
        pc[0] = ld_shared_f32(wimg + BIMG_P + 4 * c);
        pc[1] = ld_shared_f32(wimg + BIMG_P + 4 * (EMB + c));
        pc[2] = ld_shared_f32(wimg + BIMG_P + 4 * (2 * EMB + c));
        pc[3] = ld_shared_f32(wimg + BIMG_PHASE + 4 * c);
      }, r_blk + r, ((lane / 16) * 4 + p) * 8);
    }
  }

"""

# the register split 216 / 72 in place of the chain's 232 / 40
REGS_216_72 = [
    ("mlp_sm90.cuh",
     "    setmaxnreg_dec<PRODUCER_REGS>();\n    if (t == 0) {\n      produce<S>(",
     "    setmaxnreg_dec<72>();\n    if (t == 0) {\n      produce<S>("),
    ("mlp_sm90.cuh",
     "    setmaxnreg_inc<CONSUMER_REGS>();\n    In in = in_args;\n    uint32_t g = 0;\n"
     "    float acc[128];",
     "    setmaxnreg_inc<216>();\n    In in = in_args;\n    uint32_t g = 0;\n"
     "    float acc[128];")]

# name -> [(file, text, replacement)]
VARIANTS = {
    "base": [],
    # the producer arrives on each "full" barrier without copying a chunk:
    # what the L2 stream of weights costs
    "no_weight_copies": [(
        "mlp_sm90.cuh",
        "      mbar_expect_tx(bars + 8 * s, nb);\n"
        "      bulk_load(ring + s * CHUNK_BYTES, chunks + size_t(c) * CHUNK_BYTES, nb, bars + 8 * s);",
        "      mbar_arrive(bars + 8 * s);")],
    # the layer epilogue computes but does not store its bf16 tile
    "no_epilogue_stores": [(
        "mlp_sm90.cuh",
        "      *reinterpret_cast<__nv_bfloat162*>(act + tile_offset(r0 + 8 * h, col)) = v;",
        "      if (v0 == 12345.0f) {\n"
        "        *reinterpret_cast<__nv_bfloat162*>(act + tile_offset(r0 + 8 * h, col)) = v;\n"
        "      }")],
    # a 4-stage forward ring (the sources use 3)
    "fwd_4_stages": [(
        "mlp_sm90.cuh", "constexpr int FWD_STAGES = 3;",
        "constexpr int FWD_STAGES = 4;")],
    # a 2-stage forward ring for rows 1, 3 and 5 (the depth row 9 runs at)
    "fwd_2_stages": [(
        "mlp_sm90.cuh", "constexpr int FWD_STAGES = 3;",
        "constexpr int FWD_STAGES = 2;")],
    # the dh chain two accumulators deep: chunk c + 1's products in flight
    # under chunk c's epilogue (the sources take one chunk at a time)
    "dh_two_accumulators": [(
        "mlp_sm90.cuh",
        "#pragma unroll 1\n"
        "  for (int c = 0; c < N; ++c, ++g) {\n"
        "    nt_issue<S>(acc, cur, ring, bars, g, wg);\n"
        "    wgmma_wait<0>();\n"
        "    fence_acc<32>(acc);\n"
        "    ring_release<S>(bars, g, t == 0);\n"
        "    if (gate != nullptr) {\n"
        "      dh_epilogue(acc, gate[c], c, oth, wg, t);\n"
        "    } else {\n"
        "      sink(acc, c);\n"
        "    }\n"
        "  }\n",
        "  float acc2[2][32];\n"
        "  nt_issue<S>(acc2[0], cur, ring, bars, g, wg);\n"
        "#pragma unroll\n"
        "  for (int c = 0; c < N; ++c) {\n"
        "    if (c + 1 < N) {\n"
        "      nt_issue<S>(acc2[(c + 1) % 2], cur, ring, bars, g + c + 1, wg);\n"
        "      wgmma_wait<1>();\n"
        "    } else {\n"
        "      wgmma_wait<0>();\n"
        "    }\n"
        "    fence_acc(acc2[c % 2]);\n"
        "    ring_release<S>(bars, g + c, t == 0);\n"
        "    if (gate != nullptr) {\n"
        "      dh_epilogue(acc2[c % 2], gate[c], c, oth, wg, t);\n"
        "    } else {\n"
        "      sink(acc2[c % 2], c);\n"
        "    }\n"
        "  }\n"
        "  g += N;\n")],
    # row 5: the consumers encode the next tile themselves once layer 5 has
    # read the tile (one encoding tile), in place of the producer
    # warpgroup's three idle warps (PtsFwdIn, two encoding tiles)
    "pts_encode_on_consumers": [
        ("mlp_sm90.cuh",
         "// mlpe_bwd.cu's input: the points, encoded (encode_rows) at the start of",
         "struct PtsOnConsumersIn {\n"
         "  static constexpr int FWD_TILES = 1;\n"
         "  const float* pts;\n"
         "  const float* P;\n"
         "  const float* phase;\n"
         "  float x[3];\n"
         "  __device__ void init(uint32_t) const {}\n"
         "  __device__ void encode(uint32_t, uint32_t, uint32_t, int, int, int) const {}\n"
         "  __device__ void first(uint32_t embt, long row0, int n, int wg, int t) {\n"
         "    load_point(pts, row0 + wg * WG_ROWS + t / 2, n, x);\n"
         "    done(embt, 0, 0, row0, n, wg, t);\n"
         "  }\n"
         "  __device__ void wait(uint32_t, int) {}\n"
         "  __device__ void done(uint32_t embt, uint32_t, int, long row0, int n, int wg,\n"
         "                       int t) {\n"
         "    if (row0 < 0) return;\n"
         "    const long r = row0 + wg * WG_ROWS + t / 2;\n"
         "    encode_rows(embt, x, r < n, P, phase, wg, t);\n"
         "    load_point(pts, r + long(gridDim.x) * TM, n, x);\n"
         "  }\n"
         "};\n"
         "\n"
         "// mlpe_bwd.cu's input: the points, encoded (encode_rows) at the start of"),
        ("mlpe_fwd.cu",
         "  const sm90::PtsFwdIn in{static_cast<const float*>(pts), "
         "static_cast<const float*>(P),\n"
         "                          static_cast<const float*>(phase)};",
         "  const sm90::PtsOnConsumersIn in{static_cast<const float*>(pts), "
         "static_cast<const float*>(P),\n"
         "                                  static_cast<const float*>(phase), {}};")],
    # row 5: the encoding without its sines (what the sines cost; disagrees)
    "pts_no_sines": [(
        "mlp_sm90.cuh",
        "  return c < 3 ? pre : sinf(pre + p[3]);",
        "  return c < 3 ? pre : pre + p[3];")],
    # row 5: the encoders write nothing, the handshake stays (what the
    # encoding costs; disagrees)
    "pts_no_encoding": [(
        "mlp_sm90.cuh",
        "        encode_piece(embt, x, row < n, P, phase, r, (q % (EMB / 8)) * 8);\n",
        "")],
    # row 11: a 2-stage ring (the source: 3)
    "i8_2_stages": [(
        "mlp_i8.cu", "constexpr int I8_STAGES = 3;", "constexpr int I8_STAGES = 2;")],
    # row 11: each consumer warpgroup quantizes its 64 rows of the tile's
    # encoding itself when the tile starts (the source: the producer
    # warpgroup's three idle warps, a tile ahead); the encoders keep the
    # handshake and write nothing
    "i8_quantize_on_consumers": [
        ("mlp_i8.cu",
         "      quantize_piece(embt, emb, long(tile) * TM, n, m, q / 4, (q % 4) * 16);\n",
         ""),
        ("mlp_i8.cu",
         "      fence_proxy_async();\n"
         "      wg_barrier(wg);   // ... and the last tile's head is done\n",
         "      for (int q = t; q < EMB_PIECES / CONSUMERS; q += 128) {\n"
         "        quantize_piece(emb0 + uint32_t(i % 2) * I8_EMB_BYTES, emb, row0, n,\n"
         "                       __ldg(p.qm), wg * WG_ROWS + q / 4, (q % 4) * 16);\n"
         "      }\n"
         "      fence_proxy_async();\n"
         "      wg_barrier(wg);   // ... and the last tile's head is done\n")],
    # row 9, variant (c) of its design: the whole bender on the producer's
    # idle warps at 40 registers, its activations in shared memory
    # (FUSED_ON_ENCODERS), the consumers' `ahead` a no-op; the same
    # arithmetic (agrees bit for bit)
    "fused_bender_on_encoders": [(
        "mlp_sm90.cuh",
        ("struct FusedFwdIn {",
         "// What the forward kernel gives its input beyond the tiles"),
        FUSED_ON_ENCODERS)],
    # row 9, variant (a): the whole bender on the producer's idle warps with
    # its activations in registers (FUSED_IN_REGISTERS), at the register
    # split 216 / 72; agrees bit for bit
    "fused_bender_in_registers": [
        ("mlp_sm90.cuh",
         ("struct FusedFwdIn {",
          "// What the forward kernel gives its input beyond the tiles"),
         FUSED_ON_ENCODERS),
        ("mlp_sm90.cuh",
         "  __device__ __forceinline__ void bend_block(uint32_t embt,",
         FUSED_IN_REGISTERS
         + "  __device__ __forceinline__ void bend_block(uint32_t embt,"),
        ("mlp_sm90.cuh",
         "        bend_block(embt, wimg, long(tile) * TM, blk * 16, n, lane);",
         "        bend_block_regs(embt, wimg, long(tile) * TM, blk * 16, n, lane);"),
        *REGS_216_72],
    # row 9: the sources at the register split 216 / 72 in place of the
    # chain's 232 / 40 (what registers given to the encoders cost the
    # consumers' chain)
    "fused_regs_216_72": REGS_216_72,
    # row 9: the consumers' `ahead` reduced to its handshake (no A tiles,
    # products, epilogues or rigidity: what the bender costs the consumers
    # in all; disagrees)
    "fused_ahead_handshake_only": [(
        "mlp_sm90.cuh",
        ("    const uint32_t lat_t = smem_u32(act) + uint32_t(wg) * WG_ATOM_BYTES;   // atom 0",
         "    if (t == 0) mbar_arrive(bars + 8 * (2 + slot));"),
        "    wg_barrier(wg);\n")],
    # row 9: the encoders without the offsets and bent points (what they
    # cost the encoders; disagrees)
    "fused_no_offsets": [(
        "mlp_sm90.cuh",
        ("      for (int p = e; p < TM * 3; p += ENCODERS) {",
         "      encoders_barrier();   // every bh3 row is read"),
        "")],
    # row 9: the encoding without its sines (what the encoders' sines cost;
    # disagrees)
    "fused_no_sines": [(
        "mlp_sm90.cuh",
        "  return c < 3 ? pre : sinf(pre + p[3]);",
        "  return c < 3 ? pre : pre + p[3];")],
    # row 9: the consumers' `ahead` without its loads of the points and
    # latents (zeros; what their latency costs; disagrees)
    "fused_ahead_no_loads": [
        ("mlp_sm90.cuh",
         "  __device__ __forceinline__ bool valid(int r) const { return row0 + r < n; }",
         "  __device__ __forceinline__ bool valid(int r) const { return row0 + r < 0 * n; }")],
    # row 9: the consumers' `ahead` without its five products (what the
    # bender's layers cost the chain; disagrees)
    "fused_ahead_no_products": [
        ("mlp_sm90.cuh",
         "    wgmma_m64n32(acc, desc_sw64(rh0_t + kk * 32), desc_sw64(img + BIMG_R1W + kk * 32),\n"
         "                 kk != 0);", ""),
        ("mlp_sm90.cuh",
         "    wgmma_m64n64(acc, desc_sw64(lat_t + kk * 32), desc_sw64(img + BIMG_B0L + kk * 32),\n"
         "                 kk != 0);", ""),
        ("mlp_sm90.cuh",
         "      wgmma_m64n64(acc, desc_sw128(a + kk * 32),\n"
         "                   desc_sw128(img + BIMG_BW + uint32_t(l - 1) * BEND_W * BEND_W * 2 + kk * 32),\n"
         "                   kk != 0);", "")],
    # row 9: `ahead` zeroes the products' 32 accumulators first, and the
    # consumers the chain's 128 after `ahead` (the same arithmetic; the
    # source zeroes neither: ptxas then serialized the chain's wgmma,
    # C7511, about 20% slower on an H100)
    "fused_zero_accumulators": [
        ("mlp_sm90.cuh",
         "    const int slot = j % 2;\n"
         "    const uint32_t lat_t = smem_u32(act) + uint32_t(wg) * WG_ATOM_BYTES;   // atom 0\n",
         "#pragma unroll\n"
         "    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;\n"
         "    const int slot = j % 2;\n"
         "    const uint32_t lat_t = smem_u32(act) + uint32_t(wg) * WG_ATOM_BYTES;   // atom 0\n"),
        ("mlp_sm90.cuh",
         "      in.wait(in_bars, i);\n",
         "      in.wait(in_bars, i);\n"
         "      if constexpr (FwdPlan<In>::AHEAD) {\n"
         "#pragma unroll\n"
         "        for (int k = 0; k < 128; ++k) acc[k] = 0.0f;\n"
         "      }\n")],
    # row 9: `ahead` with the bender inline (INLINE_AHEAD), the rest as the source
    "fused_parent_ahead": [(
        "mlp_sm90.cuh",
        ("  template <int R>\n  __device__ __forceinline__ void ahead(",
         "  __device__ __forceinline__ void first(uint32_t, long, int, int, int) {}"),
        INLINE_AHEAD + "\n")],
    # row 7: two groups of a consumer and two encoder warpgroups a CTA (768
    # threads; the consumer at 112 registers; the source: three groups of a
    # consumer and one encoder warpgroup, the consumer at 96)
    "bend_groups_2x2": [
        ("mlp_sm90.cuh", "constexpr int BF_PAIRS = 3;", "constexpr int BF_PAIRS = 2;"),
        ("mlp_sm90.cuh", "constexpr int BF_ENC_WGS = 1;", "constexpr int BF_ENC_WGS = 2;"),
        ("mlp_sm90.cuh", "constexpr int BF_CONSUMER_REGS = 96;",
         "constexpr int BF_CONSUMER_REGS = 112;")],
    # row 7: two groups of a consumer and one encoder warpgroup (512 threads)
    "bend_groups_2x1": [("mlp_sm90.cuh", "constexpr int BF_PAIRS = 3;",
                         "constexpr int BF_PAIRS = 2;")],
    # row 7: one group of a consumer and two encoder warpgroups a CTA, two
    # CTAs an SM (the image staged twice an SM)
    "bend_groups_1x2_2ctas": [
        ("mlp_sm90.cuh", "constexpr int BF_PAIRS = 3;", "constexpr int BF_PAIRS = 1;"),
        ("mlp_sm90.cuh", "constexpr int BF_ENC_WGS = 1;", "constexpr int BF_ENC_WGS = 2;"),
        ("mlp_sm90.cuh", "constexpr int BF_CTAS_PER_SM = 1;", "constexpr int BF_CTAS_PER_SM = 2;"),
        ("mlp_sm90.cuh", "constexpr int BF_CONSUMER_REGS = 96;",
         "constexpr int BF_CONSUMER_REGS = 112;")],
    # row 7: the input ring's stages, 1 (the source: 2; three do not fit
    # beside three groups)
    "bend_ring_1": [("mlp_sm90.cuh", "constexpr int BF_STAGES = 2;",
                     "constexpr int BF_STAGES = 1;")],
    # row 7: half of a group's encoder threads (64 of 128) do the encoding
    "bend_encoders_64": [("mlp_sm90.cuh", "constexpr int BF_ENCODERS = 128 * BF_ENC_WGS;",
                          "constexpr int BF_ENCODERS = 64;")],
    # row 8: one worker warpgroup a CTA (the source: two), half the workers
    "bend_bwd_workers_1": [("mlp_sm90.cuh", "constexpr int BB_WORKERS = 2;",
                            "constexpr int BB_WORKERS = 1;")],
    # row 8: half the CTAs (66 on 132 SMs), each walking twice the tiles
    "bend_bwd_tiles_x2": [(
        "mlp_sm90.cuh",
        "  return bend_grid((n + WG_ROWS - 1) / WG_ROWS, BB_WORKERS, BB_CTAS_PER_SM);",
        "  const int g = bend_grid((n + WG_ROWS - 1) / WG_ROWS, BB_WORKERS, BB_CTAS_PER_SM);\n"
        "  return g > 1 ? g / 2 : g;")],
    # row 11: the 8-lane head as rows 1 and 5 take it, a per-thread f32 dot
    # product on the CUDA cores from the bf16 h8 tile (the source: 16
    # m64n8k16 on the tensor cores)
    "i8_head_on_cuda_cores": [(
        "mlp_i8.cu",
        "      i8_head(act_s + rows, smem_u32(owt), p.ob, out, row0, n, wg, t);\n",
        "      raw_head(act, p.ow, p.ob, out, row0, n, wg, t);\n")],
}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def substitute(src, text, repl, what):
    """src with `text` (or the span from text[0] up to text[1]) replaced."""
    if isinstance(text, tuple):
        start = src.find(text[0])
        end = src.find(text[1], start)
        if start < 0 or end < 0:
            raise AssertionError(f"{what} has no {text[0][:60]!r} .. {text[1][:60]!r}")
        return src[:start] + repl + src[end:]
    if text not in src:
        raise AssertionError(f"{what} has no {text[:60]!r}")
    return src.replace(text, repl)


def build(names, out_dir):
    """Patched copies of csrc/, every source built side by side; returns the
    variants that did not build."""
    from nonrigid_nerf_torch.ops.kernels import build as B
    nvcc = B.find_nvcc()
    procs = {}
    for name in names:
        d = os.path.join(out_dir, name)
        shutil.copytree(CSRC, d)
        for f, text, repl in VARIANTS[name]:
            path = os.path.join(d, f)
            with open(path) as fh:
                src = fh.read()
            with open(path, "w") as fh:
                fh.write(substitute(src, text, repl, f"variant {name}: {f}"))
        for s in (("mlp_i8.cu",) if name in I8_ONLY else
                  ("fused_fwd.cu",) if name in FUSED_ONLY else
                  ("bend_fwd.cu", "bend_bwd.cu") if name in BEND_ONLY else SOURCES):
            procs[(name, s)] = subprocess.Popen(
                [nvcc, *B.NVCC_FLAGS, "-o", os.path.join(d, s + ".so"),
                 os.path.join(d, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = set()
    for (name, s), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            failed.add(name)
            print(f"build {name}/{s}: nvcc failed:\n{log[-3000:]}", flush=True)
            continue
        notes = [l.strip() for l in log.splitlines()
                 if "C75" in l or ("spill" in l and " 0 bytes spill" not in l)]
        print(f"build {name}/{s}: " + (" | ".join(notes)[:400] or "no spills"),
              flush=True)
    return failed


def run_variant(name, out_dir):
    """The child: time and check one built variant."""
    sys.path.insert(0, ROOT)
    from nonrigid_nerf_torch.config import ModelConfig
    from nonrigid_nerf_torch.models.model import NRNeRF
    from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
    from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
    from nonrigid_nerf_torch.ops.kernels import mlpe_fwd as KE
    from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as KV
    from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import (pack_chain_image,
                                                          pack_views_image)

    dev = torch.device("cuda")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    if name in FUSED_ONLY:
        time_fused(name, out_dir, dev, backward=False)
        return
    time_bend(name, out_dir, dev)
    if name in BEND_ONLY:
        return
    time_i8(name, out_dir, dev)
    if name in I8_ONLY:
        return
    time_fused(name, out_dir, dev, backward=True)
    fwd = ctypes.CDLL(os.path.join(out_dir, name, "mlp_fwd.cu.so"))
    fwd.nrnerf_mlp_fwd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ptrs, ptrs,
                                   ctypes.c_void_p, ctypes.c_void_p]
    bwd = ctypes.CDLL(os.path.join(out_dir, name, "mlp_bwd.cu.so"))
    bwd.nrnerf_mlp_bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                   ptrs, ptrs] + [ctypes.c_void_p] * 5
    bwd.nrnerf_mlp_bwd_sizes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    vfwd = ctypes.CDLL(os.path.join(out_dir, name, "mlpv_fwd.cu.so"))
    vfwd.nrnerf_mlpv_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p, ptrs, ptrs,
                                     ctypes.c_void_p, ctypes.c_void_p]
    efwd = ctypes.CDLL(os.path.join(out_dir, name, "mlpe_fwd.cu.so"))
    efwd.nrnerf_mlpe_fwd.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ptrs, ptrs, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def run_fwd(emb, mw, image):
        out = torch.empty((emb.shape[0], 8), dtype=torch.float32, device=dev)
        mats, biases = K.weight_pointers(mw, K._MATRIX_IDX, K._BIAS_IDX)
        if fwd.nrnerf_mlp_fwd(emb.data_ptr(), emb.shape[0], emb.shape[1],
                              image.data_ptr(), mats, biases, out.data_ptr(),
                              stream):
            raise RuntimeError("mlp_fwd launch failed")
        return out

    def run_bwd(embb, mw, draw, image):
        n, width = embb.shape
        shapes = KB.grad_shapes(width)
        se, pf = ctypes.c_longlong(), ctypes.c_longlong()
        bwd.nrnerf_mlp_bwd_sizes(n, width, ctypes.byref(se), ctypes.byref(pf))
        scratch = torch.empty(se.value, dtype=torch.bfloat16, device=dev)
        partials = torch.empty(pf.value, dtype=torch.float32, device=dev)
        grads = torch.empty(sum(s.numel() for s in shapes),
                            dtype=torch.float32, device=dev)
        demb = torch.empty((n, width), dtype=torch.float32, device=dev)
        mats, biases = K.weight_pointers(mw, K._MATRIX_IDX, K._BIAS_IDX)
        if bwd.nrnerf_mlp_bwd(embb.data_ptr(), draw.data_ptr(), n, width,
                              image.data_ptr(), mats, biases,
                              scratch.data_ptr(), partials.data_ptr(),
                              demb.data_ptr(), grads.data_ptr(), stream):
            raise RuntimeError("mlp_bwd launch failed")
        return demb, KB.split_grads(grads, shapes)

    def run_vfwd(emb, embv, mw, image):
        out = torch.empty((emb.shape[0], 8), dtype=torch.float32, device=dev)
        mats, biases = K.weight_pointers(mw, KV._MATRIX_IDX, KV._BIAS_IDX)
        if vfwd.nrnerf_mlpv_fwd(emb.data_ptr(), embv.data_ptr(), emb.shape[0],
                                image.data_ptr(), mats, biases, out.data_ptr(),
                                stream):
            raise RuntimeError("mlpv_fwd launch failed")
        return out

    def run_efwd(pts, mw, image):
        out = torch.empty((pts.shape[0], 8), dtype=torch.float32, device=dev)
        mats, biases = K.weight_pointers(mw, K._MATRIX_IDX, K._BIAS_IDX)
        P, phase = KE._projection_on(dev)
        if efwd.nrnerf_mlpe_fwd(pts.data_ptr(), pts.shape[0], image.data_ptr(),
                                P.data_ptr(), phase.data_ptr(), mats, biases,
                                out.data_ptr(), stream):
            raise RuntimeError("mlpe_fwd launch failed")
        return out

    def report(what, n, fn, kernel, err, tol):
        for rep in (1, 2):
            t = device_ms_of(fn)
            print(f"{name} {what} n={n} rep {rep}: {t.get(kernel, 0.0):.4f} ms; "
                  f"max abs err {err:.2e} (tol {tol:.0e}); {smi()}", flush=True)

    # rows 3 and 5 on the flagship's parameters (with view directions for
    # row 3); the points of row 5 where a scene's bent points lie
    gen = torch.Generator(device=dev).manual_seed(3)
    model_v = NRNeRF(ModelConfig(use_viewdirs=True), num_timesteps=1,
                     device="cpu", generator=torch.Generator().manual_seed(1))
    mwv = tuple(w.detach().to(dev) for w in KV.cast_mlpv_weights(
        KV.pack_viewdirs_mlp_weights(model_v.coarse)))
    image_v = pack_views_image(mwv, ("fwd",))
    model = NRNeRF(ModelConfig(), num_timesteps=1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    mwe = tuple(w.detach().to(dev) for w in
                K.cast_mlp_weights(K.pack_mlp_weights(model.coarse)))
    image_e = pack_chain_image(mwe, ("fwd",))
    for n in (1 << 21, 65536):
        emb = torch.rand(n, 64, device=dev, generator=gen) * 2 - 1
        emb[:, 63] = 0
        embv = torch.rand(n, 32, device=dev, generator=gen) * 2 - 1
        embv[:, 27:] = 0
        emb, embv = emb.to(torch.bfloat16), embv.to(torch.bfloat16)
        err = (run_vfwd(emb, embv, mwv, image_v)
               - KV.mlpv_fwd_plain(emb, embv, mwv)).abs().max().item()
        report("mlpv_fwd", n, lambda: run_vfwd(emb, embv, mwv, image_v),
               "mlpv_fwd_kernel", err, KV.BF16_TOL_MAX)
        lo = torch.tensor([-0.8, -0.8, -1.0], device=dev)
        pts = lo + (torch.tensor([0.8, 0.8, 0.5], device=dev) - lo) * torch.rand(
            n, 3, device=dev, generator=gen)
        err = (run_efwd(pts, mwe, image_e)
               - KE.mlpe_fwd_plain(pts, mwe)).abs().max().item()
        report("mlpe_fwd", n, lambda: run_efwd(pts, mwe, image_e),
               "mlp_fwd_kernel", err, K.BF16_TOL_MAX)

    for width in (64, 128):
        if name in HEADS_ONLY and width == 128:
            break
        if width == 64:
            model = NRNeRF(ModelConfig(), num_timesteps=1, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        else:
            model = NRNeRF(ModelConfig(ray_bending=None,
                                       time_conditioned_baseline=True),
                           num_timesteps=2, device="cpu",
                           generator=torch.Generator().manual_seed(2))
        mw = tuple(w.detach().to(dev) for w in
                   K.cast_mlp_weights(K.pack_mlp_weights(model.fine)))
        image_f = pack_chain_image(mw, ("fwd",))
        image_b = pack_chain_image(mw, ("fwd", "bwd"))
        gen = torch.Generator(device=dev).manual_seed(width)
        for n in (1 << 21, 65536):
            emb = (torch.rand(n, width, device=dev, generator=gen) * 2
                   - 1).to(torch.bfloat16)
            err = (run_fwd(emb, mw, image_f) - K.mlp_fwd_plain(emb, mw)).abs()
            for rep in (1, 2):
                t = device_ms_of(lambda: run_fwd(emb, mw, image_f))
                print(f"{name} mlp_fwd {width} lanes n={n} rep {rep}: "
                      f"{t.get('mlp_fwd_kernel', 0.0):.4f} ms; max abs err "
                      f"{err.max().item():.2e} (tol {K.BF16_TOL_MAX:.0e}); "
                      f"{smi()}", flush=True)
        if name in HEADS_ONLY:
            continue
        for n in (65536, 131072):
            embb = (torch.rand(n, width, device=dev, generator=gen) * 2
                    - 1).to(torch.bfloat16)
            draw = torch.randn(n, 8, device=dev, generator=gen)
            stats = KB.bwd_agreement(run_bwd(embb, mw, draw, image_b),
                                     KB.mlp_bwd_plain(embb, mw, draw))
            for rep in (1, 2):
                t = device_ms_of(lambda: run_bwd(embb, mw, draw, image_b))
                print(f"{name} mlp_bwd {width} lanes n={n} rep {rep}: "
                      f"{sum(t.values()):.4f} ms in all: " + ", ".join(
                          f"{k} {v:.4f}" for k, v in sorted(t.items()))
                      + f"; agrees with the plain version: {stats['ok']}; "
                      f"{smi()}", flush=True)


def device_ms_of(fn, reps=5, tries=3):
    """Device ms a call of fn by kernel (`...kernel` names), torch.profiler
    over `reps` calls after one. A profile in which some kernel's launches
    are not a multiple of `reps` lost events (the profiler has been seen to
    drop launches made through ctypes) and is taken again, up to `tries`
    times; the last is returned, after a line that says it too lost
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, count = {}, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            m = re.search(r"(\w*kernel)", e.key)
            key = m.group(1) if m else "other"
            out[key] = out.get(key, 0.0) + e.self_device_time_total / reps / 1e3
            count[key] = count.get(key, 0) + e.count
        if all(c % reps == 0 for c in count.values()):
            return out
    print(f"profile incomplete after {tries} tries: launches {count} over "
          f"{reps} calls; the next reading is short", flush=True)
    return out


def fused_case(dev):
    """Row 9 and 10's case: the cast weights of the flagship's fine network
    (seed 0, its deformation's output layers perturbed so that it bends),
    2^21 points and latents from seed 9, and that generator (for the
    cotangents), through the modules of the tree first on sys.path."""
    from nonrigid_nerf_torch.config import ModelConfig
    from nonrigid_nerf_torch.models.model import NRNeRF
    from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
    from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
    gen = torch.Generator().manual_seed(0)
    model = NRNeRF(ModelConfig(), num_timesteps=1, device="cpu", generator=gen)
    with torch.no_grad():
        for layer, scale in ((model.bender.bend[-1], 0.05),
                             (model.bender.rigidity[-1], 0.3)):
            layer.weight.copy_(scale * torch.randn(layer.weight.shape,
                                                   generator=gen))
        w = tuple(t.to(dev) for t in FF.cast_fused_weights(
            FQ.pack_fused_weights(model, network="fine")))
    g = torch.Generator(device=dev).manual_seed(9)
    lo = torch.tensor([-0.8, -0.8, -1.0], device=dev)
    hi = torch.tensor([0.8, 0.8, 0.5], device=dev)
    n_all = 1 << 21
    pts = lo + (hi - lo) * torch.rand(n_all, 3, device=dev, generator=g)
    lat = 0.1 * torch.randn(n_all, 32, device=dev, generator=g)
    return w, pts, lat, g


def time_fused(name, out_dir, dev, backward):
    """Row 9 (`fused_fwd`) of a built variant at 2^21 and 65,536 points and,
    with `backward`, row 10 (`fused_bwd`) at 65,536 and 131,072, on the
    flagship's fine network (seed 0, its deformation's output layers
    perturbed so that it bends), through the port's wrappers on the
    variant's libraries; device ms twice each (row 10 by kernel), whether
    the outputs agree with the plain versions and whether row 9's equal the
    base's bit for bit (where "base" ran first)."""
    from nonrigid_nerf_torch.ops.kernels import build as B
    from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
    from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
    for source in ("fused_fwd.cu",) + (("fused_bwd.cu",) if backward else ()):
        B._LIBS[source] = ctypes.CDLL(os.path.join(out_dir, name, source + ".so"))
    w, pts, lat, g = fused_case(dev)
    for n in (1 << 21, 65536):
        p, l = pts[:n], lat[:n]
        out = FF.fused_fwd(p, l, w)
        ok = FF.fused_fwd_agreement(out, FF.fused_fwd_plain(p, l, w))["ok"]
        if n == 65536:
            # the outputs beside the base's, where "base" ran before
            torch.save([t.cpu() for t in out],
                       os.path.join(out_dir, f"{name}.fused_fwd.pt"))
            ref = os.path.join(out_dir, "base.fused_fwd.pt")
            if name != "base" and os.path.exists(ref):
                same = all(torch.equal(a.cpu(), b) for a, b in
                           zip(out, torch.load(ref)))
                print(f"{name} fused_fwd n={n}: bit-equal to base: {same}",
                      flush=True)
        for rep in (1, 2):
            t = device_ms_of(lambda: FF.fused_fwd(p, l, w))
            print(f"{name} fused_fwd n={n} rep {rep}: "
                  f"{t.get('mlp_fwd_kernel', 0.0):.4f} ms; agrees with the "
                  f"plain version: {ok}; {smi()}", flush=True)
    if not backward:
        return
    for n in (65536, 131072):
        p, l = pts[:n], lat[:n]
        cots = [torch.randn(n, c, device=dev, generator=g) for c in (8, 3, 1)]
        ok = FB.fused_bwd_agreement(FB.fused_bwd(p, l, w, *cots),
                                    FB.fused_bwd_plain(p, l, w, *cots))["ok"]
        for rep in (1, 2):
            t = device_ms_of(lambda: FB.fused_bwd(p, l, w, *cots))
            print(f"{name} fused_bwd n={n} rep {rep}: {sum(t.values()):.4f} ms "
                  "in all: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(t.items()))
                  + f"; agrees with the plain version: {ok}; {smi()}", flush=True)


def time_bend(name, out_dir, dev):
    """Rows 7 and 8 (`bend_fwd`, `bend_bwd`) of a built variant: row 7 at
    2^21 and 65,536 points, row 8 at 65,536 and 131,072, on the flagship's
    coarse network (seed 0, its deformation perturbed so that it bends),
    through the port's wrappers on the variant's libraries; device ms twice
    each (row 8 with its reduction), whether the outputs agree with the
    plain versions and whether they equal the base's bit for bit (where
    "base" ran first: row 7's outputs and row 8's per-point outputs always
    should; row 8's gradients only on the same grid, which sums them in the
    same order)."""
    from nonrigid_nerf_torch.config import ModelConfig
    from nonrigid_nerf_torch.models.model import NRNeRF
    from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
    from nonrigid_nerf_torch.ops.kernels import bend_fwd as BF
    from nonrigid_nerf_torch.ops.kernels import build as B
    from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
    from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
    for source in ("bend_fwd.cu", "bend_bwd.cu"):
        B._LIBS[source] = ctypes.CDLL(os.path.join(out_dir, name, source + ".so"))
    gen = torch.Generator().manual_seed(0)
    model = NRNeRF(ModelConfig(), num_timesteps=1, device="cpu", generator=gen)
    with torch.no_grad():
        for layer, scale in ((model.bender.bend[-1], 0.05),
                             (model.bender.rigidity[-1], 0.3)):
            layer.weight.copy_(scale * torch.randn(layer.weight.shape,
                                                   generator=gen))
        bw = tuple(t.to(dev) for t in FF.cast_fused_weights(
            FQ.pack_fused_weights(model))[:18])
    g = torch.Generator(device=dev).manual_seed(10)
    lo = torch.tensor([-0.8, -0.8, -1.0], device=dev)
    hi = torch.tensor([0.8, 0.8, 0.5], device=dev)
    pts = lo + (hi - lo) * torch.rand(1 << 21, 3, device=dev, generator=g)
    lat = 0.1 * torch.randn(1 << 21, 32, device=dev, generator=g)
    mine = {}
    for n in (1 << 21, 65536):
        p, l = pts[:n], lat[:n]
        out = BF.bend_fwd(p, l, bw)
        ok = BF.bend_fwd_agreement(out, BF.bend_fwd_plain(p, l, bw))["ok"]
        mine[f"fwd{n}"] = [t.cpu() for t in out] if n == 65536 else None
        for rep in (1, 2):
            t = device_ms_of(lambda: BF.bend_fwd(p, l, bw))
            print(f"{name} bend_fwd n={n} rep {rep}: {t.get('bend_fwd_sm90_kernel', 0.0):.4f} "
                  f"ms; agrees with the plain version: {ok}; {smi()}", flush=True)
    for n in (65536, 131072):
        p, l = pts[:n], lat[:n]
        cots = [0.1 * torch.randn(n, 64, device=dev, generator=g),
                torch.randn(n, 3, device=dev, generator=g),
                torch.randn(n, 1, device=dev, generator=g)]
        got = BB.bend_bwd(p, l, bw, *cots)
        ok = BB.bend_bwd_agreement(got, BB.bend_bwd_plain(p, l, bw, *cots))["ok"]
        mine[f"bwd{n}"] = [got[0].cpu(), got[1].cpu()] + [x.cpu() for x in got[2]]
        for rep in (1, 2):
            t = device_ms_of(lambda: BB.bend_bwd(p, l, bw, *cots))
            print(f"{name} bend_bwd n={n} rep {rep}: {sum(t.values()):.4f} ms in all: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(t.items()))
                  + f"; agrees with the plain version: {ok}; {smi()}", flush=True)
    mine.pop("fwd2097152")
    torch.save(mine, os.path.join(out_dir, f"{name}.bend.pt"))
    ref = os.path.join(out_dir, "base.bend.pt")
    if name != "base" and os.path.exists(ref):
        base = torch.load(ref)
        fwd = all(torch.equal(a, b) for a, b in zip(mine["fwd65536"], base["fwd65536"]))
        for n in (65536, 131072):
            a, b = mine[f"bwd{n}"], base[f"bwd{n}"]
            point = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            grads = all(torch.equal(x, y) for x, y in zip(a[2:], b[2:]))
            print(f"{name} bend n={n}: row 7 bit-equal to base: {fwd}; row 8's dpts "
                  f"and dlat: {point}, its gradients: {grads}", flush=True)


def time_i8(name, out_dir, dev):
    """Row 11 (`mlp_i8`) of a built variant at a render block's two passes
    (2^21 and 2^22 points) on the flagship's coarse parameters, calibrated
    on 65,536 encodings from a seed; device ms twice, and the largest
    difference to `mlp_i8_plain`."""
    from nonrigid_nerf_torch.config import ModelConfig
    from nonrigid_nerf_torch.models.model import NRNeRF
    from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ
    from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import (pack_i8_epilogue,
                                                          pack_i8_image)
    lib = ctypes.CDLL(os.path.join(out_dir, name, "mlp_i8.cu.so"))
    lib.nrnerf_mlp_i8.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 7
    model = NRNeRF(ModelConfig(), num_timesteps=1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(11)
    emb = torch.rand(1 << 22, 64, device=dev, generator=gen) * 2 - 1
    emb[:, 63] = 0
    emb = emb.to(torch.bfloat16)
    scales = KQ.calibrate_act_scales(model.coarse, emb[:65536].float().cpu())
    qw = tuple(w.to(dev) for w in KQ.pack_int8_mlp_weights(model.coarse, scales))
    image = pack_i8_image([qw[i] for i in KQ._I8_MATRIX_IDX])
    epi = pack_i8_epilogue([qw[i] for i in KQ._I8_DEQ_IDX],
                           [qw[i] for i in KQ._I8_BIAS_IDX])
    stream = torch.cuda.current_stream().cuda_stream

    def run(e):
        out = torch.empty((e.shape[0], 8), dtype=torch.float32, device=dev)
        if lib.nrnerf_mlp_i8(e.data_ptr(), e.shape[0], image.data_ptr(),
                             epi.data_ptr(), qw[KQ._I8_OW].data_ptr(),
                             qw[KQ._I8_OB].data_ptr(), qw[KQ._I8_QM].data_ptr(),
                             out.data_ptr(), stream):
            raise RuntimeError("mlp_i8 launch failed")
        return out

    for n in (1 << 21, 1 << 22):
        e = emb[:n]
        err = (run(e) - KQ.mlp_i8_plain(e, qw)).abs().max().item()
        for rep in (1, 2):
            t = device_ms_of(lambda: run(e))
            print(f"{name} mlp_i8 n={n} rep {rep}: "
                  f"{t.get('mlp_i8_kernel', 0.0):.4f} ms; max abs err "
                  f"{err:.2e} (tol {KQ.I8_TOL_MAX:.0e}); {smi()}", flush=True)


STEP_WARMUP, STEP_TIMED = 30, 50


def time_row9(root, dev):
    """Row 9 of the tree at `root` through its own wrapper on `fused_case`:
    device ms at 2^21 points (torch.profiler, 5 calls) and ms with the host
    at 65,536 (CUDA events, 20 calls), three times each."""
    import chip_smoke as cs
    from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
    w, pts, lat, _ = fused_case(dev)
    p, l = pts[:65536], lat[:65536]
    for rep in (1, 2, 3):
        t = device_ms_of(lambda: FF.fused_fwd(pts, lat, w))
        host = cs.cuda_time_ms(lambda: FF.fused_fwd(p, l, w), 20)
        print(f"row9 {root}: rep {rep}: n=2097152 device "
              f"{t.get('mlp_fwd_kernel', 0.0):.4f} ms; n=65536 {host:.4f} ms "
              "with the host", flush=True)


def run_steps(root, modes):
    """The frames and training steps of the tree at `root` (see the top) in
    `modes` (F, V, P, B; I renders only, and times the tree's `mlp_i8`; R
    times the tree's row 9 alone)."""
    import dataclasses
    import time
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.apps.train import step_generator
    from nonrigid_nerf_torch.config import (load_args, model_config_from_args,
                                            render_settings_from_args,
                                            train_config_from_args)
    from nonrigid_nerf_torch.engine.train_state import create_train_state
    from nonrigid_nerf_torch.engine.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    args = load_args(os.path.join(root, "configs", "example_sequence.txt"))
    args.seed = cs.SEED
    cfg = model_config_from_args(args)
    args_tc = load_args(os.path.join(root, "results", "r4_baseline_tc",
                                     "args.txt"))
    args_tc.seed = cs.SEED
    ds = cs.synthetic_dataset(device)
    configs = {"F": (cfg, args),
               "V": (dataclasses.replace(cfg, use_viewdirs=True), args),
               "P": (dataclasses.replace(cfg, fused_kernel="pts"), args),
               "B": (model_config_from_args(args_tc), args_tc),
               "I": (dataclasses.replace(cfg, fused_kernel="int8"), args)}
    for what in modes:
        if what == "R":
            time_row9(root, device)
            continue
        cfg_x, args_x = configs[what]
        tc = train_config_from_args(args_x)
        rs = render_settings_from_args(args_x, ds.near, ds.far)
        # frames first: chip_smoke.py's two poses through render_path, after
        # a warm-up frame at 1/8 of the size
        model = cs.flagship_model(cfg if what == "I" else cfg_x, device)
        poses, intrinsics = cs.synthetic_poses()
        rs_frames = render_settings_from_args(args_x, near=0.1, far=1.6)
        latents = model.latents.detach().cpu().numpy()
        if what == "I":     # calibrated on the first pose, as chip_smoke.py does
            from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ
            from nonrigid_nerf_torch.ops.rays import get_rays
            rays_o, rays_d = get_rays(torch.as_tensor(poses[0], device=device),
                                      intrinsics[0])
            model = KQ.quantize_for_inference(
                model, cfg, rays_o, rays_d,
                model.latents[:1].detach().expand(cs.H * cs.W, -1),
                rs_frames.near, rs_frames.far)
        with torch.no_grad():
            render_path(model, cfg_x, rs_frames, poses[:1], intrinsics[:1],
                        latents[:1], chunk=cs.CHUNK, render_factor=8,
                        verbose=False, device=device)
        torch.cuda.synchronize()
        _, _, frame_s = cs.render_frames(model, cfg_x, rs_frames, poses,
                                         intrinsics, latents, device, what)
        print(f"frames {root} {what}: " + ", ".join(f"{t:.4f}" for t in frame_s)
              + f" s; mean {sum(frame_s) / len(frame_s):.4f} s", flush=True)
        if what == "I":     # rendering only: the tree's kernel, then no steps
            qw = model.quant["coarse"].packed
            gen = torch.Generator(device=device).manual_seed(11)
            emb = (torch.rand(1 << 22, 64, device=device, generator=gen) * 2
                   - 1).to(torch.bfloat16)
            for n in (1 << 21, 1 << 22):
                ms = cs.cuda_time_ms(lambda: KQ.mlp_i8(emb[:n], qw), 10)
                print(f"frames {root} I: mlp_i8 n={n} {ms:.4f} ms", flush=True)
            continue
        del model
        state = create_train_state(cfg_x, tc, cs.TRAIN_FRAMES, device=device)
        step_fn = make_train_step(cfg_x, tc, rs, has_test_split=True)

        def steps(k):
            for _ in range(k):
                step_fn(state, ds, step_generator(tc.seed, state.step, device))

        steps(STEP_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(STEP_TIMED)
        torch.cuda.synchronize()
        rate = STEP_TIMED / (time.perf_counter() - t0)
        prof = cs.profile_run(lambda: steps(cs.PROFILE_STEPS),
                              f"{cs.PROFILE_STEPS} steps ({what})")
        top = "; ".join(f"{k[:40]} {v / cs.PROFILE_STEPS:.4f}"
                        for k, v in prof["top"][:6])
        print(f"steps {root} {what}: {rate:.2f} steps/s over {STEP_TIMED}, "
              f"device {prof['device_busy_ms'] / cs.PROFILE_STEPS:.3f} ms a "
              f"step, idle share {prof['idle_share']:.3f}; top kernels, ms a "
              f"step: {top}", flush=True)


def compare_steps(other, modes) -> int:
    print(smi(), flush=True)
    failed = False
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--steps-child", os.path.abspath(root), *modes],
                           capture_output=True, text=True, timeout=600)
        print("".join(line + "\n" for line in r.stdout.splitlines()
                      if line.startswith(("steps ", "frames ", "row9 ", "profile "))), end="",
              flush=True)
        if r.returncode:
            failed = True
            print(f"{root}: exit {r.returncode}\n{r.stderr[-2000:]}", flush=True)
    return 1 if failed else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        run_variant(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--steps-child":
        run_steps(sys.argv[2], sys.argv[3:])
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--steps":
        modes = sys.argv[3:] or ["V", "P"]
        if any(m not in ("F", "V", "P", "B", "I", "R") for m in modes):
            print(f"chip_variants: modes are F, V, P, B, I and R, got {modes}",
                  file=sys.stderr)
            return 2
        return compare_steps(sys.argv[2], modes)
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"chip_variants: unknown variants {unknown}; known: "
              f"{list(VARIANTS)}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    print(smi(), flush=True)
    with tempfile.TemporaryDirectory() as out_dir:
        not_built = build(names, out_dir)
        failed = bool(not_built)
        for name in names:
            if name in not_built:
                continue
            try:
                r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                    "--child", name, out_dir],
                                   capture_output=True, text=True,
                                   timeout=CHILD_TIMEOUT_S)
                print(r.stdout, end="", flush=True)
                if r.returncode:
                    failed = True
                    print(f"{name}: exit {r.returncode}\n{r.stderr[-2000:]}",
                          flush=True)
            except subprocess.TimeoutExpired:
                failed = True
                print(f"{name}: cut off after {CHILD_TIMEOUT_S} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
