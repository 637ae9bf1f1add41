#!/usr/bin/env python3
"""Time variants of rows 1-3, 5 and 11's CUDA sources on one NVIDIA GPU.

    python3 chip_variants.py                  # every variant below
    python3 chip_variants.py base no_epilogue_stores
    python3 chip_variants.py --steps OTHER    # training steps, two trees
    python3 chip_variants.py --steps OTHER I  # int8 frames and mlp_i8, two trees

A variant is a list of text substitutions applied to a copy of
`nonrigid_nerf_torch/ops/kernels/csrc/` (the sources in this checkout stay
as they are). Each copy's `mlp_fwd.cu`, `mlp_bwd.cu`, `mlpv_fwd.cu`,
`mlpe_fwd.cu` and `mlp_i8.cu` (a variant of row 11: that one alone) are
built with the port's nvcc flags, one nvcc per source and all started
together, into a temporary directory. Then, one child process per variant
(so that a variant that hangs is cut off after `CHILD_TIMEOUT_S` without
taking the others with it), the script:

- times `mlp_i8` at a render block's two passes (2^21 and 2^22 points), and
  for a variant of row 11 nothing else;
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
`fused_kernel="pts"` mode (P), or the modes named after OTHER, it renders
`chip_smoke.py`'s two 384 x 512 frames through `render_path` (s per frame,
host clock, each ending in a copy to the host), trains on its synthetic
stack for 30 steps, times 50 more (steps/s, host clock), and profiles 5
(`chip_smoke.profile_run` of that tree: device ms a step, the card's idle
share, the top kernels). In `fused_kernel="int8"` mode (I), which does not
train, it calibrates on the first pose as `chip_smoke.py` does, renders the
frames and times the tree's `mlp_i8` at 2^21 and 2^22 points (CUDA events,
10 calls) on the coarse network's packed weights.
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
           "mlp_i8.cu")
CHILD_TIMEOUT_S = 150
# variants that change rows 3 and 5 only: the child times rows 3 and 5 and,
# as the yardstick, row 1 at 64 lanes
HEADS_ONLY = ("pts_encode_on_consumers", "pts_no_sines", "pts_no_encoding")
# variants that change row 11 only: the child times row 11 alone
I8_ONLY = ("i8_2_stages", "i8_quantize_on_consumers", "i8_head_on_cuda_cores")

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
         "  __device__ void encode(uint32_t, uint32_t, int, int, int) const {}\n"
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
        "    const float y = c < 3 ? pre : sinf(pre + __ldg(phase + c));",
        "    const float y = c < 3 ? pre : pre + __ldg(phase + c);")],
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


def build(names, out_dir):
    """Patched copies of csrc/, both sources built side by side."""
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
            if text not in src:
                raise AssertionError(f"variant {name}: {f} has no {text[:60]!r}")
            with open(path, "w") as fh:
                fh.write(src.replace(text, repl))
        for s in (("mlp_i8.cu",) if name in I8_ONLY else SOURCES):
            procs[(name, s)] = subprocess.Popen(
                [nvcc, *B.NVCC_FLAGS, "-o", os.path.join(d, s + ".so"),
                 os.path.join(d, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, s), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{s}:\n{log}")
        notes = [l.strip() for l in log.splitlines()
                 if "C75" in l or ("spill" in l and " 0 bytes spill" not in l)]
        print(f"build {name}/{s}: " + (" | ".join(notes)[:400] or "no spills"),
              flush=True)


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
    time_i8(name, out_dir, dev)
    if name in I8_ONLY:
        return
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


def device_ms_of(fn, reps=5):
    """Device ms a call of fn by kernel (`mlp*kernel` names), torch.profiler
    over `reps` calls after one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        m = re.search(r"(mlp\w*kernel)", e.key)
        key = m.group(1) if m else "other"
        out[key] = out.get(key, 0.0) + e.self_device_time_total / reps / 1e3
    return out


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


def run_steps(root, modes):
    """The frames and training steps of the tree at `root` (see the top) in
    `modes` (V, P; I renders only, and times the tree's `mlp_i8`)."""
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
    ds = cs.synthetic_dataset(device)
    tc = train_config_from_args(args)
    rs = render_settings_from_args(args, ds.near, ds.far)
    configs = {"V": dataclasses.replace(cfg, use_viewdirs=True),
               "P": dataclasses.replace(cfg, fused_kernel="pts"),
               "I": dataclasses.replace(cfg, fused_kernel="int8")}
    for what in modes:
        cfg_x = configs[what]
        # frames first: chip_smoke.py's two poses through render_path, after
        # a warm-up frame at 1/8 of the size
        model = cs.flagship_model(cfg if what == "I" else cfg_x, device)
        poses, intrinsics = cs.synthetic_poses()
        rs_frames = render_settings_from_args(args, near=0.1, far=1.6)
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
                      if line.startswith(("steps ", "frames "))), end="",
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
        if any(m not in ("V", "P", "I") for m in modes):
            print(f"chip_variants: modes are V, P and I, got {modes}",
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
    failed = False
    with tempfile.TemporaryDirectory() as out_dir:
        build(names, out_dir)
        for name in names:
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
