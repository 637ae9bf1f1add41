#!/usr/bin/env python3
"""Time variants of rows 1-2's CUDA sources on one NVIDIA GPU.

    python3 chip_variants.py                  # every variant below
    python3 chip_variants.py base no_epilogue_stores

A variant is a list of text substitutions applied to a copy of
`nonrigid_nerf_torch/ops/kernels/csrc/` (the sources in this checkout stay
as they are). Each copy's `mlp_fwd.cu` and `mlp_bwd.cu` are built with the
port's nvcc flags, one nvcc per source and all started together, into a
temporary directory. Then, one child process per variant (so that a variant
that hangs is cut off after `CHILD_TIMEOUT_S` without taking the others with
it), the script:

- times `mlp_fwd` at a render block's coarse pass (2^21 points) and a
  training step's (65,536) and `mlp_bwd` at a training step's two passes
  (65,536 and 131,072), at the 64-lane and the 128-lane encoding, as the
  device time of each kernel under torch.profiler over 5 calls, twice;
- holds the variant's outputs against the plain versions (a variant that
  cuts work out of a kernel is expected to disagree: it measures what that
  work costs).

It prints the card's name and power limit first and one line per variant,
size and repetition. It exits non-zero when no CUDA device is present.
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
SOURCES = ("mlp_fwd.cu", "mlp_bwd.cu")
CHILD_TIMEOUT_S = 150

# name -> [(file, text, replacement)]
VARIANTS = {
    "base": [],
    # the producer arrives on each "full" barrier without copying a chunk:
    # what the L2 stream of weights costs
    "no_weight_copies": [(
        "mlp_sm90.cuh",
        "      mbar_expect_tx(bars + 8 * s, CHUNK_BYTES);\n"
        "      bulk_load(ring + s * CHUNK_BYTES, image + size_t(c) * CHUNK_ELEMS, CHUNK_BYTES,\n"
        "                bars + 8 * s);",
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
        "  float acc[32];\n"
        "#pragma unroll 1\n"
        "  for (int c = 0; c < N; ++c, ++g) {\n"
        "    nt_issue<S>(acc, cur, ring, bars, g, wg);\n"
        "    wgmma_wait<0>();\n"
        "    fence_acc(acc);\n"
        "    ring_release<S>(bars, g, t == 0);\n"
        "    if (gate != nullptr) {\n"
        "      dh_epilogue(acc, gate[c], c, oth, wg, t);\n"
        "    } else {\n"
        "      demb_epilogue<E>(acc, c, demb, rows_left, add, wg, t);\n"
        "    }\n"
        "  }\n",
        "  float acc[2][32];\n"
        "  nt_issue<S>(acc[0], cur, ring, bars, g, wg);\n"
        "#pragma unroll\n"
        "  for (int c = 0; c < N; ++c) {\n"
        "    if (c + 1 < N) {\n"
        "      nt_issue<S>(acc[(c + 1) % 2], cur, ring, bars, g + c + 1, wg);\n"
        "      wgmma_wait<1>();\n"
        "    } else {\n"
        "      wgmma_wait<0>();\n"
        "    }\n"
        "    fence_acc(acc[c % 2]);\n"
        "    ring_release<S>(bars, g + c, t == 0);\n"
        "    if (gate != nullptr) {\n"
        "      dh_epilogue(acc[c % 2], gate[c], c, oth, wg, t);\n"
        "    } else {\n"
        "      demb_epilogue<E>(acc[c % 2], c, demb, rows_left, add, wg, t);\n"
        "    }\n"
        "  }\n"
        "  g += N;\n")],
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
        for s in SOURCES:
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nonrigid_nerf_torch.config import ModelConfig
    from nonrigid_nerf_torch.models.model import NRNeRF
    from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
    from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
    from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import pack_chain_image

    dev = torch.device("cuda")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
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

    def device_ms_by_kernel(fn, reps=5):
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
            m = re.search(r"(mlp_\w+kernel)", e.key)
            key = m.group(1) if m else "other"
            out[key] = out.get(key, 0.0) + e.self_device_time_total / reps / 1e3
        return out

    for width in (64, 128):
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
                t = device_ms_by_kernel(lambda: run_fwd(emb, mw, image_f))
                print(f"{name} mlp_fwd {width} lanes n={n} rep {rep}: "
                      f"{t.get('mlp_fwd_kernel', 0.0):.4f} ms; max abs err "
                      f"{err.max().item():.2e} (tol {K.BF16_TOL_MAX:.0e}); "
                      f"{smi()}", flush=True)
        for n in (65536, 131072):
            embb = (torch.rand(n, width, device=dev, generator=gen) * 2
                    - 1).to(torch.bfloat16)
            draw = torch.randn(n, 8, device=dev, generator=gen)
            stats = KB.bwd_agreement(run_bwd(embb, mw, draw, image_b),
                                     KB.mlp_bwd_plain(embb, mw, draw))
            for rep in (1, 2):
                t = device_ms_by_kernel(lambda: run_bwd(embb, mw, draw, image_b))
                print(f"{name} mlp_bwd {width} lanes n={n} rep {rep}: "
                      f"{sum(t.values()):.4f} ms in all: " + ", ".join(
                          f"{k} {v:.4f}" for k, v in sorted(t.items()))
                      + f"; agrees with the plain version: {stats['ok']}; "
                      f"{smi()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        run_variant(sys.argv[2], sys.argv[3])
        return 0
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
