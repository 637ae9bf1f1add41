"""The fused point query forward: deformation field, encoding and canonical
8 x 256 MLP in one hand-written CUDA kernel.

Counterpart of the Pallas kernel `_fused_core` (forward `_fwd_pallas`, math
`_forward_math`, nonrigid_nerf_tpu/ops/pallas/fused_query.py:218-304).

- `fused_fwd(pts, lat, w)` runs the kernel (`csrc/fused_fwd.cu`) on a CUDA
  tensor and the plain version `fused_fwd_plain` on a CPU tensor. It never
  falls back: a CUDA tensor either launches the kernel or raises. `w` is the
  37-tuple of `cast_fused_weights`: the bender's 18, then the canonical MLP's
  19 (`ops/kernels/fused_query.py:pack_fused_weights` builds the f32 tuple).
- `fused_fwd_plain` is `bend_fwd_plain` followed by `mlp_fwd_plain` on the
  bf16 encoding, so on the CPU the monolith and the split variant
  (`bend_fwd`, then `mlp_fwd`) run the same arithmetic.

Bound by the tensor cores (the chain's 493,568 MACs per point, and the
bender's 15,872, against 188 B of HBM traffic per point); see the source.
The kernel is row 1's chain (`mlp_sm90.cuh`) with the deformation field
beside it (its products on the consumers' wgmma a tile ahead, the offsets
and the encoding on the producer warpgroup's idle warps), so the wrapper
passes row 1's weight image (`mlp_sm90.pack_chain_image(mw, ("fwd",))`)
and the 18 cast bender weights, which each CTA stages as the bender's image
(`mlp_sm90.pack_bend_image`'s layout: its weights, biases and the
encoding's P and phase), as rows 7, 8 and 10 do.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels.bend_fwd import (
    BEND_TOL_OFF, BEND_TOL_RIG, N_BEND_W, bend_fwd_plain, cast_bend_weights,
    bend_weight_pointers, check_bend_args, kernel_inputs)
from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import pack_chain_image
from nonrigid_nerf_torch.ops.kernels.mlpe_fwd import PTS

N_FUSED_W = N_BEND_W + K.N_MLP_W     # 37, the JAX tuple
# raw's limit where the encoding comes from two implementations of the bender
# (see bend_fwd.py): a point whose offsets moved by a flipped bf16 rounding
# has its top-frequency lanes moved by up to 0.35, which reaches raw. Observed
# on an H100, kernel vs plain: max 5.2e-4 / 1.6e-3 / 1.9e-3 at 65,536 /
# 131,072 / 2^21 points (mean 2.2e-7 / 2.5e-7 / 2.3e-7, within
# `mlp_fwd.BF16_TOL_MEAN`), against 2.6e-4 at 2^21 for the chain on the same
# encoding. Three times the largest reading. On the CPU against the JAX math
# no offset flipped and raw stays within `mlp_fwd.BF16_TOL_MAX`.
FUSED_TOL_RAW_MAX = 6e-3


def cast_fused_weights(packed: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, ...]:
    """`cast_bend_weights` of the first 18, `cast_mlp_weights` of the last
    19."""
    return (cast_bend_weights(packed[:N_BEND_W])
            + K.cast_mlp_weights(packed[N_BEND_W:]))


def fused_fwd_plain(pts: torch.Tensor, lat: torch.Tensor,
                    w: Sequence[torch.Tensor]):
    """Plain PyTorch version of the kernel: `_forward_math`. pts (n, 3), lat
    (n, 32) f32, w from `cast_fused_weights`. Returns raw (n, 8), off (n, 3),
    rig (n, 1), f32."""
    emb, off, rig = bend_fwd_plain(pts, lat, w[:N_BEND_W])
    return K.mlp_fwd_plain(emb.to(torch.bfloat16), w[N_BEND_W:]), off, rig


def fused_fwd_agreement(got, ref) -> dict:
    """Error statistics of (raw, off, rig) against a reference triple, and
    `ok`: raw within FUSED_TOL_RAW_MAX and `mlp_fwd.BF16_TOL_MEAN`, the
    offsets and the rigidity within bend_fwd.py's limits."""
    err = (got[0] - ref[0]).abs().double()
    n = err.numel()
    out = {"raw_max": err.max().item() if n else 0.0,
           "raw_mean": err.mean().item() if n else 0.0,
           "off": (got[1] - ref[1]).abs().max().item() if n else 0.0,
           "rig": (got[2] - ref[2]).abs().max().item() if n else 0.0,
           "finite": all(bool(torch.isfinite(t).all()) for t in got)}
    out["ok"] = (out["finite"] and out["raw_max"] <= FUSED_TOL_RAW_MAX
                 and out["raw_mean"] <= K.BF16_TOL_MEAN
                 and out["off"] <= BEND_TOL_OFF and out["rig"] <= BEND_TOL_RIG)
    return out


def check_fused_args(pts, lat, w, what: str):
    if len(w) != N_FUSED_W:
        raise ValueError(f"expected {N_FUSED_W} packed weights, got {len(w)}")
    check_bend_args(pts, lat, w[:N_BEND_W], what)
    for i, t in enumerate(w[N_BEND_W:]):
        want = torch.bfloat16 if i in K._MATRIX_IDX else torch.float32
        if t.dtype != want or t.device != pts.device:
            raise ValueError(f"{what}: packed MLP weight {i} must be {want} on "
                             f"{pts.device}, got {t.dtype} on {t.device}")


def mlp_pointers(mw):
    """The ctypes arrays of the canonical MLP's pointers, after the checks
    its CUDA kernels need."""
    K.check_kernel_weights(mw, K._expected_shape, "canonical MLP")
    for t in mw:
        if t.data_ptr() % 16:
            raise ValueError("the chain kernels need 16-byte aligned weights")
    return K.weight_pointers(mw, K._MATRIX_IDX, K._BIAS_IDX)


def fused_fwd(pts: torch.Tensor, lat: torch.Tensor, w: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(raw (n, 8), off (n, 3), rig (n, 1)), f32, of the fused point query at
    pts (n, 3) with latents lat (n, 32).

    On a CPU tensor this is `fused_fwd_plain`. On a CUDA tensor it launches
    the CUDA kernel on the current stream (and counts the launch in
    `fused_fwd.launches`), or raises."""
    check_fused_args(pts, lat, w, "fused_fwd")
    if pts.device.type == "cpu":
        return fused_fwd_plain(pts, lat, w)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_fwd runs on cpu or cuda, not {pts.device}")
    pts, lat = kernel_inputs(pts, lat)
    bend_weights = bend_weight_pointers(w[:N_BEND_W])
    mats, biases = mlp_pointers(w[N_BEND_W:])
    n, device = pts.shape[0], pts.device
    if n >= 2 ** 31:
        raise ValueError(f"fused_fwd takes fewer than 2^31 points, got {n}")
    raw = torch.empty((n, K.OUT_PAD), dtype=torch.float32, device=device)
    off = torch.empty((n, PTS), dtype=torch.float32, device=device)
    rig = torch.empty((n, 1), dtype=torch.float32, device=device)
    if n == 0:      # nothing to launch, nothing to count
        return raw, off, rig
    lib = _library()
    image = pack_chain_image(w[N_BEND_W:], ("fwd",))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nrnerf_fused_fwd(
            pts.data_ptr(), lat.data_ptr(), n, bend_weights,
            image.data_ptr(), mats, biases, raw.data_ptr(), off.data_ptr(),
            rig.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_fwd kernel launch failed: CUDA error {err}")
    fused_fwd.launches += 1
    return raw, off, rig


fused_fwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("fused_fwd.cu")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.nrnerf_fused_fwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ptrs,
         ctypes.c_void_p, ptrs, ptrs] + [ctypes.c_void_p] * 4)
    lib.nrnerf_fused_fwd.restype = ctypes.c_int
    return lib
