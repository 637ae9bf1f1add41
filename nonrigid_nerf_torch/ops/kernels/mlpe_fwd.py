"""The canonical 8 x 256 NeRF MLP forward on bent POINTS, with the Fourier
encoding computed inside the hand-written CUDA kernel (`fused_kernel="pts"`).

Counterpart of the Pallas kernel `_mlpe_core` (forward `_mlpe_pallas_fwd`,
`_embed_ew` then `_mlp_fwd_math`,
nonrigid_nerf_tpu/ops/pallas/fused_query.py:86-102,875-947).

- `embedding_projection()` gives P (8, 64) and phase (64,) with
  `emb = where(lane < 3, pre, sin(pre + phase))`, `pre = pts @ P`: every column
  of P has one entry, a power of two, so `pre` is exact; the cosine lanes are
  `sin(pre + pi/2)`; the pad lane 63 has no entry and phase 0, so it is
  `sin(0) = 0`. Only `multires == 10` is supported, so P and phase are
  constants of the encoding and no weights: the packed weights are the 19 of
  `pack_mlp_weights`.
- `embed_ew(pts)` is that encoding in plain PyTorch, in f32.
- `mlpe_fwd(pts, mw)` runs the kernel (`csrc/mlpe_fwd.cu`) on a CUDA tensor
  and the plain version `mlpe_fwd_plain` on a CPU tensor. It never falls back:
  a CUDA tensor either launches the kernel or raises. The points are read as
  (n, 3) f32 as they stand (the TPU kernel pads them to 8 lanes; no pad copy
  here).

The kernel is bound by the tensor cores (0.987 MFLOP per point, as `mlp_fwd`)
and moves 44 B per point against `mlp_fwd`'s 160; see the source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    BF16_TOL_MAX, BF16_TOL_MEAN, EMB, MACS_PER_POINT, N_MLP_W, OUT_PAD,
    _BIAS_IDX, _MATRIX_IDX, _expected_shape, check_kernel_weights,
    mlp_fwd_plain, weight_pointers)

# the chain is `mlp_fwd`'s: its work per point and its bf16 tolerances hold
__all__ = ["BF16_TOL_MAX", "BF16_TOL_MEAN", "MACS_PER_POINT", "MULTIRES",
           "PTS", "check_pts_args", "embed_ew", "embedding_projection",
           "mlpe_fwd", "mlpe_fwd_plain"]

PTS = 3           # coordinates per point, as the kernel reads them
PTS_PAD = 8       # rows of P (the TPU kernel's lane padding of the points)
MULTIRES = 10     # the only encoding the kernel computes


def embedding_projection(multires: int = MULTIRES
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """P (8, 64) and phase (64,), f32, such that the encoding
    [x, y, z, sin(2^k x..z), cos(2^k x..z), ...] equals
    where(lane < 3, pre, sin(pre + phase)) with pre = pts_pad @ P."""
    if 3 + 6 * multires > EMB:
        raise ValueError(f"multires={multires} does not fit {EMB} lanes")
    P = np.zeros((PTS_PAD, EMB), np.float32)
    phase = np.zeros((EMB,), np.float32)
    for j in range(3):
        P[j, j] = 1.0
    c = 3
    for k in range(multires):
        for is_cos in (0, 1):
            for j in range(3):
                P[j, c] = 2.0 ** k
                phase[c] = (np.pi / 2.0) if is_cos else 0.0
                c += 1
    return P, phase


@functools.lru_cache(maxsize=None)
def _projection_on(device: torch.device):
    """(P[:3] (3, 64), phase (64,)) as tensors on `device`; read only."""
    P, phase = embedding_projection()
    return (torch.from_numpy(P[:PTS]).to(device),
            torch.from_numpy(phase).to(device))


def embed_ew(pts: torch.Tensor):
    """(pre, emb), both (n, 64) f32, of pts (n, 3) f32: `_embed_ew` without
    the matmul, three f32 broadcast-multiplies (exact: the entries of P are
    powers of two)."""
    P, phase = _projection_on(pts.device)
    pre = (pts[:, 0:1] * P[0:1, :] + pts[:, 1:2] * P[1:2, :]
           + pts[:, 2:3] * P[2:3, :])
    lane = torch.arange(EMB, device=pts.device)
    return pre, torch.where(lane < 3, pre, torch.sin(pre + phase))


def mlpe_fwd_plain(pts: torch.Tensor, mw: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the encoding in f32, cast to
    bf16, then `mlp_fwd_plain`. pts (n, 3) f32, mw from `cast_mlp_weights`.
    Returns (n, 8) f32."""
    return mlp_fwd_plain(embed_ew(pts.float())[1].to(torch.bfloat16), mw)


def check_pts_args(pts, mw, what: str):
    """pts (n, 3) and the 19 cast weights on its device."""
    if pts.dim() != 2 or pts.shape[1] != PTS:
        raise ValueError(f"pts must be (n, {PTS}), got {tuple(pts.shape)}")
    if len(mw) != N_MLP_W:
        raise ValueError(f"expected {N_MLP_W} packed weights, got {len(mw)}")
    for i, w in enumerate(mw):
        want = torch.bfloat16 if i in _MATRIX_IDX else torch.float32
        if w.dtype != want or w.device != pts.device:
            raise ValueError(f"{what}: packed weight {i} must be {want} on "
                             f"{pts.device}, got {w.dtype} on {w.device}")


def mlpe_fwd(pts: torch.Tensor, mw: Sequence[torch.Tensor]) -> torch.Tensor:
    """raw (n, 8) f32 = the canonical MLP on the encoding of pts (n, 3) f32.

    On a CPU tensor this is `mlpe_fwd_plain`. On a CUDA tensor it launches
    the CUDA kernel on the current stream (and counts the launch in
    `mlpe_fwd.launches`), or raises."""
    check_pts_args(pts, mw, "mlpe_fwd")
    if pts.device.type == "cpu":
        return mlpe_fwd_plain(pts, mw)
    if pts.device.type != "cuda":
        raise ValueError(f"mlpe_fwd runs on cpu or cuda, not {pts.device}")
    pts = pts.float().contiguous()
    check_kernel_weights(mw, _expected_shape, "mlpe_fwd")
    for t in mw:     # the coordinates are read one f32 at a time
        if t.data_ptr() % 16:
            raise ValueError("mlpe_fwd needs 16-byte aligned weights")
    n = pts.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"mlpe_fwd takes fewer than 2^31 points, got {n}")
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=pts.device)
    if n == 0:      # nothing to launch, nothing to count
        return out
    lib = _library()
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.nrnerf_mlpe_fwd(pts.data_ptr(), n, mats, biases,
                                  out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlpe_fwd kernel launch failed: CUDA error {err}")
    mlpe_fwd.launches += 1
    return out


mlpe_fwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("mlpe_fwd.cu")
    fn = lib.nrnerf_mlpe_fwd
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ptrs, ptrs,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
