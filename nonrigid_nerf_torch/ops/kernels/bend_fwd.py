"""The deformation field forward (bending and rigidity networks, bent points,
Fourier encoding) as a hand-written CUDA kernel.

Counterpart of the Pallas kernel `_bend_core` (forward `_bend_fwd_kernel`,
math `_bend_fwd_math`, nonrigid_nerf_tpu/ops/pallas/fused_query.py:511-540,
630-644) and of the first 18 arrays of its weight packing
`pack_fused_weights` (fused_query.py:156-183).

- `pack_bend_weights(bender)` flattens the flagship `BendingNetwork` (5 x 64
  with ReLU, rigidity 3 x 32, latent 32) into the 18 padded f32 tensors of the
  JAX packing, in the JAX (fan_in, fan_out) layout: differentiable, so the
  gradients of the packed tensors reach the `nn.Linear` parameters. P and the
  phase (16, 17) are constants of the encoding (`embedding_projection`).
- `cast_bend_weights(packed)` casts the nine matrices to bf16 once; biases, P
  and the phase stay f32 (`_cast_matmul_weights`).
- `bend_fwd(pts, lat, bw)` runs the kernel (`csrc/bend_fwd.cu`) on a CUDA
  tensor and the plain version `bend_fwd_plain` on a CPU tensor. It never
  falls back: a CUDA tensor either launches the kernel or raises. The points
  are read as (n, 3) f32 as they stand (the TPU kernel pads them to 8 lanes),
  and only the meaningful lanes of the padded outputs come back: offsets
  (n, 3), rigidity (n, 1).

The kernel stages the bender's image (`mlp_sm90.pack_bend_image`'s layout:
its weights, biases and the encoding's P and phase) into each CTA's shared
memory straight from the 18 cast weights, so a call packs nothing on the
host; it is bound by HBM traffic (the f32 encoding it writes); see the
source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    EMB, _pad_b, _pad_w, check_kernel_weights, mm_bf16)
from nonrigid_nerf_torch.ops.kernels.mlpe_fwd import (
    MULTIRES, PTS, PTS_PAD, embed_ew, embedding_projection)

LAT = 32          # ray-bending latent size
BW = 64           # bending hidden width
RW = 32           # rigidity hidden width
BEND_DEPTH = 5    # four hidden layers and the offsets' layer
RIGIDITY_DEPTH = 3
N_BEND_W = 18
# the nonzero products per point (the padded packing holds 16,896):
# [pts, lat] -> 64, 3 x 64 -> 64, 64 -> 3, pts -> 32, 32 -> 32, 32 -> 1
BEND_MACS_PER_POINT = (PTS + LAT) * BW + 3 * BW * BW + BW * PTS + PTS * RW \
    + RW * RW + RW
# Agreement of two implementations of the bender (this kernel, its plain
# version, the JAX math): f32 sums in another order flip an occasional bf16
# rounding of a hidden activation (about one point in a thousand), which moves
# that point's offsets or rigidity by one bf16 ulp of the activation times
# its weight, and the sines amplify the bent point's change by up to 2^9 on
# the top frequency. Limits, as absolute errors:
# - offsets (|off| up to 0.4) BEND_TOL_OFF, rigidity (in 0..1) BEND_TOL_RIG;
# - the encoding (in -1..1): mean BEND_TOL_EMB_MEAN, and at most
#   BEND_TOL_EMB_OUTLIERS of its entries off by more than BEND_TOL_EMB_ENTRY
#   (a flipped point's high-frequency lanes move by up to 0.35);
# - raw of the fused kernel, where such a point's encoding feeds the chain:
#   max `fused_fwd.FUSED_TOL_RAW_MAX`, mean `mlp_fwd.BF16_TOL_MEAN`.
# Observed on the CPU, plain vs JAX math, n = 300 and 700 (no flip): offsets
# 3.0e-8, rigidity 8.9e-8, encoding max 1.2e-4 / mean 1.7e-7. Observed on an
# H100, kernel vs plain, at 65,536 / 131,072 / 2^21 points: offsets 3.5e-4 /
# 8.7e-4 / 9.7e-4, rigidity 7.7e-4 / 1.0e-3 / 1.3e-3, encoding mean 8.5e-7 /
# 2.1e-6 / 1.7e-6, share of its entries off by more than 1e-2 2.2e-5 / 4.9e-5
# / 4.1e-5 (worst entry 0.069 / 0.19 / 0.35). The limits are three times the
# largest reading, the share twenty times.
BEND_TOL_OFF = 3e-3
BEND_TOL_RIG = 4e-3
BEND_TOL_EMB_MEAN = 1e-5
BEND_TOL_EMB_ENTRY = 1e-2
BEND_TOL_EMB_OUTLIERS = 1e-3

_MATRIX_IDX = (0, 1, 3, 5, 7, 9, 10, 12, 14)   # b0p b0l b1w b2w b3w bow r0w r1w row
_BIAS_IDX = (2, 4, 6, 8, 11, 13, 15)           # b0b b1b b2b b3b r0b r1b rob


def check_bender_supported(bender, latent_size: int) -> None:
    """Raise ValueError unless `bender` is the flagship deformation field the
    kernels hard-code: bending 5 x 64 with ReLU on [pts, latent 32], offsets
    from a layer without bias, and a rigidity network 3 x 32. The JAX kernel
    hard-codes ReLU and would give other numbers for `bending_activation=
    "sin"` without a word; here that raises."""
    def dims(layers):
        return [(layer.in_features, layer.out_features, layer.bias is not None)
                for layer in layers]

    if bender is None:
        raise ValueError("the fused point query needs ray bending")
    want_bend = [(PTS + LAT, BW, True)] + [(BW, BW, True)] * 3 + [(BW, PTS, False)]
    want_rig = [(PTS, RW, True), (RW, RW, True), (RW, 1, True)]
    if bender.activation != "relu":
        raise ValueError("the fused point query computes a ReLU bender, not "
                         f"bending_activation={bender.activation!r}")
    if latent_size != LAT or dims(bender.bend) != want_bend:
        raise ValueError(f"the fused point query needs bending {BEND_DEPTH} x "
                         f"{BW} on [pts, latent {LAT}], got {dims(bender.bend)} "
                         f"with latent {latent_size}")
    if bender.rigidity is None or dims(bender.rigidity) != want_rig:
        raise ValueError(f"the fused point query needs a rigidity network "
                         f"{RIGIDITY_DEPTH} x {RW}")


@functools.lru_cache(maxsize=None)
def _constants_on(device: torch.device):
    """(P (8, 64), phase (1, 64)) f32 on `device`; read only."""
    P, phase = embedding_projection(MULTIRES)
    return (torch.from_numpy(P).to(device),
            torch.from_numpy(phase).reshape(1, EMB).to(device))


def pack_bend_weights(bender) -> Tuple[torch.Tensor, ...]:
    """The 18 padded f32 tensors of the JAX `pack_fused_weights[:18]`: b0p
    (8, 64), b0l (32, 64), b0b, b1w b1b, b2w b2b, b3w b3b, bow (64, 8, no
    bias), r0w (8, 32), r0b, r1w r1b, row (32, 8), rob (1, 8), P (8, 64),
    phase (1, 64)."""
    bend, rig = bender.bend, bender.rigidity
    w0 = bend[0].weight.t()
    ws = [_pad_w(w0[:PTS], PTS_PAD, BW), w0[PTS:], _pad_b(bend[0].bias, BW)]
    for i in (1, 2, 3):
        ws += [bend[i].weight.t(), _pad_b(bend[i].bias, BW)]
    ws.append(_pad_w(bend[4].weight.t(), BW, PTS_PAD))
    ws += [_pad_w(rig[0].weight.t(), PTS_PAD, RW), _pad_b(rig[0].bias, RW),
           rig[1].weight.t(), _pad_b(rig[1].bias, RW),
           _pad_w(rig[2].weight.t(), RW, PTS_PAD), _pad_b(rig[2].bias, PTS_PAD)]
    ws = [w.float().contiguous() for w in ws]
    return tuple(ws) + _constants_on(ws[0].device)


def cast_bend_weights(packed: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """bf16 matrices; f32 biases, P and phase: what the kernel and its plain
    version read."""
    return tuple(w.to(torch.bfloat16).contiguous() if i in _MATRIX_IDX
                 else w.float().contiguous() for i, w in enumerate(packed))


def bend_fwd_plain(pts: torch.Tensor, lat: torch.Tensor,
                   bw: Sequence[torch.Tensor], return_acts: bool = False):
    """Plain PyTorch version of the kernel: `_bend_fwd_math` line for line.

    pts (n, 3) f32, lat (n, 32) f32, bw from `cast_bend_weights`. Returns
    emb (n, 64), off (n, 3), rig (n, 1), f32, and with `return_acts` the
    activations the backward reads."""
    (b0p, b0l, b0b, b1w, b1b, b2w, b2b, b3w, b3b, bow,
     r0w, r0b, r1w, r1b, row, rob, _, _) = bw
    bf16 = torch.bfloat16
    pts = pts.float()
    ptsb, latb = pts.to(bf16), lat.to(bf16)
    bh = [torch.relu(mm_bf16(ptsb, b0p[:PTS]) + mm_bf16(latb, b0l) + b0b).to(bf16)]
    for w, b in ((b1w, b1b), (b2w, b2b), (b3w, b3b)):
        bh.append(torch.relu(mm_bf16(bh[-1], w) + b).to(bf16))
    off = mm_bf16(bh[3], bow[:, :PTS])
    rh0 = torch.relu(mm_bf16(ptsb, r0w[:PTS]) + r0b).to(bf16)
    rh1 = torch.relu(mm_bf16(rh0, r1w) + r1b).to(bf16)
    tanh_rr = torch.tanh(mm_bf16(rh1, row[:, :1]) + rob[:, :1])
    rig = (tanh_rr + 1.0) * 0.5
    bent = pts + rig * off
    pre, emb = embed_ew(bent)
    if not return_acts:
        return emb, off, rig
    acts: Dict[str, torch.Tensor] = dict(
        ptsb=ptsb, latb=latb, bh0=bh[0], bh1=bh[1], bh2=bh[2], bh3=bh[3],
        rh0=rh0, rh1=rh1, tanh_rr=tanh_rr, pre=pre)
    return emb, off, rig, acts


def bend_fwd_agreement(got, ref) -> dict:
    """Error statistics of (emb, off, rig) against a reference triple, and
    `ok`: whether they are within the limits above."""
    emb_err = (got[0] - ref[0]).abs().double()
    n = emb_err.numel()
    out = {"emb_mean": emb_err.mean().item() if n else 0.0,
           "emb_max": emb_err.max().item() if n else 0.0,
           "emb_outliers": ((emb_err > BEND_TOL_EMB_ENTRY).double().mean().item()
                            if n else 0.0),
           "off": (got[1] - ref[1]).abs().max().item() if n else 0.0,
           "rig": (got[2] - ref[2]).abs().max().item() if n else 0.0,
           "finite": all(bool(torch.isfinite(t).all()) for t in got)}
    out["ok"] = (out["finite"] and out["emb_mean"] <= BEND_TOL_EMB_MEAN
                 and out["emb_outliers"] <= BEND_TOL_EMB_OUTLIERS
                 and out["off"] <= BEND_TOL_OFF and out["rig"] <= BEND_TOL_RIG)
    return out


def check_bend_args(pts, lat, bw, what: str):
    """pts (n, 3), lat (n, 32) and the 18 cast weights on pts' device."""
    if pts.dim() != 2 or pts.shape[1] != PTS:
        raise ValueError(f"pts must be (n, {PTS}), got {tuple(pts.shape)}")
    if lat.shape != (pts.shape[0], LAT) or lat.device != pts.device:
        raise ValueError(f"lat must be ({pts.shape[0]}, {LAT}) on {pts.device}, "
                         f"got {tuple(lat.shape)} on {lat.device}")
    if len(bw) != N_BEND_W:
        raise ValueError(f"expected {N_BEND_W} packed bender weights, got "
                         f"{len(bw)}")
    for i, w in enumerate(bw):
        want = torch.bfloat16 if i in _MATRIX_IDX else torch.float32
        if w.dtype != want or w.device != pts.device:
            raise ValueError(f"{what}: packed bender weight {i} must be {want} "
                             f"on {pts.device}, got {w.dtype} on {w.device}")


def expected_bend_shape(i: int) -> torch.Size:
    shapes = {0: (PTS_PAD, BW), 1: (LAT, BW), 9: (BW, PTS_PAD),
              10: (PTS_PAD, RW), 11: (1, RW), 12: (RW, RW), 13: (1, RW),
              14: (RW, PTS_PAD), 15: (1, PTS_PAD), 16: (PTS_PAD, EMB),
              17: (1, EMB)}
    if i in shapes:
        return torch.Size(shapes[i])
    return torch.Size((BW, BW) if i in _MATRIX_IDX else (1, BW))


def kernel_inputs(pts, lat):
    """pts and lat as the CUDA kernels read them: contiguous f32, the latents
    16-byte aligned (read 4 at a time; a misaligned view is copied)."""
    pts, lat = pts.float().contiguous(), lat.float().contiguous()
    if lat.data_ptr() % 16:
        lat = lat.clone()
    return pts, lat


_BEND_SHAPES = tuple(expected_bend_shape(i) for i in range(N_BEND_W))


def check_bend_weights(bw):
    """The checks the CUDA kernels need of the 18 cast weights they stage
    as the bender's image: the packed shapes, contiguous."""
    check_kernel_weights(bw, _BEND_SHAPES.__getitem__, "bender")


def bend_weight_pointers(bw):
    """The ctypes array of the 18 cast weights' pointers, which the CUDA
    kernels stage the bender's image from, after `check_bend_weights`."""
    check_bend_weights(bw)
    return (ctypes.c_void_p * N_BEND_W)(*(w.data_ptr() for w in bw))


def bend_fwd(pts: torch.Tensor, lat: torch.Tensor, bw: Sequence[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(emb (n, 64), off (n, 3), rig (n, 1)), f32, of the deformation field at
    pts (n, 3) with latents lat (n, 32).

    On a CPU tensor this is `bend_fwd_plain`. On a CUDA tensor it launches the
    CUDA kernel on the current stream (and counts the launch in
    `bend_fwd.launches`), or raises."""
    check_bend_args(pts, lat, bw, "bend_fwd")
    if pts.device.type == "cpu":
        return bend_fwd_plain(pts, lat, bw)
    if pts.device.type != "cuda":
        raise ValueError(f"bend_fwd runs on cpu or cuda, not {pts.device}")
    pts, lat = kernel_inputs(pts, lat)
    weights = bend_weight_pointers(bw)
    n = pts.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"bend_fwd takes fewer than 2^31 points, got {n}")
    device = pts.device
    emb = torch.empty((n, EMB), dtype=torch.float32, device=device)
    off = torch.empty((n, PTS), dtype=torch.float32, device=device)
    rig = torch.empty((n, 1), dtype=torch.float32, device=device)
    if n == 0:      # nothing to launch, nothing to count
        return emb, off, rig
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nrnerf_bend_fwd(pts.data_ptr(), lat.data_ptr(), n, weights,
                                  emb.data_ptr(), off.data_ptr(), rig.data_ptr(),
                                  stream)
    if err != 0:
        raise RuntimeError(f"bend_fwd kernel launch failed: CUDA error {err}")
    bend_fwd.launches += 1
    return emb, off, rig


bend_fwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("bend_fwd.cu")
    lib.nrnerf_bend_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.nrnerf_bend_fwd.restype = ctypes.c_int
    return lib

