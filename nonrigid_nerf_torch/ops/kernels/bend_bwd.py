"""The deformation field backward as a hand-written CUDA kernel, and the
autograd function that joins it to `bend_fwd`.

Counterpart of the Pallas kernel `_bend_core_bwd` / `_bend_bwd_kernel`
(nonrigid_nerf_tpu/ops/pallas/fused_query.py:542-627,651-671) and of the
`jax.custom_vjp` around `_bend_core` (fused_query.py:630-674).

- `bend_bwd(pts, lat, bw, demb, doff, drig)` runs the kernels of
  `csrc/bend_bwd.cu` on a CUDA tensor and the plain version `bend_bwd_plain`
  on a CPU tensor. It never falls back: a CUDA tensor either launches the
  kernels or raises. The result is deterministic (bit-equal from run to
  run): fixed-order sums, no atomics.
- `BendCore.apply(pts, lat, *packed)` is the differentiable deformation
  field: forward `bend_fwd`, backward `bend_bwd`. Only the f32 points and
  latents and the 18 packed tensors are kept between the two. It returns
  dpts, dlat and the 16 gradients of the bender; nothing for P and the phase,
  which are constants of the encoding. An output without a cotangent counts
  as a zero cotangent.

The tolerances are `mlp_bwd.py`'s (`agreement`), with dpts and dlat held as
demb is there: one row per point, and a flipped ReLU gate changes a point's
whole row.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from nonrigid_nerf_torch.ops.kernels.bend_fwd import (
    BEND_MACS_PER_POINT, LAT, N_BEND_W, bend_fwd, bend_fwd_plain,
    bend_weight_pointers, cast_bend_weights, check_bend_args, expected_bend_shape,
    kernel_inputs)
from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_bwd import (
    MAX_POINTS_PER_LAUNCH, agreement, bsum, masked, mm_nt, mm_tn, split_grads)
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import EMB
from nonrigid_nerf_torch.ops.kernels.mlpe_fwd import PTS
from nonrigid_nerf_torch.ops.kernels.pieces import backward_in_pieces

# the forward recomputed, the cotangent chain and the weight products
BEND_BWD_MACS_PER_POINT = 3 * BEND_MACS_PER_POINT
N_BEND_GRADS = 16       # the 18 packed tensors but P and the phase
BEND_GRAD_SHAPES = tuple(expected_bend_shape(i) for i in range(N_BEND_GRADS))
BEND_GRAD_FLOATS = sum(s.numel() for s in BEND_GRAD_SHAPES)
# names of the per-point outputs and the 16 gradients in pack order
BEND_BWD_NAMES = ("dpts", "dlat", "b0p", "b0l", "b0b", "b1w", "b1b", "b2w",
                  "b2b", "b3w", "b3b", "bow", "r0w", "r0b", "r1w", "r1b", "row",
                  "rob")


# The rigidity head's one-channel bias gradient (`rob`, gradient ROB of the
# bender's 16) is one sum of n cotangent entries, which can cancel to a
# small share of its terms while its rounding noise (through the chain's
# bf16 backward in fused_bwd) does not. A check of a backward in pieces
# holds it by its own error over its own magnitude at ROB_TOL: three times
# the worst of 13 draws of fused_bwd against fused_bwd_plain on an H100
# (4.3% at one launch of 262,144 points; `chip_probes.py rob_draws`).
ROB, ROB_TOL = 15, 0.13


def rob_rel_err(got_grads, ref_grads) -> float:
    """|rob - rob_ref| / |rob_ref| of two gradient lists in pack order (the
    bender's 16 first)."""
    want = ref_grads[ROB].flatten()[0].item()
    err = abs(got_grads[ROB].flatten()[0].item() - want)
    return err / max(abs(want), 1e-30)


def bend_bwd_agreement(got, ref) -> dict:
    """`agreement` of (dpts, dlat, grads) against a reference triple."""
    return agreement(list(got[:2]), list(ref[:2]), got[2], ref[2],
                     BEND_BWD_NAMES)


def _pad_to(g, shape):
    return F.pad(g, (0, shape[1] - g.shape[1], 0, shape[0] - g.shape[0]))


def bend_bwd_plain(pts: torch.Tensor, lat: torch.Tensor,
                   bw: Sequence[torch.Tensor], demb: torch.Tensor,
                   doff: torch.Tensor, drig: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of the kernel: `_bend_bwd_kernel` line for line.

    pts (n, 3), lat (n, 32) f32, bw from `cast_bend_weights`, cotangents demb
    (n, 64), doff (n, 3), drig (n, 1) f32. bf16 x bf16 products are exact in
    f32, so an f32 matmul of the bf16 values is the kernel's arithmetic up to
    the order of the f32 sums. Returns dpts (n, 3), dlat (n, 32) and the 16
    f32 gradients in pack order, padded as packed."""
    (b0p, b0l, _, b1w, _, b2w, _, b3w, _, bow,
     r0w, _, r1w, _, row, _, P, phase) = bw
    _, off, rig, a = bend_fwd_plain(pts, lat, bw, return_acts=True)
    lane = torch.arange(EMB, device=pts.device)
    dpre = torch.where(lane < 3, demb, demb * torch.cos(a["pre"] + phase))
    dbent = dpre @ P[:PTS].t()
    doff_total = dbent * rig + doff
    drig0 = (dbent * off).sum(dim=1, keepdim=True)
    drig_raw = (drig + drig0) * 0.5 * (1.0 - a["tanh_rr"] * a["tanh_rr"])

    g_row, g_rob = mm_tn(a["rh1"], drig_raw), bsum(drig_raw)
    drh1 = masked(mm_nt(drig_raw, row[:, :1]), a["rh1"])
    g_r1w, g_r1b = mm_tn(a["rh0"], drh1), bsum(drh1)
    drh0 = masked(mm_nt(drh1, r1w), a["rh0"])
    g_r0w, g_r0b = mm_tn(a["ptsb"], drh0), bsum(drh0)
    dpts_rig = mm_nt(drh0, r0w[:PTS])

    g_bow = mm_tn(a["bh3"], doff_total)
    dbh3 = masked(mm_nt(doff_total, bow[:, :PTS]), a["bh3"])
    g_b3w, g_b3b = mm_tn(a["bh2"], dbh3), bsum(dbh3)
    dbh2 = masked(mm_nt(dbh3, b3w), a["bh2"])
    g_b2w, g_b2b = mm_tn(a["bh1"], dbh2), bsum(dbh2)
    dbh1 = masked(mm_nt(dbh2, b2w), a["bh1"])
    g_b1w, g_b1b = mm_tn(a["bh0"], dbh1), bsum(dbh1)
    dbh0 = masked(mm_nt(dbh1, b1w), a["bh0"])
    g_b0p, g_b0l = mm_tn(a["ptsb"], dbh0), mm_tn(a["latb"], dbh0)
    g_b0b = bsum(dbh0)

    dpts = dbent + dpts_rig + mm_nt(dbh0, b0p[:PTS])
    dlat = mm_nt(dbh0, b0l)
    grads = [g_b0p, g_b0l, g_b0b, g_b1w, g_b1b, g_b2w, g_b2b, g_b3w, g_b3b,
             g_bow, g_r0w, g_r0b, g_r1w, g_r1b, g_row, g_rob]
    return dpts, dlat, [_pad_to(g, s) for g, s in zip(grads, BEND_GRAD_SHAPES)]


def check_cotangents(n, device, named):
    """Each (name, tensor, width) must be (n, width) on `device`."""
    for name, t, width in named:
        if t.shape != (n, width) or t.device != device:
            raise ValueError(f"{name} must be ({n}, {width}) on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def bend_bwd(pts: torch.Tensor, lat: torch.Tensor, bw: Sequence[torch.Tensor],
             demb: torch.Tensor, doff: torch.Tensor, drig: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """dpts (n, 3), dlat (n, 32) and the 16 f32 weight gradients (pack order,
    padded shapes, summed over all n points) of the deformation field at pts
    (n, 3), lat (n, 32), for the cotangents demb (n, 64), doff (n, 3), drig
    (n, 1) of its three outputs.

    On a CPU tensor this is `bend_bwd_plain`. On a CUDA tensor it launches
    the CUDA kernels on the current stream (and counts the call in
    `bend_bwd.launches`), or raises."""
    check_bend_args(pts, lat, bw, "bend_bwd")
    n, device = pts.shape[0], pts.device
    check_cotangents(n, device, (("demb", demb, EMB), ("doff", doff, PTS),
                                 ("drig", drig, 1)))
    if device.type == "cpu":
        return bend_bwd_plain(pts, lat, bw, demb.float(), doff.float(),
                              drig.float())
    if device.type != "cuda":
        raise ValueError(f"bend_bwd runs on cpu or cuda, not {device}")
    if n > MAX_POINTS_PER_LAUNCH:
        raise ValueError(f"bend_bwd takes at most {MAX_POINTS_PER_LAUNCH} "
                         f"points per call, got {n}")
    pts, lat = kernel_inputs(pts, lat)
    demb, doff, drig = (t.float().contiguous() for t in (demb, doff, drig))
    weights = bend_weight_pointers(bw)
    dpts = torch.empty((n, PTS), dtype=torch.float32, device=device)
    dlat = torch.empty((n, LAT), dtype=torch.float32, device=device)
    if n == 0:      # nothing to launch, nothing to count
        return dpts, dlat, split_grads(
            torch.zeros(BEND_GRAD_FLOATS, device=device), BEND_GRAD_SHAPES)
    lib = _library()
    partial_floats = ctypes.c_longlong()
    lib.nrnerf_bend_bwd_sizes(n, ctypes.byref(partial_floats))
    partials = torch.empty(partial_floats.value, dtype=torch.float32,
                           device=device)
    grads = torch.empty(BEND_GRAD_FLOATS, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nrnerf_bend_bwd(
            pts.data_ptr(), lat.data_ptr(), demb.data_ptr(), doff.data_ptr(),
            drig.data_ptr(), n, weights, partials.data_ptr(),
            dpts.data_ptr(), dlat.data_ptr(), grads.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bend_bwd kernel launch failed: CUDA error {err}")
    bend_bwd.launches += 1
    return dpts, dlat, split_grads(grads, BEND_GRAD_SHAPES)


bend_bwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("bend_bwd.cu")
    lib.nrnerf_bend_bwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        + [ctypes.c_void_p] * 5)
    lib.nrnerf_bend_bwd.restype = ctypes.c_int
    lib.nrnerf_bend_bwd_sizes.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.nrnerf_bend_bwd_sizes.restype = None
    return lib


class BendCore(torch.autograd.Function):
    """(emb (n, 64), off (n, 3), rig (n, 1)) f32 = the deformation field at
    pts (n, 3) with latents lat (n, 32), differentiable.

    `BendCore.apply(pts, lat, *packed)` takes the 18 packed f32 tensors of
    `pack_bend_weights` and casts the matrices to bf16 itself. The backward
    returns dpts, dlat and the 16 gradients in pack order (None for P and the
    phase). The saved tensors are read, not consumed, so the backward may run
    once per cotangent; past MAX_POINTS_PER_LAUNCH points it runs in pieces
    (`pieces.py`)."""

    @staticmethod
    def forward(ctx, pts, lat, *packed):
        if len(packed) != N_BEND_W:
            raise ValueError(f"expected {N_BEND_W} packed bender weights, got "
                             f"{len(packed)}")
        pts, lat = pts.float(), lat.float()
        ctx.save_for_backward(pts, lat, *packed)
        return bend_fwd(pts, lat, cast_bend_weights(packed))

    @staticmethod
    def backward(ctx, demb, doff, drig):
        pts, lat, *packed = ctx.saved_tensors
        bw = cast_bend_weights(packed)
        dpts, dlat, grads = backward_in_pieces(
            lambda p, la, de, do, dr: bend_bwd(p, la, bw, de, do, dr),
            pts, lat, demb, doff, drig)
        return (dpts, dlat, *grads, None, None)

