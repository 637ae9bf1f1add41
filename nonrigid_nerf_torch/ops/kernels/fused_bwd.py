"""The fused point query backward as hand-written CUDA kernels, and the
autograd function that joins them to `fused_fwd`.

Counterpart of the Pallas kernel `_fused_core_bwd` / `_bwd_kernel`
(nonrigid_nerf_tpu/ops/pallas/fused_query.py:317-494) and of the
`jax.custom_vjp` around `_fused_core` (fused_query.py:307-314,497).

- `fused_bwd(pts, lat, w, draw, doff, drig)` runs the kernels of
  `csrc/fused_bwd.cu` on a CUDA tensor and the plain version
  `fused_bwd_plain` on a CPU tensor. It never falls back: a CUDA tensor
  either launches the kernels or raises. Deterministic: fixed-order sums, no
  atomics.
- `fused_bwd_plain` is `mlp_bwd_plain` on the recomputed bf16 encoding, then
  `bend_bwd_plain` on its demb: on the CPU the monolith and the split variant
  run the same arithmetic, and on the card the two share their device code
  (rows 7 and 8's kernels on csrc/mlp_sm90.cuh, which stage the bender's
  image, `mlp_sm90.pack_bend_image`'s layout, and b0l's rows,
  `mlp_sm90.bend_b0l_rows`, from the weights; row 2's,
  which read row 2's weight image, `mlp_sm90.pack_chain_image(mw, ("fwd",
  "bwd"))`), so the two variants agree bit for bit in value and gradient, as
  the JAX package holds them (tests/test_fused_kernel.py:397-419).
- `FusedCore.apply(pts, lat, *packed)`: forward `fused_fwd`, backward
  `fused_bwd`; returns dpts, dlat and the 37 gradients (None for P and the
  phase). Outputs without a cotangent count as zero cotangents; the saved
  tensors are read, not consumed.

The tolerances are `mlp_bwd.py`'s (`agreement`), with dpts and dlat held as
demb is there.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels.bend_bwd import (
    BEND_BWD_MACS_PER_POINT, BEND_BWD_NAMES, BEND_GRAD_FLOATS,
    BEND_GRAD_SHAPES, bend_bwd_plain, check_cotangents)
from nonrigid_nerf_torch.ops.kernels.bend_fwd import (
    LAT, N_BEND_W, bend_fwd_plain, bend_weight_pointers, kernel_inputs)
from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.fused_fwd import (
    N_FUSED_W, cast_fused_weights, check_fused_args, fused_fwd, mlp_pointers)
from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import pack_chain_image
from nonrigid_nerf_torch.ops.kernels.mlpe_fwd import PTS
from nonrigid_nerf_torch.ops.kernels.pieces import backward_in_pieces

FUSED_BWD_MACS_PER_POINT = KB.BWD_MACS_PER_POINT + BEND_BWD_MACS_PER_POINT
# names of dpts, dlat and the 35 gradients (the bender's 16, the MLP's 19)
FUSED_BWD_NAMES = BEND_BWD_NAMES + KB.BWD_NAMES[1:]


def fused_bwd_agreement(got, ref) -> dict:
    """`agreement` of (dpts, dlat, grads) against a reference triple."""
    return KB.agreement(list(got[:2]), list(ref[:2]), got[2], ref[2],
                        FUSED_BWD_NAMES)


def fused_bwd_plain(pts: torch.Tensor, lat: torch.Tensor,
                    w: Sequence[torch.Tensor], draw: torch.Tensor,
                    doff: torch.Tensor, drig: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of the kernels: `_bwd_kernel`. pts (n, 3), lat
    (n, 32) f32, w from `cast_fused_weights`, cotangents draw (n, 8), doff
    (n, 3), drig (n, 1) f32. Returns dpts (n, 3), dlat (n, 32) and the 35 f32
    gradients in pack order (the bender's 16, the MLP's 19)."""
    emb, _, _ = bend_fwd_plain(pts, lat, w[:N_BEND_W])
    demb, mgrads = KB.mlp_bwd_plain(emb.to(torch.bfloat16), w[N_BEND_W:], draw)
    dpts, dlat, bgrads = bend_bwd_plain(pts, lat, w[:N_BEND_W], demb, doff, drig)
    return dpts, dlat, bgrads + mgrads


def fused_bwd(pts: torch.Tensor, lat: torch.Tensor, w: Sequence[torch.Tensor],
              draw: torch.Tensor, doff: torch.Tensor, drig: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """dpts (n, 3), dlat (n, 32) and the 35 f32 weight gradients (the
    bender's 16 and the MLP's 19, pack order, padded shapes, summed over all
    n points) of the fused point query for the cotangents draw (n, 8), doff
    (n, 3), drig (n, 1) of its three outputs.

    On a CPU tensor this is `fused_bwd_plain`. On a CUDA tensor it launches
    the CUDA kernels on the current stream (and counts the call in
    `fused_bwd.launches`), or raises."""
    check_fused_args(pts, lat, w, "fused_bwd")
    n, device = pts.shape[0], pts.device
    check_cotangents(n, device, (("draw", draw, K.OUT_PAD), ("doff", doff, PTS),
                                 ("drig", drig, 1)))
    if device.type == "cpu":
        return fused_bwd_plain(pts, lat, w, draw.float(), doff.float(),
                               drig.float())
    if device.type != "cuda":
        raise ValueError(f"fused_bwd runs on cpu or cuda, not {device}")
    if n > KB.MAX_POINTS_PER_LAUNCH:
        raise ValueError(f"fused_bwd takes at most {KB.MAX_POINTS_PER_LAUNCH} "
                         f"points per call, got {n}")
    pts, lat = kernel_inputs(pts, lat)
    draw, doff, drig = (t.float().contiguous() for t in (draw, doff, drig))
    bend_weights = bend_weight_pointers(w[:N_BEND_W])
    mats, biases = mlp_pointers(w[N_BEND_W:])
    dpts = torch.empty((n, PTS), dtype=torch.float32, device=device)
    dlat = torch.empty((n, LAT), dtype=torch.float32, device=device)
    if n == 0:      # nothing to launch, nothing to count
        zeros = torch.zeros(BEND_GRAD_FLOATS + KB.GRAD_FLOATS, device=device)
        return dpts, dlat, (
            KB.split_grads(zeros[:BEND_GRAD_FLOATS], BEND_GRAD_SHAPES)
            + KB.split_grads(zeros[BEND_GRAD_FLOATS:], KB._SHAPES))
    lib = _library()
    sizes = [ctypes.c_longlong() for _ in range(3)]
    lib.nrnerf_fused_bwd_sizes(n, *(ctypes.byref(s) for s in sizes))
    scratch = torch.empty(sizes[0].value, dtype=torch.bfloat16, device=device)
    partials = torch.empty(sizes[1].value, dtype=torch.float32, device=device)
    bend_partials = torch.empty(sizes[2].value, dtype=torch.float32,
                                device=device)
    demb = torch.empty((n, K.EMB), dtype=torch.float32, device=device)
    grads = torch.empty(KB.GRAD_FLOATS, dtype=torch.float32, device=device)
    bend_grads = torch.empty(BEND_GRAD_FLOATS, dtype=torch.float32,
                             device=device)
    image = pack_chain_image(w[N_BEND_W:], ("fwd", "bwd"))
    for t in (draw, scratch, partials, demb, grads):
        if t.data_ptr() % 16:
            raise ValueError("fused_bwd needs 16-byte aligned tensors")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nrnerf_fused_bwd(
            pts.data_ptr(), lat.data_ptr(), draw.data_ptr(), doff.data_ptr(),
            drig.data_ptr(), n, bend_weights, image.data_ptr(), mats, biases,
            scratch.data_ptr(), partials.data_ptr(), demb.data_ptr(),
            bend_partials.data_ptr(), dpts.data_ptr(), dlat.data_ptr(),
            grads.data_ptr(), bend_grads.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_bwd kernel launch failed: CUDA error {err}")
    fused_bwd.launches += 1
    return dpts, dlat, (KB.split_grads(bend_grads, BEND_GRAD_SHAPES)
                        + KB.split_grads(grads, KB._SHAPES))


fused_bwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("fused_bwd.cu")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.nrnerf_fused_bwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ptrs, ctypes.c_void_p, ptrs, ptrs]
        + [ctypes.c_void_p] * 9)
    lib.nrnerf_fused_bwd.restype = ctypes.c_int
    lib.nrnerf_fused_bwd_sizes.argtypes = [
        ctypes.c_int] + [ctypes.POINTER(ctypes.c_longlong)] * 3
    lib.nrnerf_fused_bwd_sizes.restype = None
    return lib


class FusedCore(torch.autograd.Function):
    """(raw (n, 8), off (n, 3), rig (n, 1)) f32 = the fused point query at
    pts (n, 3) with latents lat (n, 32), differentiable.

    `FusedCore.apply(pts, lat, *packed)` takes the 37 packed f32 tensors of
    `pack_fused_weights` and casts the matrices to bf16 itself. The backward
    returns dpts, dlat and the 37 gradients in pack order (None for P and the
    phase); past MAX_POINTS_PER_LAUNCH points it runs in pieces
    (`pieces.py`)."""

    @staticmethod
    def forward(ctx, pts, lat, *packed):
        if len(packed) != N_FUSED_W:
            raise ValueError(f"expected {N_FUSED_W} packed weights, got "
                             f"{len(packed)}")
        pts, lat = pts.float(), lat.float()
        ctx.save_for_backward(pts, lat, *packed)
        return fused_fwd(pts, lat, cast_fused_weights(packed))

    @staticmethod
    def backward(ctx, draw, doff, drig):
        pts, lat, *packed = ctx.saved_tensors
        w = cast_fused_weights(packed)
        dpts, dlat, grads = backward_in_pieces(
            lambda p, la, dr, do, dg: fused_bwd(p, la, w, dr, do, dg),
            pts, lat, draw, doff, drig)
        return (dpts, dlat, *grads[:N_BEND_W - 2], None, None,
                *grads[N_BEND_W - 2:])
