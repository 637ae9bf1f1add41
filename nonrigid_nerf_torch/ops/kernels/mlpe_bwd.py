"""The canonical 8 x 256 NeRF MLP backward on bent POINTS as a hand-written
CUDA kernel, and the autograd function that joins it to `mlpe_fwd`
(`fused_kernel="pts"` under training).

Counterpart of the Pallas kernel `_mlpe_core_bwd` / `_mlpe_bwd_kernel`
(nonrigid_nerf_tpu/ops/pallas/fused_query.py:909-926,960-985) and of the
`jax.custom_vjp` around `_mlpe_core` (fused_query.py:943-988).

- `mlpe_bwd(pts, mw, draw)` runs the kernels of `csrc/mlpe_bwd.cu` on a CUDA
  tensor and the plain version `mlpe_bwd_plain` on a CPU tensor. It never
  falls back: a CUDA tensor either launches the kernels or raises. The result
  is deterministic (bit-equal from run to run): fixed-order sums, no atomics.
- `MLPECore.apply(pts, *packed)` is the differentiable canonical MLP on
  points: forward `mlpe_fwd`, backward `mlpe_bwd`. Only the f32 points and the
  packed f32 weights are kept between the two; the backward recomputes the
  encoding and the activations. It returns dpts and the 19 gradients; nothing
  for P or the phase, which are constants of the encoding.

The gradient of the encoding (64 f32 per point) never reaches HBM: the kernel
multiplies it by cos(pre + phase) and the lane's 2^k and sums the lanes of each
coordinate on the chip. The factors up to 2^9 amplify the bf16 rounding of the
chain's dh1 and dh6; the JAX kernel has the same arithmetic, so the plain
version here is the yardstick, not the f32 step.

The kernels are `mlp_bwd`'s, on `csrc/mlp_sm90.cuh` (the chain kernel's
template on another input, the same second pass): on a CUDA tensor the
wrapper packs the same weight image (`mlp_sm90.pack_chain_image` of the
forward and backward chunks at 64 lanes) and hands over the encoding's
projection P and phase in f32.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_bwd import (
    BWD_MACS_PER_POINT, BWD_NAMES, BWD_TOL_DEMB_MAX, BWD_TOL_ENTRY, BWD_TOL_L2,
    BWD_TOL_OUTLIERS, GRAD_FLOATS, MAX_POINTS_PER_LAUNCH, _SHAPES, agreement,
    grad_max_tol, mlp_bwd_plain, split_grads)
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    EMB, N_MLP_W, OUT_PAD, _BIAS_IDX, _MATRIX_IDX, _expected_shape,
    cast_mlp_weights, check_kernel_weights, weight_pointers)
from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import pack_chain_image
from nonrigid_nerf_torch.ops.kernels.mlpe_fwd import (
    PTS, _projection_on, check_pts_args, embed_ew, mlpe_fwd)

# the bf16 scratch of one call, per point: the recomputed encoding (64), then
# nh1..nh8 and dh1..dh8 (256 each): 8,320 B, as `mlp_bwd`'s, so the same
# limit of points per call keeps it at 2 GiB
SCRATCH_PER_POINT = EMB + 2 * 8 * 256
# names of dpts and the 19 gradients in pack order, for reports
BWD_NAMES = ("dpts",) + BWD_NAMES[1:]
# the work per point and the tolerances are `mlp_bwd`'s, with dpts held as
# demb is there
__all__ = ["BWD_MACS_PER_POINT", "BWD_NAMES", "BWD_TOL_DEMB_MAX",
           "BWD_TOL_ENTRY", "BWD_TOL_L2", "BWD_TOL_OUTLIERS",
           "MAX_POINTS_PER_LAUNCH", "MLPECore", "SCRATCH_PER_POINT",
           "bwd_agreement", "grad_max_tol", "mlpe_bwd", "mlpe_bwd_plain"]


def bwd_agreement(got, ref) -> dict:
    """`agreement` of (dpts, grads) against a reference pair, within the
    tolerances `mlp_bwd.py` states (dpts in demb's place: one row per
    point, and a flipped ReLU gate changes a point's whole row)."""
    return agreement([got[0]], [ref[0]], got[1], ref[1], BWD_NAMES)


def mlpe_bwd_plain(pts: torch.Tensor, mw: Sequence[torch.Tensor],
                   draw: torch.Tensor
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of the kernel: `_mlpe_bwd_kernel` line for line.

    pts (n, 3) f32, mw from `cast_mlp_weights`, draw (n, 8) f32. Returns dpts
    (n, 3) f32 and the 19 f32 gradients in pack order."""
    P, phase = _projection_on(pts.device)
    pre, emb = embed_ew(pts.float())
    demb, grads = mlp_bwd_plain(emb.to(torch.bfloat16), mw, draw)
    # d/dpre of where(lane < 3, pre, sin(pre + phase)), then folded back onto
    # the three coordinates (the entries of P are powers of two and one-hots)
    lane = torch.arange(EMB, device=pts.device)
    dpre = torch.where(lane < 3, demb, demb * torch.cos(pre + phase))
    dpts = torch.stack([(dpre * P[d]).sum(dim=1) for d in range(PTS)], dim=1)
    return dpts, grads


def mlpe_bwd(pts: torch.Tensor, mw: Sequence[torch.Tensor],
             draw: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """dpts (n, 3) f32 and the 19 f32 weight gradients (pack order, padded
    shapes, summed over all n points) of the canonical MLP on the encoding of
    pts (n, 3) for the cotangent draw (n, 8).

    On a CPU tensor this is `mlpe_bwd_plain`. On a CUDA tensor it launches
    the CUDA kernels on the current stream (and counts the call in
    `mlpe_bwd.launches`), or raises."""
    check_pts_args(pts, mw, "mlpe_bwd")
    if draw.shape != (pts.shape[0], OUT_PAD) or draw.device != pts.device:
        raise ValueError(f"draw must be ({pts.shape[0]}, {OUT_PAD}) on "
                         f"{pts.device}, got {tuple(draw.shape)} on "
                         f"{draw.device}")
    if pts.device.type == "cpu":
        return mlpe_bwd_plain(pts, mw, draw.float())
    if pts.device.type != "cuda":
        raise ValueError(f"mlpe_bwd runs on cpu or cuda, not {pts.device}")
    pts = pts.float().contiguous()
    draw = draw.float().contiguous()
    check_kernel_weights(mw, _expected_shape, "mlpe_bwd")
    n = pts.shape[0]
    device = pts.device
    if n > MAX_POINTS_PER_LAUNCH:
        raise ValueError(f"mlpe_bwd takes at most {MAX_POINTS_PER_LAUNCH} "
                         f"points per call, got {n}")
    dpts = torch.empty((n, PTS), dtype=torch.float32, device=device)
    if n == 0:      # nothing to launch, nothing to count
        return dpts, split_grads(torch.zeros(GRAD_FLOATS, device=device),
                                 _SHAPES)
    lib = _library()
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    scratch_elems, partial_floats = ctypes.c_longlong(), ctypes.c_longlong()
    lib.nrnerf_mlpe_bwd_sizes(n, ctypes.byref(scratch_elems),
                              ctypes.byref(partial_floats))
    scratch = torch.empty(scratch_elems.value, dtype=torch.bfloat16,
                          device=device)
    partials = torch.empty(partial_floats.value, dtype=torch.float32,
                           device=device)
    grads = torch.empty(GRAD_FLOATS, dtype=torch.float32, device=device)
    image = pack_chain_image(mw, ("fwd", "bwd"))
    P, phase = _projection_on(device)
    for t in (draw, scratch, partials, grads, *mw):
        if t.data_ptr() % 16:
            raise ValueError("mlpe_bwd needs 16-byte aligned tensors")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nrnerf_mlpe_bwd(pts.data_ptr(), draw.data_ptr(), n,
                                  image.data_ptr(), P.data_ptr(),
                                  phase.data_ptr(), mats, biases,
                                  scratch.data_ptr(), partials.data_ptr(),
                                  dpts.data_ptr(), grads.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlpe_bwd kernel launch failed: CUDA error {err}")
    mlpe_bwd.launches += 1
    return dpts, split_grads(grads, _SHAPES)


mlpe_bwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("mlpe_bwd.cu")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.nrnerf_mlpe_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ptrs, ptrs, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.nrnerf_mlpe_bwd.restype = ctypes.c_int
    lib.nrnerf_mlpe_bwd_sizes.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.nrnerf_mlpe_bwd_sizes.restype = None
    return lib


class MLPECore(torch.autograd.Function):
    """raw (n, 8) f32 = the canonical MLP on the encoding of pts (n, 3) f32,
    differentiable.

    `MLPECore.apply(pts, *packed)` takes the 19 packed f32 tensors of
    `pack_mlp_weights` and casts the ten matrices to bf16 itself. The backward
    returns dpts in f32 and the 19 f32 gradients in pack order. The saved
    tensors are read, not consumed, so the backward may run once per
    cotangent."""

    @staticmethod
    def forward(ctx, pts, *packed):
        if len(packed) != N_MLP_W:
            raise ValueError(f"expected {N_MLP_W} packed weights, got "
                             f"{len(packed)}")
        pts = pts.float()
        ctx.save_for_backward(pts, *packed)
        return mlpe_fwd(pts, cast_mlp_weights(packed))

    @staticmethod
    def backward(ctx, draw):
        pts, *packed = ctx.saved_tensors
        dpts, grads = mlpe_bwd(pts, cast_mlp_weights(packed), draw)
        return (dpts, *grads)
