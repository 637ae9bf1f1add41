"""The view-direction canonical NeRF MLP backward as a hand-written CUDA
kernel, and the autograd function that joins it to the forward kernel.

Counterpart of the Pallas kernel `_mlpv_core_bwd` / `_mlpv_bwd_kernel`
(nonrigid_nerf_tpu/ops/pallas/fused_query.py:1080-1177,1215-1237), and of the
`jax.custom_vjp` around `_mlpv_core` (fused_query.py:1194-1240).

- `mlpv_bwd(embb, embvb, mw, draw)` runs the kernels of `csrc/mlpv_bwd.cu` on
  CUDA tensors and the plain version `mlpv_bwd_plain` on CPU tensors. It
  never falls back: a CUDA tensor either launches the kernels or raises. The
  result is deterministic (bit-equal from run to run): partial sums are
  reduced in a fixed order, never with atomics.
- `MLPVCore.apply(emb, embv, *packed)` is the differentiable view-direction
  MLP: forward `mlpv_fwd`, backward `mlpv_bwd`, with gradients for both
  encodings and all 26 packed weights. Nothing but the bf16 encodings and
  the packed f32 weights is kept between the two; the backward recomputes
  the activations.

The kernel is bound by the tensor cores (3.58 MFLOP per point against 608 B
of HBM traffic per point); see the source for its design. It runs on
`csrc/mlp_sm90.cuh`: on CUDA tensors the wrapper first packs the chain's and
the heads' chunks into the swizzled image the chain kernel streams
(`mlp_sm90.pack_views_image`).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_bwd import (
    BWD_TOL_DEMB_MAX, BWD_TOL_ENTRY, BWD_TOL_L2, BWD_TOL_MAX, BWD_TOL_OUTLIERS,
    agreement, bsum, chain_bwd_plain, grad_max_tol, masked, mm_nt, mm_tn,
    split_grads)
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    EMB, OUT_PAD, chain_plain, check_kernel_weights, weight_pointers)
from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import pack_views_image
from nonrigid_nerf_torch.ops.kernels.mlpv_fwd import (
    _BIAS_IDX, _MATRIX_IDX, MACS_PER_POINT, N_MLPV_W, VEMB, _check_args,
    _expected_shape, cast_mlpv_weights, heads_plain, mlpv_fwd)
from nonrigid_nerf_torch.ops.kernels.pieces import backward_in_pieces

# recompute + the dh chain + the dW products, each as many MACs as the forward
BWD_MACS_PER_POINT = 3 * MACS_PER_POINT
_SHAPES = tuple(_expected_shape(i) for i in range(N_MLPV_W))
GRAD_FLOATS = sum(shape.numel() for shape in _SHAPES)
# bf16 elements of scratch per point: emb and embv (padded to 64 lanes: one
# 128-lane array), nh1..nh8, feat, hv, and dh1..dh8, dfeat, dhv
SCRATCH_PER_POINT = EMB + 64 + 2 * (8 * 256 + 256 + 128)
# one call takes at most this many points: the bf16 scratch (9,984 B per
# point) then stays at 2.44 GiB. The training step gives 131,072 at most.
MAX_POINTS_PER_LAUNCH = 1 << 18
# Agreement of two implementations (these kernels, the plain version, the
# JAX math): `mlp_bwd`'s limits (BWD_TOL_*, grad_max_tol, held here under the
# same names), through `agreement`, for its reasons (bf16 rounding flips; a
# ReLU gate of the chain or of hv that flips changes one point's rows of demb
# and dembv). dembv counts as demb does.
__all__ = ["BWD_TOL_DEMB_MAX", "BWD_TOL_ENTRY", "BWD_TOL_L2", "BWD_TOL_MAX",
           "BWD_TOL_OUTLIERS", "grad_max_tol", "bwd_agreement", "mlpv_bwd",
           "mlpv_bwd_plain", "MLPVCore"]
BWD_NAMES = ("demb", "dembv", "n0w", "n0b", "n1w", "n1b", "n2w", "n2b", "n3w",
             "n3b", "n4w", "n4b", "n5e", "n5h", "n5b", "n6w", "n6b", "n7w",
             "n7b", "fw", "fb", "aw", "ab", "vwf", "vwv", "vb", "rw", "rb")


def bwd_agreement(got, ref) -> dict:
    """`agreement` of (demb, dembv, grads) against a reference triple."""
    return agreement(got[:2], ref[:2], got[2], ref[2], BWD_NAMES)


def mlpv_bwd_plain(embb: torch.Tensor, embvb: torch.Tensor,
                   mw: Sequence[torch.Tensor], draw: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of the kernel: `_mlpv_bwd_kernel`'s math line
    for line.

    embb (n, 64) and embvb (n, 32) (cast to bf16), mw from
    `cast_mlpv_weights`, draw (n, 8) f32. Returns demb (n, 64) and dembv
    (n, 32) f32 and the 26 f32 gradients in pack order."""
    fw, _, aw, _, vwf, vwv, _, rw, _ = mw[17:]
    bf16 = torch.bfloat16
    # the forward activations, recomputed in bf16 as in mlpv_fwd
    embb, embvb = embb.to(bf16), embvb.to(bf16)
    nh = chain_plain(embb, mw)
    nh8 = nh[7]
    feat, hv, _ = heads_plain(nh8, embvb, mw)

    drawb = draw.to(bf16)
    # rgb head
    g_rw = mm_tn(hv, drawb)
    g_rb = bsum(draw)                      # the f32 sum of the UNCAST draw
    dhv = masked(mm_nt(drawb, rw), hv)
    # views layer
    g_vwf = mm_tn(feat, dhv)
    g_vwv = mm_tn(embvb, dhv)
    g_vb = bsum(dhv)
    dfeat = mm_nt(dhv, vwf).to(bf16)
    dembv = mm_nt(dhv, vwv)                # f32, no mask
    # feature head (linear, no activation mask)
    g_fw = mm_tn(nh8, dfeat)
    g_fb = bsum(dfeat)
    # alpha head
    g_aw = mm_tn(nh8, drawb)
    g_ab = bsum(draw)
    dh8 = masked(mm_nt(dfeat, fw) + mm_nt(drawb, aw), nh8)

    demb, grads = chain_bwd_plain(embb, nh, mw, dh8)
    return demb, dembv, grads + [g_fw, g_fb, g_aw, g_ab, g_vwf, g_vwv, g_vb,
                                 g_rw, g_rb]


def mlpv_bwd(embb: torch.Tensor, embvb: torch.Tensor,
             mw: Sequence[torch.Tensor], draw: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """demb (n, 64) and dembv (n, 32) f32 and the 26 f32 weight gradients
    (pack order, padded shapes, summed over all n points) of the
    view-direction MLP at embb (n, 64), embvb (n, 32) for the cotangent draw
    (n, 8).

    On CPU tensors this is `mlpv_bwd_plain`. On CUDA tensors it launches the
    CUDA kernels on the current stream (and counts the call in
    `mlpv_bwd.launches`), or raises."""
    _check_args(embb, embvb, mw)
    if draw.shape != (embb.shape[0], OUT_PAD) or draw.device != embb.device:
        raise ValueError(f"draw must be ({embb.shape[0]}, {OUT_PAD}) on "
                         f"{embb.device}, got {tuple(draw.shape)} on "
                         f"{draw.device}")
    if embb.device.type == "cpu":
        return mlpv_bwd_plain(embb, embvb, mw, draw.float())
    if embb.device.type != "cuda":
        raise ValueError(f"mlpv_bwd runs on cpu or cuda, not {embb.device}")
    embb = embb.to(torch.bfloat16).contiguous()
    embvb = embvb.to(torch.bfloat16).contiguous()
    draw = draw.float().contiguous()
    check_kernel_weights(mw, _expected_shape, "mlpv_bwd")
    n = embb.shape[0]
    device = embb.device
    if n > MAX_POINTS_PER_LAUNCH:
        raise ValueError(f"mlpv_bwd takes at most {MAX_POINTS_PER_LAUNCH} "
                         f"points per call, got {n}")
    demb = torch.empty((n, EMB), dtype=torch.float32, device=device)
    dembv = torch.empty((n, VEMB), dtype=torch.float32, device=device)
    if n == 0:      # nothing to launch, nothing to count
        return demb, dembv, split_grads(
            torch.zeros(GRAD_FLOATS, device=device), _SHAPES)
    lib = _library()
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    scratch_elems, partial_floats = ctypes.c_longlong(), ctypes.c_longlong()
    lib.nrnerf_mlpv_bwd_sizes(n, ctypes.byref(scratch_elems),
                              ctypes.byref(partial_floats))
    scratch = torch.empty(scratch_elems.value, dtype=torch.bfloat16,
                          device=device)
    partials = torch.empty(partial_floats.value, dtype=torch.float32,
                           device=device)
    grads = torch.empty(GRAD_FLOATS, dtype=torch.float32, device=device)
    image = pack_views_image(mw)
    for t in (embb, embvb, draw, demb, dembv, scratch, partials, grads, *mw):
        if t.data_ptr() % 16:
            raise ValueError("mlpv_bwd needs 16-byte aligned tensors")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nrnerf_mlpv_bwd(embb.data_ptr(), embvb.data_ptr(),
                                  draw.data_ptr(), n, image.data_ptr(),
                                  mats, biases,
                                  scratch.data_ptr(), partials.data_ptr(),
                                  demb.data_ptr(), dembv.data_ptr(),
                                  grads.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlpv_bwd kernel launch failed: CUDA error {err}")
    mlpv_bwd.launches += 1
    return demb, dembv, split_grads(grads, _SHAPES)


mlpv_bwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("mlpv_bwd.cu")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.nrnerf_mlpv_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ptrs, ptrs, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.nrnerf_mlpv_bwd.restype = ctypes.c_int
    lib.nrnerf_mlpv_bwd_sizes.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.nrnerf_mlpv_bwd_sizes.restype = None
    return lib


class MLPVCore(torch.autograd.Function):
    """raw (n, 8) f32 = the view-direction MLP on emb (n, 64) and embv
    (n, 32), differentiable.

    `MLPVCore.apply(emb, embv, *packed)` takes the 26 packed f32 tensors of
    `pack_viewdirs_mlp_weights` and casts the matrices to bf16 itself. The
    backward returns demb and dembv in f32 (hand over f32 encodings to keep
    them unrounded) and the 26 f32 gradients in pack order. The saved tensors
    are read, not consumed, so the backward may run once per cotangent; past
    MAX_POINTS_PER_LAUNCH points it runs in pieces (`pieces.py`)."""

    @staticmethod
    def forward(ctx, emb, embv, *packed):
        if len(packed) != N_MLPV_W:
            raise ValueError(f"expected {N_MLPV_W} packed weights, got "
                             f"{len(packed)}")
        embb, embvb = emb.to(torch.bfloat16), embv.to(torch.bfloat16)
        ctx.save_for_backward(embb, embvb, *packed)
        return mlpv_fwd(embb, embvb, cast_mlpv_weights(packed))

    @staticmethod
    def backward(ctx, draw):
        embb, embvb, *packed = ctx.saved_tensors
        mw = cast_mlpv_weights(packed)
        demb, dembv, grads = backward_in_pieces(
            lambda e, ev, d: mlpv_bwd(e, ev, mw, d), embb, embvb, draw)
        return (demb, dembv, *grads)
