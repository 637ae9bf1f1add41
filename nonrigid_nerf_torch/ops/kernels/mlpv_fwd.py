"""The view-direction canonical NeRF MLP forward as a hand-written CUDA
kernel: the 8 x 256 chain, then the feature, alpha, views and rgb heads.

Counterpart of the Pallas kernel `_mlpv_core` (forward `_mlpv_pallas_fwd` /
`_mlpv_fwd_math`, nonrigid_nerf_tpu/ops/pallas/fused_query.py:1050-1072,
1180-1200) and of its weight packing `pack_viewdirs_mlp_weights`
(fused_query.py:1008-1047).

- `pack_viewdirs_mlp_weights(nerf)` flattens a view-direction `NeRF` module
  into the 26 padded f32 arrays of the JAX packing, in the JAX
  (fan_in, fan_out) layout; rgb lands in lanes 0:3 of the 8 raw lanes and
  alpha in lane 3.
- `cast_mlpv_weights(packed)` casts the matrices to bf16 once, outside the
  kernel, and keeps the biases f32.
- `mlpv_fwd(emb, embv, mw)` runs the kernel (`csrc/mlpv_fwd.cu`) on CUDA
  tensors and the plain version `mlpv_fwd_plain` on CPU tensors. It never
  falls back: a CUDA tensor either launches the kernel or raises.

The kernel is bound by the tensor cores (1.194 MFLOP per point against
224 B of HBM traffic); see the source for its design.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    BF16_TOL_MAX, BF16_TOL_MEAN, EMB, NW, OUT_PAD, _pad_b, _pad_w, chain_plain,
    check_kernel_weights, mm_bf16, pack_chain_weights, weight_pointers)

VEMB = 32         # 27 view-encoding channels (multires_views = 4) padded
VW = 128          # width of the view-conditioned layer = netwidth // 2
N_MLPV_W = 26
# MACs per point: the chain's 2*64*256 + 7*256*256, the feature head's
# 256*256, the alpha head's 256*8, the views layer's (256 + 32)*128, the rgb
# head's 128*8
MACS_PER_POINT = (2 * EMB * NW + 7 * NW * NW + NW * NW + NW * OUT_PAD
                  + (NW + VEMB) * VW + VW * OUT_PAD)
# Agreement of two implementations (this kernel, its plain version, the JAX
# math): `mlp_fwd`'s limits BF16_TOL_MAX / BF16_TOL_MEAN, held here under the
# same names, for its reason (an f32 sum in another order flips an occasional
# bf16 rounding). Observed max / mean abs error on |raw| ~ 1: 1.2e-7 / 1e-10
# on the CPU (plain vs JAX); 3.5e-4 / 2.9e-7 on the H100 at 2^22 points
# (kernel vs plain).
__all__ = ["BF16_TOL_MAX", "BF16_TOL_MEAN", "MACS_PER_POINT", "N_MLPV_W",
           "VEMB", "VW", "cast_mlpv_weights", "heads_plain", "mlpv_fwd",
           "mlpv_fwd_plain", "pack_viewdirs_mlp_weights"]

# n0w..n4w, n5e, n5h, n6w, n7w, fw, aw, vwf, vwv, rw
_MATRIX_IDX = (0, 2, 4, 6, 8, 10, 11, 13, 15, 17, 19, 21, 22, 24)
# n0b..n4b, n5b, n6b, n7b, fb, ab, vb, rb
_BIAS_IDX = (1, 3, 5, 7, 9, 12, 14, 16, 18, 20, 23, 25)
_HEAD_SHAPES = {17: (NW, NW), 18: (1, NW), 19: (NW, OUT_PAD),
                20: (1, OUT_PAD), 21: (NW, VW), 22: (VEMB, VW), 23: (1, VW),
                24: (VW, OUT_PAD), 25: (1, OUT_PAD)}


def pack_viewdirs_mlp_weights(nerf) -> Tuple[torch.Tensor, ...]:
    """A view-direction `NeRF` module as 26 padded f32 tensors, equal to the
    JAX `pack_viewdirs_mlp_weights`: the chain's 17 (`pack_chain_weights`),
    then fw fb (feature), aw ab (alpha, in lane 3 of 8), vwf vwv vb (the
    views layer's weight split into its feature rows and its 27 direction
    rows padded to 32) and rw rb (rgb, in lanes 0:3). Differentiable, like
    `pack_mlp_weights`."""
    if nerf.pts[0].in_features != 63 or nerf.views[0].in_features != NW + 27:
        raise ValueError("the view-direction kernel takes the 63-channel "
                         "point encoding and the 27-channel view encoding")
    ws = pack_chain_weights(nerf.pts)
    vw = nerf.views[0].weight.t()                       # (256 + 27, 128)
    ws += [nerf.feature.weight.t(), _pad_b(nerf.feature.bias, NW),
           F.pad(nerf.alpha.weight.t(), (3, OUT_PAD - 4)),
           F.pad(nerf.alpha.bias, (3, OUT_PAD - 4)).reshape(1, OUT_PAD),
           vw[:NW], _pad_w(vw[NW:], VEMB, VW), _pad_b(nerf.views[0].bias, VW),
           _pad_w(nerf.rgb.weight.t(), VW, OUT_PAD),
           _pad_b(nerf.rgb.bias, OUT_PAD)]
    return tuple(w.float().contiguous() for w in ws)


def cast_mlpv_weights(packed: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """bf16 matrices, f32 biases: what the kernel and its plain version read."""
    return tuple(w.to(torch.bfloat16).contiguous() if i in _MATRIX_IDX
                 else w.float().contiguous() for i, w in enumerate(packed))


def heads_plain(nh8, embvb, mw):
    """(feat, hv, raw) of the heads from nh8, the bf16 view encoding and the
    26 cast weights: `_mlpv_fwd_math`'s last three lines."""
    fw, fb, aw, ab, vwf, vwv, vb, rw, rb = mw[17:]
    bf16 = torch.bfloat16
    feat = (mm_bf16(nh8, fw) + fb).to(bf16)             # NO activation
    hv = torch.relu(mm_bf16(feat, vwf) + mm_bf16(embvb, vwv) + vb).to(bf16)
    raw = mm_bf16(hv, rw) + rb + mm_bf16(nh8, aw) + ab  # rgb 0:3, alpha 3
    return feat, hv, raw


def mlpv_fwd_plain(emb: torch.Tensor, embv: torch.Tensor,
                   mw: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same bf16 casts.

    emb (n, 64) and embv (n, 32) (cast to bf16), mw from
    `cast_mlpv_weights`. Returns raw (n, 8) f32."""
    nh8 = chain_plain(emb.to(torch.bfloat16), mw)[-1]
    return heads_plain(nh8, embv.to(torch.bfloat16), mw)[2]


def _expected_shape(i: int):
    if i in _HEAD_SHAPES:
        return torch.Size(_HEAD_SHAPES[i])
    if i in (0, 10):
        return torch.Size((EMB, NW))
    return torch.Size((NW, NW) if i in _MATRIX_IDX else (1, NW))


def _check_args(emb, embv, mw):
    if emb.dim() != 2 or emb.shape[1] != EMB:
        raise ValueError(f"emb must be (n, {EMB}), got {tuple(emb.shape)}")
    if embv.shape != (emb.shape[0], VEMB) or embv.device != emb.device:
        raise ValueError(f"embv must be ({emb.shape[0]}, {VEMB}) on "
                         f"{emb.device}, got {tuple(embv.shape)} on "
                         f"{embv.device}")
    if len(mw) != N_MLPV_W:
        raise ValueError(f"expected {N_MLPV_W} packed weights, got {len(mw)}")
    for i, w in enumerate(mw):
        want = torch.bfloat16 if i in _MATRIX_IDX else torch.float32
        if w.dtype != want or w.device != emb.device:
            raise ValueError(f"packed weight {i} must be {want} on "
                             f"{emb.device}, got {w.dtype} on {w.device}")


def mlpv_fwd(emb: torch.Tensor, embv: torch.Tensor,
             mw: Sequence[torch.Tensor]) -> torch.Tensor:
    """raw (n, 8) f32 = the view-direction MLP on emb (n, 64), embv (n, 32).

    On CPU tensors this is `mlpv_fwd_plain`. On CUDA tensors it launches the
    CUDA kernel on the current stream (and counts the launch in
    `mlpv_fwd.launches`), or raises."""
    _check_args(emb, embv, mw)
    if emb.device.type == "cpu":
        return mlpv_fwd_plain(emb, embv, mw)
    if emb.device.type != "cuda":
        raise ValueError(f"mlpv_fwd runs on cpu or cuda, not {emb.device}")
    embb = emb.to(torch.bfloat16).contiguous()
    embvb = embv.to(torch.bfloat16).contiguous()
    check_kernel_weights(mw, _expected_shape, "mlpv_fwd")
    for t in (embb, embvb, *mw):
        if t.data_ptr() % 16:
            raise ValueError("mlpv_fwd needs 16-byte aligned tensors")
    n = embb.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"mlpv_fwd takes fewer than 2^31 points, got {n}")
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=emb.device)
    if n == 0:      # nothing to launch, nothing to count
        return out
    lib = _library()
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.nrnerf_mlpv_fwd(embb.data_ptr(), embvb.data_ptr(), n, mats,
                                  biases, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlpv_fwd kernel launch failed: CUDA error {err}")
    mlpv_fwd.launches += 1
    return out


mlpv_fwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("mlpv_fwd.cu")
    fn = lib.nrnerf_mlpv_fwd
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ptrs, ptrs,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
