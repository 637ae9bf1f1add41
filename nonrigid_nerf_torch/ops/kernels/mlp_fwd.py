"""The canonical 8 x 256 NeRF MLP forward as a hand-written CUDA kernel.

Counterpart of the Pallas kernel `_mlp_core` (forward `_mlp_pallas_fwd` /
`_mlp_fwd_math`, nonrigid_nerf_tpu/ops/pallas/fused_query.py:677-694,804-822)
and of its weight packing `pack_mlp_weights` (fused_query.py:120-153).

- `pack_mlp_weights(nerf)` flattens a `NeRF` module into the 19 padded f32
  arrays of the JAX packing, in the JAX (fan_in, fan_out) layout.
- `cast_mlp_weights(packed)` casts the matrices to bf16 once, outside the
  kernel, and keeps the biases f32 (`_cast_matmul_weights`).
- `mlp_fwd(emb, mw)` runs the kernel (`csrc/mlp_fwd.cu`) on a CUDA tensor and
  the plain version `mlp_fwd_plain` on a CPU tensor. It never falls back: a
  CUDA tensor either launches the kernel or raises.

The kernel is bound by the tensor cores (0.987 MFLOP per point against
160 B of HBM traffic); see the source for its design.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library

NW = 256          # canonical MLP width
EMB = 64          # 63 encoding channels padded to 64
OUT_PAD = 8       # raw output (4 channels consumed) padded to 8
N_MLP_W = 19
# MACs per point: 64*256 (layer 0) + 7*256*256 (layers 1-4, 5h, 6, 7)
# + 64*256 (layer 5 skip) + 256*8 (head)
MACS_PER_POINT = 2 * EMB * NW + 7 * NW * NW + NW * OUT_PAD
# Agreement of two implementations of the bf16 chain (this kernel, its plain
# version, the JAX math): f32 sums in another order flip an occasional bf16
# rounding between layers, which reaches raw at about 1e-4. Observed max /
# mean abs error on |raw| ~ 1: 9.3e-5 / 1.2e-7 on the CPU (plain vs JAX);
# 3.9e-4 / 5.7e-7 on the H100 at 2^21 points (kernel vs plain).
BF16_TOL_MAX = 1e-3
BF16_TOL_MEAN = 2e-6

_MATRIX_IDX = (0, 2, 4, 6, 8, 10, 11, 13, 15, 17)   # n0w..n4w, n5e, n5h, n6w, n7w, ow
_BIAS_IDX = (1, 3, 5, 7, 9, 12, 14, 16, 18)         # n0b..n4b, n5b, n6b, n7b, ob


def pad_lanes(n_ch: int) -> int:
    """Input channels padded to a multiple of 64 lanes."""
    return -(-n_ch // 64) * 64


def _pad_w(w, rows, cols):
    return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))


def _pad_b(b, cols):
    return F.pad(b, (0, cols - b.shape[0])).reshape(1, cols)


def pack_chain_weights(pts) -> list:
    """The 8 x 256 chain of a `NeRF` module's `pts` layers as the first 17
    packed tensors: n0w n0b n1w n1b n2w n2b n3w n3b n4w n4b n5e n5h n5b n6w
    n6b n7w n7b, in the JAX (fan_in, fan_out) layout. The skip layer's weight
    splits into its input rows (n5e) and its hidden rows (n5h), so the concat
    becomes a sum of two products."""
    in_ch = pts[0].in_features
    emb_pad = pad_lanes(in_ch)
    ws = [_pad_w(pts[0].weight.t(), emb_pad, NW), _pad_b(pts[0].bias, NW)]
    for i in (1, 2, 3, 4):
        ws += [pts[i].weight.t(), _pad_b(pts[i].bias, NW)]
    w5 = pts[5].weight.t()
    ws += [_pad_w(w5[:in_ch], emb_pad, NW), w5[in_ch:],
           _pad_b(pts[5].bias, NW)]
    for i in (6, 7):
        ws += [pts[i].weight.t(), _pad_b(pts[i].bias, NW)]
    return ws


def pack_mlp_weights(nerf) -> Tuple[torch.Tensor, ...]:
    """The canonical chain + raw head of a `NeRF` module as 19 padded f32
    tensors, equal to the JAX `pack_mlp_weights` (fan_in, fan_out layout):
    the 17 of `pack_chain_weights`, then ow ob. Differentiable: padding,
    transposing and slicing carry a gradient of the packed tensors back to
    the `nn.Linear` parameters and drop the pad rows."""
    ws = pack_chain_weights(nerf.pts)
    ws += [_pad_w(nerf.output.weight.t()[:, :4], NW, OUT_PAD),
           _pad_b(nerf.output.bias[:4], OUT_PAD)]
    return tuple(w.float().contiguous() for w in ws)


def cast_mlp_weights(packed: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """bf16 matrices, f32 biases: what the kernel and its plain version read."""
    return tuple(w.to(torch.bfloat16).contiguous() if i in _MATRIX_IDX
                 else w.float().contiguous() for i, w in enumerate(packed))


def mm_bf16(a, w):
    """a @ w for bf16 values, summed in f32: bf16 x bf16 products are exact
    in f32, so an f32 matmul of the bf16 values is the kernels' arithmetic up
    to the order of the f32 sums."""
    return a.float() @ w.float()


def chain_plain(embb: torch.Tensor, mw: Sequence[torch.Tensor]):
    """[nh1 .. nh8] of the chain in bf16 from the bf16 encoding and the first
    17 cast weights."""
    (n0w, n0b, n1w, n1b, n2w, n2b, n3w, n3b, n4w, n4b,
     n5e, n5h, n5b, n6w, n6b, n7w, n7b) = mw[:17]
    bf16 = torch.bfloat16
    nh = [torch.relu(mm_bf16(embb, n0w) + n0b).to(bf16)]
    for w, b in ((n1w, n1b), (n2w, n2b), (n3w, n3b), (n4w, n4b)):
        nh.append(torch.relu(mm_bf16(nh[-1], w) + b).to(bf16))
    nh.append(torch.relu(mm_bf16(nh[-1], n5h) + mm_bf16(embb, n5e)
                         + n5b).to(bf16))
    for w, b in ((n6w, n6b), (n7w, n7b)):
        nh.append(torch.relu(mm_bf16(nh[-1], w) + b).to(bf16))
    return nh


def mlp_fwd_plain(emb: torch.Tensor, mw: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same bf16 casts.

    emb (n, 64) (cast to bf16), mw from `cast_mlp_weights`. Returns (n, 8)
    f32."""
    nh8 = chain_plain(emb.to(torch.bfloat16), mw)[-1]
    return mm_bf16(nh8, mw[17]) + mw[18]


def _check_args(emb, mw):
    if emb.dim() != 2 or emb.shape[1] != EMB:
        raise ValueError(f"emb must be (n, {EMB}), got {tuple(emb.shape)}")
    if len(mw) != N_MLP_W:
        raise ValueError(f"expected {N_MLP_W} packed weights, got {len(mw)}")
    for i, w in enumerate(mw):
        want = torch.bfloat16 if i in _MATRIX_IDX else torch.float32
        if w.dtype != want or w.device != emb.device:
            raise ValueError(f"packed weight {i} must be {want} on "
                             f"{emb.device}, got {w.dtype} on {w.device}")


def check_kernel_weights(mw, expected_shape, what: str):
    """What the CUDA kernels read: contiguous tensors of the packed shapes
    (`expected_shape(i)` of weight i)."""
    for i, w in enumerate(mw):
        if w.shape != expected_shape(i) or not w.is_contiguous():
            raise ValueError(f"{what}: packed weight {i} must be contiguous "
                             f"{tuple(expected_shape(i))}, got "
                             f"{tuple(w.shape)}")


def weight_pointers(mw, matrix_idx, bias_idx):
    """The ctypes arrays of matrix and bias pointers of the C interfaces."""
    mats = (ctypes.c_void_p * len(matrix_idx))(
        *(mw[i].data_ptr() for i in matrix_idx))
    biases = (ctypes.c_void_p * len(bias_idx))(
        *(mw[i].data_ptr() for i in bias_idx))
    return mats, biases


def mlp_fwd(emb: torch.Tensor, mw: Sequence[torch.Tensor]) -> torch.Tensor:
    """raw (n, 8) f32 = the canonical MLP on emb (n, 64).

    On a CPU tensor this is `mlp_fwd_plain`. On a CUDA tensor it launches the
    CUDA kernel on the current stream (and counts the launch in
    `mlp_fwd.launches`), or raises."""
    _check_args(emb, mw)
    if emb.device.type == "cpu":
        return mlp_fwd_plain(emb, mw)
    if emb.device.type != "cuda":
        raise ValueError(f"mlp_fwd runs on cpu or cuda, not {emb.device}")
    embb = emb.to(torch.bfloat16).contiguous()
    check_kernel_weights(mw, _expected_shape, "mlp_fwd")
    for t in (embb, *mw):
        if t.data_ptr() % 16:
            raise ValueError("mlp_fwd needs 16-byte aligned tensors")
    n = embb.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"mlp_fwd takes fewer than 2^31 points, got {n}")
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=emb.device)
    if n == 0:      # nothing to launch, nothing to count
        return out
    lib = _library()
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.nrnerf_mlp_fwd(embb.data_ptr(), n, mats, biases,
                                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlp_fwd kernel launch failed: CUDA error {err}")
    mlp_fwd.launches += 1
    return out


mlp_fwd.launches = 0


def _expected_shape(i: int):
    if i in (0, 10):
        return torch.Size((EMB, NW))
    if i == 17:
        return torch.Size((NW, OUT_PAD))
    if i == 18:
        return torch.Size((1, OUT_PAD))
    if i in _MATRIX_IDX:
        return torch.Size((NW, NW))
    return torch.Size((1, NW))


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("mlp_fwd.cu")
    fn = lib.nrnerf_mlp_fwd
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ptrs, ptrs,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
