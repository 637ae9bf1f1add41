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
- `mlp_fwd_points(pts, mw, latents, samples_per_ray)` is the same kernel on
  its second input, the render path's: the points and each ray's latent, from
  which the kernel builds the encoding `points_encoding` gives, bit for bit,
  so no encoding tensor is written; on a CPU tensor `mlp_fwd_points_plain`.

The encoding has 64 lanes (the 63-channel Fourier encoding) or 128 (the
time-conditioned baseline's input: the encoding and the latent, 63 + 32
channels, as the JAX `pack_mlp_weights(in_ch=95)` pads it); n0w and n5e have
as many rows. Any other width raises.

The kernel is bound by the tensor cores (0.987 MFLOP per point against
160 B of HBM traffic at 64 lanes); see the source for its design. On a CUDA
tensor the wrapper first packs the chain's weights into the swizzled image
the kernel streams (`mlp_sm90.pack_chain_image`, one gather).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nonrigid_nerf_torch.ops.embedding import fourier_embed
from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import pack_chain_image

NW = 256          # canonical MLP width
EMB = 64          # 63 encoding channels padded to 64
EMB_TC = 128      # the time-conditioned input, 63 + 32 channels, padded to 128
EMB_WIDTHS = (EMB, EMB_TC)
OUT_PAD = 8       # raw output (4 channels consumed) padded to 8
MULTIRES = 10     # the octaves of the encoding the points input builds
FOURIER_CH = 3 * (1 + 2 * MULTIRES)   # its 63 channels
N_MLP_W = 19


def macs_per_point(emb_width: int = EMB) -> int:
    """MACs per point: E*256 (layer 0) + 7*256*256 (layers 1-4, 5h, 6, 7)
    + E*256 (layer 5 skip) + 256*8 (head), for an encoding of E lanes."""
    return 2 * emb_width * NW + 7 * NW * NW + NW * OUT_PAD


MACS_PER_POINT = macs_per_point(EMB)
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


def check_emb_width(width: int) -> None:
    if width not in EMB_WIDTHS:
        raise ValueError(f"the MLP kernels take an encoding of {EMB_WIDTHS} "
                         f"lanes, got {width}")


def _pad_w(w, rows, cols):
    return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))


def _pad_b(b, cols):
    return F.pad(b, (0, cols - b.shape[0])).reshape(1, cols)


def pack_chain_weights(pts) -> list:
    """The 8 x 256 chain of a `NeRF` module's `pts` layers as the first 17
    packed tensors: n0w n0b n1w n1b n2w n2b n3w n3b n4w n4b n5e n5h n5b n6w
    n6b n7w n7b, in the JAX (fan_in, fan_out) layout. The skip layer's weight
    splits into its input rows (n5e) and its hidden rows (n5h), so the concat
    becomes a sum of two products. The input (63 channels, or 95 with the
    time-conditioned latent) is padded to 64 or 128 lanes; a wider one
    raises."""
    in_ch = pts[0].in_features
    emb_pad = pad_lanes(in_ch)
    check_emb_width(emb_pad)
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

    emb (n, 64 or 128) (cast to bf16), mw from `cast_mlp_weights`. Returns
    (n, 8) f32."""
    check_emb_width(emb.shape[-1])
    nh8 = chain_plain(emb.to(torch.bfloat16), mw)[-1]
    return mm_bf16(nh8, mw[17]) + mw[18]


def _check_weights(mw, width: int, device: torch.device):
    if len(mw) != N_MLP_W:
        raise ValueError(f"expected {N_MLP_W} packed weights, got {len(mw)}")
    for i, w in enumerate(mw):
        want = torch.bfloat16 if i in _MATRIX_IDX else torch.float32
        if w.dtype != want or w.device != device:
            raise ValueError(f"packed weight {i} must be {want} on "
                             f"{device}, got {w.dtype} on {w.device}")
    for i in (0, 10):
        if mw[i].dim() != 2 or mw[i].shape[0] != width:
            raise ValueError(f"packed weight {i} must have {width} rows, as "
                             f"the input has lanes, got {tuple(mw[i].shape)}")


def _check_args(emb, mw):
    if emb.dim() != 2 or emb.shape[1] not in EMB_WIDTHS:
        raise ValueError(f"emb must be (n, 64) or (n, 128), got "
                         f"{tuple(emb.shape)}")
    _check_weights(mw, emb.shape[1], emb.device)


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
    """raw (n, 8) f32 = the canonical MLP on emb (n, 64) or (n, 128).

    On a CPU tensor this is `mlp_fwd_plain`. On a CUDA tensor it launches the
    CUDA kernel on the current stream (and counts the launch in
    `mlp_fwd.launches`, and by width in `mlp_fwd.launches_by_width`), or
    raises."""
    _check_args(emb, mw)
    if emb.device.type == "cpu":
        return mlp_fwd_plain(emb, mw)
    if emb.device.type != "cuda":
        raise ValueError(f"mlp_fwd runs on cpu or cuda, not {emb.device}")
    embb = emb.to(torch.bfloat16).contiguous()
    width = embb.shape[1]
    check_kernel_weights(mw, lambda i: _expected_shape(i, width), "mlp_fwd")
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
    image = pack_chain_image(mw, ("fwd",))
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.nrnerf_mlp_fwd(embb.data_ptr(), n, width, image.data_ptr(),
                                 mats, biases, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlp_fwd kernel launch failed: CUDA error {err}")
    mlp_fwd.launches += 1
    mlp_fwd.launches_by_width[width] += 1
    return out


mlp_fwd.launches = 0
mlp_fwd.launches_by_width = dict.fromkeys(EMB_WIDTHS, 0)
mlp_fwd.points_launches = 0   # of them, on the points input (mlp_fwd_points)


def points_encoding(pts: torch.Tensor, width: int,
                    latents: Optional[torch.Tensor] = None,
                    samples_per_ray: int = 1) -> torch.Tensor:
    """The bf16 encoding (n, width) of points (n, 3) f32 that
    `mlp_fwd_points` builds in the kernel: the 10-octave `fourier_embed` in
    f32, then (with latents (R, L), R * samples_per_ray >= n) the latent of
    each point's ray (point p's is latents[p // samples_per_ray]), zero lanes
    up to `width`, rounded to bf16. The render path's encoding route builds
    this tensor in the same order of operations."""
    emb = fourier_embed(pts.float(), MULTIRES).to(torch.bfloat16)
    if latents is not None:
        emb = torch.cat([emb, latents.to(torch.bfloat16).repeat_interleave(
            samples_per_ray, dim=0)[:emb.shape[0]]], dim=-1)
    return F.pad(emb, (0, width - emb.shape[-1]))


def mlp_fwd_points_plain(pts: torch.Tensor, mw: Sequence[torch.Tensor],
                         latents: Optional[torch.Tensor] = None,
                         samples_per_ray: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel on points: `mlp_fwd_plain` on
    `points_encoding`. Returns (n, 8) f32."""
    return mlp_fwd_plain(points_encoding(pts, mw[0].shape[0], latents,
                                         samples_per_ray), mw)


def _check_points_args(pts, mw, latents, samples_per_ray):
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be (n, 3) f32, got {tuple(pts.shape)} "
                         f"{pts.dtype}")
    width = mw[0].shape[0] if len(mw) == N_MLP_W else None
    if width not in EMB_WIDTHS:
        raise ValueError(f"expected {N_MLP_W} packed weights, the first of "
                         f"{EMB_WIDTHS} rows")
    _check_weights(mw, width, pts.device)
    if samples_per_ray <= 0:
        raise ValueError(f"samples_per_ray must be positive, got "
                         f"{samples_per_ray}")
    if latents is None:
        if width != EMB:
            raise ValueError(f"the {width}-lane input takes latents")
        return width
    if (latents.dim() != 2 or latents.dtype != torch.float32
            or latents.device != pts.device):
        raise ValueError(f"latents must be (R, L) f32 on {pts.device}, got "
                         f"{tuple(latents.shape)} {latents.dtype} on "
                         f"{latents.device}")
    if width != EMB_TC or FOURIER_CH + latents.shape[1] > width:
        raise ValueError(f"{FOURIER_CH} + {latents.shape[1]} latent lanes do "
                         f"not fit the {width}-lane input")
    if latents.shape[0] * samples_per_ray < pts.shape[0]:
        raise ValueError(f"{latents.shape[0]} rays of {samples_per_ray} "
                         f"samples do not cover {pts.shape[0]} points")
    return width


def mlp_fwd_points(pts: torch.Tensor, mw: Sequence[torch.Tensor],
                   latents: Optional[torch.Tensor] = None,
                   samples_per_ray: int = 1) -> torch.Tensor:
    """raw (n, 8) f32 = the canonical MLP on the encoding of pts (n, 3) f32
    (`points_encoding`: with latents (R, L) f32, R * samples_per_ray >= n,
    point p on ray p // samples_per_ray, at the 128-lane input; without, at
    64), bit-equal to `mlp_fwd` on that encoding.

    On a CPU tensor this is `mlp_fwd_points_plain`. On a CUDA tensor it
    launches `mlp_fwd`'s kernel on its points input on the current stream
    and counts the launch in `mlp_fwd.launches`, `mlp_fwd.launches_by_width`
    and `mlp_fwd.points_launches`, or raises."""
    width = _check_points_args(pts, mw, latents, samples_per_ray)
    if pts.device.type == "cpu":
        return mlp_fwd_points_plain(pts, mw, latents, samples_per_ray)
    if pts.device.type != "cuda":
        raise ValueError(f"mlp_fwd_points runs on cpu or cuda, not "
                         f"{pts.device}")
    pts = pts.contiguous()
    lat = latents.contiguous() if latents is not None else None
    check_kernel_weights(mw, lambda i: _expected_shape(i, width),
                         "mlp_fwd_points")
    for t in mw:     # points and latents are read one f32 at a time
        if t.data_ptr() % 16:
            raise ValueError("mlp_fwd_points needs 16-byte aligned weights")
    n = pts.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"mlp_fwd_points takes fewer than 2^31 points, "
                         f"got {n}")
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=pts.device)
    if n == 0:      # nothing to launch, nothing to count
        return out
    lib = _library()
    image = pack_chain_image(mw, ("fwd",))
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    lat_width = lat.shape[1] if lat is not None else 0
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.nrnerf_mlp_fwd_points(
            pts.data_ptr(), lat.data_ptr() if lat_width else None, lat_width,
            samples_per_ray, n, width, image.data_ptr(), mats, biases,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlp_fwd_points kernel launch failed: CUDA error "
                           f"{err}")
    mlp_fwd.launches += 1
    mlp_fwd.launches_by_width[width] += 1
    mlp_fwd.points_launches += 1
    return out


def _expected_shape(i: int, emb_width: int = EMB):
    if i in (0, 10):
        return torch.Size((emb_width, NW))
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
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ptrs, ptrs, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.nrnerf_mlp_fwd_points
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ptrs, ptrs, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
