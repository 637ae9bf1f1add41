"""Int8 inference of the canonical 8 x 256 NeRF MLP as a hand-written CUDA
kernel (`fused_kernel="int8"`), with its calibration and weight packing.

Counterpart of nonrigid_nerf_tpu/ops/pallas/quant_mlp.py, whole: the Pallas
kernel `mlp_i8_core` (math `_i8_fwd_math`, quant_mlp.py:198-257),
`calibrate_act_scales`, `pack_int8_mlp_weights`, `packed_int8_weights`,
`add_quant_scales` and `quantize_for_inference`.

Post-training quantization for the rendering path: int8 weights with one
scale per output channel, int8 activations with one static scale per layer,
calibrated once from a trained model, so that every 256 x 256 product runs on
the tensor cores' int8 path. ReLU activations are non-negative, so a
symmetric int8 range would waste the sign bit: hidden activations quantize
with zero-point -127 (q = round(x * 254 / s) - 127 over [0, s]) and the shift
is repaired exactly in the integer domain, (q + 127) @ W = q @ W + 127 *
colsum(W), with 127 * colsum(qw) * dequant folded into the bias ahead of
time. The encoding is sign-symmetric (sines and cosines), so layer 0 and the
skip of layer 5 quantize symmetrically. The raw head stays bf16 on the
dequantized last hidden layer, so density and colour never quantize.
Inference only: training never quantizes (`make_train_step` rejects the mode).

- `quantize_for_inference(model, cfg, rays_o, rays_d, latents, near, far)`
  calibrates on scene content and returns a model that shares the parameters
  and holds the state (`NRNeRF.quant`); render it with
  `dataclasses.replace(cfg, fused_kernel="int8")`.
- `mlp_i8(emb, qw)` runs the kernel (`csrc/mlp_i8.cu`, on
  `csrc/mlp_sm90.cuh`: int8 wgmma fed by the weight ring) on a CUDA tensor
  and the plain version `mlp_i8_plain` on a CPU tensor. It never falls back:
  a CUDA tensor either launches the kernel or raises. Each call derives the
  kernel's int8 weight image and its epilogues' parameters from the packed
  tuple (`mlp_sm90.pack_i8_image`, `pack_i8_epilogue`): one gather and a few
  small copies, no transposes.

The kernel is bound by the tensor cores at their int8 rate (0.987 MOP per
point against 160 B of HBM traffic); see the source for its design.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from nonrigid_nerf_torch.models.model import NRNeRF, QuantState
from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    EMB, MACS_PER_POINT, NW, OUT_PAD, cast_mlp_weights, chain_plain,
    pack_mlp_weights)
from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import (pack_i8_epilogue,
                                                      pack_i8_image)

N_QW = 28            # packed weights before the quantization multipliers
N_SCALES = 9         # s_emb, s1 .. s8
# the packed tuple (all product operands int8, per-output-channel scales
# folded with the PREVIOUS layer's activation step into f32 dequantization
# rows; biases absorb the zero-point correction):
#   layer 0 (qw0, d0, b0), layers 1-4 (qw, d, b) x 4,
#   layer 5 (qw5h, d5h, b5, qw5e, d5e), layers 6-7 (qw, d, b) x 2,
#   head (owb bf16, ob), qm (1, 16): [127/s_emb, 254/s_1 .. 254/s_8, 0 ...]
_I8_MATRIX_IDX = (0, 3, 6, 9, 12, 18, 15, 20, 23)   # as n0w n1w..n4w n5e n5h n6w n7w
_I8_DEQ_IDX = (1, 4, 7, 10, 13, 19, 16, 21, 24)
_I8_BIAS_IDX = (2, 5, 8, 11, 14, 17, 22, 25)
_I8_OW, _I8_OB, _I8_QM = 26, 27, 28
# Agreement of the kernel with the plain version: the integer sums are exact
# in any order and the epilogue multiplies and adds without contraction, so
# every layer up to h8 is bit-equal; what is left is the order of the f32
# sums of the 256-deep bf16 head, about 1e-6 of |raw|.
I8_TOL_MAX = 1e-4


def calibrate_act_scales(nerf, emb_samples: torch.Tensor) -> torch.Tensor:
    """Per-layer activation maxima of the canonical MLP `nerf` on a
    calibration batch of encoded points (n, 63 or 64), through the bf16 chain
    that `mlp_fwd` computes. Returns (9,) f32: [s_emb, s1..s8]."""
    with torch.no_grad():
        emb = emb_samples.float()
        if emb.shape[-1] == EMB - 1:
            emb = torch.nn.functional.pad(emb, (0, 1))
        embb = emb.to(torch.bfloat16)
        acts = [embb] + chain_plain(embb, cast_mlp_weights(
            pack_mlp_weights(nerf)))
        return torch.stack([a.float().abs().max() for a in acts])


def pack_int8_mlp_weights(nerf, scales: torch.Tensor
                          ) -> Tuple[torch.Tensor, ...]:
    """Quantize the canonical MLP `nerf` into the int8 kernel's 29 weights.

    scales: (9,) f32 from `calibrate_act_scales`. Hidden activation l uses
    zero-point -127 over [0, s_l]; the encoding is symmetric over [-s_emb,
    s_emb]."""
    with torch.no_grad():
        (n0w, n0b, n1w, n1b, n2w, n2b, n3w, n3b, n4w, n4b,
         n5e, n5h, n5b, n6w, n6b, n7w, n7b, ow, ob) = pack_mlp_weights(nerf)
        s = [torch.clamp(scales[i].float(), min=1e-8) for i in range(N_SCALES)]

        def quant_w(w):
            ws = w.abs().amax(dim=0, keepdim=True) / 127.0
            ws = torch.clamp(ws, min=1e-12)
            return torch.round(w / ws).to(torch.int8), ws

        def shifted(qw, d, b):
            # the bias absorbs 127 * colsum(qw) * dequant
            return b + 127.0 * qw.float().sum(dim=0, keepdim=True) * d

        out = []
        # layer 0: the symmetric encoding, quantization step s_emb / 127
        qw0, ws0 = quant_w(n0w)
        out += [qw0, (s[0] / 127.0) * ws0, n0b]
        # layers 1..4: ReLU input from layer l, step s_l / 254
        for l, (w, b) in enumerate(((n1w, n1b), (n2w, n2b), (n3w, n3b),
                                    (n4w, n4b)), start=1):
            qw, ws = quant_w(w)
            d = (s[l] / 254.0) * ws
            out += [qw, d, shifted(qw, d, b)]
        # layer 5 (skip): the hidden branch from nh5 (zero-point -127) and
        # the encoding branch (symmetric)
        qw5h, ws5h = quant_w(n5h)
        d5h = (s[5] / 254.0) * ws5h
        qw5e, ws5e = quant_w(n5e)
        d5e = (s[0] / 127.0) * ws5e
        out += [qw5h, d5h, shifted(qw5h, d5h, n5b), qw5e, d5e]
        for l, (w, b) in enumerate(((n6w, n6b), (n7w, n7b)), start=6):
            qw, ws = quant_w(w)
            d = (s[l] / 254.0) * ws
            out += [qw, d, shifted(qw, d, b)]
        # the head: bf16 on the dequantized last hidden layer
        out += [ow.to(torch.bfloat16), ob]
        qm = torch.zeros((1, 16), dtype=torch.float32, device=ow.device)
        qm[0, 0] = 127.0 / s[0]
        for l in range(1, N_SCALES):
            qm[0, l] = 254.0 / s[l]
        out.append(qm)
        if len(out) != N_QW + 1:
            raise AssertionError(f"packed {len(out)} int8 weights")
        return tuple(t.contiguous() for t in out)


def packed_int8_weights(state: QuantState, nerf) -> Tuple[torch.Tensor, ...]:
    """The kernel's weights from a network's `QuantState`: the tuple packed
    at calibration time, or, for a state that holds the scales alone, packed
    now from `nerf`."""
    packed = state.packed
    return packed if packed is not None \
        else pack_int8_mlp_weights(nerf, state.scales)


def add_quant_scales(model: NRNeRF, emb_samples: torch.Tensor) -> NRNeRF:
    """A model that shares `model`'s parameters and holds, per network, the
    calibration scales AND the packed int8 weights (so the rounding, the
    clipping and the bias folds run once here, not in the renderer's block
    loop). `model` itself stays without them."""
    quant = {}
    for network in ("coarse", "fine"):
        nerf = getattr(model, network)
        if nerf is not None:
            scales = calibrate_act_scales(nerf, emb_samples)
            quant[network] = QuantState(
                scales, pack_int8_mlp_weights(nerf, scales))
    return model.with_quant(quant)


def quantize_for_inference(model: NRNeRF, cfg, rays_o, rays_d, latents,
                           near: float, far: float, n_rays: int = 512,
                           n_samples: int = 64) -> NRNeRF:
    """Calibrate the int8 activation scales on scene content and return a
    model with the `quant` state set (see `add_quant_scales`).

    Takes a strided subset of the given rays (tensors or arrays: rays_o,
    rays_d (..., 3), latents one row per ray), samples them without jitter,
    runs the bending field and the positional encoding on the model's
    device, and records the per-layer activation maxima of both canonical
    MLPs on those encodings."""
    from nonrigid_nerf_torch.engine.query import bend_encode_stage
    from nonrigid_nerf_torch.ops.sampling import stratified_z_vals

    device = model.latents.device

    def on_device(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x, np.float32))
        return x.detach().to(device=device, dtype=torch.float32)

    rays_o = on_device(rays_o).reshape(-1, 3)
    rays_d = on_device(rays_d).reshape(-1, 3)
    latents = on_device(latents).reshape(rays_o.shape[0], -1)
    stride = max(1, rays_o.shape[0] // n_rays)
    rays_o, rays_d = rays_o[::stride][:n_rays], rays_d[::stride][:n_rays]
    lat = latents[::stride][:n_rays]
    with torch.no_grad():
        z = stratified_z_vals(near, far, rays_o.shape[0], n_samples,
                              perturb=0.0, device=device)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., :, None]
        st = bend_encode_stage(model, cfg, pts, lat)
        emb = st["embedded"].float().reshape(-1, cfg.input_ch)
    return add_quant_scales(model, emb)


def _mm_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> the int32 sums as f32: an f32 matmul of the int8
    values is exact in any order (at most 256 * 127 * 127 < 2^24)."""
    return a.float() @ b.float()


def _quant_sym(x, m):
    return torch.round(torch.clamp(x * m, -127.0, 127.0)).to(torch.int8)


def _quant_relu(x, m):
    # x is post-ReLU (>= 0): zero-point -127 over [0, s]
    return (torch.round(torch.clamp(x * m, 0.0, 254.0)) - 127.0).to(torch.int8)


def i8_chain_plain(emb: torch.Tensor, qw: Sequence[torch.Tensor]):
    """The int8 chain of `_i8_fwd_math` line for line up to h8: ([qemb, q1
    .. q7] int8, h8 f32). emb (n, 64) (bf16 or f32 holding bf16 values), qw
    the 29 packed weights."""
    (qw0, d0, b0, qw1, d1, b1, qw2, d2, b2, qw3, d3, b3, qw4, d4, b4,
     qw5h, d5h, b5, qw5e, d5e, qw6, d6, b6, qw7, d7, b7, owb, ob, qm) = qw
    qemb = _quant_sym(emb.float(), qm[0, 0])
    acts = [qemb]
    h = torch.relu(_mm_i8(qemb, qw0) * d0 + b0)
    for l, (w, d, b) in enumerate(((qw1, d1, b1), (qw2, d2, b2),
                                   (qw3, d3, b3), (qw4, d4, b4)), start=1):
        acts.append(_quant_relu(h, qm[0, l]))
        h = torch.relu(_mm_i8(acts[-1], w) * d + b)
    acts.append(_quant_relu(h, qm[0, 5]))
    h = torch.relu(_mm_i8(acts[-1], qw5h) * d5h
                   + _mm_i8(qemb, qw5e) * d5e + b5)
    for l, (w, d, b) in enumerate(((qw6, d6, b6), (qw7, d7, b7)), start=6):
        acts.append(_quant_relu(h, qm[0, l]))
        h = torch.relu(_mm_i8(acts[-1], w) * d + b)
    return acts, h


def mlp_i8_plain(emb: torch.Tensor, qw: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `_i8_fwd_math` line for line.

    emb (n, 64) (bf16 or f32 holding bf16 values), qw the 29 packed weights.
    Returns (n, 8) f32."""
    _, h8 = i8_chain_plain(emb, qw)
    return h8.to(torch.bfloat16).float() @ qw[_I8_OW].float() + qw[_I8_OB]


def _expected_i8(i: int):
    """(shape, dtype) of packed int8 weight i."""
    if i in _I8_MATRIX_IDX:
        rows = EMB if i in (0, 18) else NW
        return torch.Size((rows, NW)), torch.int8
    if i == _I8_OW:
        return torch.Size((NW, OUT_PAD)), torch.bfloat16
    if i == _I8_OB:
        return torch.Size((1, OUT_PAD)), torch.float32
    if i == _I8_QM:
        return torch.Size((1, 16)), torch.float32
    return torch.Size((1, NW)), torch.float32


def _check_args(emb, qw):
    if emb.dim() != 2 or emb.shape[1] != EMB:
        raise ValueError(f"emb must be (n, {EMB}), got {tuple(emb.shape)}")
    if len(qw) != N_QW + 1:
        raise ValueError(f"expected {N_QW + 1} packed int8 weights, got "
                         f"{len(qw)}")
    for i, w in enumerate(qw):
        shape, dtype = _expected_i8(i)
        if w.shape != shape or w.dtype != dtype or w.device != emb.device:
            raise ValueError(
                f"packed int8 weight {i} must be {tuple(shape)} {dtype} on "
                f"{emb.device}, got {tuple(w.shape)} {w.dtype} on {w.device}")


def mlp_i8(emb: torch.Tensor, qw: Sequence[torch.Tensor]) -> torch.Tensor:
    """raw (n, 8) f32 = the int8 canonical MLP on emb (n, 64).

    On a CPU tensor this is `mlp_i8_plain`. On a CUDA tensor it launches the
    CUDA kernel on the current stream (and counts the launch in
    `mlp_i8.launches`), or raises."""
    _check_args(emb, qw)
    if emb.device.type == "cpu":
        return mlp_i8_plain(emb.to(torch.bfloat16), qw)
    if emb.device.type != "cuda":
        raise ValueError(f"mlp_i8 runs on cpu or cuda, not {emb.device}")
    embb = emb.to(torch.bfloat16).contiguous()
    for t in (embb, *qw):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mlp_i8 needs contiguous, 16-byte aligned "
                             "tensors")
    n = embb.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"mlp_i8 takes fewer than 2^31 points, got {n}")
    out = torch.empty((n, OUT_PAD), dtype=torch.float32, device=emb.device)
    if n == 0:      # nothing to launch, nothing to count
        return out
    lib = _library()
    # the kernel's image of the nine int8 matrices (17 chunks of 32 KB) and
    # its epilogues' parameters, derived on each call
    image = pack_i8_image([qw[i] for i in _I8_MATRIX_IDX])
    epi = pack_i8_epilogue([qw[i] for i in _I8_DEQ_IDX],
                           [qw[i] for i in _I8_BIAS_IDX])
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.nrnerf_mlp_i8(
            embb.data_ptr(), n, image.data_ptr(), epi.data_ptr(),
            qw[_I8_OW].data_ptr(), qw[_I8_OB].data_ptr(),
            qw[_I8_QM].data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlp_i8 kernel launch failed: CUDA error {err}")
    mlp_i8.launches += 1
    return out


mlp_i8.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("mlp_i8.cu")
    fn = lib.nrnerf_mlp_i8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return lib
