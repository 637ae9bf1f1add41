"""The canonical 8 x 256 NeRF MLP backward as a hand-written CUDA kernel, and
the autograd function that joins it to the forward kernel.

Counterpart of the Pallas kernel `_mlp_core_bwd` and its math `_mlp_bwd_math`
(nonrigid_nerf_tpu/ops/pallas/fused_query.py:702-767,833-858), and of the
`jax.custom_vjp` around `_mlp_core` (fused_query.py:816-861).

- `mlp_bwd(embb, mw, draw)` runs the kernels of `csrc/mlp_bwd.cu` on a CUDA
  tensor and the plain version `mlp_bwd_plain` on a CPU tensor. It never
  falls back: a CUDA tensor either launches the kernels or raises. The
  result is deterministic (bit-equal from run to run): partial sums are
  reduced in a fixed order, never with atomics.
- `MLPCore.apply(emb, *packed)` is the differentiable canonical MLP: forward
  `mlp_fwd`, backward `mlp_bwd`. Nothing but the bf16 encoding and the packed
  f32 weights is kept between the two; the backward recomputes the
  activations.

The encoding has 64 or 128 lanes, as for `mlp_fwd`; demb comes back at the
full width, so with the time-conditioned input its lanes 63 .. 94 are the
gradient of the latents.

The kernel is bound by the tensor cores (2.96 MFLOP per point against 416 B
of HBM traffic per point at 64 lanes); see the source for its design. On a
CUDA tensor the wrapper first packs the chain's forward and backward chunks
into the swizzled image the chain kernel streams
(`mlp_sm90.pack_chain_image`).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from nonrigid_nerf_torch.ops.kernels.build import load_kernel_library
from nonrigid_nerf_torch.ops.kernels.mlp_sm90 import pack_chain_image
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    EMB, EMB_WIDTHS, N_MLP_W, OUT_PAD, _BIAS_IDX, _MATRIX_IDX,
    _check_args, _expected_shape, cast_mlp_weights, chain_plain,
    check_emb_width, check_kernel_weights, macs_per_point, mlp_fwd,
    weight_pointers)


def bwd_macs_per_point(emb_width: int = EMB) -> int:
    """The recompute, the dh chain and the dW products, each as many MACs
    as the forward."""
    return 3 * macs_per_point(emb_width)


def grad_shapes(emb_width: int = EMB):
    """The 19 gradients' (padded) shapes in pack order."""
    return tuple(_expected_shape(i, emb_width) for i in range(N_MLP_W))


BWD_MACS_PER_POINT = bwd_macs_per_point(EMB)
_SHAPES = grad_shapes(EMB)
GRAD_FLOATS = sum(shape.numel() for shape in _SHAPES)
# one call takes at most this many points: the bf16 scratch (8,320 B per
# point at 64 lanes, 8,448 at 128) then stays at 2.06 GiB. The training step
# gives 131,072 at most.
MAX_POINTS_PER_LAUNCH = 1 << 18
# Agreement of two implementations of the bf16 backward (these kernels, the
# plain version, the JAX math). f32 sums in another order flip an occasional
# bf16 rounding, which moves single entries by about one bf16 ulp (2^-8) of
# one term; and a pre-activation within an f32 rounding of 0 flips its ReLU
# gate, which changes that one point's whole row of demb and adds a rank-1
# error to every dW below the gate (about one point in a few thousand; the
# fewer points a dW sums, the more one flip weighs: up to 1/sqrt(n) of a
# column). The limits:
# - each of the 19 gradients (sums over all n points): relative L2 error at
#   most BWD_TOL_L2, and max abs error at most `grad_max_tol(n)` of the
#   array's max magnitude: BWD_TOL_MAX, or 1/sqrt(n) where that is larger
#   (below 1,112 points);
# - demb (one row per point): relative L2 error at most BWD_TOL_L2, at most
#   BWD_TOL_OUTLIERS of its entries off by more than BWD_TOL_ENTRY of the
#   max magnitude, and none by more than BWD_TOL_DEMB_MAX of it (a flipped
#   gate's row).
# Observed on the CPU, plain vs JAX math: n = 300 without a gate flip:
# gradients 9.0e-4 max, 3.3e-4 L2; n = 300 with one (against Pallas
# interpret mode): 3.1e-2 max; n = 4101: gradients 9.4e-3 max, 3.0e-3 L2,
# demb 1.9e-3 L2, 1.1e-4 outliers (3.2e-2 of max at the worst entry).
# Observed on an H100, kernels vs plain, n = 65,536 / 131,072: gradients
# 7.8e-3 / 1.0e-2 max, 4.1e-3 / 4.3e-3 L2; demb 3.1e-3 / 3.6e-3 L2, worst
# entry 6.6e-2 / 1.04e-1. So BWD_TOL_MAX and BWD_TOL_DEMB_MAX are three
# times the largest sound reading.
BWD_TOL_L2 = 1e-2
BWD_TOL_MAX = 3e-2
BWD_TOL_ENTRY = 3e-2
BWD_TOL_OUTLIERS = 1e-3
BWD_TOL_DEMB_MAX = 3e-1
# names of demb and the 19 gradients in pack order, for reports
BWD_NAMES = ("demb", "n0w", "n0b", "n1w", "n1b", "n2w", "n2b", "n3w", "n3b",
             "n4w", "n4b", "n5e", "n5h", "n5b", "n6w", "n6b", "n7w", "n7b",
             "ow", "ob")


def grad_max_tol(n: int) -> float:
    """The limit on a weight gradient's max abs error, as a share of the
    array's max magnitude, when it sums n points."""
    return max(BWD_TOL_MAX, 1.0 / max(n, 1) ** 0.5)


def agreement(per_point, per_point_ref, grads, grads_ref, names) -> dict:
    """Error statistics of per-point arrays (demb, and dembv where there is
    one) and weight gradients against references, and `ok`: whether they are
    within the tolerances above. `names` are the per-point arrays' names,
    then the gradients'; `max_rel` holds each array's max abs error over its
    max magnitude, by name. The `demb_*` entries are the worst over the
    per-point arrays."""
    def rel(a, b):
        a, b = a.detach().double(), b.detach().double()
        if b.numel() == 0:
            return 0.0, 0.0, 0.0
        err = (a - b).abs()
        scale = max(b.abs().max().item(), 1e-30)
        l2 = (torch.linalg.vector_norm(a - b)
              / max(torch.linalg.vector_norm(b).item(), 1e-30)).item()
        return (err.max().item() / scale, l2,
                (err > BWD_TOL_ENTRY * scale).double().mean().item())

    stats = [rel(a, b) for a, b in zip(grads, grads_ref)]
    pp = [rel(a, b) for a, b in zip(per_point, per_point_ref)]
    finite = all(bool(torch.isfinite(t).all()) for t in (*per_point, *grads))
    out = {"grad_max_rel": max(s[0] for s in stats),
           "grad_l2_rel": max(s[1] for s in stats),
           "demb_max_rel": max(s[0] for s in pp),
           "demb_l2_rel": max(s[1] for s in pp),
           "demb_outliers": max(s[2] for s in pp), "finite": finite,
           "max_rel": dict(zip(names, [s[0] for s in pp + stats]))}
    out["ok"] = (finite and len(per_point) == len(per_point_ref)
                 and len(grads) == len(grads_ref) == len(names) - len(per_point)
                 and out["grad_max_rel"] <= grad_max_tol(per_point[0].shape[0])
                 and out["grad_l2_rel"] <= BWD_TOL_L2
                 and out["demb_l2_rel"] <= BWD_TOL_L2
                 and out["demb_outliers"] <= BWD_TOL_OUTLIERS
                 and out["demb_max_rel"] <= BWD_TOL_DEMB_MAX)
    return out


def bwd_agreement(got, ref) -> dict:
    """`agreement` of (demb, grads) against a reference pair."""
    return agreement([got[0]], [ref[0]], got[1], ref[1], BWD_NAMES)


def mm_nt(x, w):
    """x @ w^T with x rounded to bf16: reads the weight's other axis."""
    return x.to(torch.bfloat16).float() @ w.float().t()


def mm_tn(act, g):
    """act^T @ g with g rounded to bf16: contracts over the points."""
    return act.float().t() @ g.to(torch.bfloat16).float()


def bsum(g):
    return g.float().sum(dim=0, keepdim=True)


def masked(g, nh):
    """The ReLU gate of the recomputed activation; rounded to bf16 before
    any further use."""
    return (g * (nh.float() > 0)).to(torch.bfloat16)


def chain_bwd_plain(embb, nh, mw, dh8):
    """The dh chain from dh8 down: demb (n, E) f32 and the chain's 17
    gradients in pack order. nh = [nh1 .. nh8] from `chain_plain`."""
    (n0w, _, n1w, _, n2w, _, n3w, _, n4w, _, n5e, n5h, _, n6w, _, n7w,
     _) = mw[:17]
    nh1, nh2, nh3, nh4, nh5, nh6, nh7, nh8 = nh
    g_n7w, g_n7b = mm_tn(nh7, dh8), bsum(dh8)
    dh7 = masked(mm_nt(dh8, n7w), nh7)
    g_n6w, g_n6b = mm_tn(nh6, dh7), bsum(dh7)
    dh6 = masked(mm_nt(dh7, n6w), nh6)
    g_n5h, g_n5e, g_n5b = mm_tn(nh5, dh6), mm_tn(embb, dh6), bsum(dh6)
    demb = mm_nt(dh6, n5e)                 # the skip: f32, no mask
    dh5 = masked(mm_nt(dh6, n5h), nh5)
    g_n4w, g_n4b = mm_tn(nh4, dh5), bsum(dh5)
    dh4 = masked(mm_nt(dh5, n4w), nh4)
    g_n3w, g_n3b = mm_tn(nh3, dh4), bsum(dh4)
    dh3 = masked(mm_nt(dh4, n3w), nh3)
    g_n2w, g_n2b = mm_tn(nh2, dh3), bsum(dh3)
    dh2 = masked(mm_nt(dh3, n2w), nh2)
    g_n1w, g_n1b = mm_tn(nh1, dh2), bsum(dh2)
    dh1 = masked(mm_nt(dh2, n1w), nh1)
    g_n0w, g_n0b = mm_tn(embb, dh1), bsum(dh1)
    demb = demb + mm_nt(dh1, n0w)
    return demb, [g_n0w, g_n0b, g_n1w, g_n1b, g_n2w, g_n2b, g_n3w, g_n3b,
                  g_n4w, g_n4b, g_n5e, g_n5h, g_n5b, g_n6w, g_n6b, g_n7w,
                  g_n7b]


def mlp_bwd_plain(embb: torch.Tensor, mw: Sequence[torch.Tensor],
                  draw: torch.Tensor
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of the kernel: `_mlp_bwd_math` line for line.

    embb (n, 64 or 128) (cast to bf16), mw from `cast_mlp_weights`, draw
    (n, 8) f32. bf16 x bf16 products are exact in f32, so an f32 matmul of
    the bf16 values is the kernel's arithmetic up to the order of the f32
    sums. Returns demb (n, 64 or 128) f32 and the 19 f32 gradients in pack
    order."""
    check_emb_width(embb.shape[-1])
    ow = mw[17]
    # the forward activations, recomputed in bf16 from embb as in mlp_fwd
    embb = embb.to(torch.bfloat16)
    nh = chain_plain(embb, mw)
    drawb = draw.to(torch.bfloat16)
    g_ow = mm_tn(nh[7], drawb)
    g_ob = bsum(draw)                      # the f32 sum of the UNCAST draw
    dh8 = masked(mm_nt(drawb, ow), nh[7])
    demb, grads = chain_bwd_plain(embb, nh, mw, dh8)
    return demb, grads + [g_ow, g_ob]


def split_grads(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """The gradients as views of one flat pack-order buffer."""
    out, off = [], 0
    for shape in shapes:
        out.append(flat[off:off + shape.numel()].view(shape))
        off += shape.numel()
    return out


def mlp_bwd(embb: torch.Tensor, mw: Sequence[torch.Tensor],
            draw: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """demb (n, E) f32 and the 19 f32 weight gradients (pack order, padded
    shapes, summed over all n points) of the canonical MLP at embb (n, E),
    E = 64 or 128, for the cotangent draw (n, 8).

    On a CPU tensor this is `mlp_bwd_plain`. On a CUDA tensor it launches
    the CUDA kernels on the current stream (and counts the call in
    `mlp_bwd.launches`, and by width in `mlp_bwd.launches_by_width`), or
    raises."""
    _check_args(embb, mw)
    if draw.shape != (embb.shape[0], OUT_PAD) or draw.device != embb.device:
        raise ValueError(f"draw must be ({embb.shape[0]}, {OUT_PAD}) on "
                         f"{embb.device}, got {tuple(draw.shape)} on "
                         f"{draw.device}")
    if embb.device.type == "cpu":
        return mlp_bwd_plain(embb, mw, draw.float())
    if embb.device.type != "cuda":
        raise ValueError(f"mlp_bwd runs on cpu or cuda, not {embb.device}")
    embb = embb.to(torch.bfloat16).contiguous()
    draw = draw.float().contiguous()
    n, width = embb.shape
    shapes = grad_shapes(width)
    check_kernel_weights(mw, lambda i: shapes[i], "mlp_bwd")
    device = embb.device
    if n > MAX_POINTS_PER_LAUNCH:
        raise ValueError(f"mlp_bwd takes at most {MAX_POINTS_PER_LAUNCH} "
                         f"points per call, got {n}")
    demb = torch.empty((n, width), dtype=torch.float32, device=device)
    grad_floats = sum(shape.numel() for shape in shapes)
    if n == 0:      # nothing to launch, nothing to count
        return demb, split_grads(torch.zeros(grad_floats, device=device),
                                 shapes)
    lib = _library()
    mats, biases = weight_pointers(mw, _MATRIX_IDX, _BIAS_IDX)
    scratch_elems, partial_floats = ctypes.c_longlong(), ctypes.c_longlong()
    err = lib.nrnerf_mlp_bwd_sizes(n, width, ctypes.byref(scratch_elems),
                                   ctypes.byref(partial_floats))
    if err != 0:
        raise RuntimeError(f"mlp_bwd_sizes failed: CUDA error {err}")
    scratch = torch.empty(scratch_elems.value, dtype=torch.bfloat16,
                          device=device)
    partials = torch.empty(partial_floats.value, dtype=torch.float32,
                           device=device)
    grads = torch.empty(grad_floats, dtype=torch.float32, device=device)
    image = pack_chain_image(mw, ("fwd", "bwd"))
    for t in (embb, draw, demb, scratch, partials, grads, *mw):
        if t.data_ptr() % 16:
            raise ValueError("mlp_bwd needs 16-byte aligned tensors")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nrnerf_mlp_bwd(embb.data_ptr(), draw.data_ptr(), n, width,
                                 image.data_ptr(), mats, biases,
                                 scratch.data_ptr(),
                                 partials.data_ptr(), demb.data_ptr(),
                                 grads.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mlp_bwd kernel launch failed: CUDA error {err}")
    mlp_bwd.launches += 1
    mlp_bwd.launches_by_width[width] += 1
    return demb, split_grads(grads, shapes)


mlp_bwd.launches = 0
mlp_bwd.launches_by_width = dict.fromkeys(EMB_WIDTHS, 0)


def _library() -> ctypes.CDLL:
    lib = load_kernel_library("mlp_bwd.cu")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.nrnerf_mlp_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ptrs, ptrs, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.nrnerf_mlp_bwd.restype = ctypes.c_int
    lib.nrnerf_mlp_bwd_sizes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.nrnerf_mlp_bwd_sizes.restype = ctypes.c_int
    return lib


class MLPCore(torch.autograd.Function):
    """raw (n, 8) f32 = the canonical MLP on emb (n, 64 or 128),
    differentiable.

    `MLPCore.apply(emb, *packed)` takes the 19 packed f32 tensors of
    `pack_mlp_weights` and casts the ten matrices to bf16 itself. The
    backward returns demb in f32 (a bf16 `emb` gets it rounded by autograd;
    hand over the f32 encoding to keep it exact, as the JAX package does)
    and the 19 f32 gradients in pack order. The saved tensors are read, not
    consumed, so the backward may run once per cotangent."""

    @staticmethod
    def forward(ctx, emb, *packed):
        if len(packed) != N_MLP_W:
            raise ValueError(f"expected {N_MLP_W} packed weights, got "
                             f"{len(packed)}")
        embb = emb.to(torch.bfloat16)
        ctx.save_for_backward(embb, *packed)
        return mlp_fwd(embb, cast_mlp_weights(packed))

    @staticmethod
    def backward(ctx, draw):
        embb, *packed = ctx.saved_tensors
        demb, grads = mlp_bwd(embb, cast_mlp_weights(packed), draw)
        return (demb, *grads)
