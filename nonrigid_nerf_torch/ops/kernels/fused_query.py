"""The fused point-query entry points: the deformation field and the
canonical MLP of the flagship model on points and latents, differentiable.

Counterpart of `fused_point_query`, `fused_point_query_split` and
`pack_fused_weights` (nonrigid_nerf_tpu/ops/pallas/fused_query.py:156-183,
1244-1289). Like those, they serve benchmarks and direct callers: the
engine's render and training paths do not call them.

- `fused_point_query(model, pts, latents)` runs the monolith, `FusedCore`
  (`fused_fwd` / `fused_bwd`): one kernel per call, one per backward.
- `fused_point_query_split(...)` runs `BendCore` (`bend_fwd` / `bend_bwd`),
  then `MLPCore` (`mlp_fwd` / `mlp_bwd`) on the f32 encoding between them.

Both return raw (..., 4), the unmasked offsets (..., 3) and the rigidity
(..., 1), f32, for pts (..., 3) and latents (..., 32), and are
differentiable with respect to the model's parameters, the points and the
latents; the two agree bit for bit in value and gradient. They run where
their tensors are: CUDA tensors launch the kernels (or raise), CPU tensors
run the kernels' plain versions. The model must be the flagship
architecture the kernels hard-code (`check_fused_query_supported`), else
ValueError. `block` is kept for the JAX signature: the kernels tile the
points by 128 whatever it is, and the results do not depend on it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels.bend_bwd import BendCore
from nonrigid_nerf_torch.ops.kernels.bend_fwd import (
    LAT, N_BEND_W, check_bender_supported, pack_bend_weights)
from nonrigid_nerf_torch.ops.kernels.fused_bwd import FusedCore
from nonrigid_nerf_torch.ops.kernels.mlp_bwd import MLPCore
from nonrigid_nerf_torch.ops.kernels.mlpe_fwd import MULTIRES, PTS

DEFAULT_BLOCK = 1024
N_LAYERS = 8
SKIP = 4


def check_fused_query_supported(model, multires: int = MULTIRES,
                                network: str = "coarse") -> None:
    """Raise ValueError unless the kernels compute this model: multires 10,
    the flagship bender (`check_bender_supported`) and a canonical 8 x 256
    MLP on the 63-channel encoding with the skip at layer 4 and the single
    raw head."""
    if multires != MULTIRES:
        raise ValueError(f"the fused point query computes multires={MULTIRES}, "
                         f"not {multires}")
    check_bender_supported(model.bender, model.latents.shape[1])
    net = model.network(network)
    in_ch = 3 + 6 * MULTIRES
    dims = [(layer.in_features, layer.out_features) for layer in net.pts]
    want = [(in_ch, K.NW)] + [(K.NW + in_ch if i == SKIP + 1 else K.NW, K.NW)
                              for i in range(1, N_LAYERS)]
    if (net.use_viewdirs or dims != want or tuple(net.skips) != (SKIP,)
            or net.output.out_features < 4):
        raise ValueError("the fused point query needs the canonical 8 x 256 "
                         f"MLP with the skip at {SKIP}, no view directions and "
                         f"a raw head; '{network}' has {dims}")


def pack_fused_weights(model, multires: int = MULTIRES,
                       network: str = "coarse") -> Tuple[torch.Tensor, ...]:
    """The 37 padded f32 tensors of the JAX `pack_fused_weights(params,
    multires, network)`: the bender's 18 (`pack_bend_weights`), then the
    canonical MLP's 19 (`mlp_fwd.pack_mlp_weights`). Differentiable."""
    check_fused_query_supported(model, multires, network)
    return (pack_bend_weights(model.bender)
            + K.pack_mlp_weights(model.network(network)))


def _flatten(pts, latents):
    shape = tuple(pts.shape[:-1])
    if pts.shape[-1] != PTS or tuple(latents.shape) != shape + (LAT,):
        raise ValueError(f"pts must be (..., {PTS}) and latents (..., {LAT}) "
                         f"with the same leading shape, got "
                         f"{tuple(pts.shape)} and {tuple(latents.shape)}")
    n = math.prod(shape)
    return shape, pts.reshape(n, PTS), latents.reshape(n, LAT)


def _unflatten(shape, raw, off, rig):
    return (raw[:, :4].reshape(shape + (4,)), off.reshape(shape + (PTS,)),
            rig.reshape(shape + (1,)))


def fused_point_query(model, pts: torch.Tensor, latents: torch.Tensor,
                      multires: int = MULTIRES, network: str = "coarse",
                      block: int = DEFAULT_BLOCK):
    """(raw (..., 4), unmasked offsets (..., 3), rigidity (..., 1)) of the
    fused chain at pts (..., 3) with latents (..., 32): one `fused_fwd`
    launch, and one `fused_bwd` launch per backward. `block` does not change
    the result (the kernels tile by 128)."""
    weights = pack_fused_weights(model, multires, network)
    shape, pts2, lat2 = _flatten(pts, latents)
    return _unflatten(shape, *FusedCore.apply(pts2, lat2, *weights))


def fused_point_query_split(model, pts: torch.Tensor, latents: torch.Tensor,
                            multires: int = MULTIRES, network: str = "coarse",
                            block: int = DEFAULT_BLOCK):
    """The two-kernel version of `fused_point_query` (same arguments and
    results, bit for bit): `bend_fwd` then `mlp_fwd`, and per backward
    `mlp_bwd` then `bend_bwd`."""
    weights = pack_fused_weights(model, multires, network)
    shape, pts2, lat2 = _flatten(pts, latents)
    emb, off, rig = BendCore.apply(pts2, lat2, *weights[:N_BEND_W])
    raw = MLPCore.apply(emb, *weights[N_BEND_W:])
    return _unflatten(shape, raw, off, rig)
