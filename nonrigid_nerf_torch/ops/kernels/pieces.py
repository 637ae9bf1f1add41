"""Backward passes of any size, in pieces of at most one launch.

Each backward kernel takes at most `MAX_POINTS_PER_LAUNCH` points a call:
its bf16 scratch holds every point's recomputed activations (2.0-2.4 GiB at
2^18 points). The JAX kernels run a grid over the points and have no such
cap (nonrigid_nerf_tpu/ops/pallas/fused_query.py:842). The autograd
functions `MLPCore`, `MLPVCore`, `MLPECore`, `BendCore` and `FusedCore`
therefore run their backward through `backward_in_pieces`: the points in
consecutive pieces of at most `PIECE_POINTS`, one after another, so that one
piece's scratch is alive at a time. The per-point cotangents are the pieces'
rows in order; each weight gradient is piece 0's, plus piece 1's, plus ...,
summed in f32 in that fixed order, without atomics, so that the result is
bit-equal from run to run.

The split sits above the wrappers, so on the CPU it runs the plain versions
in the same pieces; a test lowers `PIECE_POINTS` to hold the pieces against
one piece.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

# the largest piece: every backward kernel's MAX_POINTS_PER_LAUNCH
PIECE_POINTS = 1 << 18


def backward_in_pieces(bwd: Callable, *per_point: torch.Tensor):
    """bwd(*rows) -> (*per-point outputs, list of weight gradients), run on
    consecutive pieces of the per-point tensors' rows (all of the same
    length n) and joined: (*per-point outputs of all n rows, the gradients
    summed over the pieces in order)."""
    n = per_point[0].shape[0]
    piece = PIECE_POINTS
    if n <= piece:
        return bwd(*per_point)
    outs: List[torch.Tensor] = []
    grads: Sequence[torch.Tensor] = []
    for start in range(0, n, piece):
        *rows, piece_grads = bwd(*(t[start:start + piece] for t in per_point))
        if start == 0:
            outs = [torch.empty((n,) + r.shape[1:], dtype=r.dtype,
                                device=r.device) for r in rows]
            grads = [g.float() for g in piece_grads]
        else:
            for acc, g in zip(grads, piece_grads):
                acc.add_(g)
        for out, r in zip(outs, rows):
            out[start:start + r.shape[0]] = r
    return (*outs, list(grads))
