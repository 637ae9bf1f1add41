"""Small math helpers (counterpart of nonrigid_nerf_tpu/ops/math.py)."""

from __future__ import annotations

import math

import numpy as np
import torch


def img2mse(pred, target, n_rays: int):
    """Per-ray MSE, shape (n_rays,) (reference: run_nerf_helpers.py:10-13)."""
    se = (pred - target) ** 2
    return se.reshape(n_rays, -1).mean(dim=1)


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255.0 * np.clip(np.asarray(x), 0.0, 1.0)).astype(np.uint8)


def safe_norm(v, dim=-1, keepdim=False, eps=0.0):
    """L2 norm with a zero gradient at v = 0 (the double-where trick: the
    offsets loss takes norms of the zero-initialised bending offsets)."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    is_zero = sq <= eps
    sq_safe = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(sq_safe))


def safe_pow(base, exponent, eps: float = 1e-9):
    """base**exponent with a finite gradient for base >= 0, base = 0
    included. The offsets loss takes ||offset||^(2 - rigidity): the exponent
    is learnable and d/dp x^p = x^p ln(x) diverges at x = 0. Clamping the
    base to eps keeps the exponent's gradient near its true limit 0 there
    and leaves values for base >= eps untouched."""
    return torch.pow(torch.clamp(base, min=eps), exponent)
