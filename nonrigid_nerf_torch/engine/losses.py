"""NR-NeRF training losses
(counterpart of nonrigid_nerf_tpu/engine/losses.py:33-130).

- reconstruction: per-ray MSE of the fine and the coarse rgb;
- offsets loss: per-ray mean over the coarse samples of
  w * ||unmasked_offsets||^(2 - rigidity), w the detached coarse visibility
  weights, plus rigidity_loss_weight * mean(w * rigidity);
- divergence loss: a Hutchinson estimate of div(offsets) at the detached
  coarse sample points, squared, weighted by the detached
  1 - exp(-relu(coarse alpha));
- both regularizers are scaled by the increasing schedule
  weight * (1/100)^(1 - step / N_iters).

The divergence estimate e^T J e is a forward-mode jvp of the bender at
detached points (`torch.func.jvp` over `torch.func.functional_call`), built
inside the autograd graph, so the outer backward differentiates through it
into the bender's parameters and the latents. It never runs through the
canonical MLP or its kernels. (The exact view directions are a second jvp
of the same kind, in `engine/query.py:sample_viewdirs`.)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call, jvp

from nonrigid_nerf_torch.config import ModelConfig, TrainConfig
from nonrigid_nerf_torch.models.mlp import compute_dtype_of
from nonrigid_nerf_torch.ops.math import img2mse, safe_norm, safe_pow


def loss_schedule_factor(step, n_iters: int, dtype=torch.float32,
                         device=None):
    """Increasing schedule (1/100)^(1 - step / N_iters)
    (reference: train.py:237-242)."""
    frac = torch.as_tensor(step, dtype=dtype, device=device) / float(n_iters)
    return torch.pow(torch.as_tensor(0.01, dtype=dtype, device=device),
                     1.0 - frac)


def offsets_and_rigidity_loss(render_out, rigidity_loss_weight: float):
    """Per-ray offsets + rigidity regularizer (reference: train.py:219-236).

    Without a rigidity network the loss is the weighted L1 of the offsets
    and the rigidity term vanishes."""
    offsets = render_out["unmasked_offsets"]                 # (R, S, 3)
    weights = render_out["visibility_weights"].detach()      # (R, S) coarse
    norm = safe_norm(offsets, dim=-1)
    if "rigidity_mask" not in render_out:
        return torch.mean(weights * norm, dim=-1)            # (R,)
    rigidity = render_out["rigidity_mask"][..., 0]           # (R, S)
    loss = torch.mean(weights * safe_pow(norm, 2.0 - rigidity), dim=-1)
    return loss + rigidity_loss_weight * torch.mean(weights * rigidity, dim=-1)


def divergence_loss(model, cfg: ModelConfig, render_out, latents,
                    exact: bool = False, e: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Per-ray divergence regularizer (reference: train.py:244-280,
    run_nerf_helpers.py:22-116).

    The offsets field is linearized at the DETACHED coarse sample points, so
    gradients reach the bender's parameters and the latents only. The
    Hutchinson probe is `e` (R, S, 3), standard normal, or a draw from
    `generator`; `exact` takes the trace of the Jacobian from 3 basis
    probes instead."""
    pts = render_out["initial_input_pts"].detach()           # (R, S, 3)
    R, S = pts.shape[:-1]
    latents_per_pt = latents[:, None, :].expand(R, S, latents.shape[-1])
    bender = model.bender
    params = dict(bender.named_parameters())

    kwargs = {"compute_dtype": compute_dtype_of(cfg.compute_dtype)}

    def offsets_at(p):
        _, details = functional_call(bender, params, (p, latents_per_pt),
                                     kwargs)
        return details.get("masked_offsets", details["unmasked_offsets"])

    if exact:
        div = torch.zeros(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
        for i in range(3):
            basis = torch.zeros_like(pts)
            basis[..., i] = 1.0
            _, je = jvp(offsets_at, (pts,), (basis,))
            div = div + je[..., i]
    else:
        if e is None:
            e = torch.randn(pts.shape, generator=generator, dtype=pts.dtype,
                            device=pts.device)
        _, je = jvp(offsets_at, (pts,), (e,))
        div = torch.sum(je * e, dim=-1)                      # e^T J e (R, S)

    # weights: 1 - exp(-relu(coarse alpha)), detached: alpha goes through
    # the alpha formula a second time, as in the reference (train.py:262-267)
    alpha = render_out["opacity_alpha"].detach()
    weights = 1.0 - torch.exp(-torch.relu(alpha))
    return torch.mean(weights * torch.square(torch.abs(div)), dim=-1)   # (R,)


def per_ray_losses(model, cfg: ModelConfig, tc: TrainConfig, render_out,
                   target_rgb, latents, step,
                   e: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Total per-ray training loss (R,) and a dict of its unweighted
    components (reference: training_wrapper_class.forward,
    train.py:152-286). `e` / `generator` feed the divergence probe."""
    R = target_rgb.shape[0]
    img_loss = img2mse(render_out["rgb_map"], target_rgb, R)
    loss = img_loss
    aux = {"img_loss": img_loss}

    if "rgb0" in render_out:
        img_loss0 = img2mse(render_out["rgb0"], target_rgb, R)
        loss = loss + img_loss0
        aux["img_loss0"] = img_loss0

    if needs_bending_losses(cfg, tc):
        sched = loss_schedule_factor(step, tc.N_iters, img_loss.dtype,
                                     img_loss.device)
        if tc.offsets_loss_weight > 0.0:
            off = offsets_and_rigidity_loss(render_out, tc.rigidity_loss_weight)
            loss = loss + tc.offsets_loss_weight * sched * off
            aux["offsets_loss"] = off
        if tc.divergence_loss_weight > 0.0:
            div = divergence_loss(model, cfg, render_out, latents, e=e,
                                  generator=generator)
            loss = loss + tc.divergence_loss_weight * sched * div
            aux["divergence_loss"] = div
    return loss, aux


def needs_bending_losses(cfg: ModelConfig, tc: TrainConfig) -> bool:
    """Whether the step needs the coarse pass's per-sample internals."""
    return cfg.use_ray_bending and (tc.offsets_loss_weight > 0.0
                                    or tc.divergence_loss_weight > 0.0)
