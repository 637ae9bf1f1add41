"""The NR-NeRF training step
(counterpart of nonrigid_nerf_tpu/engine/train_step.py:33-189).

One step: pixel sampling on the device -> ray generation -> latent lookup ->
coarse + fine rendering -> per-ray losses -> two-phase gradients -> Adam.

Two-phase gradients (reference: train.py:1594-1608): rays of test images
move ONLY the per-timestep latent codes, rays of training images move
everything. Both phases share one forward pass: `torch.autograd.grad` runs
over the one graph with two cotangent vectors (the first call retains the
graph). With `fused_kernel` on, the backward of each canonical MLP is the
CUDA kernel `mlp_bwd` (with view directions `mlpv_bwd`, whose gradient of
the view encoding flows on into the bender and the latents; with
`fused_kernel="pts"` `mlpe_bwd`, whose gradient of the bent points does),
launched once per network and cotangent.

The random numbers of step k come from `step_generator(seed, k)`: first the
pixels, then the jitter, noise, importance draws and divergence probe. The
presampled step (`make_prefetch_train_step`) draws the pixels of many steps
in one pass over the image stack and hands each step its generator as the
pixel draw left it, so that it trains bit-equal to the plain step.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from nonrigid_nerf_torch.config import ModelConfig, RenderSettings, TrainConfig
from nonrigid_nerf_torch.data.dataset import (RayDataset, draw_pixels,
                                              sample_ray_batch)
from nonrigid_nerf_torch.engine.losses import (needs_bending_losses,
                                               per_ray_losses)
from nonrigid_nerf_torch.engine.render import render_rays
from nonrigid_nerf_torch.engine.train_state import TrainState, adam_update
from nonrigid_nerf_torch.ops.math import mse2psnr
from nonrigid_nerf_torch.utils.spans import span


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws (pixels, jitter, noise, probe): a
    function of (seed, step) only."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


def losses_and_grads(model, step: int, batch, *, cfg: ModelConfig,
                     tc: TrainConfig, rs: RenderSettings,
                     has_test_split: bool, n_rand: int,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Mapping[str, torch.Tensor]] = None):
    """One forward and the two-phase backward on a sampled ray batch:
    (per-ray losses (R,), aux dict of per-ray components, gradients by
    parameter name). Random numbers come from `generator`, or from `draws`:
    the renderer's `t_rand`, `noise0`, `u`, `noise1` and the divergence
    probe `e`."""
    draws = dict(draws or {})
    e = draws.pop("e", None)
    names = [name for name, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    with torch.enable_grad():
        latents = model.latents[batch["timestep_ids"]]
        # the losses read only COARSE-pass internals (reference
        # train.py:219-286): the fine pass carries no detail channels
        out = render_rays(model, cfg, rs, batch["rays_o"], batch["rays_d"],
                          latents, generator=generator,
                          detailed=needs_bending_losses(cfg, tc),
                          fine_detailed=False, draws=draws)
        with span("losses"):
            losses, aux = per_ray_losses(model, cfg, tc, out,
                                         batch["target_rgb"], latents, step,
                                         e=e, generator=generator)

    # phase 1 (always): training rays -> gradients for everything; the mean
    # runs over the FULL batch with the indicator as a mask, as the
    # reference's mean(indicator * losses) (train.py:1604-1607)
    inv_n = 1.0 / float(n_rand)
    with span("backward"):
        grads = torch.autograd.grad(
            losses, params,
            grad_outputs=batch["train_indicator"].to(losses.dtype) * inv_n,
            retain_graph=has_test_split, allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else g
             for name, p, g in zip(names, params, grads)}
    if has_test_split:
        # phase 2: test rays -> latent-table gradients only
        with span("backward"):
            test_grad, = torch.autograd.grad(
                losses, [model.latents],
                grad_outputs=batch["test_indicator"].to(losses.dtype) * inv_n,
                allow_unused=True)
        if test_grad is not None:
            grads["latents"] = grads["latents"] + test_grad
    aux = {k: v.detach() for k, v in aux.items()}
    return losses.detach(), aux, grads


def train_step_from_batch(state: TrainState, batch, *, cfg: ModelConfig,
                          tc: TrainConfig, rs: RenderSettings,
                          has_test_split: bool, n_rand: int,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Mapping[str, torch.Tensor]] = None,
                          debug_metrics: bool = False):
    """The step body on a sampled ray batch: gradients, then Adam. Updates
    `state` in place and returns the metrics (0-d tensors on the device)."""
    losses, aux, grads = losses_and_grads(
        state.model, state.step, batch, cfg=cfg, tc=tc, rs=rs,
        has_test_split=has_test_split, n_rand=n_rand, generator=generator,
        draws=draws)
    adam_update(state, grads, tc)

    indicator = batch["train_indicator"].to(losses.dtype)
    train_count = torch.clamp(indicator.sum(), min=1.0)

    def masked_mean(v):
        return torch.sum(v * indicator) / train_count

    metrics = {"loss": masked_mean(losses),
               "psnr": mse2psnr(masked_mean(aux["img_loss"]))}
    for name in ("img_loss", "img_loss0", "offsets_loss", "divergence_loss"):
        if name in aux:
            metrics[name] = masked_mean(aux[name])
    if debug_metrics:
        # the per-step global gradient norm (reference: train.py:1617-1629)
        metrics["grad_norm"] = torch.sqrt(sum(
            torch.sum(g * g) for g in grads.values()))
    return metrics


def train_step(state: TrainState, ds: RayDataset, *, cfg: ModelConfig,
               tc: TrainConfig, rs: RenderSettings, has_test_split: bool,
               n_rand: int, generator: Optional[torch.Generator] = None,
               debug_metrics: bool = False):
    """One optimization step on a fresh random batch of `ds`."""
    with span("step"):
        with span("sample"):
            batch = sample_ray_batch(ds, n_rand, generator=generator)
        return train_step_from_batch(
            state, batch, cfg=cfg, tc=tc, rs=rs,
            has_test_split=has_test_split, n_rand=n_rand,
            generator=generator, debug_metrics=debug_metrics)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, rs: RenderSettings,
                    has_test_split: bool, n_rand: Optional[int] = None,
                    debug_metrics: bool = False):
    """fn(state, ds, generator) -> metrics, updating `state` in place."""
    if cfg.fused_kernel == "int8":
        raise ValueError("fused_kernel='int8' is inference-only (the int8 "
                         "kernel has no backward); train with 'auto', 'on' "
                         "or 'off'")
    n_rand = tc.N_rand if n_rand is None else n_rand

    def step_fn(state: TrainState, ds: RayDataset,
                generator: Optional[torch.Generator] = None):
        return train_step(state, ds, cfg=cfg, tc=tc, rs=rs,
                          has_test_split=has_test_split, n_rand=n_rand,
                          generator=generator, debug_metrics=debug_metrics)

    return step_fn


def make_prefetch_train_step(cfg: ModelConfig, tc: TrainConfig,
                             rs: RenderSettings, has_test_split: bool,
                             n_prefetch: int, n_rand: Optional[int] = None,
                             debug_metrics: bool = False):
    """The presampled-training pair (presample_fn, step_fn)
    (counterpart of make_prefetch_train_step, JAX engine/train_step.py:
    137-189):

      presample_fn(ds, seed, step0) -> batches   # the one pass over the stack
      step_fn(state, batches, i) -> metrics      # step step0 + i

    `presample_fn` draws the pixels of steps step0 .. step0 + n_prefetch - 1,
    each from its `step_generator(seed, step)` as the plain step does first,
    then gathers all of them from the image stack and makes their rays in
    one pass. `batches` holds the rays and each step's generator in the
    state its pixel draw left it; `step_fn` renders and steps on ray batch i
    with that generator. So the presampled steps draw the same pixels and
    the same further numbers as plain steps, and train bit-equal to them;
    the batches depend on (seed, step) only, so a resume is exact too."""
    if cfg.fused_kernel == "int8":
        raise ValueError("fused_kernel='int8' is inference-only (the int8 "
                         "kernel has no backward); train with 'auto', 'on' "
                         "or 'off'")
    if n_prefetch < 1:
        raise ValueError(f"n_prefetch must be at least 1, got {n_prefetch}")
    nr = tc.N_rand if n_rand is None else n_rand

    def presample_fn(ds: RayDataset, seed: int, step0: int):
        device = ds.images.device
        generators = [step_generator(seed, step0 + j, device)
                      for j in range(n_prefetch)]
        drawn = [draw_pixels(ds, nr, g) for g in generators]
        image_ids, x, y = (torch.cat(parts) for parts in zip(*drawn))
        rays = sample_ray_batch(ds, n_prefetch * nr, image_ids=image_ids,
                                x=x, y=y)
        return {"rays": rays, "generators": generators, "step0": int(step0)}

    def step_fn(state: TrainState, batches, i: int):
        with span("step"):
            batch = {k: v[i * nr:(i + 1) * nr]
                     for k, v in batches["rays"].items()}
            return train_step_from_batch(
                state, batch, cfg=cfg, tc=tc, rs=rs,
                has_test_split=has_test_split, n_rand=nr,
                generator=batches["generators"][i],
                debug_metrics=debug_metrics)

    return presample_fn, step_fn
