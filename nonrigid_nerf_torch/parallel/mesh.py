"""Data parallelism over the ray axis on a torch.distributed process group
(counterpart of nonrigid_nerf_tpu/parallel/mesh.py:43-217).

The JAX package shards the ray batch over a 1-D `data` mesh with
`shard_map`; here one process per GPU holds the whole model and the whole
dataset, and the process group (`parallel/multihost.py`) takes the mesh's
place. The model is about 4 MB of weights, so the layout is the JAX
package's: replicated parameters, the ray batch split over the ranks.

Training: every rank samples the GLOBAL batch and the GLOBAL random draws
(jitter, density noise, importance samples, divergence probe) from the
step's generator, in the order the single-device step draws them, and takes
its contiguous shard of both. Its gradients are normalized by the global
batch; one all-reduce of them all, flattened into one buffer, gives every
rank the single-device gradient, and the same Adam on every rank keeps the
parameters replicated without a broadcast. A W-rank step is therefore the
single-process step up to the order of the sums (a run stopped on four GPUs
can resume on one), where the JAX step folds the device index into its
render and loss keys. The step does not use DistributedDataParallel: its
two-phase backward is two `torch.autograd.grad` calls over one graph, which
DDP's `.backward()` hooks do not see.

Rendering: the flat rays are padded to a multiple of world x chunk; each
rank renders its contiguous shard block by block, and every rank receives
the whole result. Every rank of the group must call a parallel renderer
with the same model and rays, as it must call the step: the collectives
pair up across ranks in call order.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist

from nonrigid_nerf_torch.config import (EditConfig, ModelConfig,
                                        RenderSettings, TrainConfig)
from nonrigid_nerf_torch.data.dataset import RayDataset, sample_ray_batch
from nonrigid_nerf_torch.device import DeviceLike
from nonrigid_nerf_torch.engine.losses import needs_bending_losses
from nonrigid_nerf_torch.engine.render import make_ray_renderer
from nonrigid_nerf_torch.engine.train_state import TrainState, adam_update
from nonrigid_nerf_torch.engine.train_step import losses_and_grads
from nonrigid_nerf_torch.ops.math import mse2psnr
from nonrigid_nerf_torch.parallel import multihost
from nonrigid_nerf_torch.utils.spans import span

METRIC_PARTS = ("img_loss0", "offsets_loss", "divergence_loss")


def world_and_rank():
    """(world size, rank) of the process group; raises when none is up:
    nothing falls back to one device."""
    if not multihost.is_initialized():
        raise RuntimeError(
            "no process group: launch under torchrun (or set NRNERF_*) and "
            "call parallel.multihost.maybe_initialize() first; "
            "engine/train_step.py and engine/render.py run one device")
    return dist.get_world_size(), dist.get_rank()


def step_draws(cfg: ModelConfig, tc: TrainConfig, rs: RenderSettings,
               n_rays: int, generator: Optional[torch.Generator], dtype,
               device) -> dict:
    """The random numbers a single-device step draws from `generator`
    after its pixels, in its order and at its shapes, as `draws`: the
    stratified jitter, the coarse density noise, the importance samples'
    uniforms, the fine density noise (engine/render.py) and the divergence
    probe (engine/losses.py), each only where the step draws it."""
    S, Ni = rs.N_samples, rs.N_importance

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    draws = {}
    if rs.perturb > 0.0:
        draws["t_rand"] = rand(n_rays, S)
    if rs.raw_noise_std > 0.0:
        draws["noise0"] = randn(n_rays, S)
    if Ni > 0:
        if rs.perturb != 0.0:
            draws["u"] = rand(n_rays, Ni)
        if rs.raw_noise_std > 0.0:
            draws["noise1"] = randn(n_rays, S + Ni)
    if needs_bending_losses(cfg, tc) and tc.divergence_loss_weight > 0.0:
        draws["e"] = randn(n_rays, S, 3)
    return draws


def parallel_train_step_from_batch(
        state: TrainState, gbatch, *, cfg: ModelConfig, tc: TrainConfig,
        rs: RenderSettings, has_test_split: bool,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Mapping[str, torch.Tensor]] = None,
        debug_metrics: bool = False):
    """This rank's part of one data-parallel step on the GLOBAL ray batch
    `gbatch`: its contiguous shard's forward and two-phase backward, one
    all-reduce of the gradients, Adam. `draws` are this rank's (its shard
    of the global draws); without them the global draws come from
    `generator` (`step_draws`) and are sliced here. Updates `state` in
    place; returns the metrics as global masked means, the same on every
    rank."""
    world, rank = world_and_rank()
    n_rand = gbatch["rays_o"].shape[0]
    if n_rand % world:
        raise ValueError(f"N_rand={n_rand} is not divisible by {world} ranks")
    local = n_rand // world
    shard = slice(rank * local, (rank + 1) * local)
    if draws is None:
        draws = step_draws(cfg, tc, rs, n_rand, generator,
                           gbatch["rays_o"].dtype, gbatch["rays_o"].device)
        draws = {k: v[shard] for k, v in draws.items()}
    batch = {k: v[shard] for k, v in gbatch.items()}

    # local gradients normalized by the GLOBAL batch, so that their sum
    # over the ranks is the single-device gradient
    losses, aux, grads = losses_and_grads(
        state.model, state.step, batch, cfg=cfg, tc=tc, rs=rs,
        has_test_split=has_test_split, n_rand=n_rand, generator=generator,
        draws=draws)
    names = list(grads)
    flat = multihost.flatten([grads[n] for n in names])
    dist.all_reduce(flat)          # every gradient in one all-reduce
    grads = dict(zip(names, multihost.unflatten(
        flat, [grads[n] for n in names])))
    adam_update(state, grads, tc)

    # the metrics' numerators and the count ride a second small buffer
    indicator = batch["train_indicator"].to(losses.dtype)
    parts = {"loss": losses, "img_loss": aux["img_loss"]}
    parts.update({k: aux[k] for k in METRIC_PARTS if k in aux})
    sums = torch.stack([indicator.sum()] + [torch.sum(v * indicator)
                                            for v in parts.values()])
    dist.all_reduce(sums)
    means = dict(zip(parts, sums[1:] / torch.clamp(sums[0], min=1.0)))
    metrics = {"loss": means["loss"], "psnr": mse2psnr(means["img_loss"]),
               "img_loss": means["img_loss"]}
    metrics.update({k: means[k] for k in METRIC_PARTS if k in means})
    if debug_metrics:
        metrics["grad_norm"] = torch.sqrt(torch.sum(flat * flat))
    return metrics


def make_parallel_train_step(cfg: ModelConfig, tc: TrainConfig,
                             rs: RenderSettings, has_test_split: bool,
                             n_rand: Optional[int] = None,
                             debug_metrics: bool = False):
    """The data-parallel step over the ranks of the process group:
    fn(state, ds, generator) -> metrics, updating `state` in place. The
    GLOBAL batch is `n_rand` rays (default tc.N_rand), split evenly over
    the ranks; every rank holds the whole `ds` and calls fn with a
    generator in the same state."""
    if cfg.fused_kernel == "int8":
        raise ValueError("fused_kernel='int8' is inference-only (the int8 "
                         "kernel has no backward); train with 'auto', 'on' "
                         "or 'off'")
    n_rand = tc.N_rand if n_rand is None else n_rand
    world, _ = world_and_rank()
    if n_rand % world:
        raise ValueError(f"N_rand={n_rand} is not divisible by {world} ranks")

    def step_fn(state: TrainState, ds: RayDataset,
                generator: Optional[torch.Generator] = None):
        # topology-invariant pixels: every rank samples the GLOBAL batch
        # with the step's generator, as the single-device step does
        with span("step"):
            with span("sample"):
                gbatch = sample_ray_batch(ds, n_rand, generator=generator)
            return parallel_train_step_from_batch(
                state, gbatch, cfg=cfg, tc=tc, rs=rs,
                has_test_split=has_test_split, generator=generator,
                debug_metrics=debug_metrics)

    return step_fn


def gather_rows(out: Mapping[str, torch.Tensor], world: int,
                rank: int) -> dict:
    """Every rank's rows of each output, in rank order, on every rank.

    One all-reduce a dtype of a zeroed (world, rows, C) buffer holding this
    rank's rows in its slot: a sum in which every value meets only zeros
    is exact. `gloo` takes all-reduce on CUDA tensors, where it has no
    all-gather, so the same code serves both backends, and ranks that
    share one GPU."""
    rows = next(iter(out.values())).shape[0]
    gathered = {}
    names_by_dtype = {}
    for k, v in out.items():
        names_by_dtype.setdefault(v.dtype, []).append(k)
    for names in names_by_dtype.values():
        mine = torch.cat([out[k].reshape(rows, -1) for k in names], 1)
        full = mine.new_zeros((world,) + mine.shape)
        full[rank] = mine
        dist.all_reduce(full)
        full = full.reshape(world * rows, -1)
        widths = [out[k][0].numel() for k in names]
        for k, part in zip(names, full.split(widths, 1)):
            gathered[k] = part.reshape((world * rows,) + out[k].shape[1:])
    return gathered


def make_parallel_renderer(cfg: ModelConfig, rs: RenderSettings,
                           edit: EditConfig = EditConfig(),
                           chunk: int = 32768, device: DeviceLike = None,
                           detailed: bool = False, postprocess=None):
    """Inference over the ranks of the process group (reference analog:
    render_wrapper_class, train.py:300-323).

    Returns fn(model, rays_o (N, 3), rays_d, latents (N, L), generator=None)
    -> dict of (N, ...) tensors, on every rank. N is padded with copies of
    the first ray to a multiple of world x chunk; each rank renders its
    contiguous shard through `make_ray_renderer` (`detailed` and
    `postprocess` pass through: postprocess runs on the rank, per block,
    before the gather). A `generator` is used by every rank as it is given.
    Every rank must call fn, with the same arguments."""
    world, rank = world_and_rank()
    block = make_ray_renderer(cfg, rs, edit=edit, chunk=chunk, device=device,
                              detailed=detailed, postprocess=postprocess)

    def render_all(model, rays_o, rays_d, latents,
                   generator: Optional[torch.Generator] = None):
        n = rays_o.shape[0]
        per = max(1, -(-n // (world * chunk))) * chunk
        pad = world * per - n

        def _shard(x):
            if pad:
                x = torch.cat([x, x[:1].expand((pad,) + x.shape[1:])], 0)
            return x[rank * per:(rank + 1) * per]

        out = block(model, _shard(rays_o), _shard(rays_d), _shard(latents),
                    generator)
        return {k: v[:n] for k, v in
                gather_rows(out, world, rank).items()}

    return render_all


def make_auto_renderer(cfg: ModelConfig, rs: RenderSettings,
                       edit: EditConfig = EditConfig(), chunk: int = 32768,
                       device: DeviceLike = None, detailed: bool = False,
                       postprocess=None, n_rays_hint: Optional[int] = None):
    """The parallel renderer when a process group of more than one rank is
    up, else `make_ray_renderer` on one device: the inference analog of the
    reference's optional DataParallel wrap (train.py:320-323). Uniform
    signature: fn(model, rays_o (N, 3), rays_d, latents, generator=None).

    `n_rays_hint` (e.g. H * W) shrinks the chunk to a rank's share of the
    rays, so that padding to world x chunk wastes little work. Under a
    group every rank must call the renderer (make_parallel_renderer)."""
    world = multihost.world_size()
    share = None if not n_rays_hint else -(-int(n_rays_hint) // world)
    if share:
        chunk = max(1, min(chunk, share))
    if world > 1:
        return make_parallel_renderer(cfg, rs, edit=edit, chunk=chunk,
                                      device=device, detailed=detailed,
                                      postprocess=postprocess)
    return make_ray_renderer(cfg, rs, edit=edit, chunk=chunk, device=device,
                             detailed=detailed, postprocess=postprocess)
