"""Train state: the model, Adam's moments and the step
(counterpart of nonrigid_nerf_tpu/engine/train_state.py:22-74).

The latent table is a parameter of the model like any other, so one Adam
covers the three networks and the latent codes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from nonrigid_nerf_torch.config import ModelConfig, TrainConfig
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.utils.spans import spanned

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def lr_schedule(tc: TrainConfig, count: int) -> float:
    """Learning rate of optimizer step `count` (0-based): exponential decay
    with the reference's warm-up divisor and the reference's step alignment
    (reference: train.py:1631-1643). There the rate is recomputed AFTER
    optimizer.step() from the pre-increment global step, so step k runs at
    the value computed for k - 1, and step 0 runs at the raw `lrate`,
    outside the warm-up divisor. With g = k - 1:
    lrate * 0.1^(g / decay), divided by 20 * (warmup - g) / warmup + 1
    while g < warmup."""
    if count < 1:
        return float(tc.lrate)
    g = float(count - 1)
    lr = tc.lrate * math.pow(0.1, g / float(tc.lrate_decay))
    warm = float(tc.warmup_steps)
    if g < warm:
        lr = lr / (20.0 * (warm - g) / warm + 1.0)
    return lr


@dataclasses.dataclass
class TrainState:
    """The model, Adam's first and second moments by parameter name, and
    the number of steps taken (optax's `count`, the checkpoint's `step`)."""

    model: NRNeRF
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: int = 0


def zero_moments(model: NRNeRF) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros_like(p) for name, p in model.named_parameters()}


def create_train_state(cfg: ModelConfig, tc: TrainConfig, num_timesteps: int,
                       device: DeviceLike = None,
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """A fresh model on `device` (cuda unless asked otherwise), initialised
    from `generator` (seeded with tc.seed when none is given), with zero
    moments at step 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(tc.seed)
    model = NRNeRF(cfg, num_timesteps, generator=generator, device="cpu")
    model = model.to(device)
    return TrainState(model=model, mu=zero_moments(model),
                      nu=zero_moments(model), step=0)


@torch.no_grad()
@spanned("adam")
def adam_update(state: TrainState, grads: Dict[str, torch.Tensor],
                tc: TrainConfig) -> None:
    """One Adam step in place, in optax's form: the moments are updated,
    bias-corrected with count + 1, and the parameter moves by
    -lr(count) * m_hat / (sqrt(v_hat) + eps), the rate read at `count`
    BEFORE the increment. Then the step is incremented."""
    lr = lr_schedule(tc, state.step)
    count = state.step + 1
    c1 = 1.0 - ADAM_B1 ** count
    c2 = 1.0 - ADAM_B2 ** count
    for name, p in state.model.named_parameters():
        g = grads[name]
        mu, nu = state.mu[name], state.nu[name]
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        p.add_(-lr * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS))
    state.step = count
