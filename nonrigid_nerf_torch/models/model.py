"""The full NR-NeRF parameter set as one module: coarse and fine canonical
MLPs, the bender and the per-timestep latent table. Counterpart of the JAX
parameter tree {"coarse", "fine", "bender", "latents"} built by
nonrigid_nerf_tpu/engine/train_state.py:init_params. The optional "quant"
leaf of that tree (the int8 calibration state of `fused_kernel="int8"`) is the
model's `quant`: non-trainable buffers that `.to(device)` moves and that no
optimizer sees.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from nonrigid_nerf_torch.config import ModelConfig
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.models.bending import BendingNetwork
from nonrigid_nerf_torch.models.nerf import NeRF


class QuantState(nn.Module):
    """The int8 calibration state of one canonical MLP, as buffers: `scales`
    (9,) f32, the activation maxima [s_emb, s1..s8], and `packed`, the int8
    kernel's 29 weights (int8 matrices, f32 dequantization rows and folded
    biases, the bf16 head, the quantization multipliers) in the order of
    `ops/kernels/quant_mlp.py:pack_int8_mlp_weights`. Counterpart of
    params["quant"][network] = {"scales", "packed"} of the JAX package. An
    entry read from a file that holds the scales alone has `packed = None`."""

    def __init__(self, scales: torch.Tensor,
                 packed: Optional[Sequence[torch.Tensor]] = None):
        super().__init__()
        self.register_buffer("scales", scales.detach().clone())
        self.n_packed = 0 if packed is None else len(packed)
        for i, t in enumerate(packed or ()):
            self.register_buffer(f"p{i}", t.detach().clone())

    @property
    def packed(self) -> Optional[Tuple[torch.Tensor, ...]]:
        if not self.n_packed:
            return None
        return tuple(getattr(self, f"p{i}") for i in range(self.n_packed))


class NRNeRF(nn.Module):
    """`fine` is None without importance sampling and `bender` is None
    without ray bending; `latents` (T, L) starts at zero
    (reference: train.py:1447-1453). `quant` is None until
    `ops/kernels/quant_mlp.py:quantize_for_inference` calibrates the model:
    then a ModuleDict of one `QuantState` per network."""

    def __init__(self, cfg: ModelConfig, num_timesteps: int,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.coarse = NeRF(cfg, generator=generator, device=device)
        self.fine = (NeRF(cfg, cfg.netdepth_fine, cfg.netwidth_fine,
                          generator=generator, device=device)
                     if cfg.N_importance > 0 else None)
        self.bender = (BendingNetwork(cfg, generator=generator, device=device)
                       if cfg.use_ray_bending else None)
        self.latents = nn.Parameter(torch.zeros(
            num_timesteps, cfg.ray_bending_latent_size, device=device))
        self.quant: Optional[nn.ModuleDict] = None

    def network(self, name: str) -> NeRF:
        """"coarse" or "fine" (the coarse net when there is no fine one)."""
        if name == "fine" and self.fine is not None:
            return self.fine
        return self.coarse

    def with_quant(self, quant: Mapping[str, QuantState]) -> "NRNeRF":
        """A model that shares this one's parameters and holds `quant` (by
        network name); this one stays without it."""
        out = copy.copy(self)
        out._modules = dict(self._modules)      # the same children, another table
        out.quant = nn.ModuleDict(dict(quant))
        return out
