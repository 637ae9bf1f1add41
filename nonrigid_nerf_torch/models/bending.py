"""Ray-bending deformation field + rigidity network
(counterpart of nonrigid_nerf_tpu/models/bending.py:31-125).

- bending MLP: input [xyz (3), latent (L)], `bending_depth` layers of width
  `bending_width`, ReLU (or the reference's dormant SIREN sin), output 3
  offsets from a zero-initialised layer without bias, so a fresh model
  starts from straight rays;
- rigidity MLP: input xyz, `rigidity_depth` layers of width
  `rigidity_width`, output 1 from a zero-initialised layer with bias;
  mask = (tanh(h) + 1) / 2, so it starts at 0.5 everywhere;
- bent point = xyz + mask * offsets;
- in a compute dtype (bf16) every layer runs `dense_apply` in it, the ReLU
  and the rigidity's tanh on its activations; the offsets and the mask come
  back in the points' dtype, so the bent point is f32 (JAX:
  models/bending.py:66-92);
- test-time edits: the rigidity cutoff zeroes the mask at or below it, and
  the scaling multiplies the masked offsets.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nonrigid_nerf_torch.config import ModelConfig
from nonrigid_nerf_torch.models.mlp import dense, dense_apply


class BendingNetwork(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.activation = cfg.bending_activation
        siren = self.activation == "sin"
        layers = []
        in_dim = 3 + cfg.ray_bending_latent_size
        for i in range(cfg.bending_depth - 1):
            init = ("siren_first" if i == 0 else "siren") if siren \
                else "kaiming_relu"
            layers.append(dense(in_dim, cfg.bending_width, init=init,
                                generator=generator, device=device))
            in_dim = cfg.bending_width
        layers.append(dense(in_dim, 3, init="zeros", bias=False,
                            device=device))
        self.bend = nn.ModuleList(layers)

        self.rigidity = None
        if cfg.use_rigidity_network:
            rlayers = []
            in_dim = 3
            for _ in range(cfg.rigidity_depth - 1):
                rlayers.append(dense(in_dim, cfg.rigidity_width,
                                     init="kaiming_relu", generator=generator,
                                     device=device))
                in_dim = cfg.rigidity_width
            rlayers.append(dense(in_dim, 1, init="zeros", device=device))
            self.rigidity = nn.ModuleList(rlayers)

    @staticmethod
    def _chain(layers, h, activation="relu", compute_dtype=torch.float32):
        for i, layer in enumerate(layers[:-1]):
            h = dense_apply(layer, h, compute_dtype)
            if activation == "sin":
                # SIREN: the first pre-activation is scaled by 30
                # (reference: run_nerf_helpers.py:528-530)
                h = torch.sin(h * 30.0 if i == 0 else h)
            else:
                h = torch.relu(h)
        return dense_apply(layers[-1], h, compute_dtype)

    def unmasked_offsets(self, pts, latents, compute_dtype=torch.float32):
        return self._chain(self.bend, torch.cat([pts, latents], dim=-1),
                           self.activation, compute_dtype).to(pts.dtype)

    def rigidity_mask(self, pts, compute_dtype=torch.float32):
        h = self._chain(self.rigidity, pts, compute_dtype=compute_dtype)
        return ((torch.tanh(h) + 1.0) * 0.5).to(pts.dtype)

    def forward(self, pts, latents,
                rigidity_test_time_cutoff: Optional[float] = None,
                test_time_scaling: Optional[float] = None,
                compute_dtype: torch.dtype = torch.float32):
        """Bend points (..., 3) with per-point latents (..., L), the layers
        in `compute_dtype`.

        Returns (bent_pts, details) with details holding unmasked_offsets,
        and with the rigidity network also rigidity_mask (..., 1) and
        masked_offsets."""
        unmasked = self.unmasked_offsets(pts, latents, compute_dtype)
        details = {"unmasked_offsets": unmasked}
        if self.rigidity is not None:
            mask = self.rigidity_mask(pts, compute_dtype)
            if rigidity_test_time_cutoff is not None:
                mask = torch.where(mask <= rigidity_test_time_cutoff,
                                   torch.zeros_like(mask), mask)
            offsets = mask * unmasked
            details["rigidity_mask"] = mask
            if test_time_scaling is not None:
                offsets = offsets * test_time_scaling
            details["masked_offsets"] = offsets
        else:
            offsets = unmasked
            if test_time_scaling is not None:
                offsets = offsets * test_time_scaling
        return pts + offsets, details
