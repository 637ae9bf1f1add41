"""Canonical NeRF MLP (counterpart of nonrigid_nerf_tpu/models/nerf.py:24-91).

D hidden ReLU layers of width W; after layer i in `skips` the encoded input
is concatenated in front of the activation, [mlp_input, h]
(reference: run_nerf_helpers.py:295-302). Without view directions a single
output head gives `output_ch` channels (5 with importance sampling, of which
4 are used). With them (reference: run_nerf_helpers.py:283-304) a density
head `alpha` (W -> 1), a `feature` head (W -> W, no activation), one
view-conditioned ReLU layer `views[0]` (W + view_ch -> W / 2) and an `rgb`
head (W / 2 -> 3). The time-conditioned input comes with a later slice of
the port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nonrigid_nerf_torch.config import ModelConfig
from nonrigid_nerf_torch.models.mlp import dense


def check_nerf_supported(cfg: ModelConfig) -> None:
    """Raise on the canonical-MLP variants that are not ported yet."""
    if cfg.time_conditioned_baseline:
        raise NotImplementedError("time_conditioned_baseline is not ported yet")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r} is not ported yet")


class NeRF(nn.Module):
    def __init__(self, cfg: ModelConfig, depth: Optional[int] = None,
                 width: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        check_nerf_supported(cfg)
        D = cfg.netdepth if depth is None else depth
        W = cfg.netwidth if width is None else width
        input_ch = cfg.input_ch
        self.skips = tuple(cfg.skips)
        layers = [dense(input_ch, W, generator=generator, device=device)]
        for i in range(D - 1):
            in_dim = W + input_ch if i in self.skips else W
            layers.append(dense(in_dim, W, generator=generator, device=device))
        self.pts = nn.ModuleList(layers)
        self.use_viewdirs = cfg.use_viewdirs
        if cfg.use_viewdirs:
            # a list of one layer, so that names map to the JAX tree's
            # params[net]["views"][0]
            self.feature = dense(W, W, generator=generator, device=device)
            self.alpha = dense(W, 1, generator=generator, device=device)
            self.views = nn.ModuleList([dense(cfg.input_ch_views + W, W // 2,
                                              generator=generator,
                                              device=device)])
            self.rgb = dense(W // 2, 3, generator=generator, device=device)
        else:
            self.output = dense(W, cfg.output_ch, generator=generator,
                                device=device)

    def forward(self, embedded_pts: torch.Tensor,
                embedded_views: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(..., input_ch) encoded (bent) points, and with view directions
        (..., input_ch_views) encoded directions -> raw (..., 4) f32: rgb
        logits and density."""
        h = embedded_pts
        for i, layer in enumerate(self.pts):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([embedded_pts, h], dim=-1)
        if not self.use_viewdirs:
            return self.output(h)[..., :4]
        if embedded_views is None:
            raise ValueError("a view-direction NeRF needs embedded_views")
        alpha = self.alpha(h)
        hv = torch.cat([self.feature(h), embedded_views], dim=-1)
        for layer in self.views:
            hv = torch.relu(layer(hv))
        return torch.cat([self.rgb(hv), alpha], dim=-1)
