"""The weights of a view-direction configuration (`"use_viewdirs": true`),
under the program's state_dict names: `inputs.py`'s tensors with each
canonical MLP's output layer `{net}.output` replaced by its four heads,
`{net}.feature` (W -> W), `{net}.alpha` (W -> 1), `{net}.views.0`
(W + view channels -> W / 2) and `{net}.rgb` (W / 2 -> 3), in the order the
program's `NeRF` registers them. The laws are `inputs.py`'s: the heads take
the canonical layers' uniform law, and the density bias raise goes on
`alpha`'s bias, which holds the density; the draws are `inputs.py`'s one
uniform and one normal draw on the device from the same sub-seed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import inputs


def _heads(model: dict, net: str):
    w = model["netwidth"]
    views = 3 + 6 * model["multires_views"]
    return [(f"{net}.feature", w, w), (f"{net}.alpha", w, 1),
            (f"{net}.views.0", w + views, w // 2), (f"{net}.rgb", w // 2, 3)]


def weight_shapes(model: dict, num_timesteps: int) -> Dict[str, tuple]:
    """name -> (shape, law, scale), as `inputs.weight_shapes`; "density" is
    `alpha`'s bias (one entry), uniform, with `scale` added."""
    out = {}
    for name, entry in inputs.weight_shapes(model, num_timesteps).items():
        net, _, rest = name.partition(".")
        if rest == "output.weight":
            for head, fan_in, fan_out in _heads(model, net):
                b = 1.0 / math.sqrt(fan_in)
                out[f"{head}.weight"] = ((fan_out, fan_in), "uniform", b)
                out[f"{head}.bias"] = ((fan_out,), "density" if head.endswith(
                    "alpha") else "uniform", b)
        elif rest != "output.bias":
            out[name] = entry
    return out


def make_weights(config: dict, num_timesteps: int, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The f32 weights of a view-direction configuration from the seed: one
    uniform and one normal draw on the device (`inputs.sub_seed(seed, 2)`),
    cut into the tensors of `weight_shapes`."""
    model, law = config["model"], config["weights"]
    shapes = weight_shapes(model, num_timesteps)
    n_uni = sum(math.prod(s) for s, kind, _ in shapes.values()
                if kind in ("uniform", "density"))
    n_norm = sum(math.prod(s) for s, kind, _ in shapes.values()
                 if kind == "normal")
    g = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, 2))
    uni = torch.rand(n_uni, generator=g, device=device) * 2.0 - 1.0
    norm = torch.randn(n_norm, generator=g, device=device)
    out, iu, inn = {}, 0, 0
    for name, (shape, kind, scale) in shapes.items():
        size = math.prod(shape)
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "normal":
            out[name] = norm[inn:inn + size].view(shape) * law[scale]
            inn += size
        else:
            out[name] = uni[iu:iu + size].view(shape) * scale
            iu += size
            if kind == "density":
                out[name][0] += law["density_bias"]
    return out
