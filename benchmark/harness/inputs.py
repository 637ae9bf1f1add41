"""What the benchmark hands the program and the reference alike, all made on
the device from `--seed`: the image stack with its cameras, the weights,
the camera path of the render traffic and the seeds of the training steps.

The stack is the synthetic one of the port's first bench (uniform noise,
cameras stepping along z, one timestep per image, every image a training
image) at the geometry the traffic file gives. The weights follow the
reference's initializers, with the bending and rigidity output layers and
the latent table drawn from normals, and the density bias raised, as the
configuration's "weights" group sets, so that bending and importance
sampling do real work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

MASK63 = (1 << 63) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream of draws (1: the stack, 2: the
    weights)."""
    return (int(seed) * 8 + stream) & MASK63


def make_stack(stack: dict, seed: int, device, images: bool = True) -> dict:
    """images (N, H, W, 3) uint8 (None where `images` is false: rendering
    reads only the cameras), poses (N, 3, 4) f32, focal, timestep (N,) (one
    timestep per image), near, far."""
    n, h, w = stack["images"], stack["height"], stack["width"]
    if images:
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
        images = torch.randint(0, 256, (n, h, w, 3), generator=g,
                               dtype=torch.uint8, device=device)
    else:
        images = None
    poses = torch.zeros((n, 3, 4), device=device)
    poses[:, 0, 0] = poses[:, 1, 1] = poses[:, 2, 2] = 1.0
    poses[:, 2, 3] = torch.linspace(0.0, stack["z_span"], n, device=device)
    return {"images": images, "poses": poses, "focal": float(stack["focal"]),
            "timestep": torch.arange(n, device=device),
            "near": float(stack["near"]), "far": float(stack["far"])}


def _nerf_layers(model: dict, net: str) -> List[Tuple[str, int, int]]:
    in_ch = 3 + 6 * model["multires"]
    if model["time_conditioned_baseline"]:
        in_ch += model["ray_bending_latent_size"]
    width = model["netwidth"]
    out = [(f"{net}.pts.0", in_ch, width)]
    for i in range(model["netdepth"] - 1):
        fan_in = width + in_ch if i in model["skips"] else width
        out.append((f"{net}.pts.{i + 1}", fan_in, width))
    out.append((f"{net}.output", width, 5 if model["N_importance"] > 0 else 4))
    return out


def weight_shapes(model: dict, num_timesteps: int) -> Dict[str, tuple]:
    """name -> (shape, law, scale): the law of each tensor's draw, "uniform"
    on (-scale, scale), "normal" with std scale, or "zeros"; "density" is
    the output bias, uniform, whose density entry gets `scale` added."""
    latent = model["ray_bending_latent_size"]
    out = {"latents": ((num_timesteps, latent), "normal", "latent_std")}
    for net in ("coarse", "fine"):
        for name, fan_in, fan_out in _nerf_layers(model, net):
            b = 1.0 / math.sqrt(fan_in)
            out[f"{name}.weight"] = ((fan_out, fan_in), "uniform", b)
            out[f"{name}.bias"] = ((fan_out,), "density" if name.endswith(
                "output") else "uniform", b)
    if model["ray_bending"]:
        fan_in = 3 + latent
        for i in range(model["bending_depth"] - 1):
            w = model["bending_width"]
            out[f"bender.bend.{i}.weight"] = ((w, fan_in), "uniform",
                                              math.sqrt(6.0 / fan_in))
            out[f"bender.bend.{i}.bias"] = ((w,), "zeros", 0.0)
            fan_in = w
        out[f"bender.bend.{model['bending_depth'] - 1}.weight"] = (
            (3, fan_in), "normal", "bend_out_std")
        fan_in = 3
        for i in range(model["rigidity_depth"] - 1):
            w = model["rigidity_width"]
            out[f"bender.rigidity.{i}.weight"] = ((w, fan_in), "uniform",
                                                  math.sqrt(6.0 / fan_in))
            out[f"bender.rigidity.{i}.bias"] = ((w,), "zeros", 0.0)
            fan_in = w
        last = model["rigidity_depth"] - 1
        out[f"bender.rigidity.{last}.weight"] = ((1, fan_in), "normal",
                                                 "rigidity_out_std")
        out[f"bender.rigidity.{last}.bias"] = ((1,), "zeros", 0.0)
    return out


def make_weights(config: dict, num_timesteps: int, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The f32 weights of a configuration from the seed: one uniform and one
    normal draw on the device, cut into the tensors of `weight_shapes`."""
    model, law = config["model"], config["weights"]
    shapes = weight_shapes(model, num_timesteps)
    n_uni = sum(math.prod(s) for s, kind, _ in shapes.values()
                if kind in ("uniform", "density"))
    n_norm = sum(math.prod(s) for s, kind, _ in shapes.values()
                 if kind == "normal")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
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
                out[name][3] += law["density_bias"]
    return out


def path_pose(poses: np.ndarray, path: dict, k: int) -> np.ndarray:
    """Camera k of the render traffic's path, (3, 4) f32 on the host: the
    stack's camera k mod N (`poses` (N, 3, 4)), turned about y by
    yaw_deg * sin(2 pi k / period)."""
    base = poses[k % poses.shape[0]].astype(np.float64)
    a = math.radians(path["yaw_deg"]) * math.sin(2.0 * math.pi * k
                                                 / path["period"])
    rot = np.array([[math.cos(a), 0.0, math.sin(a)],
                    [0.0, 1.0, 0.0],
                    [-math.sin(a), 0.0, math.cos(a)]])
    return np.concatenate([rot @ base[:, :3], base[:, 3:]], 1).astype(np.float32)
