"""Ahead-of-time export of a trained renderer for serving
(counterpart of nonrigid_nerf_tpu/serving.py).

The production inference path, `render_rays` over a fixed-size ray block in
deterministic test mode, is captured with `torch.export` from a module that
holds the trained weights, and saved as one `.pt2` file (graph and weights)
with a JSON sidecar that carries the calling convention and the
per-timestep latent table. A serving process needs only `torch` to run it:
none of this package, no checkpoint, no config system:

    import torch
    render = torch.export.load("model.pt2").module()
    with torch.no_grad():
        out = render(rays_o, rays_d, latents)     # each (chunk, 3 / L)

The artifact is captured on one device (`meta["device"]`) and runs there.
It runs the plain MLP (`fused_kernel="off"`): the exported graph holds
ATen operators only, no call into a ctypes kernel library, as the JAX
artifact holds no Pallas call.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
from typing import Optional, Tuple

import torch
from torch import nn

from nonrigid_nerf_torch.config import EditConfig, ModelConfig, RenderSettings
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.engine.render import render_rays

FORMAT = "nonrigid_nerf_torch.serving/1"
OUTPUTS = ("rgb_map", "disp_map", "acc_map")


class ServingRenderer(nn.Module):
    """The block renderer as a module: the model's weights are its own, the
    configuration is fixed, and the outputs are the compact per-ray maps."""

    def __init__(self, model, cfg: ModelConfig, rs: RenderSettings,
                 edit: EditConfig = EditConfig()):
        super().__init__()
        self.model = model
        self.cfg = dataclasses.replace(cfg, fused_kernel="off")
        self.rs = rs.test_mode()
        self.edit = edit

    def forward(self, rays_o, rays_d, latents):
        out = render_rays(self.model, self.cfg, self.rs, rays_o, rays_d,
                          latents, edit=self.edit)
        return {k: out[k] for k in OUTPUTS}


def make_serving_fn(model, cfg: ModelConfig, rs: RenderSettings,
                    edit: EditConfig = EditConfig()):
    """The block renderer the artifact holds, live: fn(rays_o, rays_d,
    latents) -> {rgb_map, disp_map, acc_map}, with `fused_kernel="off"`, in
    test mode, without autograd."""
    module = ServingRenderer(model, cfg, rs, edit)

    def fn(rays_o, rays_d, latents):
        with torch.no_grad():
            return module(rays_o, rays_d, latents)

    return fn


def export_renderer(model, cfg: ModelConfig, rs: RenderSettings,
                    chunk: int = 32768, device: DeviceLike = None,
                    edit: EditConfig = EditConfig(),
                    extra_meta: Optional[dict] = None) -> Tuple[bytes, dict]:
    """Capture the renderer with `torch.export` on `device` (cuda unless
    asked otherwise; a copy of the model is moved there) for a fixed (chunk, 3),
    (chunk, 3), (chunk, L) f32 block. Returns (the `.pt2` bytes, meta).
    Callers pad the tail block (`render_many` does)."""
    device = resolve_device(device)
    model = copy.deepcopy(model).to(device)
    module = ServingRenderer(model, cfg, rs, edit).eval()
    latent_size = int(model.latents.shape[-1])
    example = (torch.zeros(chunk, 3, device=device),
               torch.tensor([[0.0, 0.0, -1.0]], device=device).expand(
                   chunk, 3).contiguous(),
               torch.zeros(chunk, latent_size, device=device))
    with torch.no_grad():
        exported = torch.export.export(module, example)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    meta = {
        "format": FORMAT,
        "chunk": int(chunk),
        "latent_size": latent_size,
        "device": str(device),
        "inputs": ["rays_o (chunk, 3) f32", "rays_d (chunk, 3) f32",
                   "latents (chunk, latent_size) f32"],
        "outputs": ["rgb_map (chunk, 3)", "disp_map (chunk,)",
                    "acc_map (chunk,)"],
        "near": float(rs.near),
        "far": float(rs.far),
        # the per-timestep latent table, so that a client can render frame
        # t without any other file
        "latent_table": model.latents.detach().float().cpu().tolist(),
    }
    if extra_meta:
        meta.update(extra_meta)
    return buf.getvalue(), meta


def save_exported(path: str, blob: bytes, meta: dict) -> None:
    """Write the artifact to `path` and its meta to `path + ".meta.json"`."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_exported(path: str):
    """(render_fn, meta) of an artifact; render_fn takes (rays_o, rays_d,
    latents) tensors of the exported block shape on the export's device."""
    module = torch.export.load(path).module()
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)

    def render(rays_o, rays_d, latents):
        with torch.no_grad():
            return module(rays_o, rays_d, latents)

    return render, meta


def render_many(render_fn, chunk: int, rays_o, rays_d, latents):
    """Drive a fixed-block artifact over any number of rays: the tail block
    is padded (rays from the origin along -z, zero latents) and the padding
    stripped from the outputs."""
    n = rays_o.shape[0]
    pad = (-n) % chunk
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d.new_tensor([[0.0, 0.0, -1.0]])
                            .expand(pad, 3)])
        latents = torch.cat([latents, latents.new_zeros(pad,
                                                        latents.shape[1])])
    outs = [render_fn(rays_o[i:i + chunk], rays_d[i:i + chunk],
                      latents[i:i + chunk]) for i in range(0, n + pad, chunk)]
    return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}
