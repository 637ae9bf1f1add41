"""Render pose sequences to images + artifact files
(counterpart of nonrigid_nerf_tpu/apps/render_path.py:29-125).

Behavioral contract (reference: render_path, train.py:419-553): with
`savedir`, each frame is written as `{i:03d}.png`, `disp_{i:03d}.png`
(max-normalized), jet and Blinn-Phong disparity visualizations, and a jet
error map against its ground truth where one is given; `render_factor`
downscales intrinsics for fast previews. One renderer per frame size is
reused across frames: `parallel.make_auto_renderer`, which renders over the
ranks of a process group when one of more than one rank is up. Then every
rank must call `render_path`, every rank gets every frame, and rank 0 alone
writes the files.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from nonrigid_nerf_torch.config import EditConfig, ModelConfig, RenderSettings
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.ops.math import to8b
from nonrigid_nerf_torch.ops.rays import get_rays
from nonrigid_nerf_torch.parallel import multihost
from nonrigid_nerf_torch.parallel.mesh import make_auto_renderer
from nonrigid_nerf_torch.utils.image_io import imwrite
from nonrigid_nerf_torch.utils.spans import span
from nonrigid_nerf_torch.utils.viz import (disparity_to_blinn_phong,
                                           disparity_to_jet)


def downscale_intrinsics(intrinsics, render_factor: int):
    if not render_factor:
        return intrinsics
    out = []
    for intrin in intrinsics:
        new = dict(intrin)
        new["height"] = intrin["height"] // render_factor
        new["width"] = intrin["width"] // render_factor
        for k in ("focal_x", "focal_y", "center_x", "center_y"):
            new[k] = intrin[k] / render_factor
        out.append(new)
    return out


def render_path(model, cfg: ModelConfig, rs: RenderSettings, render_poses,
                intrinsics, latents, chunk: int = 32768,
                gt_imgs=None, savedir: Optional[str] = None,
                render_factor: int = 0, detailed: bool = False,
                edit: EditConfig = EditConfig(), renderer=None,
                verbose: bool = True, device: DeviceLike = None):
    """Render each pose with its latent code, in test mode (no jitter, no
    density noise).

    render_poses: (F, 3, 4+) array-like; intrinsics: F dicts; latents
    (F, L); gt_imgs: (F, H, W, 3) in [0, 1] for the error maps; renderer: a
    `make_ray_renderer` function to use in place of one built here.
    Under a process group every rank calls it, and rank 0 alone writes to
    `savedir`.
    Returns (rgbs (F, H, W, 3), disps (F, H, W)) numpy arrays, plus a list
    of per-frame detail dicts (numpy, (H, W, ...)) when `detailed`.
    """
    device = resolve_device(device)
    rs = rs.test_mode()
    intrinsics = downscale_intrinsics(intrinsics, render_factor)
    latents = torch.as_tensor(np.asarray(latents, np.float32), device=device)
    if not multihost.is_main():
        savedir = None

    rgbs, disps, all_details = [], [], []
    renderer_cache = {}
    t0 = time.time()
    for i, (c2w, intrin) in enumerate(zip(render_poses, intrinsics)):
        with span("frame"):
            H, W = int(intrin["height"]), int(intrin["width"])
            with span("frame_rays"):
                if renderer is None:
                    if (H, W) not in renderer_cache:
                        renderer_cache[(H, W)] = make_auto_renderer(
                            cfg, rs, edit=edit, chunk=chunk, device=device,
                            detailed=detailed, n_rays_hint=H * W)
                    render_fn = renderer_cache[(H, W)]
                else:
                    render_fn = renderer

                c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4],
                                      device=device)
                rays_o, rays_d = get_rays(c2w, intrin)
                rays_o = rays_o.reshape(-1, 3)
                rays_d = rays_d.reshape(-1, 3)
                frame_latents = latents[i].reshape(1, -1).expand(H * W, -1)

            with span("blocks"):
                out = render_fn(model, rays_o, rays_d, frame_latents)
            with span("readback"):
                rgb = out["rgb_map"].reshape(H, W, 3).cpu().numpy()
                disp = out["disp_map"].reshape(H, W).cpu().numpy()
                if detailed:
                    all_details.append({
                        k: v.reshape((H, W) + v.shape[1:]).cpu().numpy()
                        for k, v in out.items()
                        if k not in ("rgb_map", "disp_map")})
            rgbs.append(rgb)
            disps.append(disp)
            if verbose:
                print(f"render_path frame {i}: {time.time() - t0:.2f}s",
                      flush=True)
                t0 = time.time()

            if savedir is not None:
                with span("write"):
                    imwrite(os.path.join(savedir, f"{i:03d}.png"), to8b(rgb))
                    raw_disp = disp / max(float(disp.max()), 1e-10)
                    imwrite(os.path.join(savedir, f"disp_{i:03d}.png"),
                            to8b(raw_disp))
                    imwrite(os.path.join(savedir, f"disp_jet_{i:03d}.png"),
                            to8b(disparity_to_jet(raw_disp)))
                    imwrite(os.path.join(savedir, f"disp_phong_{i:03d}.png"),
                            to8b(disparity_to_blinn_phong(raw_disp)))
                    if gt_imgs is not None:
                        gt = np.asarray(gt_imgs[i])
                        if render_factor:
                            gt = gt[::render_factor, ::render_factor][:H, :W]
                        error = (np.linalg.norm(gt - rgb, axis=-1)
                                 / np.sqrt(3.0))
                        error = np.clip(error * 10.0, 0.0, 1.0)  # exaggerate
                        imwrite(os.path.join(savedir, f"error_{i:03d}.png"),
                                to8b(disparity_to_jet(error)))

    rgbs = np.stack(rgbs, 0)
    disps = np.stack(disps, 0)
    if detailed:
        return rgbs, disps, all_details
    return rgbs, disps
