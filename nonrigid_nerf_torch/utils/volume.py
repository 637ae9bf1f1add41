"""Scene volume extent probe + camera visualization
(counterpart of nonrigid_nerf_tpu/utils/volume.py:20-93).

Renders the 4 corner rays of every camera in one batch, in test mode, takes
the min/max of all unbent sample points and camera positions, pads 10%, and
writes a `cameras.obj` sanity mesh (reference: run_nerf_helpers.py:918-1051,
called from train.py:1485). On a CUDA model the batch's canonical MLP runs
as the `mlp_fwd` kernel (coarse and fine pass), as any render does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from nonrigid_nerf_torch.config import ModelConfig, RenderSettings
from nonrigid_nerf_torch.engine.render import render_rays
from nonrigid_nerf_torch.ops.rays import pixel_rays


def determine_nerf_volume_extent(model, cfg: ModelConfig, rs: RenderSettings,
                                 poses, intrinsics,
                                 output_folder: Optional[str] = None):
    """Returns (min_point, max_point) numpy arrays of shape (3,).

    poses: (N, 3, 4+) camera-to-world; intrinsics: N dicts. The rays are
    made and rendered on the model's device."""
    rs = rs.test_mode()
    device = model.latents.device
    c2w, xs, ys, fx, fy, cx, cy = [], [], [], [], [], [], []
    # corner order (y, x) per camera matches the reference probe
    for pose, intrin in zip(poses, intrinsics):
        w, h = int(intrin["width"]), int(intrin["height"])
        for yy, xx in ((0, 0), (h - 1, 0), (0, w - 1), (h - 1, w - 1)):
            c2w.append(np.asarray(pose)[:3, :4])
            xs.append(xx)
            ys.append(yy)
            fx.append(intrin["focal_x"])
            fy.append(intrin["focal_y"])
            cx.append(intrin["center_x"])
            cy.append(intrin["center_y"])

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    rays_o, rays_d = pixel_rays(dev(np.stack(c2w)), dev(xs), dev(ys), dev(fx),
                                dev(fy), dev(cx), dev(cy))
    latents = torch.zeros((rays_o.shape[0],
                           intrinsics[0]["ray_bending_latent_size"]),
                          device=device)
    with torch.no_grad():
        out = render_rays(model, cfg, rs, rays_o, rays_d, latents,
                          detailed=True)
    pts = out["initial_input_pts"].cpu().numpy()        # (4N, S, 3)
    camera_positions = np.asarray(poses)[:, :3, 3]

    if output_folder is not None:
        _write_cameras_obj(os.path.join(output_folder, "cameras.obj"),
                           pts, camera_positions)

    critical = np.concatenate([pts.reshape(-1, 3), camera_positions], 0)
    min_point = critical.min(0)
    max_point = critical.max(0)
    center = (min_point + max_point) / 2.0
    min_point = center + (min_point - center) * 1.1
    max_point = center + (max_point - center) * 1.1
    return min_point, max_point


def _write_cameras_obj(path: str, corner_pts: np.ndarray,
                       camera_positions: np.ndarray) -> None:
    """Green near points, red corner-ray segments, blue camera markers."""
    eps = 1e-5
    begin = corner_pts[:, 0, :]
    end = corner_pts[:, -1, :]
    n = len(begin)
    m = len(camera_positions)
    with open(path, "w") as f:
        for x, y, z in begin:
            f.write(f"v {x} {y} {z} 0.0 1.0 0.0\n")
        for x, y, z in end:
            f.write(f"v {x} {y} {z} 1.0 0.0 0.0\n")
        for x, y, z in end:
            f.write(f"v {x + eps} {y} {z} 1.0 0.0 0.0\n")
        for x, y, z in camera_positions:
            f.write(f"v {x} {y} {z} 0.0 0.0 1.0\n")
        for x, y, z in camera_positions:
            f.write(f"v {x + eps} {y} {z} 0.0 0.0 1.0\n")
        for x, y, z in camera_positions:
            f.write(f"v {x} {y + eps} {z} 0.0 0.0 1.0\n")
        for i in range(1, n + 1):
            f.write(f"f {i} {i + n} {i + 2 * n}\n")
        off = 3 * n
        for i in range(1, m + 1):
            f.write(f"f {off + i} {off + i + m} {off + i + 2 * m}\n")
