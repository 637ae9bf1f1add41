"""Ray generation from camera poses and per-camera intrinsics, and the NDC
projection (counterpart of nonrigid_nerf_tpu/ops/rays.py:21-80).

Pinhole camera, x right, y up, z backwards: pixel (x, y) maps to the camera
direction [(x - cx)/fx, -(y - cy)/fy, -1], rotated to world space by the
camera-to-world rotation. The 3x3 rotation is written out elementwise in
f32, so no TF32 matmul can touch it (the JAX code asks for
Precision.HIGHEST here).
"""

from __future__ import annotations

import torch


def pixel_rays(c2w, x, y, focal_x, focal_y, center_x, center_y):
    """Rays through (possibly batched) pixel coordinates.

    c2w (..., 3, 4) broadcasts against the pixels x, y (...,). Returns
    rays_o, rays_d (..., 3): origins and unnormalized directions."""
    dirs = torch.stack([(x - center_x) / focal_x,
                        -(y - center_y) / focal_y,
                        -torch.ones_like(x)], dim=-1)            # (..., 3)
    rot = c2w[..., :3, :3]
    rays_d = (rot * dirs[..., None, :]).sum(dim=-1)
    rays_o = torch.broadcast_to(c2w[..., :3, 3], rays_d.shape)
    return rays_o, rays_d


def get_rays(c2w, intrin):
    """Full-image ray grid: (H, W, 3) origins and directions on c2w's device.

    `intrin` holds height/width/focal_x/focal_y/center_x/center_y."""
    H, W = int(intrin["height"]), int(intrin["width"])
    x = torch.arange(W, dtype=torch.float32, device=c2w.device)
    y = torch.arange(H, dtype=torch.float32, device=c2w.device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")                 # (H, W)
    return pixel_rays(
        c2w, xx, yy,
        float(intrin["focal_x"]), float(intrin["focal_y"]),
        float(intrin["center_x"]), float(intrin["center_y"]))


def ndc_rays(H, W, focal_x, focal_y, near, rays_o, rays_d):
    """Shift rays (..., 3) to the near plane and project them into NDC space.

    For API parity only: the reference keeps NDC off
    (reference: train.py:384-387,714)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal_x)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal_y)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal_x)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal_y)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
