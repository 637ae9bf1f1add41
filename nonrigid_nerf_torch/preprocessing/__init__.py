"""Host-side preprocessing: COLMAP model readers and LLFF poses."""

from nonrigid_nerf_torch.preprocessing.colmap_model import (
    read_cameras_binary, read_images_binary, read_points3d_binary,
    qvec2rotmat)
from nonrigid_nerf_torch.preprocessing.poses import (
    gen_poses, colmap_to_poses_bounds, run_colmap)

__all__ = [
    "read_cameras_binary", "read_images_binary", "read_points3d_binary",
    "qvec2rotmat", "gen_poses", "colmap_to_poses_bounds", "run_colmap",
]
