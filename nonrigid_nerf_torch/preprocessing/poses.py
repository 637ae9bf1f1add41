"""SfM pose estimation: running COLMAP + LLFF poses_bounds.npy conversion
(a copy of nonrigid_nerf_tpu/preprocessing/poses.py: the port keeps its own).

Fills in the `gen_poses(datadir, matching)` contract the reference leaves as
a user-supplied stub (reference: llff_preprocessing/pose_utils.py:4-5,
preprocess.py:334-336, README.md:25-29): run COLMAP (sequential or
exhaustive matching), read the sparse model, and write the LLFF-convention
`poses_bounds.npy` consumed by the data loader.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from nonrigid_nerf_torch.preprocessing.colmap_model import (
    qvec2rotmat, read_cameras_binary, read_images_binary,
    read_points3d_binary)


def run_colmap(basedir: str, matching: str = "sequential_matcher",
               colmap_path: str = "colmap") -> None:
    """Run COLMAP feature extraction, matching, and sparse mapping over
    basedir/images, producing basedir/sparse/0."""
    if matching not in ("sequential_matcher", "exhaustive_matcher"):
        raise ValueError(f"unknown matching mode {matching!r}")
    db = os.path.join(basedir, "database.db")
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    logfile = os.path.join(basedir, "colmap_output.txt")

    commands = [
        [colmap_path, "feature_extractor", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--ImageReader.single_camera", "1"],
        [colmap_path, matching, "--database_path", db],
        [colmap_path, "mapper", "--database_path", db,
         "--image_path", os.path.join(basedir, "images"),
         "--output_path", sparse],
    ]
    with open(logfile, "a") as log:
        for cmd in commands:
            print("running:", " ".join(cmd), flush=True)
            try:
                subprocess.run(cmd, check=True, stdout=log,
                               stderr=subprocess.STDOUT)
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"COLMAP binary {colmap_path!r} not found — install "
                    "COLMAP (https://colmap.github.io/) or point "
                    "--colmap_path at it")


def colmap_to_poses_bounds(basedir: str, model_dir: str = None) -> np.ndarray:
    """Convert a COLMAP sparse model to the LLFF poses_bounds.npy layout:
    (N, 17) rows of a 3x5 [down right back | t | hwf] matrix plus
    (close_depth, inf_depth) scene bounds from the 0.1/99.9 depth
    percentiles of the sparse points."""
    model_dir = model_dir or os.path.join(basedir, "sparse", "0")
    cameras = read_cameras_binary(os.path.join(model_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(model_dir, "images.bin"))
    points = read_points3d_binary(os.path.join(model_dir, "points3D.bin"))

    cam = cameras[list(cameras)[0]]
    h, w = cam.height, cam.width
    focal = cam.params[0]   # fx of SIMPLE_PINHOLE / SIMPLE_RADIAL / PINHOLE

    names = sorted(images, key=lambda k: images[k].name)
    c2w_mats = []
    for key in names:
        im = images[key]
        R = qvec2rotmat(im.qvec)
        t = im.tvec.reshape(3, 1)
        # world-to-camera -> camera-to-world
        c2w = np.concatenate([R.T, -R.T @ t], axis=1)
        c2w_mats.append(c2w)
    c2w_mats = np.stack(c2w_mats, 0)           # (N, 3, 4)

    # COLMAP camera axes are [right, down, forward]; LLFF stores
    # [down, right, back]
    poses = np.concatenate([
        c2w_mats[:, :, 1:2], c2w_mats[:, :, 0:1], -c2w_mats[:, :, 2:3],
        c2w_mats[:, :, 3:4],
        np.tile(np.array([h, w, focal], np.float64).reshape(1, 3, 1),
                (len(c2w_mats), 1, 1)),
    ], axis=2)                                  # (N, 3, 5)

    pts = np.stack([p.xyz for p in points.values()])       # (P, 3)
    bounds = []
    for key in names:
        im = images[key]
        R = qvec2rotmat(im.qvec)
        t = im.tvec
        z = (pts @ R[2].T + t[2])               # depth along camera forward
        z = z[z > 0]
        close = np.percentile(z, 0.1) * 0.9 if len(z) else 0.1
        inf = np.percentile(z, 99.9) * 1.0 if len(z) else 10.0
        bounds.append([close, inf])
    bounds = np.asarray(bounds)

    out = np.concatenate([poses.reshape(-1, 15), bounds], axis=1)
    np.save(os.path.join(basedir, "poses_bounds.npy"), out)
    return out


def gen_poses(basedir: str, matching: str = "sequential_matcher",
              colmap_path: str = "colmap") -> None:
    """COLMAP-based pose estimation for a sequence at basedir/images."""
    model_dir = os.path.join(basedir, "sparse", "0")
    if not os.path.exists(os.path.join(model_dir, "images.bin")):
        run_colmap(basedir, matching, colmap_path)
    else:
        print("found existing COLMAP sparse model, skipping SfM")
    colmap_to_poses_bounds(basedir, model_dir)
    print("wrote", os.path.join(basedir, "poses_bounds.npy"))
