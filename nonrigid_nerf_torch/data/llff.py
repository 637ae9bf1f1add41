"""LLFF-style dataset loading on the host
(counterpart of nonrigid_nerf_tpu/data/llff.py, numpy only, with the same
functions, arguments and results).

Covers the reference's data contract (reference: load_llff.py:5-73,
README.md:292-296, train.py:1222-1322):

- monocular sequences: `precomputed.json` (poses/bds/render_poses/i_test)
  next to an `images/` folder, OR a standard LLFF `poses_bounds.npy`.
- multi-view rigs: `calibration.json` + optional
  `image_to_camera_id_and_timestep.json`.

Returns match the reference shapes: images (N, H, W, 3) float32 in [0, 1],
poses (N, 3, 5) ([R|t|hwf]), bds, render_poses, i_test. Images are decoded
by `utils/image_io.py` (Pillow, the decoder behind the JAX package's
imageio).
"""

from __future__ import annotations

import json
import os

import numpy as np

from nonrigid_nerf_torch.utils.image_io import imread


def _imread(path: str) -> np.ndarray:
    img = imread(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.asarray(img[..., :3])


def _list_images(imgdir: str):
    exts = (".png", ".jpg", ".jpeg", ".JPG", ".PNG")
    return [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
            if f.endswith(exts)]


def _downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor average-pool downsampling (host side, numpy)."""
    if factor <= 1:
        return img
    H = (img.shape[0] // factor) * factor
    W = (img.shape[1] // factor) * factor
    img = img[:H, :W]
    return img.reshape(H // factor, factor, W // factor, factor,
                       img.shape[-1]).mean(axis=(1, 3))


def _load_images(datadir: str, factor: int = 1) -> np.ndarray:
    """Load (and possibly downsample) the image stack as float32 in [0,1].

    Prefers a pre-downsampled `images_{factor}` folder when present (the
    LLFF convention), otherwise average-pools `images/`.
    """
    imgdir = os.path.join(datadir, f"images_{factor}") if factor > 1 else None
    pooled = False
    if imgdir is None or not os.path.isdir(imgdir):
        imgdir = os.path.join(datadir, "images")
        pooled = factor > 1
    files = _list_images(imgdir)
    if not files:
        raise FileNotFoundError(f"no images found under {imgdir}")
    imgs = []
    for f in files:
        img = _imread(f).astype(np.float32) / 255.0
        if pooled:
            img = _downsample(img, factor)
        imgs.append(img)
    return np.stack(imgs, 0).astype(np.float32)


def _recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly transform all poses so their average sits at the origin
    looking down -z (standard LLFF recentering)."""
    def viewmatrix(z, up, pos):
        vec2 = z / np.linalg.norm(z)
        vec0 = np.cross(up, vec2)
        vec0 = vec0 / np.linalg.norm(vec0)
        vec1 = np.cross(vec2, vec0)
        return np.stack([vec0, vec1, vec2, pos], 1)

    center = poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].sum(0)
    up = poses[:, :3, 1].sum(0)
    c2w = viewmatrix(z, up, center)                       # (3, 4)

    bottom = np.array([[0, 0, 0, 1.0]])
    c2w_h = np.concatenate([c2w, bottom], 0)
    poses_h = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (len(poses), 1, 1))], 1)
    return (np.linalg.inv(c2w_h) @ poses_h)[:, :3, :4]


def _spiral_render_poses(poses: np.ndarray, bds: np.ndarray,
                         n_views: int = 120, n_rots: int = 2) -> np.ndarray:
    """Generate a spiral camera path around the average pose (the LLFF
    `render_poses`)."""
    def viewmatrix(z, up, pos):
        vec2 = z / np.linalg.norm(z)
        vec0 = np.cross(up, vec2)
        vec0 = vec0 / np.linalg.norm(vec0)
        vec1 = np.cross(vec2, vec0)
        return np.stack([vec0, vec1, vec2, pos], 1)

    c2w = np.eye(4)[:3]
    up = poses[:, :3, 1].sum(0)

    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0) * 1.0
    rads = np.append(rads, 1.0)

    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * 0.5), 1.0]) * rads)
        z = c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0])
        render_poses.append(viewmatrix(z, up, c))
    return np.stack(render_poses, 0).astype(np.float32)


def adaptive_spiral_poses(poses: np.ndarray, near: float, far: float,
                          n_views: int = 120, n_rots: int = 2) -> np.ndarray:
    """Spiral render path derived from the *trained* scene: orbit the average
    input camera with radii fitted to the capture's camera spread and focus
    depth from the scene bounds. This is the adaptive spiral the reference
    leaves to the user (reference README.md:259-261); unlike
    `_spiral_render_poses` it does not assume recentered poses.

    poses: (N, 3, 4+) camera-to-world. Returns (n_views, 3, 4)."""
    poses = np.asarray(poses)[:, :3, :4]

    def viewmatrix(z, up, pos):
        vec2 = z / np.linalg.norm(z)
        vec0 = np.cross(up, vec2)
        vec0 = vec0 / np.linalg.norm(vec0)
        vec1 = np.cross(vec2, vec0)
        return np.stack([vec0, vec1, vec2, pos], 1)

    center = poses[:, :3, 3].mean(0)
    c2w = viewmatrix(poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0), center)
    up = poses[:, :3, 1].sum(0)

    # spiral radii from the camera spread, expressed in the average frame;
    # keep a minimum so a perfectly-static capture still orbits
    rel = (poses[:, :3, 3] - center) @ c2w[:3, :3]
    rads = np.percentile(np.abs(rel), 90, axis=0)
    floor = 0.05 * max(float(far - near), 1e-6)
    rads = np.maximum(rads, floor)

    close_depth, inf_depth = max(float(near), 1e-3), float(far) * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]:
        offset = np.array([np.cos(theta), -np.sin(theta),
                           -np.sin(theta * 0.5)]) * rads
        c = center + c2w[:3, :3] @ offset
        z = c - (center + c2w[:3, :3] @ np.array([0.0, 0.0, -focal]))
        out.append(viewmatrix(z, up, c))
    return np.stack(out, 0).astype(np.float32)


def _load_poses_bounds(datadir: str, images: np.ndarray, factor: int):
    """Standard LLFF `poses_bounds.npy`: (N, 17) = 3x5 pose + 2 bounds.

    Performs the LLFF axis swap ([down right back] -> [right up back]),
    rescales the scene by 1/(bds.max() - bds.min()) (the reference's
    `sc = 1./(bds.max() - bds.min())` variant, README.md:23-24), recenters,
    and generates a spiral render path.
    """
    arr = np.load(os.path.join(datadir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bds = arr[:, -2:]

    # [down right back] -> [right up back]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], 2)

    # adjust hwf for the actual loaded resolution
    H, W = images.shape[1:3]
    poses[:, 0, 4] = H
    poses[:, 1, 4] = W
    poses[:, 2, 4] = poses[:, 2, 4] / factor

    sc = 1.0 / (bds.max() - bds.min())
    poses[:, :3, 3] *= sc
    bds = bds * sc

    recentered = _recenter_poses(poses[:, :3, :4])
    poses = np.concatenate([recentered, poses[:, :3, 4:5]], 2)

    render_poses = _spiral_render_poses(poses, bds)
    i_test = int(np.argmin(np.linalg.norm(
        poses[:, :3, 3] - poses[:, :3, 3].mean(0), axis=-1)))
    return poses.astype(np.float32), bds.astype(np.float32), render_poses, i_test


def load_llff_data(datadir: str, factor: int = 1, recenter: bool = True,
                   bd_factor=None, spherify: bool = False):
    """Monocular LLFF loader. Returns (images, poses, bds, render_poses,
    i_test) per the reference contract (reference: load_llff.py:5-34,
    README.md:292-296)."""
    images = _load_images(datadir, factor)

    precomputed_path = os.path.join(datadir, "precomputed.json")
    if os.path.exists(precomputed_path):
        with open(precomputed_path) as f:
            pre = json.load(f)
        poses = np.asarray(pre["poses"], np.float32)
        bds = np.asarray(pre["bds"], np.float32)
        render_poses = np.asarray(pre["render_poses"], np.float32)
        i_test = pre["i_test"]
        if factor > 1:
            # precomputed hwf refers to the full-resolution images; rescale
            # so hwf always matches the loaded image resolution
            poses[:, 0, 4] = images.shape[1]
            poses[:, 1, 4] = images.shape[2]
            poses[:, 2, 4] /= factor
        return images, poses, bds, render_poses, i_test

    if os.path.exists(os.path.join(datadir, "poses_bounds.npy")):
        poses, bds, render_poses, i_test = _load_poses_bounds(
            datadir, images, factor)
        return images, poses, bds, render_poses, i_test

    raise FileNotFoundError(
        f"{datadir} has neither precomputed.json nor poses_bounds.npy")


def load_llff_data_multi_view(datadir: str, factor: int = 1, **_):
    """Multi-view loader: per-camera extrinsics from `calibration.json`
    (schema: reference README.md:177-215, load_llff.py:36-73)."""
    images = _load_images(datadir, factor)
    extras = get_multi_view_mappings(len(images), datadir)

    with open(os.path.join(datadir, "calibration.json")) as f:
        calibration = json.load(f)

    poses = np.zeros((len(images), 3, 5), np.float32)
    for i in range(len(images)):
        raw_view = extras["raw_views"][extras["imageid_to_viewid"][i]]
        poses[i, :3, :3] = np.asarray(calibration[raw_view]["rotation"])
        poses[i, :3, 3] = np.asarray(calibration[raw_view]["translation"])
    bds = np.asarray([calibration["min_bound"], calibration["max_bound"]],
                     np.float32)
    render_poses = poses.copy()
    i_test = 0
    return images, poses, bds, render_poses, i_test


def get_multi_view_mappings(num_images: int, datadir: str) -> dict:
    """Image -> (view, timestep) id mappings; identity for monocular
    (reference: train.py:1222-1267)."""
    mapping_path = os.path.join(
        datadir, "image_to_camera_id_and_timestep.json")
    extras = {}
    if os.path.exists(mapping_path):
        extras["is_multiview"] = True
        with open(mapping_path) as f:
            raw_mapping = json.load(f)
    else:
        extras["is_multiview"] = False
        raw_mapping = {name: [i, i] for i, name in enumerate(range(num_images))}

    sorted_mapping = {k: raw_mapping[k] for k in sorted(raw_mapping)}
    pairs = list(sorted_mapping.values())
    extras["raw_multi_view_mapping"] = sorted_mapping
    extras["raw_multi_view_list"] = pairs

    timesteps = sorted({t for _, t in pairs})
    views = sorted({v for v, _ in pairs})
    extras["raw_timesteps"] = timesteps
    extras["rawtimestep_to_timestepid"] = {t: i for i, t in enumerate(timesteps)}
    extras["raw_views"] = views
    extras["rawview_to_viewid"] = {v: i for i, v in enumerate(views)}
    extras["imageid_to_viewid"] = [
        extras["rawview_to_viewid"][v] for v, _ in pairs]
    extras["imageid_to_timestepid"] = [
        extras["rawtimestep_to_timestepid"][t] for _, t in pairs]
    return extras


def get_intrinsics(datadir: str, dataset_extras: dict, images: np.ndarray,
                   hwf, factor: int = 1,
                   ray_bending_latent_size: int = 32) -> dict:
    """Per-viewid intrinsics dicts (reference: train.py:1270-1322 +
    the downscaling fixups in main_function, train.py:1354-1366)."""
    intrinsics = {}
    H, W = images.shape[1:3]

    if dataset_extras["is_multiview"]:
        # the reference code reads calibration_averaged_camera_view.json
        # (train.py:1280-1283) but its README documents the per-camera
        # intrinsics inside calibration.json itself (README.md:177-215);
        # accept either
        avg_path = os.path.join(datadir,
                                "calibration_averaged_camera_view.json")
        if not os.path.exists(avg_path):
            avg_path = os.path.join(datadir, "calibration.json")
        with open(avg_path) as f:
            calibration = json.load(f)
        for raw_view, cam in calibration.items():
            if raw_view in ("focal", "height", "width", "min_bound",
                            "max_bound"):
                continue
            viewid = dataset_extras["rawview_to_viewid"][raw_view]
            intrinsics[viewid] = {
                "height": H, "width": W,
                "focal_x": cam["focal_x"] / factor,
                "focal_y": cam["focal_y"] / factor,
                "center_x": cam["center_x"] / factor,
                "center_y": cam["center_y"] / factor,
            }
    else:
        focal = float(hwf[2])
        for viewid in range(len(set(dataset_extras["imageid_to_viewid"]))):
            intrinsics[viewid] = {
                "height": H, "width": W,
                "focal_x": focal, "focal_y": focal,
                # full-resolution center, downscaled like the reference
                "center_x": (W * factor / 2) / factor,
                "center_y": (H * factor / 2) / factor,
            }

    for cam in intrinsics.values():
        cam["ray_bending_latent_size"] = ray_bending_latent_size
    return intrinsics


def block_train_test_split(num_timesteps: int, imageid_to_timestepid,
                           train_block_size: int = 0,
                           test_block_size: int = 0):
    """AAAAABB... split over timesteps (reference: train.py:1374-1415).
    Returns (i_train, i_test) image-id arrays."""
    num_images = len(imageid_to_timestepid)
    if train_block_size <= 0 or test_block_size <= 0:
        return np.arange(num_images), np.array([], dtype=np.int64)

    test_timesteps = np.concatenate([
        np.arange(min(num_timesteps, start + train_block_size),
                  min(num_timesteps,
                      start + train_block_size + test_block_size))
        for start in np.arange(0, num_timesteps,
                               train_block_size + test_block_size)
    ])
    i_test = np.array([i for i, t in enumerate(imageid_to_timestepid)
                       if t in test_timesteps], dtype=np.int64)
    i_train = np.array([i for i in range(num_images) if i not in set(i_test)],
                       dtype=np.int64)
    return i_train, i_test
