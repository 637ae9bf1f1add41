"""Device-resident ray dataset
(counterpart of nonrigid_nerf_tpu/data/dataset.py:24-126).

The device holds the uint8 image stack and small pose / intrinsics / id
tables; pixel sampling, ray generation and the latent lookup happen on the
device inside the training step, so the loop never copies a batch from the
host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.ops.rays import pixel_rays


@dataclasses.dataclass(frozen=True)
class RayDataset:
    """All device tensors the training step needs."""

    images: torch.Tensor                 # (N, H, W, 3) uint8
    poses: torch.Tensor                  # (N, 3, 4) float32 camera-to-world
    view_intrinsics: torch.Tensor        # (V, 4) = fx, fy, cx, cy per view
    imageid_to_viewid: torch.Tensor      # (N,) int64
    imageid_to_timestepid: torch.Tensor  # (N,) int64
    train_indicator: torch.Tensor        # (N,) float32: 1 for training images
    test_indicator: torch.Tensor         # (N,) float32: 1 for test images
    height: int
    width: int
    num_timesteps: int
    near: float
    far: float

    @property
    def num_images(self) -> int:
        return self.images.shape[0]

    @property
    def has_test_split(self) -> bool:
        return bool(self.test_indicator.sum().item() > 0)


def build_ray_dataset(images: np.ndarray, poses: np.ndarray,
                      intrinsics: Dict[int, dict], dataset_extras: dict,
                      i_train, i_test, near: float, far: float,
                      device: DeviceLike = None) -> RayDataset:
    """Assemble the dataset on `device` (cuda unless asked otherwise) from a
    loader's outputs: images (N, H, W, 3) uint8 or float in [0, 1], poses
    (N, 3+, 4+), intrinsics by view id, and the image-to-view and
    image-to-timestep mappings."""
    device = resolve_device(device)
    n_images = images.shape[0]
    view_intrin = np.zeros((len(intrinsics), 4), np.float32)
    for viewid, cam in intrinsics.items():
        view_intrin[viewid] = [cam["focal_x"], cam["focal_y"],
                               cam["center_x"], cam["center_y"]]
    train_ind = np.zeros((n_images,), np.float32)
    train_ind[np.asarray(i_train, np.int64)] = 1.0
    test_ind = np.zeros((n_images,), np.float32)
    if len(i_test):
        test_ind[np.asarray(i_test, np.int64)] = 1.0
    images_u8 = images if images.dtype == np.uint8 else \
        np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return RayDataset(
        images=dev(images_u8, torch.uint8),
        poses=dev(np.asarray(poses)[:, :3, :4], torch.float32),
        view_intrinsics=dev(view_intrin, torch.float32),
        imageid_to_viewid=dev(dataset_extras["imageid_to_viewid"], torch.int64),
        imageid_to_timestepid=dev(dataset_extras["imageid_to_timestepid"],
                                  torch.int64),
        train_indicator=dev(train_ind, torch.float32),
        test_indicator=dev(test_ind, torch.float32),
        height=int(images.shape[1]), width=int(images.shape[2]),
        num_timesteps=len(dataset_extras["raw_timesteps"]),
        near=float(near), far=float(far))


def linear_pixel_index(image_ids, y, x, height: int, width: int):
    """Row index of pixel (image, y, x) in the stack viewed as (N*H*W, 3),
    in int64: a stack of 2^31 pixels or more (about 2,300 frames of
    720 x 1280) must not wrap."""
    return (image_ids.to(torch.int64) * height + y.to(torch.int64)) * width \
        + x.to(torch.int64)


def draw_pixels(ds: RayDataset, n_rand: int,
                generator: Optional[torch.Generator] = None):
    """`n_rand` uniform (image_ids, x, y) draws from `generator`, in that
    order, on the dataset's device: the draws of `sample_ray_batch` when it
    is given no indices."""
    device = ds.images.device
    return tuple(torch.randint(0, high, (n_rand,), generator=generator,
                               device=device)
                 for high in (ds.num_images, ds.width, ds.height))


def sample_ray_batch(ds: RayDataset, n_rand: int,
                     generator: Optional[torch.Generator] = None,
                     image_ids: Optional[torch.Tensor] = None,
                     x: Optional[torch.Tensor] = None,
                     y: Optional[torch.Tensor] = None):
    """Random pixels of random images -> a ray batch, on the dataset's
    device (reference: the per-iteration sampling of (image, x, y) triples,
    train.py:1546-1553). The indices are `image_ids`, `x`, `y` (n_rand,)
    where given, else uniform draws from `generator`, in that order.

    Returns a dict with rays_o, rays_d, target_rgb (n_rand, 3), image_ids,
    timestep_ids, train_indicator, test_indicator (n_rand,)."""
    device = ds.images.device

    def draw(given, high):
        if given is not None:
            return given.to(device=device, dtype=torch.int64)
        return torch.randint(0, high, (n_rand,), generator=generator,
                             device=device)

    image_ids = draw(image_ids, ds.num_images)
    x = draw(x, ds.width)
    y = draw(y, ds.height)

    flat = ds.images.reshape(-1, 3)
    lin = linear_pixel_index(image_ids, y, x, ds.height, ds.width)
    target = flat[lin].to(torch.float32) / 255.0

    c2w = ds.poses[image_ids]                              # (R, 3, 4)
    intrin = ds.view_intrinsics[ds.imageid_to_viewid[image_ids]]   # (R, 4)
    rays_o, rays_d = pixel_rays(
        c2w, x.to(torch.float32), y.to(torch.float32),
        intrin[:, 0], intrin[:, 1], intrin[:, 2], intrin[:, 3])
    return {
        "rays_o": rays_o,
        "rays_d": rays_d,
        "target_rgb": target,
        "image_ids": image_ids,
        "timestep_ids": ds.imageid_to_timestepid[image_ids],
        "train_indicator": ds.train_indicator[image_ids],
        "test_indicator": ds.test_indicator[image_ids],
    }
