"""Datasets of the port: the LLFF loaders (host, numpy) and the
device-resident ray dataset."""

from nonrigid_nerf_torch.data.llff import (
    load_llff_data, load_llff_data_multi_view, get_multi_view_mappings,
    get_intrinsics, block_train_test_split, adaptive_spiral_poses)
from nonrigid_nerf_torch.data.dataset import RayDataset, build_ray_dataset

__all__ = [
    "load_llff_data", "load_llff_data_multi_view", "get_multi_view_mappings",
    "get_intrinsics", "block_train_test_split", "adaptive_spiral_poses",
    "RayDataset", "build_ray_dataset",
]
