"""Readers for COLMAP's binary sparse-model format (a copy of
nonrigid_nerf_tpu/preprocessing/colmap_model.py: the port keeps its own).

The reference delegates this to the user ("please see the LLFF code",
reference: llff_preprocessing/pose_utils.py:1-5, README.md:25-29); here the
parsers are built in so `gen_poses` works out of the box against a COLMAP
binary. Format reference: COLMAP src/colmap/scene/reconstruction_io.cc
(public documented layout).
"""

from __future__ import annotations

import collections
import struct

import numpy as np

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height",
                                           "params"])
Image = collections.namedtuple("Image", ["id", "qvec", "tvec", "camera_id",
                                         "name", "xys", "point3d_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz", "rgb", "error"])

# model_id -> (name, number of parameters)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(fmt, f):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str):
    cameras = {}
    with open(path, "rb") as f:
        (num_cameras,) = _read("<Q", f)
        for _ in range(num_cameras):
            cam_id, model_id = _read("<ii", f)
            width, height = _read("<QQ", f)
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{num_params}d", f))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path: str):
    images = {}
    with open(path, "rb") as f:
        (num_images,) = _read("<Q", f)
        for _ in range(num_images):
            (image_id,) = _read("<i", f)
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            (camera_id,) = _read("<i", f)
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_points,) = _read("<Q", f)
            data = np.frombuffer(f.read(24 * num_points),
                                 dtype=np.dtype([("xy", "<f8", 2),
                                                 ("id", "<i8")]))
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode("utf-8"),
                                     data["xy"].copy(), data["id"].copy())
    return images


def read_points3d_binary(path: str):
    points = {}
    with open(path, "rb") as f:
        (num_points,) = _read("<Q", f)
        for _ in range(num_points):
            (pid,) = _read("<Q", f)
            xyz = np.array(_read("<3d", f))
            rgb = np.array(_read("<3B", f))
            (error,) = _read("<d", f)
            (track_len,) = _read("<Q", f)
            f.read(8 * track_len)  # (image_id, point2d_idx) pairs
            points[pid] = Point3D(pid, xyz, rgb, error)
    return points


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y],
    ])
