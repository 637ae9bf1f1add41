"""Host-side visualization helpers, numpy only
(counterpart of nonrigid_nerf_tpu/utils/viz.py).

Same artifact set as the reference (reference: run_nerf_helpers.py:701-915):
jet-colored disparity/error maps, a Blinn-Phong shaded relief of the
disparity, and OBJ line meshes of bent/unbent rays for inspecting the
deformation field.
"""

from __future__ import annotations

import numpy as np


def _jet_table() -> np.ndarray:
    """256-entry jet colormap: matplotlib's where it imports, else the
    analytic jet (as the JAX package chooses)."""
    try:
        from matplotlib import cm
    except ImportError:
        x = np.linspace(0.0, 1.0, 256)

        def channel(x, center):
            return np.clip(1.5 - 4.0 * np.abs(x - center), 0.0, 1.0)

        return np.stack([channel(x, 0.75), channel(x, 0.5),
                         channel(x, 0.25)], -1)
    return np.array([cm.jet(i)[:3] for i in range(256)])


def disparity_to_jet(value_map: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] to jet RGB (reference:
    visualize_disparity_with_jet_color_scheme)."""
    table = _jet_table()
    idx = (255.0 * np.clip(value_map, 0.0, 1.0)).astype(np.uint8)
    return table[idx.flatten()].reshape(value_map.shape + (3,))


def disparity_to_blinn_phong(depth_map: np.ndarray) -> np.ndarray:
    """Shaded-relief rendering of a normalized disparity map via the
    Blinn-Phong reflection model (reference:
    visualize_disparity_with_blinn_phong)."""
    light_pos = np.array([1.0, 1.0, 1.0])
    light_color = np.array([1.0, 1.0, 1.0])
    light_power = 2.0
    ambient = np.array([0.1, 0.0, 0.0])
    diffuse = np.array([0.5, 0.0, 0.0])
    specular_color = np.array([1.0, 1.0, 1.0])
    shininess = 2.0

    height, width = depth_map.shape
    spacing = 2.0 / (height - 1)
    zy, zx = np.gradient(depth_map, spacing)
    normal = np.dstack((-zx, zy, np.ones_like(depth_map)))
    normal /= np.linalg.norm(normal, axis=2, keepdims=True)

    i, j = np.meshgrid(np.arange(width, dtype=np.float32) / width,
                       np.arange(height, dtype=np.float32) / width,
                       indexing="xy")
    vert_pos = np.stack([i, j, depth_map], axis=-1)

    light_dir = light_pos.reshape(1, 1, 3) - vert_pos
    distance = np.linalg.norm(light_dir, axis=2, keepdims=True)
    light_dir = light_dir / distance
    distance = (distance + 1.0) ** 2

    lambertian = np.clip(np.sum(light_dir * normal, -1), 0.0, None)
    lambertian = lambertian.reshape(height, width, 1)
    invalid = lambertian <= 0.0

    def normalize(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    view_dir = normalize(-vert_pos)
    half_dir = normalize(light_dir + view_dir)
    spec_angle = np.clip(np.sum(half_dir * -normal, -1), 0.0, None)
    spec = (spec_angle.reshape(height, width, 1)) ** shininess
    spec[invalid] = 0.0

    color = (lambertian * diffuse * light_color * light_power / distance
             + spec * specular_color * light_color * light_power / distance
             + ambient)
    return color


def _obj_segments(point_rows: np.ndarray) -> str:
    """OBJ degenerate-triangle line segments between consecutive points of
    each row (rows: (R, S, 3))."""
    lines = []
    faces = []
    n = 0
    eps = 1e-5
    for row in point_rows:
        for a, b in zip(row[:-1], row[1:]):
            lines.append(f"v {a[0]} {a[1]} {a[2]}")
            lines.append(f"v {a[0] + eps} {a[1] + eps} {a[2] + eps}")
            lines.append(f"v {b[0]} {b[1]} {b[2]}")
            faces.append(f"f {3 * n + 1} {3 * n + 2} {3 * n + 3}")
            n += 1
    return "\n".join(lines + faces) + "\n"


def export_ray_bending_objs(initial_pts: np.ndarray, bent_pts: np.ndarray,
                            filename_prefix: str, subsample: int = 100,
                            rng: np.random.RandomState = None) -> None:
    """Write `<prefix>_bent.obj`, `<prefix>_not_bent.obj`,
    `<prefix>_deltas.obj` line meshes (reference: visualize_ray_bending)."""
    initial_pts = np.asarray(initial_pts).reshape(-1, initial_pts.shape[-2], 3)
    bent_pts = np.asarray(bent_pts).reshape(-1, bent_pts.shape[-2], 3)
    num_rays = bent_pts.shape[0]
    if subsample < num_rays:
        rng = rng or np.random.RandomState(0)
        idx = rng.choice(num_rays, size=subsample, replace=False)
    else:
        idx = np.arange(num_rays)

    with open(filename_prefix + "_bent.obj", "w") as f:
        f.write(_obj_segments(bent_pts[idx]))
    with open(filename_prefix + "_not_bent.obj", "w") as f:
        f.write(_obj_segments(initial_pts[idx]))
    # deltas: one segment from each initial point to its bent position
    pairs = np.stack([initial_pts[idx].reshape(-1, 3),
                      bent_pts[idx].reshape(-1, 3)], axis=1)
    with open(filename_prefix + "_deltas.obj", "w") as f:
        f.write(_obj_segments(pairs))
