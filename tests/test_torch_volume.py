"""The port's volume probe (`nonrigid_nerf_torch/utils/volume.py`) against
the JAX package's on the cameras of data_r5/occlusion: the same extent
(rtol 1e-5) and a cameras.obj with the same vertices and faces. The probe
reads the unbent sample points of a test-mode render, so it does not depend
on the weights."""

import dataclasses
import pathlib

import numpy as np
import pytest

from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.data import (get_intrinsics as t_get_intrinsics,
                                      get_multi_view_mappings,
                                      load_llff_data_multi_view)
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.utils.volume import determine_nerf_volume_extent
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig, RenderSettings
from nonrigid_nerf_tpu.utils.volume import \
    determine_nerf_volume_extent as j_determine_nerf_volume_extent
from tests.torch_parity import jax_params, torch_cfg

OCCLUSION = str(pathlib.Path(__file__).resolve().parent.parent / "data_r5"
                / "occlusion")
CFG = ModelConfig(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32,
                  skips=(), multires=4, N_samples=16, N_importance=8,
                  bending_width=16, rigidity_width=8)
RS = RenderSettings(N_samples=16, N_importance=8, perturb=1.0,
                    raw_noise_std=1.0, near=2.2 * 0.9, far=7.5)
T_RS = t_config.RenderSettings(**dataclasses.asdict(RS))


@pytest.fixture(scope="module")
def cameras():
    images, poses, bds, _, _ = load_llff_data_multi_view(OCCLUSION, factor=4)
    extras = get_multi_view_mappings(len(images), OCCLUSION)
    intrinsics = t_get_intrinsics(OCCLUSION, extras, images, poses[0, :3, 4],
                                  factor=4, ray_bending_latent_size=32)
    per_image = [intrinsics[extras["imageid_to_viewid"][i]]
                 for i in range(len(images))]
    return poses[:, :3, :4], per_image


def obj_lines(path):
    verts, faces = [], []
    for line in open(path):
        kind, *vals = line.split()
        if kind == "v":
            verts.append([float(v) for v in vals])
        else:
            assert kind == "f"
            faces.append(vals)
    return np.asarray(verts), faces


def test_probe_matches_jax_on_occlusion(cameras, tmp_path):
    poses, intrinsics = cameras
    tree = jax_params(CFG, num_timesteps=20)
    model = params_from_jax(tree, torch_cfg(CFG), device="cpu")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    lo, hi = determine_nerf_volume_extent(
        model, torch_cfg(CFG), T_RS, poses, intrinsics,
        output_folder=str(tmp_path / "t"))
    jlo, jhi = j_determine_nerf_volume_extent(
        tree, CFG, RS, poses, intrinsics, output_folder=str(tmp_path / "j"))
    assert lo.shape == hi.shape == (3,) and np.all(lo < hi)
    np.testing.assert_allclose(lo, jlo, rtol=1e-5)
    np.testing.assert_allclose(hi, jhi, rtol=1e-5)
    verts, faces = obj_lines(tmp_path / "t" / "cameras.obj")
    jverts, jfaces = obj_lines(tmp_path / "j" / "cameras.obj")
    # 60 cameras x 4 corner rays: 3 vertices a ray, 3 a camera
    assert verts.shape == (3 * 240 + 3 * 60, 6)
    np.testing.assert_allclose(verts, jverts, rtol=1e-5, atol=1e-6)
    assert faces == jfaces and len(faces) == 240 + 60


def test_probe_does_not_depend_on_the_weights(cameras):
    poses, intrinsics = cameras
    tcfg = torch_cfg(CFG)
    a = determine_nerf_volume_extent(NRNeRF(tcfg, 20, device="cpu"), tcfg,
                                     T_RS, poses, intrinsics)
    b = determine_nerf_volume_extent(
        params_from_jax(jax_params(CFG, seed=3, num_timesteps=20), tcfg,
                        device="cpu"), tcfg, T_RS, poses, intrinsics)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_probe_renders_all_corners_in_one_batch_through_mlp_fwd(cameras,
                                                                monkeypatch):
    """One render of the 240 corner rays: the canonical MLP's kernel wrapper
    twice (coarse and fine pass), on the bent points, which on a CUDA model
    launches `mlp_fwd`'s kernel on its points input."""
    poses, intrinsics = cameras
    # the kernel's architecture: the flagship's widths
    tcfg = torch_cfg(ModelConfig(N_samples=16, N_importance=8,
                                 fused_kernel="on"))
    calls = []
    real = t_query.mlp_fwd_points

    def spy(pts, mw, *args):
        calls.append(tuple(pts.shape))
        return real(pts, mw, *args)

    monkeypatch.setattr(t_query, "mlp_fwd_points", spy)
    determine_nerf_volume_extent(NRNeRF(tcfg, 20, device="cpu"), tcfg, T_RS,
                                 poses, intrinsics)
    assert [c[0] for c in calls] == [240 * 16, 240 * 24]
