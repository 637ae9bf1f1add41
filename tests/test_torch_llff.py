"""The port's LLFF loaders (`nonrigid_nerf_torch/data/llff.py`) and image
files (`utils/image_io.py`) against the JAX package's, exactly: the
multi-view scene data_r5/occlusion/ of this repository, a monocular
`precomputed.json` sequence and a monocular `poses_bounds.npy` sequence
written here, at factors 1 and 2."""

import os
import pathlib

import imageio.v2 as imageio
import numpy as np
import pytest

from nonrigid_nerf_torch import data as t_data
from nonrigid_nerf_torch.utils.image_io import imread, imwrite
from nonrigid_nerf_tpu import data as j_data
from tests.test_data import write_synthetic_sequence

REPO = pathlib.Path(__file__).resolve().parent.parent
OCCLUSION = str(REPO / "data_r5" / "occlusion")
SCALE300 = REPO / "data_r5" / "scale300" / "images"


def assert_same(a, b):
    """Equal values, types and shapes, recursively."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def write_poses_bounds_sequence(root, n=5, H=12, W=16):
    """A standard LLFF folder: images/ and poses_bounds.npy ((N, 17): the
    [down right back] 3x5 pose and the two bounds)."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.RandomState(1)
    rows = []
    for i in range(n):
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        imageio.imwrite(os.path.join(root, "images", f"{i:03d}.png"), img)
        a = 0.1 * i
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]])
        pose = np.concatenate([rot, [[0.1 * i], [0.05 * i], [1.0]],
                               [[H], [W], [20.0]]], 1)
        rows.append(np.concatenate([pose.ravel(), [2.0 + 0.1 * i, 8.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))


@pytest.fixture(scope="module")
def monocular(tmp_path_factory):
    root = tmp_path_factory.mktemp("mono")
    write_synthetic_sequence(str(root), n=5, H=12, W=16)
    return str(root)


@pytest.fixture(scope="module")
def poses_bounds(tmp_path_factory):
    root = tmp_path_factory.mktemp("pb")
    write_poses_bounds_sequence(str(root))
    return str(root)


@pytest.mark.parametrize("factor", [1, 2])
def test_multi_view_loader_matches_jax_on_occlusion(factor):
    out = t_data.load_llff_data_multi_view(OCCLUSION, factor=factor)
    ref = j_data.load_llff_data_multi_view(OCCLUSION, factor=factor)
    assert out[0].shape == (60, 192 // factor, 256 // factor, 3)
    assert_same(out, ref)
    images, poses = out[0], out[1]
    extras = t_data.get_multi_view_mappings(len(images), OCCLUSION)
    assert_same(extras, j_data.get_multi_view_mappings(len(images), OCCLUSION))
    assert extras["is_multiview"] and len(extras["raw_timesteps"]) == 20
    intr = t_data.get_intrinsics(OCCLUSION, extras, images, poses[0, :3, 4],
                                 factor=factor, ray_bending_latent_size=32)
    assert_same(intr, j_data.get_intrinsics(
        OCCLUSION, extras, images, poses[0, :3, 4], factor=factor,
        ray_bending_latent_size=32))
    assert sorted(intr) == [0, 1, 2]


@pytest.mark.parametrize("factor", [1, 2])
def test_monocular_precomputed_loader_matches_jax(monocular, factor):
    out = t_data.load_llff_data(monocular, factor=factor)
    ref = j_data.load_llff_data(monocular, factor=factor)
    assert out[0].shape == (5, 12 // factor, 16 // factor, 3)
    assert_same(out, ref)
    images, poses = out[0], out[1]
    extras = t_data.get_multi_view_mappings(len(images), monocular)
    assert_same(extras, j_data.get_multi_view_mappings(len(images), monocular))
    assert not extras["is_multiview"]
    assert_same(t_data.get_intrinsics(monocular, extras, images,
                                      poses[0, :3, 4], factor=factor,
                                      ray_bending_latent_size=8),
                j_data.get_intrinsics(monocular, extras, images,
                                      poses[0, :3, 4], factor=factor,
                                      ray_bending_latent_size=8))


@pytest.mark.parametrize("factor", [1, 2])
def test_poses_bounds_loader_matches_jax(poses_bounds, factor):
    out = t_data.load_llff_data(poses_bounds, factor=factor)
    ref = j_data.load_llff_data(poses_bounds, factor=factor)
    assert out[2].shape == (5, 2) and out[3].shape == (120, 3, 4)
    assert_same(out, ref)


def test_loader_without_poses_raises_as_jax(tmp_path):
    os.makedirs(tmp_path / "images")
    imageio.imwrite(tmp_path / "images" / "a.png", np.zeros((4, 4, 3), np.uint8))
    for loader in (t_data.load_llff_data, j_data.load_llff_data):
        with pytest.raises(FileNotFoundError, match="neither"):
            loader(str(tmp_path))


@pytest.mark.parametrize("blocks", [(0, 0), (3, 2), (1, 1), (4, 7)])
def test_block_train_test_split_matches_jax(blocks):
    extras = t_data.get_multi_view_mappings(60, OCCLUSION)
    args = (len(extras["raw_timesteps"]), extras["imageid_to_timestepid"],
            *blocks)
    i_train, i_test = t_data.block_train_test_split(*args)
    assert_same((i_train, i_test), j_data.block_train_test_split(*args))
    assert len(i_train) + len(i_test) == 60


def test_adaptive_spiral_matches_jax():
    poses = t_data.load_llff_data_multi_view(OCCLUSION, factor=4)[1]
    out = t_data.adaptive_spiral_poses(poses, 2.2, 7.5, n_views=30, n_rots=2)
    assert out.shape == (30, 3, 4)
    assert_same(out, j_data.adaptive_spiral_poses(poses, 2.2, 7.5, n_views=30,
                                                  n_rots=2))


def test_imread_equals_imageio_on_the_repository_scenes():
    """Every occlusion PNG and three scale300 PNGs (1280 x 720, mostly
    Paeth-filtered rows) decode to imageio's arrays."""
    files = sorted((REPO / "data_r5" / "occlusion" / "images").glob("*.png"))
    assert len(files) == 60
    files += sorted(SCALE300.glob("*.png"))[::300][:3]
    assert len(files) == 63
    for f in files:
        a, b = imread(str(f)), imageio.imread(f)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=str(f))


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16", "palette",
                                  "interlaced", "jpeg"])
def test_imread_equals_imageio_on_other_files(kind, tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    path = str(tmp_path / ("x.jpg" if kind == "jpeg" else "x.png"))
    rgb = (rng.rand(9, 11, 3) * 255).astype(np.uint8)
    if kind == "gray":
        Image.fromarray(rgb[..., 0]).save(path)
    elif kind in ("rgb", "jpeg"):
        Image.fromarray(rgb).save(path)
    elif kind == "rgba":
        Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1)).save(path)
    elif kind == "gray16":
        Image.fromarray((rng.rand(9, 11) * 65535).astype(np.uint16)).save(path)
    elif kind == "palette":
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(path)
    else:
        Image.fromarray(rgb).save(path, interlace=1)
    a, b = imread(path), imageio.imread(path)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_imwrite_round_trips(tmp_path):
    rng = np.random.RandomState(2)
    for shape in ((7, 5), (7, 5, 3), (7, 5, 4)):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        path = str(tmp_path / f"r{len(shape)}_{shape[-1]}.png")
        imwrite(path, img)
        np.testing.assert_array_equal(imread(path), img)
        np.testing.assert_array_equal(imageio.imread(path), img)
    with pytest.raises(ValueError, match="uint8"):
        imwrite(str(tmp_path / "f.png"), np.zeros((2, 2, 3), np.float32))
