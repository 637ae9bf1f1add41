"""The port's ray dataset against `nonrigid_nerf_tpu/data/dataset.py` on the
same image stack and the same pixel indices (CPU). Both sides gather uint8
pixels and generate rays with the same f32 formulas: tolerance 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch.data import dataset as t_data
from nonrigid_nerf_tpu.data import dataset as j_data

N, H, W = 5, 7, 9


def _loader_outputs(seed=0, floats=False):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (N, H, W, 3)).astype(np.uint8)
    if floats:
        images = images.astype(np.float32) / 255.0
    poses = np.zeros((N, 3, 5), np.float32)
    for i in range(N):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        poses[i, :, :3] = q
        poses[i, :, 3] = rng.randn(3)
    intrinsics = {0: dict(focal_x=9.0, focal_y=9.5, center_x=4.5, center_y=3.5),
                  1: dict(focal_x=11.0, focal_y=10.0, center_x=4.0, center_y=3.0)}
    extras = {"imageid_to_viewid": [0, 1, 0, 1, 0],
              "imageid_to_timestepid": [0, 0, 1, 1, 2],
              "raw_timesteps": [0, 1, 2]}
    return images, poses, intrinsics, extras, np.array([0, 2, 4]), np.array([1, 3])


@pytest.mark.parametrize("floats", [False, True], ids=["uint8", "float"])
def test_build_ray_dataset_matches_jax(floats):
    args = _loader_outputs(floats=floats)
    t_ds = t_data.build_ray_dataset(*args, near=0.5, far=2.5, device="cpu")
    j_ds = j_data.build_ray_dataset(*args, near=0.5, far=2.5)
    assert t_ds.images.dtype == torch.uint8
    for name in ("images", "poses", "view_intrinsics", "imageid_to_viewid",
                 "imageid_to_timestepid", "train_indicator", "test_indicator"):
        np.testing.assert_array_equal(getattr(t_ds, name).numpy(),
                                      np.asarray(getattr(j_ds, name)), name)
    for name in ("height", "width", "num_timesteps", "near", "far",
                 "num_images"):
        assert getattr(t_ds, name) == getattr(j_ds, name), name
    assert t_ds.has_test_split


def test_sample_ray_batch_with_given_indices_matches_jax(monkeypatch):
    args = _loader_outputs(seed=1)
    t_ds = t_data.build_ray_dataset(*args, near=0.5, far=2.5, device="cpu")
    j_ds = j_data.build_ray_dataset(*args, near=0.5, far=2.5)
    n_rand = 40
    # the indices the JAX function draws from its key (dataset.py:97-100)
    key = jax.random.PRNGKey(3)
    k_img, k_x, k_y = jax.random.split(key, 3)
    ids = np.asarray(jax.random.randint(k_img, (n_rand,), 0, N))
    x = np.asarray(jax.random.randint(k_x, (n_rand,), 0, W))
    y = np.asarray(jax.random.randint(k_y, (n_rand,), 0, H))
    want = j_data.sample_ray_batch(key, j_ds, n_rand)
    got = t_data.sample_ray_batch(t_ds, n_rand, image_ids=torch.from_numpy(ids),
                                  x=torch.from_numpy(x), y=torch.from_numpy(y))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert got["image_ids"].dtype == torch.int64
    assert got["target_rgb"].dtype == torch.float32


def test_sample_ray_batch_draws_from_generator():
    t_ds = t_data.build_ray_dataset(*_loader_outputs(), near=0.5, far=2.5,
                                    device="cpu")
    a = t_data.sample_ray_batch(t_ds, 64, torch.Generator().manual_seed(1))
    b = t_data.sample_ray_batch(t_ds, 64, torch.Generator().manual_seed(1))
    c = t_data.sample_ray_batch(t_ds, 64, torch.Generator().manual_seed(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image_ids"], c["image_ids"])
    assert int(a["image_ids"].max()) < N and int(a["image_ids"].min()) >= 0
    assert set(a["train_indicator"].tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        (a["train_indicator"] + a["test_indicator"]).numpy(), np.ones(64))


def test_linear_pixel_index_is_int64_past_2_31():
    """A stack of more than 2^31 pixels: the JAX version computes the index
    in int32 and wraps; the port's index must not. A meta tensor stands for
    the stack (nothing that large is allocated)."""
    height, width = 720, 1280
    n_images = 2400                                   # 2.2e9 pixels
    ids = torch.tensor([0, 2330, n_images - 1], dtype=torch.int32)
    y = torch.tensor([0, 300, height - 1], dtype=torch.int32)
    x = torch.tensor([0, 7, width - 1], dtype=torch.int32)
    lin = t_data.linear_pixel_index(ids, y, x, height, width)
    assert lin.dtype == torch.int64
    want = [(i * height + r) * width + c
            for i, r, c in zip(ids.tolist(), y.tolist(), x.tolist())]
    assert lin.tolist() == want
    assert want[1] > 2 ** 31 and want[2] == n_images * height * width - 1
    # the int32 arithmetic of the JAX version wraps on the same indices
    wrapped = (jnp.asarray(ids.numpy()) * height + jnp.asarray(y.numpy())) \
        * width + jnp.asarray(x.numpy())
    assert int(wrapped[1]) != want[1]
    stack = torch.empty((n_images, height, width, 3), dtype=torch.uint8,
                        device="meta")
    assert stack.reshape(-1, 3)[lin.to("meta")].shape == (3, 3)


def test_build_ray_dataset_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_data.build_ray_dataset(*_loader_outputs(), near=0.5, far=2.5)
