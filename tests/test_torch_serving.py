"""The port's serving export (`nonrigid_nerf_torch/serving.py`) on the CPU,
as tests/test_serving.py holds the JAX package's: the artifact renders what
the live renderer renders, bit for bit, and what JAX's `make_serving_fn`
renders on the same weights within SERVING_TOL (1e-5 absolute; observed
2e-7: the same f32 arithmetic, summed in another order); its meta describes
it; it loads and runs in a process that imports torch alone; `render_many`
pads and strips; the view-direction family exports."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import serving as t_serving
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.config import ModelConfig, RenderSettings, TrainConfig
from nonrigid_nerf_tpu.engine.train_state import create_train_state
from nonrigid_nerf_tpu.serving import make_serving_fn as j_serving_fn
from tests.torch_parity import torch_cfg

TINY = ModelConfig(netdepth=2, netwidth=32, netdepth_fine=2,
                   netwidth_fine=32, multires=4, N_samples=4,
                   N_importance=4, fused_kernel="off")
RS = RenderSettings(N_samples=4, N_importance=4, near=2.0, far=6.0)
CHUNK = 64
SERVING_TOL = 1e-5


def _t_rs(rs):
    from nonrigid_nerf_torch import config as t_config
    return t_config.RenderSettings(**dataclasses.asdict(rs))


def _model(cfg, seed, timesteps):
    params = create_train_state(jax.random.PRNGKey(seed), cfg, TrainConfig(),
                                timesteps).params
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tree, params_from_jax(tree, torch_cfg(cfg), device="cpu")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tree, model = _model(TINY, 0, 3)
    blob, meta = t_serving.export_renderer(model, torch_cfg(TINY), _t_rs(RS),
                                           chunk=CHUNK, device="cpu")
    path = str(tmp_path_factory.mktemp("serve") / "model.pt2")
    t_serving.save_exported(path, blob, meta)
    return tree, model, path


def _rays(n):
    rng = np.random.RandomState(3)
    rays_o = 0.1 * rng.randn(n, 3).astype(np.float32)
    rays_d = rng.randn(n, 3).astype(np.float32)
    rays_d[:, 2] -= 2.0
    latents = 0.05 * rng.randn(n, 32).astype(np.float32)
    return rays_o, rays_d, latents


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_artifact_equals_the_live_renderer_and_jax(artifact):
    tree, model, path = artifact
    render, _ = t_serving.load_exported(path)
    rays = _rays(CHUNK)
    got = render(*_t(rays))
    live = t_serving.make_serving_fn(model, torch_cfg(TINY), _t_rs(RS))(
        *_t(rays))
    assert set(got) == set(live) == {"rgb_map", "disp_map", "acc_map"}
    for k in got:
        assert torch.equal(got[k], live[k]), k
    want = jax.jit(j_serving_fn(tree, TINY, RS))(*rays)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=SERVING_TOL, atol=SERVING_TOL,
                                   err_msg=k)


def test_meta_is_self_describing(artifact):
    tree, _, path = artifact
    _, meta = t_serving.load_exported(path)
    assert meta["format"] == "nonrigid_nerf_torch.serving/1"
    assert meta["chunk"] == CHUNK and meta["latent_size"] == 32
    assert meta["device"] == "cpu" and "platforms" not in meta
    np.testing.assert_array_equal(np.asarray(meta["latent_table"], np.float32),
                                  tree["latents"])
    assert meta["near"] == 2.0 and meta["far"] == 6.0
    assert len(meta["inputs"]) == 3 and len(meta["outputs"]) == 3


def test_artifact_loads_in_a_process_that_imports_torch_alone(artifact,
                                                              tmp_path):
    """The deployment path: `torch.export.load` in a fresh interpreter that
    cannot import this package (another working directory, no path)."""
    _, model, path = artifact
    rays = _rays(CHUNK)
    np.savez(tmp_path / "rays.npz", *rays)
    code = (
        "import sys, numpy as np, torch\n"
        f"ep = torch.export.load({path!r})\n"
        f"r = np.load({str(tmp_path / 'rays.npz')!r})\n"
        "with torch.no_grad():\n"
        "    out = ep.module()(*(torch.from_numpy(r[f'arr_{i}'])\n"
        "                        for i in range(3)))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('nonrigid_nerf_torch', 'nonrigid_nerf_tpu', 'jax')]\n"
        "assert not bad, bad\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, "
        "**{k: v.numpy() for k, v in out.items()})\n")
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True,
                   timeout=300, env={"PATH": os.environ.get("PATH", ""),
                                     "HOME": str(tmp_path)})
    out = np.load(tmp_path / "out.npz")
    live = t_serving.make_serving_fn(model, torch_cfg(TINY), _t_rs(RS))(
        *_t(rays))
    for k, v in live.items():
        np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)


def test_render_many_pads_and_strips(artifact):
    """Any number of rays through the fixed-block artifact: the padded tail
    does not leak into the results."""
    _, model, path = artifact
    render, meta = t_serving.load_exported(path)
    n = CHUNK + 17
    rays = _t(_rays(n))
    got = t_serving.render_many(render, meta["chunk"], *rays)
    live = t_serving.make_serving_fn(model, torch_cfg(TINY), _t_rs(RS))(*rays)
    for k in got:
        assert got[k].shape[0] == n
        torch.testing.assert_close(got[k], live[k], rtol=0, atol=1e-6)


def test_viewdirs_model_exports(tmp_path):
    """The view-direction family (finite-difference and exact directions,
    the latter a jvp through the bender) exports through the same path."""
    rays = _rays(16)
    for approx in (True, False):
        cfg = dataclasses.replace(TINY, use_viewdirs=True,
                                  approx_nonrigid_viewdirs=approx)
        tree, model = _model(cfg, 2, 2)
        blob, meta = t_serving.export_renderer(
            model, torch_cfg(cfg), _t_rs(RS), chunk=16, device="cpu")
        path = str(tmp_path / f"vd_{approx}.pt2")
        t_serving.save_exported(path, blob, meta)
        render, _ = t_serving.load_exported(path)
        got = render(*_t(rays))
        live = t_serving.make_serving_fn(model, torch_cfg(cfg), _t_rs(RS))(
            *_t(rays))
        assert torch.equal(got["rgb_map"], live["rgb_map"])
        want = jax.jit(j_serving_fn(tree, cfg, RS))(*rays)
        np.testing.assert_allclose(got["rgb_map"].numpy(),
                                   np.asarray(want["rgb_map"]),
                                   rtol=SERVING_TOL, atol=SERVING_TOL)


def test_serving_fn_is_off_in_test_mode_and_asks_for_cuda(monkeypatch):
    from nonrigid_nerf_torch import config as t_config
    _, model = _model(TINY, 0, 3)
    cfg = dataclasses.replace(torch_cfg(TINY), fused_kernel="auto")
    rs = dataclasses.replace(_t_rs(RS), perturb=1.0, raw_noise_std=1.0)
    module = t_serving.ServingRenderer(model, cfg, rs)
    assert module.cfg.fused_kernel == "off"
    assert module.rs.perturb == 0.0 and module.rs.raw_noise_std == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serving.export_renderer(model, cfg, t_config.RenderSettings(),
                                  chunk=8)
    json.dumps(dataclasses.asdict(module.cfg))     # plain values only
