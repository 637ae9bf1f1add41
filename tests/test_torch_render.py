"""The port's renderer against the JAX `make_ray_renderer`, in test mode, on
the same rays and the same parameters (CPU).

- A narrow network with fused_kernel="off": both are f32 end to end.
  Observed max abs difference 3.6e-7 over all outputs; pinned at 1e-5 (the
  MLP's sums run in another order; the inverse-CDF resampling turns that
  into depth shifts of the same size).
- The flagship 8 x 256 with fused_kernel="on": the port runs `mlp_fwd`'s
  plain version, JAX runs `_mlp_core` in Pallas interpret mode. Observed
  max abs difference 4.7e-6 (rgb_map); pinned at 1e-4 (bf16 rounding flips
  inside the MLP, then the resampling).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.apps.render_path import render_path as t_render_path
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.engine.render import make_ray_renderer as t_renderer
from nonrigid_nerf_torch.engine.render import render_rays as t_render_rays
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import mlp_fwd
from nonrigid_nerf_torch.weights import params_from_jax
from nonrigid_nerf_tpu.apps.render_path import render_path as j_render_path
from nonrigid_nerf_tpu.config import EditConfig, ModelConfig, RenderSettings
from nonrigid_nerf_tpu.engine.render import make_ray_renderer as j_renderer
from nonrigid_nerf_tpu.engine.render import render_rays as j_render_rays
from tests.torch_parity import jax_params, torch_cfg

NARROW = ModelConfig(netwidth=32, netwidth_fine=32, bending_width=16,
                     rigidity_width=8, ray_bending_latent_size=8,
                     N_samples=8, N_importance=8, fused_kernel="off")
FLAGSHIP = ModelConfig(N_samples=8, N_importance=8, fused_kernel="on")
RS = RenderSettings(N_samples=8, N_importance=8, near=0.5, far=2.5)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fq.pl, "pallas_call", patched)


def _rays(n, latent_size, seed=0):
    rng = np.random.RandomState(seed)
    o = (0.1 * rng.randn(n, 3)).astype(np.float32)
    d = np.concatenate([0.4 * rng.randn(n, 2), -np.ones((n, 1))], 1)
    lat = (0.1 * rng.randn(n, latent_size)).astype(np.float32)
    return o, d.astype(np.float32), lat


def _t_edit(edit):
    return t_config.EditConfig(**dataclasses.asdict(edit))


def _t_rs(rs):
    return t_config.RenderSettings(**dataclasses.asdict(rs))


def render_port(cfg, rs, edit=EditConfig(), n=37, chunk=16):
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    o, d, lat = _rays(n, cfg.ray_bending_latent_size)
    out = t_renderer(torch_cfg(cfg), _t_rs(rs).test_mode(), _t_edit(edit),
                     chunk=chunk, device="cpu")(
        model, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lat))
    return out, (tree, o, d, lat)


def render_both(cfg, rs, edit=EditConfig(), n=37, chunk=16):
    out, (tree, o, d, lat) = render_port(cfg, rs, edit, n, chunk)
    ref = j_renderer(cfg, rs.test_mode(), edit, chunk=chunk)(
        tree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lat), None)
    return out, ref


def assert_outputs_close(out, ref, tol):
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=tol, atol=tol, err_msg=k)


def test_narrow_off_matches_jax():
    out, ref = render_both(NARROW, RS)
    assert out["rgb_map"].shape == (37, 3)
    assert float(out["acc_map"].min()) > 0.05      # the scene is not empty
    assert_outputs_close(out, ref, 1e-5)


def test_coarse_only_matches_jax():
    cfg = dataclasses.replace(NARROW, N_importance=0)
    out, ref = render_both(cfg, dataclasses.replace(RS, N_importance=0))
    assert_outputs_close(out, ref, 1e-5)


@pytest.mark.parametrize("edit", [
    EditConfig(rigidity_test_time_cutoff=0.5, test_time_scaling=2.0),
    EditConfig(nonrigid_object_removal_threshold=0.5),
    EditConfig(render_canonical=True),
], ids=["cutoff+scaling", "removal", "canonical"])
def test_scene_edits_match_jax(edit):
    cfg = dataclasses.replace(NARROW, fused_kernel="auto")
    out, ref = render_both(cfg, RS, edit)
    assert_outputs_close(out, ref, 1e-5)


def test_flagship_kernel_path_matches_pallas_interpret(interpret_pallas):
    out, ref = render_both(FLAGSHIP, RS, n=6, chunk=4)
    assert_outputs_close(out, ref, 1e-4)


def test_fused_path_reaches_mlp_fwd(monkeypatch):
    calls = []

    def spy(emb, mw):
        calls.append(tuple(emb.shape))
        return mlp_fwd(emb, mw)

    monkeypatch.setattr(t_query, "mlp_fwd", spy)
    render_port(FLAGSHIP, RS, n=6, chunk=4)
    # 2 blocks x (coarse 4 x 8 points, fine 4 x 16 points)
    assert calls == [(32, 64), (64, 64)] * 2


def test_render_path_matches_jax(tmp_path):
    cfg = NARROW
    tree = jax_params(cfg, num_timesteps=2)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    intr = [dict(height=6, width=5, focal_x=6.0, focal_y=6.0, center_x=2.5,
                 center_y=3.0)] * 2
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[1, 0, 3] = 0.1
    rgbs, disps = t_render_path(model, torch_cfg(cfg), _t_rs(RS), poses, intr,
                                tree["latents"], chunk=16, savedir=str(tmp_path),
                                verbose=False, device="cpu")
    jrgbs, jdisps = j_render_path(tree, cfg, RS, poses, intr, tree["latents"],
                                  chunk=16, verbose=False)
    assert rgbs.shape == (2, 6, 5, 3) and disps.shape == (2, 6, 5)
    np.testing.assert_allclose(rgbs, jrgbs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(disps, jdisps, rtol=1e-5, atol=1e-5)
    assert np.load(tmp_path / "001.npy").dtype == np.uint8
    assert np.load(tmp_path / "disp_001.npy").max() == 1.0


def test_downscale_intrinsics():
    from nonrigid_nerf_torch.apps.render_path import downscale_intrinsics
    intr = [dict(height=384, width=512, focal_x=400.0, focal_y=410.0,
                 center_x=256.0, center_y=192.0)]
    (small,) = downscale_intrinsics(intr, 4)
    assert (small["height"], small["width"]) == (96, 128)
    assert small["focal_x"] == 100.0 and small["center_y"] == 48.0
    assert downscale_intrinsics(intr, 0) is intr


class TestFusedKernelPredicate:
    CPU = torch.device("cpu")
    CUDA = torch.device("cuda")     # a device object only: nothing runs there

    def cfg(self, mode, **kw):
        return t_config.ModelConfig(fused_kernel=mode, **kw)

    def test_auto_follows_device(self):
        edit = t_config.EditConfig()
        assert t_query.use_fused_kernel(self.cfg("auto"), edit, self.CUDA)
        assert not t_query.use_fused_kernel(self.cfg("auto"), edit, self.CPU)
        assert t_query.use_fused_kernel(self.cfg("on"), edit, self.CPU)
        assert not t_query.use_fused_kernel(self.cfg("off"), edit, self.CUDA)

    def test_edit_turns_auto_off_and_on_raises(self):
        edit = t_config.EditConfig(test_time_scaling=2.0)
        assert not t_query.use_fused_kernel(self.cfg("auto"), edit, self.CUDA)
        with pytest.raises(ValueError, match="outside the kernel's support"):
            t_query.use_fused_kernel(self.cfg("on"), edit, self.CUDA)

    def test_unsupported_architecture(self):
        edit = t_config.EditConfig()
        assert not t_query.use_fused_kernel(self.cfg("auto", netwidth=128),
                                            edit, self.CUDA)
        with pytest.raises(ValueError):
            t_query.use_fused_kernel(self.cfg("on", netdepth_fine=6), edit,
                                     self.CUDA)

    @pytest.mark.parametrize("mode", ["pts", "int8"])
    def test_unported_modes_raise(self, mode):
        """The two opt-in modes are ported: both take the kernels on either
        device. What raises now is a mode that does not exist, and "pts"
        outside its support; "int8" outside its support takes the f32 path
        (tests/test_torch_mlpe_kernel.py, tests/test_torch_quant.py)."""
        edit = t_config.EditConfig()
        assert t_query.use_fused_kernel(self.cfg(mode), edit, self.CUDA)
        assert t_query.use_fused_kernel(self.cfg(mode), edit, self.CPU)
        with pytest.raises(ValueError, match="unknown fused_kernel"):
            t_query.use_fused_kernel(self.cfg(mode + "2"), edit, self.CUDA)
        views = self.cfg(mode, use_viewdirs=True)
        if mode == "pts":
            with pytest.raises(ValueError, match="outside the kernel"):
                t_query.use_fused_kernel(views, edit, self.CUDA)
        else:
            assert not t_query.use_fused_kernel(views, edit, self.CUDA)

    def test_renderer_checks_mode_when_built(self):
        with pytest.raises(ValueError):
            t_renderer(self.cfg("on"), t_config.RenderSettings(),
                       t_config.EditConfig(render_canonical=True),
                       device="cpu")


def test_random_render_draws_from_generator():
    cfg = NARROW
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    o, d, lat = _rays(10, 8)
    rs = dataclasses.replace(_t_rs(RS), perturb=1.0, raw_noise_std=1.0)
    render = t_renderer(torch_cfg(cfg), rs, chunk=8, device="cpu")
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lat))
    a = render(model, *args, generator=torch.Generator().manual_seed(1))
    b = render(model, *args, generator=torch.Generator().manual_seed(1))
    c = render(model, *args, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a["rgb_map"], b["rgb_map"])
    assert not torch.equal(a["rgb_map"], c["rgb_map"])
    assert torch.isfinite(a["rgb_map"]).all()


def test_jax_reference_is_on_cpu():
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("name", ["default.txt", "example_sequence.txt"])
def test_config_file_reads_like_jax(name):
    from nonrigid_nerf_tpu import config as j_config
    path = str(pathlib.Path(__file__).resolve().parent.parent / "configs" / name)
    t_args, j_args = t_config.load_args(path), j_config.load_args(path)
    assert (dataclasses.asdict(t_config.model_config_from_args(t_args))
            == dataclasses.asdict(j_config.model_config_from_args(j_args)))
    assert (dataclasses.asdict(t_config.render_settings_from_args(t_args, 0.1, 2.0))
            == dataclasses.asdict(j_config.render_settings_from_args(j_args, 0.1, 2.0)))
    assert t_args.chunk == j_args.chunk


def _render_rays_both(cfg, rs, n=12, key=None, **flags):
    """`render_rays` of both packages on the same rays; with a key, the
    port gets the JAX draws as tensors (the key split of render.py:121-124
    and the jax.random calls of the JAX ops)."""
    tree = jax_params(cfg)
    model = params_from_jax(tree, torch_cfg(cfg), device="cpu")
    o, d, lat = _rays(n, cfg.ray_bending_latent_size, seed=5)
    draws = None
    if key is not None:
        k_strat, k_noise0, k_pdf, k_noise1 = jax.random.split(key, 4)
        S, I = rs.N_samples, rs.N_importance
        draws = {"t_rand": jax.random.uniform(k_strat, (n, S)),
                 "noise0": jax.random.normal(k_noise0, (n, S)),
                 "u": jax.random.uniform(k_pdf, (n, I)),
                 "noise1": jax.random.normal(k_noise1, (n, S + I))}
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    with torch.no_grad():
        out = t_render_rays(model, torch_cfg(cfg), _t_rs(rs),
                            torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(lat), draws=draws, **flags)
    ref = j_render_rays(tree, cfg, rs, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(lat), key=key, **flags)
    return out, ref


DETAIL_KEYS = {"initial_input_pts", "input_pts", "unmasked_offsets",
               "rigidity_mask", "masked_offsets"}


@pytest.mark.parametrize("fine_detailed", [None, False],
                         ids=["fine-detailed", "coarse-only"])
def test_detailed_and_retraw_match_jax(fine_detailed):
    """The per-sample internals the training losses read, with the training
    draws (jitter, density noise, importance samples) passed in."""
    rs = dataclasses.replace(RS, perturb=1.0, raw_noise_std=1.0)
    out, ref = _render_rays_both(NARROW, rs, key=jax.random.PRNGKey(4),
                                 detailed=True, retraw=True,
                                 fine_detailed=fine_detailed)
    assert_outputs_close(out, ref, 1e-5)
    want = DETAIL_KEYS | {"visibility_weights", "opacity_alpha", "raw"}
    assert want <= set(out)
    has_fine = {k for k in out if k.startswith("fine_")}
    if fine_detailed is None:
        assert has_fine == {"fine_" + k for k in DETAIL_KEYS} | {
            "fine_visibility_weights", "fine_opacity_alpha"}
        assert out["fine_unmasked_offsets"].shape == (12, 16, 3)
    else:
        assert not has_fine
    assert out["raw"].shape == (12, 16, 4)
    assert out["unmasked_offsets"].shape == (12, 8, 3)


def test_detailed_without_bending_or_importance_matches_jax():
    cfg = dataclasses.replace(NARROW, ray_bending=None, N_importance=0)
    rs = dataclasses.replace(RS, N_importance=0).test_mode()
    out, ref = _render_rays_both(cfg, rs, detailed=True, retraw=True)
    assert_outputs_close(out, ref, 1e-5)
    assert {"initial_input_pts", "input_pts", "raw"} <= set(out)
    assert "unmasked_offsets" not in out


@pytest.mark.parametrize("detailed", [False, True])
def test_stage1_reuse_off_matches_jax(detailed):
    """The reference's way: the sorted union is bent and encoded again."""
    cfg = dataclasses.replace(NARROW, stage1_reuse=False)
    rs = dataclasses.replace(RS, perturb=1.0, raw_noise_std=1.0)
    out, ref = _render_rays_both(cfg, rs, key=jax.random.PRNGKey(5),
                                 detailed=detailed, retraw=True)
    assert_outputs_close(out, ref, 1e-5)
    # and it renders what the reuse path renders, up to f32 rounding
    reuse, _ = _render_rays_both(NARROW, rs, key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(out["rgb_map"].numpy(), reuse["rgb_map"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_draws_replace_the_generator_and_unknown_keys_raise():
    cfg = NARROW
    model = params_from_jax(jax_params(cfg), torch_cfg(cfg), device="cpu")
    o, d, lat = (torch.from_numpy(a) for a in _rays(5, 8))
    rs = dataclasses.replace(_t_rs(RS), perturb=1.0, raw_noise_std=1.0)
    rng = np.random.RandomState(0)
    draws = {"t_rand": torch.from_numpy(rng.uniform(size=(5, 8)).astype(np.float32)),
             "noise0": torch.from_numpy(rng.randn(5, 8).astype(np.float32)),
             "u": torch.from_numpy(rng.uniform(size=(5, 8)).astype(np.float32)),
             "noise1": torch.from_numpy(rng.randn(5, 16).astype(np.float32))}
    with torch.no_grad():
        a = t_render_rays(model, torch_cfg(cfg), rs, o, d, lat, draws=draws,
                          generator=torch.Generator().manual_seed(1))
        b = t_render_rays(model, torch_cfg(cfg), rs, o, d, lat, draws=draws,
                          generator=torch.Generator().manual_seed(2))
    assert torch.equal(a["rgb_map"], b["rgb_map"])     # nothing left to draw
    with pytest.raises(ValueError, match="unknown draws"):
        t_render_rays(model, torch_cfg(cfg), rs, o, d, lat,
                      draws={"noise": draws["noise0"]})


def test_fused_training_render_goes_through_mlp_core(monkeypatch):
    """Under autograd the fused path calls `MLPCore` (f32 encoding in), with
    no gradient recorded it calls `mlp_fwd` (bf16 encoding in)."""
    from nonrigid_nerf_torch.ops.kernels.mlp_bwd import MLPCore
    seen = []
    orig_apply = MLPCore.apply
    monkeypatch.setattr(t_query.MLPCore, "apply", staticmethod(
        lambda emb, *w: seen.append(("core", emb.dtype)) or orig_apply(emb, *w)))
    monkeypatch.setattr(t_query, "mlp_fwd", lambda emb, mw: seen.append(
        ("fwd", emb.dtype)) or mlp_fwd(emb, mw))
    tree = jax_params(FLAGSHIP)
    model = params_from_jax(tree, torch_cfg(FLAGSHIP), device="cpu")
    o, d, lat = (torch.from_numpy(a) for a in _rays(3, 32))
    args = (model, torch_cfg(FLAGSHIP), _t_rs(RS).test_mode(), o, d, lat)
    out = t_render_rays(*args)
    assert seen == [("core", torch.float32)] * 2
    (g,) = torch.autograd.grad(out["rgb_map"].sum(),
                               [model.fine.pts[0].weight])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    seen.clear()
    with torch.no_grad():
        t_render_rays(*args)
    assert seen == [("fwd", torch.bfloat16)] * 2
