"""Shared helpers of the tests that hold nonrigid_nerf_torch against
nonrigid_nerf_tpu: JAX parameters from the JAX initializers (with the
zero-initialised bending/rigidity output layers perturbed, so bending is
exercised), as numpy trees, and the port's config of the same fields."""

import dataclasses

import jax
import numpy as np

from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_tpu.config import ModelConfig
from nonrigid_nerf_tpu.models import init_bending_params, init_nerf_params


def torch_cfg(cfg: ModelConfig) -> t_config.ModelConfig:
    return t_config.ModelConfig(**dataclasses.asdict(cfg))


def jax_params(cfg: ModelConfig, seed: int = 0, num_timesteps: int = 3,
               density_shift: float = 1.0):
    """A JAX parameter tree of numpy arrays. `density_shift` is added to the
    density bias of the output heads so that random networks render
    non-empty images."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    params = {"coarse": init_nerf_params(ks[0], cfg)}
    if cfg.N_importance > 0:
        params["fine"] = init_nerf_params(ks[1], cfg, cfg.netdepth_fine,
                                          cfg.netwidth_fine)
    if cfg.use_ray_bending:
        bender = init_bending_params(ks[2], cfg)
        w = bender["bend"][-1]["w"]
        bender["bend"][-1]["w"] = 0.05 * jax.random.normal(ks[3], w.shape)
        if "rigidity" in bender:
            w = bender["rigidity"][-1]["w"]
            bender["rigidity"][-1]["w"] = 0.3 * jax.random.normal(ks[4], w.shape)
        params["bender"] = bender
    params["latents"] = 0.1 * jax.random.normal(
        ks[5], (num_timesteps, cfg.ray_bending_latent_size))
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    for net in ("coarse", "fine"):
        if net in tree and cfg.use_viewdirs:
            tree[net]["alpha"]["b"][0] += density_shift
        elif net in tree:
            tree[net]["output"]["b"][3] += density_shift
    return tree


def jax_step_draws(key, step, n_rays, n_samples, n_importance,
                   dtype=np.float32):
    """The random numbers that one JAX training step draws, as numpy arrays
    keyed as the port's `draws`: the key splits of
    engine/train_step.py:56-57 and engine/render.py:121-124, and the
    `jax.random` calls of stratified_z_vals, raw2outputs (twice),
    sample_pdf and divergence_loss."""
    _, k_render, k_loss = jax.random.split(jax.random.fold_in(key, step), 3)
    return _draws_from_keys(k_render, k_loss, n_rays, n_samples,
                            n_importance, dtype)


def jax_parallel_step_draws(key, step, rank, n_local, n_samples,
                            n_importance, dtype=np.float32):
    """The random numbers that device `rank` of the JAX mesh step draws for
    its `n_local` rays, keyed as the port's `draws`: the step's render and
    loss keys with the device index folded in
    (parallel/mesh.py:81-82), then as `jax_step_draws`."""
    _, k_render, k_loss = jax.random.split(jax.random.fold_in(key, step), 3)
    return _draws_from_keys(jax.random.fold_in(k_render, rank),
                            jax.random.fold_in(k_loss, rank), n_local,
                            n_samples, n_importance, dtype)


def _draws_from_keys(k_render, k_loss, n_rays, n_samples, n_importance,
                     dtype):
    k_strat, k_noise0, k_pdf, k_noise1 = jax.random.split(k_render, 4)
    draws = {
        "t_rand": jax.random.uniform(k_strat, (n_rays, n_samples), dtype=dtype),
        "noise0": jax.random.normal(k_noise0, (n_rays, n_samples), dtype=dtype),
        "u": jax.random.uniform(k_pdf, (n_rays, n_importance), dtype=dtype),
        "noise1": jax.random.normal(
            k_noise1, (n_rays, n_samples + n_importance), dtype=dtype),
        "e": jax.random.normal(k_loss, (n_rays, n_samples, 3), dtype=dtype),
    }
    return {k: np.asarray(v) for k, v in draws.items()}


def ray_batch(n_rays, num_timesteps, seed=0, dtype=np.float32):
    """A fixed training batch from a numpy seed: rays towards -z, targets,
    timestep ids and a train/test indicator (every third ray is a test
    ray)."""
    rng = np.random.RandomState(seed)
    test = (np.arange(n_rays) % 3 == 2).astype(dtype)
    return {
        "rays_o": (0.1 * rng.randn(n_rays, 3)).astype(dtype),
        "rays_d": np.concatenate([0.4 * rng.randn(n_rays, 2),
                                  -np.ones((n_rays, 1))], 1).astype(dtype),
        "target_rgb": rng.uniform(0, 1, (n_rays, 3)).astype(dtype),
        "timestep_ids": rng.randint(0, num_timesteps, n_rays).astype(np.int32),
        "train_indicator": 1.0 - test,
        "test_indicator": test,
    }
