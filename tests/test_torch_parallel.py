"""The port's data parallelism (`nonrigid_nerf_torch/parallel/mesh.py`)
against the JAX package's mesh step and renderer on the virtual 8-device
CPU mesh, and against the port's own single-process step and renderer.

The port's side runs in W spawned gloo processes (`tests/torch_ranks.py`:
torch and the port only, never JAX), all of one W's cases in one process
group, while this process runs the JAX side. Cases, at W = 2 and 4:

(a) JAX `make_parallel_train_step` on `make_mesh(jax.devices()[:W])`
    against the port's step on JAX's global batches, each rank with its
    device's draws (`tests/torch_parity.py:jax_parallel_step_draws`), from
    the same weights; metrics and parameters after 1 and 3 steps, with
    fused_kernel "off" and "on" (the port's plain versions of the kernels,
    JAX's `_mlp_core` in Pallas interpret mode). Tolerances are
    tests/test_torch_train_step.py's for one step; see `TOL` there. After 3
    "on" steps an entry may have flipped at each step: 2 lrate for the
    first, 2 lrate / 19 for each of the others (observed: metrics 1.0e-2
    relative, parameters 2.06 lrate at worst and 0.033 lrate on a leaf's
    mean; "off": 8.6e-5 and 0.009 lrate).
(b) The W-rank port step against the single-process port step on the same
    generators: metrics to rtol 2e-5 (the JAX package's bound for its
    process topologies, tests/test_multihost.py:146; the sums run in
    another order), parameters to 0.05 lrate (an entry whose gradient is
    within rounding of 0 may take another Adam step, as in
    tests/test_torch_train_step.py), and the ranks' parameters and Adam
    moments identical (observed: 1.6e-7 and 1.1e-4 lrate).
(c) The parallel renderer on a ray count that needs padding, against JAX
    `make_parallel_renderer` (1e-5, tests/test_torch_render.py's bound for
    the narrow network; observed 3.6e-7) and the port's single-device
    renderer (the same arithmetic on each ray: 1e-6; observed equal).
(d) An N_rand that does not split over the ranks raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.sharding import NamedSharding, PartitionSpec

import nonrigid_nerf_tpu.ops.pallas.fused_query as fq
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.apps.train import step_generator
from nonrigid_nerf_torch.data.dataset import build_ray_dataset
from nonrigid_nerf_torch.engine.render import make_ray_renderer
from nonrigid_nerf_torch.engine.train_state import TrainState, zero_moments
from nonrigid_nerf_torch.engine.train_step import make_train_step
from nonrigid_nerf_torch.weights import params_from_jax, params_to_jax
from nonrigid_nerf_tpu.data import dataset as j_data
from nonrigid_nerf_tpu.engine import train_state as j_state
from nonrigid_nerf_tpu.parallel import (make_mesh, make_parallel_renderer,
                                        make_parallel_train_step)
from tests import torch_ranks
from tests.test_torch_train_step import (FLAGSHIP, NARROW, RS, TC, TOL,
                                         assert_tree_rel)
from tests.torch_parity import jax_params, jax_parallel_step_draws, torch_cfg

T = 3
STEPS = 3
KEY = 7
RENDER_RAYS, RENDER_CHUNK = 37, 8    # padded to 48 (W = 2) and 64 (W = 4)
RS_TEST = dataclasses.replace(RS, perturb=0.0, raw_noise_std=0.0)


def t_tc(tc):
    return t_config.TrainConfig(**dataclasses.asdict(tc))


def t_rs(rs):
    return t_config.RenderSettings(**dataclasses.asdict(rs))


def dataset_arrays(seed=0, n=4):
    """A 6 x 8 image stack seen from cameras looking down -z: three
    training images, one test image."""
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    poses[:, :2, 3] = 0.1 * rng.randn(n, 2)
    poses[:, 2, 3] = 1.5
    return (rng.randint(0, 256, (n, 6, 8, 3)).astype(np.uint8), poses,
            {0: dict(focal_x=8.0, focal_y=8.0, center_x=4.0, center_y=3.0)},
            {"imageid_to_viewid": [0] * n,
             "imageid_to_timestepid": [0, 1, 2, 2], "raw_timesteps": [0, 1, 2]},
            [0, 1, 2], [3], 0.5, 2.5)


def render_rays_arrays(tree, seed=1):
    rng = np.random.RandomState(seed)
    n = RENDER_RAYS
    rays_o = (0.1 * rng.randn(n, 3)).astype(np.float32)
    rays_d = np.concatenate([0.4 * rng.randn(n, 2), -np.ones((n, 1))],
                            1).astype(np.float32)
    latents = tree["latents"][rng.randint(0, T, n)]
    return rays_o, rays_d, latents


def jax_mesh_steps(cfg, tree, mesh, ds, n_steps):
    """JAX's mesh step from `tree`: metrics per step, parameters after
    each step (numpy)."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = j_state.TrainState(
        params=params, opt_state=j_state.make_optimizer(TC).init(params),
        step=jnp.asarray(0, jnp.int32))
    # replicated on the mesh from the start: one compile for every step
    state, ds = jax.device_put((state, ds),
                               NamedSharding(mesh, PartitionSpec()))
    step_fn = make_parallel_train_step(cfg, TC, RS, mesh,
                                       has_test_split=True, donate=False,
                                       debug_metrics=True)
    metrics, params = [], []
    for _ in range(n_steps):
        state, m = step_fn(state, ds, jax.random.PRNGKey(KEY))
        metrics.append({k: float(v) for k, v in m.items()})
        params.append(jax.tree_util.tree_map(np.asarray, state.params))
    return metrics, params


def given_batches(j_ds, world):
    """JAX's global batches and each device's draws for STEPS steps."""
    key = jax.random.PRNGKey(KEY)
    batches, draws = [], []
    for step in range(STEPS):
        k_batch, _, _ = jax.random.split(jax.random.fold_in(key, step), 3)
        batches.append({k: np.asarray(v) for k, v in
                        j_data.sample_ray_batch(k_batch, j_ds,
                                                TC.N_rand).items()})
        draws.append([jax_parallel_step_draws(
            key, step, r, TC.N_rand // world, RS.N_samples, RS.N_importance)
            for r in range(world)])
    return {"batches": batches, "draws": draws}


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def world_runs(request, tmp_path_factory):
    """Every case at one W: the port's ranks (spawned first), then the JAX
    side while they run."""
    world = request.param
    trees = {c.fused_kernel: jax_params(c, num_timesteps=T)
             for c in (NARROW, FLAGSHIP)}
    arrays = dataset_arrays()
    j_ds = j_data.build_ray_dataset(*arrays)
    given = given_batches(j_ds, world)
    cases = {f"given_{c.fused_kernel}": ("given_batch_steps", dict(
        given, tree=trees[c.fused_kernel], cfg=torch_cfg(c), tc=t_tc(TC),
        rs=t_rs(RS), keep=(1, STEPS))) for c in (NARROW, FLAGSHIP)}
    narrow = {"tree": trees["off"], "cfg": torch_cfg(NARROW), "tc": t_tc(TC),
              "rs": t_rs(RS)}
    cases["generator"] = ("generator_steps",
                          dict(narrow, dataset=arrays, steps=STEPS))
    rays = render_rays_arrays(trees["off"])
    cases["render"] = ("render", dict(narrow, rs=t_rs(RS_TEST), rays=rays,
                                      chunk=RENDER_CHUNK))
    cases["nondividing"] = ("nondividing",
                            dict(narrow, batches=given["batches"]))
    ranks = torch_ranks.Ranks(torch_ranks.all_cases, world,
                              tmp_path_factory.mktemp(f"ranks{world}"), cases)

    try:
        mesh = make_mesh(jax.devices()[:world])
        jax_runs = {"off": jax_mesh_steps(NARROW, trees["off"], mesh, j_ds,
                                          STEPS)}
        with pytest.MonkeyPatch.context() as mp:
            orig = pl.pallas_call
            mp.setattr(fq.pl, "pallas_call",
                       lambda *a, **k: orig(*a, **dict(k, interpret=True)))
            jax_runs["on"] = jax_mesh_steps(FLAGSHIP, trees["on"], mesh,
                                            j_ds, STEPS)
        renderer = make_parallel_renderer(NARROW, RS_TEST, mesh,
                                          chunk=RENDER_CHUNK)
        jax_render = {k: np.asarray(v) for k, v in renderer(
            jax.tree_util.tree_map(jnp.asarray, trees["off"]),
            *map(jnp.asarray, rays)).items()}
    finally:
        rank_results = ranks.results()      # joins (or kills) every rank
    return {"world": world, "ranks": rank_results, "jax": jax_runs,
            "jax_render": jax_render, "trees": trees, "arrays": arrays,
            "rays": rays}


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("mode", ["off", "on"])
def test_step_matches_jax_mesh_step(world_runs, mode, steps):
    """(a) After `steps` steps on JAX's batches and per-device draws."""
    tol_loss, tol_grad, _ = TOL[(mode, "float32")]
    j_metrics, j_params = world_runs["jax"][mode]
    lrate = TC.lrate
    for rank_result in world_runs["ranks"]:
        got = rank_result[f"given_{mode}"]
        for step in range(steps):
            assert set(got["metrics"][step]) == set(j_metrics[step])
            for k, v in got["metrics"][step].items():
                np.testing.assert_allclose(
                    v, j_metrics[step][k], rtol=max(5 * tol_loss, tol_grad),
                    err_msg=f"step {step + 1} {k}")
        if mode == "on":
            # bf16 gradients: an entry within rounding of 0 may change
            # sign, each step at most 2x its rate (the first at lrate)
            assert_tree_rel(got["params"][steps], j_params[steps - 1], 0.0,
                            atol=2 * lrate * (1 + (steps - 1) / 19),
                            mean_atol=0.05 * lrate)
        else:
            assert_tree_rel(got["params"][steps], j_params[steps - 1], 0.0,
                            atol=0.05 * lrate)


def test_step_matches_single_process(world_runs):
    """(b) The W-rank step against the single-process port step on the
    same (seed, step) generators."""
    cfg, tc, rs = torch_cfg(NARROW), t_tc(TC), t_rs(RS)
    ds = build_ray_dataset(*world_runs["arrays"], device="cpu")
    model = params_from_jax(world_runs["trees"]["off"], cfg, device="cpu")
    state = TrainState(model=model, mu=zero_moments(model),
                       nu=zero_moments(model))
    step_fn = make_train_step(cfg, tc, rs, has_test_split=True)
    want = [{k: float(v) for k, v in step_fn(
        state, ds, step_generator(tc.seed, step, "cpu")).items()}
        for step in range(STEPS)]
    for rank_result in world_runs["ranks"]:
        got = rank_result["generator"]
        for step in range(STEPS):
            assert set(got["metrics"][step]) == set(want[step])
            for k, v in want[step].items():
                np.testing.assert_allclose(got["metrics"][step][k], v,
                                           rtol=2e-5, err_msg=k)
        assert_tree_rel(got["params"], params_to_jax(model), 0.0,
                        atol=0.05 * TC.lrate)


def test_ranks_hold_identical_parameters(world_runs):
    """(b) One all-reduce and the same Adam on every rank: parameters and
    moments bit-equal across the ranks, in every case."""
    first, *others = world_runs["ranks"]
    leaves0 = jax.tree_util.tree_leaves(
        [first["generator"]["params"], first["generator"]["mu"],
         first["given_off"]["params"], first["given_on"]["params"]])
    for other in others:
        leaves = jax.tree_util.tree_leaves(
            [other["generator"]["params"], other["generator"]["mu"],
             other["given_off"]["params"], other["given_on"]["params"]])
        assert len(leaves) == len(leaves0)
        for a, b in zip(leaves0, leaves):
            np.testing.assert_array_equal(a, b)
        assert other["generator"]["metrics"] == first["generator"]["metrics"]


@pytest.mark.parametrize("renderer", ["parallel", "auto"])
def test_renderer_matches_jax_mesh_renderer(world_runs, renderer):
    """(c) `make_parallel_renderer` and `make_auto_renderer` (which takes
    the group) against JAX `make_parallel_renderer` on the same mesh
    size, at a ray count that needs padding."""
    want = world_runs["jax_render"]
    for rank_result in world_runs["ranks"]:
        got = rank_result["render"][renderer]
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_renderer_matches_single_device(world_runs):
    """(c) The parallel renderer against `make_ray_renderer` on one
    process, on every rank."""
    import torch
    model = params_from_jax(world_runs["trees"]["off"], torch_cfg(NARROW),
                            device="cpu")
    single = make_ray_renderer(torch_cfg(NARROW), t_rs(RS_TEST),
                               chunk=RENDER_CHUNK, device="cpu")
    want = {k: v.numpy() for k, v in single(
        model, *map(torch.from_numpy, world_runs["rays"])).items()}
    for rank_result in world_runs["ranks"]:
        got = rank_result["render"]["parallel"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_nondividing_n_rand_raises(world_runs):
    """(d) At make time and on a given batch of W + 1 rays."""
    for messages in (r["nondividing"] for r in world_runs["ranks"]):
        assert len(messages) == 2
        for msg in messages:
            assert f"N_rand={world_runs['world'] + 1}" in msg
            assert f"{world_runs['world']} ranks" in msg
