"""The port's reference-checkpoint interop (`nonrigid_nerf_torch/interop.py`)
held against the JAX package's (`nonrigid_nerf_tpu/interop.py`), with the
tars built as tests/test_interop.py builds them (no reference checkout is
needed): a reference tar goes into the port (its model and Adam state) and
out as a tar again, which the JAX package reads back bit for bit; an
imported reference experiment equals the JAX package's import and renders
with the port's free-viewpoint CLI; an exported experiment equals the JAX
package's export."""

import os

import jax
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch import interop as t_interop
from nonrigid_nerf_torch.checkpoints import read_checkpoint, write_checkpoint
from nonrigid_nerf_torch.weights import (named_from_tree, params_from_jax,
                                         params_to_jax, tree_from_named)
from nonrigid_nerf_tpu import interop as j_interop
from nonrigid_nerf_tpu.config import TrainConfig
from nonrigid_nerf_tpu.engine.train_state import init_params, make_optimizer
from tests.test_interop import _assert_tree_equal, _tiny_cfg

TINY = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32,
            N_samples=8, N_importance=8, skips=[2], ray_bending_latent_size=8)


def jax_state(seed, viewdirs=False, bender=True, num_timesteps=3):
    """JAX parameters with random latents and an Adam state with random
    moments (so that a swap or a missed transpose shows)."""
    cfg = _tiny_cfg(use_viewdirs=viewdirs,
                    ray_bending=("simple_neural" if bender else None))
    params = init_params(jax.random.PRNGKey(seed), cfg, num_timesteps)
    params["latents"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                          params["latents"].shape)
    opt_state = make_optimizer(TrainConfig()).init(params)
    leaves, treedef = jax.tree_util.tree_flatten(opt_state)
    rng = np.random.RandomState(seed)
    leaves = [np.asarray(rng.rand(*np.shape(x)), np.asarray(x).dtype)
              if np.ndim(x) else x for x in leaves]
    return params, jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("viewdirs,bender", [(False, True), (True, True),
                                             (False, False)])
def test_reference_tar_round_trip_through_the_port(tmp_path, viewdirs,
                                                   bender):
    params, opt_state = jax_state(0, viewdirs, bender)
    tar_in, tar_out = str(tmp_path / "in.tar"), str(tmp_path / "out.tar")
    j_interop.export_reference_tar(tar_in, params, step=7,
                                   opt_state=opt_state)

    ckpt = t_interop.load_reference_tar(tar_in)
    assert t_interop.describe_reference_tar(ckpt) == \
        j_interop.describe_reference_tar(ckpt)
    tree, info = t_interop.params_from_reference_tar(ckpt)
    mu, nu = t_interop.opt_state_from_reference_tar(ckpt, tree, info)
    # into the port's model and its Adam state by parameter name, and out
    cfg = t_config.ModelConfig(
        use_viewdirs=viewdirs,
        ray_bending=("simple_neural" if bender else None), **TINY)
    model = params_from_jax(tree, cfg, device="cpu")
    mu_named, nu_named = named_from_tree(mu, model), named_from_tree(nu, model)
    t_interop.export_reference_tar(
        tar_out, params_to_jax(model), info["global_step"],
        (tree_from_named(mu_named), tree_from_named(nu_named)))

    back = j_interop.load_reference_tar(tar_out)
    got, got_info = j_interop.params_from_reference_tar(back)
    assert got_info == j_interop.describe_reference_tar(
        j_interop.load_reference_tar(tar_in))
    _assert_tree_equal(got, params)
    got_state = j_interop.opt_state_from_reference_tar(
        back, got, got_info, make_optimizer(TrainConfig()))
    assert int(got_state[0].count) == 7
    _assert_tree_equal(got_state[0].mu, opt_state[0].mu)
    _assert_tree_equal(got_state[0].nu, opt_state[0].nu)
    # the two tars hold the same tensors, slot for slot
    want = torch.load(tar_in, weights_only=False)
    for key in ("network_fn_state_dict", "network_fine_state_dict",
                "ray_bender_state_dict"):
        a, b = back[key], want[key]
        assert (a is None) == (b is None)
        for name in (a or {}):
            if not name.startswith("views_linears") or viewdirs:
                assert torch.equal(a[name], b[name]), (key, name)
    assert set(back["optimizer_state_dict"]["state"]) == \
        set(want["optimizer_state_dict"]["state"])


def write_reference_experiment(tmp_path):
    """A reference experiment folder: args.txt in the reference's format,
    with reference-only flags, and a tar at step 10 (as
    tests/test_interop.py's TestImportCLI builds it)."""
    from tests.test_data import write_synthetic_sequence
    datadir = tmp_path / "data"
    datadir.mkdir()
    n, _, _, _ = write_synthetic_sequence(str(datadir), n=4, H=10, W=12)
    ref_logs = tmp_path / "ref_exp" / "logs"
    ref_logs.mkdir(parents=True)
    params = init_params(jax.random.PRNGKey(3), _tiny_cfg(skips=(4,)),
                         num_timesteps=n)
    for net in ("coarse", "fine"):    # a live density head at width 32
        params[net]["output"]["b"] = np.asarray(
            params[net]["output"]["b"]) + 1.0
    lines = {"datadir": str(datadir), "netdepth": 4, "netwidth": 32,
             "netdepth_fine": 4, "netwidth_fine": 32, "N_samples": 8,
             "N_importance": 8, "N_rand": 32, "chunk": 512, "netchunk": 512,
             "ray_bending": "simple_neural", "ray_bending_latent_size": 8,
             "use_viewdirs": "False", "multires": 10, "factor": 1,
             "no_batching": "True", "random_seed": 0, "no_reload": "True"}
    with open(ref_logs / "args.txt", "w") as f:
        for k in sorted(lines):
            f.write(f"{k} = {lines[k]}\n")
    opt_state = make_optimizer(TrainConfig()).init(params)
    j_interop.export_reference_tar(
        str(ref_logs / "000010.tar"), params, step=10, opt_state=opt_state,
        extras={"scripts_dict": {"near": 2.0, "far": 6.0}})
    return tmp_path / "ref_exp"


def test_import_equals_jax_and_renders(tmp_path):
    from nonrigid_nerf_torch.cli import free_viewpoint_rendering as t_fvr
    from nonrigid_nerf_torch.utils.image_io import imread
    import free_viewpoint_rendering as j_fvr

    src = write_reference_experiment(tmp_path)
    out_t, out_j = tmp_path / "port_exp", tmp_path / "jax_exp"
    with pytest.warns(UserWarning, match="dropped reference-only args"):
        summary = t_interop.import_reference_experiment(str(src), str(out_t))
    with pytest.warns(UserWarning, match="dropped reference-only args"):
        j_interop.import_reference_experiment(str(src), str(out_j))
    assert summary["step"] == 10

    step_t, params_t, extras_t, opt_t = read_checkpoint(
        str(out_t / "logs" / "latest.npz"), with_opt_state=True)
    step_j, params_j, extras_j, opt_j = read_checkpoint(
        str(out_j / "logs" / "latest.npz"), with_opt_state=True)
    assert step_t == step_j == 10 and extras_t == extras_j
    _assert_tree_equal(params_t, params_j)
    assert int(opt_t[0]["count"]) == int(opt_j[0]["count"]) == 10
    _assert_tree_equal(opt_t[0]["mu"], opt_j[0]["mu"])
    _assert_tree_equal(opt_t[0]["nu"], opt_j[0]["nu"])
    args_t = t_config.parse_config_file(str(out_t / "logs" / "args.txt"))
    args_j = t_config.parse_config_file(str(out_j / "logs" / "args.txt"))
    assert "no_batching" not in args_t and args_t["no_reload"] is False
    for key in ("expname", "rootdir"):
        args_t.pop(key), args_j.pop(key)
    assert args_t == args_j

    # the imported experiment renders with the port's CLI as with JAX's
    flags = ["--deformations", "train", "--camera_path", "fixed",
             "--fixed_view", "0"]
    got = t_fvr.free_viewpoint_rendering(t_fvr.build_parser().parse_args(
        ["--input", str(out_t), "--device", "cpu"] + flags))
    want = j_fvr.free_viewpoint_rendering(j_fvr.build_parser().parse_args(
        ["--input", str(out_j)] + flags))
    for name in ("rgb_000000.png", "rgb_000002.png", "disp_000001.png"):
        a = imread(os.path.join(got, name)).astype(int)
        b = imread(os.path.join(want, name)).astype(int)
        assert np.abs(a - b).max() <= 1, name


def test_export_experiment_equals_jax(tmp_path):
    params, opt_state = jax_state(5)
    logs = tmp_path / "exp" / "logs"
    logs.mkdir(parents=True)
    t_config.Args(lrate_decay=250, **TINY).dump(str(logs / "args.txt"))
    tree = jax.tree_util.tree_map(np.asarray, params)
    moments = tuple(jax.tree_util.tree_map(np.asarray, m)
                    for m in (opt_state[0].mu, opt_state[0].nu))
    write_checkpoint(str(logs / "latest.npz"), 1500, tree, moments,
                     {"scripts_dict": {"near": 2.0, "far": 6.0}})
    got = t_interop.export_experiment(str(tmp_path / "exp"),
                                      str(tmp_path / "port.tar"))
    j_interop.export_experiment(str(tmp_path / "exp"),
                                str(tmp_path / "jax.tar"))
    assert got["step"] == 1500
    a = j_interop.load_reference_tar(str(tmp_path / "port.tar"))
    b = j_interop.load_reference_tar(str(tmp_path / "jax.tar"))
    assert a["scripts_dict"] == b["scripts_dict"] == {"near": 2.0, "far": 6.0}
    _assert_tree_equal(j_interop.params_from_reference_tar(a)[0],
                       j_interop.params_from_reference_tar(b)[0])
    sa, sb = a["optimizer_state_dict"], b["optimizer_state_dict"]
    assert sa["param_groups"][0]["lr"] == pytest.approx(
        sb["param_groups"][0]["lr"], rel=1e-6)
    assert set(sa["state"]) == set(sb["state"])
    for idx in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][idx][k], sb["state"][idx][k])
