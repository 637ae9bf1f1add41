"""The port's command-line tools on the CPU, on a small experiment:
`python3 -m nonrigid_nerf_torch.cli.export_serving` (against the JAX
package's tools/export_serving.py on the same experiment folder, within
1e-5 absolute) and the reference-checkpoint round trip,
`...cli.import_reference_checkpoint` then `...cli.export_reference_checkpoint`
(against tools/import_reference_checkpoint.py's folder, bit for bit)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tests.test_cli as jax_cli_tests
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.checkpoints import read_checkpoint
from nonrigid_nerf_torch.cli import export_reference_checkpoint as t_export_ref
from nonrigid_nerf_torch.cli import export_serving as t_export_serving
from nonrigid_nerf_torch.cli import import_reference_checkpoint as t_import_ref
from nonrigid_nerf_torch.cli import train as t_train_cli
from nonrigid_nerf_torch.cli.free_viewpoint_rendering import load_experiment
from nonrigid_nerf_torch.serving import load_exported, make_serving_fn
from nonrigid_nerf_tpu import interop as j_interop
from tests.test_data import write_synthetic_sequence
from tests.test_torch_interop import write_reference_experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The JAX CLI tests' tiny scene, trained 8 steps by the port's CLI."""
    root = tmp_path_factory.mktemp("tools")
    datadir = root / "data"
    datadir.mkdir()
    write_synthetic_sequence(str(datadir), n=4, H=32, W=36)
    cfg_path = root / "tiny.txt"
    cfg_path.write_text(jax_cli_tests.TINY_CONFIG.format(
        datadir=datadir, rootdir=root / "experiments"))
    t_train_cli.main(["--config", str(cfg_path), "--device", "cpu"])
    return str(root / "experiments" / "tiny_exp")


def test_export_serving_cli_with_an_edit_matches_jax(experiment, tmp_path,
                                                     capsys):
    out = str(tmp_path / "scene.pt2")
    t_export_serving.main(["--input", experiment, "--out", out, "--chunk",
                           "32", "--device", "cpu", "--motion_factor", "2"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"device": "cpu"' in printed and '"chunk": 32' in printed
    render, meta = load_exported(out)
    assert meta["edit"] == {"test_time_scaling": 2.0}
    assert meta["experiment"] == os.path.abspath(experiment)
    rng = np.random.RandomState(0)
    o = (0.1 * rng.randn(32, 3)).astype(np.float32)
    d = np.concatenate([0.3 * rng.randn(32, 2), -np.ones((32, 1))],
                       1).astype(np.float32)
    lat = np.tile(np.asarray(meta["latent_table"][1], np.float32), (32, 1))
    got = render(torch.from_numpy(o), torch.from_numpy(d),
                 torch.from_numpy(lat))
    # the live renderer with the same edit, bit for bit
    args, model, extras = load_experiment(experiment, device="cpu")
    sd = extras["scripts_dict"]
    live = make_serving_fn(
        model, t_config.model_config_from_args(args),
        t_config.render_settings_from_args(args, sd["near"], sd["far"]),
        t_config.EditConfig(test_time_scaling=2.0))(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lat))
    for k in got:
        assert torch.equal(got[k], live[k]), k
    # the JAX tool on the same folder
    jax_out = str(tmp_path / "scene.stablehlo")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import export_serving as j_tool
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    j_tool.main(["--input", experiment, "--out", jax_out, "--chunk", "32",
                 "--motion_factor", "2"])
    from nonrigid_nerf_tpu.serving import load_exported as j_load
    want = j_load(jax_out)[0](o, d, lat)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_reference_import_and_export_clis_round_trip(tmp_path, capsys):
    src = write_reference_experiment(tmp_path)
    out_t, out_j = tmp_path / "port_exp", tmp_path / "jax_exp"
    with pytest.warns(UserWarning, match="dropped reference-only args"):
        t_import_ref.main([str(src), str(out_t), "--set", "N_iters=20",
                           "--datadir", "/data/elsewhere"])
    printed = capsys.readouterr().out
    assert "imported" in printed and "step 10" in printed
    assert "nonrigid_nerf_torch.cli.train" in printed
    with pytest.warns(UserWarning, match="dropped reference-only args"):
        j_interop.import_reference_experiment(
            str(src), str(out_j),
            overrides={"N_iters": 20, "datadir": "/data/elsewhere"})
    step_t, params_t, _, opt_t = read_checkpoint(
        str(out_t / "logs" / "latest.npz"), with_opt_state=True)
    step_j, params_j, _, opt_j = read_checkpoint(
        str(out_j / "logs" / "latest.npz"), with_opt_state=True)
    assert step_t == step_j == 10
    for a, b in zip(jax.tree_util.tree_leaves(params_t),
                    jax.tree_util.tree_leaves(params_j)):
        np.testing.assert_array_equal(a, b)
    args_t = t_config.parse_config_file(str(out_t / "logs" / "args.txt"))
    assert args_t["N_iters"] == 20 and args_t["datadir"] == "/data/elsewhere"

    tar = tmp_path / "back.tar"
    t_export_ref.main([str(out_t), str(tar)])
    assert "exported step 10" in capsys.readouterr().out
    back = j_interop.load_reference_tar(str(tar))
    orig = j_interop.load_reference_tar(
        str(src / "logs" / "000010.tar"))
    assert back["global_step"] == orig["global_step"] == 10
    pa = j_interop.params_from_reference_tar(back)[0]
    pb = j_interop.params_from_reference_tar(orig)[0]
    for a, b in zip(jax.tree_util.tree_leaves(pa), jax.tree_util.tree_leaves(pb)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # weights only: the Adam moments are zero
    t_export_ref.main([str(out_t), str(tmp_path / "w.tar"), "--no_optimizer"])
    state = j_interop.load_reference_tar(str(tmp_path / "w.tar"))[
        "optimizer_state_dict"]["state"]
    assert all(float(s["exp_avg"].abs().max()) == 0 for s in state.values())


@pytest.mark.parametrize("module", ["export_serving",
                                    "import_reference_checkpoint",
                                    "export_reference_checkpoint",
                                    "preprocess"])
def test_cli_modules_run_with_help(module):
    proc = subprocess.run(
        [sys.executable, "-m", f"nonrigid_nerf_torch.cli.{module}", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "usage" in proc.stdout
