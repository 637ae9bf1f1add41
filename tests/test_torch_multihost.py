"""The port's process-group bring-up (`nonrigid_nerf_torch/parallel/
multihost.py`) and its entry points under torchrun on the CPU: gloo ranks,
`--device cpu`, on the tiny scene of tests/test_cli.py:TINY_CONFIG.

- The environment contracts: a partial torchrun or NRNERF_* environment
  raises and names what is missing; a backend that does not carry the
  device's tensors raises; without a group the parallel step and renderer
  raise instead of running on one device, and a bare `cuda` becomes the
  process's own GPU under a group.
- `python3 -m torch.distributed.run --nproc_per_node 2 -m
  nonrigid_nerf_torch.cli.train ... --device cpu` writes one experiment
  folder, rank 0's; its metrics.jsonl matches the 1-process run's to rtol
  2e-5 (the JAX package's bound across process topologies; the two runs
  differ in the order of the gradient sums: observed 1.5e-7), its images
  the 1-process run's to 1/255 (observed: equal).
- The same run killed by `--die_at_step 4` after its save and started
  again ends bit-equal to the uninterrupted 2-process run: parameters,
  Adam moments and every metrics row.
- The free-viewpoint CLI under 2 ranks writes the scores.json of 1
  process on the same experiment (rtol 1e-5: the ranks render the same
  rays in other blocks; observed: equal).

The subprocesses of one wave run side by side: the uninterrupted and the
killed run, then the resumed run and the 2-rank rendering.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.test_cli as jax_cli_tests
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.checkpoints import load_train_state, read_checkpoint
from nonrigid_nerf_torch.cli import free_viewpoint_rendering as fvr_cli
from nonrigid_nerf_torch.cli import train as cli
from nonrigid_nerf_torch.device import resolve_device
from nonrigid_nerf_torch.parallel import (make_parallel_renderer,
                                          make_parallel_train_step,
                                          multihost)
from tests.test_data import write_synthetic_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a validation frame and a save every 4 steps, the training subset rendered
# at the last step: every collective render of the CLI runs
FLAGS = ["--device", "cpu", "--i_img", "4", "--i_weights", "4",
         "--i_testset", "8"]
TIMEOUT_S = 300


def torchrun(*argv):
    """`python3 -m torch.distributed.run` of 2 CPU ranks, started."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", *argv], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish(proc):
    out, _ = proc.communicate(timeout=TIMEOUT_S)
    return proc.returncode, out.decode(errors="replace")


def metrics_rows(folder):
    with open(os.path.join(folder, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    datadir = root / "data"
    datadir.mkdir()
    write_synthetic_sequence(str(datadir), n=4, H=32, W=36)
    cfg_path = root / "tiny.txt"
    cfg_path.write_text(jax_cli_tests.TINY_CONFIG.format(
        datadir=datadir, rootdir=root / "experiments"))
    base = ["nonrigid_nerf_torch.cli.train", "--config", str(cfg_path)] \
        + FLAGS
    two = torchrun(*base, "--expname", "two")
    killed = torchrun(*base, "--expname", "killed", "--die_at_step", "4")
    cli.main(["--config", str(cfg_path), "--expname", "one"] + FLAGS)
    results = {"two": finish(two), "killed": finish(killed)}

    exp = root / "experiments"
    shutil.copytree(exp / "two", exp / "two_fvr")
    fvr = ["--deformations", "train", "--camera_path",
           "input_reconstruction", "--device", "cpu"]
    resumed = torchrun(*base, "--expname", "killed")
    fvr_two = torchrun("nonrigid_nerf_torch.cli.free_viewpoint_rendering",
                       "--input", str(exp / "two_fvr"), *fvr)
    fvr_cli.main(["--input", str(exp / "two")] + fvr)
    results.update(resumed=finish(resumed), fvr_two=finish(fvr_two))
    return root, exp, cfg_path, results


def test_partial_nrnerf_environment_names_what_is_missing(monkeypatch):
    for var in multihost.TORCHRUN_ENV + multihost.NRNERF_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NRNERF_COORDINATOR", "localhost:1234")
    with pytest.raises(RuntimeError) as err:
        multihost.maybe_initialize("cpu")
    msg = str(err.value)
    assert "NRNERF_NUM_PROCESSES and NRNERF_PROCESS_ID are missing" in msg
    monkeypatch.setenv("NRNERF_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="NRNERF_PROCESS_ID is missing"):
        multihost.maybe_initialize("cpu")
    assert not multihost.is_initialized()


def test_partial_torchrun_environment_names_what_is_missing(monkeypatch):
    for var in multihost.TORCHRUN_ENV + multihost.NRNERF_ENV:
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize("cpu") == 1     # alone: no group
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError) as err:
        multihost.maybe_initialize("cpu")
    for var in ("LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        assert var in str(err.value)
    assert not multihost.is_initialized()


def test_backend_must_carry_the_device(tmp_path):
    assert multihost.backend_for(None) == "nccl"
    assert multihost.backend_for("cuda") == "nccl"
    assert multihost.backend_for("cpu") == "gloo"
    # ranks that share a GPU: gloo, asked for explicitly
    assert multihost.backend_for("cuda:0", "gloo") == "gloo"
    for device, backend in (("cpu", "nccl"), ("cpu", "mpi"),
                            ("cuda", "mpi")):
        with pytest.raises(ValueError, match="does not carry"):
            multihost.backend_for(device, backend)
    with pytest.raises(ValueError, match="does not carry"):
        multihost.initialize(0, 1, f"file://{tmp_path}/rendezvous",
                             device="cpu", backend="nccl")
    assert not multihost.is_initialized()


def test_nothing_falls_back_to_one_device_without_a_group():
    from tests.test_torch_train_step import NARROW
    from tests.torch_parity import torch_cfg
    cfg = torch_cfg(NARROW)
    rs = t_config.RenderSettings(near=0.5, far=2.5)
    tc = t_config.TrainConfig(N_rand=16)
    assert not multihost.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_parallel_train_step(cfg, tc, rs, has_test_split=False)
    with pytest.raises(RuntimeError, match="no process group"):
        make_parallel_renderer(cfg, rs, device="cpu")
    assert multihost.world_size() == 1 and multihost.is_main()
    multihost.barrier()                     # alone: returns at once


def test_bare_cuda_is_the_process_gpu_under_a_group(monkeypatch):
    """After `initialize` pinned the process to cuda:LOCAL_RANK (here 3),
    a bare `cuda` and no device at all resolve to it; an indexed device is
    kept."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_two_ranks_write_one_experiment_folder(runs):
    root, exp, _, results = runs
    code, out = results["two"]
    assert code == 0, out[-3000:]
    assert out.count("data-parallel training over 2 devices") == 2
    assert out.count("[TRAIN] Iter: 8") == 1       # rank 0 prints
    assert sorted(os.listdir(exp)) == ["killed", "one", "two", "two_fvr"]
    logdir = exp / "two" / "logs"
    assert sorted(os.listdir(logdir)) == sorted(os.listdir(exp / "one" / "logs"))
    for name in ("args.txt", "config.txt", "cameras.obj", "latest.npz"):
        assert (logdir / name).exists(), name
    assert (exp / "two" / "backup" / "nonrigid_nerf_torch" / "parallel"
            / "mesh.py").exists()
    assert read_checkpoint(str(logdir / "latest.npz"))[0] == 8
    rows = metrics_rows(exp / "two")
    assert [(r["step"], "loss" in r) for r in rows] == \
        [(4, True), (4, False), (8, True), (8, False)]


def test_two_ranks_match_one_process(runs):
    _, exp, _, results = runs
    assert results["two"][0] == 0, results["two"][1][-3000:]
    one, two = metrics_rows(exp / "one"), metrics_rows(exp / "two")
    assert [sorted(r) for r in one] == [sorted(r) for r in two]
    for a, b in zip(one, two):
        for k in a:
            if k != "it_per_sec":
                np.testing.assert_allclose(b[k], a[k], rtol=2e-5,
                                           err_msg=f"step {a['step']} {k}")
    from nonrigid_nerf_torch.utils.image_io import imread
    for sub in ("val_images", "trainsubset_000008"):
        names = sorted(os.listdir(exp / "one" / "logs" / sub))
        assert names == sorted(os.listdir(exp / "two" / "logs" / sub))
        assert names
        for name in names:
            a = imread(str(exp / "one" / "logs" / sub / name)).astype(int)
            b = imread(str(exp / "two" / "logs" / sub / name)).astype(int)
            assert np.abs(a - b).max() <= 1, (sub, name)


def test_killed_and_resumed_equals_uninterrupted(runs):
    _, exp, cfg_path, results = runs
    code, out = results["killed"]
    assert code != 0 and out.count("[FAULT-INJECTION] SIGKILL at step 4") \
        == 2, out[-3000:]
    code, out = results["resumed"]
    assert code == 0, out[-3000:]
    assert out.count("Reloading from") == 2          # every rank loads
    strip = [{k: v for k, v in r.items() if k != "it_per_sec"}
             for r in metrics_rows(exp / "killed")]
    want = [{k: v for k, v in r.items() if k != "it_per_sec"}
            for r in metrics_rows(exp / "two")]
    assert strip == want
    cfg = t_config.model_config_from_args(t_config.load_args(str(cfg_path)))
    a, b = (load_train_state(str(exp / name / "logs" / "latest.npz"), cfg,
                             device="cpu")[0] for name in ("two", "killed"))
    assert a.step == b.step == 8
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(a.mu[name], b.mu[name]), name
        assert torch.equal(a.nu[name], b.nu[name]), name


def test_two_rank_rendering_writes_the_scores_of_one_process(runs):
    _, exp, _, results = runs
    code, out = results["fvr_two"]
    assert code == 0, out[-3000:]
    folder = os.path.join("output", "train_input_reconstruction")
    with open(exp / "two" / folder / "scores.json") as f:
        want = json.load(f)
    with open(exp / "two_fvr" / folder / "scores.json") as f:
        got = json.load(f)
    assert set(got) == set(want) and "average_psnr" in got
    for k, v in want.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                if vv is not None:
                    np.testing.assert_allclose(got[k][kk], vv, rtol=1e-5,
                                               err_msg=f"{k} {kk}")
        elif v is not None:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    assert sorted(os.listdir(exp / "two" / folder)) == \
        sorted(os.listdir(exp / "two_fvr" / folder))
