"""The port's measuring tools under `nonrigid_nerf_torch/cli/` held against
the JAX package's `tools/`: `probe_offsets` against
`tools/probe_offsets.py` on one tiny experiment (every statistic within
1e-5); `batch_scaling`, `gather_microbench` and `scale_bisect` at tiny
sizes on the CPU, each with the JAX tool's stage
names or row keys; the three gather forms returning identical pixels."""

import dataclasses
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import tests.test_cli as jax_cli_tests
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.cli import (batch_scaling, bench, gather_microbench,
                                     probe_offsets, scale_bisect)
from nonrigid_nerf_torch.cli import train as t_train_cli
from nonrigid_nerf_tpu import config as j_config
from nonrigid_nerf_tpu.utils import flops as j_flops
from tests.test_data import write_synthetic_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")

TINY = t_config.ModelConfig(netdepth=2, netwidth=32, netdepth_fine=2,
                            netwidth_fine=32, multires=4, multires_views=2,
                            N_samples=4, N_importance=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tool_source(name):
    with open(os.path.join(TOOLS, f"{name}.py")) as f:
        return f.read()


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The JAX CLI tests' tiny scene (4 frames of 32 x 36, bending and
    rigidity), trained 8 steps by the port's training CLI."""
    root = tmp_path_factory.mktemp("probe")
    datadir = root / "data"
    datadir.mkdir()
    write_synthetic_sequence(str(datadir), n=4, H=32, W=36)
    cfg_path = root / "tiny.txt"
    cfg_path.write_text(jax_cli_tests.TINY_CONFIG.format(
        datadir=datadir, rootdir=root / "experiments"))
    t_train_cli.main(["--config", str(cfg_path), "--device", "cpu"])
    return str(root / "experiments" / "tiny_exp")


def assert_close_tree(got, want, path="probe"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), \
            f"{path}: {got} vs {want}"
    else:
        assert got == want, path


@pytest.mark.parametrize("checkpoint", [None, "logs/latest.npz"])
def test_probe_offsets_equals_jax(experiment, tmp_path, checkpoint):
    extra = ["--checkpoint", checkpoint] if checkpoint else []
    want = jax_tool("probe_offsets").main([experiment, "--grid", "6"] + extra)
    out = tmp_path / "probe.json"
    got = probe_offsets.main([experiment, "--grid", "6", "--out", str(out),
                              "--device", "cpu"] + extra)
    assert_close_tree(got, want)
    assert want["mean_offset"] > 0 and len(want["per_timestep"]) == 4
    assert "mean_rigidity" in got["per_timestep"][0]
    with open(out) as f:
        assert_close_tree(json.load(f), want)


def test_probe_offsets_missing_checkpoint(experiment):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        probe_offsets.probe(experiment, 4, "logs/999999.npz", device="cpu")


def test_batch_scaling_rows(capsys):
    ds = bench.synthetic_dataset(n_images=4, H=10, W=12, device="cpu")
    out = batch_scaling.run_batch_scaling(TINY, ds, [8, 16], 1, device="cpu",
                                          windows=(2, 2), warmup=0)
    src = tool_source("batch_scaling")
    row_keys = set(re.findall(r'^\s+"(\w+)":', src.split("row = {")[1]
                              .split("}")[0], re.M))
    result_keys = set(re.findall(r'"(\w+)":', src.split("result = {")[1]
                                 .split("print(")[0]))
    assert row_keys == {"N_rand", "train_rays_per_sec", "steps_per_sec",
                        "model_tflops_per_sec", "mfu_vs_bf16_peak",
                        "steadiness", "windows"}
    assert [r["N_rand"] for r in out["rows"]] == [8, 16]
    for r in out["rows"]:
        assert set(r) == row_keys
        assert r["train_rays_per_sec"] > 0 and len(r["windows"]) == 2
        assert r["steps_per_sec"] == r["train_rays_per_sec"] / r["N_rand"]
        assert r["mfu_vs_bf16_peak"] is None           # no peak on the CPU
    assert result_keys <= set(out)
    assert out["model_flops_per_train_ray"] == j_flops.train_flops_per_ray(
        j_config.ModelConfig(**dataclasses.asdict(TINY)),
        divergence_weight=3.0)
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["N_rand"] for line in printed] == [8, 16]


def test_gather_forms_return_identical_pixels():
    n, h, w = 3, 5, 7
    images = gather_microbench.random_stack(n, h, w, "cpu")
    flat = images.reshape(n * h * w, 3)
    gen = torch.Generator().manual_seed(1)
    ids, y, x = gather_microbench.draw(n, h, w, 64, gen, "cpu")
    want = images.numpy()[ids.numpy(), y.numpy(), x.numpy()] / 255.0
    for name, gather in gather_microbench.GATHERS:
        got = gather(images, flat, ids, y, x)
        assert got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_gather_microbench_cli(capsys):
    out = gather_microbench.main(["--n", "3", "--h", "5", "--w", "7",
                                  "--rays", "16", "--iters", "2",
                                  "--device", "cpu"])
    assert list(out["ms"]) == ["a_4d_advanced", "b_flat_rows",
                               "c_index_select"]
    printed = capsys.readouterr().out
    for name in out["ms"]:
        assert re.search(rf"^{name}: [0-9.]+ ms / 16 pixels  \(stack 3x5x7",
                         printed, re.M)


def test_scale_bisect_cells():
    tc = dataclasses.replace(bench.flagship_train_config(), N_rand=8)
    stacks = ((3, 8, 10), (9, 6, 8))
    out = scale_bisect.run_scale_bisect(1, "cpu", stacks, TINY, tc)
    assert list(out["cells"]) == ["3x8x10", "9x6x8"]
    for label, cells in out["cells"].items():
        assert set(cells) == {"stack_bytes", "sample[flat_rows]",
                              "sample[4d]", "step[flat_rows]", "step[4d]",
                              "batch_only[stack resident]",
                              "batch_only[stack freed]"}
        assert all(v > 0 for v in cells.values())
    assert out["cells"]["9x6x8"]["stack_bytes"] == 9 * 6 * 8 * 3


def test_scale_bisect_4d_gather_is_the_same_batch():
    from nonrigid_nerf_torch.data.dataset import sample_ray_batch
    ds = scale_bisect.make_ds(9, 6, 8, "cpu")
    want = sample_ray_batch(ds, 32, generator=torch.Generator().manual_seed(3))
    got = scale_bisect.sample_4d(ds, 32, torch.Generator().manual_seed(3))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # the tiled stack holds real bytes, 8 distinct frames
    images = ds.images.numpy()
    np.testing.assert_array_equal(images[8], images[0])
    assert not np.array_equal(images[1], images[0])
