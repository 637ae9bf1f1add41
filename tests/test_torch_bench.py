"""The port's bench (`python3 -m nonrigid_nerf_torch.cli.bench`) and its
FLOP count (`nonrigid_nerf_torch/utils/flops.py`) held against the JAX
package's root bench.py and `nonrigid_nerf_tpu/utils/flops.py`: every count
of the FLOP matrix equal as an integer, the windows protocol equal on
scripted rate sequences, the synthetic stack equal to `__graft_entry__`'s,
every mode of the bench line at tiny sizes on the CPU with every key of the
JAX bench's recorded line (`results/r5_bench/bench.json`), and a planted
failing mode reported as null, an `errors` entry and exit code 1."""

import dataclasses
import itertools
import json
import math
import os

import numpy as np
import pytest
import torch

import bench as j_bench
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.cli import bench
from nonrigid_nerf_torch.utils import flops as t_flops
from nonrigid_nerf_tpu import config as j_config
from nonrigid_nerf_tpu.utils import flops as j_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDED_LINE = os.path.join(REPO, "results", "r5_bench", "bench.json")
ADDED_KEYS = {"N_rand", "medians", "power_limit_w", "errors"}

FLAGSHIP = t_config.ModelConfig()
# the FLOP matrix: (config changes, train_flops_per_ray keywords)
FLOP_CASES = {
    "flagship": ({}, {}),
    "viewdirs_fd": ({"use_viewdirs": True}, {}),
    "viewdirs_exact": ({"use_viewdirs": True,
                        "approx_nonrigid_viewdirs": False}, {}),
    "time_conditioned_baseline": ({"ray_bending": None,
                                   "time_conditioned_baseline": True}, {}),
    "no_stage1_reuse": ({"stage1_reuse": False}, {}),
    "no_importance": ({"N_importance": 0}, {}),
    "no_rigidity": ({"use_rigidity_network": False}, {}),
    "two_backwards": ({}, {"n_backwards": 2}),
    "exact_divergence": ({}, {"divergence_exact": True}),
    "no_divergence": ({}, {"divergence_weight": 0.0}),
    "no_bending": ({"ray_bending": None}, {}),
}

TINY = t_config.ModelConfig(netdepth=2, netwidth=32, netdepth_fine=2,
                            netwidth_fine=32, multires=4, multires_views=2,
                            N_samples=4, N_importance=4)
TINY_TC = t_config.TrainConfig(N_rand=16, offsets_loss_weight=60.0,
                               divergence_loss_weight=3.0,
                               rigidity_loss_weight=5e-4, N_iters=200000)
TINY_RUN = dict(steps=1, render_frames=1, render_chunk=64, windows=(2, 2),
                warmup=0, device="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(cfg):
    return j_config.ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("case", sorted(FLOP_CASES))
def test_flops_equal_jax(case):
    changes, kwargs = FLOP_CASES[case]
    cfg = dataclasses.replace(FLAGSHIP, **changes)
    jcfg = jax_config(cfg)
    for network in ("coarse", "fine"):
        assert t_flops.canonical_mlp_flops(cfg, network) \
            == j_flops.canonical_mlp_flops(jcfg, network)
    assert t_flops.bender_flops(cfg) == j_flops.bender_flops(jcfg)
    assert t_flops.rigidity_flops(cfg) == j_flops.rigidity_flops(jcfg)
    assert t_flops.render_flops_per_ray(cfg) \
        == j_flops.render_flops_per_ray(jcfg)
    got = t_flops.train_flops_per_ray(cfg, **kwargs)
    assert isinstance(got, int)
    assert got == j_flops.train_flops_per_ray(jcfg, **kwargs)


def test_flagship_train_flops_per_ray():
    assert t_flops.train_flops_per_ray(FLAGSHIP, divergence_weight=3.0) \
        == 590_610_432


def test_bf16_peak_by_device(monkeypatch):
    """No TPU entry: the CPU and unknown GPUs give None, an H100 SXM5 its
    datasheet's 989.4 TFLOP/s."""
    assert t_flops.device_bf16_peak_tflops("cpu") is None
    assert t_flops.device_bf16_peak_tflops(torch.device("cpu")) is None
    assert not any("TPU" in k for k in t_flops._BF16_PEAK_TFLOPS)
    names = {"NVIDIA H100 80GB HBM3": 989.4, "H100 80GB HBM3": 989.4,
             "NVIDIA H100 PCIe": None, "NVIDIA A100-SXM4-80GB": None}
    for name, peak in names.items():
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
        assert t_flops.device_bf16_peak_tflops("cuda:0") == peak
        assert t_flops.device_bf16_peak_tflops(0) == peak


SEQUENCES = {
    "steady": [100.0, 101.0],
    "third_window": [100.0, 90.0, 99.5],
    "never_steady": [100.0, 50.0, 25.0, 12.5, 6.25, 3.125, 1.0, 1.0],
    "settles_late": [10.0, 30.0, 60.0, 61.0, 5.0, 5.0],
    "equal": [7.0, 7.0, 7.0],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("limits", [(2, 6), (2, 2), (3, 4)])
def test_steady_windows_equal_jax(name, limits):
    def scripted():
        rates = itertools.cycle(SEQUENCES[name])
        return lambda: next(rates)

    got = bench.steady_windows(scripted(), *limits)
    want = j_bench.steady_windows(scripted(), *limits)
    assert got == want
    assert (bench.STEADY_TOL, bench.MIN_WINDOWS, bench.MAX_WINDOWS) \
        == (j_bench.STEADY_TOL, j_bench.MIN_WINDOWS, j_bench.MAX_WINDOWS)


def test_synthetic_dataset_equals_jax():
    from __graft_entry__ import _synthetic_dataset
    want = _synthetic_dataset(n_images=5, H=6, W=8)
    got = bench.synthetic_dataset(n_images=5, H=6, W=8, device="cpu")
    for name in ("images", "poses", "view_intrinsics", "imageid_to_viewid",
                 "imageid_to_timestepid", "train_indicator", "test_indicator"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert (got.height, got.width, got.num_timesteps, got.near, got.far) \
        == (want.height, want.width, want.num_timesteps, want.near, want.far)


def test_block_split_dataset():
    ds = bench.synthetic_dataset(n_images=9, H=4, W=4, device="cpu")
    split = bench.block_split_dataset(ds)
    test = (np.arange(9) % 7) >= 5
    np.testing.assert_array_equal(split.test_indicator.numpy(), test)
    np.testing.assert_array_equal(split.train_indicator.numpy(), ~test)


@pytest.fixture(scope="module")
def tiny_ds():
    return bench.synthetic_dataset(n_images=7, H=12, W=16, device="cpu")


@pytest.fixture(scope="module")
def bench_line(tiny_ds):
    torch.manual_seed(0)
    return bench.run_bench(TINY, TINY_TC, tiny_ds, **TINY_RUN)


def test_bench_line_has_the_jax_keys(bench_line):
    with open(RECORDED_LINE) as f:
        recorded = json.load(f)
    assert set(recorded) | ADDED_KEYS == set(bench_line)
    assert set(recorded["mfu"]) | {"render"} == set(bench_line["windows"])
    assert set(bench_line["steadiness"]) == set(bench_line["windows"]) \
        == set(bench_line["medians"]) == set(bench.MODES)
    json.loads(json.dumps(bench_line))           # one JSON line


def test_bench_line_numbers(bench_line):
    line = bench_line
    assert line["errors"] == {}
    assert line["N_rand"] == TINY_TC.N_rand
    assert line["value"] == line["steps_per_sec"] * line["N_rand"]
    assert line["vs_baseline"] == line["value"] / bench.V100_BASELINE_RAYS_PER_SEC
    assert line["model_flops_per_train_ray"] == j_flops.train_flops_per_ray(
        jax_config(TINY), divergence_weight=TINY_TC.divergence_loss_weight)
    for key in ("value", "render_rays_per_sec", "train_rays_per_sec_bf16",
                "train_rays_per_sec_viewdirs",
                "train_rays_per_sec_viewdirs_exact",
                "train_rays_per_sec_block_split", "model_tflops_per_sec",
                "final_psnr_sample", "model_tflops_per_sec_viewdirs"):
        assert math.isfinite(line[key]) and line[key] > 0, key
    reported = {"render": line["render_rays_per_sec"],
                "default": line["steps_per_sec"] * TINY_TC.N_rand}
    for mode, windows in line["windows"].items():
        assert len(windows) == 2 and line["steadiness"][mode] >= 1.0
        # the fastest window is the mode's rate
        assert max(windows) == pytest.approx(
            reported.get(mode, line.get(f"train_rays_per_sec_{mode}")),
            rel=1e-12)
        assert line["medians"][mode] == float(np.median(windows))
    # the CPU has no peak: no MFU, never a made-up one
    assert line["bf16_peak_tflops"] is None
    assert line["mfu_vs_bf16_peak"] is None
    assert line["mfu"] == dict.fromkeys(bench.TRAIN_MODES)
    assert line["device"] == "cpu" and line["power_limit_w"] is None


def test_a_failing_mode_is_reported_and_exits_1(monkeypatch, capsys, tiny_ds):
    """bf16's step raises: its rate is null with its message under
    "errors", the other modes still run, the line is printed and the
    process exits 1."""
    from nonrigid_nerf_torch.engine import train_step
    real_make = train_step.make_train_step

    def make(cfg, *args, **kwargs):
        step_fn = real_make(cfg, *args, **kwargs)
        if cfg.compute_dtype != "bfloat16":
            return step_fn

        def failing(state, ds, generator=None):
            raise RuntimeError("planted failure")
        return failing

    real_run = bench.run_bench
    monkeypatch.setattr(train_step, "make_train_step", make)
    monkeypatch.setattr(bench, "build_dataset", lambda datadir, device: tiny_ds)
    monkeypatch.setattr(bench, "run_bench", lambda cfg, tc, ds, **kw:
                        real_run(TINY, TINY_TC, ds, **{**kw, **TINY_RUN}))
    capsys.readouterr()
    assert bench.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line["train_rays_per_sec_bf16"] is None
    assert line["errors"] == {"bf16": "RuntimeError: planted failure"}
    assert "bf16" not in line["windows"]
    for key in ("value", "train_rays_per_sec_viewdirs",
                "train_rays_per_sec_block_split", "render_rays_per_sec"):
        assert line[key] is not None and line[key] > 0
