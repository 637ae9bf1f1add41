"""The benchmark's frozen arithmetic reproduces the port's FLOP counts and
PERF.md's kernel bounds."""

import pytest

from benchmark.harness import spec, yardstick


@pytest.mark.parametrize("config, train, render", [
    ("nrnerf_flagship", 590_610_432, 193_101_824),
    ("nrnerf_tc_baseline", 585_990_144, 195_330_048)])
def test_flops_per_ray(config, train, render):
    c = spec.read_json(f"{spec.BENCH_DIR}/configs/{config}.json")
    assert yardstick.train_flops_per_ray(c["model"], c["train"]) == train
    assert yardstick.render_flops_per_ray(c["model"]) == render


@pytest.mark.parametrize("work, points, lanes, bound_ms", [
    (yardstick.mlp_fwd_work, 2 ** 21, 64, 2.093),     # PERF.md row 1
    (yardstick.mlp_fwd_work, 2 ** 21, 128, 2.232),
    (yardstick.mlp_bwd_work, 65536, 64, 0.1962),      # row 2
    (yardstick.mlp_bwd_work, 65536, 128, 0.2093)])
def test_kernel_bounds(work, points, lanes, bound_ms):
    card = yardstick.peaks("NVIDIA H100 80GB HBM3")
    flops, nbytes = work(points, 1, lanes)
    assert yardstick.least_seconds(flops, nbytes, card) * 1e3 == \
        pytest.approx(bound_ms, rel=2e-3)


def test_kernel_lanes():
    for config, lanes in (("nrnerf_flagship", 64), ("nrnerf_tc_baseline", 128)):
        c = spec.read_json(f"{spec.BENCH_DIR}/configs/{config}.json")
        assert yardstick.kernel_lanes(c["model"]) == lanes


def test_unknown_card_has_no_peaks():
    assert yardstick.peaks("cpu") is None
