"""The view-direction configuration's cells (`nrnerf_viewdirs`), their
drivers, yardstick and readers, on the CPU at tiny sizes: the cells run
correct and each planted fault reads incorrect; `yardstick_views` gives
PERF.md's bounds of rows 3-4; the launch log records what the traced
units launched; every new reader reads a number from a tiny run with a
trace of the kernels it reads, and the span reader 0.0 without spans."""

import pytest
import torch

from benchmark.harness import cells, cells_views, spec, yardstick, \
    yardstick_views
from benchmark.harness.trace import Trace
from bench_cases import BIG_SEED, tiny

RENDER = "nrnerf_viewdirs.render_path_384x512_views"
TRAIN = "nrnerf_viewdirs.train_r16384_views"
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread a worker: a tiny frame then takes some 30 ms however many
    workers share the machine, so a window of a second renders many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(name, variant="program", seconds=1.0):
    """A tiny run; the render window of a second renders many frames, so a
    stale frame is among the checked ones."""
    return cells.run_cell(tiny(spec.cell(name)), BIG_SEED, seconds, False,
                          "cpu", variant=variant)


@pytest.mark.parametrize("name", [RENDER, TRAIN])
def test_tiny_cell_is_correct(name):
    r = run(name)
    assert r.correct and r.failed == 0 and r.attempted > 0
    assert set(r.checks) == set(spec.cell(name)["limits"])
    assert {"mlpv_fwd", "mlpv_bwd"} <= set(r.counters)


@pytest.mark.parametrize("name, fault", [
    (RENDER, "stale_frame"), (RENDER, "altered_pixel"),
    (RENDER, "straight_viewdirs"), (TRAIN, "frozen"), (TRAIN, "half_batch"),
    (TRAIN, "straight_viewdirs"), (TRAIN, "detached_viewdirs")])
def test_fault_is_incorrect(name, fault):
    r = run(name, fault)
    assert r.units >= 2 or name == TRAIN
    assert not r.correct and r.failed == r.attempted > 0


@pytest.mark.parametrize("work, points, bound_ms", [
    (yardstick_views.mlpv_fwd_work, 2 ** 21, 2.532),    # PERF.md row 3
    (yardstick_views.mlpv_bwd_work, 65536, 0.2374)])    # row 4
def test_kernel_bounds(work, points, bound_ms):
    flops, nbytes = work(points, 1)
    assert yardstick.least_seconds(flops, nbytes, yardstick.peaks(H100)) \
        * 1e3 == pytest.approx(bound_ms, rel=2e-3)


def test_model_flops_count_the_view_branch():
    model = spec.cell(RENDER)["config"]["model"]
    assert yardstick_views.canonical_flops(model) == 2 * 593_408
    assert yardstick.canonical_flops(model) == 2 * 492_288
    # the bender's share is F's; only the canonical MLP differs
    flagship = spec.read_json(
        f"{spec.BENCH_DIR}/configs/nrnerf_flagship.json")
    assert yardstick_views.render_flops_per_ray(model) \
        - yardstick.render_flops_per_ray(flagship["model"]) \
        == (2 * 64 + 64) * 2 * (593_408 - 492_288)


def test_launch_log_sums_the_traced_units(monkeypatch):
    from nonrigid_nerf_torch.ops.kernels import mlpv_fwd
    monkeypatch.setattr(mlpv_fwd.mlpv_fwd, "launches", 0)
    log = cells_views.LaunchLog()
    calls = iter([1, 2, 3, 4, 5])

    def unit():
        mlpv_fwd.mlpv_fwd.launches += next(calls)

    for _ in range(5):
        log.counted(unit)()
    traced = cells.Run("render", {}, {}, "cpu", trace_units=2)
    log.record(traced, trace=True)
    assert traced.counters == {"mlpv_fwd": 9, "mlpv_bwd": 0}
    untraced = cells.Run("render", {}, {}, "cpu")
    log.record(untraced, trace=False)
    assert untraced.counters["mlpv_fwd"] == 15


def traced(name, kernels, spans=True, launches=2):
    """A tiny run of the cell with a synthetic trace of 2 units on an H100:
    each kernel (name, seconds) once a unit, the first of them counted
    `launches` times by its wrapper, and with `spans` a `viewdirs` span over
    an idle stretch of 2 ms a unit."""
    r = run(name, seconds=0.2)
    r.device_name, r.trace_units = H100, 2
    ks, host, t = [], [], 0.0
    for _ in range(2):
        for k, s in kernels:
            ks.append((k, t, t + s))
            t += s
        if spans:
            host.append(("nrnerf/viewdirs", t, t + 0.002))
        t += 0.002
    r.trace = Trace(window_s=t, kernels=ks, copies=[], host_ops=host)
    r.counters["mlpv_fwd" if name == RENDER else "mlpv_bwd"] = launches
    return r


FWD = [("void sm90::mlpv_fwd_kernel(...)", 0.010)]
BWD = [("void sm90::mlpv_bwd_chain_kernel(...)", 0.004),
       ("sm90::mlp_dw_sm90_kernel(...)", 0.003),
       ("sm90::mlp_head_grad_kernel(...)", 0.0005),
       ("mlp_reduce_kernel(...)", 0.0005)]


@pytest.mark.parametrize("name, kernels, work, reader", [
    (RENDER, FWD, yardstick_views.mlpv_fwd_work, "mlpv_fwd_roofline"),
    (TRAIN, BWD, yardstick_views.mlpv_bwd_work, "mlpv_bwd_roofline")])
def test_roofline_readers(name, kernels, work, reader):
    r = traced(name, kernels)
    model = r.config["model"]
    points = 2 * r.rays_per_unit * (2 * model["N_samples"]
                                    + model["N_importance"])
    least = yardstick.least_seconds(*work(points, 2), yardstick.peaks(H100))
    device = 2 * sum(s for _, s in kernels)
    assert spec.reader(reader)(r) == pytest.approx(100.0 * least / device)
    # launches that disagree with the counter read nothing
    assert spec.reader(reader)(traced(name, kernels, launches=3)) is None


@pytest.mark.parametrize("name, kernels, unit", [
    (RENDER, FWD, "render"), (TRAIN, BWD, "train")])
def test_mfu_and_idle_readers(name, kernels, unit):
    r = traced(name, kernels)
    per_unit = (yardstick_views.render_flops_per_ray(r.config["model"])
                if unit == "render" else yardstick_views.train_flops_per_ray(
                    r.config["model"], r.config["train"]))
    assert spec.reader(f"mfu_views.{unit}")(r) == pytest.approx(
        100.0 * r.units * r.rays_per_unit * per_unit / r.window_s
        / yardstick.PEAKS["H100 80GB HBM3"]["bf16_flops"])
    assert spec.reader(f"viewdirs_idle_ms.{unit}")(r) == pytest.approx(2.0)
    # a program that opens no `viewdirs` span (the parent) reads 0.0
    assert spec.reader(f"viewdirs_idle_ms.{unit}")(
        traced(name, kernels, spans=False)) == 0.0
    other = "train" if unit == "render" else "render"
    assert spec.reader(f"viewdirs_idle_ms.{other}")(r) is None
    assert spec.reader(f"mfu_views.{other}")(r) is None
