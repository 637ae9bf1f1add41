"""End-to-end metrics take all of the window: a stall in it moves the rate
and the frame latency's 90th percentile."""

import time

import torch

from benchmark.harness import cells, spec

E2E = {m["name"]: spec.reader(m["name"])
       for m in spec.benchmark()["end_to_end"]}


def run_window(kind, stall_frames=(), seconds=0.4, unit_s=0.02):
    run = cells.Run(kind, {}, {}, "cpu", rays_per_unit=100)
    n = [0]

    def unit():
        t = time.perf_counter()
        time.sleep(0.15 if n[0] in stall_frames else unit_s)
        n[0] += 1
        run.latencies_s.append(time.perf_counter() - t)

    cells.window(run, unit, seconds, False, 0, torch.device("cpu"))
    return run


def test_stall_moves_render_rate_and_p90():
    calm = run_window("render")
    stalled = run_window("render", stall_frames=(3, 4, 5))
    assert E2E["render_frames_per_s"](stalled) < \
        0.8 * E2E["render_frames_per_s"](calm)
    assert E2E["render_frame_p90_ms"](stalled) > \
        2 * E2E["render_frame_p90_ms"](calm)


def test_stall_moves_train_rate():
    calm = run_window("train")
    stalled = run_window("train", stall_frames=(2,))
    assert E2E["train_rays_per_s"](stalled) < \
        0.8 * E2E["train_rays_per_s"](calm)


def test_rate_is_all_units_over_all_time():
    run = run_window("train", seconds=0.2)
    assert E2E["train_rays_per_s"](run) == run.units * 100 / run.window_s
    assert run.window_s >= 0.2
