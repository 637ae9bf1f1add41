"""Traffic of kind "render" for a view-direction configuration: the loop,
the control and the comparison of `render.py` (its `check` and `FAULTS`,
loaded by path), with two differences: the weights carry the view heads
(`harness/inputs_views.py`), and the run records the `mlpv_fwd` and
`mlpv_bwd` launches of its traced frames (without a trace, of its window)
in `run.counters` (`harness/cells_views.py:LaunchLog`). One fault more:
"straight_viewdirs", the unbent ray's directions.
"""

from __future__ import annotations

import os
import random
import time
from typing import List

import torch

from benchmark.harness import cells, cells_views, inputs, inputs_views, spec

base = spec.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "render.py"))
check = base.check
FAULTS = dict(base.FAULTS, straight_viewdirs=cells_views.straight_viewdirs)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t0: float, ref) -> cells.Run:
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.config import RenderSettings
    config, traffic = cell["config"], cell["traffic"]
    st = traffic["stack"]
    h, w, n_img = st["height"], st["width"], st["images"]
    out = cells.Run("render", config, traffic, cells.device_name(device),
                    rays_per_unit=h * w)
    stack = inputs.make_stack(st, seed, device, images=False)
    weights = inputs_views.make_weights(config, n_img, seed, device)
    poses = stack["poses"].cpu().numpy()
    latents = weights["latents"].cpu().numpy()
    intrin = {"height": h, "width": w, "focal_x": stack["focal"],
              "focal_y": stack["focal"], "center_x": w / 2.0,
              "center_y": h / 2.0}
    frames: List[tuple] = []
    cfg = cells.program_config(config)
    rs = RenderSettings(N_samples=cfg.N_samples, N_importance=cfg.N_importance,
                        near=stack["near"], far=stack["far"])
    model = cells.program_model(cfg, weights, n_img, device)

    def render(k):
        rgbs, disps = render_path(
            model, cfg, rs, inputs.path_pose(poses, traffic["path"], k)[None],
            [intrin], latents[k % n_img][None], chunk=traffic["chunk"],
            verbose=False, device=device)
        return rgbs[0], disps[0]

    for k in range(traffic["warmup_frames"]):
        render(k)
    cells.sync(device)
    setup_peak = cells.peak(device)
    out.setup_s = time.time() - t0

    def frame():
        k = len(frames)
        t = time.perf_counter()
        frames.append(render(k))
        out.latencies_s.append(time.perf_counter() - t)

    log = cells_views.LaunchLog()
    cells.window(out, log.counted(frame), seconds, trace,
                 traffic["trace_frames"], device)
    log.record(out, trace)
    out.memory_peak_bytes = max(setup_peak, out.peak_window_bytes)
    del model, render, frame
    cells.free_program(device)
    picks = sorted(random.Random(seed).sample(
        range(len(frames)), min(traffic["check_frames"], len(frames))))
    out.attempted = len(picks)
    check(out, ref, cell["limits"], weights, stack,
          {k: frames[k] for k in picks})
    return out


def control(cell: dict, seed: int, device, t0: float, ref) -> cells.Run:
    """The reference in the program's place, one precision below what the
    configuration states, on `check_frames` frames of the camera path drawn
    from the seed: no window."""
    config, traffic = cell["config"], cell["traffic"]
    st = traffic["stack"]
    out = cells.Run("render", config, traffic, cells.device_name(device))
    stack = inputs.make_stack(st, seed, device, images=False)
    weights = inputs_views.make_weights(config, st["images"], seed, device)
    poses = stack["poses"].cpu().numpy()
    picks = sorted(random.Random(seed).sample(
        range(4 * traffic["check_frames"]), traffic["check_frames"]))
    frames = {}
    with ref.full_f32():
        for k in picks:
            rgb, disp = ref.render_frame(
                weights, config["model"],
                torch.as_tensor(inputs.path_pose(poses, traffic["path"], k),
                                device=device),
                st["height"], st["width"], stack["focal"],
                weights["latents"][k % st["images"]][None], stack["near"],
                stack["far"], mlp_dtype=ref.mlp_dtype(config, control=True))
            frames[k] = (rgb.cpu().numpy(), disp.cpu().numpy())
    out.attempted = len(picks)
    check(out, ref, cell["limits"], weights, stack, frames)
    return out
