"""Traffic of kind "render": a closed loop of one viewer, one frame at a time
through `apps/render_path.py:render_path` in test mode, each frame's rgb
and disparity copied to the host; the camera walks the traffic's path and
each frame takes the next timestep's latent.

The comparison (`check`): `check_frames` frames drawn from the seed among
the window's are rendered again by the reference, in full, in the
precision the configuration states (`ref.mlp_dtype`):
- `rgb_max`, `rgb_mean`: the largest and the mean |rgb - rgb_ref|;
- `disp_max`: the largest |disparity - disparity_ref| over the frame's
  largest reference disparity.
"""

from __future__ import annotations

import random
import time
from typing import List

import numpy as np
import torch

from benchmark.harness import cells, checks, faults, inputs

FAULTS = {"stale_frame": faults.stale_frame,
          "altered_pixel": faults.altered_pixel}


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
    weights = inputs.make_weights(config, n_img, seed, device)
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

    cells.window(out, frame, seconds, trace, traffic["trace_frames"], device)
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
    weights = inputs.make_weights(config, st["images"], seed, device)
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


def check(run, ref, limits, weights, stack, frames):
    traffic = run.traffic
    st = traffic["stack"]
    h, w, n_img = st["height"], st["width"], st["images"]
    poses = stack["poses"].cpu().numpy()
    gaps = {"rgb_max": [], "rgb_mean": [], "disp_max": []}
    device = weights["latents"].device
    with ref.full_f32():
        for k, (rgb, disp) in frames.items():
            c2w = torch.as_tensor(inputs.path_pose(poses, traffic["path"], k),
                                  device=device)
            ref_rgb, ref_disp = ref.render_frame(
                weights, run.config["model"], c2w, h, w, stack["focal"],
                weights["latents"][k % n_img][None], stack["near"],
                stack["far"], mlp_dtype=ref.mlp_dtype(run.config))
            ref_rgb = ref_rgb.cpu().numpy().astype(np.float64)
            ref_disp = ref_disp.cpu().numpy().astype(np.float64)
            d_rgb = np.abs(rgb - ref_rgb)
            d_disp = np.abs(disp - ref_disp) / np.abs(ref_disp).max()
            gaps["rgb_max"].append(d_rgb.max())
            gaps["rgb_mean"].append(d_rgb.mean())
            gaps["disp_max"].append(d_disp.max())
    checks.finish(run, {k: checks.worst(v) for k, v in gaps.items() if v},
                  limits)
