"""Probe a trained checkpoint's deformation field: offset magnitudes and
rigidity statistics over the scene volume, per timestep
(counterpart of the JAX package's tools/probe_offsets.py).

    python3 -m nonrigid_nerf_torch.cli.probe_offsets EXPERIMENT_DIR
        [--grid 16] [--out FILE] [--checkpoint logs/050000.npz]
        [--device cuda]

Quantifies how the regularizers behave on a scene type (reference analogs:
the offsets and rigidity losses, train.py:219-242): on a rigid scene the
masked offsets must stay about 0 everywhere; on a large-motion scene the
foreground carries large offsets while the background stays small.

The probe lattice spans the trained volume (`min/max_nerf_volume_point` of
the checkpoint's scripts_dict), or the near/far cube when the experiment
skipped the volume probe. The bender runs on the device, in f32.
`--checkpoint` probes a given snapshot (a path, or a name relative to
EXPERIMENT_DIR) instead of the latest one. Prints one JSON object, the JAX
tool's keys; `--out` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch


def probe(experiment: str, grid: int = 16, checkpoint: Optional[str] = None,
          device=None) -> dict:
    """The JAX tool's statistics of the experiment's deformation field."""
    from nonrigid_nerf_torch import config as cfg_mod
    from nonrigid_nerf_torch.checkpoints import (latest_checkpoint,
                                                 load_checkpoint)
    from nonrigid_nerf_torch.device import resolve_device

    device = resolve_device(device)
    logdir = os.path.join(experiment, "logs")
    if checkpoint:
        ckpt_path = checkpoint if os.path.exists(checkpoint) \
            else os.path.join(experiment, checkpoint)
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
    else:
        ckpt_path = latest_checkpoint(logdir)
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint under {logdir}")
    train_args = cfg_mod.load_args(os.path.join(logdir, "args.txt"))
    cfg = cfg_mod.model_config_from_args(train_args)
    if not cfg.use_ray_bending:
        raise SystemExit("experiment has no ray-bending network")
    step, model, extras = load_checkpoint(ckpt_path, cfg, device=device)
    if model.bender is None:
        raise SystemExit("experiment has no ray-bending network")

    sd = extras.get("scripts_dict", {})
    if "min_nerf_volume_point" in sd:
        lo = np.asarray(sd["min_nerf_volume_point"], np.float32)
        hi = np.asarray(sd["max_nerf_volume_point"], np.float32)
    else:
        far = float(sd.get("far", 6.0))
        lo, hi = np.full(3, -far, np.float32), np.full(3, far, np.float32)
    axes = [np.linspace(lo[i], hi[i], grid, dtype=np.float32)
            for i in range(3)]
    pts_np = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pts = torch.as_tensor(pts_np, device=device)

    per_t, all_offsets = [], []
    with torch.no_grad():
        latents = model.latents.detach()
        for t in range(latents.shape[0]):
            lat = latents[t].expand(pts.shape[0], latents.shape[1])
            _, det = model.bender(pts, lat)
            off = det.get("masked_offsets", det["unmasked_offsets"])
            off = off.cpu().numpy()
            all_offsets.append(off)
            mag = np.linalg.norm(off, axis=-1)
            row = {"timestep": t,
                   "mean_offset": float(mag.mean()),
                   "p99_offset": float(np.percentile(mag, 99)),
                   "max_offset": float(mag.max())}
            if "rigidity_mask" in det:
                row["mean_rigidity"] = float(
                    det["rigidity_mask"][..., 0].cpu().numpy().mean())
            per_t.append(row)

    # temporal motion: how much the bend of a point VARIES across
    # timesteps. A static offset merely re-parametrizes the canonical
    # frame; variation over t is what renders as scene motion, so on a
    # rigid scene this must be about 0 even where absolute offsets are not.
    stack = np.stack(all_offsets)                     # (T, N, 3)
    dev = np.linalg.norm(stack - stack.mean(axis=0, keepdims=True),
                         axis=-1)                     # (T, N)
    temporal = dev.mean(axis=0)                       # (N,)

    diag = float(np.linalg.norm(hi - lo))
    return {
        "experiment": experiment, "step": int(step),
        "grid": grid, "extent_lo": lo.tolist(), "extent_hi": hi.tolist(),
        "extent_diagonal": diag,
        "mean_offset": float(np.mean([r["mean_offset"] for r in per_t])),
        "max_offset": float(np.max([r["max_offset"] for r in per_t])),
        "mean_offset_rel_diag":
            float(np.mean([r["mean_offset"] for r in per_t]) / diag),
        "mean_temporal_motion": float(temporal.mean()),
        "p99_temporal_motion": float(np.percentile(temporal, 99)),
        "max_temporal_motion": float(temporal.max()),
        "mean_temporal_motion_rel_diag": float(temporal.mean() / diag),
        "per_timestep": per_t,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiment")
    ap.add_argument("--grid", type=int, default=16,
                    help="points per axis of the probe lattice")
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="probe this checkpoint file instead of the "
                         "experiment's latest (path, or a name relative "
                         "to EXPERIMENT_DIR)")
    ap.add_argument("--device", default=None,
                    help="where the bender runs: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = probe(args.experiment, args.grid, args.checkpoint, args.device)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
