"""Export a trained experiment's renderer as a self-contained serving
artifact (see nonrigid_nerf_torch/serving.py; counterpart of
tools/export_serving.py).

    python3 -m nonrigid_nerf_torch.cli.export_serving --input experiments/my_scene \\
        --out my_scene.pt2 [--chunk 32768] [--device cuda]

The artifact holds the trained weights and the graph of the plain renderer
for one device (`--device` takes the place of the JAX tool's
`--platforms`); `<out>.meta.json` carries the calling convention and the
per-timestep latent table. Serving needs only torch:

    import torch
    render = torch.export.load("my_scene.pt2").module()
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="experiment folder")
    p.add_argument("--out", required=True, help="output .pt2 path")
    p.add_argument("--chunk", type=int, default=32768,
                   help="rays per call (fixed block shape)")
    p.add_argument("--device", default=None,
                   help="the device the artifact runs on: cuda (the "
                        "default) or cpu")
    # scene edits captured in the artifact (as in the free-viewpoint CLI)
    p.add_argument("--forced_background_stabilization", type=float,
                   default=None)
    p.add_argument("--motion_factor", type=float, default=None)
    p.add_argument("--foreground_removal", type=float, default=None)
    p.add_argument("--render_canonical", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from nonrigid_nerf_torch.cli.free_viewpoint_rendering import load_experiment
    from nonrigid_nerf_torch.config import (EditConfig, model_config_from_args,
                                            render_settings_from_args)
    from nonrigid_nerf_torch.device import resolve_device
    from nonrigid_nerf_torch.serving import export_renderer, save_exported

    device = resolve_device(args.device)
    exp_args, model, extras = load_experiment(args.input, device=device)
    near = float(extras["scripts_dict"]["near"])
    far = float(extras["scripts_dict"]["far"])
    cfg = model_config_from_args(exp_args)
    rs = render_settings_from_args(exp_args, near, far)
    edit = EditConfig(
        rigidity_test_time_cutoff=args.forced_background_stabilization,
        test_time_scaling=args.motion_factor,
        nonrigid_object_removal_threshold=args.foreground_removal,
        render_canonical=args.render_canonical)
    blob, meta = export_renderer(
        model, cfg, rs, chunk=args.chunk, device=device, edit=edit,
        extra_meta={"experiment": os.path.abspath(args.input),
                    "edit": {k: v for k, v in dataclasses.asdict(edit).items()
                             if v not in (None, False)}})
    save_exported(args.out, blob, meta)
    print(json.dumps({"out": args.out, "bytes": len(blob),
                      "chunk": meta["chunk"],
                      "latent_size": meta["latent_size"],
                      "device": meta["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
