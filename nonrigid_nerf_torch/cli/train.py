"""NR-NeRF training CLI of the port
(counterpart of the JAX package's root train.py).

    python3 -m nonrigid_nerf_torch.cli.train --config configs/<scene>.txt
    python3 -m nonrigid_nerf_torch.cli.train --config <file> --device cpu

Every key of the config file (`key = value` lines, the reference's
configargparse format) is also a flag; boolean keys have `--<key>` and
`--no_<key>`. Without `--config`, configs/default.txt is read when it
exists. `--device` (cuda unless given) is the one flag the JAX CLI lacks:
without a GPU it raises unless asked for the CPU.

Data parallelism: one process per GPU, launched by torchrun,

    python3 -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m nonrigid_nerf_torch.cli.train --config <file>
    (the same with --device cpu: gloo ranks on the CPU)

brings up the process group first (`parallel/multihost.py`; the JAX
package's NRNERF_* variables work too), splits each step's N_rand rays over
the ranks (`parallel/mesh.py`) and renders the validation frame, videos and
test-set images over them. Rank 0 alone creates, wipes and backs up the
experiment folder, writes args.txt, config.txt, cameras.obj, metrics.jsonl,
the checkpoints and the images; every rank loads the dataset.

Orchestration per the reference main_function (train.py:1325-1953): load
data -> dump args.txt/config.txt -> snapshot the code into backup/ -> build
or resume the train state -> volume extent probe (cameras.obj) -> the
training loop `apps/train.py:train`, with validation images every `i_img`
steps, spiral videos every `i_video` steps, training-subset and test-set
renders every `i_testset` steps, checkpoints every `i_weights` steps and at
the end. The experiment folder has the JAX package's layout, so its
`free_viewpoint_rendering.load_experiment` opens it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

from nonrigid_nerf_torch import config as cfg_mod
from nonrigid_nerf_torch.config import (Args, DEFAULTS,
                                        model_config_from_args,
                                        parse_config_file,
                                        render_settings_from_args,
                                        resolve_seed, train_config_from_args)
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.parallel import multihost
from nonrigid_nerf_torch.utils.volume import determine_nerf_volume_extent

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PACKAGE_DIR)


def config_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="NR-NeRF training on PyTorch + CUDA")
    parser.add_argument("--config", type=str, default=None,
                        help="config file path (key = value lines)")
    parser.add_argument("--device", type=str, default=None,
                        help="where to train: cuda (the default) or cpu")
    for key in DEFAULTS:
        if key == "config":
            continue
        if key in cfg_mod._BOOL_KEYS:
            parser.add_argument(f"--{key}", dest=key, default=None,
                                action="store_true")
            # bools that default to True need an explicit off switch
            parser.add_argument(f"--no_{key}", dest=key, default=None,
                                action="store_false")
        elif key in cfg_mod._INT_KEYS:
            parser.add_argument(f"--{key}", type=int, default=None)
        elif key in cfg_mod._FLOAT_KEYS:
            parser.add_argument(f"--{key}", type=float, default=None)
        else:
            parser.add_argument(f"--{key}", type=str, default=None)
    return parser


def _args_from_namespace(ns: argparse.Namespace) -> Args:
    """The config file's values (or configs/default.txt's), overridden by
    every flag given; `--device` is not part of the experiment's args."""
    values = {}
    config_path = ns.config
    if config_path is None and os.path.exists(cfg_mod.default_config_path()):
        config_path = cfg_mod.default_config_path()
    if config_path is not None:
        values.update(parse_config_file(config_path))
        values["config"] = config_path
    for key, val in vars(ns).items():
        if key not in ("config", "device") and val is not None:
            values[key] = val
    return Args(**values)


def parse_args(argv=None) -> Args:
    return _args_from_namespace(config_parser().parse_args(argv))


def create_folder(folder: str) -> None:
    os.makedirs(folder, exist_ok=True)


def backup(results_folder: str) -> None:
    """Snapshot the port's sources (Python and CUDA) and the default config
    into backup/, so the experiment records the code that trained it
    (reference: train.py:1962-2001)."""
    print("backing up... ", flush=True, end="")
    backup_folder = os.path.join(results_folder, "backup")
    for root, dirs, files in os.walk(PACKAGE_DIR):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
        rel = os.path.relpath(root, REPO_DIR)
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                create_folder(os.path.join(backup_folder, rel))
                shutil.copyfile(os.path.join(root, f),
                                os.path.join(backup_folder, rel, f))
    default_cfg = os.path.join(REPO_DIR, "configs", "default.txt")
    if os.path.exists(default_cfg):
        create_folder(os.path.join(backup_folder, "configs"))
        shutil.copyfile(default_cfg,
                        os.path.join(backup_folder, "configs", "default.txt"))
    print("done.", flush=True)


def load_dataset(args: Args, device: DeviceLike = None):
    """Data loading + mappings + intrinsics + split + bounds, and the
    device dataset (reference: main_function setup, train.py:1336-1430)."""
    from nonrigid_nerf_torch.data import (block_train_test_split,
                                          build_ray_dataset, get_intrinsics,
                                          get_multi_view_mappings,
                                          load_llff_data,
                                          load_llff_data_multi_view)
    if args.dataset_type != "llff":
        raise ValueError(f"Unknown dataset type {args.dataset_type}")

    datadir = args.datadir
    multi_view = os.path.exists(
        os.path.join(datadir, "image_to_camera_id_and_timestep.json"))
    loader = load_llff_data_multi_view if multi_view else load_llff_data
    images, poses, bds, render_poses, _ = loader(datadir, factor=args.factor)
    extras = get_multi_view_mappings(images.shape[0], datadir)
    hwf = poses[0, :3, 4]
    # multi-view calibration.json stores full-resolution focal/center
    # values, divided by args.factor (reference: train.py:1354-1366)
    intrinsics = get_intrinsics(
        datadir, extras, images, hwf, factor=args.factor,
        ray_bending_latent_size=args.ray_bending_latent_size)

    i_train, i_test = block_train_test_split(
        len(extras["raw_timesteps"]), extras["imageid_to_timestepid"],
        args.train_block_size, args.test_block_size)

    near = float(np.min(bds)) * 0.9
    far = float(np.max(bds))
    print(f"Loaded llff {images.shape} near={near:.4f} far={far:.4f} "
          f"{'multi-view' if multi_view else 'monocular'}")
    print("TRAIN views are", i_train)
    print("TEST views are", i_test)

    ds = build_ray_dataset(images, poses[:, :3, :4], intrinsics, extras,
                           i_train, i_test, near, far, device=device)
    return ds, images, poses, render_poses, intrinsics, extras, i_train, i_test


def _write_videos(moviebase: str, rgbs: np.ndarray, disps: np.ndarray) -> None:
    """The reference's four videos at an i_video step (reference:
    train.py:1736-1781): rgb, disp (normalized over all frames), disp_jet
    and disp_phong (normalized per frame)."""
    from nonrigid_nerf_torch.ops.math import to8b
    from nonrigid_nerf_torch.utils.video import mp4_writer
    from nonrigid_nerf_torch.utils.viz import (disparity_to_blinn_phong,
                                               disparity_to_jet)
    writer = mp4_writer()
    if writer is None:
        print(f"videos skipped ({moviebase}*.mp4): no mp4 writer imports "
              "(OpenCV)", flush=True)
        return
    videos = {
        "rgb": to8b(rgbs),
        "disp": to8b(disps / np.max(disps)),
        "disp_jet": to8b(np.stack([disparity_to_jet(d / np.max(d))
                                   for d in disps])),
        "disp_phong": to8b(np.stack([disparity_to_blinn_phong(d / np.max(d))
                                     for d in disps])),
    }
    for kind, frames in videos.items():
        try:
            writer(f"{moviebase}{kind}.mp4", frames, fps=30)
        except (OSError, RuntimeError, ValueError) as e:
            print(f"video write failed for {moviebase}{kind}.mp4: {e}",
                  flush=True)


def check_supported(args: Args) -> None:
    """Reject the JAX package's options that the port does not run."""
    fmt = args.checkpoint_format
    if fmt != "npz":
        raise ValueError(f"--checkpoint_format {fmt!r}: the port writes npz "
                         "checkpoints only")
    if int(args.sampling_prefetch) > 1:
        raise ValueError(
            f"--sampling_prefetch {args.sampling_prefetch}: the presampled "
            "step is not ported (ROADMAP.md queue 1 item 7); -1, 0 and 1 "
            "run the plain step")


def main_function(args: Args, device: DeviceLike = None) -> None:
    from nonrigid_nerf_torch.apps.render_path import (downscale_intrinsics,
                                                      render_path)
    from nonrigid_nerf_torch.apps.train import initial_state, train
    from nonrigid_nerf_torch.ops.math import to8b
    from nonrigid_nerf_torch.ops.rays import get_rays
    from nonrigid_nerf_torch.parallel.mesh import make_auto_renderer
    from nonrigid_nerf_torch.utils.image_io import imwrite

    device = resolve_device(device)
    check_supported(args)
    # seed = -1: a fresh random seed, resolved BEFORE args.txt is dumped so
    # the run is reproducible after the fact
    args = args.replace(seed=multihost.broadcast_from_main(
        resolve_seed(args).seed))       # one seed for every rank: rank 0's
    world = multihost.world_size()
    main = multihost.is_main()

    (ds, images, poses, render_poses, intrinsics, extras,
     i_train, i_test) = load_dataset(args, device)

    logdir = os.path.join(args.rootdir, args.expname, "logs")
    if main:
        create_folder(logdir)
        args.dump(os.path.join(logdir, "args.txt"))
        if args.config is not None and os.path.exists(args.config):
            shutil.copyfile(args.config, os.path.join(logdir, "config.txt"))

    cfg = model_config_from_args(args)
    tc = train_config_from_args(args)
    rs = render_settings_from_args(args, ds.near, ds.far)
    state = initial_state(cfg, tc, ds.num_timesteps, logdir, device,
                          no_reload=args.no_reload, ft_path=args.ft_path)

    # volume extent probe + cameras.obj (reference: train.py:1485-1489)
    probe_intrinsics = [intrinsics[extras["imageid_to_viewid"][i]]
                        for i in range(poses.shape[0])]
    min_point, max_point = determine_nerf_volume_extent(
        state.model, cfg, rs, poses[:, :3, :4], probe_intrinsics,
        output_folder=logdir if main else None)
    scripts_dict = {"near": ds.near, "far": ds.far,
                    "min_nerf_volume_point": min_point.tolist(),
                    "max_nerf_volume_point": max_point.tolist(),
                    "image_folder": "images"}
    ckpt_extras = {
        "intrinsics": {str(k): dict(v) for k, v in intrinsics.items()},
        "scripts_dict": scripts_dict,
        "dataset_extras": {k: v for k, v in extras.items()
                           if isinstance(v, (list, bool, int, float, str))},
    }
    metrics_path = os.path.join(logdir, "metrics.jsonl") \
        if args.metrics_file and main else None
    if world > 1:
        print(f"data-parallel training over {world} devices", flush=True)

    def latents_of(model, ids):
        table = model.latents.detach().cpu().numpy()
        return np.stack([table[extras["imageid_to_timestepid"][j]]
                         for j in ids])

    # validation images (the reference parses i_img but its TF-summary
    # consumer is dead code, train.py:1910-1950): one held-out view, or the
    # first training view, every i_img steps
    val_renderer = None
    if args.i_img and args.i_img > 0:
        val_id = int(i_test[0]) if len(i_test) > 0 else int(i_train[0])
        val_intrin = downscale_intrinsics(
            [intrinsics[extras["imageid_to_viewid"][val_id]]],
            args.render_factor)[0]
        val_renderer = make_auto_renderer(
            cfg, rs.test_mode(), chunk=args.chunk, device=device,
            n_rays_hint=int(val_intrin["height"]) * int(val_intrin["width"]))
        if main:
            create_folder(os.path.join(logdir, "val_images"))

    def validation_image(i, model):
        vh, vw = int(val_intrin["height"]), int(val_intrin["width"])
        c2w = torch.as_tensor(np.asarray(poses[val_id][:3, :4], np.float32),
                              device=device)
        rays_o, rays_d = get_rays(c2w, val_intrin)
        lat = model.latents.detach()[
            extras["imageid_to_timestepid"][val_id]].reshape(1, -1)
        out = val_renderer(model, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                           lat.expand(vh * vw, -1))
        if not main:
            return
        rgb = out["rgb_map"].reshape(vh, vw, 3).cpu().numpy()
        gt = images[val_id]
        if args.render_factor:
            gt = gt[::args.render_factor, ::args.render_factor][:vh, :vw]
        val_psnr = float(-10.0 * np.log10(np.mean((gt - rgb) ** 2)))
        imwrite(os.path.join(logdir, "val_images", f"{i:06d}.png"), to8b(rgb))
        print(f"[VAL] Iter: {i} view {val_id} PSNR: {val_psnr:.2f}",
              flush=True)
        if metrics_path:
            with open(metrics_path, "a") as mf:
                mf.write(json.dumps({"step": i, "val_view": val_id,
                                     "val_psnr": round(val_psnr, 4)}) + "\n")

    def render_views(model, ids, **kw):
        return render_path(
            model, cfg, rs, poses[ids][:, :3, :4],
            [intrinsics[extras["imageid_to_viewid"][j]] for j in ids],
            latents_of(model, ids), chunk=args.chunk,
            render_factor=args.render_factor, device=device, **kw)

    def videos(i, model):
        print("rendering video...", flush=True)
        if args.render_test:
            frame_latents, video_poses = latents_of(model, i_test), poses[i_test]
        else:
            frame_latents = np.tile(latents_of(model, i_test[:1]),
                                    (len(render_poses), 1))
            video_poses = render_poses
        rgbs, disps = render_path(
            model, cfg, rs, video_poses[:, :3, :4],
            [intrinsics[0]] * len(video_poses), frame_latents,
            chunk=args.chunk, render_factor=args.render_factor, device=device)
        if main:
            _write_videos(
                os.path.join(logdir, f"{args.expname}_spiral_{i:06d}_"),
                rgbs, disps)
        # end-of-training full-training-set render (reference:
        # train.py:1782-1850, on the LAST i_video interval)
        if i >= args.N_iters + 1 - args.i_video:
            print("rendering full training set...", flush=True)
            rgbs, disps = render_views(model, i_train)
            if main:
                _write_videos(
                    os.path.join(logdir, f"{args.expname}_training_{i:06d}_"),
                    rgbs, disps)

    def test_renders(i, model):
        # every rank renders (render_path), rank 0 writes
        trainsubsavedir = os.path.join(logdir, f"trainsubset_{i:06d}")
        if main:
            create_folder(trainsubsavedir)
        i_train_sub = i_train
        if len(i_test) > 0 and i < args.N_iters + 1 - args.i_video:
            stride = max(1, int(len(i_train_sub) / max(len(i_test), 1) + 0.5))
            i_train_sub = i_train_sub[::stride]
        render_views(model, i_train_sub, gt_imgs=images[i_train_sub],
                     savedir=trainsubsavedir)
        print("Saved some training images", flush=True)
        if len(i_test) > 0:
            testsavedir = os.path.join(logdir, f"testset_{i:06d}")
            if main:
                create_folder(testsavedir)
            render_views(model, i_test, gt_imgs=images[i_test],
                         savedir=testsavedir)
            print("Saved test set", flush=True)

    def on_step(i, state):
        if val_renderer is not None and i % args.i_img == 0:
            validation_image(i, state.model)
        if (i % args.i_video == 0 and len(render_poses) > 0
                and len(i_test) > 0 and not extras["is_multiview"]):
            videos(i, state.model)
        if i % args.i_testset == 0:
            test_renders(i, state.model)

    train(cfg, tc, rs, ds, logdir, device=device, i_print=args.i_print,
          i_weights=args.i_weights, extras=ckpt_extras,
          debug_metrics=args.debug, state=state,
          die_at_step=args.die_at_step, on_step=on_step,
          profile_steps=args.profile_steps, metrics_file=args.metrics_file)


def main(argv=None) -> int:
    ns = config_parser().parse_args(argv)
    args = _args_from_namespace(ns)
    # the process group first, before any tensor (JAX train.py:554-563),
    # then the device, before anything is written
    multihost.maybe_initialize(ns.device)
    device = resolve_device(ns.device)
    results_folder = os.path.join(args.rootdir, args.expname)
    print(results_folder, flush=True)
    if multihost.is_main():
        create_folder(results_folder)
        if args.no_reload:
            shutil.rmtree(results_folder)
            create_folder(results_folder)
        backup(results_folder)
    multihost.barrier()     # no rank reads the folder before the wipe
    main_function(args, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
