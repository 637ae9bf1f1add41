"""Free-viewpoint rendering, scene editing and evaluation of a trained
experiment, on PyTorch + CUDA (counterpart of the JAX package's root
free_viewpoint_rendering.py).

    python3 -m nonrigid_nerf_torch.cli.free_viewpoint_rendering \\
        --input <experiment folder> --deformations {train,test,all} \\
        --camera_path {input_reconstruction,fixed,spiral,adaptive_spiral,
                       time_interpolation} [--fixed_view N]
        [--forced_background_stabilization T] [--motion_factor F]
        [--foreground_removal T] [--render_canonical]
        [--export_ray_bending_objs] [--output_video_fps N]
        [--num_target_frames N] [--view_stride K] [--quantize_inference]
        [--device cpu]

The CLI of the reference (free_viewpoint_rendering.py:880-941). Per frame it
writes rgb, correspondences, rigidity (+jet) and disparity (+jet, +phong)
PNGs, and mp4 videos of each; a `fixed` path adds the background-stability
image and `background_stability.json`, an `input_reconstruction` path a
PSNR / SSIM / LPIPS `scores.json` with error-map folders (reference:
free_viewpoint_rendering.py:568-876). `--device` (cuda unless given) is the
one flag the JAX CLI lacks: without a GPU it raises before anything is
written unless asked for the CPU.

Launched by torchrun (`python3 -m torch.distributed.run --nproc_per_node N
-m nonrigid_nerf_torch.cli.free_viewpoint_rendering ...`), every rank loads
the experiment and renders each frame's share of rays
(`parallel.make_auto_renderer`), and rank 0 alone writes the images,
videos, `scores.json` and `background_stability.json`.

The correspondence and rigidity images need the median-visibility surface
sample of each pixel. The reference hauls the (H, W, samples, 3) details to
the host; here `_surface_post` reduces each ray block on the device inside
the renderer's block loop, so only (H, W, 3) maps leave it.

An experiment renders with the code that trained it, as in the JAX CLI:
when `<input>/backup/nonrigid_nerf_torch` exists (the training CLI's
snapshot) and this module was not loaded from it, `main` runs the
snapshot's own CLI in a child process with the same arguments, the
snapshot first on the child's sys.path (`python3 -P`, so that the working
directory does not put the checkout ahead of it), and returns the child's
exit code. The child carries `SNAPSHOT_ENV` so that it does not hand on
again, and builds the snapshot's kernels into the snapshot's own `_build/`.
Without a snapshot, or when the functions below are called directly, the
checkout's code renders.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.parallel import multihost


# set in the child that renders with an experiment's code snapshot
SNAPSHOT_ENV = "NRNERF_TORCH_SNAPSHOT"


def create_folder(folder):
    os.makedirs(folder, exist_ok=True)


def load_experiment(input_folder: str, device: DeviceLike = None):
    """(args, model on `device`, checkpoint extras) of a trained experiment:
    its logs/args.txt and newest checkpoint (reference:
    free_viewpoint_rendering.py:18-34)."""
    from nonrigid_nerf_torch.checkpoints import (latest_checkpoint,
                                                 load_checkpoint)
    from nonrigid_nerf_torch.config import (Args, model_config_from_args,
                                            parse_config_file)

    device = resolve_device(device)
    logdir = os.path.join(input_folder, "logs")
    args = Args(**parse_config_file(os.path.join(logdir, "args.txt")))
    ckpt_path = latest_checkpoint(logdir)
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint found under {logdir}")
    step, model, extras = load_checkpoint(ckpt_path,
                                          model_config_from_args(args),
                                          device=device)
    print(f"loaded checkpoint {ckpt_path} at step {step}")
    return args, model, extras


def _surface_post(out):
    """The median-visibility surface sample of each ray, on the device: its
    canonical-space position and its rigidity (reference, on the host:
    free_viewpoint_rendering.py:616-658)."""
    w = out.get("fine_visibility_weights", out.get("visibility_weights"))
    pts = out.get("fine_input_pts", out.get("input_pts"))
    acc = torch.cumsum(w, dim=-1)
    idx = torch.argmin(torch.abs(acc - 0.5), dim=-1)          # (R,)
    surface = torch.gather(
        pts, -2, idx[:, None, None].expand(-1, 1, pts.shape[-1]))[:, 0]
    res = {"rgb_map": out["rgb_map"], "disp_map": out["disp_map"],
           "surface_points": surface}
    rig_key = "fine_rigidity_mask" if "fine_rigidity_mask" in out else (
        "rigidity_mask" if "rigidity_mask" in out else None)
    if rig_key is not None:
        res["surface_rigidity"] = torch.gather(
            out[rig_key][..., 0], -1, idx[:, None])[:, 0]
    return res


def setup(input_folder: str, device: DeviceLike = None):
    """A trained experiment as one namespace, for notebooks and scripts
    (the reference's tuple of closures, free_viewpoint_rendering.py:392-411):

        fvr = setup("experiments/my_scene")
        rgbs, disps = fvr.render(fvr.poses[:3], fvr.frame_latents[:3])
        edited, _   = fvr.render(fvr.poses[:1], fvr.frame_latents[:1],
                                 edit=EditConfig(test_time_scaling=2.0))

    The attributes are the JAX CLI's: args, cfg, rs, params (the JAX-layout
    parameter tree, numpy), ckpt_extras, dataset, images, poses,
    render_poses, intrinsics, extras, i_train, i_test, latents,
    frame_latents, render, to8b, disparity_to_jet and
    disparity_to_blinn_phong; and `model`, the module that renders."""
    import types

    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.cli.train import load_dataset
    from nonrigid_nerf_torch.config import (EditConfig,
                                            model_config_from_args,
                                            render_settings_from_args)
    from nonrigid_nerf_torch.ops.math import to8b
    from nonrigid_nerf_torch.utils.viz import (disparity_to_blinn_phong,
                                               disparity_to_jet)
    from nonrigid_nerf_torch.weights import params_to_jax

    device = resolve_device(device)
    args, model, ckpt_extras = load_experiment(input_folder, device)
    (ds, images, poses, render_poses, intrinsics, extras,
     i_train, i_test) = load_dataset(args, device)

    cfg = model_config_from_args(args)
    rs = render_settings_from_args(args, ds.near, ds.far).test_mode()
    latents = model.latents.detach().cpu().numpy()
    frame_latents = np.stack(
        [latents[extras["imageid_to_timestepid"][i]]
         for i in range(len(images))])

    def render(render_poses_, frame_latents_, edit: EditConfig = None,
               render_factor: int = 0, detailed: bool = False,
               view_ids=None):
        """Render poses with per-frame latents; returns (rgbs, disps) numpy
        stacks (reference: render_convenient,
        free_viewpoint_rendering.py:202-337). `view_ids` picks each frame's
        intrinsics (view 0's by default)."""
        rp = np.asarray(render_poses_)
        if view_ids is None:
            view_ids = [extras["imageid_to_viewid"][0]] * len(rp)
        intr = [intrinsics[v] for v in view_ids]
        return render_path(
            model, cfg, rs, rp[:, :3, :4], intr, np.asarray(frame_latents_),
            chunk=args.chunk, render_factor=render_factor, detailed=detailed,
            edit=edit if edit is not None else EditConfig(), verbose=False,
            device=device)

    return types.SimpleNamespace(
        args=args, cfg=cfg, rs=rs, params=params_to_jax(model), model=model,
        ckpt_extras=ckpt_extras, dataset=ds, images=images, poses=poses,
        render_poses=render_poses, intrinsics=intrinsics, extras=extras,
        i_train=i_train, i_test=i_test, latents=latents,
        frame_latents=frame_latents, render=render, to8b=to8b,
        disparity_to_jet=disparity_to_jet,
        disparity_to_blinn_phong=disparity_to_blinn_phong)


def output_name(fvr_args) -> str:
    """The output folder's name: the path and every edit (reference:
    free_viewpoint_rendering.py:425-446)."""
    name = fvr_args.deformations + "_" + fvr_args.camera_path
    if fvr_args.camera_path == "fixed":
        name += "_" + str(fvr_args.fixed_view)
    if fvr_args.forced_background_stabilization is not None:
        name += "_fbs_" + str(fvr_args.forced_background_stabilization)
    if fvr_args.motion_factor is not None:
        name += "_exaggeration_" + str(fvr_args.motion_factor)
    if fvr_args.foreground_removal is not None:
        name += "_removal_" + str(fvr_args.foreground_removal)
    if fvr_args.render_canonical:
        name += "_canonical"
    if fvr_args.quantize_inference:
        name += "_int8"
    if fvr_args.view_stride > 1:
        name += "_stride" + str(fvr_args.view_stride)
    return name


def _calibration_rays(poses, intrinsics, extras, frame_latents, n_images,
                      device):
    """Rays and latents of 8 frames spread over the sequence, 64 rays a
    frame, for the int8 calibration."""
    from nonrigid_nerf_torch.ops.rays import get_rays
    sel = np.unique(np.linspace(0, n_images - 1, 8).astype(int))
    cal_o, cal_d, cal_l = [], [], []
    for i in sel:
        intrin = intrinsics[extras["imageid_to_viewid"][i]]
        co, cd = get_rays(torch.as_tensor(
            np.asarray(poses[i], np.float32)[:3, :4], device=device), intrin)
        co = co.reshape(-1, 3).cpu().numpy()
        cd = cd.reshape(-1, 3).cpu().numpy()
        stride = max(1, co.shape[0] // 64)
        cal_o.append(co[::stride][:64])
        cal_d.append(cd[::stride][:64])
        cal_l.append(np.broadcast_to(
            frame_latents[i], (cal_o[-1].shape[0], frame_latents.shape[-1])))
    return (len(sel), np.concatenate(cal_o), np.concatenate(cal_d),
            np.concatenate(cal_l))


def free_viewpoint_rendering(fvr_args, device: DeviceLike = None) -> str:
    """Render, edit and score the experiment `fvr_args.input` as
    `build_parser()` describes; returns the output folder. `device`, or
    else `fvr_args.device`, is where it renders (cuda unless given)."""
    import dataclasses

    if device is None:
        device = getattr(fvr_args, "device", None)
    device = resolve_device(device)       # before anything is written
    args, model, ckpt_extras = load_experiment(fvr_args.input, device)

    from nonrigid_nerf_torch.cli.train import load_dataset
    from nonrigid_nerf_torch.config import (EditConfig, model_config_from_args,
                                            render_settings_from_args)
    from nonrigid_nerf_torch.engine.query import (edits_active,
                                                  use_fused_kernel)
    from nonrigid_nerf_torch.ops.math import to8b
    from nonrigid_nerf_torch.ops.rays import get_rays
    from nonrigid_nerf_torch.parallel.mesh import make_auto_renderer
    from nonrigid_nerf_torch.utils.image_io import imwrite
    from nonrigid_nerf_torch.utils.video import write_video
    from nonrigid_nerf_torch.utils.viz import (disparity_to_blinn_phong,
                                               disparity_to_jet)

    cfg = model_config_from_args(args)
    edit = EditConfig(
        rigidity_test_time_cutoff=fvr_args.forced_background_stabilization,
        test_time_scaling=fvr_args.motion_factor,
        nonrigid_object_removal_threshold=fvr_args.foreground_removal,
        render_canonical=fvr_args.render_canonical)

    if cfg.fused_kernel in ("on", "pts") and edits_active(edit):
        # a FORCED kernel mode in the experiment's args.txt makes the engine
        # refuse scene edits; a user who renders never chose that failure,
        # so the render falls back to the auto policy
        print(f"fused_kernel={cfg.fused_kernel!r} (from the experiment's "
              "args.txt) does not support scene edits; rendering with "
              "fused_kernel='auto'", flush=True)
        cfg = dataclasses.replace(cfg, fused_kernel="auto")

    if fvr_args.quantize_inference and (args.use_viewdirs
                                        or args.time_conditioned_baseline):
        # the int8 kernel covers the canonical MLP without view directions
        # only; nothing is calibrated for what cannot run
        print("--quantize_inference: unsupported for viewdirs/baseline "
              "models; rendering with the default path", flush=True)
        fvr_args.quantize_inference = False
    if fvr_args.quantize_inference and not use_fused_kernel(
            dataclasses.replace(cfg, fused_kernel="int8"), edit, device):
        # checked NOW, so that the folder is not named _int8 for frames
        # that would take the f32 path
        print("--quantize_inference: the int8 kernel does not run for this "
              "configuration (scene edits active, or a non-default MLP "
              "architecture); rendering with the default f32 path",
              flush=True)
        fvr_args.quantize_inference = False

    output_folder = os.path.join(fvr_args.input, "output",
                                 output_name(fvr_args))
    main = multihost.is_main()      # every rank renders, rank 0 writes
    if main:
        create_folder(output_folder)

    # the dataset this experiment was trained on
    (ds, images, poses, render_poses, intrinsics, extras,
     i_train, i_test) = load_dataset(args, device)
    rs = render_settings_from_args(args, ds.near, ds.far).test_mode()

    latents = model.latents.detach().cpu().numpy()         # (T, L)
    frame_latents = np.stack(
        [latents[extras["imageid_to_timestepid"][i]]
         for i in range(len(images))])                      # (N, L)

    if fvr_args.quantize_inference:
        # post-training int8: activation scales calibrated on rays and
        # latents spread over the sequence; the canonical MLP then runs the
        # int8 kernel (ops/kernels/quant_mlp.py)
        from nonrigid_nerf_torch.ops.kernels.quant_mlp import \
            quantize_for_inference
        n_sel, cal_o, cal_d, cal_l = _calibration_rays(
            poses, intrinsics, extras, frame_latents, len(images), device)
        model = quantize_for_inference(model, cfg, cal_o, cal_d, cal_l,
                                       ds.near, ds.far, n_rays=512)
        cfg = dataclasses.replace(cfg, fused_kernel="int8")
        print(f"int8 inference: calibrated on {n_sel} frames", flush=True)

    # the deformation subset (reference: free_viewpoint_rendering.py:494-509)
    if fvr_args.deformations == "train":
        indices = np.asarray(i_train)
    elif fvr_args.deformations == "test":
        indices = np.asarray(i_test)
    elif fvr_args.deformations == "all":
        indices = np.arange(len(images))
    else:
        raise ValueError("invalid --deformations argument")
    if len(indices) == 0:
        raise ValueError(f"deformation subset {fvr_args.deformations!r} "
                         "is empty for this experiment")
    if fvr_args.view_stride > 1:
        # every k-th frame of the subset; scores.json stays aligned with
        # its ground truth, and the folder's _stride{k} suffix keeps the
        # subsampled artifacts apart from the full protocol's
        indices = indices[::fvr_args.view_stride]
    sub_poses = poses[indices]
    sub_latents = frame_latents[indices]
    sub_images = images[indices]

    # the camera path (reference: free_viewpoint_rendering.py:520-545)
    num_frames = len(indices)
    if fvr_args.camera_path == "input_reconstruction":
        path_poses = sub_poses
        path_intrinsics = [intrinsics[extras["imageid_to_viewid"][i]]
                           for i in indices]
    elif fvr_args.camera_path == "fixed":
        fixed = fvr_args.fixed_view
        path_poses = np.tile(poses[fixed][None], (num_frames, 1, 1))
        path_intrinsics = [intrinsics[extras["imageid_to_viewid"][fixed]]
                           ] * num_frames
    elif fvr_args.camera_path == "spiral":
        reps = -(-num_frames // max(len(render_poses), 1))
        path_poses = np.concatenate([np.asarray(render_poses)] * reps,
                                    0)[:num_frames]
        path_intrinsics = [intrinsics[extras["imageid_to_viewid"][0]]
                           ] * num_frames
    elif fvr_args.camera_path == "adaptive_spiral":
        # a spiral fitted to the trained scene (camera spread and scene
        # bounds), the adaptive path the reference leaves to the user
        # (reference README.md:259-261)
        from nonrigid_nerf_torch.data import adaptive_spiral_poses
        path_poses = adaptive_spiral_poses(poses[:, :3, :4], ds.near, ds.far,
                                           n_views=num_frames)
        path_intrinsics = [intrinsics[extras["imageid_to_viewid"][0]]
                           ] * num_frames
    elif fvr_args.camera_path == "time_interpolation":
        # slow motion between captured time steps: the latent codes
        # interpolated linearly, seen from a fixed camera (a recipe of the
        # reference, free_viewpoint_rendering.py:547-562)
        num_frames = fvr_args.num_target_frames
        t = np.linspace(0.0, len(sub_latents) - 1, num_frames)
        lo = np.floor(t).astype(int)
        hi = np.ceil(t).astype(int)
        frac = (t - lo)[:, None]
        sub_latents = (sub_latents[hi] * frac
                       + sub_latents[lo] * (1.0 - frac)).astype(np.float32)
        sub_images = None   # interpolated frames have no ground truth
        fixed = fvr_args.fixed_view
        path_poses = np.tile(poses[fixed][None], (num_frames, 1, 1))
        path_intrinsics = [intrinsics[extras["imageid_to_viewid"][fixed]]
                           ] * num_frames
    else:
        raise ValueError("invalid --camera_path argument")

    # the volume's extent colours the correspondences
    scripts = ckpt_extras.get("scripts_dict", {})
    if ("min_nerf_volume_point" in scripts
            and "max_nerf_volume_point" in scripts):
        min_pt = np.asarray(scripts["min_nerf_volume_point"])
        max_pt = np.asarray(scripts["max_nerf_volume_point"])
    else:
        # a checkpoint from before the extent probe: computed again as the
        # reference does (free_viewpoint_rendering.py:171), not assumed
        print("volume extent missing from checkpoint; recomputing",
              flush=True)
        from nonrigid_nerf_torch.utils.volume import \
            determine_nerf_volume_extent
        probe_intrinsics = [intrinsics[extras["imageid_to_viewid"][i]]
                            for i in range(poses.shape[0])]
        min_pt, max_pt = determine_nerf_volume_extent(
            model, cfg, rs, poses[:, :3, :4], probe_intrinsics)
    min_pt = min_pt.reshape(1, 1, 3)
    max_pt = max_pt.reshape(1, 1, 3)

    # every frame, with the surface extraction on the device
    rgbs, disps, corr_rgbs, rigidities = [], [], [], []
    renderer_cache = {}
    for f in range(num_frames):
        t0 = time.perf_counter()
        intrin = path_intrinsics[f]
        H, W = int(intrin["height"]), int(intrin["width"])
        if (H, W) not in renderer_cache:
            renderer_cache[(H, W)] = make_auto_renderer(
                cfg, rs, edit=edit, chunk=args.chunk, device=device,
                detailed=True, postprocess=_surface_post, n_rays_hint=H * W)
        render_fn = renderer_cache[(H, W)]

        rays_o, rays_d = get_rays(torch.as_tensor(
            np.asarray(path_poses[f], np.float32)[:3, :4], device=device),
            intrin)
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        lat = torch.as_tensor(np.asarray(sub_latents[f], np.float32),
                              device=device).reshape(1, -1).expand(H * W, -1)
        out = render_fn(model, rays_o, rays_d, lat)
        rgbs.append(out["rgb_map"].reshape(H, W, 3).cpu().numpy())
        disps.append(out["disp_map"].reshape(H, W).cpu().numpy())

        surface = out["surface_points"].reshape(H, W, 3).cpu().numpy()
        corr = (surface - min_pt) / (max_pt - min_pt)
        voxels = 100  # a small-voxel checkerboard makes the motion visible
        corr = corr * voxels
        corr = corr - corr.astype(int)
        corr_rgbs.append(corr)
        if "surface_rigidity" in out:
            rigidities.append(
                out["surface_rigidity"].reshape(H, W).cpu().numpy())

        # ray-bending line meshes: 100 random pixels rendered with every
        # sample, written as bent / not_bent / deltas OBJs (reference:
        # free_viewpoint_rendering.py:385, run_nerf_helpers.py:794-915)
        if fvr_args.export_ray_bending_objs and cfg.use_ray_bending:
            from nonrigid_nerf_torch.utils.viz import export_ray_bending_objs
            n_obj_rays = min(100, H * W)
            if "obj" not in renderer_cache:
                renderer_cache["obj"] = make_auto_renderer(
                    cfg, rs, edit=edit, chunk=n_obj_rays, device=device,
                    detailed=True, n_rays_hint=n_obj_rays)
            idx = torch.as_tensor(np.random.RandomState(0).choice(
                H * W, size=n_obj_rays, replace=False), device=device)
            out_obj = renderer_cache["obj"](model, rays_o[idx], rays_d[idx],
                                            lat[idx])
            if main:
                export_ray_bending_objs(
                    out_obj["initial_input_pts"].cpu().numpy(),
                    out_obj["input_pts"].cpu().numpy(),
                    os.path.join(output_folder, f"ray_bending_{f:06d}"),
                    subsample=n_obj_rays)
        print(f"rendered frame {f + 1}/{num_frames} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

    if not main:
        return output_folder
    rgbs = np.stack(rgbs)
    disps = np.stack(disps)
    corr_rgbs = np.stack(corr_rgbs)
    use_rigidity = len(rigidities) == num_frames

    # the frames' images (reference: free_viewpoint_rendering.py:666-704)
    disp_max = max(float(disps.max()), 1e-10)
    for i in range(num_frames):
        post = f"_{i:06d}.png"
        imwrite(os.path.join(output_folder, "rgb" + post), to8b(rgbs[i]))
        imwrite(os.path.join(output_folder, "correspondences" + post),
                to8b(corr_rgbs[i]))
        raw_disp = disps[i] / max(float(disps[i].max()), 1e-10)
        imwrite(os.path.join(output_folder, "disp" + post), to8b(raw_disp))
        imwrite(os.path.join(output_folder, "disp_jet" + post),
                to8b(disparity_to_jet(raw_disp)))
        imwrite(os.path.join(output_folder, "disp_phong" + post),
                to8b(disparity_to_blinn_phong(raw_disp)))
        if use_rigidity:
            imwrite(os.path.join(output_folder, "rigidity" + post),
                    to8b(rigidities[i]))
            imwrite(os.path.join(output_folder, "rigidity_jet" + post),
                    to8b(disparity_to_jet(rigidities[i])))

    # videos (reference: free_viewpoint_rendering.py:706-768)
    fps = fvr_args.output_video_fps
    vp = os.path.join(output_folder, "video_")
    write_video(vp + "rgb.mp4", to8b(rgbs), fps)
    write_video(vp + "correspondences.mp4", to8b(corr_rgbs), fps)
    write_video(vp + "disp.mp4", to8b(disps / disp_max), fps)
    write_video(vp + "disp_jet.mp4",
                np.stack([to8b(disparity_to_jet(d / disp_max))
                          for d in disps]), fps)
    write_video(vp + "disp_phong.mp4",
                np.stack([to8b(disparity_to_blinn_phong(d / disp_max))
                          for d in disps]), fps)
    if use_rigidity:
        write_video(vp + "rigidity.mp4",
                    np.stack([to8b(r) for r in rigidities]), fps)
        write_video(vp + "rigidity_jet.mp4",
                    np.stack([to8b(disparity_to_jet(r))
                              for r in rigidities]), fps)

    # background stability (reference: free_viewpoint_rendering.py:771-785)
    if fvr_args.camera_path == "fixed":
        std = 10.0 * np.mean(np.std(rgbs, axis=0), axis=-1)
        imwrite(os.path.join(output_folder, "standard_deviations.png"),
                to8b(disparity_to_jet(np.clip(std, 0.0, 1.0))))
        # the reference only visualizes it; the scalar makes runs
        # comparable (lower is a more stable background)
        with open(os.path.join(output_folder,
                               "background_stability.json"), "w") as f:
            json.dump({"mean_10x_std": float(np.mean(std)),
                       "max_10x_std": float(np.max(std)),
                       "num_frames": int(len(rgbs)),
                       "fixed_view": int(fvr_args.fixed_view)}, f, indent=2)

    # the scores (reference: free_viewpoint_rendering.py:787-876)
    if fvr_args.camera_path == "input_reconstruction":
        write_scores(output_folder, sub_images, rgbs)

    print("output written to", output_folder, flush=True)
    return output_folder


def write_scores(output_folder, gt_images, rgbs):
    """scores.json (PSNR, SSIM, LPIPS per frame and their means) and the
    error-map folders of an input_reconstruction path."""
    from nonrigid_nerf_torch.ops.math import to8b
    from nonrigid_nerf_torch.utils.image_io import imwrite
    from nonrigid_nerf_torch.utils.metrics import lpips_distance, psnr, ssim
    from nonrigid_nerf_torch.utils.viz import disparity_to_jet

    naive_folder = os.path.join(output_folder, "naive_errors")
    ssim_folder = os.path.join(output_folder, "ssim_errors")
    create_folder(naive_folder)
    create_folder(ssim_folder)

    # undistortion can leave masked-out black pixels in the ground truth
    mask = np.sum(gt_images[0], axis=-1) == 0.0
    if mask.all():
        # a fully black first frame: nothing is masked
        mask = np.zeros_like(mask)
    scores = {}
    lpips_missing = False
    for i in range(len(rgbs)):
        gt = gt_images[i].copy()
        gen = rgbs[i].copy()
        gt[mask] = 0.0
        gen[mask] = 0.0

        ssim_val, ssim_map = ssim(gt, gen, full=True)
        lp = lpips_distance(gt, gen)
        if lp is None:
            # no weights: null, NEVER a made-up number
            lpips_missing = True
        scores[i] = {"psnr": psnr(gt, gen), "ssim": ssim_val, "lpips": lp}

        error = np.linalg.norm(gt - gen, axis=-1) / np.sqrt(3.0)
        error = np.clip(error * 10.0, 0.0, 1.0)
        imwrite(os.path.join(naive_folder, f"error_{i:03d}.png"),
                to8b(disparity_to_jet(error)))
        ssim_err = 1.0 - np.mean(ssim_map, axis=-1)
        imwrite(os.path.join(ssim_folder, f"error_{i:03d}.png"),
                to8b(disparity_to_jet(ssim_err)))

    lpips_vals = [s["lpips"] for s in scores.values()
                  if s["lpips"] is not None]
    averaged = {
        "average_psnr": float(np.mean([s["psnr"] for s in scores.values()])),
        "average_ssim": float(np.mean([s["ssim"] for s in scores.values()])),
        "average_lpips": (float(np.mean(lpips_vals)) if lpips_vals else None),
        "lpips_available": not lpips_missing,
    }
    if lpips_missing:
        from nonrigid_nerf_torch.utils.lpips import lpips_available
        if lpips_available():
            print("LPIPS weights are installed but the evaluation images are "
                  "too small for the AlexNet trunk (~31 px per side "
                  "minimum); lpips is reported as null.")
        else:
            print("LPIPS weights not found; lpips is reported as null "
                  "(lpips_available: false). Generate data/lpips_alex.npz "
                  "once with tools/convert_lpips_weights.py (or pip install "
                  "lpips) for real values.")
    print(averaged, flush=True)
    scores.update(averaged)
    with open(os.path.join(output_folder, "scores.json"), "w") as f:
        json.dump(scores, f, indent=4)


def build_parser():
    parser = argparse.ArgumentParser(
        description="NR-NeRF free-viewpoint rendering on PyTorch + CUDA")
    parser.add_argument("--input", type=str, required=True,
                        help="experiment folder created by the training CLI")
    parser.add_argument("--deformations", type=str, required=True,
                        choices=["train", "test", "all"])
    parser.add_argument("--camera_path", type=str, required=True,
                        choices=["input_reconstruction", "fixed", "spiral",
                                 "adaptive_spiral", "time_interpolation"])
    parser.add_argument("--fixed_view", type=int, default=0)
    parser.add_argument("--forced_background_stabilization", type=float,
                        default=None)
    parser.add_argument("--motion_factor", type=float, default=None)
    parser.add_argument("--foreground_removal", type=float, default=None)
    parser.add_argument("--render_canonical", action="store_true")
    parser.add_argument("--export_ray_bending_objs", action="store_true",
                        help="per frame, write bent/not_bent/deltas OBJ line "
                             "meshes of 100 random rays (reference: "
                             "visualize_ray_bending)")
    parser.add_argument("--output_video_fps", type=int, default=5)
    parser.add_argument("--num_target_frames", type=int, default=120,
                        help="frame count for time_interpolation paths")
    parser.add_argument("--view_stride", type=int, default=1,
                        help="render/evaluate every k-th frame of the "
                             "deformation subset (the output folder gains a "
                             "_stride{k} suffix when > 1)")
    parser.add_argument("--quantize_inference", action="store_true",
                        help="render through the int8 kernel (mlp_i8), after "
                             "a post-training calibration on this scene's "
                             "rays; see ops/kernels/quant_mlp.py")
    parser.add_argument("--device", type=str, default=None,
                        help="where to render: cuda (the default) or cpu")
    return parser


# the child's program: the snapshot first on sys.path, then its CLI
SNAPSHOT_STUB = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
                 "from nonrigid_nerf_torch.cli.free_viewpoint_rendering "
                 "import main; sys.exit(main(sys.argv[1:]))")


def snapshot_dir(input_folder: str):
    """The experiment's backup/ folder where its code snapshot renders, or
    None where the checkout's code does: no snapshot, this module loaded
    from it, or already handed on to it."""
    backup = os.path.abspath(os.path.join(input_folder, "backup"))
    package = os.path.join(backup, "nonrigid_nerf_torch")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if (not os.path.isdir(package) or os.environ.get(SNAPSHOT_ENV)
            or os.path.realpath(package) == os.path.realpath(here)):
        return None
    return backup


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    fvr_args = build_parser().parse_args(argv)
    resolve_device(fvr_args.device)       # no GPU: raise here, in any case
    backup = snapshot_dir(fvr_args.input)
    if backup is not None:
        print(f"rendering with the experiment's code snapshot {backup}",
              flush=True)
        return subprocess.run(
            [sys.executable, "-P", "-c", SNAPSHOT_STUB, backup, *argv],
            env=dict(os.environ, **{SNAPSHOT_ENV: backup})).returncode
    multihost.maybe_initialize(fvr_args.device)     # before any tensor
    free_viewpoint_rendering(fvr_args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
