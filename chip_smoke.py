#!/usr/bin/env python3
"""Smoke run of nonrigid_nerf_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Three model families run, each through its pair of kernels: the flagship
config (configs/example_sequence.txt) as it is (F: `mlp_fwd`, `mlp_bwd` at
the 64-lane encoding), the same config with use_viewdirs=True (`mlpv_fwd`,
`mlpv_bwd`), and the time-conditioned baseline of
results/r4_baseline_tc/args.txt (B: no bender, the 32-lane latent
concatenated to the encoding, `mlp_fwd` and `mlp_bwd` at 128 lanes; its
regularizer weights are 0). Then the flagship's two opt-in kernel modes:
fused_kernel="pts" (`mlpe_fwd`, `mlpe_bwd`: the Fourier encoding computed
inside the kernels; rendered and trained) and fused_kernel="int8"
(`mlp_i8`; rendered, after `quantize_for_inference` on the first pose's
rays). Then the training and free-viewpoint CLIs on a real
scene, and the trained r3_eval checkpoint in every mode. Last, the fused
point query's two entry points, `fused_point_query` (`fused_fwd`, `fused_bwd`)
and `fused_point_query_split` (`bend_fwd`, `mlp_fwd`; `mlp_bwd`,
`bend_bwd`), on the flagship's parameters.

Phases (each raises on failure; the exit code is then non-zero and no
result line is printed):

1. Print the card's name and power limit, build every CUDA kernel from the
   sources in this checkout (one nvcc per source, side by side), print the
   build times and what ptxas says of registers, spills and wgmma
   serialization; a kernel whose wgmma ptxas serialized fails the run.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, within the tolerance the CPU tests pin,
   and relaunch it to see bit-equal outputs; time kernel, plain version and
   a chain of bf16 torch.matmul calls (a yardstick only; for "pts" with the
   encoding in PyTorch before it, for "int8" a chain of torch._int_mm calls
   with elementwise requantization); compute the roofline bound. Points for
   `mlpe_fwd` / `mlpe_bwd` lie where the synthetic scene's bent points lie,
   so the sines' arguments reach hundreds of radians; B's 128-lane inputs
   hold 63 encoding lanes, 32 latent lanes (0.3 N(0, 1)) and 33 zero lanes.
   Forward kernels: chunk x N_samples (2^21) and chunk x (N_samples +
   N_importance) (2^22) points of a render block, and N_rand x N_samples
   (65,536) and N_rand x (N_samples + N_importance) (131,072) points of a
   training step, for B at 128 lanes as well as at 64. Backward kernels:
   the training step's two sizes (`mlp_i8`: the render sizes only).
3. Per family and mode, render frames at 384 x 512 through `render_path`,
   parameters from a seed, with the launch counts set to 0 just before and
   read just after (12 launches of the family's forward kernel per frame,
   none of the other's; for F and B all at the family's width, 64 or 128
   lanes). Render the same frames with fused_kernel="off" (plain f32 MLP)
   and require a PSNR of at least 40 dB between the two ("pts" and "int8"
   are held against the first family's "off" frames, the same parameters:
   40 dB and 30 dB). For F: a block of rays on the card against the same
   rays on the CPU. With view directions: the frames use finite-difference
   directions, and a block of rays is rendered with exact directions (a jvp
   through the bender), kernel against "off". Every frame is its own
   `render_path` call, and its time is printed with the median beside the
   mean (one frame's stall on the host shows as one). Profile one frame:
   device time by kernel and the device's idle share.
4. Per family, and in "pts" mode, train (1024 rays, 64 + 64 samples, a
   test split; all three regularizers, or for B none, as its run had) with
   `apps.train.train` on a synthetic image stack built in memory, launch
   counts set to 0 just before and read just after: 2
   forward and 4 backward launches per step, everything finite, the loss
   lower at the end than at the start; steps and rays per second over all
   steps after the first window of 25. Then, from the trained state: one
   step's losses and gradients with the kernels against fused_kernel="off"
   and against the kernels' plain versions on the same draws (the bender's
   and the latents' gradients included, the latents' named on its own: for
   B they learn through the MLP's input alone; with view directions in both
   direction modes); a checkpoint saved, loaded and stepped once, bit-equal
   to the step without the round trip; a profile of a few steps (device
   ms a step, idle share, the backward's kernels by name).
5. The training CLI on a real dataset, data_r5/occlusion (60 frames of
   256 x 192, 3 cameras x 20 timesteps) with its JAX run's config
   (results/r5_robustness_full/args.txt) cut to 200 steps, a validation
   frame and a save every 100. The phase tests the CLI, its loaders and its
   resume, not quality: its N_iters is 200, which also puts the offsets and
   divergence regularizers on a schedule of 200 steps, (1/100)^(1 - step /
   200), not the 200,000 of the JAX run (chip_quality.py keeps those). Run A: `python3 -m
   nonrigid_nerf_torch.cli.train` driven in this process, launch counts set
   to 0 just before and read just after (2 `mlp_fwd` and 2 `mlp_bwd` a
   step: the config has no test split, so one cotangent a network; 4
   `mlp_fwd` a validation frame, 2 for the volume probe, printed on its
   own line; no other kernel); the experiment folder (args.txt,
   config.txt, backup/, cameras.obj, metrics.jsonl, val_images/, latest.npz
   at step 200), finite values, the loss at step 200 below the loss at step
   50; steps/s over steps 51-200, the validation PSNRs and the peak device
   memory. Run B: the same command in a subprocess with `--die_at_step
   100` must die by SIGKILL (-9) and, started again, print "Reloading
   from"; its metrics.jsonl must equal A's at every printed step and its
   final parameters and Adam moments A's bit for bit.
6. Free-viewpoint rendering of run A's folder through `python3 -m
   nonrigid_nerf_torch.cli.free_viewpoint_rendering`, driven in this
   process on every 20th of the 60 training frames, launch counts set to 0
   just before and read just after each call: `input_reconstruction`
   (scores.json finite, lpips null; `mlp_fwd` 4 launches a frame, 2 blocks
   x 2 passes, and no other kernel), `fixed` (background_stability.json),
   `--motion_factor 2` (a scene edit: no kernel launches),
   `--quantize_inference` (`mlp_i8` 4 launches a frame; the frames at least
   30 dB from the same frames with fused_kernel = off in the experiment's
   args.txt), `--export_ray_bending_objs` on an `adaptive_spiral` path (3
   OBJ files a frame, 2 more `mlp_fwd` launches a frame for its 100 rays). Each frame's seconds as
   the CLI prints them, the median beside the mean.
7. The trained checkpoint of results/r3_eval (200,000 JAX steps of the
   flagship, 1,007,627 parameters) at its own 384 x 512 intrinsics, from
   two look-at poses inside the volume its scripts_dict records: `auto`,
   `pts` and `int8` (calibrated on the two poses' rays) against `off`, at
   least 40, 40 and 30 dB, 12 launches a frame of the mode's kernel only.
8. Data parallelism (`nonrigid_nerf_torch/parallel/`): the flagship's
   step on the synthetic stack of phase 4 for 50 steps from the seed's
   fresh state, three ways on the same (seed, step) generators: the
   single-process step (the reference), `make_parallel_train_step` at
   world size 1 on nccl in this process, and 2 spawned ranks sharing the
   card on gloo (NCCL refuses two ranks on one GPU; gloo all-reduces CUDA
   tensors). Each run's losses against the reference (step 1: rtol 2e-5;
   every step: 2e-3) and its final parameters (1 lrate; DP_LOSS_RTOL says
   why), the ranks' parameters bit-equal,
   and each rank's launches (counts set to 0 just before, read just
   after): 2 `mlp_fwd` and 4 `mlp_bwd` a step, nothing else.
9. The fused point query: each of its four kernels against its plain
   version at a render block's coarse pass (2^21 points, forwards) and a
   training step's two passes (65,536 and 131,072 points, forwards and
   backwards), bit-equal on relaunch, timed beside its plain version, its
   roofline bound and the same products as cuBLAS bf16 matmuls; then both
   entry points at the three sizes (backward through autograd on the JAX
   tests' loss at the training sizes), launch counts set to 0 just before
   and read just after each call, the split held bit-equal to the monolith
   and the gradients against the f32 modules'; and `fused_fwd` against what
   the engine spends on the same function (the f32 bender, then
   `mlpe_fwd`).
10. Print rows 1-6 and 11 (`mlp_fwd`, `mlp_bwd`, `mlpv_fwd`, `mlpv_bwd`,
   `mlpe_fwd`, `mlpe_bwd`, `mlp_i8`: csrc/mlp_sm90.cuh's chains on wgmma) at
   every size and width, each with its device time and share of the bound (a
   backward also with its two-pass floor and its device time by kernel:
   chain, dW, head sums, reduction; row 11 with the registers, spills and
   wgmma serialization ptxas reported in phase 1), rows 7 and 8 (`bend_fwd`,
   `bend_bwd`: the deformation field's kernels on csrc/mlp_sm90.cuh) with
   ptxas's report and row 8's device time by kernel (its kernel, the
   reduction), and rows 9 and 10 (`fused_fwd`, `fused_bwd`) likewise:
   ptxas's report of their chain kernels, row 10's two-pass floor and its
   device time by kernel (pre-pass, chain, dW, heads, reductions, the
   bender's backward); the kernels JSON line (eleven rows;
   `mlp_fwd` and `mlp_bwd` carry B's 128-lane checks, timings and launches
   under "lanes_128", and their share of the bound) and, last, the result
   line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Beside these: phase 2 and the fused phase hold every backward past one
launch (2^18 + 129 and 524,288 points; rows 8 and 10 also 2^21) in pieces
(ops/kernels/pieces.py) against its plain version, under each row's
"other_sizes"; phase 4b trains F at N_rand 4096 on one GPU; phase 4c
renders F, V, P, B and I at compute_dtype="bfloat16" against phase 3's f32
"off" frames and trains F and B; phase 5b runs the CLI presampled
(--sampling_prefetch 16) against the plain run; phase 6b exports the
serving artifact on the card and loads it in a process that imports torch
alone.
"""

import copy
import dataclasses
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
FRAMES = 2
H, W = 384, 512                  # the example sequence's frame size
CHUNK = 32768                    # render_path's default ray block
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
MIN_PSNR_DB = 40.0
MIN_PSNR_INT8_DB = 30.0          # int8 activations against the f32 render
TRAIN_FRAMES = 8                 # synthetic stack: 6 training + 2 test images
TRAIN_TEST_IDS = (3, 7)
TRAIN_STEPS = 150                # training steps without view directions
TRAIN_STEPS_VIEWDIRS = 200       # ... and with them
TRAIN_STEPS_PTS = 150            # ... and in fused_kernel="pts" mode
TRAIN_STEPS_BASELINE = 100       # ... and for the time-conditioned baseline
# the baseline's latent table: nonzero, so that the latent lanes 63 .. 94 of
# the MLP's input carry signal (as the JAX package's test of its kernel,
# tests/test_fused_kernel.py:209)
BASELINE_LATENT_SCALE = 0.3
# the regularizer weights (offsets, divergence, rigidity) of each run:
# configs/example_sequence.txt and results/r4_baseline_tc/args.txt
LOSS_WEIGHTS = {False: (60.0, 3.0, 0.0005), True: (0.0, 0.0, 0.0)}
TRAIN_PRINT = 25
PROFILE_STEPS = 5
# one training step with the kernels against fused_kernel="off" on the same
# draws: bf16 activations and cotangents against f32 ones. The JAX package's
# own test of this (tests/test_fused_kernel.py:132-155) allows 6% of each
# gradient's max magnitude.
STEP_LOSS_TOL_REL = 2e-2
STEP_GRAD_MIN_COSINE = 0.98
# ... and against the kernels' plain versions in the same step (the same
# arithmetic up to the order of the f32 sums): measured 0.9999 or more.
STEP_PLAIN_MIN_COSINE = 0.999
# With finite-difference view directions the gradient of the view encoding
# reaches the bent points through diffs / (|diffs| + 1e-6) of neighbouring
# samples, and the sorted union of a fine pass holds near-duplicate depths:
# the bf16 rounding of that gradient is amplified by 1 / |diffs| and the two
# terms of each point nearly cancel. Against the f32 step the bender's and
# the latents' gradients then keep their direction only roughly (measured
# here after 200 steps: 0.81, against 0.998 with exact directions), while
# they agree with the plain versions to 0.9999. Held to this floor there.
STEP_FD_DEFORMATION_MIN_COSINE = 0.5
# the CLI on a real dataset: the occlusion scene of data_r5/ with its JAX
# run's config, cut to 200 steps; a validation frame and a save every 100
CLI_CONFIG = os.path.join("results", "r5_robustness_full", "args.txt")
CLI_DATA = os.path.join("data_r5", "occlusion")
CLI_STEPS, CLI_PRINT, CLI_EVERY = 200, 50, 100
CLI_FRAME = (192, 256)           # the scene's frame: 2 ray blocks of CHUNK
# free-viewpoint rendering of the CLI's run A: every 20th of its 60 frames
FVR_STRIDE = 20
# the trained checkpoint of results/r3_eval (200,000 JAX steps on the
# example sequence): its frame is the example sequence's, 384 x 512
R3_EVAL = os.path.join("results", "r3_eval", "pretrained", "logs")
R3_EVAL_PARAMETERS = 1007627
R3_EVAL_LATENTS = (0, 43)        # the timesteps of its two frames
# the data-parallel phase: the flagship's step over ranks for DP_STEPS steps
# against the single-process step on the same generators. The first step
# starts from the same parameters: its loss differs only in the order of the
# masked sums, held to tests/test_torch_parallel.py (b)'s rtol 2e-5. Later
# steps carry the kernels' bf16 backward, whose dW sums each rank's 512
# points apart from the other's: an entry whose gradient is within rounding
# of 0 may then step the other way (2 lrate at most, as in
# tests/test_torch_parallel.py (a) "on"), and the losses follow the
# parameters. Measured after 50 steps on the H100: 5.6e-4 relative and
# 0.29 lrate; held to 2e-3 and 1 lrate.
DP_STEPS = 50
DP_FIRST_LOSS_RTOL = 2e-5
DP_LOSS_RTOL = 2e-3
DP_PARAM_ATOL_LRATE = 1.0


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flagship_model(cfg, device, frames=FRAMES):
    """The port's model from a seed, with the zero-initialised bending and
    rigidity output layers perturbed (a fresh model would never bend), a
    nonzero latent table and the density bias raised by 1 so random
    networks render non-empty frames."""
    from nonrigid_nerf_torch.models.model import NRNeRF
    gen = torch.Generator().manual_seed(SEED)
    model = NRNeRF(cfg, num_timesteps=frames, generator=gen, device="cpu")
    with torch.no_grad():
        if model.bender is not None:
            model.bender.bend[-1].weight.copy_(0.05 * torch.randn(
                model.bender.bend[-1].weight.shape, generator=gen))
            model.bender.rigidity[-1].weight.copy_(0.3 * torch.randn(
                model.bender.rigidity[-1].weight.shape, generator=gen))
        scale = BASELINE_LATENT_SCALE if cfg.time_conditioned_baseline else 0.1
        model.latents.copy_(scale * torch.randn(model.latents.shape,
                                                generator=gen))
        for net in (model.coarse, model.fine):
            if cfg.use_viewdirs:
                net.alpha.bias += 1.0
            else:
                net.output.bias[3] += 1.0
    return model.to(device)


def synthetic_poses(frames=FRAMES):
    """Cameras a little apart, looking down -z at the scene around the
    origin."""
    poses = []
    for i in range(frames):
        a = 0.05 * i
        rot = np.array([[math.cos(a), 0.0, math.sin(a)],
                        [0.0, 1.0, 0.0],
                        [-math.sin(a), 0.0, math.cos(a)]], np.float32)
        poses.append(np.concatenate(
            [rot, np.array([[0.1 * i], [0.0], [0.6]], np.float32)], 1))
    intrinsics = [dict(height=H, width=W, focal_x=420.0, focal_y=420.0,
                       center_x=W / 2, center_y=H / 2)] * frames
    return np.stack(poses), intrinsics


def synthetic_dataset(device):
    """An image stack built in memory from the seed: smooth colour waves
    that drift from frame to frame (something to learn), the cameras of
    `synthetic_poses`, one timestep per image, two test images."""
    from nonrigid_nerf_torch.data.dataset import build_ray_dataset
    rng = np.random.RandomState(SEED)
    yy, xx = np.meshgrid(np.linspace(0, 1, H, dtype=np.float32),
                         np.linspace(0, 1, W, dtype=np.float32), indexing="ij")
    freq = rng.uniform(1.0, 4.0, (3, 2)).astype(np.float32)
    phase = rng.uniform(0.0, 6.28, 3).astype(np.float32)
    images = np.stack([
        np.stack([0.5 + 0.4 * np.sin(6.28 * (freq[c, 0] * xx + freq[c, 1] * yy)
                                     + phase[c] + 0.2 * t)
                  for c in range(3)], -1)
        for t in range(TRAIN_FRAMES)]).astype(np.float32)
    poses, intrinsics = synthetic_poses(TRAIN_FRAMES)
    ids = list(range(TRAIN_FRAMES))
    extras = {"imageid_to_viewid": [0] * TRAIN_FRAMES,
              "imageid_to_timestepid": ids, "raw_timesteps": ids}
    i_train = [i for i in ids if i not in TRAIN_TEST_IDS]
    return build_ray_dataset(images, poses, {0: intrinsics[0]}, extras,
                             i_train, list(TRAIN_TEST_IDS), near=0.1, far=1.6,
                             device=device)


def kernel_wrappers():
    """Every kernel's wrapper by name: each counts its launches."""
    from nonrigid_nerf_torch.ops.kernels import (bend_bwd, bend_fwd, fused_bwd,
                                                 fused_fwd, mlp_bwd, mlp_fwd,
                                                 mlpe_bwd, mlpe_fwd, mlpv_bwd,
                                                 mlpv_fwd, quant_mlp)
    wrappers = (mlp_fwd.mlp_fwd, mlp_bwd.mlp_bwd, mlpv_fwd.mlpv_fwd,
                mlpv_bwd.mlpv_bwd, mlpe_fwd.mlpe_fwd, mlpe_bwd.mlpe_bwd,
                quant_mlp.mlp_i8, bend_fwd.bend_fwd, bend_bwd.bend_bwd,
                fused_fwd.fused_fwd, fused_bwd.fused_bwd)
    return {w.__name__: w for w in wrappers}


def reset_launch_counts():
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
        if hasattr(wrapper, "launches_by_width"):
            wrapper.launches_by_width = dict.fromkeys(wrapper.launches_by_width, 0)


def launch_counts(without=()):
    """Launches by kernel name, the kernels named in `without` left out."""
    return {name: w.launches for name, w in kernel_wrappers().items()
            if name not in without}


class Family:
    """One pair of kernels behind one interface. `inputs` are (emb,) for the
    flagship ("plain", 64 lanes) and the time-conditioned baseline
    ("baseline", 128 lanes), (emb, embv) with view directions ("viewdirs")
    and (pts,) where the kernels compute the encoding themselves ("pts")."""

    def __init__(self, kind: str):
        self.kind = kind
        self.viewdirs = kind == "viewdirs"
        self.emb_width = 128 if kind == "baseline" else 64
        if kind == "viewdirs":
            from nonrigid_nerf_torch.ops.kernels import mlpv_bwd as KB
            from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as K
            self.fwd, self.fwd_plain = K.mlpv_fwd, K.mlpv_fwd_plain
            self.bwd, self.bwd_plain = KB.mlpv_bwd, KB.mlpv_bwd_plain
            self.pack, self.cast = K.pack_viewdirs_mlp_weights, K.cast_mlpv_weights
            self.core_name = "MLPVCore"
            self.replaces = ("nonrigid_nerf_tpu/ops/pallas/fused_query.py:1183",
                             "nonrigid_nerf_tpu/ops/pallas/fused_query.py:1224")
        elif kind == "pts":
            from nonrigid_nerf_torch.ops.kernels import mlp_fwd
            from nonrigid_nerf_torch.ops.kernels import mlpe_bwd as KB
            from nonrigid_nerf_torch.ops.kernels import mlpe_fwd as K
            self.fwd, self.fwd_plain = K.mlpe_fwd, K.mlpe_fwd_plain
            self.bwd, self.bwd_plain = KB.mlpe_bwd, KB.mlpe_bwd_plain
            self.pack, self.cast = mlp_fwd.pack_mlp_weights, mlp_fwd.cast_mlp_weights
            self.core_name = "MLPECore"
            self.replaces = ("nonrigid_nerf_tpu/ops/pallas/fused_query.py:932",
                             "nonrigid_nerf_tpu/ops/pallas/fused_query.py:970")
        elif kind in ("plain", "baseline"):
            from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
            from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
            self.fwd, self.fwd_plain = K.mlp_fwd, K.mlp_fwd_plain
            self.bwd, self.bwd_plain = KB.mlp_bwd, KB.mlp_bwd_plain
            self.pack, self.cast = K.pack_mlp_weights, K.cast_mlp_weights
            self.core_name = "MLPCore"
            self.replaces = ("nonrigid_nerf_tpu/ops/pallas/fused_query.py:807",
                             "nonrigid_nerf_tpu/ops/pallas/fused_query.py:842")
        else:
            raise ValueError(f"unknown family {kind!r}")
        self.K, self.KB = K, KB
        self.fwd_name, self.bwd_name = self.fwd.__name__, self.bwd.__name__
        self.macs, self.bwd_macs = K.MACS_PER_POINT, KB.BWD_MACS_PER_POINT
        if kind == "baseline":
            self.macs = K.macs_per_point(self.emb_width)
            self.bwd_macs = KB.bwd_macs_per_point(self.emb_width)
        self.n_grads = len(KB.BWD_NAMES) - (2 if self.viewdirs else 1)
        self.what = {"plain": "no viewdirs", "viewdirs": "viewdirs",
                     "pts": "no viewdirs, fused_kernel=pts",
                     "baseline": "time-conditioned baseline"}[kind]

    def counts(self):
        return {self.fwd_name: self.fwd.launches,
                self.bwd_name: self.bwd.launches}

    def weights(self, net, device):
        return tuple(w.detach().to(device)
                     for w in self.cast(self.pack(net)))

    def inputs(self, n_points, device, seed):
        """bf16 encodings from a seed, the pad lanes zero (for the baseline
        lanes 63 .. 94 a latent, 0.3 N(0, 1)); for "pts" f32 points where
        the synthetic scene's bent points lie (x, y within 0.8 of the axis,
        z from -1 to 0.5 before the cameras at z = 0.6)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        if self.kind == "pts":
            u = torch.rand((n_points, 3), generator=gen, device=device)
            lo = torch.tensor([-0.8, -0.8, -1.0], device=device)
            hi = torch.tensor([0.8, 0.8, 0.5], device=device)
            return (lo + (hi - lo) * u,), gen
        emb = torch.rand((n_points, self.emb_width), generator=gen,
                         device=device) * 2 - 1
        emb[:, 63:] = 0         # the pad lanes of the 63-channel encoding
        if self.kind == "baseline":
            emb[:, 63:95] = BASELINE_LATENT_SCALE * torch.randn(
                (n_points, 32), generator=gen, device=device)
        emb = emb.to(torch.bfloat16)
        if not self.viewdirs:
            return (emb,), gen
        embv = (torch.rand((n_points, 32), generator=gen, device=device) * 2
                - 1).to(torch.bfloat16)
        embv[:, 27:] = 0        # the pad lanes of the 27-channel encoding
        return (emb, embv), gen

    def acts_bf16(self, inputs, mw):
        """[emb, nh1 .. nh8] as cuBLAS bf16 products (the yardstick)."""
        bf16 = torch.bfloat16
        emb = inputs[0]
        if self.kind == "pts":      # the encoding in PyTorch, as stage 1 makes it
            from nonrigid_nerf_torch.ops.embedding import fourier_embed
            emb = torch.nn.functional.pad(fourier_embed(emb, 10),
                                          (0, 1)).to(bf16)
        acts = [emb, torch.relu(emb @ mw[0] + mw[1]).to(bf16)]
        for i in (2, 4, 6, 8):
            acts.append(torch.relu(acts[-1] @ mw[i] + mw[i + 1]).to(bf16))
        acts.append(torch.relu(acts[-1] @ mw[11] + emb @ mw[10] + mw[12]).to(bf16))
        for i in (13, 15):
            acts.append(torch.relu(acts[-1] @ mw[i] + mw[i + 1]).to(bf16))
        return acts

    def heads_bf16(self, inputs, nh8, mw):
        """(feat, hv, raw) with view directions, (None, None, raw) without."""
        bf16 = torch.bfloat16
        if not self.viewdirs:
            return None, None, nh8.float() @ mw[17].float() + mw[18]
        feat = (nh8 @ mw[17] + mw[18]).to(bf16)
        hv = torch.relu(feat @ mw[21] + inputs[1] @ mw[22] + mw[23]).to(bf16)
        raw = (hv.float() @ mw[24].float() + mw[25]
               + nh8.float() @ mw[19].float() + mw[20])
        return feat, hv, raw

    def fwd_chain_bf16(self, inputs, mw):
        return self.heads_bf16(inputs, self.acts_bf16(inputs, mw)[8], mw)[2]

    def bwd_chain_bf16(self, inputs, mw, drawb):
        """The same backward as cuBLAS bf16 products (the yardstick)."""
        acts = self.acts_bf16(inputs, mw)
        emb = acts[0]
        feat, hv, _ = self.heads_bf16(inputs, acts[8], mw)
        if self.viewdirs:
            grads = [hv.t() @ drawb, acts[8].t() @ drawb]
            dhv = (drawb @ mw[24].t()) * (hv > 0)
            grads += [feat.t() @ dhv, inputs[1].t() @ dhv]
            dfeat, dembv = dhv @ mw[21].t(), dhv @ mw[22].t()
            grads.append(acts[8].t() @ dfeat)
            dh = (dfeat @ mw[17].t() + drawb @ mw[19].t()) * (acts[8] > 0)
        else:
            grads, dembv = [acts[8].t() @ drawb], None
            dh = (drawb @ mw[17].t()) * (acts[8] > 0)
        demb = None
        for layer, i in ((7, 15), (6, 13), (5, 11), (4, 8), (3, 6), (2, 4),
                         (1, 2), (0, 0)):
            grads.append(acts[layer].t() @ dh)
            if layer == 5:
                grads.append(emb.t() @ dh)
                demb = dh @ mw[10].t()
            nxt = dh @ mw[i].t()
            if layer == 0:
                demb = demb + nxt
                if self.kind == "pts":      # fold onto the coordinates
                    pre, _ = self.K.embed_ew(inputs[0])
                    P, phase = self.K._projection_on(inputs[0].device)
                    lane = torch.arange(64, device=pre.device)
                    dpre = torch.where(lane < 3, demb.float(),
                                       demb.float() * torch.cos(pre + phase))
                    demb = dpre @ P.t()
                return demb, dembv, grads
            dh = nxt * (acts[layer] > 0)

    def plain_core(self):
        """The family's autograd function (`MLPCore` / `MLPVCore` /
        `MLPECore`) with both kernels replaced by their plain versions."""
        fam, n_in = self, 2 if self.viewdirs else 1
        kept = torch.float32 if self.kind == "pts" else torch.bfloat16

        class PlainCore(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *args):
                inputs = [a.to(kept) for a in args[:n_in]]
                ctx.save_for_backward(*inputs, *args[n_in:])
                return fam.fwd_plain(*inputs, fam.cast(args[n_in:]))

            @staticmethod
            def backward(ctx, draw):
                saved = ctx.saved_tensors
                got = fam.bwd_plain(*saved[:n_in], fam.cast(saved[n_in:]), draw)
                return (*got[:-1], *got[-1])

        return PlainCore


def roofline(flops, nbytes):
    """(bound ms, what bounds): operations at the bf16 peak against bytes at
    the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_fwd(fam, model, n_points, device, network="coarse"):
    """The family's forward kernel against its plain version at n_points,
    with timings."""
    K, name = fam.K, fam.fwd_name
    mw = fam.weights(model.network(network), device)
    inputs, _ = fam.inputs(n_points, device, SEED + n_points)
    out = fam.fwd(*inputs, mw)
    ref = fam.fwd_plain(*inputs, mw)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    log(f"{name} n={n_points}: max abs err {max_err:.3e} (tol "
        f"{K.BF16_TOL_MAX:.0e}), mean {mean_err:.3e} (tol "
        f"{K.BF16_TOL_MEAN:.0e}), max |ref| {ref.abs().max().item():.3f}")
    if not (torch.isfinite(out).all() and max_err <= K.BF16_TOL_MAX
            and mean_err <= K.BF16_TOL_MEAN):
        raise AssertionError(f"{name} disagrees with its plain version")
    if not torch.equal(out, fam.fwd(*inputs, mw)):
        raise AssertionError(f"{name} is not deterministic")

    ms = cuda_time_ms(lambda: fam.fwd(*inputs, mw), 10)
    kernel_device_ms = device_ms(lambda: fam.fwd(*inputs, mw))
    plain_ms = cuda_time_ms(lambda: fam.fwd_plain(*inputs, mw), 3, warmup=1)
    chain_ms = cuda_time_ms(lambda: fam.fwd_chain_bf16(inputs, mw), 10)
    flops = 2.0 * fam.macs * n_points
    bound_ms, bound_by = roofline(flops, tensor_bytes(*inputs, out, *mw))
    log(f"{name} n={n_points}: kernel {ms:.4f} ms (device time "
        f"{kernel_device_ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, bf16 matmul chain {chain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it")
    return dict(max_abs_err=max_err, mean_abs_err=mean_err, ms=ms,
                device_ms=kernel_device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, matmul_chain_bf16_ms=chain_ms)


def check_bwd(fam, model, n_points, device):
    """The family's backward kernel against its plain version at n_points,
    with timings."""
    KB, name = fam.KB, fam.bwd_name
    mw = fam.weights(model.fine, device)
    inputs, gen = fam.inputs(n_points, device, SEED + n_points + 1)
    draw = torch.randn((n_points, 8), generator=gen, device=device)
    got = fam.bwd(*inputs, mw, draw)
    ref = fam.bwd_plain(*inputs, mw, draw)
    torch.cuda.synchronize()
    stats = KB.bwd_agreement(got, ref)
    log(f"{name} n={n_points}: {fam.n_grads} gradients max err "
        f"{stats['grad_max_rel']:.3e} of max magnitude (tol "
        f"{KB.grad_max_tol(n_points):.0e}), L2 {stats['grad_l2_rel']:.3e} (tol "
        f"{KB.BWD_TOL_L2:.0e}); per-point outputs L2 {stats['demb_l2_rel']:.3e}, "
        f"entries off by over {KB.BWD_TOL_ENTRY:.0e} of max "
        f"{stats['demb_outliers']:.3e} (tol {KB.BWD_TOL_OUTLIERS:.0e}), worst "
        f"{stats['demb_max_rel']:.3e} (tol {KB.BWD_TOL_DEMB_MAX:.0e})")
    log(f"{name} max abs err of each array over its max magnitude: "
        + " ".join(f"{k}={v:.2e}" for k, v in stats["max_rel"].items()))
    if not stats["ok"]:
        raise AssertionError(f"{name} disagrees with its plain version: {stats}")
    again = fam.bwd(*inputs, mw, draw)
    flat, flat_again = [*got[:-1], *got[-1]], [*again[:-1], *again[-1]]
    if not all(torch.equal(a, b) for a, b in zip(flat, flat_again)):
        raise AssertionError(f"{name} is not deterministic")

    drawb = draw.to(torch.bfloat16)
    ms = cuda_time_ms(lambda: fam.bwd(*inputs, mw, draw), 10)
    kernel_device_ms = device_ms(lambda: fam.bwd(*inputs, mw, draw))
    plain_ms = cuda_time_ms(lambda: fam.bwd_plain(*inputs, mw, draw), 3, warmup=1)
    chain_ms = cuda_time_ms(lambda: fam.bwd_chain_bf16(inputs, mw, drawb), 10)
    flops = 2.0 * fam.bwd_macs * n_points
    bound_ms, bound_by = roofline(flops, tensor_bytes(*inputs, draw, *flat, *mw))
    # the two-pass floor: the bf16 scratch (the encoding copy, nh and dh;
    # with view directions also feat, hv and their gradients) written by the
    # chain kernel and read back by the second pass
    per_point = getattr(KB, "SCRATCH_PER_POINT",
                        inputs[0].shape[1] + 16 * 256)   # mlp_bwd: by width
    floor_ms = 2 * 2 * n_points * per_point / PEAK_HBM_BYTES * 1e3
    log(f"{name} n={n_points}: kernel {ms:.4f} ms (device time "
        f"{kernel_device_ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, bf16 matmul chain {chain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it; the "
        f"scratch's round trip alone {floor_ms:.4f} ms")
    return dict(max_abs_err=stats["grad_max_rel"], agreement=stats, ms=ms,
                device_ms=kernel_device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, scratch_floor_ms=floor_ms,
                matmul_chain_bf16_ms=chain_ms)


def bwd_kernel_part(name: str) -> str:
    """The part of a backward call a device kernel is: its chain kernel, its
    dW products, the head sums, the reduction over the splits; row 10's
    bender pre-pass and the bender's backward."""
    return ("chain" if "chain_kernel" in name else
            "dw" if "mlp_dw_" in name else
            "heads" if "head_grad" in name else
            "bend_prepass" if "bend_fwd_sm90_kernel" in name else
            "bend_bwd" if "bend_bwd_sm90_kernel" in name else
            "reduce")


# the device kernels of a backward call (csrc/mlp_sm90.cuh's chain kernels,
# dW products and head sums, and the reduction)
BWD_KERNEL_NAMES = ("_bwd_chain_kernel", "mlp_dw_sm90_kernel",
                    "mlp_head_grad_kernel", "mlp_reduce_kernel")


def device_ms_by_part(fn, device_ms: float, reps: int = 5):
    """Device ms a call of fn by `bwd_kernel_part`, torch.profiler over
    `reps` calls after one; or None where no profile is whole: each part's
    launches a multiple of `reps`, and the parts adding up to between 0.75
    and 1.05 of `device_ms`, the call's device time from CUDA events (the
    rest is the gaps between a call's kernels). Late in the main process the
    profiler kept two of five launches of a kernel started through ctypes
    (and with `acc_events` once a chain kernel's time twice over), so it
    runs in a process of its own (`--splits`), and the profile is tried with
    the host's activity traced too, with the device's alone, and with
    `acc_events`, in that order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for what, kwargs in (
            ("host and device", dict(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])),
            ("device", dict(activities=[ProfilerActivity.CUDA])),
            ("device, acc_events", dict(activities=[ProfilerActivity.CUDA],
                                        acc_events=True))):
        with profile(**kwargs) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, count = {}, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                part = bwd_kernel_part(e.key)
                out[part] = out.get(part, 0.0) + e.self_device_time_total / reps / 1e3
                count[part] = count.get(part, 0) + e.count
        whole = (all(c % reps == 0 for c in count.values())
                 and 0.75 * device_ms <= sum(out.values()) <= 1.05 * device_ms)
        log(f"profile by kernel ({what}): {'whole' if whole else 'incomplete'}, "
            f"launches {count} over {reps} calls, {sum(out.values()):.4f} of "
            f"{device_ms:.4f} device ms")
        if whole:
            return out
    return None


def profile_run(run, what):
    """Device time by kernel over `run()` (torch.profiler, CUDA activity),
    and the device's idle share of its wall time (kernels run on one
    stream, so their times add up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: a CPU op's entry repeats the device time of its kernels
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"profile, {what}: wall {wall_us / 1e3:.1f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.1f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}, "
        f"{sum(e.count for e in events)} kernel launches")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    for e in top[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.self_device_time_total / busy_us:6.3f} x{e.count:<5d} "
            f"{e.key[:90]}")

    def share(name):
        return sum(e.self_device_time_total for e in events
                   if name in e.key) / busy_us

    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / wall_us,
            "kernel_launches": sum(e.count for e in events),
            "fwd_share": share("_fwd_kernel") + share("mlp_i8_kernel"),
            "cat_share": share("CatArrayBatchedCopy"),
            # cuBLAS's products (the bender's and the rigidity network's)
            "gemm_ms": sum(e.self_device_time_total for e in events
                           if "gemm" in e.key.lower()) / 1e3,
            "bwd_share": sum(share(k) for k in BWD_KERNEL_NAMES),
            "bwd_kernels_ms": {e.key[:90]: e.self_device_time_total / 1e3
                               for e in top
                               if any(k in e.key for k in BWD_KERNEL_NAMES)},
            "top": [[e.key[:60], e.self_device_time_total / 1e3]
                    for e in top[:12]]}


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


def render_frames(model, cfg, rs, poses, intrinsics, latents, device, what):
    """The frames through `render_path`, one call a frame (each ends in a
    copy to the host), every frame's time printed with the median beside
    the mean, so that one frame's stall on the host shows as one. Returns
    (rgbs, disps, seconds of each frame)."""
    from nonrigid_nerf_torch.apps.render_path import render_path
    rgbs, disps, seconds = [], [], []
    for i in range(len(poses)):
        t0 = time.perf_counter()
        rgb, disp = render_path(model, cfg, rs, poses[i:i + 1],
                                intrinsics[i:i + 1], latents[i:i + 1],
                                chunk=CHUNK, verbose=False, device=device)
        seconds.append(time.perf_counter() - t0)
        rgbs.append(rgb[0])
        disps.append(disp[0])
    log(f"render ({what}): s per frame " + ", ".join(f"{t:.4f}" for t in seconds)
        + f"; median {float(np.median(seconds)):.4f}, mean "
        f"{float(np.mean(seconds)):.4f}")
    return np.stack(rgbs), np.stack(disps), seconds


def render_phase(fam, cfg, args, device, smi, kernel_ms, off_frames=None):
    """Phase 3 for one family: frames through `render_path` with the kernel
    and with fused_kernel="off" (or held against `off_frames`, another
    family's "off" frames from the same parameters), launch counts, PSNR, a
    block of rays against a second rendering of it, a profile of one frame.
    `kernel_ms`: the isolated timings of the coarse and the fine launch.
    Returns (results dict, launches of the family's forward kernel, the
    "off" frames)."""
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.config import render_settings_from_args
    from nonrigid_nerf_torch.engine.render import make_ray_renderer
    from nonrigid_nerf_torch.ops.rays import get_rays

    name = fam.fwd_name
    model = flagship_model(cfg, device)
    poses, intrinsics = synthetic_poses()
    rs = render_settings_from_args(args, near=0.1, far=1.6)
    latents = model.latents.detach().cpu().numpy()
    with torch.no_grad():                 # warm-up: cuBLAS, allocator
        render_path(model, cfg, rs, poses[:1], intrinsics[:1], latents[:1],
                    chunk=CHUNK, render_factor=8, verbose=False, device=device)
    torch.cuda.synchronize()

    what = fam.what if "fused_kernel" in fam.what \
        else f"{fam.what}, fused_kernel={cfg.fused_kernel}"
    reset_launch_counts()
    rgbs, disps, frame_s = render_frames(model, cfg, rs, poses, intrinsics,
                                         latents, device, f"{name}, {what}")
    t_kernel = sum(frame_s)
    launches = fam.fwd.launches
    by_width = dict(getattr(fam.fwd, "launches_by_width", {}))
    others = launch_counts(without=(name,))
    blocks = -(-H * W // CHUNK)
    log(f"render ({name}, {what}): {FRAMES} frames in {t_kernel:.3f} s, "
        f"{t_kernel / FRAMES:.4f} s/frame, "
        f"{name} launches {launches} (expected {FRAMES * blocks * 2}"
        f"{f', by input width {by_width}' if by_width else ''}), of the other "
        f"kernels {others} (expected 0)")
    if launches != FRAMES * blocks * 2 or any(others.values()):
        raise AssertionError(f"the render path did not run {name}, and only "
                             "it, once per pass and block")
    if by_width and by_width.get(fam.emb_width) != launches:
        raise AssertionError(f"the render path ran {name} at another width "
                             f"than {fam.emb_width} lanes")
    if rgbs.shape != (FRAMES, H, W, 3) or disps.shape != (FRAMES, H, W):
        raise AssertionError(f"bad shapes {rgbs.shape} {disps.shape}")
    if not (np.isfinite(rgbs).all() and np.isfinite(disps).all()):
        raise AssertionError("non-finite pixels")
    if rgbs.min() < 0 or rgbs.max() > 1 or rgbs.std() < 1e-3:
        raise AssertionError(f"implausible frames: min {rgbs.min()} max "
                             f"{rgbs.max()} std {rgbs.std()}")
    kernel_s = FRAMES * blocks * sum(kernel_ms) / 1e3
    log(f"{name} share of render time (from the isolated kernel timings): "
        f"{kernel_s / t_kernel:.3f}")

    cfg_off = dataclasses.replace(cfg, fused_kernel="off")
    t_off = None
    if off_frames is None:
        off_frames, _, off_s = render_frames(model, cfg_off, rs, poses,
                                             intrinsics, latents, device,
                                             f"{name}, fused_kernel=off")
        t_off = sum(off_s)
        if fam.fwd.launches != launches:
            raise AssertionError(f"fused_kernel=off launched {name}")
        log(f"render ({name}, fused_kernel=off): {t_off / FRAMES:.4f} s/frame")
    rgbs_off = off_frames
    frame_psnr = [psnr(rgbs[i], rgbs_off[i]) for i in range(FRAMES)]
    log(f"render ({name}): PSNR kernel vs off per frame "
        f"{['%.2f' % p for p in frame_psnr]} dB (need >= {MIN_PSNR_DB})")
    if min(frame_psnr) < MIN_PSNR_DB:
        raise AssertionError("kernel render disagrees with the f32 render")

    rs_test = rs.test_mode()
    rays_o, rays_d = get_rays(torch.as_tensor(poses[0], device=device),
                              intrinsics[0])
    results = {}
    if fam.kind == "plain":
        # the card against the CPU on a block of frame 0's rays (f32 path)
        sel = torch.arange(0, H * W, (H * W) // 512, device=device)[:512]
        ro, rd = rays_o.reshape(-1, 3)[sel], rays_d.reshape(-1, 3)[sel]
        lat = model.latents[:1].detach().expand(ro.shape[0], -1)
        gpu = make_ray_renderer(cfg_off, rs_test, device=device)(model, ro, rd, lat)
        model_cpu = flagship_model(cfg, "cpu")
        cpu = make_ray_renderer(cfg_off, rs_test, device="cpu")(
            model_cpu, ro.cpu(), rd.cpu(), lat.cpu())
        gap = (gpu["rgb_map"].cpu() - cpu["rgb_map"]).abs().max().item()
        log(f"card vs CPU, 512 rays, fused_kernel=off: max |rgb| gap {gap:.3e}")
        if gap > 1e-4:
            raise AssertionError("the card's render disagrees with the CPU's")
        results["card_vs_cpu_max_rgb_gap"] = gap
    elif fam.kind == "viewdirs":
        # exact directions (one jvp through the bender per pass) on a block
        # of frame 0's rays: kernel against "off"
        n_rays = 4096
        sel = torch.arange(0, H * W, (H * W) // n_rays, device=device)[:n_rays]
        ro, rd = rays_o.reshape(-1, 3)[sel], rays_d.reshape(-1, 3)[sel]
        lat = model.latents[:1].detach().expand(n_rays, -1)
        cfg_exact = dataclasses.replace(cfg, approx_nonrigid_viewdirs=False)
        before = fam.fwd.launches
        exact = make_ray_renderer(cfg_exact, rs_test, chunk=n_rays,
                                  device=device)(model, ro, rd, lat)
        if fam.fwd.launches != before + 2:
            raise AssertionError(f"exact directions did not run {name} twice")
        exact_off = make_ray_renderer(
            dataclasses.replace(cfg_exact, fused_kernel="off"), rs_test,
            chunk=n_rays, device=device)(model, ro, rd, lat)
        fd = make_ray_renderer(cfg, rs_test, chunk=n_rays, device=device)(
            model, ro, rd, lat)
        torch.cuda.synchronize()
        p_exact = psnr(exact["rgb_map"].cpu().numpy(),
                       exact_off["rgb_map"].cpu().numpy())
        fd_gap = (exact["rgb_map"] - fd["rgb_map"]).abs().max().item()
        log(f"exact directions, {n_rays} rays: PSNR kernel vs off "
            f"{p_exact:.2f} dB (need >= {MIN_PSNR_DB}); max |rgb| gap to the "
            f"finite-difference directions {fd_gap:.3e}")
        if not torch.isfinite(exact["rgb_map"]).all() or p_exact < MIN_PSNR_DB:
            raise AssertionError("exact-direction kernel render disagrees "
                                 "with the f32 render")
        if fd_gap == 0.0:
            raise AssertionError("exact and finite-difference directions "
                                 "rendered the same pixels")
        results.update(exact_psnr_kernel_vs_off_db=p_exact,
                       exact_vs_fd_max_rgb_gap=fd_gap)

    prof = profile_run(lambda: render_path(
        model, cfg, rs, poses[:1], intrinsics[:1], latents[:1], chunk=CHUNK,
        verbose=False, device=device), f"one frame ({name})")
    log(f"{name} share of device time (profiler): {prof['fwd_share']:.3f}; "
        f"CatArrayBatchedCopy's: {prof['cat_share']:.3f}")
    results.update(frames=FRAMES, height=H, width=W, chunk=CHUNK,
                   use_viewdirs=cfg.use_viewdirs, fused_kernel=cfg.fused_kernel,
                   time_conditioned_baseline=cfg.time_conditioned_baseline,
                   s_per_frame_kernel=t_kernel / FRAMES,
                   s_per_frame_median=float(np.median(frame_s)),
                   frame_s=frame_s,
                   s_per_frame_off=None if t_off is None else t_off / FRAMES,
                   psnr_kernel_vs_off_db=frame_psnr,
                   rays_per_s_kernel=H * W * FRAMES / t_kernel,
                   fwd_share_est=kernel_s / t_kernel, profile=prof, gpu=smi)
    return results, launches, off_frames


def train_phase(fam, args, cfg, device, smi, steps):
    """Phase 4 for one family: train, compare with fused_kernel="off",
    round-trip a checkpoint, profile. Returns (results dict, launch
    counts)."""
    from nonrigid_nerf_torch.apps.train import step_generator, train
    from nonrigid_nerf_torch.checkpoints import (load_train_state,
                                                 save_checkpoint)
    from nonrigid_nerf_torch.config import (render_settings_from_args,
                                            train_config_from_args)
    from nonrigid_nerf_torch.data.dataset import sample_ray_batch
    from nonrigid_nerf_torch.engine import query
    from nonrigid_nerf_torch.engine.train_step import (losses_and_grads,
                                                       make_train_step)

    what = fam.what
    ds = synthetic_dataset(device)
    args.seed = SEED
    tc = train_config_from_args(args)
    rs = render_settings_from_args(args, ds.near, ds.far)
    weights = (tc.offsets_loss_weight, tc.divergence_loss_weight,
               tc.rigidity_loss_weight)
    if not (tc.N_rand == 1024 and rs.N_samples == 64 and rs.N_importance == 64
            and rs.perturb == 1.0 and rs.raw_noise_std == 1.0
            and weights == LOSS_WEIGHTS[cfg.time_conditioned_baseline]
            and ds.has_test_split):
        raise AssertionError(f"unexpected training setup ({what}) {tc} {rs}")

    with tempfile.TemporaryDirectory() as logdir:
        reset_launch_counts()
        t0 = time.perf_counter()
        state = train(cfg, tc, rs, ds, logdir, device=device,
                      i_print=TRAIN_PRINT, i_weights=steps, max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fam.counts()
        others = launch_counts(without=tuple(counts))
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            # the step rows: on a GPU the file ends with the peak memory's
            rows = [row for row in map(json.loads, f) if "loss" in row]
        if not os.path.exists(os.path.join(logdir, "latest.npz")):
            raise AssertionError("train() saved no checkpoint")
    want = {fam.fwd_name: 2 * steps, fam.bwd_name: 4 * steps}
    by_width = {name: dict(w.launches_by_width)
                for name, w in ((fam.fwd_name, fam.fwd), (fam.bwd_name, fam.bwd))
                if hasattr(w, "launches_by_width")}
    log(f"train ({what}): {steps} steps in {wall:.2f} s (first step's warm-up "
        f"and the checkpoint included); launches {counts} (expected {want}"
        f"{f', by input width {by_width}' if by_width else ''}), of the other "
        f"kernels {others} (expected 0)")
    if state.step != steps or counts != want or any(others.values()):
        raise AssertionError(f"a training step must launch {fam.fwd_name} "
                             f"twice and {fam.bwd_name} four times")
    if any(w.get(fam.emb_width) != counts[name] for name, w in by_width.items()):
        raise AssertionError(f"training ran its kernels at another width than "
                             f"{fam.emb_width} lanes")
    for row in rows:
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"non-finite metrics {row}")
    for name, t in list(state.model.named_parameters()) + \
            list(state.mu.items()) + list(state.nu.items()):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite values in {name}")
    first, last = rows[0], rows[-1]
    log(f"train ({what}): loss {first['loss']:.5f} (steps 1-{TRAIN_PRINT} end) "
        f"-> {last['loss']:.5f} (step {last['step']}); img_loss "
        f"{first['img_loss']:.5f} -> {last['img_loss']:.5f}; psnr "
        f"{first['psnr']:.2f} -> {last['psnr']:.2f}")
    if not (last["loss"] < first["loss"]
            and last["img_loss"] < first["img_loss"]):
        raise AssertionError("the loss did not fall")
    # end to end: every step after the first window (the warm-up) over all
    # the time those steps took, a stall included; the windows are detail
    rates = sorted(r["it_per_sec"] for r in rows[1:])
    timed_steps = TRAIN_PRINT * len(rates)
    steps_per_s = timed_steps / sum(TRAIN_PRINT / r for r in rates)
    log(f"train ({what}): {steps_per_s:.2f} steps/s, "
        f"{steps_per_s * tc.N_rand:.0f} rays/s over steps {TRAIN_PRINT + 1}-"
        f"{steps} ({timed_steps} steps, all their time); windows of "
        f"{TRAIN_PRINT} steps: median {rates[len(rates) // 2]:.2f}, min "
        f"{rates[0]:.2f}, max {rates[-1]:.2f} steps/s; {smi}")

    # one step's losses and gradients, same state, same draws: the kernels
    # against fused_kernel="off" and against their plain versions; with view
    # directions in both direction modes
    step_args = dict(tc=tc, rs=rs, has_test_split=True, n_rand=tc.N_rand)
    core_name = fam.core_name

    def one(cfg_x, plain=False):
        kernel_core = getattr(query, core_name)
        if plain:
            setattr(query, core_name, fam.plain_core())
        try:
            gen = step_generator(tc.seed, state.step, device)
            batch = sample_ray_batch(ds, tc.N_rand, generator=gen)
            return losses_and_grads(state.model, state.step, batch, cfg=cfg_x,
                                    generator=gen, **step_args)
        finally:
            setattr(query, core_name, kernel_core)

    def cosines(grads_a, grads_b):
        out = {}
        for name in grads_a:
            a = grads_a[name].flatten().double()
            b = grads_b[name].flatten().double()
            if a.norm().item() == 0.0 and b.norm().item() == 0.0:
                continue
            out[name] = (torch.dot(a, b) / (a.norm() * b.norm())).item()
        return out

    def is_deformation(name):
        return name.startswith("bender.") or name == "latents"

    modes = [("finite-difference directions", cfg),
             ("exact directions",
              dataclasses.replace(cfg, approx_nonrigid_viewdirs=False))] \
        if cfg.use_viewdirs else [(what, cfg)]
    step_checks = {}
    for mode, cfg_m in modes:
        fd = cfg_m.use_viewdirs and cfg_m.approx_nonrigid_viewdirs
        launched = fam.counts()
        loss_k, _, grads_k = one(cfg_m)
        if fam.counts() != {fam.fwd_name: launched[fam.fwd_name] + 2,
                            fam.bwd_name: launched[fam.bwd_name] + 4}:
            raise AssertionError(f"the step ({mode}) did not launch the kernels")
        loss_o, _, grads_o = one(dataclasses.replace(cfg_m, fused_kernel="off"))
        _, _, grads_p = one(cfg_m, plain=True)
        if fam.counts()[fam.bwd_name] != launched[fam.bwd_name] + 4:
            raise AssertionError("the plain-version step launched a kernel")
        loss_gap = (abs(loss_k.mean().item() - loss_o.mean().item())
                    / abs(loss_o.mean().item()))
        cos_off, cos_plain = cosines(grads_k, grads_o), cosines(grads_k, grads_p)
        deform = {n: c for n, c in cos_off.items() if is_deformation(n)}
        mlp = {n: c for n, c in cos_off.items() if not is_deformation(n)}
        if "latents" not in deform or (state.model.bender is not None
                                       and len(deform) < 2):
            raise AssertionError("the bender and the latents got no gradient")
        worst_mlp, worst_def = min(mlp, key=mlp.get), min(deform, key=deform.get)
        worst_plain = min(cos_plain, key=cos_plain.get)
        deform_floor = STEP_FD_DEFORMATION_MIN_COSINE if fd \
            else STEP_GRAD_MIN_COSINE
        log(f"step with kernels vs fused_kernel=off ({mode}): mean loss "
            f"{loss_k.mean().item():.6f} vs {loss_o.mean().item():.6f} (gap "
            f"{loss_gap:.3e}, tol {STEP_LOSS_TOL_REL:.0e}); gradient cosine "
            f"min {mlp[worst_mlp]:.5f} ({worst_mlp}) over the canonical "
            f"MLPs' {len(mlp)} parameters (need >= {STEP_GRAD_MIN_COSINE}), "
            f"{deform[worst_def]:.5f} ({worst_def}) over the bender's and "
            f"the latents' {len(deform)} (need >= {deform_floor}); vs the "
            f"plain versions: min {cos_plain[worst_plain]:.5f} "
            f"({worst_plain}) over {len(cos_plain)} (need >= "
            f"{STEP_PLAIN_MIN_COSINE}); the latents' gradient: cosine "
            f"{deform['latents']:.5f} vs off, {cos_plain['latents']:.5f} vs "
            f"the plain versions")
        if (loss_gap > STEP_LOSS_TOL_REL
                or mlp[worst_mlp] < STEP_GRAD_MIN_COSINE
                or deform[worst_def] < deform_floor):
            raise AssertionError("the kernel step disagrees with the f32 step")
        if cos_plain[worst_plain] < STEP_PLAIN_MIN_COSINE \
                or set(cos_plain) != set(cos_off):
            raise AssertionError("the kernel step disagrees with the step "
                                 "through the plain versions")
        step_checks[mode] = {
            "loss_gap": loss_gap, "min_mlp_grad_cosine": mlp[worst_mlp],
            "min_deformation_grad_cosine": deform[worst_def],
            "min_grad_cosine_vs_plain": cos_plain[worst_plain],
            "latents_grad_cosine_vs_off": deform["latents"],
            "latents_grad_cosine_vs_plain": cos_plain["latents"]}

    # a checkpoint saved, loaded, one more step: bit-equal to the step taken
    # without the round trip
    step_fn = make_train_step(cfg, tc, rs, has_test_split=True)
    with tempfile.TemporaryDirectory() as ckdir:
        path = os.path.join(ckdir, "latest.npz")
        save_checkpoint(path, state.step, state.model, (state.mu, state.nu),
                        {"near": ds.near, "far": ds.far})
        loaded, _ = load_train_state(path, cfg, device=device)
    direct = copy.deepcopy(state)
    for st in (direct, loaded):
        step_fn(st, ds, step_generator(tc.seed, st.step, device))
    torch.cuda.synchronize()
    same = loaded.step == direct.step == steps + 1 and all(
        torch.equal(a, b) for a, b in zip(
            list(direct.model.parameters()) + list(direct.mu.values())
            + list(direct.nu.values()),
            list(loaded.model.parameters()) + list(loaded.mu.values())
            + list(loaded.nu.values())))
    log(f"checkpoint round trip, then one step ({what}): bit-equal = {same}")
    if not same:
        raise AssertionError("resume does not reproduce the next step")

    def few_steps():
        for _ in range(PROFILE_STEPS):
            step_fn(direct, ds, step_generator(tc.seed, direct.step, device))

    prof = profile_run(few_steps, f"{PROFILE_STEPS} training steps ({what})")
    # the backward's device time by part, a launch on average over the
    # step's two sizes (4 launches a step)
    split = dict.fromkeys(("chain", "dw", "heads", "reduce"), 0.0)
    for name, ms in prof["bwd_kernels_ms"].items():
        split[bwd_kernel_part(name)] += ms / (4 * PROFILE_STEPS)
    log(f"training-step shares of device time (profiler, {what}): "
        f"{fam.fwd_name} {prof['fwd_share']:.3f}, {fam.bwd_name} "
        f"{prof['bwd_share']:.3f}; device {prof['device_busy_ms'] / PROFILE_STEPS:.2f} "
        f"ms a step, idle share {prof['idle_share']:.3f}; the backward's "
        "kernels, ms a step: " + "; ".join(
            f"{k} {v / PROFILE_STEPS:.3f}"
            for k, v in prof["bwd_kernels_ms"].items()))
    return {"steps": steps, "n_rand": tc.N_rand, "use_viewdirs": cfg.use_viewdirs,
            "bwd_split_ms_per_launch": split,
            "fused_kernel": cfg.fused_kernel,
            "time_conditioned_baseline": cfg.time_conditioned_baseline,
            "frames": TRAIN_FRAMES, "height": H, "width": W,
            "wall_s": wall, "steps_per_s": steps_per_s,
            "rays_per_s": steps_per_s * tc.N_rand,
            "timed_steps": timed_steps,
            "window_steps_per_s_median": rates[len(rates) // 2],
            "window_steps_per_s_min": rates[0],
            "window_steps_per_s_max": rates[-1],
            "loss_first": first["loss"], "loss_last": last["loss"],
            "psnr_first": first["psnr"], "psnr_last": last["psnr"],
            "kernel_vs_off": step_checks, "resume_bit_equal": same, "profile": prof, "gpu": smi}, counts


def int_mm_chain(emb, qw):
    """The int8 chain as torch._int_mm calls with elementwise
    requantization between them (a yardstick only: the port never calls
    it)."""
    (qw0, d0, b0, qw1, d1, b1, qw2, d2, b2, qw3, d3, b3, qw4, d4, b4,
     qw5h, d5h, b5, qw5e, d5e, qw6, d6, b6, qw7, d7, b7, owb, ob, qm) = qw

    def requant(h, m):
        return (torch.round(torch.clamp(h * m, 0.0, 254.0)) - 127.0).to(torch.int8)

    qemb = torch.round(torch.clamp(emb.float() * qm[0, 0], -127.0, 127.0)).to(
        torch.int8)
    h = torch.relu(torch._int_mm(qemb, qw0).float() * d0 + b0)
    for l, (w, d, b) in enumerate(((qw1, d1, b1), (qw2, d2, b2), (qw3, d3, b3),
                                   (qw4, d4, b4)), start=1):
        h = torch.relu(torch._int_mm(requant(h, qm[0, l]), w).float() * d + b)
    h = torch.relu(torch._int_mm(requant(h, qm[0, 5]), qw5h).float() * d5h
                   + torch._int_mm(qemb, qw5e).float() * d5e + b5)
    for l, (w, d, b) in enumerate(((qw6, d6, b6), (qw7, d7, b7)), start=6):
        h = torch.relu(torch._int_mm(requant(h, qm[0, l]), w).float() * d + b)
    return h.to(torch.bfloat16).float() @ owb.float() + ob


def ptxas_report(source: str, kernel: str) -> str:
    """What ptxas said in phase 1's build of `source` of the entry function
    whose name holds `kernel`: registers, stack and spill bytes, and whether
    it serialized the function's wgmma (C7510-C7512)."""
    from nonrigid_nerf_torch.ops.kernels import build
    lines = build.BUILD_INFO[source]["log"].splitlines()
    serialized = any("C751" in l and kernel in l for l in lines)
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            props = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", props)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", props)
            if regs and spill:
                return (f"ptxas: {regs.group(1)} registers, {spill.group(1)} B "
                        f"stack, {spill.group(2)} B spill stores, "
                        f"{spill.group(3)} B spill loads, wgmma "
                        f"{'serialized' if serialized else 'not serialized'}")
    return "ptxas: not reported (the library was built before this run)"


def check_i8(fam_plain, model, n_points, device, network="coarse"):
    """`mlp_i8` against its plain version at n_points, with timings. The
    encodings are the first family's; the scales are calibrated on the first
    65,536 of them."""
    from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ
    name = "mlp_i8"
    net = model.network(network)
    (emb,), _ = fam_plain.inputs(n_points, device, SEED + n_points)
    scales = KQ.calibrate_act_scales(net, emb[:65536])
    qw = KQ.pack_int8_mlp_weights(net, scales)
    out = KQ.mlp_i8(emb, qw)
    ref = KQ.mlp_i8_plain(emb, qw)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    mw = fam_plain.weights(net, device)
    bf16_gap = ((out - fam_plain.fwd_plain(emb, mw)).abs().mean()
                / ref.abs().mean()).item()
    log(f"{name} n={n_points}: max abs err {max_err:.3e} (tol "
        f"{KQ.I8_TOL_MAX:.0e}), mean {mean_err:.3e}, max |ref| "
        f"{ref.abs().max().item():.3f}; mean gap to the bf16 plain version "
        f"{bf16_gap:.3e} of mean |raw| (need < 2e-2)")
    if not (torch.isfinite(out).all() and max_err <= KQ.I8_TOL_MAX
            and bf16_gap < 2e-2):
        raise AssertionError(f"{name} disagrees with its plain version")
    if not torch.equal(out, KQ.mlp_i8(emb, qw)):
        raise AssertionError(f"{name} is not deterministic")

    ms = cuda_time_ms(lambda: KQ.mlp_i8(emb, qw), 10)
    kernel_device_ms = device_ms(lambda: KQ.mlp_i8(emb, qw))
    plain_ms = cuda_time_ms(lambda: KQ.mlp_i8_plain(emb, qw), 3, warmup=1)
    chain_ms = cuda_time_ms(lambda: int_mm_chain(emb, qw), 10)
    ops = 2.0 * KQ.MACS_PER_POINT * n_points
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = tensor_bytes(emb, out, *qw) / PEAK_HBM_BYTES * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"
    log(f"{name} n={n_points}: kernel {ms:.4f} ms (device time "
        f"{kernel_device_ms:.4f} ms, {ops / ms / 1e9:.1f} TOP/s), "
        f"plain {plain_ms:.4f} ms, torch._int_mm chain {chain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}, int8 peak)")
    return dict(max_abs_err=max_err, mean_abs_err=mean_err, ms=ms,
                device_ms=kernel_device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                int_mm_chain_ms=chain_ms, mean_gap_to_bf16=bf16_gap)


def int8_render_phase(cfg_plain, args, device, smi, kernel_ms, off_frames):
    """Phase 3 for fused_kernel="int8": calibrate on the first pose's rays
    (`quantize_for_inference`), render the frames through `render_path`,
    launch counts, PSNR against the first family's "off" frames, a profile
    of one frame. Returns (results dict, launches of `mlp_i8`)."""
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.config import render_settings_from_args
    from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ
    from nonrigid_nerf_torch.ops.rays import get_rays

    name = "mlp_i8"
    cfg = dataclasses.replace(cfg_plain, fused_kernel="int8")
    model = flagship_model(cfg_plain, device)
    poses, intrinsics = synthetic_poses()
    rs = render_settings_from_args(args, near=0.1, far=1.6)
    latents = model.latents.detach().cpu().numpy()
    rays_o, rays_d = get_rays(torch.as_tensor(poses[0], device=device),
                              intrinsics[0])
    t0 = time.perf_counter()
    model_q = KQ.quantize_for_inference(
        model, cfg_plain, rays_o, rays_d,
        model.latents[:1].detach().expand(H * W, -1), rs.near, rs.far)
    torch.cuda.synchronize()
    t_calibrate = time.perf_counter() - t0
    if model.quant is not None or set(model_q.quant) != {"coarse", "fine"}:
        raise AssertionError("quantize_for_inference must return a new model "
                             "with the state of both networks")
    log(f"quantize_for_inference: {t_calibrate:.3f} s; activation maxima "
        f"coarse {[round(v, 3) for v in model_q.quant['coarse'].scales.tolist()]}")
    with torch.no_grad():                 # warm-up
        render_path(model_q, cfg, rs, poses[:1], intrinsics[:1], latents[:1],
                    chunk=CHUNK, render_factor=8, verbose=False, device=device)
    torch.cuda.synchronize()

    reset_launch_counts()
    rgbs, disps, frame_s = render_frames(model_q, cfg, rs, poses, intrinsics,
                                         latents, device,
                                         f"{name}, fused_kernel=int8")
    t_kernel = sum(frame_s)
    counts = launch_counts()
    launches = counts.pop(name)
    blocks = -(-H * W // CHUNK)
    log(f"render ({name}, fused_kernel=int8): {FRAMES} frames in "
        f"{t_kernel:.3f} s, {t_kernel / FRAMES:.4f} s/frame, {name} launches "
        f"{launches} (expected {FRAMES * blocks * 2}), of the other kernels "
        f"{counts} (expected 0)")
    if launches != FRAMES * blocks * 2 or any(counts.values()):
        raise AssertionError(f"the render path did not run {name}, and only "
                             "it, once per pass and block")
    if rgbs.shape != (FRAMES, H, W, 3) or disps.shape != (FRAMES, H, W):
        raise AssertionError(f"bad shapes {rgbs.shape} {disps.shape}")
    if not (np.isfinite(rgbs).all() and np.isfinite(disps).all()):
        raise AssertionError("non-finite pixels")
    frame_psnr = [psnr(rgbs[i], off_frames[i]) for i in range(FRAMES)]
    log(f"render ({name}): PSNR int8 vs off per frame "
        f"{['%.2f' % p for p in frame_psnr]} dB (need >= {MIN_PSNR_INT8_DB})")
    if min(frame_psnr) < MIN_PSNR_INT8_DB:
        raise AssertionError("int8 render disagrees with the f32 render")
    kernel_s = FRAMES * blocks * sum(kernel_ms) / 1e3
    prof = profile_run(lambda: render_path(
        model_q, cfg, rs, poses[:1], intrinsics[:1], latents[:1], chunk=CHUNK,
        verbose=False, device=device), f"one frame ({name})")
    log(f"{name} share of device time (profiler): {prof['fwd_share']:.3f}; "
        f"CatArrayBatchedCopy's: {prof['cat_share']:.3f}")
    return dict(frames=FRAMES, height=H, width=W, chunk=CHUNK,
                use_viewdirs=False, fused_kernel="int8",
                time_conditioned_baseline=False,
                s_per_frame_kernel=t_kernel / FRAMES,
                s_per_frame_median=float(np.median(frame_s)), frame_s=frame_s,
                s_per_frame_off=None,
                calibrate_s=t_calibrate, psnr_kernel_vs_off_db=frame_psnr,
                rays_per_s_kernel=H * W * FRAMES / t_kernel,
                fwd_share_est=kernel_s / t_kernel, profile=prof,
                gpu=smi), launches


def int8_row(sizes, checks, render_launches):
    """The kernels line's row of `mlp_i8` (rendering only: no training
    launches, no backward)."""
    coarse_k, fine_k = checks
    return {"name": "mlp_i8", "route": "cuda",
            "source": "nonrigid_nerf_torch/ops/kernels/csrc/mlp_i8.cu",
            "replaces": "nonrigid_nerf_tpu/ops/pallas/quant_mlp.py:249",
            "launches": render_launches, "launches_render": render_launches,
            "launches_train": 0,
            "max_abs_err": max(k["max_abs_err"] for k in checks),
            "ms": coarse_k["ms"], "device_ms": coarse_k["device_ms"],
            "plain_ms": coarse_k["plain_ms"],
            "bound_ms": coarse_k["bound_ms"], "bound_by": coarse_k["bound_by"],
            "library_ms": None, "points": sizes[0],
            "int_mm_chain_ms": coarse_k["int_mm_chain_ms"],
            "ptxas": ptxas_report("mlp_i8.cu", "mlp_i8_kernel"),
            "fine_pass": {"points": sizes[1], **fine_k}}


def kernel_rows(fam, sizes, fwd_checks, bwd_checks, render_launches,
                train_counts):
    """The family's two rows of the kernels line. Launches: the render
    path's and the training path's, each counted from 0 over its own run. A
    backward row's max_abs_err is the largest of its gradients' max abs
    errors, each over its array's max magnitude (the arrays differ in scale
    by orders of magnitude); "agreement" has every array's."""
    n_coarse, n_fine, n_bwd_coarse, n_bwd_fine = sizes
    coarse_k, fine_k, train_coarse_k, train_fine_k = fwd_checks
    coarse_b, fine_b = bwd_checks
    src = "nonrigid_nerf_torch/ops/kernels/csrc/"
    fwd_row = {"name": fam.fwd_name, "route": "cuda",
               "source": f"{src}{fam.fwd_name}.cu",
               "replaces": fam.replaces[0],
               "launches": render_launches + train_counts[fam.fwd_name],
               "launches_render": render_launches,
               "launches_train": train_counts[fam.fwd_name],
               "max_abs_err": max(k["max_abs_err"] for k in fwd_checks),
               "ms": coarse_k["ms"], "plain_ms": coarse_k["plain_ms"],
               "bound_ms": coarse_k["bound_ms"],
               "bound_by": coarse_k["bound_by"], "library_ms": None,
               "device_ms": coarse_k["device_ms"],
               "share_of_bound": coarse_k["share_of_bound"],
               "points": n_coarse,
               "matmul_chain_bf16_ms": coarse_k["matmul_chain_bf16_ms"],
               "fine_pass": {"points": n_fine, **fine_k},
               "train_pass": {"points": n_bwd_coarse, **train_coarse_k},
               "train_fine_pass": {"points": n_bwd_fine, **train_fine_k}}
    bwd_row = {"name": fam.bwd_name, "route": "cuda",
               "source": f"{src}{fam.bwd_name}.cu",
               "replaces": fam.replaces[1],
               "launches": train_counts[fam.bwd_name],
               "max_abs_err": max(coarse_b["max_abs_err"],
                                  fine_b["max_abs_err"]),
               "ms": coarse_b["ms"], "plain_ms": coarse_b["plain_ms"],
               "bound_ms": coarse_b["bound_ms"],
               "bound_by": coarse_b["bound_by"], "library_ms": None,
               "device_ms": coarse_b["device_ms"],
               "share_of_bound": coarse_b["share_of_bound"],
               "scratch_floor_ms": coarse_b["scratch_floor_ms"],
               "points": n_bwd_coarse,
               "matmul_chain_bf16_ms": coarse_b["matmul_chain_bf16_ms"],
               "agreement": coarse_b["agreement"],
               "fine_pass": {"points": n_bwd_fine, **fine_b}}
    return [fwd_row, bwd_row]


def add_width_rows(rows, rows_128):
    """`mlp_fwd`'s and `mlp_bwd`'s rows with the baseline's 128-lane checks,
    timings and launches under "lanes_128"; the rows' own numbers stay the
    64-lane ones, their launches count both widths."""
    for row, wide in zip(rows, rows_128):
        if row["name"] != wide["name"]:
            raise AssertionError(f"{wide['name']} has no 64-lane row")
        row["launches_64"] = row["launches"]
        row["launches"] += wide["launches"]
        row["max_abs_err"] = max(row["max_abs_err"], wide["max_abs_err"])
        row["lanes_128"] = {k: v for k, v in wide.items()
                            if k not in ("name", "route", "source", "replaces")}


# ---- the fused point query (fused_point_query, fused_point_query_split)

FUSED_REPLACES = {
    "bend_fwd": "nonrigid_nerf_tpu/ops/pallas/fused_query.py:635",
    "bend_bwd": "nonrigid_nerf_tpu/ops/pallas/fused_query.py:660",
    "fused_fwd": "nonrigid_nerf_tpu/ops/pallas/fused_query.py:289",
    "fused_bwd": "nonrigid_nerf_tpu/ops/pallas/fused_query.py:478",
}
# the entry points' gradients against the f32 modules': the JAX package's
# bound for its kernels against its XLA path (tests/test_fused_kernel.py:
# 132-153), which holds without the raised density bias of `flagship_model`
# (tests/test_torch_fused_query.py says why)
FUSED_F32_GRAD_TOL = 0.06


def fused_inputs(model, n, device, seed):
    """Points where the synthetic scene's bent points lie (as for "pts"), and
    each point's latent from the model's latent table (a frame at random)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((n, 3), generator=gen, device=device)
    lo = torch.tensor([-0.8, -0.8, -1.0], device=device)
    hi = torch.tensor([0.8, 0.8, 0.5], device=device)
    frame = torch.randint(0, model.latents.shape[0], (n,), generator=gen,
                          device=device)
    return lo + (hi - lo) * u, model.latents.detach()[frame].contiguous(), gen


def bend_chain_bf16(pts, lat, bw):
    """The bender's products as cuBLAS bf16 matmuls, the elementwise work
    around them and the encoding (a yardstick only: the port never calls
    it). Returns (emb f32, activations)."""
    from nonrigid_nerf_torch.ops.embedding import fourier_embed
    (b0p, b0l, b0b, b1w, b1b, b2w, b2b, b3w, b3b, bow,
     r0w, r0b, r1w, r1b, row, rob, _, _) = bw
    bf16 = torch.bfloat16
    ptsb, latb = pts.to(bf16), lat.to(bf16)
    bh = [torch.relu(ptsb @ b0p[:3] + latb @ b0l + b0b).to(bf16)]
    for w, b in ((b1w, b1b), (b2w, b2b), (b3w, b3b)):
        bh.append(torch.relu(bh[-1] @ w + b).to(bf16))
    off = (bh[3] @ bow[:, :3]).float()
    rh0 = torch.relu(ptsb @ r0w[:3] + r0b).to(bf16)
    rh1 = torch.relu(rh0 @ r1w + r1b).to(bf16)
    rig = (torch.tanh(rh1 @ row[:, :1] + rob[:, :1]) + 1.0) * 0.5
    bent = pts + rig * off
    emb = torch.nn.functional.pad(fourier_embed(bent, 10), (0, 1))
    return emb, dict(ptsb=ptsb, latb=latb, bh=bh, rh0=rh0, rh1=rh1, off=off,
                     rig=rig, bent=bent)


def bend_bwd_chain_bf16(pts, lat, bw, demb, doff, drig):
    """The bender's backward as cuBLAS bf16 matmuls (a yardstick only)."""
    (b0p, b0l, _, b1w, _, b2w, _, b3w, _, bow,
     r0w, _, r1w, _, row, _, P, phase) = bw
    bf16 = torch.bfloat16
    _, a = bend_chain_bf16(pts, lat, bw)
    dbent = (demb * torch.cos(a["bent"] @ P[:3] + phase)) @ P[:3].t()
    doff_t = (dbent * a["rig"] + doff).to(bf16)
    drig_raw = ((drig + (dbent * a["off"]).sum(1, keepdim=True))
                * 2.0 * a["rig"] * (1.0 - a["rig"])).to(bf16)
    grads = [a["rh1"].t() @ drig_raw]
    g = (drig_raw @ row[:, :1].t()) * (a["rh1"] > 0)
    grads.append(a["rh0"].t() @ g)
    g = (g @ r1w.t()) * (a["rh0"] > 0)
    grads.append(a["ptsb"].t() @ g)
    dpts = g @ r0w[:3].t()
    grads.append(a["bh"][3].t() @ doff_t)
    g = (doff_t @ bow[:, :3].t()) * (a["bh"][3] > 0)
    for layer, w in ((2, b3w), (1, b2w), (0, b1w)):
        grads.append(a["bh"][layer].t() @ g)
        g = (g @ w.t()) * (a["bh"][layer] > 0)
    grads += [a["ptsb"].t() @ g, a["latb"].t() @ g]
    return dbent + dpts + g @ b0p[:3].t(), g @ b0l.t(), grads


def fused_weights(model, device, network):
    from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
    from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
    with torch.no_grad():
        return tuple(w.detach().to(device) for w in FF.cast_fused_weights(
            FQ.pack_fused_weights(model, network=network)))


def device_ms(fn, iters: int = 10) -> float:
    """The device time of fn per call, without the host's gaps between calls
    that a CUDA-event timing of a kernel shorter than its wrapper's host time
    includes: a spin kernel (about 50 ms) holds the stream until the host has
    queued all the calls, so the events time them back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(kernel, plain, chain, flops, nbytes):
    """ms of the kernel (CUDA events over 10 calls, with and without the
    host's gaps between them), of its plain version and of the bf16
    yardstick, and the roofline bound."""
    ms = cuda_time_ms(kernel, 10)
    kernel_device_ms = device_ms(kernel)
    plain_ms = cuda_time_ms(plain, 3, warmup=1)
    chain_ms = cuda_time_ms(chain, 10)
    bound_ms, bound_by = roofline(flops, nbytes)
    return dict(ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
                matmul_chain_bf16_ms=chain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def log_timing(name, n, t):
    log(f"{name} n={n}: kernel {t['ms']:.4f} ms (device time "
        f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, bf16 matmul "
        f"chain {t['matmul_chain_bf16_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']})")


def check_fused_forwards(model, n, device, network):
    """`bend_fwd` and `fused_fwd` against their plain versions at n points,
    bit-equal on relaunch, with timings."""
    from nonrigid_nerf_torch.ops.kernels import bend_fwd as BF
    from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
    from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
    w = fused_weights(model, device, network)
    bw = w[:18]
    pts, lat, _ = fused_inputs(model, n, device, SEED + n)
    got = BF.bend_fwd(pts, lat, bw)
    errs = BF.bend_fwd_agreement(got, BF.bend_fwd_plain(pts, lat, bw))
    torch.cuda.synchronize()
    log(f"bend_fwd n={n}: emb mean abs err {errs['emb_mean']:.3e} (tol "
        f"{BF.BEND_TOL_EMB_MEAN:.0e}), share of entries off by over "
        f"{BF.BEND_TOL_EMB_ENTRY:.0e} {errs['emb_outliers']:.3e} (tol "
        f"{BF.BEND_TOL_EMB_OUTLIERS:.0e}), worst {errs['emb_max']:.3e}; off "
        f"{errs['off']:.3e} (tol {BF.BEND_TOL_OFF:.0e}), rig {errs['rig']:.3e} "
        f"(tol {BF.BEND_TOL_RIG:.0e})")
    if not errs["ok"]:
        raise AssertionError(f"bend_fwd disagrees with its plain version: {errs}")
    if not all(torch.equal(a, b) for a, b in zip(got, BF.bend_fwd(pts, lat, bw))):
        raise AssertionError("bend_fwd is not deterministic")
    bend_t = timings(lambda: BF.bend_fwd(pts, lat, bw),
                     lambda: BF.bend_fwd_plain(pts, lat, bw),
                     lambda: bend_chain_bf16(pts, lat, bw),
                     2.0 * BF.BEND_MACS_PER_POINT * n,
                     tensor_bytes(pts, lat, *got, *bw[:16]))
    log_timing("bend_fwd", n, bend_t)

    out = FF.fused_fwd(pts, lat, w)
    ferrs = FF.fused_fwd_agreement(out, FF.fused_fwd_plain(pts, lat, w))
    torch.cuda.synchronize()
    log(f"fused_fwd n={n}: raw max abs err {ferrs['raw_max']:.3e} (tol "
        f"{FF.FUSED_TOL_RAW_MAX:.0e}), mean {ferrs['raw_mean']:.3e} (tol "
        f"{K.BF16_TOL_MEAN:.0e}); off {ferrs['off']:.3e}, rig {ferrs['rig']:.3e}")
    if not ferrs["ok"]:
        raise AssertionError(f"fused_fwd disagrees with its plain version: {ferrs}")
    if not all(torch.equal(a, b) for a, b in zip(out, FF.fused_fwd(pts, lat, w))):
        raise AssertionError("fused_fwd is not deterministic")
    fam = Family("plain")
    fused_t = timings(lambda: FF.fused_fwd(pts, lat, w),
                      lambda: FF.fused_fwd_plain(pts, lat, w),
                      lambda: fam.fwd_chain_bf16(
                          (bend_chain_bf16(pts, lat, bw)[0].to(torch.bfloat16),),
                          w[18:]),
                      2.0 * (K.MACS_PER_POINT + BF.BEND_MACS_PER_POINT) * n,
                      tensor_bytes(pts, lat, *out, *bw[:16], *w[18:]))
    log_timing("fused_fwd", n, fused_t)
    return (dict(max_abs_err=errs["emb_max"], errors=errs, **bend_t),
            dict(max_abs_err=ferrs["raw_max"], errors=ferrs, **fused_t))


def backward_splits_child(root) -> int:
    """`python3 chip_smoke.py --splits`: rows 8 and 10's device ms by
    kernel (`device_ms_by_part`) at a training step's two sizes, on
    `check_fused_backwards`' inputs, as one JSON line, in a process of their
    own: late in the main process the profiler keeps only part of these
    kernels' launches."""
    from nonrigid_nerf_torch.config import load_args, model_config_from_args
    from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
    from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
    device = torch.device("cuda")
    args = load_args(os.path.join(root, "configs", "example_sequence.txt"))
    cfg = model_config_from_args(args)
    model = flagship_model(cfg, device)
    out = {}
    with torch.no_grad():
        for n, net in ((args.N_rand * cfg.N_samples, "coarse"),
                       (args.N_rand * (cfg.N_samples + cfg.N_importance), "fine")):
            w = fused_weights(model, device, net)
            pts, lat, gen = fused_inputs(model, n, device, SEED + n + 1)
            for name, fn, weights, cols in (("bend_bwd", BB.bend_bwd, w[:18], (64, 3, 1)),
                                            ("fused_bwd", FB.fused_bwd, w, (8, 3, 1))):
                cots = [torch.randn((n, c), generator=gen, device=device) for c in cols]

                def call():
                    return fn(pts, lat, weights, *cots)

                out[f"{name} {n}"] = device_ms_by_part(call, device_ms(call))
    print(json.dumps({"splits": out}), flush=True)
    return 0


def backward_splits() -> dict:
    """Rows 8 and 10's device ms by kernel from `--splits`, keyed "name
    n"; {} where that process fails."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--splits"],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines:
        if line.startswith("profile by kernel"):
            log(f"--splits: {line}")
    if r.returncode or not lines or not lines[-1].startswith('{"splits"'):
        log(f"--splits: exit {r.returncode}; {r.stderr[-1000:]}")
        return {}
    return json.loads(lines[-1])["splits"]


def check_fused_backwards(model, n, device, network, splits):
    """`bend_bwd` and `fused_bwd` against their plain versions at n points,
    bit-equal on relaunch, with timings; their device ms by kernel from
    `splits` (`backward_splits`)."""
    from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
    from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
    w = fused_weights(model, device, network)
    bw = w[:18]
    pts, lat, gen = fused_inputs(model, n, device, SEED + n + 1)

    def randn(cols, scale=1.0):
        return scale * torch.randn((n, cols), generator=gen, device=device)

    results = []
    for name, fn, plain, agree, cots, macs, chain in (
            ("bend_bwd", BB.bend_bwd, BB.bend_bwd_plain, BB.bend_bwd_agreement,
             (randn(64, 0.1), randn(3), randn(1)), BB.BEND_BWD_MACS_PER_POINT,
             lambda c: bend_bwd_chain_bf16(pts, lat, bw, *c)),
            ("fused_bwd", FB.fused_bwd, FB.fused_bwd_plain,
             FB.fused_bwd_agreement, (randn(8), randn(3), randn(1)),
             FB.FUSED_BWD_MACS_PER_POINT,
             lambda c: fused_bwd_chain_bf16(pts, lat, w, *c))):
        weights = bw if name == "bend_bwd" else w
        got = fn(pts, lat, weights, *cots)
        ref = plain(pts, lat, weights, *cots)
        torch.cuda.synchronize()
        stats = agree(got, ref)
        log(f"{name} n={n}: {len(got[2])} gradients max err "
            f"{stats['grad_max_rel']:.3e} of max magnitude, L2 "
            f"{stats['grad_l2_rel']:.3e}; dpts and dlat L2 "
            f"{stats['demb_l2_rel']:.3e}, outliers {stats['demb_outliers']:.3e}, "
            f"worst {stats['demb_max_rel']:.3e}")
        log(f"{name} max abs err of each array over its max magnitude: "
            + " ".join(f"{k}={v:.2e}" for k, v in stats["max_rel"].items()))
        if not stats["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{stats}")
        again = fn(pts, lat, weights, *cots)
        if not all(torch.equal(a, b) for a, b in zip(
                [got[0], got[1], *got[2]], [again[0], again[1], *again[2]])):
            raise AssertionError(f"{name} is not deterministic")
        t = timings(lambda: fn(pts, lat, weights, *cots),
                    lambda: plain(pts, lat, weights, *cots),
                    lambda: chain(cots), 2.0 * macs * n,
                    tensor_bytes(pts, lat, *cots, got[0], got[1], *got[2],
                                 *weights[:16], *weights[18:]))
        log_timing(name, n, t)
        # the device time by kernel: row 8's kernel and its reduction; row
        # 10's pre-pass, row 2's kernels, row 8's (with row 2's two-pass
        # floor: its scratch written and read back)
        split = splits.get(f"{name} {n}")
        if split is not None:
            t["split_ms_per_launch"] = split
        floor = ""
        if name == "fused_bwd":
            t["scratch_floor_ms"] = 2 * 2 * n * (64 + 16 * 256) / PEAK_HBM_BYTES * 1e3
            floor = f"; the scratch's round trip alone {t['scratch_floor_ms']:.4f} ms"
        log(f"{name} n={n}: device ms by kernel " + (", ".join(
            f"{k} {v:.4f}" for k, v in split.items()) if split is not None
            else "not reported: no whole profile") + floor)
        results.append(dict(max_abs_err=stats["grad_max_rel"], agreement=stats,
                            **t))
    return results


def fused_bwd_chain_bf16(pts, lat, w, draw, doff, drig):
    """The fused backward as cuBLAS bf16 matmuls (a yardstick only): the
    canonical MLP's, then the bender's."""
    embb = bend_chain_bf16(pts, lat, w[:18])[0].to(torch.bfloat16)
    demb, _, _ = Family("plain").bwd_chain_bf16((embb,), w[18:],
                                                draw.to(torch.bfloat16))
    return bend_bwd_chain_bf16(pts, lat, w[:18], demb.float(), doff, drig)


def entry_point_runs(model, model_unshifted, sizes, device):
    """Both entry points at each (points, network, backward?) of `sizes`,
    launch counts set to 0 just before each call and read just after; the
    split held bit-equal to the monolith; with a backward, the gradients
    against the f32 modules' (on the parameters without the raised density
    bias). Returns the launches by kernel, summed over the calls."""
    from nonrigid_nerf_torch.ops.embedding import fourier_embed
    from nonrigid_nerf_torch.ops.kernels import fused_query as FQ

    def loss_of(raw, off, rig):      # the JAX tests' loss
        return (raw ** 2).mean() + 10 * (off ** 2).mean() + (rig ** 2).mean()

    def run(entry, m, pts, lat, network, backward):
        names = [k for k, _ in m.named_parameters()
                 if k.startswith((network + ".", "bender."))]
        params = dict(m.named_parameters())
        if not backward:
            with torch.no_grad():
                return entry(m, pts, lat, network=network), {}
        p, l = pts.clone().requires_grad_(True), lat.clone().requires_grad_(True)
        out = entry(m, p, l, network=network)
        grads = torch.autograd.grad(loss_of(*out), [p, l] + [params[k] for k in names])
        return out, dict(zip(["pts", "lat"] + names, grads))

    total = {}
    for n, network, backward in sizes:
        pts, lat, _ = fused_inputs(model, n, device, SEED + 3 * n)
        results = {}
        for label, entry, want in (
                ("fused_point_query", FQ.fused_point_query,
                 {"fused_fwd": 1, "fused_bwd": int(backward)}),
                ("fused_point_query_split", FQ.fused_point_query_split,
                 {"bend_fwd": 1, "mlp_fwd": 1, "mlp_bwd": int(backward),
                  "bend_bwd": int(backward)})):
            reset_launch_counts()
            results[label] = run(entry, model, pts, lat, network, backward)
            torch.cuda.synchronize()
            counts = launch_counts()
            expected = {k: want.get(k, 0) for k in counts}
            log(f"{label} n={n} ({network}{', backward' if backward else ''}): "
                f"launches {dict((k, v) for k, v in counts.items() if v)} "
                f"(expected {dict((k, v) for k, v in expected.items() if v)}, "
                "every other kernel 0)")
            if counts != expected:
                raise AssertionError(f"{label} did not run its kernels once each")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        (mono, mono_g), (split, split_g) = results.values()
        same = all(torch.equal(a, b) for a, b in zip(mono, split)) and \
            mono_g.keys() == split_g.keys() and \
            all(torch.equal(mono_g[k], split_g[k]) for k in mono_g)
        log(f"split vs monolith n={n}: bit-equal in value"
            f"{' and every gradient' if backward else ''} = {same}")
        if not same:
            raise AssertionError("the split entry point disagrees with the "
                                 "monolith")
        if not all(torch.isfinite(t).all() for t in (*mono, *mono_g.values())):
            raise AssertionError("non-finite outputs or gradients")
        if backward:
            def f32_path(m, x, l, network):
                bent, det = m.bender(x, l)
                raw = m.network(network)(fourier_embed(bent, 10))
                return raw, det["unmasked_offsets"], det["rigidity_mask"]

            _, got = run(FQ.fused_point_query, model_unshifted, pts, lat,
                         network, True)
            _, want = run(f32_path, model_unshifted, pts, lat, network, True)
            rel = {k: ((got[k] - want[k]).abs().max()
                       / want[k].abs().max().clamp_min(1e-6)).item()
                   for k in got if k not in ("pts", "lat")}
            worst = max(rel, key=rel.get)
            log(f"fused_point_query n={n} gradients vs the f32 modules: worst "
                f"{rel[worst]:.4f} of max magnitude ({worst}) over {len(rel)} "
                f"parameters (need < {FUSED_F32_GRAD_TOL})")
            if rel[worst] >= FUSED_F32_GRAD_TOL:
                raise AssertionError("the entry point's gradients disagree "
                                     "with the f32 modules'")
    return total


def fused_query_phase(cfg, device, smi, sizes):
    """Phase 5: the four kernels against their plain versions, the entry
    points with their launch counts, the comparison with the engine's stage
    1 + `mlpe_fwd`. `sizes` = (render block's coarse pass, a training step's
    coarse and fine passes). Returns (the four kernels rows, results)."""
    from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
    from nonrigid_nerf_torch.ops.kernels import mlpe_fwd as KE
    n_render, n_train, n_train_fine = sizes
    model = flagship_model(cfg, device)
    model_unshifted = copy.deepcopy(model)
    with torch.no_grad():
        for net in (model_unshifted.coarse, model_unshifted.fine):
            net.output.bias[3] -= 1.0
    with torch.no_grad():
        fwd = [check_fused_forwards(model, n, device, net)
               for n, net in ((n_render, "coarse"), (n_train, "coarse"),
                              (n_train_fine, "fine"))]
        splits = backward_splits()
        bwd = [check_fused_backwards(model, n, device, net, splits)
               for n, net in ((n_train, "coarse"), (n_train_fine, "fine"))]
        # past one launch: the autograd functions' pieces
        pieces = dict(zip(("bend_bwd", "fused_bwd"),
                          fused_bwd_in_pieces(model, device)))
    launches = entry_point_runs(
        model, model_unshifted, ((n_render, "coarse", False),
                                 (n_train, "coarse", True),
                                 (n_train_fine, "fine", True)), device)

    # what the engine spends on the same function today: the f32 bender
    # (bend_encode_stage's products) and mlpe_fwd on the bent points
    pts, lat, _ = fused_inputs(model, n_render, device, SEED)
    with torch.no_grad():
        mw = tuple(t.detach() for t in K.cast_mlp_weights(
            K.pack_mlp_weights(model.coarse)))
        bender_ms = cuda_time_ms(lambda: model.bender(pts, lat), 5)
        engine_ms = cuda_time_ms(lambda: KE.mlpe_fwd(model.bender(pts, lat)[0], mw),
                                 5)
    fused_ms = fwd[0][1]["ms"]
    log(f"fused_fwd against the engine at {n_render} points: fused_fwd "
        f"{fused_ms:.4f} ms; the f32 bender {bender_ms:.4f} ms, then mlpe_fwd: "
        f"{engine_ms:.4f} ms in all ({engine_ms / fused_ms:.3f} x); {smi}")

    src = "nonrigid_nerf_torch/ops/kernels/csrc/"
    rows = []
    for name, checks, points in (
            ("bend_fwd", [f[0] for f in fwd], (n_render, n_train, n_train_fine)),
            ("bend_bwd", [b[0] for b in bwd], (n_train, n_train_fine)),
            ("fused_fwd", [f[1] for f in fwd], (n_render, n_train, n_train_fine)),
            ("fused_bwd", [b[1] for b in bwd], (n_train, n_train_fine))):
        head = checks[0]
        rows.append({"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                     "replaces": FUSED_REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": max(c["max_abs_err"] for c in checks),
                     "ms": head["ms"], "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                     "library_ms": None, "points": points[0],
                     "device_ms": head["device_ms"],
                     "matmul_chain_bf16_ms": head["matmul_chain_bf16_ms"],
                     "other_sizes": [{"points": p, **{k: v for k, v in c.items()
                                                      if k != "agreement"}}
                                     for p, c in zip(points[1:], checks[1:])]})
        rows[-1]["other_sizes"] += pieces.get(name, [])
        for key in ("scratch_floor_ms", "split_ms_per_launch"):
            if key in head:
                rows[-1][key] = head[key]
    return rows, dict(engine_stage1_mlpe_ms=engine_ms, bender_f32_ms=bender_ms,
                      fused_fwd_ms=fused_ms, points=n_render, gpu=smi)



# ---- the CLI on a real dataset (python3 -m nonrigid_nerf_torch.cli.train)
def cli_argv(root, rootdir, *extra):
    return ["--config", os.path.join(root, CLI_CONFIG),
            "--datadir", os.path.join(root, CLI_DATA),
            "--N_iters", str(CLI_STEPS), "--i_print", str(CLI_PRINT),
            "--i_weights", str(CLI_EVERY), "--i_img", str(CLI_EVERY),
            "--i_video", "1000000", "--i_testset", "1000000",
            "--rootdir", rootdir, "--expname", "occlusion_cli", *extra]


def cli_subprocess(root, argv):
    return subprocess.run(
        [sys.executable, "-m", "nonrigid_nerf_torch.cli.train"] + argv,
        cwd=root, capture_output=True, text=True, timeout=600)


def cli_rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return np.asarray(a).dtype == np.asarray(b).dtype and \
        np.array_equal(np.asarray(a), np.asarray(b))


def cli_phase(root, smi, tmp):
    """Run A: the training CLI in this process on data_r5/occlusion, launch
    counts set to 0 just before and read just after; the experiment folder,
    finite values, a falling loss. Run B: the same command in a subprocess
    that SIGKILLs itself after its save at step CLI_EVERY, started again: the
    metric stream and the final parameters and Adam moments bit-equal to
    A's. Both run under `tmp`; run A's experiment folder stays there for
    phase 6. Returns (results, run A's folder)."""
    from nonrigid_nerf_torch.checkpoints import read_checkpoint
    from nonrigid_nerf_torch.cli import train as cli
    from nonrigid_nerf_torch.config import load_args

    logdir_a = os.path.join(tmp, "A", "occlusion_cli", "logs")
    probe = {}
    real_probe = cli.determine_nerf_volume_extent

    def counted_probe(*a, **kw):
        before = launch_counts()
        result = real_probe(*a, **kw)
        probe.update({k: v - before[k] for k, v in launch_counts().items()
                      if v != before[k]})
        return result

    cli.determine_nerf_volume_extent = counted_probe
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        cli.main(cli_argv(root, os.path.join(tmp, "A")))
    finally:
        cli.determine_nerf_volume_extent = real_probe
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    frames = CLI_STEPS // CLI_EVERY
    blocks = -(-CLI_FRAME[0] * CLI_FRAME[1] // CHUNK)
    # one backward launch a network and cotangent: the test rays' second
    # cotangent exists only with a test split, which this config has not
    args = load_args(os.path.join(root, CLI_CONFIG))
    bwd = 4 if args.train_block_size > 0 and args.test_block_size > 0 \
        else 2
    want = {"mlp_fwd": 2 * CLI_STEPS + 2 * blocks * frames + 2,
            "mlp_bwd": bwd * CLI_STEPS}
    log(f"cli (A, in this process): {CLI_STEPS} steps, {frames} validation "
        f"frames, the volume probe in {wall:.2f} s (data loading, the "
        f"backup and the saves included); launches {counts} (expected "
        f"{want}: 2 + {bwd} a step, {2 * blocks} a frame, "
        f"2 the probe)")
    log(f"cli volume probe: launches {probe} (expected {{'mlp_fwd': 2}})")
    if counts != want or probe != {"mlp_fwd": 2}:
        raise AssertionError("the CLI's run launched other kernels or "
                             "other counts than expected")
    for name in ("args.txt", "config.txt", "cameras.obj", "metrics.jsonl",
                 "latest.npz",
                 os.path.join("val_images", f"{CLI_EVERY:06d}.png"),
                 os.path.join("val_images", f"{CLI_STEPS:06d}.png")):
        if not os.path.exists(os.path.join(logdir_a, name)):
            raise AssertionError(f"the experiment folder lacks {name}")
    if not os.path.isdir(os.path.join(tmp, "A", "occlusion_cli", "backup",
                                      "nonrigid_nerf_torch")):
        raise AssertionError("the experiment folder lacks backup/")
    step_a, params_a, _, opt_a = read_checkpoint(
        os.path.join(logdir_a, "latest.npz"), with_opt_state=True)
    if step_a != CLI_STEPS:
        raise AssertionError(f"latest.npz is at step {step_a}")
    for leaf in checkpoint_leaves((params_a, opt_a)):
        if not np.isfinite(leaf).all():
            raise AssertionError("non-finite values in latest.npz")
    rows = cli_rows(logdir_a)
    train_rows = [r for r in rows if "loss" in r]
    val_rows = [r for r in rows if "val_psnr" in r]
    peak = [r["peak_device_bytes"] for r in rows if "peak_device_bytes" in r]
    if [r["step"] for r in train_rows] != list(
            range(CLI_PRINT, CLI_STEPS + 1, CLI_PRINT)) \
            or [r["step"] for r in val_rows] != [CLI_EVERY, CLI_STEPS] \
            or len(peak) != 1:
        raise AssertionError(f"unexpected metrics.jsonl rows {rows}")
    for r in rows:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite metrics {r}")
    first, last = train_rows[0], train_rows[-1]
    if not last["loss"] < first["loss"]:
        raise AssertionError("the CLI's loss did not fall")
    rates = [r["it_per_sec"] for r in train_rows[1:]]
    steps_per_s = CLI_PRINT * len(rates) / sum(CLI_PRINT / r for r in rates)
    log(f"cli (A): loss {first['loss']:.5f} (step {CLI_PRINT}) -> "
        f"{last['loss']:.5f} (step {CLI_STEPS}); psnr {first['psnr']:.2f} "
        f"-> {last['psnr']:.2f}; {steps_per_s:.2f} steps/s over steps "
        f"{CLI_PRINT + 1}-{CLI_STEPS} (a validation frame and a save "
        f"included); validation PSNR "
        + ", ".join(f"{r['val_psnr']:.2f} dB at {r['step']}"
                    for r in val_rows)
        + f" (view {val_rows[0]['val_view']}); peak device memory "
        f"{peak[0]} B ({peak[0] / 2**30:.3f} GiB); {smi}")

    # run B: killed after its save at step CLI_EVERY, then started again
    argv_b = cli_argv(root, os.path.join(tmp, "B"), "--die_at_step",
                      str(CLI_EVERY))
    t0 = time.perf_counter()
    killed = cli_subprocess(root, argv_b)
    if killed.returncode != -9 or "SIGKILL at step" not in killed.stdout:
        raise AssertionError(f"run B exited with {killed.returncode}, "
                             f"not -9: {killed.stderr[-3000:]}")
    resumed = cli_subprocess(root, argv_b)
    wall_b = time.perf_counter() - t0
    if resumed.returncode != 0 or "Reloading from" not in resumed.stdout:
        raise AssertionError(f"run B did not resume ({resumed.returncode})"
                             f": {resumed.stdout[-2000:]}"
                             f"{resumed.stderr[-3000:]}")
    logdir_b = os.path.join(tmp, "B", "occlusion_cli", "logs")
    rows_b = cli_rows(logdir_b)
    fields = ("loss", "psnr", "img_loss", "img_loss0", "offsets_loss",
              "divergence_loss")

    def stream(rs):
        return [{k: r[k] for k in ("step", "val_psnr") + fields if k in r}
                for r in rs if "loss" in r or "val_psnr" in r]

    step_b, params_b, _, opt_b = read_checkpoint(
        os.path.join(logdir_b, "latest.npz"), with_opt_state=True)
    metrics_equal = stream(rows) == stream(rows_b)
    state_equal = step_b == step_a and same_tree(params_a, params_b) \
        and same_tree(opt_a, opt_b)
    log(f"cli (B, subprocesses): killed with {killed.returncode} after the "
        f"save at step {CLI_EVERY}, resumed to step {step_b} in "
        f"{wall_b:.2f} s for both launches; metrics.jsonl equal to A's at "
        f"every printed step: {metrics_equal}; parameters and Adam moments "
        f"bit-equal to A's: {state_equal}")
    if not (metrics_equal and state_equal):
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    out = {"steps": CLI_STEPS, "launches": counts, "probe_launches": probe,
           "steps_per_s": steps_per_s, "wall_s_a": wall,
           "loss_first": first["loss"], "loss_last": last["loss"],
           "psnr_last": last["psnr"],
           "val_psnr_db": {r["step"]: r["val_psnr"] for r in val_rows},
           "peak_device_bytes": peak[0], "resume_bit_equal": True,
           "wall_s_b": wall_b}
    return out, os.path.join(tmp, "A", "occlusion_cli")


# ---- free-viewpoint rendering (python3 -m nonrigid_nerf_torch.cli.
# free_viewpoint_rendering) of the CLI's run A, and the trained r3_eval
# checkpoint
def fvr_run(exp, flags):
    """One free-viewpoint rendering of `exp` in this process, launch counts
    set to 0 just before and read just after. Returns (output folder,
    launches of the kernels that ran, seconds of each frame as the CLI
    printed them)."""
    import contextlib
    import io

    from nonrigid_nerf_torch.cli import free_viewpoint_rendering as fvr
    buf = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        folder = fvr.free_viewpoint_rendering(fvr.build_parser().parse_args(
            ["--input", exp] + flags))
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    text = buf.getvalue()
    print(text, end="", flush=True)
    frame_s = [float(m) for m in re.findall(r"rendered frame \d+/\d+ in "
                                            r"([0-9.]+) s", text)]
    return folder, counts, frame_s


def rgb_frames(folder):
    from nonrigid_nerf_torch.utils.image_io import imread
    names = sorted(f for f in os.listdir(folder) if f.startswith("rgb_"))
    return np.stack([imread(os.path.join(folder, f)) / 255.0 for f in names])


def fvr_phase(exp, smi):
    """Phase 6: the free-viewpoint CLI on the CLI's run A (the occlusion
    scene after CLI_STEPS steps), every FVR_STRIDE-th of its 60 training frames:
    `input_reconstruction` (scores.json finite; `mlp_fwd` 4 launches a
    frame, 2 blocks x 2 passes, and nothing else), `fixed`
    (background_stability.json), `--motion_factor 2` (an edit: no kernel
    launches), `--quantize_inference` (`mlp_i8` 4 launches a frame, the
    frames at least 30 dB from the f32 path's), `--export_ray_bending_objs`
    (on an `adaptive_spiral` path: the OBJ files; 2 more launches a frame
    for the 100 rays); the f32 path is the experiment rendered with
    fused_kernel = off in args.txt."""
    import shutil

    from nonrigid_nerf_torch.config import Args, parse_config_file

    blocks = -(-CLI_FRAME[0] * CLI_FRAME[1] // CHUNK)
    n = -(-60 // FVR_STRIDE)
    base = ["--deformations", "train", "--view_stride", str(FVR_STRIDE)]
    exp_off = exp + "_off"
    shutil.copytree(exp, exp_off)
    args_path = os.path.join(exp_off, "logs", "args.txt")
    Args(**parse_config_file(args_path)).replace(fused_kernel="off").dump(
        args_path)
    runs = {
        "input_reconstruction": (exp, ["--camera_path", "input_reconstruction"],
                                 {"mlp_fwd": 2 * blocks * n}),
        "fixed": (exp, ["--camera_path", "fixed"], {"mlp_fwd": 2 * blocks * n}),
        "motion_factor_2": (exp, ["--camera_path", "input_reconstruction",
                                  "--motion_factor", "2"], {}),
        "int8": (exp, ["--camera_path", "input_reconstruction",
                       "--quantize_inference"], {"mlp_i8": 2 * blocks * n}),
        "objs": (exp, ["--camera_path", "adaptive_spiral",
                       "--export_ray_bending_objs"],
                 {"mlp_fwd": (2 * blocks + 2) * n}),
        "off": (exp_off, ["--camera_path", "input_reconstruction"], {}),
    }
    out, folders = {}, {}
    for name, (where, flags, want) in runs.items():
        t0 = time.perf_counter()
        folder, counts, frame_s = fvr_run(where, base + flags)
        wall = time.perf_counter() - t0
        folders[name] = folder
        log(f"fvr ({name}): {len(frame_s)} frames, s per frame "
            + ", ".join(f"{t:.4f}" for t in frame_s)
            + f"; median {float(np.median(frame_s)):.4f}, mean "
            f"{float(np.mean(frame_s)):.4f}; the whole call {wall:.2f} s "
            f"(loading, PNGs, videos, scores included); launches {counts} "
            f"(expected {want}); {smi}")
        if counts != want or len(frame_s) != n:
            raise AssertionError(f"fvr ({name}) launched other kernels or "
                                 "other counts than expected")
        out[name] = {"frames": len(frame_s), "launches": counts,
                     "s_per_frame_median": float(np.median(frame_s)),
                     "s_per_frame_mean": float(np.mean(frame_s)),
                     "wall_s": wall, "folder": os.path.basename(folder)}
    for name in ("input_reconstruction", "motion_factor_2", "int8", "off"):
        with open(os.path.join(folders[name], "scores.json")) as f:
            scores = json.load(f)
        if not (math.isfinite(scores["average_psnr"])
                and math.isfinite(scores["average_ssim"])
                and scores["average_lpips"] is None):
            raise AssertionError(f"fvr ({name}): scores.json {scores}")
        out[name]["average_psnr"] = scores["average_psnr"]
        out[name]["average_ssim"] = scores["average_ssim"]
    with open(os.path.join(folders["fixed"],
                           "background_stability.json")) as f:
        out["fixed"]["background_stability"] = json.load(f)
    objs = [f for f in os.listdir(folders["objs"]) if f.endswith(".obj")]
    if len(objs) != 3 * n or "_int8" not in os.path.basename(folders["int8"]):
        raise AssertionError(f"fvr: {len(objs)} OBJ files, int8 folder "
                             f"{folders['int8']}")
    off = rgb_frames(folders["off"])
    for name in ("input_reconstruction", "int8"):
        out[name]["psnr_vs_off_db"] = [psnr(a, b) for a, b in
                                       zip(rgb_frames(folders[name]), off)]
    log("fvr: scores.json average_psnr / average_ssim "
        + ", ".join(f"{k} {out[k]['average_psnr']:.4f} / "
                    f"{out[k]['average_ssim']:.4f}"
                    for k in ("input_reconstruction", "int8", "off",
                              "motion_factor_2"))
        + f"; background stability {out['fixed']['background_stability']}; "
        "PSNR of the frames (8-bit PNGs) against off: kernels "
        f"{min(out['input_reconstruction']['psnr_vs_off_db']):.2f} dB, int8 "
        f"{min(out['int8']['psnr_vs_off_db']):.2f} dB or more (need >= "
        f"{MIN_PSNR_INT8_DB}); {smi}")
    if min(out["int8"]["psnr_vs_off_db"]) < MIN_PSNR_INT8_DB:
        raise AssertionError("the int8 frames disagree with the f32 path")
    return out


def look_at_poses(scripts, n=2):
    """Cameras on the volume's near face, looking at its centre, spread
    sideways (NeRF's camera frame: columns right, up, back)."""
    lo = np.asarray(scripts["min_nerf_volume_point"])
    hi = np.asarray(scripts["max_nerf_volume_point"])
    center = (lo + hi) / 2.0
    poses = []
    for i in range(n):
        pos = np.array([center[0] + (i - (n - 1) / 2) * 0.2 * (hi[0] - lo[0]),
                        center[1], hi[2]])
        back = (pos - center) / np.linalg.norm(pos - center)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        poses.append(np.concatenate(
            [np.stack([right, up, back], 1), pos[:, None]], 1))
    return np.stack(poses).astype(np.float32)


def trained_weights_phase(root, device, smi):
    """Phase 7: the trained checkpoint of results/r3_eval at its own
    384 x 512 intrinsics, from two look-at poses inside its volume
    (scripts_dict), rendered with `auto`, `pts` and `int8` (calibrated on
    the two poses' rays) against `off`: PSNR at least 40, 40 and 30 dB,
    12 launches a frame of the mode's kernel and of no other."""
    from nonrigid_nerf_torch.checkpoints import load_checkpoint
    from nonrigid_nerf_torch.config import (load_args, model_config_from_args,
                                            render_settings_from_args)
    from nonrigid_nerf_torch.ops.kernels.quant_mlp import \
        quantize_for_inference
    from nonrigid_nerf_torch.ops.rays import get_rays

    args = load_args(os.path.join(root, R3_EVAL, "args.txt"))
    cfg = model_config_from_args(args)
    step, model, extras = load_checkpoint(
        os.path.join(root, R3_EVAL, "latest.npz"), cfg, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    if step != 200000 or n_params != R3_EVAL_PARAMETERS:
        raise AssertionError(f"r3_eval: step {step}, {n_params} parameters")
    scripts = extras["scripts_dict"]
    rs = render_settings_from_args(args, scripts["near"], scripts["far"])
    poses = look_at_poses(scripts)
    intrinsics = [extras["intrinsics"]["0"]] * len(poses)
    h, w = int(intrinsics[0]["height"]), int(intrinsics[0]["width"])
    latents = model.latents.detach().cpu().numpy()[list(R3_EVAL_LATENTS)]
    rays = [get_rays(torch.as_tensor(p, device=device), intrinsics[0])
            for p in poses]
    model_q = quantize_for_inference(
        model, cfg, torch.cat([r[0].reshape(-1, 3) for r in rays]),
        torch.cat([r[1].reshape(-1, 3) for r in rays]),
        torch.as_tensor(np.repeat(latents, h * w, 0), device=device),
        rs.near, rs.far)
    blocks = -(-h * w // CHUNK)
    modes = (("off", model, None, None), ("auto", model, "mlp_fwd", MIN_PSNR_DB),
             ("pts", model, "mlpe_fwd", MIN_PSNR_DB),
             ("int8", model_q, "mlp_i8", MIN_PSNR_INT8_DB))
    out, off = {}, None
    for mode, m, kernel, limit in modes:
        cfg_m = dataclasses.replace(cfg, fused_kernel=mode)
        reset_launch_counts()
        rgbs, disps, frame_s = render_frames(m, cfg_m, rs, poses, intrinsics,
                                             latents, device,
                                             f"r3_eval, fused_kernel={mode}")
        counts = {k: v for k, v in launch_counts().items() if v}
        want = {kernel: 2 * blocks * len(poses)} if kernel else {}
        if counts != want or not np.isfinite(rgbs).all():
            raise AssertionError(f"r3_eval ({mode}): launches {counts} "
                                 f"(expected {want}), or non-finite pixels")
        out[mode] = {"launches": counts, "frame_s": frame_s,
                     "rgb_std": float(rgbs.std())}
        if off is None:
            off = rgbs
            continue
        out[mode]["psnr_vs_off_db"] = [psnr(a, b) for a, b in zip(rgbs, off)]
        log(f"r3_eval ({mode}): PSNR vs off per frame "
            f"{['%.2f' % p for p in out[mode]['psnr_vs_off_db']]} dB (need >= "
            f"{limit}); launches {counts}; {smi}")
        if min(out[mode]["psnr_vs_off_db"]) < limit:
            raise AssertionError(f"r3_eval ({mode}) disagrees with off")
    if out["off"]["rgb_std"] < 0.05:
        raise AssertionError("r3_eval: the frames are flat, the poses see "
                             "no scene")
    return out


def checkpoint_leaves(tree):
    """The numpy leaves of a checkpoint's tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from checkpoint_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from checkpoint_leaves(v)
    elif tree is not None:
        yield np.asarray(tree)


# ---- data parallelism (nonrigid_nerf_torch/parallel/): the flagship's
# step over ranks, against the single-process step on the same generators
def dp_setup(device):
    """The flagship's training setup of phase 4 (configs/
    example_sequence.txt, N_rand 1024, 64 + 64 samples, all three
    regularizers) on the synthetic stack: (cfg, tc, rs, ds, fresh state
    from the seed)."""
    from nonrigid_nerf_torch.config import (load_args, model_config_from_args,
                                            render_settings_from_args,
                                            train_config_from_args)
    from nonrigid_nerf_torch.engine.train_state import create_train_state
    args = load_args(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "configs", "example_sequence.txt"))
    args.seed = SEED
    cfg, tc = model_config_from_args(args), train_config_from_args(args)
    ds = synthetic_dataset(device)
    rs = render_settings_from_args(args, ds.near, ds.far)
    if (tc.N_rand, rs.N_samples, rs.N_importance) != (1024, 64, 64):
        raise AssertionError(f"unexpected flagship setup {tc} {rs}")
    return cfg, tc, rs, ds, create_train_state(cfg, tc, ds.num_timesteps,
                                               device=device)


def dp_steps(step_fn, state, ds, tc, device, steps):
    """`steps` steps from the fresh state, launch counts set to 0 just
    before and read just after: the per-step losses, the final parameters
    (numpy), the launches and the steps/s (the first step's warm-up
    included)."""
    from nonrigid_nerf_torch.apps.train import step_generator
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step_fn(state, ds, step_generator(tc.seed, i, device))["loss"]
              for i in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    return {"losses": [float(v) for v in losses],
            "params": {n: p.detach().cpu().numpy()
                       for n, p in state.model.named_parameters()},
            "launches": counts, "steps_per_s": steps / seconds}


def dp_rank(rank, world, folder, steps):
    """One rank of the 2-rank run (a spawned process): gloo on the one
    card, both ranks on cuda:0."""
    from nonrigid_nerf_torch.parallel import (make_parallel_train_step,
                                              multihost)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        device = multihost.initialize(rank, world, f"file://{folder}/pg",
                                      device="cuda:0", backend="gloo")
        cfg, tc, rs, ds, state = dp_setup(device)
        multihost.replicate(state.model)
        step_fn = make_parallel_train_step(cfg, tc, rs, ds.has_test_split)
        result = ("ok", dp_steps(step_fn, state, ds, tc, device, steps))
    except Exception:   # noqa: BLE001 - reported to the parent, which fails
        import traceback
        result = ("error", traceback.format_exc())
    finally:
        if multihost.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def dp_phase(device, smi):
    """The data-parallel step of the flagship for DP_STEPS steps: the
    single-process step (the reference), the data-parallel step at world
    size 1 on nccl, and 2 ranks sharing the card on gloo (which takes CUDA
    tensors for all-reduce and broadcast, where NCCL refuses two ranks on
    one GPU), each from the fresh state of the seed on the same (seed,
    step) generators. Holds every run's losses and final parameters
    against the reference (DP_FIRST_LOSS_RTOL, DP_LOSS_RTOL,
    DP_PARAM_ATOL_LRATE), the 2 ranks' parameters bit-equal, and each rank's launches: 2 `mlp_fwd` and 4
    `mlp_bwd` a step, nothing else."""
    import multiprocessing
    from nonrigid_nerf_torch.engine.train_step import make_train_step
    from nonrigid_nerf_torch.parallel import (make_parallel_train_step,
                                              multihost)
    t_phase = time.perf_counter()
    cfg, tc, rs, ds, state = dp_setup(device)
    ref = dp_steps(make_train_step(cfg, tc, rs, ds.has_test_split), state,
                   ds, tc, device, DP_STEPS)
    runs = {}
    with tempfile.TemporaryDirectory() as folder:
        multihost.initialize(0, 1, f"file://{folder}/pg1", device=device)
        try:
            _, _, _, _, state = dp_setup(device)
            runs["nccl, 1 rank"] = [dp_steps(make_parallel_train_step(
                cfg, tc, rs, ds.has_test_split), state, ds, tc, device,
                DP_STEPS)]
        finally:
            torch.distributed.destroy_process_group()
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=dp_rank, args=(r, 2, folder, DP_STEPS))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:
            if p.is_alive():
                p.kill()
        ranks = []
        for r in range(2):
            path = os.path.join(folder, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise AssertionError(f"data-parallel rank {r} returned nothing")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise AssertionError(f"data-parallel rank {r}:\n{value}")
            ranks.append(value)
        runs["gloo, 2 ranks on one card"] = ranks
        log(f"data parallel: 2 spawned ranks done in "
            f"{time.perf_counter() - t0:.1f} s")

    want_launches = {"mlp_fwd": 2 * DP_STEPS, "mlp_bwd": 4 * DP_STEPS}
    results = {"steps": DP_STEPS, "reference_steps_per_s": ref["steps_per_s"],
               "reference_launches": ref["launches"], "runs": {}}
    if ref["launches"] != want_launches:
        raise AssertionError(f"reference launches {ref['launches']}")
    for name, rank_runs in runs.items():
        loss_err = max(abs(a - b) / abs(b) for run in rank_runs
                       for a, b in zip(run["losses"], ref["losses"]))
        first_err = max(abs(run["losses"][0] - ref["losses"][0])
                        / abs(ref["losses"][0]) for run in rank_runs)
        param_err = max(float(np.abs(run["params"][n] - p).max())
                        for run in rank_runs for n, p in ref["params"].items())
        bit_equal = all(np.array_equal(run["params"][n], p)
                        for run in rank_runs for n, p in ref["params"].items())
        same_ranks = all(np.array_equal(rank_runs[0]["params"][n],
                                        run["params"][n])
                         for run in rank_runs[1:] for n in ref["params"])
        launches = [run["launches"] for run in rank_runs]
        log(f"data parallel ({name}): {DP_STEPS} steps, losses against the "
            f"single-process step: step 1 rel {first_err:.3e} (limit "
            f"{DP_FIRST_LOSS_RTOL:g}), max rel {loss_err:.3e} (limit "
            f"{DP_LOSS_RTOL:g}); final parameters max abs "
            f"{param_err / tc.lrate:.4f} lrate (limit {DP_PARAM_ATOL_LRATE:g}),"
            f" bit-equal {bit_equal}; ranks' parameters identical "
            f"{same_ranks}; launches per rank {launches} (expected "
            f"{want_launches}); steps/s per rank " + ", ".join(
                f"{run['steps_per_s']:.2f}" for run in rank_runs)
            + f" (single process {ref['steps_per_s']:.2f}); {smi}")
        results["runs"][name] = {
            "loss_max_rel": loss_err, "first_loss_rel": first_err,
            "param_max_abs_lrate":
                param_err / tc.lrate, "bit_equal": bit_equal,
            "ranks_identical": same_ranks, "launches": launches,
            "steps_per_s": [run["steps_per_s"] for run in rank_runs],
            "final_loss": rank_runs[0]["losses"][-1]}
        if not all(math.isfinite(v) for run in rank_runs
                   for v in run["losses"]):
            raise AssertionError(f"{name}: non-finite losses")
        if (first_err > DP_FIRST_LOSS_RTOL or loss_err > DP_LOSS_RTOL
                or param_err > DP_PARAM_ATOL_LRATE * tc.lrate):
            raise AssertionError(f"{name}: the data-parallel step departs "
                                 "from the single-process step")
        if not same_ranks or any(c != want_launches for c in launches):
            raise AssertionError(f"{name}: ranks differ, or launched other "
                                 "kernels than the step's")
    log(f"data parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return results


# ---- the backward past one launch, compute_dtype="bfloat16", serving and
# the presampled step

# a backward past one launch runs in pieces (ops/kernels/pieces.py): a
# ragged second piece, and two whole pieces (a training step's fine pass at
# N_rand 4096); rows 8 and 10 also at a render block's coarse pass (8)
PIECE_SIZES = ((1 << 18) + 129, 524288)
PIECE_SIZE_RENDER = 1 << 21
PIECE_PLAIN_WHOLE = 1 << 20      # above it the plain version runs in pieces
BIG_N_RAND = 4096                # one GPU: 262,144 coarse, 524,288 fine points
BIG_STEPS = 5
BF16_STEPS = 100                 # F and B at compute_dtype="bfloat16"
# a bf16 frame against the f32 "off" frame of the same parameters: the bf16
# bender moves every bent point by a bf16 rounding of its offset, which the
# encoding's 2^9 octave turns into phase; the JAX run's bf16 scored 0.06 dB
# under its f32 run (results/r3_bf16). The int8 mode keeps its own limit.
MIN_PSNR_BF16_DB = 30.0
# ... and against the f32 frames of the same kernels, where the family has
# a bender: at most this, so that a bf16 that changed nothing (bit-equal
# frames, an infinite PSNR) fails. F and P read 87-88 dB and V 64 dB
# against the f32 "off" frames; the f32 kernels' own frames 87-99 dB.
MAX_PSNR_BF16_DB = 95.0
# bf16 stage 1 on the card against the CPU's `dense_apply` on the same
# weights and points: at most this share of the offsets' and the mask's
# entries off by more than one bf16 ulp, and at most STAGE1_UNEQUAL of them
# not bit-equal (a sum in another order flips a rounding now and then: 6e-5
# unequal, 1e-5 beyond one ulp on the CPU for f64 sums against f32; a
# rounding before the bias, the planted fault, 0.43-0.58 and 0.15-0.23)
STAGE1_POINTS = 65536
STAGE1_ULP_SHARE = 1e-3
STAGE1_UNEQUAL = 1e-2
SERVE_CHUNK = 32768
PREFETCH_STEPS, PREFETCH = 50, 16


# the backwards whose gradients begin with the bender's 16: their `rob` is
# held by its own error over its own magnitude (bend_bwd.ROB_TOL says why),
# and a planted fault (rob = 0) must fail that check
HAS_ROB = ("bend_bwd", "fused_bwd")


def check_bwd_in_pieces(name, fn, plain, agree, inputs, weights, cots, macs,
                        device):
    """A backward past one launch as its autograd function runs it: the
    kernel wrapper `fn` on pieces of at most PIECE_POINTS points
    (`backward_in_pieces`), against the plain version on all points (past
    PIECE_PLAIN_WHOLE in the same pieces, to bound its f32 temporaries),
    bit-equal on relaunch, one launch a piece; ms, device ms, the plain
    version's ms, the bound and the peak device memory above the inputs."""
    from nonrigid_nerf_torch.ops.kernels.mlp_bwd import grad_max_tol
    from nonrigid_nerf_torch.ops.kernels.pieces import (PIECE_POINTS,
                                                        backward_in_pieces)
    n, k = inputs[0].shape[0], len(inputs)

    def pieced(f):
        return backward_in_pieces(
            lambda *rows: f(*rows[:k], weights, *rows[k:]), *inputs, *cots)

    def reference():
        return pieced(plain) if n > PIECE_PLAIN_WHOLE \
            else plain(*inputs, weights, *cots)

    def flat(r):
        return [*r[:-1], *r[-1]]

    before = fn.launches
    got = pieced(fn)
    torch.cuda.synchronize()
    launches = fn.launches - before
    pieces = -(-n // PIECE_POINTS)
    ref = reference()
    torch.cuda.synchronize()
    rob_rel = None
    if name in HAS_ROB:
        from nonrigid_nerf_torch.ops.kernels.bend_bwd import (ROB, ROB_TOL,
                                                              rob_rel_err)
        rob_rel = rob_rel_err(got[-1], ref[-1])
        planted = list(got[-1])
        planted[ROB] = torch.zeros_like(planted[ROB])
        if rob_rel_err(planted, ref[-1]) <= ROB_TOL:
            raise AssertionError(f"{name}: the rob check passes rob = 0")
        grads = list(ref[-1])
        grads[ROB] = got[-1][ROB]       # held by rob_rel, not by `agree`
        ref = (*ref[:-1], grads)
    stats = agree(got, ref)
    if rob_rel is not None:
        stats["rob_rel"] = rob_rel
        stats["ok"] = stats["ok"] and rob_rel <= ROB_TOL
    del ref
    log(f"{name} n={n} in {pieces} pieces ({launches} launches): gradients "
        f"max err {stats['grad_max_rel']:.3e} of max magnitude, L2 "
        f"{stats['grad_l2_rel']:.3e}; per-point outputs L2 "
        f"{stats['demb_l2_rel']:.3e}, outliers {stats['demb_outliers']:.3e}, "
        f"worst {stats['demb_max_rel']:.3e}"
        + ("" if rob_rel is None else
           f"; rob's error over its magnitude {rob_rel:.3e} (tol {ROB_TOL})"))
    if not stats["ok"] or launches != pieces:
        raise AssertionError(f"{name} in pieces disagrees with its plain "
                             f"version or launched {launches} times for "
                             f"{pieces} pieces: {stats}")
    again = pieced(fn)
    if not all(torch.equal(a, b) for a, b in zip(flat(got), flat(again))):
        raise AssertionError(f"{name} in pieces is not deterministic")
    del again
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    pieced(fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    ms = cuda_time_ms(lambda: pieced(fn), 3, warmup=1)
    dev_ms = device_ms(lambda: pieced(fn), 3)
    plain_ms = cuda_time_ms(reference, 1, warmup=0)
    bound_ms, bound_by = roofline(2.0 * macs * n, tensor_bytes(
        *inputs, *cots, *flat(got), *weights))
    log(f"{name} n={n} in pieces: {ms:.4f} ms (device {dev_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.3f} of it; peak device memory above the inputs "
        f"{peak} B")
    return dict(points=n, pieces=pieces, launches=launches,
                max_abs_err=stats["grad_max_rel"], ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, peak_bytes=peak)


def family_bwd_in_pieces(fam, model, device):
    """The family's backward at PIECE_SIZES, in pieces."""
    mw = fam.weights(model.fine, device)
    out = []
    for n in PIECE_SIZES:
        inputs, gen = fam.inputs(n, device, SEED + n + 2)
        draw = torch.randn((n, 8), generator=gen, device=device)
        out.append(check_bwd_in_pieces(
            f"{fam.bwd_name} ({fam.what})", fam.bwd, fam.bwd_plain,
            fam.KB.bwd_agreement, inputs, mw, (draw,), fam.bwd_macs, device))
        del inputs, draw
    return out


def fused_bwd_in_pieces(model, device):
    """`bend_bwd` and `fused_bwd` at PIECE_SIZES and PIECE_SIZE_RENDER, in
    pieces: ([bend_bwd's], [fused_bwd's])."""
    from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
    from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
    w = fused_weights(model, device, "fine")
    bend, fused = [], []
    for n in PIECE_SIZES + (PIECE_SIZE_RENDER,):
        pts, lat, gen = fused_inputs(model, n, device, SEED + n + 2)

        def randn(cols, scale=1.0):
            return scale * torch.randn((n, cols), generator=gen, device=device)

        bend.append(check_bwd_in_pieces(
            "bend_bwd", BB.bend_bwd, BB.bend_bwd_plain, BB.bend_bwd_agreement,
            (pts, lat), w[:18], (randn(64, 0.1), randn(3), randn(1)),
            BB.BEND_BWD_MACS_PER_POINT, device))
        fused.append(check_bwd_in_pieces(
            "fused_bwd", FB.fused_bwd, FB.fused_bwd_plain,
            FB.fused_bwd_agreement, (pts, lat), w,
            (randn(8), randn(3), randn(1)), FB.FUSED_BWD_MACS_PER_POINT,
            device))
        del pts, lat
    return bend, fused


def big_step_phase(device, smi):
    """The flagship's training step at N_rand 4096 on one GPU (phase 4's
    setup otherwise): 262,144 coarse and 524,288 fine points a step, so the
    fine pass's backward runs in two pieces; launch counts set to 0 just
    before the timed steps and read just after; finite losses; steps/s and
    the peak device memory of a step."""
    from nonrigid_nerf_torch.engine.train_step import (make_train_step,
                                                       step_generator)
    cfg, tc, rs, ds, state = dp_setup(device)
    tc = dataclasses.replace(tc, N_rand=BIG_N_RAND)
    step_fn = make_train_step(cfg, tc, rs, ds.has_test_split)
    step_fn(state, ds, step_generator(tc.seed, 0, device))      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(step_fn(state, ds, step_generator(tc.seed, i, device))
                    ["loss"]) for i in range(1, BIG_STEPS + 1)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    counts = {k: v for k, v in launch_counts().items() if v}
    # a cotangent a network and phase (a test split: two): the coarse pass
    # in one launch, the fine pass in two
    per_backward = {"coarse": 1, "fine": 2}
    want = {"mlp_fwd": 2 * BIG_STEPS,
            "mlp_bwd": 2 * sum(per_backward.values()) * BIG_STEPS}
    log(f"step at N_rand {BIG_N_RAND} (one GPU): losses "
        + ", ".join(f"{v:.5f}" for v in losses)
        + f"; {BIG_STEPS / seconds:.2f} steps/s, "
        f"{BIG_STEPS * BIG_N_RAND / seconds:.0f} rays/s; launches {counts} "
        f"(expected {want}: mlp_bwd 1 + 2 a cotangent, two cotangents); "
        f"peak device memory {peak} B ({peak / 2**30:.3f} GiB); {smi}")
    if counts != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError("the N_rand 4096 step did not run its backward "
                             "in pieces, or its losses are not finite")
    return {"n_rand": BIG_N_RAND, "steps": BIG_STEPS, "losses": losses,
            "steps_per_s": BIG_STEPS / seconds, "launches": counts,
            "mlp_bwd_launches_per_backward": per_backward,
            "peak_device_bytes": peak, "gpu": smi}


def bf16_share_beyond_ulp(got, want):
    """(share of entries not bit-equal, share off by more than one bf16 ulp
    of `want`, the largest error in ulps) of two tensors of one shape."""
    got, want = got.double().cpu(), want.double().cpu()
    mag = want.abs().clamp_min(float(np.finfo(np.float32).tiny))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (got - want).abs()
    return (float((got != want).double().mean()),
            float((err > ulp).double().mean()), float((err / ulp).max()))


def bf16_stage1_check(cfg, device):
    """The bender and the rigidity network at compute_dtype="bfloat16" on
    the card against the CPU's `dense_apply` (held bitwise against JAX's by
    tests/test_torch_bf16.py) on the same weights and STAGE1_POINTS points:
    the flagship's bender with every bias drawn at random (the hidden
    layers' start at 0, and a rounding before the bias is only visible on
    a nonzero bias), its offsets and mask within STAGE1_ULP_SHARE /
    STAGE1_UNEQUAL. The planted fault, the same layers rounding their
    product to bf16 before the bias (a bf16-output product), must fail."""
    import copy

    from nonrigid_nerf_torch.models import bending as MB
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("bf16 stage 1 needs TF32 off")
    gen = torch.Generator().manual_seed(SEED + 16)
    bender = copy.deepcopy(flagship_model(cfg, "cpu").bender)
    with torch.no_grad():
        for layer in (*bender.bend, *bender.rigidity):
            if layer.bias is not None:
                bound = layer.in_features ** -0.5
                layer.bias.copy_(bound * (2 * torch.rand(
                    layer.bias.shape, generator=gen) - 1))
    pts = 2 * torch.rand((STAGE1_POINTS, 3), generator=gen) - 1
    lat = 0.1 * torch.randn((STAGE1_POINTS, cfg.ray_bending_latent_size),
                            generator=gen)
    on_card = copy.deepcopy(bender).to(device)

    def stage1(net, where):
        with torch.no_grad():
            _, det = net(pts.to(where), lat.to(where),
                         compute_dtype=torch.bfloat16)
        return det["unmasked_offsets"], det["rigidity_mask"]

    want = stage1(bender, "cpu")
    got = stage1(on_card, device)
    stats = {k: bf16_share_beyond_ulp(g, w)
             for k, g, w in zip(("offsets", "mask"), got, want)}

    def before_bias(layer, x, compute_dtype=torch.float32):
        y = torch.nn.functional.linear(x.to(compute_dtype),
                                       layer.weight.to(compute_dtype))
        return y if layer.bias is None else y + layer.bias.to(compute_dtype)

    orig = MB.dense_apply
    MB.dense_apply = before_bias
    try:
        fault = stage1(on_card, device)
    finally:
        MB.dense_apply = orig
    fault_stats = {k: bf16_share_beyond_ulp(g, w)
                   for k, g, w in zip(("offsets", "mask"), fault, want)}

    def passes(st):
        return all(u <= STAGE1_UNEQUAL and b <= STAGE1_ULP_SHARE
                   for u, b, _ in st.values())

    def fmt(st):
        return "; ".join(f"{k} unequal {u:.3e}, beyond one ulp {b:.3e}, "
                         f"worst {w:.1f} ulp" for k, (u, b, w) in st.items())
    log(f"bf16 stage 1 on the card against the CPU ({STAGE1_POINTS} points, "
        f"random biases): {fmt(stats)} (need <= {STAGE1_UNEQUAL:.0e} "
        f"unequal, <= {STAGE1_ULP_SHARE:.0e} beyond one ulp); planted fault "
        f"(rounded before the bias): {fmt(fault_stats)}")
    if not passes(stats):
        raise AssertionError("the bf16 stage 1 on the card is not the CPU's "
                             "dense_apply")
    if passes(fault_stats):
        raise AssertionError("the bf16 stage-1 check passes a rounding "
                             "before the bias")
    return {"points": STAGE1_POINTS, "vs_cpu": stats,
            "planted_fault": fault_stats}


def bf16_render(fam, cfg, args, device, off_frames, min_psnr, model=None):
    """`cfg` at compute_dtype="bfloat16": frames through `render_path`,
    launch counts set to 0 just before and read just after (the family's
    forward kernel, 12 a frame, no other), PSNR against the f32 "off"
    frames of the same parameters; with a bender, PSNR against the f32
    frames of the same kernels at most MAX_PSNR_BF16_DB (bf16 changed
    something). The baseline has no bender and its kernel ignores
    compute_dtype (as JAX's does), so its bf16 frames are its f32 ones."""
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.config import render_settings_from_args
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = flagship_model(cfg, device) if model is None else model
    poses, intrinsics = synthetic_poses()
    rs = render_settings_from_args(args, near=0.1, far=1.6)
    latents = model.latents.detach().cpu().numpy()
    with torch.no_grad():                 # warm-up
        render_path(model, cfg16, rs, poses[:1], intrinsics[:1], latents[:1],
                    chunk=CHUNK, render_factor=8, verbose=False, device=device)
    torch.cuda.synchronize()
    what = f"{fam.what}, fused_kernel={cfg.fused_kernel}, bfloat16"
    reset_launch_counts()
    rgbs, _, frame_s = render_frames(model, cfg16, rs, poses, intrinsics,
                                     latents, device, what)
    counts = {k: v for k, v in launch_counts().items() if v}
    name = fam.fwd_name if cfg.fused_kernel != "int8" else "mlp_i8"
    want = {name: FRAMES * -(-H * W // CHUNK) * 2}
    frame_psnr = [psnr(a, b) for a, b in zip(rgbs, off_frames)]
    rgbs32, _, _ = render_frames(model, cfg, rs, poses, intrinsics, latents,
                                 device, f"{what} -> float32")
    same_psnr = [psnr(a, b) for a, b in zip(rgbs, rgbs32)]
    bent = cfg.ray_bending is not None
    log(f"bf16 render ({what}): launches {counts} (expected {want}); PSNR "
        f"against the f32 off frames " + ", ".join(f"{p:.2f}" for p in
                                                    frame_psnr)
        + f" dB (need >= {min_psnr}); against the f32 frames of the same "
        "kernels " + ", ".join(f"{p:.2f}" for p in same_psnr) + " dB"
        + (f" (need <= {MAX_PSNR_BF16_DB})" if bent else
           " (no bender: the same function)"))
    if counts != want or not np.isfinite(rgbs).all() \
            or min(frame_psnr) < min_psnr:
        raise AssertionError(f"the bf16 render ({what}) ran other kernels or "
                             "disagrees with the f32 frames")
    if bent and max(same_psnr) > MAX_PSNR_BF16_DB:
        raise AssertionError(f"the bf16 render ({what}) is the f32 render")
    return {"what": what, "launches": counts, "psnr_vs_f32_off_db": frame_psnr,
            "psnr_vs_f32_same_kernels_db": same_psnr,
            "s_per_frame": float(np.mean(frame_s)),
            "s_per_frame_median": float(np.median(frame_s))}, \
        (model, cfg16, rs, poses, intrinsics, latents)


def bf16_train(fam, cfg, args, device, steps):
    """`cfg` at compute_dtype="bfloat16": `steps` training steps on the
    synthetic stack, launch counts set to 0 just before and read just after
    (2 forward and 4 backward launches a step), finite values, a falling
    loss; a profile of PROFILE_STEPS steps (cuBLAS's device ms)."""
    from nonrigid_nerf_torch.apps.train import step_generator, train
    from nonrigid_nerf_torch.config import (render_settings_from_args,
                                            train_config_from_args)
    from nonrigid_nerf_torch.engine.train_step import make_train_step
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    ds = synthetic_dataset(device)
    args.seed = SEED
    tc = train_config_from_args(args)
    rs = render_settings_from_args(args, ds.near, ds.far)
    with tempfile.TemporaryDirectory() as logdir:
        reset_launch_counts()
        t0 = time.perf_counter()
        state = train(cfg16, tc, rs, ds, logdir, device=device,
                      i_print=TRAIN_PRINT, i_weights=steps, max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [row for row in map(json.loads, f) if "loss" in row]
    counts = {k: v for k, v in launch_counts().items() if v}
    want = {fam.fwd_name: 2 * steps, fam.bwd_name: 4 * steps}
    first, last = rows[0], rows[-1]
    rates = [r["it_per_sec"] for r in rows[1:]]
    steps_per_s = TRAIN_PRINT * len(rates) / sum(TRAIN_PRINT / r for r in rates)
    log(f"bf16 train ({fam.what}): {steps} steps in {wall:.2f} s, "
        f"{steps_per_s:.2f} steps/s after the first {TRAIN_PRINT}; launches "
        f"{counts} (expected {want}); loss {first['loss']:.5f} -> "
        f"{last['loss']:.5f}, psnr {first['psnr']:.2f} -> {last['psnr']:.2f}")
    finite = all(math.isfinite(v) for r in rows for v in r.values()) and all(
        bool(torch.isfinite(p).all()) for p in state.model.parameters())
    if counts != want or not finite or not last["loss"] < first["loss"]:
        raise AssertionError(f"bf16 training ({fam.what}) launched other "
                             "kernels, is not finite or did not learn")
    step_fn = make_train_step(cfg16, tc, rs, ds.has_test_split)

    def few_steps():
        for _ in range(PROFILE_STEPS):
            step_fn(state, ds, step_generator(tc.seed, state.step, device))

    prof = profile_run(few_steps, f"{PROFILE_STEPS} training steps "
                       f"({fam.what}, bfloat16)")
    return {"what": fam.what, "steps": steps, "launches": counts,
            "loss_first": first["loss"], "loss_last": last["loss"],
            "psnr_last": last["psnr"], "steps_per_s": steps_per_s,
            "device_ms_per_step": prof["device_busy_ms"] / PROFILE_STEPS,
            "gemm_ms_per_step": prof["gemm_ms"] / PROFILE_STEPS,
            "idle_share": prof["idle_share"]}


def bf16_phase(families, cfg_plain, args, off_frames, f32_profiles, device,
               smi):
    """compute_dtype="bfloat16" through the normal entry points: F, V, P
    and B render (each family's kernels, 12 launches a frame) and I renders
    after a calibration at bf16, each against the f32 "off" frames of its
    parameters from phase 3; a profile of an F frame and of F's steps
    (cuBLAS's device ms against phase 3's and 4's f32 profiles); F and B
    train BF16_STEPS steps."""
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ
    from nonrigid_nerf_torch.ops.rays import get_rays
    renders, trains = [], []
    stage1 = bf16_stage1_check(cfg_plain, device)
    for fam, cfg, _, fam_args in families:
        off = off_frames["plain" if fam.kind == "pts" else fam.kind]
        result, ctx = bf16_render(fam, cfg, fam_args, device, off,
                                  MIN_PSNR_BF16_DB)
        if fam.kind == "plain":
            model, cfg16, rs, poses, intrinsics, latents = ctx
            prof = profile_run(lambda: render_path(
                model, cfg16, rs, poses[:1], intrinsics[:1], latents[:1],
                chunk=CHUNK, verbose=False, device=device),
                "one frame (mlp_fwd, bfloat16)")
            result["profile"] = prof
            log(f"bf16 F frame: cuBLAS {prof['gemm_ms']:.2f} ms of "
                f"{prof['device_busy_ms']:.2f} device ms (f32, this run: "
                f"{f32_profiles['frame']['gemm_ms']:.2f} of "
                f"{f32_profiles['frame']['device_busy_ms']:.2f}); {smi}")
            # I: calibrated at bf16 on the first pose's rays, as phase 3
            rays_o, rays_d = get_rays(torch.as_tensor(poses[0], device=device),
                                      intrinsics[0])
            model_q = KQ.quantize_for_inference(
                model, cfg16, rays_o, rays_d,
                model.latents[:1].detach().expand(H * W, -1), rs.near, rs.far)
            cfg_i8 = dataclasses.replace(cfg, fused_kernel="int8")
            result_i8, _ = bf16_render(fam, cfg_i8, fam_args, device, off,
                                       MIN_PSNR_INT8_DB, model=model_q)
            renders.append(result_i8)
            del model_q, model
        renders.append(result)
        if fam.kind in ("plain", "baseline"):
            trains.append(bf16_train(fam, cfg, fam_args, device, BF16_STEPS))
    f_train = trains[0]
    log(f"bf16 F step: cuBLAS {f_train['gemm_ms_per_step']:.2f} ms of "
        f"{f_train['device_ms_per_step']:.2f} device ms a step (f32, this "
        f"run: {f32_profiles['step']['gemm_ms'] / PROFILE_STEPS:.2f} of "
        f"{f32_profiles['step']['device_busy_ms'] / PROFILE_STEPS:.2f}); "
        f"{smi}")
    return {"stage1_vs_cpu": stage1, "render": renders, "train": trains,
            "gpu": smi}


def serving_phase(cfg, args, device, smi, tmp):
    """The serving export (`serving.py`) of the flagship's renderer on cuda
    at SERVE_CHUNK rays a block: saved, loaded, bit-equal to the live "off"
    render of the same block; loaded again in a child process that imports
    torch alone (outside the checkout), bit-equal there too; the export's
    seconds, the artifact's bytes, ms a block."""
    from nonrigid_nerf_torch import serving
    from nonrigid_nerf_torch.config import render_settings_from_args
    from nonrigid_nerf_torch.ops.rays import get_rays
    model = flagship_model(cfg, device)
    rs = render_settings_from_args(args, near=0.1, far=1.6)
    t0 = time.perf_counter()
    blob, meta = serving.export_renderer(model, cfg, rs, chunk=SERVE_CHUNK,
                                         device=device)
    export_s = time.perf_counter() - t0
    folder = os.path.join(tmp, "serving")
    os.makedirs(folder)
    path = os.path.join(folder, "flagship.pt2")
    serving.save_exported(path, blob, meta)
    poses, intrinsics = synthetic_poses()
    rays_o, rays_d = get_rays(torch.as_tensor(poses[0], device=device),
                              intrinsics[0])
    ro = rays_o.reshape(-1, 3)[:SERVE_CHUNK].contiguous()
    rd = rays_d.reshape(-1, 3)[:SERVE_CHUNK].contiguous()
    lat = model.latents.detach()[:1].expand(SERVE_CHUNK, -1).contiguous()
    live_fn = serving.make_serving_fn(model, cfg, rs)
    render, meta = serving.load_exported(path)
    reset_launch_counts()
    live, got = live_fn(ro, rd, lat), render(ro, rd, lat)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    equal = all(torch.equal(got[k], live[k]) for k in live)
    torch.save({"rays_o": ro.cpu(), "rays_d": rd.cpu(), "latents": lat.cpu()},
               os.path.join(folder, "block.pt"))
    code = ("import sys, torch\n"
            "ep = torch.export.load('flagship.pt2')\n"
            "b = torch.load('block.pt')\n"
            "with torch.no_grad():\n"
            "    out = ep.module()(*(b[k].cuda() for k in "
            "('rays_o', 'rays_d', 'latents')))\n"
            "bad = [m for m in sys.modules if m.startswith('nonrigid_nerf')]\n"
            "assert not bad, bad\n"
            "torch.save({k: v.cpu() for k, v in out.items()}, 'out.pt')\n")
    child = subprocess.run([sys.executable, "-c", code], cwd=folder,
                           capture_output=True, text=True, timeout=300,
                           env={"PATH": os.environ.get("PATH", ""),
                                "HOME": folder})
    child_out = torch.load(os.path.join(folder, "out.pt")) \
        if child.returncode == 0 else {}
    child_equal = child.returncode == 0 and all(
        torch.equal(child_out[k], live[k].cpu()) for k in live)
    ms = cuda_time_ms(lambda: render(ro, rd, lat), 5)
    live_ms = cuda_time_ms(lambda: live_fn(ro, rd, lat), 5)
    log(f"serving: export {export_s:.2f} s, artifact {len(blob)} B, "
        f"{ms:.2f} ms a block of {SERVE_CHUNK} rays (the live off renderer "
        f"{live_ms:.2f} ms); bit-equal to the live render: {equal}; in a "
        f"child process that imports torch alone: {child_equal}; kernel "
        f"launches {launches} (expected none); {smi}")
    if not (equal and child_equal) or launches:
        raise AssertionError(f"the serving artifact differs from the live "
                             f"render or ran a kernel: {child.stderr[-2000:]}")
    return {"export_s": export_s, "bytes": len(blob), "chunk": SERVE_CHUNK,
            "ms_per_block": ms, "live_ms_per_block": live_ms,
            "bit_equal": True, "child_bit_equal": True, "gpu": smi}


def presample_phase(root, smi, tmp):
    """The training CLI on data_r5/occlusion for PREFETCH_STEPS steps, in
    this process, at --sampling_prefetch 0 and PREFETCH: metrics.jsonl
    (every step) and the final parameters and Adam moments bit-equal; the
    presampled run's ray batches made once a window (counted at
    `sample_ray_batch`)."""
    from nonrigid_nerf_torch.checkpoints import read_checkpoint
    from nonrigid_nerf_torch.cli import train as cli
    from nonrigid_nerf_torch.engine import train_step
    real = train_step.sample_ray_batch
    batches = {}
    out = {}
    for name, value in (("plain", 0), ("presampled", PREFETCH)):
        calls = []
        train_step.sample_ray_batch = lambda *a, **k: (
            calls.append(a[1]), real(*a, **k))[1]
        t0 = time.perf_counter()
        try:
            cli.main(cli_argv(root, os.path.join(tmp, name), "--N_iters",
                              str(PREFETCH_STEPS), "--i_print", "1",
                              "--i_img", "0", "--i_weights",
                              str(PREFETCH_STEPS), "--sampling_prefetch",
                              str(value)))
        finally:
            train_step.sample_ray_batch = real
        wall = time.perf_counter() - t0
        logdir = os.path.join(tmp, name, "occlusion_cli", "logs")
        rows = [{k: v for k, v in r.items() if k != "it_per_sec"}
                for r in cli_rows(logdir) if "loss" in r]
        state = read_checkpoint(os.path.join(logdir, "latest.npz"),
                                with_opt_state=True)
        batches[name] = calls
        out[name] = (rows, state, wall)
    equal_rows = out["plain"][0] == out["presampled"][0]
    (step_a, params_a, _, opt_a), (step_b, params_b, _, opt_b) = (
        out["plain"][1], out["presampled"][1])
    equal_state = step_a == step_b == PREFETCH_STEPS and same_tree(
        params_a, params_b) and same_tree(opt_a, opt_b)
    windows = -(-PREFETCH_STEPS // PREFETCH)
    log(f"presampled CLI: {PREFETCH_STEPS} steps at --sampling_prefetch "
        f"{PREFETCH}: {len(batches['presampled'])} batch draws of "
        f"{sorted(set(batches['presampled']))} rays (expected {windows}), "
        f"plain {len(batches['plain'])}; metrics.jsonl bit-equal at every "
        f"step: {equal_rows}; parameters and Adam moments bit-equal: "
        f"{equal_state}; wall {out['plain'][2]:.2f} s plain, "
        f"{out['presampled'][2]:.2f} s presampled; {smi}")
    if not (equal_rows and equal_state) or len(batches["presampled"]) \
            != windows or len(batches["plain"]) != PREFETCH_STEPS:
        raise AssertionError("the presampled CLI run differs from the plain "
                             "one, or did not presample once a window")
    return {"steps": PREFETCH_STEPS, "sampling_prefetch": PREFETCH,
            "windows": windows, "bit_equal": True,
            "wall_s_plain": out["plain"][2],
            "wall_s_presampled": out["presampled"][2], "gpu": smi}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "nonrigid_nerf_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(nonrigid_nerf_torch/ is missing beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    if sys.argv[1:] == ["--splits"]:
        return backward_splits_child(root)
    from nonrigid_nerf_torch.config import load_args, model_config_from_args
    from nonrigid_nerf_torch.ops.kernels import build

    # f32 products stay full f32 (the "off" reference), never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = gpu_name_and_power_limit()
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t_start = time.perf_counter()

    # ---- phase 1: build, one nvcc per source, side by side
    sources = ("mlp_fwd.cu", "mlp_bwd.cu", "mlpv_fwd.cu", "mlpv_bwd.cu",
               "mlpe_fwd.cu", "mlpe_bwd.cu", "mlp_i8.cu", "bend_fwd.cu",
               "bend_bwd.cu", "fused_fwd.cu", "fused_bwd.cu")
    t0 = time.perf_counter()
    build.load_kernel_libraries(sources)
    log(f"build {', '.join(sources)}: {time.perf_counter() - t0:.2f} s in all")
    for source in sources:
        info = build.BUILD_INFO[source]
        log(f"build {source}: nvcc {info['seconds']:.2f} s, {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                log("  ptxas:", line.strip())
        if "C751" in info["log"]:   # C7510-C7512: wgmma serialized
            raise AssertionError(f"ptxas serialized the wgmma of {source}")

    args = load_args(os.path.join(root, "configs", "example_sequence.txt"))
    cfg_plain = model_config_from_args(args)
    if cfg_plain.fused_kernel != "auto" or cfg_plain.netwidth != 256 \
            or cfg_plain.use_viewdirs or not cfg_plain.approx_nonrigid_viewdirs:
        raise AssertionError(f"unexpected flagship config {cfg_plain}")
    cfg_views = dataclasses.replace(cfg_plain, use_viewdirs=True)
    if cfg_views.multires_views != 4 or cfg_views.input_ch_views != 27:
        raise AssertionError(f"unexpected view encoding {cfg_views}")
    cfg_pts = dataclasses.replace(cfg_plain, fused_kernel="pts")
    # the time-conditioned baseline as its run had it: the flagship's widths,
    # no bender, the latent in the MLP's input, no regularizers
    args_tc = load_args(os.path.join(root, "results", "r4_baseline_tc",
                                     "args.txt"))
    cfg_tc = model_config_from_args(args_tc)
    if cfg_tc != dataclasses.replace(cfg_plain, ray_bending=None,
                                     time_conditioned_baseline=True) \
            or cfg_tc.input_ch + cfg_tc.ray_bending_latent_size != 95:
        raise AssertionError(f"unexpected baseline config {cfg_tc}")
    families = [(Family("plain"), cfg_plain, TRAIN_STEPS, args),
                (Family("viewdirs"), cfg_views, TRAIN_STEPS_VIEWDIRS, args),
                (Family("pts"), cfg_pts, TRAIN_STEPS_PTS, args),
                (Family("baseline"), cfg_tc, TRAIN_STEPS_BASELINE, args_tc)]
    n_coarse = CHUNK * cfg_plain.N_samples
    n_fine = CHUNK * (cfg_plain.N_samples + cfg_plain.N_importance)
    n_bwd_coarse = args.N_rand * cfg_plain.N_samples
    n_bwd_fine = args.N_rand * (cfg_plain.N_samples + cfg_plain.N_importance)
    sizes = (n_coarse, n_fine, n_bwd_coarse, n_bwd_fine)

    rows, renders, trains = [], [], []
    off_frames_plain = None
    off_frames_by_kind = {}
    for fam, cfg, steps, fam_args in families:
        # ---- phase 2: kernel vs plain at the render and training shapes
        model = flagship_model(cfg, device)
        with torch.no_grad():   # the plain versions must not record a graph
            fwd_checks = [check_fwd(fam, model, n_coarse, device),
                          check_fwd(fam, model, n_fine, device),
                          check_fwd(fam, model, n_bwd_coarse, device),
                          check_fwd(fam, model, n_bwd_fine, device, "fine")]
            bwd_checks = [check_bwd(fam, model, n_bwd_coarse, device),
                          check_bwd(fam, model, n_bwd_fine, device)]
            # past one launch: the autograd function's pieces
            piece_checks = family_bwd_in_pieces(fam, model, device)
        del model
        # ---- phase 3: render through render_path, kernel vs off ("pts"
        # against the first family's "off" frames: the same parameters)
        render, render_launches, off_frames = render_phase(
            fam, cfg, fam_args, device, smi,
            (fwd_checks[0]["ms"], fwd_checks[1]["ms"]),
            off_frames_plain if fam.kind == "pts" else None)
        if fam.kind == "plain":
            off_frames_plain = off_frames
        off_frames_by_kind[fam.kind] = off_frames
        # ---- phase 4: training
        train_results, train_counts = train_phase(fam, fam_args, cfg, device,
                                                  smi, steps)
        renders.append(render)
        trains.append(train_results)
        fam_rows = kernel_rows(fam, sizes, fwd_checks, bwd_checks,
                               render_launches, train_counts)
        fam_rows[1]["split_ms_per_launch"] = train_results["bwd_split_ms_per_launch"]
        fam_rows[1]["other_sizes"] = piece_checks
        if fam.kind == "baseline":
            add_width_rows(rows[:2], fam_rows)
        else:
            rows += fam_rows
        log(f"family done ({fam.what}): "
            f"{time.perf_counter() - t_start:.1f} s since the start")

    # ---- phase 4b: a step at N_rand 4096 on one GPU (the fine pass's
    # backward in two pieces)
    big_step = big_step_phase(device, smi)
    # ---- phase 4c: compute_dtype="bfloat16": renders of F, V, P, B and I,
    # F and B trained
    bf16_results = bf16_phase(
        families, cfg_plain, args, off_frames_by_kind,
        {"frame": renders[0]["profile"], "step": trains[0]["profile"]},
        device, smi)
    log(f"big step and bf16 done: {time.perf_counter() - t_start:.1f} s "
        "since the start")

    # ---- phase 5: the training CLI on a real dataset
    with tempfile.TemporaryDirectory() as tmp:
        cli_results, cli_exp = cli_phase(root, smi, tmp)
        log(f"cli done: {time.perf_counter() - t_start:.1f} s since the start")
        # ---- phase 5b: the presampled step through the CLI
        presample_results = presample_phase(root, smi, tmp)
        # ---- phase 6: free-viewpoint rendering of the CLI's run A
        fvr_results = fvr_phase(cli_exp, smi)
        # ---- phase 6b: the serving export
        serving_results = serving_phase(cfg_plain, args, device, smi, tmp)
    log(f"fvr done: {time.perf_counter() - t_start:.1f} s since the start")
    # ---- phase 7: the trained r3_eval checkpoint, every mode against off
    trained_results = trained_weights_phase(root, device, smi)
    log(f"trained weights done: {time.perf_counter() - t_start:.1f} s since "
        "the start")
    # ---- phase 8: the data-parallel step over ranks
    dp_results = dp_phase(device, smi)
    log(f"data parallel done: {time.perf_counter() - t_start:.1f} s since "
        "the start")

    # ---- fused_kernel="int8": phases 2 and 3 (it does not train)
    fam_plain = families[0][0]
    model = flagship_model(cfg_plain, device)
    with torch.no_grad():
        i8_checks = [check_i8(fam_plain, model, n_coarse, device),
                     check_i8(fam_plain, model, n_fine, device, "fine")]
    del model
    render_i8, i8_launches = int8_render_phase(
        cfg_plain, args, device, smi, (i8_checks[0]["ms"], i8_checks[1]["ms"]),
        off_frames_plain)
    renders.append(render_i8)
    rows.append(int8_row(sizes, i8_checks, i8_launches))
    log(f"int8 done: {time.perf_counter() - t_start:.1f} s since the start")

    # ---- the fused point query: its four kernels and both entry points
    fused_rows, fused_vs_engine = fused_query_phase(
        cfg_plain, device, smi, (n_coarse, n_bwd_coarse, n_bwd_fine))
    rows += fused_rows
    log(f"fused point query done: {time.perf_counter() - t_start:.1f} s since "
        "the start")

    # the three modes of the flagship side by side, from this run
    by_mode = {r["fused_kernel"]: r for r in renders
               if not r["use_viewdirs"] and not r["time_conditioned_baseline"]}
    log("flagship frame, s/frame (mean; median): " + ", ".join(
        f"{mode} {by_mode[mode]['s_per_frame_kernel']:.4f}; "
        f"{by_mode[mode]['s_per_frame_median']:.4f}"
        for mode in ("auto", "pts", "int8"))
        + f", off {by_mode['auto']['s_per_frame_off']:.4f}; CatArrayBatchedCopy's "
        "share of a frame's device time: " + ", ".join(
            f"{mode} {by_mode[mode]['profile']['cat_share']:.3f}"
            for mode in ("auto", "pts", "int8")) + f"; {smi}")
    log("flagship training, steps/s: " + ", ".join(
        f"{'viewdirs' if t['use_viewdirs'] else t['fused_kernel']} "
        f"{t['steps_per_s']:.2f} (device "
        f"{t['profile']['device_busy_ms'] / PROFILE_STEPS:.2f} ms/step, idle "
        f"share {t['profile']['idle_share']:.3f})"
        for t in trains if not t["time_conditioned_baseline"]) + f"; {smi}")
    render_b = next(r for r in renders if r["time_conditioned_baseline"])
    train_b = next(t for t in trains if t["time_conditioned_baseline"])
    log(f"time-conditioned baseline: {render_b['s_per_frame_kernel']:.4f} s/frame "
        f"(off {render_b['s_per_frame_off']:.4f}), PSNR kernel vs off "
        f"{min(render_b['psnr_kernel_vs_off_db']):.2f} dB or more; "
        f"{train_b['steps_per_s']:.2f} steps/s (device "
        f"{train_b['profile']['device_busy_ms'] / PROFILE_STEPS:.2f} ms/step); "
        f"{smi}")
    if len(rows) != 11:
        raise AssertionError(f"{len(rows)} kernel rows, 11 kernels")
    # every row (all on csrc/mlp_sm90.cuh). Every size's line has the time,
    # the device time and the share of the bound; a backward's adds its
    # device time by kernel (rows 2, 4 and 6: a launch on average over a
    # training step's two sizes, the profile of 5 steps; rows 8 and 10: a
    # call at 65,536 points) and rows 2-6 and 10 their two-pass floor at
    # each size; rows 7-11 what ptxas reported in phase 1 of their kernels.
    by_name = {r["name"]: r for r in rows}
    ptxas_of = {"mlp_i8": ("mlp_i8.cu", "mlp_i8_kernel"),
                "fused_fwd": ("fused_fwd.cu", "mlp_fwd_kernel"),
                "fused_bwd": ("fused_bwd.cu", "mlp_bwd_chain_kernel"),
                "bend_fwd": ("bend_fwd.cu", "bend_fwd_sm90_kernel"),
                "bend_bwd": ("bend_bwd.cu", "bend_bwd_sm90_kernel")}
    for name in ("mlp_fwd", "mlp_bwd", "mlpv_fwd", "mlpv_bwd", "mlpe_fwd",
                 "mlpe_bwd", "bend_fwd", "bend_bwd", "fused_fwd", "fused_bwd",
                 "mlp_i8"):
        r = by_name[name]
        passes = [("", r)] + [(f"{k} ", r[k]) for k in
                              ("fine_pass", "train_pass", "train_fine_pass")
                              if k in r] + [("", p) for p in
                                            r.get("other_sizes", ())]
        if "lanes_128" in r:
            passes += [("128 lanes ", r["lanes_128"])] + [
                (f"128 lanes {k} ", r["lanes_128"][k]) for k in
                ("fine_pass", "train_pass", "train_fine_pass")
                if k in r["lanes_128"]]

        def detail(p):
            if "scratch_floor_ms" not in p:
                return ""
            return (f"; two-pass floor {p['scratch_floor_ms']:.4f} ms, "
                    f"{p['scratch_floor_ms'] / p['ms']:.3f} of the time")

        split = ""
        if "split_ms_per_launch" in r:
            over = (f"a call at {r['points']} points" if name in ("fused_bwd", "bend_bwd")
                    else "over a training step")
            split = f"; device ms a launch by kernel, {over}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["split_ms_per_launch"].items())
            if "lanes_128" in r:
                split += " (128 lanes: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in
                    r["lanes_128"]["split_ms_per_launch"].items()) + ")"
        if name in ptxas_of:
            split += "; " + ptxas_report(*ptxas_of[name])
        log(f"design check, {name}: " + "; ".join(
            f"{what}{p['points']} pts {p['ms']:.4f} ms (device "
            f"{p['device_ms']:.4f} ms), bound {p['bound_ms']:.4f} ms, "
            f"{p['bound_ms'] / p['ms']:.3f} of it" + detail(p)
            for what, p in passes) + split + f"; {smi}")

    # ---- results
    log(json.dumps({"render": renders}))
    log(json.dumps({"train": trains}))
    log(json.dumps({"fused_fwd_vs_engine": fused_vs_engine}))
    log(json.dumps({"cli": cli_results}))
    log(json.dumps({"fvr": fvr_results}))
    log(json.dumps({"trained_weights": trained_results}))
    log(json.dumps({"data_parallel": dp_results}))
    log(json.dumps({"big_step": big_step}))
    log(json.dumps({"bfloat16": bf16_results}))
    log(json.dumps({"serving": serving_results}))
    log(json.dumps({"presampled": presample_results}))
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
