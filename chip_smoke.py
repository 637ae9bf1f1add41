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
rays). Last, the fused point
query's two entry points, `fused_point_query` (`fused_fwd`, `fused_bwd`)
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
5. The fused point query: each of its four kernels against its plain
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
6. Print rows 1-6 and 11 (`mlp_fwd`, `mlp_bwd`, `mlpv_fwd`, `mlpv_bwd`,
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
"""

import copy
import dataclasses
import json
import math
import os
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
            rows = [json.loads(line) for line in f]
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
        for key in ("scratch_floor_ms", "split_ms_per_launch"):
            if key in head:
                rows[-1][key] = head[key]
    return rows, dict(engine_stage1_mlpe_ms=engine_ms, bender_f32_ms=bender_ms,
                      fused_fwd_ms=fused_ms, points=n_render, gpu=smi)


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
        del model
        # ---- phase 3: render through render_path, kernel vs off ("pts"
        # against the first family's "off" frames: the same parameters)
        render, render_launches, off_frames = render_phase(
            fam, cfg, fam_args, device, smi,
            (fwd_checks[0]["ms"], fwd_checks[1]["ms"]),
            off_frames_plain if fam.kind == "pts" else None)
        if fam.kind == "plain":
            off_frames_plain = off_frames
        # ---- phase 4: training
        train_results, train_counts = train_phase(fam, fam_args, cfg, device,
                                                  smi, steps)
        renders.append(render)
        trains.append(train_results)
        fam_rows = kernel_rows(fam, sizes, fwd_checks, bwd_checks,
                               render_launches, train_counts)
        fam_rows[1]["split_ms_per_launch"] = train_results["bwd_split_ms_per_launch"]
        if fam.kind == "baseline":
            add_width_rows(rows[:2], fam_rows)
        else:
            rows += fam_rows
        log(f"family done ({fam.what}): "
            f"{time.perf_counter() - t_start:.1f} s since the start")

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

    # ---- phase 5: results
    log(json.dumps({"render": renders}))
    log(json.dumps({"train": trains}))
    log(json.dumps({"fused_fwd_vs_engine": fused_vs_engine}))
    log(smi)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
