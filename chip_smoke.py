#!/usr/bin/env python3
"""Smoke run of nonrigid_nerf_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (each raises on failure; the exit code is then non-zero and no
result line is printed):

1. Print the card's name and power limit, build every CUDA kernel from the
   sources in this checkout (one nvcc per source, side by side), print the
   build times and what ptxas says of registers and spills.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, within the tolerance the CPU tests pin,
   and relaunch it to see bit-equal outputs; time kernel, plain version and
   a chain of bf16 torch.matmul calls (a yardstick only); compute the
   roofline bound. `mlp_fwd`: chunk x N_samples and chunk x (N_samples +
   N_importance) points of a render block, and N_rand x N_samples and
   N_rand x (N_samples + N_importance) points of a training step.
   `mlp_bwd`: the training step's two sizes.
3. Render frames at 384 x 512 with the flagship config
   (configs/example_sequence.txt) through `render_path`, parameters from a
   seed, with the launch counts set to 0 just before and read just after.
   Render the same frames with fused_kernel="off" (plain f32 MLP) and
   require a PSNR of at least 40 dB between the two; hold a block of rays
   rendered on the card against the same rays rendered on the CPU. Profile
   one frame: device time by kernel and the device's idle share.
4. Train the flagship configuration (1024 rays, 64 + 64 samples, all three
   regularizers, a test split) with `apps.train.train` on a synthetic image
   stack built in memory, launch counts set to 0 just before and read just
   after: 2 `mlp_fwd` and 4 `mlp_bwd` launches per step, everything finite,
   the loss lower at the end than at the start; steps and rays per second
   over all steps after the first window of 25.
   Then, from the trained state: one step's losses and gradients with the
   kernels against fused_kernel="off" on the same draws; a checkpoint saved,
   loaded and stepped once, bit-equal to the step without the round trip;
   a profile of a few steps.
5. Print the kernels JSON line and, last, the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import copy
import dataclasses
import json
import math
import os
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
PEAK_HBM_BYTES = 3.35e12
MIN_PSNR_DB = 40.0
TRAIN_FRAMES = 8                 # synthetic stack: 6 training + 2 test images
TRAIN_TEST_IDS = (3, 7)
TRAIN_STEPS = 300
TRAIN_PRINT = 25
PROFILE_STEPS = 5
# one training step with the kernels against fused_kernel="off" on the same
# draws: bf16 activations and cotangents against f32 ones. The JAX package's
# own test of this (tests/test_fused_kernel.py:132-155) allows 6% of each
# gradient's max magnitude.
STEP_LOSS_TOL_REL = 2e-2
STEP_GRAD_MIN_COSINE = 0.98


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
    rigidity output layers perturbed (a fresh model would never bend) and
    the density bias raised by 1 so random networks render non-empty
    frames."""
    from nonrigid_nerf_torch.models.model import NRNeRF
    gen = torch.Generator().manual_seed(SEED)
    model = NRNeRF(cfg, num_timesteps=frames, generator=gen, device="cpu")
    with torch.no_grad():
        model.bender.bend[-1].weight.copy_(
            0.05 * torch.randn(model.bender.bend[-1].weight.shape, generator=gen))
        model.bender.rigidity[-1].weight.copy_(
            0.3 * torch.randn(model.bender.rigidity[-1].weight.shape,
                              generator=gen))
        model.latents.copy_(0.1 * torch.randn(model.latents.shape,
                                              generator=gen))
        for net in (model.coarse, model.fine):
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


def check_mlp_fwd(model, n_points, device, network="coarse"):
    """mlp_fwd against mlp_fwd_plain at n_points, with timings."""
    from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
    mw = tuple(w.detach().to(device) for w in
               K.cast_mlp_weights(K.pack_mlp_weights(model.network(network))))
    gen = torch.Generator(device=device).manual_seed(SEED + n_points)
    emb = (torch.rand((n_points, K.EMB), generator=gen, device=device) * 2
           - 1).to(torch.bfloat16)
    emb[:, 63] = 0          # the pad lane of the 63-channel encoding
    out = K.mlp_fwd(emb, mw)
    ref = K.mlp_fwd_plain(emb, mw)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    log(f"mlp_fwd n={n_points}: max abs err {max_err:.3e} (tol "
        f"{K.BF16_TOL_MAX:.0e}), mean {mean_err:.3e} (tol "
        f"{K.BF16_TOL_MEAN:.0e}), max |ref| {ref.abs().max().item():.3f}")
    if not (torch.isfinite(out).all() and max_err <= K.BF16_TOL_MAX
            and mean_err <= K.BF16_TOL_MEAN):
        raise AssertionError("mlp_fwd disagrees with mlp_fwd_plain")
    if not torch.equal(out, K.mlp_fwd(emb, mw)):
        raise AssertionError("mlp_fwd is not deterministic")

    bf16 = torch.bfloat16

    def matmul_chain():   # the same MLP as cuBLAS bf16 products (yardstick)
        h = torch.relu(emb @ mw[0] + mw[1]).to(bf16)
        for i in (2, 4, 6, 8):
            h = torch.relu(h @ mw[i] + mw[i + 1]).to(bf16)
        h = torch.relu(h @ mw[11] + emb @ mw[10] + mw[12]).to(bf16)
        for i in (13, 15):
            h = torch.relu(h @ mw[i] + mw[i + 1]).to(bf16)
        return h.float() @ mw[17].float() + mw[18]

    ms = cuda_time_ms(lambda: K.mlp_fwd(emb, mw), 10)
    plain_ms = cuda_time_ms(lambda: K.mlp_fwd_plain(emb, mw), 3, warmup=1)
    chain_ms = cuda_time_ms(matmul_chain, 10)
    flops = 2.0 * K.MACS_PER_POINT * n_points
    nbytes = (emb.numel() * emb.element_size() + out.numel() * out.element_size()
              + sum(w.numel() * w.element_size() for w in mw))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    log(f"mlp_fwd n={n_points}: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"bf16 matmul chain {chain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'})")
    return dict(max_abs_err=max_err, mean_abs_err=mean_err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                matmul_chain_bf16_ms=chain_ms)


def check_mlp_bwd(model, n_points, device):
    """mlp_bwd against mlp_bwd_plain at n_points, with timings."""
    from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
    from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
    mw = tuple(w.detach().to(device) for w in
               K.cast_mlp_weights(K.pack_mlp_weights(model.fine)))
    gen = torch.Generator(device=device).manual_seed(SEED + n_points + 1)
    emb = (torch.rand((n_points, K.EMB), generator=gen, device=device) * 2
           - 1).to(torch.bfloat16)
    emb[:, 63] = 0          # the pad lane of the 63-channel encoding
    draw = torch.randn((n_points, K.OUT_PAD), generator=gen, device=device)
    got = KB.mlp_bwd(emb, mw, draw)
    ref = KB.mlp_bwd_plain(emb, mw, draw)
    torch.cuda.synchronize()
    stats = KB.bwd_agreement(got, ref)
    log(f"mlp_bwd n={n_points}: 19 gradients max err "
        f"{stats['grad_max_rel']:.3e} of max magnitude (tol "
        f"{KB.grad_max_tol(n_points):.0e}), L2 {stats['grad_l2_rel']:.3e} (tol "
        f"{KB.BWD_TOL_L2:.0e}); demb L2 {stats['demb_l2_rel']:.3e}, entries "
        f"off by over {KB.BWD_TOL_ENTRY:.0e} of max "
        f"{stats['demb_outliers']:.3e} (tol {KB.BWD_TOL_OUTLIERS:.0e}), worst "
        f"{stats['demb_max_rel']:.3e} (tol {KB.BWD_TOL_DEMB_MAX:.0e})")
    log("mlp_bwd max abs err of each array over its max magnitude: "
        + " ".join(f"{k}={v:.2e}" for k, v in stats["max_rel"].items()))
    if not stats["ok"]:
        raise AssertionError(f"mlp_bwd disagrees with mlp_bwd_plain: {stats}")
    again = KB.mlp_bwd(emb, mw, draw)
    if not (torch.equal(got[0], again[0])
            and all(torch.equal(a, b) for a, b in zip(got[1], again[1]))):
        raise AssertionError("mlp_bwd is not deterministic")

    bf16 = torch.bfloat16
    drawb = draw.to(bf16)

    def matmul_chain():   # the same backward as cuBLAS bf16 products (yardstick)
        acts = [emb, torch.relu(emb @ mw[0] + mw[1]).to(bf16)]
        for i in (2, 4, 6, 8):
            acts.append(torch.relu(acts[-1] @ mw[i] + mw[i + 1]).to(bf16))
        acts.append(torch.relu(acts[-1] @ mw[11] + emb @ mw[10] + mw[12]).to(bf16))
        for i in (13, 15):
            acts.append(torch.relu(acts[-1] @ mw[i] + mw[i + 1]).to(bf16))
        grads = [acts[8].t() @ drawb]
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
                return demb + nxt, grads
            dh = nxt * (acts[layer] > 0)

    ms = cuda_time_ms(lambda: KB.mlp_bwd(emb, mw, draw), 10)
    plain_ms = cuda_time_ms(lambda: KB.mlp_bwd_plain(emb, mw, draw), 3, warmup=1)
    chain_ms = cuda_time_ms(matmul_chain, 10)
    flops = 2.0 * KB.BWD_MACS_PER_POINT * n_points
    nbytes = (emb.numel() * emb.element_size()
              + draw.numel() * draw.element_size()
              + got[0].numel() * got[0].element_size()
              + sum(w.numel() * w.element_size() for w in mw)
              + sum(g.numel() * g.element_size() for g in got[1]))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    log(f"mlp_bwd n={n_points}: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"bf16 matmul chain {chain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'})")
    return dict(max_abs_err=stats["grad_max_rel"], agreement=stats, ms=ms,
                plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                matmul_chain_bf16_ms=chain_ms)


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
            "mlp_fwd_share": share("mlp_fwd_kernel"),
            "mlp_bwd_share": share("mlp_bwd_"),
            "top": [[e.key[:60], e.self_device_time_total / 1e3]
                    for e in top[:12]]}


def train_phase(args, cfg, device, smi):
    """Phase 4: train, compare with fused_kernel="off", round-trip a
    checkpoint, profile. Returns (results dict, launch counts)."""
    from nonrigid_nerf_torch.apps.train import step_generator, train
    from nonrigid_nerf_torch.checkpoints import (load_train_state,
                                                 save_checkpoint)
    from nonrigid_nerf_torch.config import (render_settings_from_args,
                                            train_config_from_args)
    from nonrigid_nerf_torch.data.dataset import sample_ray_batch
    from nonrigid_nerf_torch.engine.train_step import (losses_and_grads,
                                                       make_train_step)
    from nonrigid_nerf_torch.ops.kernels.mlp_bwd import mlp_bwd
    from nonrigid_nerf_torch.ops.kernels.mlp_fwd import mlp_fwd

    ds = synthetic_dataset(device)
    args.seed = SEED
    tc = train_config_from_args(args)
    rs = render_settings_from_args(args, ds.near, ds.far)
    if not (tc.N_rand == 1024 and rs.N_samples == 64 and rs.N_importance == 64
            and rs.perturb == 1.0 and rs.raw_noise_std == 1.0
            and tc.offsets_loss_weight == 60.0
            and tc.divergence_loss_weight == 3.0
            and tc.rigidity_loss_weight == 0.0005 and ds.has_test_split):
        raise AssertionError(f"unexpected flagship training setup {tc} {rs}")

    with tempfile.TemporaryDirectory() as logdir:
        mlp_fwd.launches = mlp_bwd.launches = 0
        t0 = time.perf_counter()
        state = train(cfg, tc, rs, ds, logdir, device=device,
                      i_print=TRAIN_PRINT, i_weights=TRAIN_STEPS,
                      max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"mlp_fwd": mlp_fwd.launches, "mlp_bwd": mlp_bwd.launches}
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if not os.path.exists(os.path.join(logdir, "latest.npz")):
            raise AssertionError("train() saved no checkpoint")
    log(f"train: {TRAIN_STEPS} steps in {wall:.2f} s (first step's warm-up "
        f"and the checkpoint included); launches {counts} (expected "
        f"{2 * TRAIN_STEPS} and {4 * TRAIN_STEPS})")
    if state.step != TRAIN_STEPS or counts != {"mlp_fwd": 2 * TRAIN_STEPS,
                                               "mlp_bwd": 4 * TRAIN_STEPS}:
        raise AssertionError("a training step must launch mlp_fwd twice and "
                             "mlp_bwd four times")
    for row in rows:
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"non-finite metrics {row}")
    for name, t in list(state.model.named_parameters()) + \
            list(state.mu.items()) + list(state.nu.items()):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite values in {name}")
    first, last = rows[0], rows[-1]
    log(f"train: loss {first['loss']:.5f} (steps 1-{TRAIN_PRINT} end) -> "
        f"{last['loss']:.5f} (step {last['step']}); img_loss "
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
    log(f"train: {steps_per_s:.2f} steps/s, {steps_per_s * tc.N_rand:.0f} "
        f"rays/s over steps {TRAIN_PRINT + 1}-{TRAIN_STEPS} ({timed_steps} "
        f"steps, all their time); windows of {TRAIN_PRINT} steps: median "
        f"{rates[len(rates) // 2]:.2f}, min {rates[0]:.2f}, max "
        f"{rates[-1]:.2f} steps/s; {smi}")

    # one step's losses and gradients: kernels against fused_kernel="off",
    # same state, same draws
    step_args = dict(tc=tc, rs=rs, has_test_split=True, n_rand=tc.N_rand)

    def one(cfg_x):
        gen = step_generator(tc.seed, state.step, device)
        batch = sample_ray_batch(ds, tc.N_rand, generator=gen)
        return losses_and_grads(state.model, state.step, batch, cfg=cfg_x,
                                generator=gen, **step_args)

    cfg_off = dataclasses.replace(cfg, fused_kernel="off")
    (loss_k, _, grads_k), (loss_o, _, grads_o) = one(cfg), one(cfg_off)
    loss_gap = (abs(loss_k.mean().item() - loss_o.mean().item())
                / abs(loss_o.mean().item()))
    cosines = {}
    for name in grads_k:
        a, b = grads_k[name].flatten().double(), grads_o[name].flatten().double()
        if a.norm().item() == 0.0 and b.norm().item() == 0.0:
            continue
        cosines[name] = (torch.dot(a, b) / (a.norm() * b.norm())).item()
    worst = min(cosines, key=cosines.get)
    log(f"step with kernels vs fused_kernel=off: mean loss {loss_k.mean().item():.6f} "
        f"vs {loss_o.mean().item():.6f} (gap {loss_gap:.3e}, tol "
        f"{STEP_LOSS_TOL_REL:.0e}); gradient cosine min {cosines[worst]:.5f} "
        f"({worst}) over {len(cosines)} parameters (need >= "
        f"{STEP_GRAD_MIN_COSINE})")
    if loss_gap > STEP_LOSS_TOL_REL or cosines[worst] < STEP_GRAD_MIN_COSINE:
        raise AssertionError("the kernel step disagrees with the f32 step")

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
    same = loaded.step == direct.step == TRAIN_STEPS + 1 and all(
        torch.equal(a, b) for a, b in zip(
            list(direct.model.parameters()) + list(direct.mu.values())
            + list(direct.nu.values()),
            list(loaded.model.parameters()) + list(loaded.mu.values())
            + list(loaded.nu.values())))
    log(f"checkpoint round trip, then one step: bit-equal = {same}")
    if not same:
        raise AssertionError("resume does not reproduce the next step")

    def few_steps():
        for _ in range(PROFILE_STEPS):
            step_fn(direct, ds, step_generator(tc.seed, direct.step, device))

    prof = profile_run(few_steps, f"{PROFILE_STEPS} training steps")
    log(f"training-step shares of device time (profiler): mlp_fwd "
        f"{prof['mlp_fwd_share']:.3f}, mlp_bwd {prof['mlp_bwd_share']:.3f}")
    return {"steps": TRAIN_STEPS, "n_rand": tc.N_rand,
            "frames": TRAIN_FRAMES, "height": H, "width": W,
            "wall_s": wall, "steps_per_s": steps_per_s,
            "rays_per_s": steps_per_s * tc.N_rand,
            "timed_steps": timed_steps,
            "window_steps_per_s_median": rates[len(rates) // 2],
            "window_steps_per_s_min": rates[0],
            "window_steps_per_s_max": rates[-1],
            "loss_first": first["loss"], "loss_last": last["loss"],
            "psnr_first": first["psnr"], "psnr_last": last["psnr"],
            "kernel_vs_off_loss_gap": loss_gap,
            "kernel_vs_off_min_grad_cosine": cosines[worst],
            "resume_bit_equal": same, "profile": prof, "gpu": smi}, counts


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


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
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.config import (load_args, model_config_from_args,
                                            render_settings_from_args)
    from nonrigid_nerf_torch.engine.render import make_ray_renderer
    from nonrigid_nerf_torch.ops.kernels import build
    from nonrigid_nerf_torch.ops.kernels.mlp_fwd import mlp_fwd
    from nonrigid_nerf_torch.ops.rays import get_rays

    # f32 products stay full f32 (the "off" reference), never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = gpu_name_and_power_limit()
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # ---- phase 1: build, one nvcc per source, side by side
    sources = ("mlp_fwd.cu", "mlp_bwd.cu")
    t0 = time.perf_counter()
    build.load_kernel_libraries(sources)
    log(f"build {', '.join(sources)}: {time.perf_counter() - t0:.2f} s in all")
    for source in sources:
        info = build.BUILD_INFO[source]
        log(f"build {source}: nvcc {info['seconds']:.2f} s, {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # ---- phase 2: kernel vs plain at the render and training paths' shapes
    args = load_args(os.path.join(root, "configs", "example_sequence.txt"))
    cfg = model_config_from_args(args)
    if cfg.fused_kernel != "auto" or cfg.netwidth != 256:
        raise AssertionError(f"unexpected flagship config {cfg}")
    model = flagship_model(cfg, device)
    n_coarse = CHUNK * cfg.N_samples
    n_fine = CHUNK * (cfg.N_samples + cfg.N_importance)
    n_bwd_coarse = args.N_rand * cfg.N_samples
    n_bwd_fine = args.N_rand * (cfg.N_samples + cfg.N_importance)
    with torch.no_grad():       # the plain versions must not record a graph
        coarse_k = check_mlp_fwd(model, n_coarse, device)
        fine_k = check_mlp_fwd(model, n_fine, device)
        train_coarse_k = check_mlp_fwd(model, n_bwd_coarse, device)
        train_fine_k = check_mlp_fwd(model, n_bwd_fine, device, "fine")
        coarse_b = check_mlp_bwd(model, n_bwd_coarse, device)
        fine_b = check_mlp_bwd(model, n_bwd_fine, device)

    # ---- phase 3: render through render_path, kernel vs off
    poses, intrinsics = synthetic_poses()
    rs = render_settings_from_args(args, near=0.1, far=1.6)
    latents = model.latents.detach().cpu().numpy()
    with torch.no_grad():                 # warm-up: cuBLAS, allocator
        render_path(model, cfg, rs, poses[:1], intrinsics[:1], latents[:1],
                    chunk=CHUNK, render_factor=8, verbose=False, device=device)
    torch.cuda.synchronize()

    mlp_fwd.launches = 0
    t0 = time.perf_counter()
    rgbs, disps = render_path(model, cfg, rs, poses, intrinsics, latents,
                              chunk=CHUNK, verbose=True, device=device)
    t_kernel = time.perf_counter() - t0
    launches = mlp_fwd.launches
    blocks = -(-H * W // CHUNK)
    log(f"render (fused_kernel=auto): {FRAMES} frames in {t_kernel:.3f} s, "
        f"{t_kernel / FRAMES:.4f} s/frame, mlp_fwd launches {launches} "
        f"(expected {FRAMES * blocks * 2})")
    if launches != FRAMES * blocks * 2:
        raise AssertionError("the render path did not run mlp_fwd once per "
                             "pass and block")
    if rgbs.shape != (FRAMES, H, W, 3) or disps.shape != (FRAMES, H, W):
        raise AssertionError(f"bad shapes {rgbs.shape} {disps.shape}")
    if not (np.isfinite(rgbs).all() and np.isfinite(disps).all()):
        raise AssertionError("non-finite pixels")
    if rgbs.min() < 0 or rgbs.max() > 1 or rgbs.std() < 1e-3:
        raise AssertionError(f"implausible frames: min {rgbs.min()} max "
                             f"{rgbs.max()} std {rgbs.std()}")
    kernel_s = (FRAMES * blocks * (coarse_k["ms"] + fine_k["ms"])) / 1e3
    log(f"mlp_fwd share of render time (from the isolated kernel timings): "
        f"{kernel_s / t_kernel:.3f}")

    cfg_off = dataclasses.replace(cfg, fused_kernel="off")
    t0 = time.perf_counter()
    rgbs_off, _ = render_path(model, cfg_off, rs, poses, intrinsics, latents,
                              chunk=CHUNK, verbose=True, device=device)
    t_off = time.perf_counter() - t0
    if mlp_fwd.launches != launches:
        raise AssertionError("fused_kernel=off launched mlp_fwd")
    frame_psnr = [psnr(rgbs[i], rgbs_off[i]) for i in range(FRAMES)]
    log(f"render (fused_kernel=off): {t_off / FRAMES:.4f} s/frame; PSNR "
        f"kernel vs off per frame {['%.2f' % p for p in frame_psnr]} dB "
        f"(need >= {MIN_PSNR_DB})")
    if min(frame_psnr) < MIN_PSNR_DB:
        raise AssertionError("kernel render disagrees with the f32 render")

    # the card against the CPU on a block of frame 0's rays (plain f32 path)
    rs_test = rs.test_mode()
    rays_o, rays_d = get_rays(torch.as_tensor(poses[0], device=device),
                              intrinsics[0])
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

    prof = profile_run(lambda: render_path(
        model, cfg, rs, poses[:1], intrinsics[:1], latents[:1], chunk=CHUNK,
        verbose=False, device=device), "one frame")
    log(f"mlp_fwd share of device time (profiler): {prof['mlp_fwd_share']:.3f}")

    # ---- phase 4: training
    del model
    train_results, train_counts = train_phase(args, cfg, device, smi)

    # ---- phase 5: results. Launches: the render path's and the training
    # path's, each counted from 0 over its own run. mlp_bwd's max_abs_err is
    # the largest of its 19 gradients' max abs errors, each over its array's
    # max magnitude (the arrays differ in scale by orders of magnitude);
    # "agreement" has every array's, demb's too
    bwd_row = {"name": "mlp_bwd", "route": "cuda",
               "source": "nonrigid_nerf_torch/ops/kernels/csrc/mlp_bwd.cu",
               "replaces": "nonrigid_nerf_tpu/ops/pallas/fused_query.py:842",
               "launches": train_counts["mlp_bwd"],
               "max_abs_err": max(coarse_b["max_abs_err"],
                                  fine_b["max_abs_err"]),
               "ms": coarse_b["ms"], "plain_ms": coarse_b["plain_ms"],
               "bound_ms": coarse_b["bound_ms"],
               "bound_by": coarse_b["bound_by"], "library_ms": None,
               "points": n_bwd_coarse,
               "matmul_chain_bf16_ms": coarse_b["matmul_chain_bf16_ms"],
               "agreement": coarse_b["agreement"],
               "fine_pass": {"points": n_bwd_fine, **fine_b}}
    row = {"name": "mlp_fwd", "route": "cuda",
           "source": "nonrigid_nerf_torch/ops/kernels/csrc/mlp_fwd.cu",
           "replaces": "nonrigid_nerf_tpu/ops/pallas/fused_query.py:807",
           "launches": launches + train_counts["mlp_fwd"],
           "launches_render": launches,
           "launches_train": train_counts["mlp_fwd"],
           "max_abs_err": max(k["max_abs_err"] for k in (
               coarse_k, fine_k, train_coarse_k, train_fine_k)),
           "ms": coarse_k["ms"], "plain_ms": coarse_k["plain_ms"],
           "bound_ms": coarse_k["bound_ms"], "bound_by": coarse_k["bound_by"],
           "library_ms": None,
           "points": n_coarse,
           "matmul_chain_bf16_ms": coarse_k["matmul_chain_bf16_ms"],
           "fine_pass": {"points": n_fine, **fine_k},
           "train_pass": {"points": n_bwd_coarse, **train_coarse_k},
           "train_fine_pass": {"points": n_bwd_fine, **train_fine_k}}
    log(json.dumps({"render": {"frames": FRAMES, "height": H, "width": W,
                               "chunk": CHUNK,
                               "s_per_frame_kernel": t_kernel / FRAMES,
                               "s_per_frame_off": t_off / FRAMES,
                               "psnr_kernel_vs_off_db": frame_psnr,
                               "rays_per_s_kernel": H * W * FRAMES / t_kernel,
                               "mlp_fwd_share_est": kernel_s / t_kernel,
                               "profile": prof, "gpu": smi}}))
    log(json.dumps({"train": train_results}))
    log(json.dumps({"kernels": [row, bwd_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
