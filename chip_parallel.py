#!/usr/bin/env python3
"""Data-parallel scaling of nonrigid_nerf_torch's training CLI over GPUs.

    python3 chip_parallel.py            # from the repository root, 4 GPUs
    python3 chip_parallel.py --gpus 2   # or another count

Runs `python3 -m torch.distributed.run --standalone --nproc_per_node N -m
nonrigid_nerf_torch.cli.train` on data_r5/occlusion with the config of its
JAX run (results/r5_robustness_full/args.txt: 200,000 N_iters, ended here by
--die_at_step, so the regularizers weigh as in that run), on 1 GPU at a
global N_rand of 1024, and on N at 1024 (strong scaling: 1024 / N rays a
rank) and at 1024 N (weak scaling: 1024 rays a rank; one GPU cannot take
that batch: `mlp_bwd` takes at most 262,144 points a launch). For each run
it prints, beside the card's name and power limit:

- steps/s and rays/s over steps 101 to the end (rank 0's metrics.jsonl;
  every window of --print steps ends in a wait for the device);
- per rank, from the torch.profiler trace of steps 50-70 that every rank
  writes (`--profile_steps 20`): device busy ms a step and the device's
  idle share of the traced wall time (kernel intervals merged over all
  streams), with and without NCCL's kernels, and the time a step in them
  (the gradients' and the metrics' all-reduce: a rank that arrives first
  spins inside them until the last one comes);
- the runs at N_rand 1024: the N-GPU losses over the first 200 steps
  against the 1-GPU run's (every --print steps; the same steps up to the
  order of the gradient sums, parallel/mesh.py).

Then the all-reduce alone (`--allreduce-rank` under torchrun on N GPUs):
the step's gradient buffer (every parameter of the config's model, f32)
and its metrics buffer, each timed with CUDA events after a barrier, the
median of 50: the transfer without the wait for a late rank.

The last line is one JSON object with all of it. The kernels are built
once, here, before the first launch, so that no rank builds them.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

CONFIG = os.path.join("results", "r5_robustness_full", "args.txt")
DATA = os.path.join("data_r5", "occlusion")
BASE_RAYS = 1024
# apps/train.py traces steps PROFILE_AFTER to PROFILE_AFTER + profile_steps
PROFILE_AFTER, PROFILE_STEPS = 50, 20
TRACED_STEPS = PROFILE_STEPS + 1
TIMED_FROM = 100                           # steps after the profile window
LOSS_STEPS = 200
ALLREDUCE_ITERS, ALLREDUCE_WARMUP = 50, 5
METRICS_FLOATS = 7          # parallel/mesh.py: the count and 6 numerators


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run_cli(root, gpus, n_rand, steps, print_every, tmp):
    """One training run under torchrun, ended by --die_at_step after
    `steps` steps; returns its experiment folder."""
    expname = f"gpus{gpus}_rays{n_rand}"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(gpus), "-m", "nonrigid_nerf_torch.cli.train",
           "--config", CONFIG, "--datadir", DATA, "--rootdir", tmp,
           "--expname", expname, "--no_reload", "--N_rand", str(n_rand),
           "--i_print", str(print_every), "--i_img", "0",
           "--i_weights", "1000000", "--i_video", "1000000",
           "--i_testset", "1000000", "--profile_steps", str(PROFILE_STEPS),
           "--die_at_step", str(steps)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    kills = out.count(f"[FAULT-INJECTION] SIGKILL at step {steps}")
    log(f"run {expname}: exit {proc.returncode} after {wall:.1f} s, "
        f"{kills} of {gpus} ranks killed at step {steps}")
    if kills != gpus:
        log(out[-6000:])
        raise AssertionError(f"{expname}: every rank must reach step {steps}")
    return os.path.join(tmp, expname)


def metrics(folder):
    with open(os.path.join(folder, "logs", "metrics.jsonl")) as f:
        return [row for row in map(json.loads, f) if "loss" in row]


def merged_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_numbers(path):
    """Device busy time, idle share and NCCL kernel time of one rank's
    chrome trace (microseconds; the window is the span of all events)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"{path}: the profiler saw no kernel")
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"]
                                                        for e in events)
    busy = merged_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    compute = merged_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels
                         if "nccl" not in e["name"].lower()])
    nccl = sum(e["dur"] for e in kernels if "nccl" in e["name"].lower())
    return {"busy_ms_per_step": busy / 1e3 / TRACED_STEPS,
            "idle_share": 1.0 - busy / span,
            "compute_ms_per_step": compute / 1e3 / TRACED_STEPS,
            "idle_share_without_nccl": 1.0 - compute / span,
            "nccl_ms_per_step": nccl / 1e3 / TRACED_STEPS,
            "kernels_per_step": len(kernels) / TRACED_STEPS}


def summarize(folder, gpus, n_rand, smi):
    rows = metrics(folder)
    timed = [r for r in rows if r["step"] > TIMED_FROM]
    print_every = rows[1]["step"] - rows[0]["step"]
    seconds = sum(print_every / r["it_per_sec"] for r in timed)
    steps_per_s = print_every * len(timed) / seconds
    profile = os.path.join(folder, "logs", "profile")
    ranks = []
    for r in range(gpus):
        suffix = "" if r == 0 else f"_rank{r}"
        ranks.append(trace_numbers(os.path.join(
            profile, f"steps_{PROFILE_AFTER}_{PROFILE_AFTER + PROFILE_STEPS}"
            f"{suffix}.json")))
    out = {"gpus": gpus, "n_rand": n_rand, "rays_per_rank": n_rand // gpus,
           "steps_per_s": steps_per_s, "rays_per_s": steps_per_s * n_rand,
           "timed_steps": print_every * len(timed), "ranks": ranks,
           "losses": {r["step"]: r["loss"] for r in rows
                      if r["step"] <= LOSS_STEPS}}
    log(f"{gpus} GPU(s), N_rand {n_rand} ({n_rand // gpus} a rank): "
        f"{steps_per_s:.2f} steps/s, {steps_per_s * n_rand:.0f} rays/s over "
        f"steps {TIMED_FROM + 1}-{rows[-1]['step']}; per rank: " + "; ".join(
            f"rank {i} busy {x['busy_ms_per_step']:.2f} ms/step (without "
            f"NCCL {x['compute_ms_per_step']:.2f}), idle "
            f"{x['idle_share']:.3f} (without NCCL "
            f"{x['idle_share_without_nccl']:.3f}), NCCL "
            f"{x['nccl_ms_per_step']:.3f} ms/step"
            for i, x in enumerate(ranks)) + f"; {smi}")
    return out


def allreduce_rank() -> int:
    """One rank of the all-reduce timing (under torchrun): rank 0 prints
    `ALLREDUCE <json>`."""
    import torch
    import torch.distributed as dist
    from nonrigid_nerf_torch.config import load_args, model_config_from_args
    from nonrigid_nerf_torch.device import resolve_device
    from nonrigid_nerf_torch.models.model import NRNeRF
    from nonrigid_nerf_torch.parallel import multihost
    multihost.maybe_initialize()
    device = resolve_device()
    with open(os.path.join(DATA, "image_to_camera_id_and_timestep.json")) as f:
        timesteps = len({t for _, t in json.load(f).values()})
    model = NRNeRF(model_config_from_args(load_args(CONFIG)), timesteps,
                   device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    buffers = {"gradients": torch.ones(n_params, device=device),
               "metrics": torch.ones(METRICS_FLOATS, device=device)}
    times = {name: [] for name in buffers}
    for it in range(ALLREDUCE_WARMUP + ALLREDUCE_ITERS):
        for name, buf in buffers.items():
            dist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_reduce(buf)
            end.record()
            torch.cuda.synchronize()
            if it >= ALLREDUCE_WARMUP:
                times[name].append(start.elapsed_time(end))
    if multihost.is_main():
        print("ALLREDUCE " + json.dumps({
            "world": multihost.world_size(), "gradient_floats": n_params,
            **{f"{name}_ms_median": sorted(t)[len(t) // 2]
               for name, t in times.items()},
            **{f"{name}_ms_min": min(t) for name, t in times.items()}}),
            flush=True)
    dist.destroy_process_group()
    return 0


def allreduce(root, gpus):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(gpus), os.path.join(root, "chip_parallel.py"),
         "--allreduce-rank"], cwd=root, capture_output=True, text=True,
        timeout=300)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("ALLREDUCE ")]
    if proc.returncode != 0 or len(lines) != 1:
        log(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise AssertionError("the all-reduce timing failed")
    return json.loads(lines[0][len("ALLREDUCE "):])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gpus", type=int, default=4)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--print", dest="print_every", type=int, default=10)
    parser.add_argument("--allreduce-rank", action="store_true",
                        help="(internal) one rank of the all-reduce timing")
    ns = parser.parse_args()
    if ns.allreduce_rank:
        return allreduce_rank()
    import torch
    if not torch.cuda.is_available():
        print("chip_parallel: no CUDA device; this script runs on GPUs only",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "nonrigid_nerf_torch")):
        print("chip_parallel: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < ns.gpus:
        print(f"chip_parallel: {ns.gpus} GPUs asked for, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from nonrigid_nerf_torch.ops.kernels import build
    smi = gpu_name_and_power_limit()
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.load_kernel_libraries(("mlp_fwd.cu", "mlp_bwd.cu"))
    log(f"build mlp_fwd.cu, mlp_bwd.cu: {time.perf_counter() - t0:.1f} s")

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for gpus, n_rand in ((1, BASE_RAYS), (ns.gpus, BASE_RAYS),
                             (ns.gpus, BASE_RAYS * ns.gpus)):
            folder = run_cli(root, gpus, n_rand, ns.steps, ns.print_every,
                             tmp)
            results.append(summarize(folder, gpus, n_rand, smi))
    one, many = results[0], results[1]
    diffs = {s: abs(many["losses"][s] - one["losses"][s]) / abs(
        one["losses"][s]) for s in one["losses"] if s in many["losses"]}
    log(f"losses, {ns.gpus} GPUs against 1 at N_rand {BASE_RAYS}, steps "
        f"{min(diffs)}-{max(diffs)}: relative difference max "
        f"{max(diffs.values()):.3e}, mean "
        f"{sum(diffs.values()) / len(diffs):.3e}; at step {min(diffs)} "
        f"{diffs[min(diffs)]:.3e}")
    strong = many["steps_per_s"] / one["steps_per_s"]
    weak = results[2]["rays_per_s"] / one["rays_per_s"]
    for run in results[1:3]:
        nccl = [x["nccl_ms_per_step"] for x in run["ranks"]]
        log(f"all-reduce, {run['gpus']} GPUs at N_rand {run['n_rand']}: NCCL "
            f"kernels {min(nccl):.4f} ms/step on the rank that waits least, "
            f"{max(nccl):.4f} on the rank that waits most; {smi}")
    timed = allreduce(root, ns.gpus)
    log(f"all-reduce alone on {ns.gpus} GPUs, after a barrier: "
        f"{timed['gradient_floats']} f32 gradients "
        f"{timed['gradients_ms_median']:.4f} ms (median of "
        f"{ALLREDUCE_ITERS}; least {timed['gradients_ms_min']:.4f}), the "
        f"metrics' {METRICS_FLOATS} floats {timed['metrics_ms_median']:.4f} "
        f"ms; {smi}")
    log(f"strong scaling (N_rand {BASE_RAYS}): {strong:.3f}x the steps/s of "
        f"1 GPU on {ns.gpus}; weak scaling (N_rand {BASE_RAYS} a rank): "
        f"{weak:.3f}x the rays/s of 1 GPU; {smi}")
    log(json.dumps({"device": smi, "strong_scaling": strong,
                    "weak_scaling": weak, "loss_rel_diff": diffs,
                    "allreduce": timed,
                    "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
