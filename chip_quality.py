#!/usr/bin/env python3
"""Train data_r5/occlusion with the training CLI under one variant, on one
GPU, and summarize the run: a diagnosis of the training PSNR against the
JAX run's (results/r5_robustness_full/metrics.jsonl).

    python3 chip_quality.py VARIANT [--seed S] [--steps N] [CLI flags ...]

VARIANT is one of
  kernels      the config as it is (results/r5_robustness_full/args.txt);
  off          fused_kernel = off: the f32 MLP in place of the bf16 kernels;
  bfloat16     compute_dtype = bfloat16: the bender, the rigidity network
               (and with fused_kernel = off the MLP) on bf16 operands with
               f32 sums, one rounding after the bias (the JAX run's
               results/r3_bf16 setting).

The run keeps the config's N_iters (200,000, as the JAX run had it): the
offsets and divergence regularizers are scaled by (1/100)^(1 - step /
N_iters), so a run cut by a smaller N_iters weighs them on another
schedule than the run it is compared with. The run ends at step N (4,000
unless --steps says otherwise) through the CLI's --die_at_step, in a
subprocess that must die by SIGKILL (exit code -9) after its save at that
step. It goes to chip_tmp/occlusion_<variant>_seed<S>/ (git-ignored),
printing every 50 steps, a validation frame every 1,000. The output ends
with the offsets and divergence losses of the run and of the JAX run at
steps N / 2 and N, and, last, `nonrigid_nerf_torch.cli.summarize` of its
metrics.jsonl over the windows N / 2 - 450 .. N / 2 and N - 450 .. N.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANTS = ("kernels", "off", "bfloat16")
CONFIG = os.path.join(ROOT, "results", "r5_robustness_full", "args.txt")
JAX_METRICS = os.path.join(ROOT, "results", "r5_robustness_full",
                           "metrics.jsonl")
SAVE_EVERY = 2000
LOSSES = ("offsets_loss", "divergence_loss")


def train_argv(variant, seed, steps, extra):
    """The CLI's flags of a run: the config's schedule, a save at `steps`
    (the save interval divides it) and a SIGKILL after it."""
    every = SAVE_EVERY if steps % SAVE_EVERY == 0 else steps
    expname = f"occlusion_{variant}_seed{seed}"
    argv = ["--config", CONFIG,
            "--datadir", os.path.join(ROOT, "data_r5", "occlusion"),
            "--i_print", "50", "--i_img", "1000", "--i_weights", str(every),
            "--die_at_step", str(steps), "--seed", str(seed),
            "--rootdir", os.path.join(ROOT, "chip_tmp"),
            "--expname", expname, "--no_reload"]
    if variant == "off":
        argv += ["--fused_kernel", "off"]
    elif variant == "bfloat16":
        argv += ["--compute_dtype", "bfloat16"]
    return argv + list(extra), expname


def losses_beside_jax(rows, steps):
    """Each loss of the run and of the JAX run at steps / 2 and steps."""
    with open(JAX_METRICS) as f:
        jax_rows = {r["step"]: r for r in map(json.loads, f) if "loss" in r}
    ours = {r["step"]: r for r in rows if "loss" in r}
    out = {}
    for step in (steps // 2, steps):
        for key in LOSSES:
            out[f"{key}@{step}"] = {
                "port": ours.get(step, {}).get(key),
                "jax": jax_rows.get(step, {}).get(key)}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variant", choices=VARIANTS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=4000)
    ns, extra = parser.parse_known_args(argv)
    cli_argv, expname = train_argv(ns.variant, ns.seed, ns.steps, extra)
    proc = subprocess.run([sys.executable, "-m", "nonrigid_nerf_torch.cli.train"]
                          + cli_argv, cwd=ROOT)
    if proc.returncode != -9:
        print(f"chip_quality: the run exited with {proc.returncode}, not -9 "
              f"(SIGKILL after the save at step {ns.steps})", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonrigid_nerf_torch.cli import summarize
    metrics = os.path.join(ROOT, "chip_tmp", expname, "logs", "metrics.jsonl")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    print(json.dumps({"losses": losses_beside_jax(rows, ns.steps)}))
    half = ns.steps // 2
    return summarize.main([metrics, "--window", str(half - 450), str(half),
                           "--window", str(ns.steps - 450), str(ns.steps)])


if __name__ == "__main__":
    sys.exit(main())
