#!/usr/bin/env python3
"""Train data_r5/occlusion with the training CLI under one variant, on one
GPU, and summarize the run: a diagnosis of the training PSNR against the
JAX run's (results/r5_robustness_full/metrics.jsonl).

    python3 chip_quality.py VARIANT [--seed S] [--steps N] [CLI flags ...]

VARIANT is one of
  kernels      the config as it is (results/r5_robustness_full/args.txt);
  off          fused_kernel = off: the f32 MLP in place of the bf16 kernels;
  bf16_bender  every dense layer of the bender and the rigidity network
               rounds its input and its weight to bf16 and sums in f32, as
               a TPU's DEFAULT matmul precision does in the JAX run.

The run goes to chip_tmp/occlusion_<variant>_seed<S>/ (git-ignored), 4,000
steps unless --steps says otherwise, printing every 50 steps, a validation
frame every 1,000, a save every 2,000. The last line is
`nonrigid_nerf_torch.cli.summarize` of its metrics.jsonl over the windows
1,550-2,000 and 3,550-4,000.
"""

import argparse
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANTS = ("kernels", "off", "bf16_bender")


def bf16_operand_chain(layers, h, activation="relu"):
    """BendingNetwork._chain with each product on bf16-rounded operands."""
    def linear(layer, x):
        return F.linear(x.to(torch.bfloat16).float(),
                        layer.weight.to(torch.bfloat16).float(), layer.bias)

    for i, layer in enumerate(layers[:-1]):
        h = linear(layer, h)
        h = torch.sin(h * 30.0 if i == 0 else h) if activation == "sin" \
            else torch.relu(h)
    return linear(layers[-1], h)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variant", choices=VARIANTS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=4000)
    ns, extra = parser.parse_known_args(argv)
    sys.path.insert(0, ROOT)
    from nonrigid_nerf_torch.cli import summarize, train as cli
    from nonrigid_nerf_torch.models.bending import BendingNetwork

    if ns.variant == "bf16_bender":
        BendingNetwork._chain = staticmethod(bf16_operand_chain)
    if ns.variant == "off":
        extra = ["--fused_kernel", "off"] + extra
    expname = f"occlusion_{ns.variant}_seed{ns.seed}"
    cli.main(["--config", os.path.join(ROOT, "results", "r5_robustness_full",
                                       "args.txt"),
              "--datadir", os.path.join(ROOT, "data_r5", "occlusion"),
              "--N_iters", str(ns.steps), "--i_print", "50", "--i_img", "1000",
              "--i_weights", "2000", "--seed", str(ns.seed),
              "--rootdir", os.path.join(ROOT, "chip_tmp"),
              "--expname", expname, "--no_reload"] + extra)
    return summarize.main([os.path.join(ROOT, "chip_tmp", expname, "logs",
                                        "metrics.jsonl"),
                           "--window", "1550", "2000", "--window", "3550",
                           "4000"])


if __name__ == "__main__":
    sys.exit(main())
