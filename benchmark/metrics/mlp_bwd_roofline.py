"""`mlp_bwd`'s share of its roofline in the traced training window, %: the
least time of its launches' work at the published peaks (benchmark/
harness/yardstick.py) over the device time of its kernels (the chain, the
dW products, the head sums and the reduction). The points are the steps'
rays times the coarse and fine samples, each taking one cotangent. Nothing
to read where the trace's chain launches disagree with the wrapper's
launch counter."""

import sys

from benchmark.harness import yardstick

KERNELS = ("mlp_bwd_chain_kernel", "mlp_dw_sm90_kernel",
           "mlp_head_grad_kernel", "mlp_reduce_kernel")


def read(run):
    card = yardstick.peaks(run.device_name)
    if run.kind != "train" or run.trace is None or card is None:
        return None
    launches = run.trace.kernel_count(lambda n: KERNELS[0] in n)
    if launches != run.counters.get("mlp_bwd") or not launches:
        print(f"mlp_bwd_roofline: {launches} {KERNELS[0]} launches in the "
              f"trace, {run.counters.get('mlp_bwd')} counted",
              file=sys.stderr)
        return None
    model = run.config["model"]
    points = run.trace_units * run.rays_per_unit * (2 * model["N_samples"]
                                              + model["N_importance"])
    flops, nbytes = yardstick.mlp_bwd_work(points, launches,
                                           yardstick.kernel_lanes(model))
    return 100.0 * yardstick.least_seconds(flops, nbytes, card) \
        / run.trace.kernel_seconds(lambda n: any(k in n for k in KERNELS))
