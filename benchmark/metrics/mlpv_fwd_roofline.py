"""`mlpv_fwd`'s share of its roofline in the traced render window, %: the
least time of its launches' work at the published peaks (the larger of
FLOPs over the bf16 rate and bytes over HBM's; benchmark/harness/
yardstick_views.py) over the device time of its kernel. The points are the
frames' rays times the coarse and fine samples. Nothing to read where the
trace's launches disagree with the wrapper's launch counter, as the view
drivers record it."""

import sys

from benchmark.harness import yardstick, yardstick_views


def read(run):
    card = yardstick.peaks(run.device_name)
    if run.kind != "render" or run.trace is None or card is None:
        return None
    name = "mlpv_fwd_kernel"
    launches = run.trace.kernel_count(lambda n: name in n)
    if launches != run.counters.get("mlpv_fwd") or not launches:
        print(f"mlpv_fwd_roofline: {launches} {name} launches in the trace, "
              f"{run.counters.get('mlpv_fwd')} counted", file=sys.stderr)
        return None
    model = run.config["model"]
    points = run.trace_units * run.rays_per_unit * (2 * model["N_samples"]
                                                    + model["N_importance"])
    flops, nbytes = yardstick_views.mlpv_fwd_work(points, launches)
    return 100.0 * yardstick.least_seconds(flops, nbytes, card) \
        / run.trace.kernel_seconds(lambda n: name in n)
