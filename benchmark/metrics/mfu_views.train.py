"""Model FLOPs of the training window's steps with the view branch
(benchmark/harness/yardstick_views.py) over the window's wall time on the
host's clock, as a share of the card's dense bf16 peak, %: `mfu.train`'s
rule, read in a traced run from the window that runs before the profiler
starts."""

from benchmark.harness import yardstick, yardstick_views


def read(run):
    card = yardstick.peaks(run.device_name)
    if run.kind != "train" or run.trace is None or card is None \
            or not run.window_s:
        return None
    flops = run.units * run.rays_per_unit \
        * yardstick_views.train_flops_per_ray(run.config["model"],
                                              run.config["train"])
    return 100.0 * flops / run.window_s / card["bf16_flops"]
