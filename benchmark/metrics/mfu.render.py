"""Model FLOPs of the render window's frames over its wall time on the
host's clock, as a share of the card's dense bf16 peak, %: the whole
frame's share, read in a traced run from the window that runs before the
profiler starts (the profiler slows the host, also after its end)."""

from benchmark.harness import yardstick


def read(run):
    card = yardstick.peaks(run.device_name)
    if run.kind != "render" or run.trace is None or card is None \
            or not run.window_s:
        return None
    flops = run.units * run.rays_per_unit * yardstick.render_flops_per_ray(
        run.config["model"])
    return 100.0 * flops / run.window_s / card["bf16_flops"]
