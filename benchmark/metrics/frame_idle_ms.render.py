"""Device-idle ms a frame in the traced window during which the innermost
program span open on the host is `frame`, `frame_rays` or `readback`:
`render_path`'s work on a frame outside its block loop (the renderer's
lookup, the rays and their copies to the device, the image's copy back).
Each idle stretch is split over the spans along it by exact overlap
(`benchmark/harness/spans.py`). 0.0 where the program opens no such span."""

from benchmark.harness import spans

STAGES = ("frame", "frame_rays", "readback")


def read(run):
    if run.kind != "render" or run.trace is None or not run.trace_units:
        return None
    idle = spans.idle_by_span(run.trace)
    return 1e3 * sum(idle.get(s, 0.0) for s in STAGES) / run.trace_units
