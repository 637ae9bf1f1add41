"""Device-idle ms a training step in the traced window during which the
innermost program span open on the host is `viewdirs`: each sample's view
direction along the bent ray and its encoding (`engine/query.py:
sample_viewdirs`, `_embed_views`). Each idle stretch is split over the
spans along it by exact overlap (`benchmark/harness/spans.py`). 0.0 where
the program opens no such span."""

from benchmark.harness import spans


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace_units:
        return None
    return 1e3 * spans.idle_by_span(run.trace).get("viewdirs", 0.0) \
        / run.trace_units
