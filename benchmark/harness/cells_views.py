"""What the view-direction drivers (`drivers/render_views.py`,
`drivers/train_views.py`) add to `cells.py` and `faults.py`:

- `LaunchLog`: the launches of `mlpv_fwd` and `mlpv_bwd` (the wrappers'
  counters) unit by unit, so that a run records them over its traced units
  (or, without a trace, its window) as `cells.window` records `mlp_fwd` and
  `mlp_bwd`;
- the faults of the bent-ray directions: "straight_viewdirs", the
  program's view directions are the unbent ray's, in every pass, in place
  of the bent ray's; "detached_viewdirs", they are the bent ray's but cut
  from the autograd graph, so the forward is unchanged and no gradient
  reaches the bender, the rigidity network or the latents through them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

from benchmark.harness import faults

KERNELS = ("mlpv_fwd", "mlpv_bwd")


def launch_counts() -> Dict[str, int]:
    from nonrigid_nerf_torch.ops.kernels import mlpv_bwd, mlpv_fwd
    return {"mlpv_fwd": mlpv_fwd.mlpv_fwd.launches,
            "mlpv_bwd": mlpv_bwd.mlpv_bwd.launches}


class LaunchLog:
    """`counted(unit)` runs a unit and logs its launches; `record(run,
    trace)` adds their sums over the run's traced units (over all logged
    units without a trace) to `run.counters`."""

    def __init__(self):
        self.units: List[Dict[str, int]] = []

    def counted(self, unit: Callable[[], object]) -> Callable[[], None]:
        def run_unit():
            before = launch_counts()
            unit()
            after = launch_counts()
            self.units.append({k: after[k] - before[k] for k in after})
        return run_unit

    def record(self, run, trace: bool):
        units = self.units[-run.trace_units:] if trace else self.units
        run.counters.update({k: sum(u[k] for u in units) for k in KERNELS})


@contextlib.contextmanager
def straight_viewdirs():
    """Every sample's view direction is its ray's unbent unit direction."""
    from nonrigid_nerf_torch.engine import query, render

    def straight(model, cfg, pts, stage1, viewdirs, edit=None):
        return viewdirs[:, None, :].expand(pts.shape)

    with faults._patched(query, "sample_viewdirs", straight), \
            faults._patched(render, "sample_viewdirs", straight):
        yield


@contextlib.contextmanager
def detached_viewdirs():
    """Every sample's view direction is the bent ray's, detached."""
    from nonrigid_nerf_torch.engine import query, render
    bent = query.sample_viewdirs

    def detached(*args, **kwargs):
        return bent(*args, **kwargs).detach()

    with faults._patched(query, "sample_viewdirs", detached), \
            faults._patched(render, "sample_viewdirs", detached):
        yield
