"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout, and under `benchmark/` a file for each configuration
(`configs/<name>.json`), traffic mix (`traffic/<name>.json`), cell's
limits (`limits/<cell>.json`) and metric (`metrics/<name>.py`, a reader).
A configuration names its reference and a traffic mix its driver, each a
file of the checkout that `module` loads by path. A cell, a configuration,
a mix, a reference, a driver or a metric is added by adding its files and
its entry, never by editing code.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


_MODULES: Dict[str, object] = {}


def load(path: str):
    """The Python file at `path` as a module, loaded once a process."""
    path = os.path.abspath(path)
    if path not in _MODULES:
        found = importlib.util.spec_from_file_location(
            f"benchmark_file_{len(_MODULES)}", path)
        mod = importlib.util.module_from_spec(found)
        found.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def module(relpath: str, root: str = ROOT):
    """A configuration's reference or a traffic mix's driver: the file
    `relpath` of the checkout at `root`."""
    return load(os.path.join(root, relpath))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration and traffic
    files read, its limits, and the metrics it reports: {"workload",
    "root", "bench_dir", "config", "traffic", "limits", "end_to_end",
    "per_layer"}."""
    bench = benchmark(root)
    bench_dir = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reports(metric):
        return name in metric.get("workloads", [name])

    return {"workload": w, "root": root, "bench_dir": bench_dir,
            "config": read_json(os.path.join(root, entry["file"])),
            "traffic": read_json(os.path.join(bench_dir, "traffic",
                                              w["traffic"] + ".json")),
            "limits": read_json(os.path.join(bench_dir, "limits",
                                             name + ".json")),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def reader(metric_name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """`read(run) -> float or None` of `metrics/<metric_name>.py`."""
    return load(os.path.join(bench_dir, "metrics", metric_name + ".py")).read


def read_metrics(metrics, run, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose reader finds something
    to read in `run`."""
    out = {}
    for m in metrics:
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
