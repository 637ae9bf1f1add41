"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program; names compared whole, by their
top level."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import cli, spec

JAX_NAMES = {"jax", "jaxlib", "flax", "nonrigid_nerf_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    top = os.path.join(spec.BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: set(imported_tops(p)) & JAX_NAMES for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_reference_is_plain():
    allowed = {"__future__", "contextlib", "math", "typing", "torch"}
    for p in sources("reference"):
        assert set(imported_tops(p)) <= allowed, p


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_module", sys)
    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cli.forbidden_modules() == ["jax"]


CELL = "nrnerf_flagship.render_path_384x512"


@pytest.mark.parametrize("args", [
    ["benchmark/run.py", "--workload", CELL, "--seed", "1", "--seconds", "1",
     "--trace", "0"],
    ["-m", "benchmark.harness.readings", "--workload", CELL, "--seeds",
     "1,2"]])
def test_run_without_a_card_prints_no_result(args):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, *args], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
