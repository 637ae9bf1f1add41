"""The harness finds a cell, a traffic mix, a metric, a configuration with
its own reference and a mix with its own driver, each added as files
alone, and runs the new cell."""

import json
import os
import shutil

import pytest

from benchmark.harness import cells, spec
from bench_cases import tiny

# appended to a copy of a reference or a driver: the copy counts its calls
COUNTING = """
CALLS = []
_counted = {name}


def {name}(*args, **kwargs):
    CALLS.append(1)
    return _counted(*args, **kwargs)
"""


def checkout(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's files."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return root, spec.benchmark()


def add_cell(root, b, name, config, traffic):
    (root / "benchmark" / "limits" / f"{name}.json").write_text(
        json.dumps({"loss": 1e-3}))
    b["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append(name)


def copy_counting(root, src, dst, name):
    """benchmark/<dst>: benchmark/<src> whose function `name` counts its
    calls."""
    text = (root / "benchmark" / src).read_text()
    (root / "benchmark" / dst).write_text(text + COUNTING.format(name=name))


def test_cell_added_as_files(tmp_path):
    root, b = checkout(tmp_path)
    bench = root / "benchmark"
    mix = spec.read_json(os.path.join(spec.BENCH_DIR, "traffic",
                                      "train_r16384.json"))
    mix["N_rand"] = 4096
    (bench / "traffic" / "train_r4096.json").write_text(json.dumps(mix))
    name = "nrnerf_flagship.train_r4096"
    add_cell(root, b, name, "nrnerf_flagship", "train_r4096")
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    b["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "step", "moves": "train_rays_per_s",
                           "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.cell(name, root=str(root))
    assert cell["traffic"]["N_rand"] == 4096
    assert cell["limits"] == {"loss": 1e-3}
    assert "steps_in_window" in [m["name"] for m in cell["per_layer"]]
    assert "mfu.render" not in [m["name"] for m in cell["per_layer"]]
    run = cells.run_cell(tiny(cell), 5, 0.2, False, "cpu")
    assert run.correct
    got = spec.read_metrics(cell["per_layer"] + cell["end_to_end"], run,
                            cell["bench_dir"])
    assert got["steps_in_window"]["value"] == run.units
    assert got["train_rays_per_s"]["value"] > 0


@pytest.mark.parametrize("what", ["reference", "driver"])
def test_config_or_mix_brings_its_own_code(tmp_path, what):
    """A configuration that names a reference file of its own, or a traffic
    mix that names a driver file of its own, is run by that file."""
    root, b = checkout(tmp_path)
    bench = root / "benchmark"
    config = spec.read_json(str(bench / "configs" / "nrnerf_flagship.json"))
    mix = spec.read_json(str(bench / "traffic" / "train_r16384.json"))
    if what == "reference":
        copy_counting(root, "reference/nrnerf.py", "reference/nrnerf_own.py",
                      "train_steps")
        config["reference"] = "benchmark/reference/nrnerf_own.py"
        relpath = config["reference"]
    else:
        copy_counting(root, "drivers/train.py", "drivers/train_own.py", "run")
        mix["driver"] = "benchmark/drivers/train_own.py"
        relpath = mix["driver"]
    config["name"] = "nrnerf_own"
    (bench / "configs" / "nrnerf_own.json").write_text(json.dumps(config))
    (bench / "traffic" / "train_own.json").write_text(json.dumps(mix))
    b["configs"].append({"name": "nrnerf_own", "source": "x",
                         "file": "benchmark/configs/nrnerf_own.json",
                         "reduced": [], "why": "x"})
    name = "nrnerf_own.train_own"
    add_cell(root, b, name, "nrnerf_own", "train_own")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.cell(name, root=str(root))
    run = cells.run_cell(tiny(cell), 6, 0.2, False, "cpu")
    assert run.correct and run.units > 0
    assert spec.module(relpath, str(root)).CALLS


def test_every_listed_metric_has_a_reader():
    b = spec.benchmark()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        for key, relpath in (("driver", cell["traffic"]["driver"]),
                             ("reference", cell["config"]["reference"])):
            assert os.path.isfile(os.path.join(spec.ROOT, relpath)), key
