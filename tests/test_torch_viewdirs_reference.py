"""NR-NeRF with view-dependent colour (`benchmark/configs/nrnerf_viewdirs.
json`) in the port against the benchmark's plain reference
(`benchmark/reference/nrnerf_viewdirs.py`, loaded by path), at a tiny size
on the CPU, on the benchmark's seeded weights: a frame through
`render_path`, and the training step's loss, every leaf's first gradient
and the parameters' change after three steps, each as the cell's
comparison takes it (`benchmark/drivers/{render,train}_views.py`).

- `fused_kernel="off"` (a 64-wide MLP in f32) against the f32 reference:
  to 1e-5.
- `fused_kernel="on"` (the 8 x 256 MLP on `mlpv_fwd` / `mlpv_bwd`'s plain
  versions, their bf16 arithmetic) against the reference in bf16: to bf16's
  rounding.
- The fault `straight_viewdirs` (the unbent ray's directions) and the fp8
  control (the reference one precision below the stated one) read
  incorrect under the cell's limits.
- The fault `detached_viewdirs` (the bent ray's directions cut from the
  graph) leaves the forward and the canonical MLPs' gradients as they are,
  and misses the whole of the directions' term of the bender-side leaves'
  gradient, which `bender_dirs` reads.
"""

import pytest

from benchmark.harness import cells, spec

RENDER = "nrnerf_viewdirs.render_path_384x512_views"
TRAIN = "nrnerf_viewdirs.train_r16384_views"
SEED = 2 ** 31 + 22
tiny = spec.load(f"{spec.BENCH_DIR}/tests/bench_cases.py").tiny


def run(name, bf16=False, variant="program", seed=SEED):
    return cells.run_cell(tiny(spec.cell(name), bf16), seed, 0.2, False,
                          "cpu", variant=variant)


def test_reference_is_loaded_by_path_and_refuses_other_models():
    cell = spec.cell(RENDER)
    ref = spec.module(cell["config"]["reference"])
    model = cell["config"]["model"]
    ref.check_supported(model)
    for key, value in (("use_viewdirs", False),
                       ("approx_nonrigid_viewdirs", False),
                       ("time_conditioned_baseline", True)):
        with pytest.raises(ValueError):
            ref.check_supported(dict(model, **{key: value}))


@pytest.mark.parametrize("bf16, tol", [(False, 1e-5), (True, 1e-3)])
def test_frame_agrees_with_the_reference(bf16, tol):
    r = run(RENDER, bf16)
    assert r.attempted > 0
    numbers = r.detail["numbers"]
    assert set(numbers) == {"rgb_max", "rgb_mean", "disp_max"}
    assert max(numbers.values()) < tol, numbers


@pytest.mark.parametrize("bf16, tol", [(False, 1e-5), (True, 5e-3)])
def test_training_steps_agree_with_the_reference(bf16, tol):
    r = run(TRAIN, bf16)
    d = r.detail
    assert len(d["losses"]) == 3
    for a, b in zip(d["losses"], d["ref_losses"]):
        assert abs(a - b) <= tol * abs(b)
    # every leaf's first gradient, the view heads and the bender included
    names = set(d["grad_diffs"])
    assert {"coarse.views.0.weight", "fine.rgb.bias", "coarse.alpha.bias",
            "bender.bend.4.weight", "latents"} <= names
    assert max(d["grad_diffs"].values()) < tol, d["grad_diffs"]
    assert max(d["change"].values()) < tol


@pytest.mark.parametrize("name", [RENDER, TRAIN])
@pytest.mark.parametrize("variant", ["straight_viewdirs", "control"])
def test_fault_and_control_read_incorrect(name, variant):
    r = run(name, bf16=True, variant=variant)
    assert r.attempted > 0 and not r.correct and r.failed == r.attempted
    if variant == "straight_viewdirs":
        # the directions reach the colour: far beyond the program's gap
        good = run(name, bf16=True)
        assert any(r.checks[k] > 10 * good.checks[k] for k in good.checks)


def test_detached_directions_fail_the_bender_number():
    seed = 2 ** 31 + 12345
    good = run(TRAIN, seed=seed)
    bad = run(TRAIN, variant="detached_viewdirs", seed=seed)
    # the forward and the canonical MLPs' first gradients are the program's
    assert bad.detail["losses"][0] == good.detail["losses"][0]
    for k in ("grad", "head_grad"):
        assert bad.detail["numbers"][k] == good.detail["numbers"][k]
    # the term through the directions is missing from the bender side
    limit = spec.cell(TRAIN)["limits"]["bender_dirs"]
    assert good.checks["bender_dirs"] < 1e-3 * limit
    assert bad.checks["bender_dirs"] == pytest.approx(1.0, abs=1e-3)
    assert not bad.correct and bad.failed == bad.attempted > 0
