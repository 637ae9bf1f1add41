"""The comparison that decides `correct`: the reference agrees with the
port's plain path at a tiny size, and each fault planted in the timed path
makes a run incorrect. Both drive a whole run without a card."""

import pytest

from benchmark.harness import cells
from bench_cases import BIG_SEED, RENDER_CELLS, TRAIN_CELLS


@pytest.mark.parametrize("name", TRAIN_CELLS + RENDER_CELLS)
def test_reference_agrees_with_plain_port(tiny_cell, name):
    run = cells.run_cell(tiny_cell(name), BIG_SEED, 0.3, False, "cpu")
    assert run.correct and run.failed == 0
    assert run.checks and max(run.checks.values()) < 1e-4


@pytest.mark.parametrize("name", TRAIN_CELLS + RENDER_CELLS)
def test_reference_in_bf16_agrees_with_kernels_plain(tiny_cell, name):
    """At 64 rays a step a mean averages 16x less noise than at the cell's
    16,384, so the cell's limits do not apply; the gaps stay at bf16's
    rounding all the same."""
    run = cells.run_cell(tiny_cell(name, bf16=True), BIG_SEED, 0.3, False,
                         "cpu")
    assert run.detail["numbers"]
    assert max(run.detail["numbers"].values()) < 5e-3


@pytest.mark.parametrize("name, fault", [
    (c, f) for c in TRAIN_CELLS for f in ("frozen", "half_batch")] + [
    (c, f) for c in RENDER_CELLS for f in ("stale_frame", "altered_pixel")])
def test_fault_is_incorrect(tiny_cell, name, fault):
    run = cells.run_cell(tiny_cell(name), BIG_SEED + 1, 0.3, False, "cpu",
                         variant=fault)
    assert not run.correct and run.failed == run.attempted > 0


@pytest.mark.parametrize("key, value", [
    ("use_viewdirs", True), ("bending_activation", "sin"), ("i_embed", -1),
    ("netwidth_fine", 128), ("use_rigidity_network", False),
    ("N_importance", 0)])
def test_reference_refuses_what_it_does_not_implement(tiny_cell, key, value):
    from benchmark.reference import nrnerf
    model = tiny_cell(TRAIN_CELLS[0])["config"]["model"]
    nrnerf.check_supported(model)
    with pytest.raises(ValueError):
        nrnerf.check_supported(dict(model, **{key: value}))


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS + RENDER_CELLS)
def test_control_is_incorrect(cuda, name):
    """The control at the cell's own size on the card: the reference in the
    program's place one precision below what the configuration states
    (fp8 MLP products for bf16), on three seeds."""
    from benchmark.harness import spec
    for seed in (BIG_SEED + 10, BIG_SEED + 11, BIG_SEED + 12):
        run = cells.run_cell(spec.cell(name), seed, 0.0, False, cuda,
                             variant="control")
        assert not run.correct, (name, seed, run.checks)
