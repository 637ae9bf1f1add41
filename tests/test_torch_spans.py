"""The program's spans (`nonrigid_nerf_torch/utils/spans.py`) and the
kernel-load counter (`ops/kernels/build.py:KERNEL_LOAD`).

- With no profiler running, `span` is one shared no-op and builds no
  record range.
- Under torch.profiler on the CPU, a tiny training step and a
  `render_path` frame record every span their path runs, each a host event
  that is not a user annotation, nested as the step and the frame nest.
- With view directions every pass opens one `viewdirs` span, on every
  route, in training and in rendering, and none without a profiler.
- `backward_in_pieces` opens one `bwd_piece` span a piece.
- `KERNEL_LOAD` adds up the seconds of every build and load and counts the
  libraries compiled.

On the card, `tests/test_torch_kernels_cuda.py` holds that the spans put
nothing on the device's timeline.
"""

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nonrigid_nerf_torch.apps.render_path import render_path
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.engine.train_state import create_train_state
from nonrigid_nerf_torch.ops.kernels import build, pieces
from nonrigid_nerf_torch.utils import spans
from tests.test_torch_train_app import CFG, RS, TC, make_dataset

TRAIN_SPANS = {"step", "sample", "stage1", "stage2", "composite",
               "importance", "union", "sort", "losses", "backward", "adam"}
FRAME_SPANS = {"frame", "frame_rays", "blocks", "readback", "write", "block",
               "stage1", "stage2", "composite", "importance", "union", "sort"}


class CountingRange:
    """Stands in for `_RecordFunctionFast` and counts its constructions."""
    made = 0

    def __init__(self, name):
        CountingRange.made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def program_events(prof):
    """{name without the prefix: [(start us, end us), ...]} of the
    profile's program spans, after checking that each is a host event and
    not a user annotation."""
    out = {}
    for ev in prof.events():
        if not ev.name.startswith(spans.PREFIX):
            continue
        assert ev.device_type == DeviceType.CPU, ev.name
        assert not ev.is_user_annotation, ev.name
        out.setdefault(ev.name[len(spans.PREFIX):], []).append(
            (ev.time_range.start, ev.time_range.end))
    return out


def inside(events, inner, outer):
    """Every `inner` span lies within some `outer` span by time."""
    return all(any(s <= a and b <= e for s, e in events[outer])
               for a, b in events[inner])


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        CountingRange)
    CountingRange.made = 0
    assert not torch.autograd._profiler_enabled()
    first, second = spans.span("step"), spans.span("adam")
    assert first is second
    with first:
        with second:
            pass
    assert CountingRange.made == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("step"):
            pass
    assert CountingRange.made == 1


def test_span_under_the_profiler_is_a_host_range_around_its_ops():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            with spans.span("inner"):
                torch.ones(8).mul(2.0)
    events = program_events(prof)
    assert set(events) == {"outer", "inner"}
    assert inside(events, "inner", "outer")
    mul = next(ev for ev in prof.events() if ev.name == "aten::mul")
    assert mul.cpu_parent is not None
    assert mul.cpu_parent.name == spans.PREFIX + "inner"


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_training_step_records_its_spans(one_thread):
    ds = make_dataset()
    state = create_train_state(CFG, TC, ds.num_timesteps, device="cpu")
    step_fn = t_step.make_train_step(CFG, TC, RS, ds.has_test_split)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, ds, t_step.step_generator(TC.seed, 0, "cpu"))
    events = program_events(prof)
    assert set(events) == TRAIN_SPANS
    assert len(events["step"]) == 1 and len(events["adam"]) == 1
    # one gradient of everything, one of the latents for the test rays
    assert len(events["backward"]) == 2
    assert len(events["composite"]) == 2 and len(events["stage1"]) == 2
    for name in TRAIN_SPANS - {"step"}:
        assert inside(events, name, "step"), name


def test_presampled_step_records_a_step_span(one_thread):
    ds = make_dataset()
    state = create_train_state(CFG, TC, ds.num_timesteps, device="cpu")
    presample_fn, step_fn = t_step.make_prefetch_train_step(
        CFG, TC, RS, ds.has_test_split, n_prefetch=2)
    batches = presample_fn(ds, TC.seed, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, batches, 0)
        step_fn(state, batches, 1)
    events = program_events(prof)
    assert len(events["step"]) == 2 and "sample" not in events
    assert inside(events, "adam", "step")


def test_render_path_frame_records_its_spans(tmp_path, one_thread):
    h, w = 6, 8
    model = create_train_state(CFG, TC, 4, device="cpu").model
    intrin = dict(height=h, width=w, focal_x=8.0, focal_y=8.0, center_x=4.0,
                  center_y=3.0)
    pose = np.eye(4, dtype=np.float32)[:3]
    pose[2, 3] = 4.0
    latents = model.latents.detach().numpy()[:1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_path(model, CFG, RS, pose[None], [intrin], latents, chunk=32,
                    savedir=str(tmp_path), verbose=False, device="cpu")
    events = program_events(prof)
    assert set(events) == FRAME_SPANS
    assert len(events["frame"]) == 1
    assert len(events["block"]) == 2       # 48 rays in blocks of 32
    for name in ("frame_rays", "blocks", "readback", "write"):
        assert inside(events, name, "frame"), name
    assert inside(events, "block", "blocks")
    for name in ("stage1", "union", "stage2", "composite", "importance",
                 "sort"):
        assert inside(events, name, "block"), name
    assert os.path.exists(tmp_path / "000.png")


def view_cfg(approx=True, reuse=True):
    return dataclasses.replace(CFG, use_viewdirs=True,
                               approx_nonrigid_viewdirs=approx,
                               stage1_reuse=reuse)


def render_view_frame(cfg, tmp_path):
    """One 6 x 8 frame through `render_path` in blocks of 32 rays (2)."""
    model = create_train_state(cfg, TC, 4, device="cpu").model
    intrin = dict(height=6, width=8, focal_x=8.0, focal_y=8.0, center_x=4.0,
                  center_y=3.0)
    pose = np.eye(4, dtype=np.float32)[:3]
    pose[2, 3] = 4.0
    render_path(model, cfg, RS, pose[None], [intrin],
                model.latents.detach().numpy()[:1], chunk=32,
                savedir=str(tmp_path), verbose=False, device="cpu")


# the routes: the sort-first fine pass of approximate bent directions,
# the unsorted union of exact ones, and the reference's second query
@pytest.mark.parametrize("approx, reuse", [(True, True), (False, True),
                                           (True, False)])
def test_view_directions_open_a_viewdirs_span_a_pass(tmp_path, one_thread,
                                                     approx, reuse):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_view_frame(view_cfg(approx, reuse), tmp_path)
    events = program_events(prof)
    assert {"frame", "block", "stage1", "stage2", "viewdirs"} <= set(events)
    assert len(events["block"]) == 2
    assert len(events["viewdirs"]) == len(events["composite"]) == 4
    assert inside(events, "viewdirs", "block")
    # stage 1 twice a block, and the sort-first pass's encoding once more
    assert len(events["stage1"]) == (6 if approx and reuse else 4)


def test_training_step_with_view_directions_opens_viewdirs(one_thread):
    cfg = view_cfg()
    ds = make_dataset()
    state = create_train_state(cfg, TC, ds.num_timesteps, device="cpu")
    step_fn = t_step.make_train_step(cfg, TC, RS, ds.has_test_split)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, ds, t_step.step_generator(TC.seed, 0, "cpu"))
    events = program_events(prof)
    assert set(events) == TRAIN_SPANS | {"viewdirs"}
    assert len(events["viewdirs"]) == len(events["composite"]) >= 2
    assert inside(events, "viewdirs", "step")


def test_view_path_spans_are_no_ops_without_a_profiler(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        CountingRange)
    CountingRange.made = 0
    render_view_frame(view_cfg(), tmp_path)
    assert CountingRange.made == 0


@pytest.mark.parametrize("n,count", [(3, 1), (8, 2), (10, 3)])
def test_backward_in_pieces_opens_a_span_a_piece(monkeypatch, n, count):
    monkeypatch.setattr(pieces, "PIECE_POINTS", 4)

    def bwd(x):
        return 2.0 * x, [x.sum(0)]

    x = torch.arange(2.0 * n).reshape(n, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rows, grads = pieces.backward_in_pieces(bwd, x)
    assert torch.equal(rows, 2.0 * x)
    assert torch.equal(grads[0], x.sum(0))
    assert len(program_events(prof)["bwd_piece"]) == count


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """The loader on a fresh cache directory, a compiler that only writes
    its output file, and a ctypes load that takes 20 ms."""
    monkeypatch.setattr(build, "find_nvcc", lambda: sys.executable)
    monkeypatch.setattr(build, "NVCC_FLAGS", (
        "-c", "import sys; open(sys.argv[sys.argv.index('-o') + 1], 'w')"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_INFO", {})
    monkeypatch.setattr(build, "KERNEL_LOAD", {"seconds": 0.0, "compiled": 0})

    def load(path):
        time.sleep(0.02)
        return ("library", path)

    monkeypatch.setattr(build.ctypes, "CDLL", load)
    return build


def test_kernel_load_counter_adds_up_builds_and_loads(stub_build):
    stub_build.load_kernel_libraries(["mlp_fwd.cu", "mlp_bwd.cu"])
    first = dict(stub_build.KERNEL_LOAD)
    assert first["compiled"] == 2
    # two loads of 20 ms each
    assert first["seconds"] >= 0.04
    # loaded already: nothing more is counted
    stub_build.load_kernel_library("mlp_fwd.cu")
    assert stub_build.KERNEL_LOAD == first
    # built already, loaded anew: the load counts, no compile
    stub_build._LIBS.clear()
    stub_build.load_kernel_library("mlp_fwd.cu")
    assert stub_build.KERNEL_LOAD["compiled"] == 2
    assert stub_build.KERNEL_LOAD["seconds"] >= first["seconds"] + 0.02
