"""`benchmark/harness/spans.py` and the readers of the program's spans and
kernel-load counter, on synthetic traces: nested spans, spans of two
threads, idle stretches split across spans, and what a trace without spans
reads."""

import pytest

from benchmark.harness import cells, spans, spec
from benchmark.harness.trace import Trace


def trace(host, kernels):
    """A Trace of host ops (name, start, end) and kernels (start, end)."""
    return Trace(window_s=1.0, kernels=[("k", s, e) for s, e in kernels],
                 copies=[], host_ops=list(host))


def test_nested_spans_sum_by_name_and_nest_by_time():
    t = trace([("nrnerf/step", 0.0, 10.0), ("nrnerf/stage1", 1.0, 3.0),
               ("aten::mul", 1.5, 2.0), ("nrnerf/stage1", 4.0, 5.0),
               ("nrnerf/adam", 8.0, 9.5), ("nrnerf/step", 10.0, 12.0)], [])
    assert spans.seconds_by_name(t) == {"step": 12.0, "stage1": 3.0,
                                        "adam": 1.5}
    assert spans.count_by_name(t) == {"step": 2, "stage1": 2, "adam": 1}
    assert spans.innermost(spans.program_spans(t)) == [
        (0.0, 1.0, "step"), (1.0, 3.0, "stage1"), (3.0, 4.0, "step"),
        (4.0, 5.0, "stage1"), (5.0, 8.0, "step"), (8.0, 9.5, "adam"),
        (9.5, 10.0, "step"), (10.0, 12.0, "step")]


def test_spans_of_two_threads_nest_by_time():
    # the main thread's backward; autograd's device thread opens the
    # pieces inside it, and one span overlaps another without holding it
    t = trace([("nrnerf/backward", 0.0, 10.0),
               ("nrnerf/bwd_piece", 2.0, 4.0), ("nrnerf/bwd_piece", 4.0, 6.0),
               ("nrnerf/a", 11.0, 14.0), ("nrnerf/b", 12.0, 16.0)], [])
    assert spans.innermost(spans.program_spans(t)) == [
        (0.0, 2.0, "backward"), (2.0, 4.0, "bwd_piece"),
        (4.0, 6.0, "bwd_piece"), (6.0, 10.0, "backward"),
        (10.0, 11.0, None), (11.0, 12.0, "a"), (12.0, 14.0, "b"),
        (14.0, 16.0, "b")]


def test_idle_gap_is_split_across_spans_by_overlap():
    # device busy 0-2 and 8-10; the host ops run from -2 to 11. Idle -2-0:
    # no span, then frame. Idle 2-8: readback (to 3), frame (3-4),
    # frame_rays (4-6), frame (6-6.5), blocks (6.5-7), block (7-8). Idle
    # 10-11: frame
    t = trace([("nrnerf/frame", -1.0, 3.5), ("nrnerf/readback", 1.0, 3.0),
               ("nrnerf/frame", 3.5, 11.0), ("nrnerf/frame_rays", 4.0, 6.0),
               ("nrnerf/blocks", 6.5, 10.0), ("nrnerf/block", 7.0, 9.0),
               ("cudaDeviceSynchronize", -2.0, -1.5)],
              [(0.0, 2.0), (8.0, 10.0)])
    assert spans.idle_intervals(t) == [(-2.0, 0.0), (2.0, 8.0), (10.0, 11.0)]
    idle = spans.idle_by_span(t)
    assert idle == pytest.approx({None: 1.0, "frame": 1.0 + 1.0 + 0.5 + 1.0,
                                  "readback": 1.0, "frame_rays": 2.0,
                                  "blocks": 0.5, "block": 1.0})
    assert sum(idle.values()) == pytest.approx(2.0 + 6.0 + 1.0)


def run_of(kind, t, units=2):
    return cells.Run(kind, {}, {}, "cpu", trace=t, trace_units=units)


def test_readers_of_the_spans():
    t = trace([("nrnerf/step", 0.0, 0.010), ("nrnerf/adam", 0.008, 0.009),
               ("nrnerf/step", 0.010, 0.030), ("nrnerf/adam", 0.028, 0.030)],
              [(0.0, 0.005), (0.012, 0.030)])
    train = run_of("train", t)
    assert spec.reader("host_ms.train")(train) == pytest.approx(15.0)
    assert spec.reader("adam_host_ms.train")(train) == pytest.approx(1.5)
    assert spec.reader("frame_idle_ms.render")(train) is None
    render = run_of("render", trace(
        [("nrnerf/frame", 0.0, 0.010), ("nrnerf/blocks", 0.001, 0.008),
         ("nrnerf/readback", 0.008, 0.010)], [(0.002, 0.007)]))
    # idle: 0-0.001 frame, 0.001-0.002 and 0.007-0.008 blocks, 0.008-0.010
    # readback
    assert spec.reader("frame_idle_ms.render")(render) \
        == pytest.approx(1e3 * 0.003 / 2)
    assert spec.reader("host_ms.train")(render) is None


def test_readers_read_zero_where_the_program_opens_no_span():
    t = trace([("aten::mul", 0.0, 1.0)], [(0.5, 0.7)])
    assert spec.reader("host_ms.train")(run_of("train", t)) == 0.0
    assert spec.reader("adam_host_ms.train")(run_of("train", t)) == 0.0
    assert spec.reader("frame_idle_ms.render")(run_of("render", t)) == 0.0


def test_kernel_load_reader_reads_the_programs_counter(monkeypatch):
    from nonrigid_nerf_torch.ops.kernels import build
    read = spec.reader("kernel_load_s")
    monkeypatch.setattr(build, "KERNEL_LOAD", {"seconds": 2.5, "compiled": 1})
    assert read(run_of("train", None)) == 2.5
    # a program without the counter reads nothing, and no None
    monkeypatch.delattr(build, "KERNEL_LOAD")
    assert read(run_of("render", None)) == 0.0
