"""The program's spans and counters joined to the device trace
(``benchmark/program_trace.py``), and the readers of the metrics that read
them, on hand-made records: two frames of spans, device operations with
their launches' correlation ids, counters."""

import pytest
from torch.autograd import DeviceType

from benchmark import harness, program_trace, trace
from benchmark.tests.conftest import ROOT
from vrdd_tpu_torch.utils.profiling import Span

KERNEL = "void (anonymous namespace)::slice_sweep_staged<0, float>(P)"
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"

#: two frames: harness.frame > pipeline.render > sweep.* and pipeline.pack
SPANS = [
    Span("harness.frame", 0, 100, -1, 0),
    Span("pipeline.render", 10, 80, 0, 0),
    Span("sweep.prepare", 20, 40, 1, 0),
    Span("sweep.launch", 40, 50, 1, 0),
    Span("pipeline.pack", 60, 70, 1, 0),
    Span("harness.frame", 100, 200, -1, 1),
    Span("pipeline.render", 110, 190, 5, 1),
    Span("sweep.launch", 140, 150, 6, 1),
]
COUNTERS = {"sync.preblend": 6, "upload.pinned.zs": 2, "k1.launches": 2,
            "ess.pairs_tested": 10, "ess.pairs_live": 4}


class _Event:
    def __init__(self, name, start, dur, corr, dev):
        self._v = (name, start, dur, corr, dev)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


class _Prof:
    """What the join reads of a profiler: its kineto events."""

    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {
            "events": lambda _self: events})()


def _events():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    return [
        # the runtime's launches, on the host
        _Event("cudaLaunchKernel", 41, 2, 1, cpu),
        _Event("cudaMemcpyAsync", 22, 2, 2, cpu),
        _Event("cudaLaunchKernel", 145, 2, 3, cpu),
        # what they ran on the device
        _Event(KERNEL, 45, 30, 1, cuda),
        _Event(PAGEABLE, 25, 5, 2, cuda),
        _Event(KERNEL, 150, 10, 3, cuda),
    ]


class _Run:
    unit = "frames"
    units = 2
    port_kernels = {"slice_sweep_staged"}
    short = staticmethod(trace.short)


@pytest.fixture
def recorded(monkeypatch):
    """A window of two frames from -10 to 200 ns, as the profiler's hook
    leaves it."""
    state = dict(spans=SPANS, counters=dict(COUNTERS), prof=_Prof(_events()),
                 device_type="cuda", t0=-10, t1=200, offset0=0, offset1=0)
    monkeypatch.setattr(program_trace, "_state", state)
    monkeypatch.setattr(program_trace, "READY", True)
    return _Run()


def test_idle_splits_over_the_innermost_span(recorded):
    """Idle time, [-10, 25] [30, 45] [75, 150] [160, 200], goes to the
    innermost span open over each part, across nesting and frames, and to
    ``outside`` before the first span; the parts sum to the idle time."""
    w = program_trace.window(recorded)
    r, h = "harness.frame>pipeline.render", "harness.frame"
    assert w.idle_ns == 35 + 15 + 75 + 40
    assert w.idle_by_span == {
        "outside": 10, h: 10 + 20 + 10 + 10, r: 10 + 5 + 30 + 30,
        f"{r}>sweep.prepare": 5 + 10, f"{r}>sweep.launch": 5 + 10}
    assert sum(w.idle_by_span.values()) == w.idle_ns


def test_a_launch_inside_a_span_gets_its_kernels_time(recorded):
    """Device time goes, through the correlation id, to the span open at
    the launch on the host, not at the operation's own start."""
    w = program_trace.window(recorded)
    r = "harness.frame>pipeline.render"
    assert dict(w.device_by_span) == {f"{r}>sweep.launch": 30 + 10,
                                      f"{r}>sweep.prepare": 5}
    assert (w.clock_in, w.clock_n) == (2, 2)
    assert w.pageable == {f"{r}>sweep.prepare": 1}


def test_split_over_spans_outside_and_nested():
    spans = [Span("a", 10, 50, -1, 0), Span("b", 20, 30, 0, 0)]
    names = program_trace.paths(spans)
    timeline = program_trace.innermost(spans)
    got = program_trace.split_over_spans([(0, 60)], timeline, names)
    assert got == {"outside": 10 + 10, "a": 10 + 20, "a>b": 10}


def test_later_span_of_another_thread_is_innermost():
    """A span opened on another thread (the autograd engine's backward)
    inside a harness span owns its time."""
    spans = [Span("harness.step", 0, 100, -1, 0),
             Span("hist_diff.backward", 30, 60, -1, 0)]
    timeline = program_trace.innermost(spans)
    assert program_trace.owner_at(timeline, 40) == 1
    assert program_trace.owner_at(timeline, 70) == 0
    assert program_trace.owner_at(timeline, 100) == -1


READINGS = {
    # render's self time: 70 - 40 and 80 - 10 ns; median 50 ns
    "frame.pipeline_self_ms": 50e-6,
    # the outermost sweep.* spans: 30 and 10 ns a frame
    "frame.sweep_host_ms": 20e-6,
    "frame.syncs": 3.0,
    "frame.ess_live_pct": 40.0,
    "frame.idle_in_program_pct": 100.0 * (75 + 15 + 15) / 165,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_frame_readers(recorded, name):
    got = harness.load_reader(ROOT, name)(recorded)
    assert got == pytest.approx(READINGS[name])


def test_fit_syncs_reads_steps(recorded):
    read = harness.load_reader(ROOT, "fit.syncs")
    assert read(recorded) is None  # a frame cell's run
    recorded.unit = "steps"
    assert read(recorded) == pytest.approx(3.0)


@pytest.mark.parametrize("name", sorted(READINGS) + ["fit.syncs"])
def test_readers_are_silent_without_records(monkeypatch, name):
    """An older program (no tracer) or a run without a window: None."""
    monkeypatch.setattr(program_trace, "_state", {})
    assert harness.load_reader(ROOT, name)(_Run()) is None


def test_no_pairs_tested_reads_nothing(recorded):
    del recorded  # the fixture's window, without ESS pairs
    program_trace._state["counters"].pop("ess.pairs_tested")
    assert harness.load_reader(ROOT, "frame.ess_live_pct")(_Run()) is None
