"""The program's own spans and counters in a ``--trace 1`` run, on the
device trace's clock.

The port's tracer (``vrdd_tpu_torch.utils.profiling``) records spans on
``time.perf_counter_ns`` and counts host waits, launches and the ESS
test's pairs; this module joins them to the traced window. The readers of
the metrics that read them import it, and the import installs two hooks
(a program without the tracer, such as an older checkout, gets none, and
the readers then return None):

- the window's profiler (``trace.profiler``) enables the tracer when it
  starts and drains it when it stops, and samples the offset of
  ``perf_counter_ns`` from the clock of the kineto events beside the
  window;
- each kind's ``Cell.step`` sets the unit id (``profiling.unit``) and
  runs under a span of the harness's own, ``harness.frame`` or
  ``harness.step``, so that the time outside the program is named too.

:func:`window` gives the readers the joined record (:class:`Window`):
the spans and counters, the window's idle time split over the innermost
span open at each instant (``idle_by_span``), the device time of each
operation attributed through its correlation id to the innermost span
open at its launch (``device_by_span``), and the clock check: the share of
the port's kernel launches whose runtime event falls inside a
``sweep.launch`` span. It prints them on standard error once.
"""

from __future__ import annotations

import bisect
import collections
import heapq
import importlib
import json
import pkgutil
import statistics
import sys
import time

from benchmark import trace

try:
    from vrdd_tpu_torch.utils import profiling
except ImportError:  # a checkout without the port
    profiling = None

#: whether the program has the tracer this module reads
READY = profiling is not None and hasattr(profiling, "drain")
#: spans of the harness's own, by the kind's unit
HARNESS = {"frames": "harness.frame", "steps": "harness.step"}
#: idle or device time under no span
OUTSIDE = "outside"
#: device operations that moved data through pageable host memory
PAGEABLE = ("Memcpy HtoD (Pageable", "Memcpy DtoH (Device -> Pageable")
#: entries kept of each breakdown
TOP_N = 10

_state = {}


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _clock_offset() -> int:
    """``time_ns - perf_counter_ns`` read beside each other, the pair with
    the shortest bracket of five: the offset of the kineto events' clock
    (Unix nanoseconds) from the tracer's."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _Profiler:
    """The window's profiler with the tracer beside it: enabled at its
    start, drained at its stop."""

    def __init__(self, prof, device_type):
        self._prof, self._device_type = prof, device_type

    def __getattr__(self, name):
        return getattr(self._prof, name)

    def start(self):
        _state.clear()
        self._prof.start()
        profiling.enable()
        _state["offset0"] = _clock_offset()
        _state["t0"] = time.perf_counter_ns()

    def stop(self):
        t1 = time.perf_counter_ns()
        _state["offset1"] = _clock_offset()
        profiling.disable()
        self._prof.stop()
        spans, counters = profiling.drain()
        _state.update(t1=t1, spans=spans, counters=counters, prof=self._prof,
                      device_type=self._device_type)


def _step_in_unit(step, name):
    def stepped(self, i, spans):
        profiling.unit(i)
        with profiling.annotate(name):
            return step(self, i, spans)

    stepped.in_unit = True
    return stepped


def install() -> None:
    """The two hooks, once; nothing for a program without the tracer."""
    if not READY or getattr(trace.profiler, "program_trace", False):
        return
    real = trace.profiler

    def profiler(device_type):
        return _Profiler(real(device_type), device_type)

    profiler.program_trace = True
    trace.profiler = profiler
    import benchmark.kinds as kinds

    for mod in pkgutil.iter_modules(kinds.__path__):
        cell = getattr(importlib.import_module(f"benchmark.kinds.{mod.name}"),
                       "Cell", None)
        if cell is None or getattr(cell.step, "in_unit", False):
            continue
        cell.step = _step_in_unit(cell.step, HARNESS.get(cell.unit,
                                                         "harness.step"))


# ---- the joined record ------------------------------------------------------

def paths(spans) -> list:
    """Each span's path of names from its root, ``a>b>c``."""
    out = []
    for s in spans:
        out.append(s.name if s.parent < 0 else f"{out[s.parent]}>{s.name}")
    return out


def innermost(spans, offset: int = 0):
    """``(starts, owners)``: the timeline cut where the innermost open span
    changes, ``owners[k]`` the index of the span open latest (across
    threads) from ``starts[k]`` to ``starts[k + 1]``, or -1 for none;
    times shifted by ``offset``."""
    events = []
    for k, s in enumerate(spans):
        if s.end_ns > s.start_ns:
            events.append((s.start_ns + offset, 1, k))
            events.append((s.end_ns + offset, 0, k))
    events.sort()
    heap, closed, starts, owners = [], set(), [], []
    for t, opens, k in events:
        if opens:  # the later start, and of equal starts the child, wins
            heapq.heappush(heap, (-spans[k].start_ns, -k))
        else:
            closed.add(k)
        while heap and -heap[0][1] in closed:
            heapq.heappop(heap)
        owner = -heap[0][1] if heap else -1
        if starts and starts[-1] == t:
            owners[-1] = owner
        elif not owners or owners[-1] != owner:
            starts.append(t)
            owners.append(owner)
    return starts, owners


def owner_at(timeline, t: int) -> int:
    """The innermost span open at ``t`` (-1 for none)."""
    starts, owners = timeline
    k = bisect.bisect_right(starts, t) - 1
    return owners[k] if k >= 0 else -1


def split_over_spans(intervals, timeline, names) -> dict:
    """Nanoseconds of each ``(start, end)`` interval by the path of the
    innermost span open over it (``names[k]``, or :data:`OUTSIDE`)."""
    starts, owners = timeline
    out = collections.defaultdict(int)
    for a, b in intervals:
        k = bisect.bisect_right(starts, a) - 1  # -1: before the first cut
        t = a
        while t < b:
            owner = owners[k] if k >= 0 else -1
            end = min(starts[k + 1], b) if k + 1 < len(starts) else b
            out[names[owner] if owner >= 0 else OUTSIDE] += end - t
            t, k = end, k + 1
    return dict(out)


def idle_intervals(ops, lo: int, hi: int) -> list:
    """The parts of ``[lo, hi]`` in which no operation ran."""
    out, t = [], lo
    for s, e, *_ in trace.busy_intervals(ops):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def _top(d: dict, scale: float = 1e-9) -> list:
    return [[k, v * scale] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:TOP_N]]


class Window:
    """The traced window's spans and counters joined to its device trace
    (module docstring). Times in nanoseconds on the tracer's clock unless
    named otherwise."""

    def __init__(self, run, state: dict):
        self.run = run
        self.spans = state["spans"]
        self.counters = state["counters"]
        self.names = paths(self.spans)
        self.units = max(1, run.units)
        self.device, self.launches = self._events(state["prof"],
                                                  state["device_type"])
        self.offset = (state["offset0"] + state["offset1"]) // 2
        self.drift_ns = state["offset1"] - state["offset0"]
        self.timeline = innermost(self.spans, self.offset)
        times = self._port_launches()
        self.clock_n = len(times)
        self.clock_in = sum(self.names[k].endswith("sweep.launch")
                            for k in (owner_at(self.timeline, t)
                                      for t in times) if k >= 0)
        self.child_ns = collections.defaultdict(int)
        for s in self.spans:
            if s.parent >= 0 and s.end_ns:
                self.child_ns[s.parent] += s.end_ns - s.start_ns
        lo, hi = state["t0"] + self.offset, state["t1"] + self.offset
        idle = idle_intervals(
            [(n, s, d) for n, s, d, _ in self.device], lo, hi)
        self.idle_ns = sum(b - a for a, b in idle)
        self.idle_by_span = split_over_spans(idle, self.timeline, self.names)
        self.device_by_span = collections.defaultdict(int)
        self.op_by_span = collections.defaultdict(int)
        self.pageable = collections.Counter()
        for name, start, dur, corr in self.device:
            k = owner_at(self.timeline, self.launches.get(corr, start))
            path = self.names[k] if k >= 0 else OUTSIDE
            self.device_by_span[path] += dur
            self.op_by_span[f"{trace.short(name)} @ {path}"] += dur
            if name.startswith(PAGEABLE):
                self.pageable[path] += 1

    @staticmethod
    def _events(prof, device_type):
        """``([(name, start, duration, correlation)] of the device's
        operations, {correlation: host start of its launch})``: on the CPU
        an operation is its own launch."""
        from torch.autograd import DeviceType

        want = DeviceType.CUDA if device_type == "cuda" else DeviceType.CPU
        device, launches = [], {}
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            corr = e.correlation_id()
            if e.device_type() == want:
                if dur > 0:
                    device.append((e.name(), start, dur, corr))
                if want == DeviceType.CPU:
                    launches[corr] = start
            elif corr and e.device_type() == DeviceType.CPU:
                launches.setdefault(corr, start)
        device.sort(key=lambda o: o[1])
        return device, launches

    def _port_launches(self) -> list:
        port = self.run.port_kernels
        return [self.launches[c] for n, _, _, c in self.device
                if self.run.short(n) in port and c in self.launches]

    # -- per unit ---------------------------------------------------------

    def per_unit(self, fn) -> list:
        """``fn(span index)`` summed over the spans of each unit of the
        window, one value a unit."""
        by = collections.defaultdict(int)
        for k, s in enumerate(self.spans):
            if s.unit >= 0 and s.end_ns:
                by[s.unit] += fn(k)
        return [by[u] for u in sorted(by)]

    def self_ns(self, k: int) -> int:
        """Span ``k``'s length less its children's (its own thread's)."""
        s = self.spans[k]
        return (s.end_ns - s.start_ns) - self.child_ns[k]

    def outermost(self, pred) -> list:
        """The spans whose name satisfies ``pred`` and no ancestor's does."""
        out = []
        for k, s in enumerate(self.spans):
            if not pred(s.name):
                continue
            p = s.parent
            while p >= 0 and not pred(self.spans[p].name):
                p = self.spans[p].parent
            if p < 0:
                out.append(k)
        return out

    def median_ms(self, fn) -> float | None:
        vals = self.per_unit(fn)
        return statistics.median(vals) / 1e6 if vals else None

    def count(self, prefix: str) -> int:
        return sum(v for k, v in self.counters.items()
                   if k.startswith(prefix))

    def host_ms_by_path(self) -> dict:
        """Median self milliseconds a unit of each span path."""
        by = collections.defaultdict(lambda: collections.defaultdict(int))
        for k, s in enumerate(self.spans):
            if s.unit >= 0 and s.end_ns:
                by[self.names[k]][s.unit] += self.self_ns(k)
        units = {s.unit for s in self.spans if s.unit >= 0}
        return {p: statistics.median([v.get(u, 0) for u in units]) / 1e6
                for p, v in by.items()}

    def is_program(self, path: str) -> bool:
        return path != OUTSIDE and not path.split(">")[-1].startswith(
            "harness.")

    def report(self) -> None:
        """The breakdowns on standard error."""
        note(f"trace: clock check {self.clock_in}/{self.clock_n} port "
             f"launches inside sweep.launch (offset {self.offset} ns, drift "
             f"over the window {self.drift_ns} ns)")
        note("trace: idle_by_span " + json.dumps(
            _top(self.idle_by_span)) + f" of {self.idle_ns / 1e9:.6f} s idle")
        note("trace: device_by_span " + json.dumps(_top(self.device_by_span)))
        note("trace: device ops by span " + json.dumps(_top(self.op_by_span)))
        host = sorted(self.host_ms_by_path().items(), key=lambda kv: -kv[1])
        note(f"trace: {len(self.spans) / self.units} spans a unit; host self "
             "ms a unit by span " + json.dumps(
            [[p, round(v, 6)] for p, v in host[:2 * TOP_N]]))
        syncs = {k: v / self.units for k, v in sorted(self.counters.items())
                 if k.startswith(("sync.", "upload."))}
        in_program = sum(v for p, v in self.pageable.items()
                         if self.is_program(p))
        note(f"trace: syncs a unit {json.dumps(syncs)}; pageable memcpys a "
             f"unit inside program spans {in_program / self.units}, by span "
             + json.dumps({p: v / self.units
                           for p, v in self.pageable.items()}))
        note("trace: counters " + json.dumps(
            {k: v for k, v in sorted(self.counters.items())
             if not k.startswith(("sync.", "upload."))}))


def window(run):
    """The traced window's :class:`Window`, or None where the program has
    no tracer or it recorded no span (reported on the first call)."""
    if not READY or not _state.get("spans"):
        return None
    if _state.get("run") is not run:
        _state["run"] = run
        _state["window"] = Window(run, _state)
        _state["window"].report()
    return _state["window"]


install()
