"""Profiling: the port's spans and counters, and device traces (counterpart
of ``vrdd_tpu/utils/profiling.py``).

**The tracer.** Off by default. :func:`annotate` is the port's span: off,
it returns one shared no-op context manager (no clock read, no allocation,
no dispatcher call); on (:func:`enable`), each span appends one record to
an in-memory list, a :class:`Span` of its name, its start and end on
``time.perf_counter_ns()``, the index of its parent (the enclosing open
span on the same thread, -1 for none) and the unit id that
:func:`unit` set (the frame or step number: every span of one unit shares
it). Inside :func:`device_trace` (a ``torch.profiler`` session that
records the host's operators) a span also enters
``torch.profiler.record_function``, on or off, so the Chrome trace shows
the same regions beside the kernels. As a decorator, ``@annotate`` names
the span after the function.

:func:`count` adds to a host counter; :func:`watch` registers the plain
int launch attributes of a kernel wrapper (``k1.launches``,
``k4.staged_launches``, ...), which the tracer reads rather than counts
again. :func:`to_host` and :func:`to_device` are the frame and fit paths'
only ways between host and card: on, they count ``sync.<site>`` for a
blocking read or a pageable upload (which waits for the work queued on the
stream) and ``upload.pinned.<site>`` for a pinned one. On the card the ESS
test of the sweep kernels adds the (tile, chunk) pairs it tested and found
live to a buffer of :func:`ess_counts` (null when off), read once, by
:func:`drain`: ``ess.pairs_tested`` and ``ess.pairs_live``.

:func:`drain` returns ``(spans, counters)`` and starts both afresh: the
counters hold the host counts, the watched attributes' increase since
:func:`enable` (or the last drain), and the ESS pairs.

Plus the wall-clock StageTimer (``vrdd_tpu_torch.utils.timing``) for coarse
set-up stages.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from pathlib import Path
from typing import Iterator, NamedTuple

import torch


class Span(NamedTuple):
    """One span of the tracer: host nanoseconds on ``perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int


class _Off:
    """The shared no-op span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Off()


class _Tracer:
    """The process's tracer (one: spans nest across the whole port)."""

    def __init__(self):
        self.on = False
        self.records = []  # [name, start, end, parent, unit] a span
        self.counters = collections.Counter()
        self.unit = -1
        self.local = threading.local()  # .stack: open span indices
        self.watched = {}  # counter name -> (object, attribute)
        self.base = {}
        self.ess = {}  # device -> int64 (2,) pairs tested, live
        self.mirror = False  # inside device_trace: spans as record_function
        # spans and counts come from the autograd engine's threads too
        self.lock = threading.Lock()

    def snapshot(self) -> dict:
        return {k: getattr(o, a) for k, (o, a) in self.watched.items()}

    def reset(self):
        self.records = []
        self.counters = collections.Counter()
        self.base = self.snapshot()
        for buf in self.ess.values():
            buf.zero_()


_T = _Tracer()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_T.local, "stack", None)
        if stack is None:
            stack = _T.local.stack = []
        self.rec = [self.name, 0, 0, stack[-1] if stack else -1, _T.unit]
        with _T.lock:
            stack.append(len(_T.records))
            _T.records.append(self.rec)
        self.rf = None
        if _T.mirror:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec[1] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _T.local.stack.pop()
        return False


def annotate(name):
    """The port's span: ``with annotate("sweep.prepare"): ...``; the shared
    no-op while the tracer is off, outside :func:`device_trace`.
    ``@annotate`` on a function spans each call under its qualified name."""
    if callable(name):
        fn, label = name, name.__qualname__

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(label):
                return fn(*args, **kwargs)

        return spanned
    if _T.on:
        return _Span(name)
    if _T.mirror:
        return torch.profiler.record_function(name)
    return _NOOP


def enabled() -> bool:
    """Whether the tracer records."""
    return _T.on


def enable() -> None:
    """Start recording spans and counters, from nothing."""
    _T.reset()
    _T.unit = -1
    _T.on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`drain`."""
    _T.on = False


def unit(i: int) -> None:
    """The unit id (frame or step number) of the spans that start next."""
    _T.unit = int(i)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` (nothing while off)."""
    if _T.on:
        with _T.lock:
            _T.counters[name] += n


def watch(prefix: str, obj, attrs) -> None:
    """Report ``obj``'s int attributes ``attrs`` as the counters
    ``<prefix>.<attr>``: their increase over a traced window."""
    for a in attrs:
        _T.watched[f"{prefix}.{a}"] = (obj, a)


def ess_counts(dev: torch.device):
    """The ESS test's ``int64 (2,)`` pair counts on ``dev`` (tested, live)
    for a sweep launch to add to, or None while the tracer is off."""
    if not _T.on:
        return None
    buf = _T.ess.get(dev)
    if buf is None:
        buf = _T.ess[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return buf


def drain():
    """``(spans, counters)`` recorded since :func:`enable` or the last
    drain, and a fresh start: a list of :class:`Span` in start order (a
    span still open has ``end_ns`` 0) and a dict of counts. Reads the ESS
    pair counts back from the card: one wait, after the window."""
    spans = [Span(*r) for r in _T.records]
    counters = dict(_T.counters)
    now = _T.snapshot()
    for k, v in now.items():
        counters[k] = v - _T.base.get(k, 0)
    for buf in _T.ess.values():
        for name, n in zip(("ess.pairs_tested", "ess.pairs_live"),
                           buf.tolist()):
            counters[name] = counters.get(name, 0) + n
    _T.reset()
    return spans, counters


def to_host(t, site: str):
    """``t`` on the host: a CUDA tensor is copied back, which waits for
    the work queued before it (counted as ``sync.<site>``); anything else
    is returned as it is."""
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        count("sync." + site)
        return t.cpu()
    return t


def to_device(x, dev, site: str, *, dtype=None, pinned: bool = False):
    """Host data ``x`` (a CPU tensor, array, sequence or number) as a
    tensor of ``dtype`` on ``dev`` (None: torch's default device). To the
    card, ``pinned`` copies it into pinned memory and uploads it without
    blocking (``upload.pinned.<site>``); otherwise the upload is from
    pageable memory and waits for the work queued on the stream
    (``sync.<site>``). A tensor already on a card is not a transfer: it is
    converted where it is, uncounted."""
    kind = dev.type if isinstance(dev, torch.device) else (
        None if dev is None else torch.device(dev).type)
    if kind != "cuda" or (isinstance(x, torch.Tensor)
                          and x.device.type != "cpu"):
        return torch.as_tensor(x, dtype=dtype, device=dev)
    if pinned:
        count("upload.pinned." + site)
        host = torch.as_tensor(x, dtype=dtype)
        return host.pin_memory().to(dev, non_blocking=True)
    count("sync." + site)
    return torch.as_tensor(x, dtype=dtype, device=dev)


@contextlib.contextmanager
def device_trace(log_dir: str = "vrdd_trace") -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block with ``torch.profiler`` and write it to
    ``<log_dir>/trace.json`` (Chrome trace format): the host's operators,
    the kernels, and the port's spans (:func:`annotate`) as regions beside
    them. Yields the profiler, whose ``key_averages()`` summarise the run."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    mirror, _T.mirror = _T.mirror, True
    try:
        yield prof
    finally:
        _T.mirror = mirror
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_compilation_cache(path: str = "") -> Path:
    """No torch counterpart to enable: the port runs eagerly and compiles
    nothing at run time but its CUDA kernels, which ``kernels/_build.py``
    already keeps, keyed by a hash of their sources, in
    ``vrdd_tpu_torch/_build/``. Kept for the JAX package's API; ``path`` is
    ignored and the build directory returned."""
    from vrdd_tpu_torch.kernels._build import BUILD_DIR

    return BUILD_DIR
