"""The device's side of a traced window, read from ``torch.profiler``.

The window is profiled with device activity only (kernels, copies and
sets), so the host's operators pay no recording cost; the harness's own
spans say what the host did. Each device operation becomes ``(name,
start_ns, duration_ns)``; the busy time is the union of their intervals.
"""

from __future__ import annotations

import re
from collections import defaultdict

#: what a name of a device operation is kept to in the breakdown
NAME_CHARS = 160


def profiler(device_type: str):
    """A profiler of the device's operations (of the host's, on the CPU,
    where there is no device)."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if device_type == "cuda" else ProfilerActivity.CPU
    return profile(activities=[act])


def device_ops(prof, device_type: str) -> list:
    """``[(name, start_ns, duration_ns)]`` of the operations on the device
    (on the host's operators for a CPU run), in start order."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device_type == "cuda" else DeviceType.CPU
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = 1000 * e.start_us(), 1000 * e.duration_us()
        if dur > 0:
            ops.append((e.name(), int(start), int(dur)))
    ops.sort(key=lambda o: o[1])
    return ops


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, ``[(start, end, first,
    last)]`` with the names of the first and last operation in each."""
    out = []
    for name, start, dur in ops:
        end = start + dur
        if out and start <= out[-1][1]:
            s, e, first, last = out[-1]
            out[-1] = (s, max(e, end), first, name if end >= e else last)
        else:
            out.append((start, end, name, name))
    return out


def short(name: str) -> str:
    """A kernel's function name without its namespace, template arguments
    and parameters: ``void (anonymous namespace)::f<1, true>(P)`` -> ``f``."""
    bare = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", bare, 1)[0]
    return head.rsplit("::", 1)[-1].strip() or name[:NAME_CHARS]


def summary(ops, window_s: float, top_n: int = 10) -> dict:
    """Busy seconds, device operations by total time, and the longest idle
    gaps named by the operations on either side (the host was between
    them: its spans say in which layer)."""
    spans = busy_intervals(ops)
    busy_ns = sum(e - s for s, e, *_ in spans)
    by_name = defaultdict(float)
    for name, _, dur in ops:
        by_name[name[:NAME_CHARS]] += dur / 1e9
    gaps = defaultdict(float)
    for (_, e0, _, last), (s1, _, first, _) in zip(spans, spans[1:]):
        gaps[f"after {short(last)} before {short(first)}"] += (s1 - e0) / 1e9
    if spans:
        edges = window_s - (spans[-1][1] - spans[0][0]) / 1e9
        if edges > 0:
            gaps["before the first and after the last operation"] += edges

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top_n]]

    return {"busy_s": busy_ns / 1e9, "device_ops": top(by_name),
            "idle_gaps": top(gaps)}


def kernel_names(sources) -> set:
    """Names of the ``__global__`` functions defined in CUDA sources: the
    kernels of the program's own library."""
    names = set()
    for src in sources:
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            i = m.end()
            if text.startswith("__launch_bounds__", i):
                depth, i = 0, text.index("(", i)
                while True:
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    i += 1
                    if depth == 0:
                        break
            name = re.match(r"\s*(\w+)\s*\(", text[i:])
            if name:
                names.add(name.group(1))
    return names
