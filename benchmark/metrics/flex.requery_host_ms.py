"""Median host milliseconds of a re-query of the flexible-block grid: the
port's ``flex.requery`` span, from the call into
``IntegralVolume.blocks`` to its return (the work enqueued, not waited
for)."""

import statistics

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if w is None or run.unit != "frames":
        return None
    ns = [s.end_ns - s.start_ns for s in w.spans
          if s.name == "flex.requery" and s.end_ns]
    return statistics.median(ns) / 1e6 if ns else None
