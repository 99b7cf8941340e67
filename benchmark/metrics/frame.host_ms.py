"""Median host milliseconds of a frame's call into ``RenderPipeline.render``,
from the call to its return (the harness's span around it)."""

import statistics


def read(run):
    spans = run.spans.get("render")
    if run.unit != "frames" or not spans:
        return None
    return 1e3 * statistics.median(spans)
