"""Median host milliseconds a fit step spends inside the port's
``voxel_fit.view`` spans: the forward of every view (both channels'
renders, from the channel slice to the warped image), as the host
enqueues it."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if w is None or run.unit != "steps":
        return None
    return w.median_ms(lambda k: w.spans[k].end_ns - w.spans[k].start_ns
                       if w.spans[k].name == "voxel_fit.view" else 0)
