"""Percent of the H100's roofline the window's re-queries of the
flexible-block grid reach: their least time together
(``benchmark/roofline/flex.py``: each distinct corner row of the integral
histogram read once, the stats grid written once) over the device time of
the operations launched under the port's ``flex.requery`` spans."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if (w is None or run.unit != "frames" or not run.port_kernels
            or not run.roofline):
        return None
    ns = sum(v for p, v in w.device_by_span.items()
             if "flex.requery" in p.split(">"))
    return 100.0 * run.roofline["bound_s"] / (ns / 1e9) if ns else None
