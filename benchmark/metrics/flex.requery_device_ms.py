"""Device milliseconds a re-query of the flexible-block grid takes: the
device time of the operations launched under the port's ``flex.requery``
spans (the corners, the query of the integral histogram, the stats), over
the traced window's re-queries (``flex.requeries``)."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if w is None or run.unit != "frames" or not run.port_kernels:
        return None
    n = w.counters.get("flex.requeries", 0)
    ns = sum(v for p, v in w.device_by_span.items()
             if "flex.requery" in p.split(">"))
    return ns / 1e6 / n if n and ns else None
