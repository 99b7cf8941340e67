"""Percent of the traced window's idle device time during which a span of
the program was the innermost open one (not the harness's own span, not
outside every span), on the device trace's clock."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if (w is None or run.unit != "frames" or not run.port_kernels
            or not w.idle_ns):
        return None
    inside = sum(v for p, v in w.idle_by_span.items() if w.is_program(p))
    return 100.0 * inside / w.idle_ns
