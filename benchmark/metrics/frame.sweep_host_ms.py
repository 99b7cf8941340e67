"""Median host milliseconds a frame inside the port's ``sweep.*`` and
``shearwarp.*`` spans: the torch glue around the kernels (pre-blend,
launch preparation and the launch call, shear-warp's geometry, permuted
copy and warp)."""

from benchmark import program_trace


def _glue(name):
    return name.startswith(("sweep.", "shearwarp."))


def read(run):
    w = program_trace.window(run)
    if w is None or run.unit != "frames" or not run.port_kernels:
        return None
    top = set(w.outermost(_glue))
    return w.median_ms(lambda k: w.spans[k].end_ns - w.spans[k].start_ns
                       if k in top else 0)
