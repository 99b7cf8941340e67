"""Host waits a frame: the program's blocking reads from the card and
uploads from pageable memory (``sync.*`` of the port's tracer), over the
traced window's frames."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if w is None or run.unit != "frames" or not run.port_kernels:
        return None
    return w.count("sync.") / w.units
