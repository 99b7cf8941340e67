"""GiB a fit step copies to make shear-warp's permuted channels contiguous
(``shearwarp.copy_bytes`` of the port's tracer: the bytes each copy writes;
it reads as many)."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    copied = None if w is None else w.counters.get("shearwarp.copy_bytes")
    if copied is None or run.unit != "steps":
        return None
    return copied / w.units / 2 ** 30
