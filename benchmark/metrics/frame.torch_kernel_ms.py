"""Device milliseconds a frame spends in operations that are not the
program's own kernels (the pre-blend, the permuted copy, the warp, the
pack and the copy to the host), from the traced window."""


def read(run):
    if run.unit != "frames" or not run.port_kernels or not run.units:
        return None
    ns = sum(d for name, _, d in run.ops
             if run.short(name) not in run.port_kernels)
    return ns / 1e6 / run.units
