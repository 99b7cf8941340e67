"""Device milliseconds a fit step spends in operations that are not the
program's own kernels (the torch d_hist chain, the loss, copies and sets),
from the traced window."""


def read(run):
    if run.unit != "steps" or not run.port_kernels or not run.units:
        return None
    ns = sum(d for name, _, d in run.ops
             if run.short(name) not in run.port_kernels)
    return ns / 1e6 / run.units
