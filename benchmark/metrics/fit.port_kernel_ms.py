"""Device milliseconds a fit step spends in the program's own CUDA kernels
(the ``__global__`` functions of its library: K4, K5 and the rest), from
the traced window."""


def read(run):
    if run.unit != "steps" or not run.port_kernels or not run.units:
        return None
    ns = sum(d for name, _, d in run.ops if run.short(name) in run.port_kernels)
    return ns / 1e6 / run.units if ns else None
