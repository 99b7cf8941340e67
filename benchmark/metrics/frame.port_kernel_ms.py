"""Device milliseconds a frame spends in the program's own CUDA kernels
(K1 on an axis view, K3 on a rotated one), from the traced window."""


def read(run):
    if run.unit != "frames" or not run.port_kernels or not run.units:
        return None
    ns = sum(d for name, _, d in run.ops if run.short(name) in run.port_kernels)
    return ns / 1e6 / run.units if ns else None
