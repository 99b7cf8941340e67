"""Device kernels launched a fit step, counted in the traced window
(copies and sets left out)."""


def read(run):
    if run.unit != "steps" or not run.port_kernels or not run.units:
        return None
    kernels = [n for n, _, _ in run.ops
               if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels) / run.units
