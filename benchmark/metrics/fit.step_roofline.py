"""Percent of the H100's roofline a fit step reaches: the least time the
whole fwd+bwd needs (``benchmark/roofline/count.py``: its bytes and
operations counted from the algorithm, the samples by the reference) over
the step's device-busy time in the traced window."""


def read(run):
    if (run.unit != "steps" or not run.port_kernels or run.busy_s <= 0
            or not run.roofline):
        return None
    return 100.0 * run.roofline["bound_s"] / (run.busy_s / run.units)
