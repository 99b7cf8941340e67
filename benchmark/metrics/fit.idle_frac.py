"""Percent of the traced window of fit steps in which no operation ran on
the device."""


def read(run):
    if run.unit != "steps" or not run.port_kernels or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
