"""GiB the program held at most on the device during the window of fit
steps (``max_memory_allocated`` after a reset at the window's start)."""


def read(run):
    if run.unit != "steps" or not run.counters.get("window_peak_bytes"):
        return None
    return run.counters["window_peak_bytes"] / 2 ** 30
