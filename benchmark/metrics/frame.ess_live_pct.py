"""Percent of the (tile, chunk) pairs the sweep kernels' ESS test found
live over the traced window (``ess.pairs_live`` of ``ess.pairs_tested``,
counted on the card); 100 less it is the share culled."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if w is None or run.unit != "frames" or not run.port_kernels:
        return None
    tested = w.counters.get("ess.pairs_tested", 0)
    if not tested:
        return None
    return 100.0 * w.counters.get("ess.pairs_live", 0) / tested
