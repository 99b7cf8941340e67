"""Profiling helpers (counterpart of ``vrdd_tpu/utils/profiling.py``).

Device traces through ``torch.profiler`` (the CPU side always, the CUDA
side when a GPU is present), viewable in Perfetto or ``chrome://tracing``,
plus the wall-clock StageTimer (``vrdd_tpu_torch.utils.timing``) for coarse
stage accounting.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str = "vrdd_trace") -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block with ``torch.profiler`` and write it to
    ``<log_dir>/trace.json`` (Chrome trace format). Annotate hot regions
    inside the block with :func:`annotate`. Yields the profiler, whose
    ``key_averages()`` summarise the run."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named trace region: ``with annotate("decode"): ...``."""
    return torch.profiler.record_function(name)


def enable_compilation_cache(path: str = "") -> Path:
    """No torch counterpart to enable: the port runs eagerly and compiles
    nothing at run time but its CUDA kernels, which ``kernels/_build.py``
    already keeps, keyed by a hash of their sources, in
    ``vrdd_tpu_torch/_build/``. Kept for the JAX package's API; ``path`` is
    ignored and the build directory returned."""
    from vrdd_tpu_torch.kernels._build import BUILD_DIR

    return BUILD_DIR
