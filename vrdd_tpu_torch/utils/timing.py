"""Per-stage wall timing (counterpart of ``vrdd_tpu/utils/timing.py``).

Stages wait for the device before the clock stops: every CUDA tensor in a
stage's result synchronises its device (where JAX calls
``block_until_ready``), so a stage's time is the work's, not its enqueue's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

import torch


def _leaves(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def _block(x: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``x``."""
    for dev in {t.device for t in _leaves(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Collects named stage durations; drop-in for the flex-pipeline profiler."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result: Optional[Any] = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and wait for its output, recording wall time under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block(out)
        self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)
        return out

    def report(self) -> str:
        return "\n".join(f"{k}: {v * 1e3:.3f} ms" for k, v in self.stages.items())

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)

