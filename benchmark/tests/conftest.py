"""Tests of the benchmark's harness, run on the CPU at sizes a test can hold:

    python -m pytest benchmark/tests -q

The tests marked ``cuda`` run a cell at its own size and skip without a
card (decided inside the ``card`` fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: sizes a test can hold, by configuration
TINY = {
    "fit512_b16": dict(n=16, image=32, reference_chunk=4),
    "isabel_b32": dict(field_shape=[20, 40, 40], block=[4, 4, 4], image=32,
                       kept_frames=4),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell's own size runs on the card")
    return torch.device("cuda")


@pytest.fixture
def card_dispatch(monkeypatch):
    """The dispatch a card makes, on the CPU: shear-warp's 'auto' backend
    takes the fused sweep's path (its plain version on a CPU volume), as it
    does for a volume on the card."""
    from vrdd_tpu_torch.models import pipeline

    real = pipeline.shearwarp_render_image

    def on_card_path(*args, **kw):
        if kw.get("backend") == "auto":
            kw["backend"] = "pallas"
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "shearwarp_render_image", on_card_path)
