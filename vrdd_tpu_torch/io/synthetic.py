"""Synthetic datasets (counterpart of ``vrdd_tpu/io/synthetic.py``).

Deterministic from a seed: numpy for host arrays the tests share with the
JAX package, torch on the device for the full-size fixture.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gaussian_blob_volume(
    shape: Tuple[int, int, int] = (64, 64, 64),
    n_blobs: int = 4,
    seed: int = 0,
    device=None,
):
    """Sum-of-Gaussians scalar volume in [0, 1] (the 64^3 scalar config of
    BASELINE.json): a float32 numpy array, or with ``device`` a float32
    tensor computed there in float64 from the same seeded centres, widths
    and amplitudes (at 256^3 the host meshgrids take seconds and over a GB;
    the two agree to float32 rounding)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    if device is not None:
        f64 = dict(dtype=torch.float64, device=device)
        z, y, x = (torch.linspace(0, 1, n, **f64) for n in shape)
        vol = torch.zeros(shape, **f64)
        for _ in range(n_blobs):
            c = rng.uniform(0.2, 0.8, size=3)
            s = rng.uniform(0.05, 0.2)
            a = rng.uniform(0.5, 1.0)
            vol += a * torch.exp(
                -(((z - c[0]) ** 2)[:, None, None] + ((y - c[1]) ** 2)[:, None]
                  + (x - c[2]) ** 2) / (2 * s * s))
        return (vol / vol.max()).to(torch.float32)
    z, y, x = np.meshgrid(
        np.linspace(0, 1, nz), np.linspace(0, 1, ny), np.linspace(0, 1, nx),
        indexing="ij",
    )
    vol = np.zeros(shape, dtype=np.float64)
    for _ in range(n_blobs):
        c = rng.uniform(0.2, 0.8, size=3)
        s = rng.uniform(0.05, 0.2)
        a = rng.uniform(0.5, 1.0)
        vol += a * np.exp(
            -((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) / (2 * s * s)
        )
    vol /= vol.max()
    return vol.astype(np.float32)


def random_histogram_volume(
    shape: Tuple[int, int, int] = (10, 50, 50),
    n_bins: int = 32,
    seed: int = 0,
    concentration: float = 0.5,
) -> np.ndarray:
    """Random normalized per-block histograms (Dirichlet), Isabel-shaped default."""
    rng = np.random.default_rng(seed)
    h = rng.gamma(concentration, size=(*shape, n_bins)).astype(np.float32)
    h /= h.sum(axis=-1, keepdims=True)
    return h


def blob_histogram_volume(
    n: int, B: int = 16, device="cuda", dtype=torch.bfloat16,
) -> torch.Tensor:
    """The headline distribution fixture (``bench.py`` ``hist512_volume``):
    a bins-major ``(n, B, n, n)`` volume of per-voxel softmax histograms
    around a separable-blob mean.

    Made on ``device`` a few z-layers at a time, so the float32 logits never
    exist whole (at n = 512 they would be 8.6 GB; the bf16 result is 4.3 GB).
    """
    z = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    gy = torch.exp(-((z - 0.55) ** 2) / 0.08)
    gx = torch.exp(-((z - 0.5) ** 2) / 0.06)
    gz = torch.exp(-((z - 0.45) ** 2) / 0.05)
    centers = ((torch.arange(B, device=device, dtype=torch.float32) + 0.5) / B)
    out = torch.empty((n, B, n, n), dtype=dtype, device=device)
    step = max(1, (1 << 26) // (B * n * n))
    for z0 in range(0, n, step):
        base = gz[z0:z0 + step, None, None] * gy[None, :, None] * gx[None, None, :]
        logits = -((centers[None, :, None, None] - base[:, None]) ** 2) / 0.02
        out[z0:z0 + step] = torch.softmax(logits, dim=1).to(dtype)
    return out
