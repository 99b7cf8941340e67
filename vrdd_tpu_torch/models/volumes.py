"""Distribution-volume representations (counterpart of
``vrdd_tpu/models/volumes.py``).

Each family mirrors one of the reference's per-voxel distribution
representations and exposes ``stats_volume()``: a ``(Z, Y, X, 3)`` float32
tensor of (mean, variance, entropy), on the device of the family's data —
the analogue of originalQueryTex (d_basicDataProcessing,
volumeRender_kernel.cu:722-872).

Ported so far: ``ScalarVolume``, ``RawHistogramVolume`` and
``GaussianMomentVolume``. The fractal family needs ``ops/fractal.py``
(ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import torch

from vrdd_tpu_torch.ops.gaussian import gaussian_stats
from vrdd_tpu_torch.ops.histogram import raw_block_stats


@dataclasses.dataclass(frozen=True)
class ScalarVolume:
    """One scalar per voxel — densities are sampled directly."""

    values: torch.Tensor  # (Z, Y, X)

    def stats_volume(self) -> torch.Tensor:
        v = self.values
        return torch.stack([v, torch.zeros_like(v), torch.zeros_like(v)], dim=-1)


@dataclasses.dataclass(frozen=True)
class RawHistogramVolume:
    """Per-voxel (per-block) raw histograms: ``(Z, Y, X, n_bins)``.

    The Isabel representation: 50x50x10 blocks x 32 bins
    (volumeRender.cpp:86-87).
    """

    histograms: torch.Tensor  # (Z, Y, X, B)

    def stats_volume(self) -> torch.Tensor:
        """The decode, a few z-layers at a time: its float32 temporaries stay
        near 2^25 values (a 256^3 x 32 volume is 2.1 GB; whole-volume
        temporaries would be several times that). Per voxel the arithmetic
        is :func:`raw_block_stats`'s."""
        h = self.histograms
        nz = h.shape[0]
        step = max(1, (1 << 25) // max(1, h[0].numel()))
        out = torch.empty((*h.shape[:3], 3), dtype=torch.float32,
                          device=h.device)
        for z0 in range(0, nz, step):
            out[z0:z0 + step] = raw_block_stats(h[z0:z0 + step])
        return out


@dataclasses.dataclass(frozen=True)
class GaussianMomentVolume:
    """Per-voxel Gaussian (mu, sigma): BASELINE.json config 3 (256^3)."""

    mu: torch.Tensor  # (Z, Y, X)
    sigma: torch.Tensor  # (Z, Y, X)

    def stats_volume(self) -> torch.Tensor:
        return gaussian_stats(self.mu, self.sigma)


def compute_stats_volume(volume) -> torch.Tensor:
    """Any family's stats decode (JAX jits this as one call; here it runs
    eagerly on the family's device)."""
    return volume.stats_volume()
