"""Distribution-volume representations (counterpart of
``vrdd_tpu/models/volumes.py``).

Each family mirrors one of the reference's per-voxel distribution
representations and exposes ``stats_volume()``: a ``(Z, Y, X, 3)`` float32
tensor of (mean, variance, entropy), on the device of the family's data —
the analogue of originalQueryTex (d_basicDataProcessing,
volumeRender_kernel.cu:722-872).

The families: ``ScalarVolume``, ``RawHistogramVolume``,
``FractalHistogramVolume`` and ``GaussianMomentVolume``.
"""

from __future__ import annotations

import dataclasses

import torch

from vrdd_tpu_torch.ops.fractal import fractal_decode_batch
from vrdd_tpu_torch.ops.gaussian import gaussian_stats
from vrdd_tpu_torch.ops.histogram import fractal_block_stats, raw_block_stats


def _z_step(per_layer: int) -> int:
    """z-layers per chunk so that a chunk's float32 temporaries stay near
    2^25 values."""
    return max(1, (1 << 25) // max(1, per_layer))


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
        step = _z_step(h[0].numel())
        out = torch.empty((*h.shape[:3], 3), dtype=torch.float32,
                          device=h.device)
        for z0 in range(0, nz, step):
            out[z0:z0 + step] = raw_block_stats(h[z0:z0 + step])
        return out


@dataclasses.dataclass(frozen=True)
class FractalHistogramVolume:
    """Similarity-coded histograms: codebook + sparse errors + template bank.

    ``codebook`` is ``(Z, Y, X, 4)`` int32 (templateId, shift, flipFlag,
    nErrors); ``error_bins``/``error_values`` are ``(Z, Y, X, E)`` padded
    sparse corrections; ``templates`` is ``(T, n_bins)``.
    (Loader formats: volumeRender.cpp:558-691.) All on one device.
    """

    codebook: torch.Tensor
    error_bins: torch.Tensor
    error_values: torch.Tensor
    templates: torch.Tensor

    def _decode_layers(self, z0: int, z1: int) -> torch.Tensor:
        """The decoded histograms of z-layers ``[z0, z1)``."""
        cb = self.codebook[z0:z1].reshape(-1, 4).long()
        e = self.error_bins.shape[-1]
        decoded = fractal_decode_batch(
            self.templates[cb[:, 0]], cb[:, 1], cb[:, 2],
            self.error_bins[z0:z1].reshape(-1, e),
            self.error_values[z0:z1].reshape(-1, e), cb[:, 3],
        )
        return decoded.reshape(*self.codebook[z0:z1].shape[:3], -1)

    def _layer_step(self) -> int:
        """z-layers per decode chunk: the gathered templates, the decoded
        rows and their correction stay near 2^25 values each."""
        return _z_step(self.codebook[0, ..., 0].numel()
                       * self.templates.shape[-1])

    def decode(self) -> torch.Tensor:
        """Decode every voxel's histogram: ``(Z, Y, X, n_bins)``, a few
        z-layers at a time (per voxel the arithmetic is
        :func:`fractal_decode_batch`'s)."""
        nz = self.codebook.shape[0]
        out = torch.empty((*self.codebook.shape[:3], self.templates.shape[-1]),
                          dtype=torch.float32, device=self.templates.device)
        step = self._layer_step()
        for z0 in range(0, nz, step):
            out[z0:z0 + step] = self._decode_layers(z0, z0 + step)
        return out

    def stats_volume(self) -> torch.Tensor:
        """``fractal_block_stats`` of the decode, decoded and reduced a few
        z-layers at a time: the whole decode never exists at once."""
        nz = self.codebook.shape[0]
        out = torch.empty((*self.codebook.shape[:3], 3), dtype=torch.float32,
                          device=self.templates.device)
        step = self._layer_step()
        for z0 in range(0, nz, step):
            out[z0:z0 + step] = fractal_block_stats(
                self._decode_layers(z0, z0 + step))
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
