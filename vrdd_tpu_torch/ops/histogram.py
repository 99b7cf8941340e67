"""Histogram -> (mean, variance, entropy) decode ops (counterpart of
``vrdd_tpu/ops/histogram.py``).

The distribution-decode building blocks: the equivalent of
d_basicDataProcessing / d_computeBlock. Every function works on a trailing
bins axis, broadcasts over any leading shape, is differentiable and runs on
the device of its input.

The reference's normalizations are kept exactly (SURVEY.md "hard parts (d)"):

- raw path (volumeRender_kernel.cu:742-769): mean uses bin *centers*
  ``binWidth * i + binWidth / 2``, variance uses bin *left edges*
  ``(i / nBins) * MaxHistogram`` against that mean; then ``mean /= 0.0217``,
  ``variance /= 0.000021``; entropy is Shannon/log2(nBins).
- fractal path (volumeRender_kernel.cu:841-867): mean AND variance both use
  bin centers; same normalizers.
- flexible path (volumeRender_kernel.cu:1083-1115): 64 bins over [0, 255],
  centers for both, NO mean/variance normalization, entropy/log2(64).

The bin grids are built in float32 as the JAX package builds them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vrdd_tpu_torch.utils.config import (
    FLEX_MAX_HISTOGRAM,
    MAX_HISTOGRAM,
    MEAN_NORM,
    N_BINS,
    VARIANCE_NORM,
)


def _bin_centers(n_bins: int, vmax: float, device=None) -> torch.Tensor:
    bin_width = vmax / n_bins
    i = np.arange(n_bins, dtype=np.float32)
    c = np.float32(bin_width) * i + np.float32(bin_width / 2.0)
    return torch.as_tensor(c, device=device)


def _bin_left_edges(n_bins: int, vmax: float, device=None) -> torch.Tensor:
    i = np.arange(n_bins, dtype=np.float32)
    e = (i / np.float32(n_bins)) * np.float32(vmax)
    return torch.as_tensor(e, device=device)


def histogram_entropy(hist: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Normalized Shannon entropy ``-sum p log2 p / log2(n)``; 0-bins contribute 0."""
    safe = torch.where(hist > 0.0, hist, 1.0)
    ent = -torch.sum(hist * torch.log2(safe), dim=-1)
    return ent / float(np.log2(np.float32(n_bins)))


def _select_stats(builders, channels):
    """Stack only the requested stat channels (0=mean, 1=var, 2=entropy);
    ``channels=None`` keeps the full (..., 3) layout."""
    if channels is None:
        channels = (0, 1, 2)
    return torch.stack([builders[c]() for c in channels], dim=-1)


def raw_block_stats(hist: torch.Tensor, channels=None) -> torch.Tensor:
    """Raw-histogram decode: ``(..., N_BINS) -> (..., len(channels))``
    (default all three: mean, var, entropy)."""
    centers = _bin_centers(N_BINS, MAX_HISTOGRAM, hist.device)
    edges = _bin_left_edges(N_BINS, MAX_HISTOGRAM, hist.device)
    mean = torch.sum(hist * centers, dim=-1)
    return _select_stats([
        lambda: mean / MEAN_NORM,
        lambda: torch.sum(
            hist * (edges - mean[..., None]) ** 2, dim=-1) / VARIANCE_NORM,
        lambda: histogram_entropy(hist, N_BINS),
    ], channels)


def fractal_block_stats(hist: torch.Tensor, channels=None) -> torch.Tensor:
    """Fractal-decoded-histogram stats: centers for mean AND variance."""
    centers = _bin_centers(N_BINS, MAX_HISTOGRAM, hist.device)
    mean = torch.sum(hist * centers, dim=-1)
    return _select_stats([
        lambda: mean / MEAN_NORM,
        lambda: torch.sum(
            hist * (centers - mean[..., None]) ** 2, dim=-1) / VARIANCE_NORM,
        lambda: histogram_entropy(hist, N_BINS),
    ], channels)


def flex_block_stats(hist: torch.Tensor, channels=None) -> torch.Tensor:
    """Flexible-block stats over [0, 255], unnormalized mean/variance.

    Bin count is inferred from the trailing axis (64 in the reference,
    volumeRender_kernel.cu:1083-1115).
    """
    n_bins = hist.shape[-1]
    centers = _bin_centers(n_bins, FLEX_MAX_HISTOGRAM, hist.device)
    mean = torch.sum(hist * centers, dim=-1)
    return _select_stats([
        lambda: mean,
        lambda: torch.sum(hist * (centers - mean[..., None]) ** 2, dim=-1),
        lambda: histogram_entropy(hist, n_bins),
    ], channels)


def normalize_histogram(hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamp negatives to 0 and renormalize to sum 1 (guarding empty histograms).

    Mirrors the clamp-then-renormalize in d_computeBlock
    (volumeRender_kernel.cu:1047-1081). Returns ``(normalized, total)``.
    """
    hist = torch.clamp(hist, min=0.0)
    total = torch.sum(hist, dim=-1, keepdim=True)
    normed = torch.where(total > 0.0,
                         hist / torch.where(total > 0.0, total, 1.0), hist)
    return torch.clamp(normed, 0.0, 1.0), total[..., 0]
