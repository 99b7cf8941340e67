"""Flexible-block-size (integral distribution) volume family (counterpart of
``vrdd_tpu/models/flexible.py``).

The third distribution representation (SURVEY.md §0.3): for a user-chosen
block size, per-block histograms are assembled from power-of-two span
histograms via the integral-histogram identity. Two construction paths:

- :meth:`FlexibleBlockVolume.from_raw` — the raw volume is available: build a
  3-D prefix-sum integral histogram and query every block in O(1) on the
  device (replacing the reference's 5-kernel pipeline d_divideBlock ->
  d_allocateSpace -> d_queryBlockNew -> d_querySpanNew -> d_computeBlock,
  volumeRender_kernel.cu:1735-1796, including its 194 s span search).
  :class:`IntegralVolume` keeps the integral histogram on the device, so
  that a new block size (the explorer's slider) is a re-query of it,
  :meth:`IntegralVolume.blocks`, with no rebuild and no host round trip.

- :meth:`FlexibleBlockVolume.from_codebooks` — only the reference-format
  compressed span banks exist (fractal-coded spans >= 8 voxels + sparse
  "simple" spans < 8): decode both banks once on the device, build a dense
  high-corner lookup table and run the corner/Fenwick decomposition for all
  blocks on the host (numpy, ``ops/integral.py`` block_prefix_entries), and
  accumulate voxel-count-weighted span histograms with inclusion-exclusion
  signs by ``index_add_`` (deterministic on the CPU; on the card the order
  of additions into one block is the atomics').

Both paths end in clamp -> normalize -> (mean, variance, entropy) over the
[0, 255] 64-bin domain (d_computeBlock semantics,
volumeRender_kernel.cu:1041-1115). The stats grid lives on the device the
construction ran on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vrdd_tpu_torch.kernels import flex_blocks
from vrdd_tpu_torch.ops.fractal import fractal_decode_batch
from vrdd_tpu_torch.ops.histogram import flex_block_stats, normalize_histogram
from vrdd_tpu_torch.ops.integral import (
    block_edges,
    block_prefix_entries,
    build_span_lookup,
    divide_blocks,
    integral_histogram,
    query_blocks,
)
from vrdd_tpu_torch.ops.sparse import densify_sparse_histograms
from vrdd_tpu_torch.utils import profiling
from vrdd_tpu_torch.utils.config import FLEX_N_BINS
from vrdd_tpu_torch.utils.timing import StageTimer


def _stats(counts: torch.Tensor) -> torch.Tensor:
    hist, _ = normalize_histogram(counts)
    return flex_block_stats(hist)


def _raw_tensor(raw) -> torch.Tensor:
    """A raw volume as float32 on its device (a numpy volume goes to the
    card)."""
    return torch.as_tensor(
        raw, dtype=torch.float32,
        device=raw.device if isinstance(raw, torch.Tensor) else "cuda")


@dataclasses.dataclass
class FlexibleBlockVolume:
    """Per-block (mean, variance, entropy) grid for a flexible block size."""

    stats_grid: torch.Tensor  # (nZb, nYb, nXb, 3)
    block_size: int
    volume_dim: Tuple[int, int, int]  # (x, y, z) extents
    timings: Optional[Dict[str, float]] = None

    @property
    def n_blocks(self) -> Tuple[int, int, int]:
        return tuple(self.stats_grid.shape[:3])

    def stat_ranges(self) -> np.ndarray:
        """(3, 2) per-channel (min, max) over blocks — what bindToTex computes
        and prints for TF calibration (volumeRender_kernel.cu:1592-1622)."""
        g = self.stats_grid.detach().cpu().numpy().reshape(-1, 3)
        return np.stack([g.min(axis=0), g.max(axis=0)], axis=-1)

    def normalized(self) -> "FlexibleBlockVolume":
        """Copy with the mean/variance channels min-max mapped to [0, 1].

        The reference stores flexible-block mean/variance in raw bin-domain
        units, leaving their normalization as an open TODO
        (volumeRender_kernel.cu:1092, the commented-out min/max mapping at
        :1102-1104) — so queries 9/0 render black until the user winds
        transferScale down. This applies the mapping the reference left
        commented out, with the min/max bindToTex already computes. The
        entropy channel is left as it is (already in [0, 1] at decode,
        :1106-1115). Constant channels (max == min) map to 0.
        """
        g = self.stats_grid
        flat = g.reshape(-1, 3)[:, :2]
        lo = torch.amin(flat, dim=0)
        hi = torch.amax(flat, dim=0)
        span = torch.where(hi > lo, hi - lo, 1.0)
        mapped = (g[..., :2] - lo) / span
        return dataclasses.replace(
            self, stats_grid=torch.cat([mapped, g[..., 2:]], dim=-1)
        )

    # ---------------------------------------------------------------- raw path
    @classmethod
    def from_raw(
        cls,
        raw,
        block_size: int,
        n_bins: int = FLEX_N_BINS,
        vmin: float = 0.0,
        vmax: float = 255.0,
    ) -> "FlexibleBlockVolume":
        """O(1)-per-block construction from a raw scalar volume ``(Z, Y, X)``
        on its device (a tensor; a numpy volume goes to the card): the
        integral histogram, then its query at ``block_size`` in the plain
        version's stages (the grid :meth:`IntegralVolume.blocks` gives off
        the card; on the card within float32 rounding of it).

        Each stage's time (host clock, waiting for the device) is kept in
        ``timings``, as the reference's dataProcessing banners
        (volumeRender_kernel.cu:1739-1783), under the JAX package's names:
        ``divide_blocks`` is the block boundaries (``block_edges``)."""
        timer = StageTimer()
        sat = timer.time("integral_histogram", integral_histogram,
                         _raw_tensor(raw), n_bins, vmin, vmax)
        integral = IntegralVolume(sat)
        edges = timer.time("divide_blocks", integral.edges, block_size)
        counts = timer.time("query_blocks", query_blocks, sat, edges)
        stats = timer.time("compute_block_stats", _stats, counts)
        return FlexibleBlockVolume(stats, block_size, integral.volume_dim,
                                   timer.as_dict())

    # ----------------------------------------------------------- codebook path
    @classmethod
    def from_codebooks(
        cls,
        *,
        volume_dim: Tuple[int, int, int],
        block_size: int,
        fractal_spans: np.ndarray,  # (F, 6) 1-indexed inclusive
        fractal_codebook: np.ndarray,  # (F, 4) templateId, shift, flip, nErrors
        fractal_error_bins: np.ndarray,  # (F, E)
        fractal_error_values: np.ndarray,  # (F, E)
        templates: np.ndarray,  # (T, n_bins)
        simple_spans: np.ndarray,  # (S, 6) 0-indexed inclusive (reference quirk)
        simple_bin_ids: np.ndarray,  # (S, E2)
        simple_freqs: np.ndarray,  # (S, E2)
        simple_counts: np.ndarray,  # (S,)
        n_bins: int = FLEX_N_BINS,
        device="cuda",
    ) -> "FlexibleBlockVolume":
        """Reference-format construction (span codebooks, no raw volume);
        the banks decode and the blocks accumulate on ``device``."""
        timer = StageTimer()

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def decode_banks():
            cb = t(fractal_codebook).long()
            fractal_hists = fractal_decode_batch(
                t(templates, torch.float32)[cb[:, 0]], cb[:, 1], cb[:, 2],
                t(fractal_error_bins), t(fractal_error_values, torch.float32),
                cb[:, 3],
            )
            simple_hists = densify_sparse_histograms(
                t(simple_bin_ids), t(simple_freqs, torch.float32),
                t(simple_counts), n_bins,
            )
            return torch.cat([fractal_hists, simple_hists], dim=0)

        bank = timer.time("decode_banks", decode_banks)

        with timer.stage("build_span_index"):
            # simple spans are stored 0-indexed (volumeRender_kernel.cu:
            # 1464-1471); rows are ordered (fractal, simple) to match `bank`,
            # and build_span_lookup's later-row-wins makes simple spans
            # override duplicate fractal highs
            all_spans = np.concatenate(
                [np.asarray(fractal_spans), np.asarray(simple_spans) + 1],
                axis=0,
            )
            lookup = build_span_lookup(all_spans, volume_dim)

        nx, ny, nz = volume_dim
        with timer.stage("divide_blocks"):
            spans = divide_blocks(volume_dim, block_size)

        with timer.stage("corner_decomposition"):
            eb, high, ec = block_prefix_entries(spans, volume_dim)
            es = lookup[high[:, 0], high[:, 1], high[:, 2]]
            if np.any(es < 0):
                bad = high[int(np.argmax(es < 0))]
                hi = tuple(int(v) for v in bad)
                lo = tuple(int(v - (v & -v) + 1) for v in bad)
                raise KeyError(f"span {lo + hi} missing from codebooks")

        def accumulate():
            # a segment-sum in chunks, so the gathered (chunk, n_bins)
            # contributions stay bounded in device memory
            counts = torch.zeros((len(spans), n_bins), dtype=torch.float32,
                                 device=device)
            chunk = 1 << 19
            for s0 in range(0, len(eb), chunk):
                sl = slice(s0, s0 + chunk)
                contribs = bank[t(es[sl]).long()] * t(
                    ec[sl].astype(np.float32))[:, None]
                counts.index_add_(0, t(eb[sl]).long(), contribs)
            return counts

        counts = timer.time("accumulate", accumulate)
        stats = timer.time("compute_block_stats", _stats, counts)
        nbx = -(-nx // block_size)
        nby = -(-ny // block_size)
        nbz = -(-nz // block_size)
        grid = stats.reshape(nbz, nby, nbx, 3)
        return cls(grid, block_size, volume_dim, timer.as_dict())


@dataclasses.dataclass
class IntegralVolume:
    """A raw volume's integral histogram, built once and kept on its device:
    ``sat`` is the ``(Z+1, Y+1, X+1, n_bins)`` int32 table of
    ``ops/integral.py integral_histogram``. :meth:`blocks` answers any
    block size from it (the flexible-block explorer's slider re-queries it
    at every change); nothing rebuilds it."""

    sat: torch.Tensor

    @classmethod
    def from_raw(cls, raw, n_bins: int = FLEX_N_BINS, vmin: float = 0.0,
                 vmax: float = 255.0) -> "IntegralVolume":
        """The integral histogram of a raw scalar volume ``(Z, Y, X)``, on
        its device (a numpy volume goes to the card)."""
        return cls(integral_histogram(_raw_tensor(raw), n_bins, vmin, vmax))

    @property
    def volume_dim(self) -> Tuple[int, int, int]:
        """(x, y, z) extents of the raw volume."""
        nz, ny, nx = (n - 1 for n in self.sat.shape[:3])
        return (nx, ny, nz)

    def edges(self, block_size: int):
        """Each axis's block boundaries, (z, y, x), on the table's device
        (``ops/integral.py block_edges``)."""
        nx, ny, nz = self.volume_dim
        return [block_edges(n, block_size, self.sat.device)
                for n in (nz, ny, nx)]

    def blocks(self, block_size: int) -> FlexibleBlockVolume:
        """The (mean, variance, entropy) grid of ``block_size`` blocks, the
        blocks of ``divide_blocks`` (a short last block where the size does
        not divide an extent), all on the table's device: the boundaries by
        ``arange``, then on the card one launch of
        ``kernels/flex_blocks.py block_stats`` (the 8-corner int32 counts,
        the clamp-normalize and the stats of every block), elsewhere its
        plain version in two stages (each distinct corner row read once and
        differenced in int32, then the stats). Nothing waits for the device
        or reads it back."""
        with profiling.annotate("flex.requery"):
            with profiling.annotate("flex.corners"):
                edges = self.edges(block_size)
            if self.sat.device.type == "cuda":  # the counts and the stats
                with profiling.annotate("flex.query"):
                    grid = flex_blocks.block_stats(self.sat, edges)
            else:
                with profiling.annotate("flex.query"):
                    counts = query_blocks(self.sat, edges)
                with profiling.annotate("flex.stats"):
                    grid = _stats(counts)
        nbz, nby, nbx = grid.shape[:3]
        profiling.count("flex.requeries")
        profiling.count("flex.blocks", nbz * nby * nbx)
        profiling.count("flex.corner_rows", (nbz + 1) * (nby + 1) * (nbx + 1))
        return FlexibleBlockVolume(grid, block_size, self.volume_dim)
