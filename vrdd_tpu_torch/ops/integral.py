"""Integral-distribution (summed-area-table) histogram queries (counterpart
of ``vrdd_tpu/ops/integral.py``).

The reference's "flexible block size" pipeline (volumeRender_kernel.cu:
892-1544) answers "histogram of an arbitrary block" by decomposing each block
corner's prefix box into power-of-two (Fenwick) spans and *searching* a span
codebook for each — a brute-force O(64*64*32) scan per span that costs
194,764 ms (ver1.9.6.txt:9, the repo's own TODO:3-4). Two layers replace it:

1. ``integral_histogram``: a 3-D prefix sum (cumsum over Z, Y, X) of the
   one-hot binned volume — the integral histogram — as torch ops on the
   volume's device. Any axis-aligned block's histogram is then an O(1)
   8-corner +/- combination, vectorized over all query blocks at once
   (``query_blocks`` on a grid of blocks; ``query_block_histogram``, the
   JAX package's form, on blocks given by their corners).

2. Fenwick decomposition utilities (``fenwick_spans``,
   ``prefix_box_decomposition``, ``block_prefix_entries``) mirroring the
   reference's clear-lowest-set-bit corner decomposition
   (volumeRender_kernel.cu:1248-1283), for reference-format *span
   codebooks* — with the search replaced by an exact lookup built once on
   the host. These stay numpy on the host, as in the JAX package.

Signs: the standard inclusion-exclusion ``H(block) = sum_c (-1)^{#lows(c)}
P(corner_c)`` with low-corner coordinates ``low-1`` (exclusive). The
reference's sign pattern (+0,3,4,7 / -1,2,5,6 at volumeRender_kernel.cu:
1041-1046) pairs with its 1-indexed span decomposition.

Counts are int32, exact up to 2^31 voxels: JAX counts in float32, where a
prefix count above 2^24 is no longer an exact integer. The block queries
take their differences in int32 and only then convert to float32, so a
block's counts are exact however large its prefix boxes are.

The flexible-block explorer re-queries one resident integral histogram at
every block size: ``block_edges`` gives each axis's block boundaries on
the device; off the card ``query_blocks`` reads each distinct corner row
of the grid once and takes the 8-corner difference as three axis
differences (on the card ``kernels/flex_blocks.py`` does the query and
the stats in one launch).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np
import torch

from vrdd_tpu_torch.utils import profiling


def _bin_index(raw: torch.Tensor, n_bins: int, vmin: float,
               vmax: float) -> torch.Tensor:
    """The bin of each voxel: ``clip(int((raw - vmin) / (vmax - vmin) *
    n_bins), 0, n_bins - 1)`` in float32, truncated toward zero as JAX's
    ``astype(int32)``."""
    raw = torch.as_tensor(raw, dtype=torch.float32)
    q = (raw - vmin) / (vmax - vmin) * n_bins
    return torch.clamp(q.to(torch.int32), 0, n_bins - 1)


def onehot_bin_volume(
    raw, n_bins: int, vmin: float = 0.0, vmax: float = 255.0
) -> torch.Tensor:
    """``(Z, Y, X) -> (Z, Y, X, n_bins)`` hard one-hot binning (float32)."""
    idx = _bin_index(raw, n_bins, vmin, vmax)
    return (idx[..., None] == torch.arange(n_bins, dtype=torch.int32,
                                           device=idx.device)).float()


def integral_histogram(
    raw, n_bins: int, vmin: float = 0.0, vmax: float = 255.0
) -> torch.Tensor:
    """3-D prefix-sum histogram volume ``(Z+1, Y+1, X+1, n_bins)`` int32.

    ``sat[z, y, x, b]`` = count of voxels with bin ``b`` in the prefix box
    ``[0, z) x [0, y) x [0, x)`` (zero-padded on the low side so empty
    prefixes need no special-casing). Built in place: the one-hot is written
    into the padded array's interior and summed there along each axis (z,
    then y, then x, JAX's order) a slab at a time, so the peak is one
    ``(Z+1, Y+1, X+1, n_bins)`` int32 array plus a slab, not JAX's three
    or four whole arrays. Exact up to ``2^31 - 1`` voxels; a larger volume
    raises.
    """
    with profiling.annotate("flex.integral"):
        idx = _bin_index(raw, n_bins, vmin, vmax)
        nz, ny, nx = idx.shape
        if nz * ny * nx >= 2 ** 31:
            raise ValueError(f"{nz * ny * nx} voxels: int32 counts hold "
                             "fewer than 2^31")
        sat = torch.zeros((nz + 1, ny + 1, nx + 1, n_bins), dtype=torch.int32,
                          device=idx.device)
        inner = sat[1:, 1:, 1:]
        for z in range(nz):  # one z-layer of one-hot at a time
            inner[z].scatter_(-1, idx[z].long()[..., None], 1)
        del idx
        # the z sums in y-slabs, the y and x sums in z-slabs
        step_y = max(1, (1 << 26) // max(1, nz * nx * n_bins))
        for y0 in range(0, ny, step_y):
            slab = inner[:, y0:y0 + step_y]
            slab.copy_(torch.cumsum(slab, dim=0, dtype=torch.int32))
        step_z = max(1, (1 << 26) // max(1, ny * nx * n_bins))
        for dim in (1, 2):
            for z0 in range(0, nz, step_z):
                slab = inner[z0:z0 + step_z]
                slab.copy_(torch.cumsum(slab, dim=dim, dtype=torch.int32))
        return sat


def query_block_histogram(sat: torch.Tensor, low, high) -> torch.Tensor:
    """Histogram counts of blocks ``[low, high]`` (0-indexed, inclusive).

    ``low``/``high`` are ``(..., 3)`` int arrays in (z, y, x) order; returns
    ``(..., n_bins)`` float32 counts. O(1) per block: 8 gathers with +/-
    signs, summed in JAX's corner order in the table's dtype (exact in
    int32), then converted.

    The port of JAX's query, kept for parity with it (the tests hold the
    two together); the package's own queries take a grid of blocks through
    :func:`query_blocks`, which reads each corner row once.
    """
    low = torch.as_tensor(low, device=sat.device).long()
    hi = torch.as_tensor(high, device=sat.device).long() + 1  # exclusive
    out = None
    for dz, dy, dx in itertools.product((0, 1), repeat=3):
        z = hi[..., 0] if dz == 1 else low[..., 0]
        y = hi[..., 1] if dy == 1 else low[..., 1]
        x = hi[..., 2] if dx == 1 else low[..., 2]
        term = sat[z, y, x] if (dz + dy + dx) % 2 == 1 else -sat[z, y, x]
        out = term if out is None else out + term
    return out.float()


def block_edges(n: int, block: int, device=None) -> torch.Tensor:
    """The block boundaries along an axis of ``n`` voxels, ``0, block,
    2 block, ..., n`` (``ceil(n / block) + 1`` int64 values on ``device``):
    block ``i`` spans ``[edges[i], edges[i + 1])``, the last one cut short
    where ``block`` does not divide ``n``, as :func:`divide_blocks` cuts
    it."""
    if block < 1:
        raise ValueError(f"block size must be at least 1, got {block}")
    return torch.arange(0, n + block, block, device=device).clamp_(max=n)


def query_blocks(sat: torch.Tensor, edges) -> torch.Tensor:
    """Every block's counts of the grid whose boundaries along (z, y, x)
    are ``edges`` (:func:`block_edges`): ``(nbz, nby, nbx, n_bins)``
    float32. Each distinct corner row of the table is read once, and the
    8-corner inclusion-exclusion is taken as a difference along z, then y,
    then x, in int32 (exact) before the conversion."""
    ez, ey, ex = edges
    rows = sat[ez[:, None, None], ey[None, :, None], ex[None, None, :]]
    return rows.diff(dim=0).diff(dim=1).diff(dim=2).float()


def divide_blocks(volume_dim: Tuple[int, int, int], block: int) -> np.ndarray:
    """Partition a volume into ``block``-sized spans (1-indexed, inclusive).

    Returns ``(nb, 6)`` int32 rows ``(lowx, lowy, lowz, highx, highy, highz)``
    ordered x-fastest (``n = bz*nx*ny + by*nx + bx``), the layout of
    d_divideBlock (volumeRender_kernel.cu:892-1031) — without its
    copy-paste-per-axis bugs (remainder handled per axis independently).
    """
    dx, dy, dz = volume_dim  # (x, y, z) extents

    def spans_1d(n: int) -> List[Tuple[int, int]]:
        out = []
        lo = 1
        while lo <= n:
            hi = min(lo + block - 1, n)
            out.append((lo, hi))
            lo = hi + 1
        return out

    sx, sy, sz = spans_1d(dx), spans_1d(dy), spans_1d(dz)
    rows = []
    for (zl, zh) in sz:
        for (yl, yh) in sy:
            for (xl, xh) in sx:
                rows.append((xl, yl, zl, xh, yh, zh))
    return np.asarray(rows, dtype=np.int32)


def fenwick_spans(x: int) -> List[Tuple[int, int]]:
    """Decompose the 1-D prefix ``[1, x]`` into power-of-two aligned spans.

    The clear-lowest-set-bit loop of d_queryBlockNew
    (volumeRender_kernel.cu:1248-1259): span ``[ (x & ~lowbit) + 1, x ]``
    repeatedly. ``x = 0`` yields no spans.
    """
    out = []
    while x > 0:
        nxt = x & (x - 1)  # clear lowest set bit
        out.append((nxt + 1, x))
        x = nxt
    return out


def prefix_box_decomposition(corner: Tuple[int, int, int]) -> np.ndarray:
    """All Fenwick sub-spans of the 3-D prefix box ``[1, corner]``.

    Returns ``(m, 6)`` int32 rows ``(lowx, lowy, lowz, highx, highy, highz)``,
    the cross product of the per-axis decompositions (<= 6 each for dim 64,
    <= 216 total — nLgTwo, volumeRender_kernel.cu:94, 1296-1313). Empty if any
    coordinate is 0.
    """
    cx, cy, cz = corner
    sx, sy, sz = fenwick_spans(cx), fenwick_spans(cy), fenwick_spans(cz)
    rows = [
        (xl, yl, zl, xh, yh, zh)
        for (xl, xh) in sx
        for (yl, yh) in sy
        for (zl, zh) in sz
    ]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 6)


def block_corner_prefixes(span: np.ndarray) -> List[Tuple[Tuple[int, int, int], int]]:
    """The 8 (corner, sign) prefix boxes whose +/- combination gives a block.

    ``span`` is one ``(6,)`` row (1-indexed inclusive). Low corners use
    ``low - 1`` (exclusive prefix); sign is ``(-1)^(#lows)`` — the exact
    inclusion-exclusion (see module docstring for the reference divergence).
    """
    lx, ly, lz, hx, hy, hz = (int(v) for v in span)
    out = []
    for fx, fy, fz in itertools.product((0, 1), repeat=3):
        cx = hx if fx else lx - 1
        cy = hy if fy else ly - 1
        cz = hz if fz else lz - 1
        sign = 1 if (3 - fx - fy - fz) % 2 == 0 else -1
        out.append(((cx, cy, cz), sign))
    return out


def all_fenwick_triples(dims: Tuple[int, int, int]) -> np.ndarray:
    """Every (x-node, y-node, z-node) Fenwick span triple for a dims volume.

    This is the span universe the reference's dataset stores (64^3 = 262,144
    entries for the Fuel volume, split into fractal-coded >= 8 voxels and
    sparse "simple" < 8, volumeRender_kernel.cu:99-100, 1349).
    Returns ``(n, 6)`` rows (lowx, lowy, lowz, highx, highy, highz).
    """
    dx, dy, dz = dims

    def nodes(n: int) -> List[Tuple[int, int]]:
        return [(x - (x & -x) + 1, x) for x in range(1, n + 1)]

    nx_, ny_, nz_ = nodes(dx), nodes(dy), nodes(dz)
    rows = [
        (xl, yl, zl, xh, yh, zh)
        for (zl, zh) in nz_
        for (yl, yh) in ny_
        for (xl, xh) in nx_
    ]
    return np.asarray(rows, dtype=np.int32)


def fenwick_high_table(vals: np.ndarray, n_levels: int) -> np.ndarray:
    """Successive clear-lowest-set-bit highs of each prefix coordinate.

    ``vals (...,) -> (..., n_levels)`` int64: column k holds the k-th Fenwick
    span's high end (0-padded once the prefix is exhausted) — the vectorized
    form of the d_queryBlockNew bit loop (volumeRender_kernel.cu:1248-1259).
    """
    cur = np.asarray(vals, dtype=np.int64).copy()
    out = np.zeros(cur.shape + (n_levels,), dtype=np.int64)
    for k in range(n_levels):
        out[..., k] = cur
        cur = cur & (cur - 1)
    if np.any(cur):
        raise ValueError(
            f"n_levels={n_levels} too small for max coordinate {vals.max()}"
        )
    return out


def build_span_lookup(spans: np.ndarray, dims: Tuple[int, int, int]) -> np.ndarray:
    """Dense ``(dx+1, dy+1, dz+1)`` high-corner -> row-index table (-1 absent).

    A canonical Fenwick span is uniquely identified by its high corner
    (``low = high - lowbit(high) + 1``); rows that are not canonical are
    skipped (never requested by the decomposition). On duplicate high corners
    the LATER row wins — matching from_codebooks' dict semantics where simple
    spans override fractal ones. This is the vectorized replacement for the
    reference's brute-force per-span texture scan (the 194,764 ms
    d_querySpanNew bottleneck, volumeRender_kernel.cu:1352-1374,
    ver1.9.6.txt:9)."""
    dx, dy, dz = (int(v) for v in dims)
    spans = np.asarray(spans, dtype=np.int64)
    lut = np.full((dx + 1, dy + 1, dz + 1), -1, dtype=np.int64)
    h = spans[:, 3:6]
    canon = np.all(spans[:, 0:3] == h - (h & -h) + 1, axis=1)
    canon &= np.all((h >= 1) & (h <= np.asarray([dx, dy, dz])), axis=1)
    rows = np.nonzero(canon)[0]
    lut[h[rows, 0], h[rows, 1], h[rows, 2]] = rows
    return lut


def block_prefix_entries(
    spans: np.ndarray, dims: Tuple[int, int, int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized Fenwick corner decomposition of every block span at once.

    The 8-corner inclusion-exclusion factorizes per axis: the corner
    coordinate is ``high`` (sign +1) or ``low - 1`` (sign -1), each prefix
    ``[1, c]`` decomposes into Fenwick spans (identified by their high ends,
    length = lowbit), and the entry weight is the voxel count x sign, which
    is itself the product of per-axis ``sign x lowbit`` factors. The full
    entry list the reference accumulates one shared-memory atomicAdd at a
    time over a (blocks*8, 1000) grid (volumeRender_kernel.cu:1318-1544) is
    produced here as three flat arrays in a handful of numpy kernels.

    ``spans``: (nb, 6) 1-indexed inclusive (lowx..highz). Returns
    ``(block_idx (M,), high_xyz (M, 3), coef (M,))`` with
    ``block_hist[b] = sum_{i: block_idx[i]==b} coef[i] *
    span_hist[lookup[high_xyz[i]]]`` exact (counts domain).
    """
    spans = np.asarray(spans, dtype=np.int64)
    dims_i = [int(v) for v in dims]
    nb = spans.shape[0]
    vals, wts = [], []
    for ax in range(3):
        c = np.stack([spans[:, ax] - 1, spans[:, 3 + ax]], axis=-1)  # (nb, 2)
        n_levels = max(1, dims_i[ax].bit_length())
        t = fenwick_high_table(c, n_levels)  # (nb, 2, L)
        sign = np.asarray([-1.0, 1.0])[None, :, None]
        v = t.reshape(nb, 2 * n_levels)
        w = (np.broadcast_to(sign, t.shape).reshape(nb, 2 * n_levels)
             * (v & -v))  # sign * Fenwick span length (0 where exhausted)
        vals.append(v)
        wts.append(w)
    (vx, vy, vz), (wx, wy, wz) = vals, wts
    ex, ey, ez = vx.shape[1], vy.shape[1], vz.shape[1]
    shape = (nb, ex, ey, ez)
    hx = np.broadcast_to(vx[:, :, None, None], shape)
    hy = np.broadcast_to(vy[:, None, :, None], shape)
    hz = np.broadcast_to(vz[:, None, None, :], shape)
    coef = (
        wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    )
    m = ((hx > 0) & (hy > 0) & (hz > 0)).reshape(-1)
    bidx = np.broadcast_to(
        np.arange(nb, dtype=np.int64)[:, None, None, None], shape
    ).reshape(-1)[m]
    high = np.stack(
        [hx.reshape(-1)[m], hy.reshape(-1)[m], hz.reshape(-1)[m]], axis=-1
    )
    return bidx, high, coef.reshape(-1)[m]


def span_sizes(spans: np.ndarray) -> np.ndarray:
    """Voxel count of each ``(n, 6)`` span row (d_spanSize semantics)."""
    return (
        (spans[:, 3] - spans[:, 0] + 1)
        * (spans[:, 4] - spans[:, 1] + 1)
        * (spans[:, 5] - spans[:, 2] + 1)
    )


def build_span_index(spans: np.ndarray) -> Dict[Tuple[int, ...], int]:
    """Exact hash from span tuple -> row index.

    Replaces the reference's brute-force texture scan (the 194 s bottleneck,
    volumeRender_kernel.cu:1352-1374) with O(1) lookups, built once on host.
    """
    return {tuple(int(v) for v in row): i for i, row in enumerate(spans)}
