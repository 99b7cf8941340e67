"""The flexible-block re-query on the card: one launch of
``csrc/flex_blocks.cu`` turns the resident integral histogram and a block
grid's boundaries into the grid's (mean, variance, entropy).

:func:`block_stats` is the kernel's wrapper. Its plain version is the torch
chain ``models/flexible.py IntegralVolume.blocks`` runs off the card
(``ops/integral.py query_blocks``, then ``ops/histogram.py``
``normalize_histogram`` and ``flex_block_stats``), which the card tests
hold it to. The kernel sums each block's bins in another order and uses
CUDA's ``log2f``: the stats agree to float32 rounding, the counts behind
them exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from vrdd_tpu_torch.kernels.launch import call, counted, ptrs, record
from vrdd_tpu_torch.utils.config import FLEX_MAX_HISTOGRAM

#: the most bins the kernel takes (8 a lane)
MAX_BINS = 256


@counted("flexq")
@torch.no_grad()
def block_stats(sat: torch.Tensor, edges) -> torch.Tensor:
    """``(nbz, nby, nbx, 3)`` float32 (mean, variance, entropy) over the
    [0, 255] bins of every block of the grid whose boundaries along (z, y,
    x) are ``edges`` (``ops/integral.py block_edges``, int64), from the
    ``(Z+1, Y+1, X+1, B)`` int32 integral histogram ``sat``: one launch,
    no host wait. Takes a contiguous int32 table on the card, the
    boundaries on the same card, and at most :data:`MAX_BINS` bins; raises
    on anything else."""
    if sat.device.type != "cuda":
        raise ValueError(f"block_stats runs on the card; got {sat.device} "
                         "(IntegralVolume.blocks runs the plain version)")
    if sat.dtype != torch.int32 or sat.ndim != 4 or not sat.is_contiguous():
        raise ValueError("block_stats: the integral histogram must be a "
                         f"contiguous 4-D int32 table, got {sat.dtype} "
                         f"{tuple(sat.shape)}")
    n_bins = sat.shape[3]
    if n_bins > MAX_BINS:
        raise ValueError(f"block_stats: at most {MAX_BINS} bins, got {n_bins}")
    ez, ey, ex = edges
    for name, e, n in (("z", ez, sat.shape[0]), ("y", ey, sat.shape[1]),
                       ("x", ex, sat.shape[2])):
        if (e.dtype != torch.int64 or e.device != sat.device or e.ndim != 1
                or not e.is_contiguous() or e.numel() < 1):
            raise ValueError(f"block_stats: {name} boundaries must be a "
                             f"contiguous int64 vector on {sat.device}")
        if e.numel() > n:
            raise ValueError(f"block_stats: {e.numel()} {name} boundaries "
                             f"for {n - 1} voxels")
    nb = (ez.numel() - 1, ey.numel() - 1, ex.numel() - 1)
    out = torch.empty((*nb, 3), dtype=torch.float32, device=sat.device)
    if out.numel():
        call("vrdd_flex_blocks", sat.device, *ptrs(sat, ez, ey, ex, out),
             *nb, sat.stride(0), sat.stride(1), n_bins,
             float(np.float32(FLEX_MAX_HISTOGRAM / n_bins)))
        record(block_stats)
    return out

