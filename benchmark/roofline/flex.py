"""Bytes and operations of one re-query of the flexible-block grid, in the
manner of :mod:`benchmark.roofline.count` (the same peaks).

What a re-query at block size ``b`` of a ``(Z, Y, X)`` field with an
integral histogram of ``n_bins`` bins must do, whatever implements it:

- **Bytes**: read the integral histogram's row (``n_bins`` int32 counts)
  at every distinct block corner once: the corners are the product of each
  axis's block boundaries, ``ceil(n / b) + 1`` of them an axis
  (:func:`corner_rows`); and write the stats grid once, three float32 a
  block. The 8-gather form of the query reads each row up to eight times;
  that is a choice of implementation, not needed work, and is not counted.
- **Operations**, a block of ``B`` bins (:func:`block_ops`): the 8-corner
  difference, 7 adds a bin; the histogram's sum and the division by it, 2
  a bin; the mean, an FMA (two) a bin; the variance about it, a subtract
  and an FMA a bin; the entropy, a log2 and an FMA a bin; 3 to finish the
  three. So ``17 B + 3``; a re-query is bound by its bytes by a wide
  margin.
"""

from __future__ import annotations

import math

from benchmark.roofline.count import bound_s  # noqa: F401 (the kinds' bound)


def corner_rows(shape, block: int) -> int:
    """Distinct block corners of a ``shape`` field in blocks of ``block``."""
    return math.prod(-(-n // block) + 1 for n in shape)


def blocks(shape, block: int) -> int:
    """Blocks of a ``shape`` field in blocks of ``block`` (the last of an
    axis cut short)."""
    return math.prod(-(-n // block) for n in shape)


def block_ops(bins: int) -> int:
    """FP32 operations a block of ``bins`` bins (module docstring)."""
    return 17 * bins + 3


def requery_work(shape, block: int, bins: int):
    """``(bytes, operations)`` one re-query at ``block`` must move and
    compute."""
    nb = blocks(shape, block)
    n_bytes = corner_rows(shape, block) * bins * 4 + nb * 3 * 4
    return n_bytes, nb * block_ops(bins)
