"""Sparse ("simple") histogram densification (counterpart of
``vrdd_tpu/ops/sparse.py``).

The reference stores small-span histograms as (binId, freq) pairs with a
per-histogram nonzero count and densifies them during the span query
(volumeRender_kernel.cu:1476-1516, loader volumeRender.cpp:877-949). Here the
whole codebook densifies in one masked scatter-add as a precompute.
"""

from __future__ import annotations

import torch


def densify_sparse_histograms(
    bin_ids,
    freqs,
    counts,
    n_bins: int,
) -> torch.Tensor:
    """``(H, E) int, (H, E) float, (H,) int -> (H, n_bins)`` dense histograms.

    Entries beyond ``counts[h]`` are padding and ignored. Duplicate bin ids
    within one histogram overwrite in the reference (assignment, not add,
    volumeRender_kernel.cu:1515); ids are unique by construction, so the
    masked scatter-add is equivalent (and a padded slot adds 0 to whatever
    bin its id names). Indices follow JAX's ``.at[].add``: a negative id
    counts from the end, one still outside ``[0, n_bins)`` is dropped. Runs
    on the device of ``freqs``.
    """
    freqs = torch.as_tensor(freqs, dtype=torch.float32)
    dev = freqs.device
    bin_ids = torch.as_tensor(bin_ids, device=dev).long()
    bin_ids = torch.where(bin_ids < 0, bin_ids + n_bins, bin_ids)
    counts = torch.as_tensor(counts, device=dev).long()
    h, e = bin_ids.shape
    valid = torch.arange(e, device=dev)[None, :] < counts[:, None]
    valid &= (bin_ids >= 0) & (bin_ids < n_bins)
    masked = torch.where(valid, freqs, 0.0)
    out = torch.zeros((h, n_bins), dtype=torch.float32, device=dev)
    return out.scatter_add_(1, torch.where(valid, bin_ids, 0), masked)
