"""Carry the JAX side's arrays over to the port, bit for bit.

The JAX package hands out numpy arrays (``np.asarray`` of a ``jax.Array``):
float32, or ``ml_dtypes.bfloat16`` for bf16 histogram storage. This module
turns them into tensors on a given device without importing either JAX or
``ml_dtypes``: a bf16 array is reinterpreted as int16, moved, and viewed back
as ``torch.bfloat16``, so both packages compute on identical bits. A JAX
``RenderPipeline``, ``FractalHistogramVolume`` or ``FlexibleBlockVolume`` is
read by its attributes, never by importing its class.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" and a.dtype.itemsize == 2


def tensor_from_jax(array, device) -> torch.Tensor:
    """One numpy (or numpy-convertible) array -> tensor on ``device``."""
    a = np.array(array)  # a writable copy: JAX hands out read-only views
    if _is_bfloat16(a):
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def state_from_jax(arrays: Mapping[str, object], device) -> Dict[str, torch.Tensor]:
    """The JAX side's state -> the port's tensors on ``device``.

    ``arrays`` maps names to arrays, e.g. ``{"hist_bm": ..., "tf_lut": ...,
    "rows": ...}`` (the bins-major histogram volume, the LUT and the decode
    rows of ``decode_weight_rows``). Each keeps its dtype; bf16 stays bf16.
    """
    return {k: tensor_from_jax(v, device) for k, v in arrays.items()}


def pipeline_state_from_jax(pipeline, device) -> Dict[str, torch.Tensor]:
    """A JAX ``RenderPipeline``'s raw-histogram state -> tensors on
    ``device``: ``histograms`` (its raw ``(Z, Y, X, B)`` histograms),
    ``tf_lut`` and ``raw_stats`` (its precomputed ``(Z, Y, X, 3)`` stats
    volume, to compare the port's own decode against). Feed the first two
    to ``vrdd_tpu_torch.models.pipeline.RenderPipeline`` and both packages
    render the same bits."""
    if getattr(pipeline, "raw", None) is None:
        raise ValueError("the pipeline holds no raw histogram volume")
    return state_from_jax({
        "histograms": pipeline.raw.histograms,
        "tf_lut": pipeline.tf_lut,
        "raw_stats": pipeline.raw_stats,
    }, device)


def fit_voxels_state_from_jax(mu, sigma, device):
    """A JAX ``fit-voxels`` state, the ``(mu, sigma)`` numpy pair of its
    checkpoint (or of its parameters ``(mu, exp(log_sigma))``) -> the
    port's parameters ``(mu, log_sigma)``: float32 tensors on ``device``
    (``log_sigma`` is the float32 log of ``sigma``)."""
    mu_t = tensor_from_jax(mu, device).to(torch.float32)
    return mu_t, torch.log(tensor_from_jax(sigma, device).to(torch.float32))


def fractal_state_from_jax(volume, device):
    """A JAX ``FractalHistogramVolume`` (read by its attributes: codebook,
    error bins and values, templates) -> the port's, its arrays bit for bit
    on ``device``."""
    from vrdd_tpu_torch.models.volumes import FractalHistogramVolume

    return FractalHistogramVolume(
        *(tensor_from_jax(getattr(volume, k), device) for k in (
            "codebook", "error_bins", "error_values", "templates"))
    )


def flexible_state_from_jax(volume, device):
    """A JAX ``FlexibleBlockVolume`` (its stats grid, block size, volume
    extents and stage timings) -> the port's, the grid bit for bit on
    ``device``."""
    from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume

    return FlexibleBlockVolume(
        tensor_from_jax(volume.stats_grid, device), int(volume.block_size),
        tuple(int(v) for v in volume.volume_dim),
        dict(volume.timings) if volume.timings else None,
    )
