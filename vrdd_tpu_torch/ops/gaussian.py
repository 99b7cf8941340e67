"""Gaussian-moment distribution decode (counterpart of
``vrdd_tpu/ops/gaussian.py``).

BASELINE.json config 3 stores per-voxel ``(mu, sigma)`` instead of a full
histogram. The decode maps the moments to the (mean, variance, entropy)
triple the histogram paths produce, so every query downstream is
representation-agnostic. Plain torch on the device of its inputs,
differentiable.
"""

from __future__ import annotations

import math

import torch

#: 2 pi e, as the JAX package folds ``2.0 * jnp.pi * jnp.e`` (a Python float)
_TWO_PI_E = 2.0 * math.pi * math.e


def gaussian_stats(mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``(...,), (...,) -> (..., 3)``: mean, variance, normalized
    differential entropy.

    The differential entropy of N(mu, sigma^2), ``0.5 * log2(2 pi e
    sigma^2)``, is squashed to [0, 1) by a logistic of temperature 8, the
    JAX package's pinned choice (``tests/test_ops.py::
    test_gaussian_stats_pinned_constants``). The logistic is written out as
    ``1 / (1 + exp(-x))``, as in JAX, so both round alike."""
    var = sigma * sigma
    ent_bits = 0.5 * torch.log2(_TWO_PI_E * torch.clamp(var, min=1e-12))
    ent01 = 1.0 / (1.0 + torch.exp(-(ent_bits / 8.0)))
    return torch.stack([mu, var, ent01], dim=-1)
