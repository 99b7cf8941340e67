"""Explicit texture-unit semantics as differentiable gathers (counterpart of
``vrdd_tpu/core/sampling.py``).

The reference's CUDA texture fetches (volumeRender_kernel.cu:61-88) as
explicit gathers with the CUDA filtering/addressing model, clamp-to-edge
addressing, f32 weights (the texture unit's 9-bit filter weights are not
used: the JAX package designed them away, and the port keeps its
numerics):

    x_f  = u * N - 0.5        (normalized coords;  x - 0.5 for unnormalized)
    i    = floor(x_f),  a = x_f - i
    out  = (1 - a) * T[clamp(i)] + a * T[clamp(i + 1)]

Point (nearest) sampling: ``T[clamp(floor(u * N))]``.

Volumes are tensors of shape ``(Z, Y, X)`` or ``(Z, Y, X, C)``; coordinates
are ``(..., 3)`` in CUDA texture order ``(x, y, z)``.
"""

from __future__ import annotations

import torch


def _axis_sizes(vol: torch.Tensor, channels: bool) -> torch.Tensor:
    shape = vol.shape[:-1] if channels else vol.shape
    return torch.tensor([shape[2], shape[1], shape[0]], dtype=torch.float32,
                        device=vol.device)  # (x, y, z)


def sample_linear_1d(lut: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear-filtered 1-D LUT fetch at normalized coordinate ``u``.

    ``lut`` is ``(N, C)`` (or ``(N,)``); returns ``u.shape + (C,)``. This is the
    transferTex fetch (volumeRender_kernel.cu:683, setup 2337-2339).
    """
    squeeze = lut.ndim == 1
    if squeeze:
        lut = lut[:, None]
    n = lut.shape[0]
    xf = u * n - 0.5
    i0 = torch.floor(xf)
    a = (xf - i0)[..., None]
    i0 = i0.to(torch.int64)
    lo = i0.clamp(0, n - 1)
    hi = (i0 + 1).clamp(0, n - 1)
    out = (1.0 - a) * lut[lo] + a * lut[hi]
    return out[..., 0] if squeeze else out


def sample_nearest_3d(vol: torch.Tensor, p01: torch.Tensor) -> torch.Tensor:
    """Point-sampled fetch at normalized coords ``p01 (..., 3)`` in (x,y,z) order."""
    channels = vol.ndim == 4
    sizes = _axis_sizes(vol, channels)
    idx = torch.floor(p01 * sizes).to(torch.int64)
    nz, ny, nx = vol.shape[:3]
    ix = idx[..., 0].clamp(0, nx - 1)
    iy = idx[..., 1].clamp(0, ny - 1)
    iz = idx[..., 2].clamp(0, nz - 1)
    return vol[iz, iy, ix]


def _trilinear(vol: torch.Tensor, xf: torch.Tensor, channels: bool) -> torch.Tensor:
    """Shared trilinear core; ``xf (..., 3)`` is the shifted filter coordinate."""
    nz, ny, nx = vol.shape[:3]
    if not channels:
        vol = vol[..., None]
    i0 = torch.floor(xf)
    a = xf - i0
    i0 = i0.to(torch.int64)
    x0 = i0[..., 0].clamp(0, nx - 1)
    x1 = (i0[..., 0] + 1).clamp(0, nx - 1)
    y0 = i0[..., 1].clamp(0, ny - 1)
    y1 = (i0[..., 1] + 1).clamp(0, ny - 1)
    z0 = i0[..., 2].clamp(0, nz - 1)
    z1 = (i0[..., 2] + 1).clamp(0, nz - 1)
    ax = a[..., 0:1]
    ay = a[..., 1:2]
    az = a[..., 2:3]
    c000 = vol[z0, y0, x0]
    c100 = vol[z0, y0, x1]
    c010 = vol[z0, y1, x0]
    c110 = vol[z0, y1, x1]
    c001 = vol[z1, y0, x0]
    c101 = vol[z1, y0, x1]
    c011 = vol[z1, y1, x0]
    c111 = vol[z1, y1, x1]
    c00 = c000 * (1 - ax) + c100 * ax
    c10 = c010 * (1 - ax) + c110 * ax
    c01 = c001 * (1 - ax) + c101 * ax
    c11 = c011 * (1 - ax) + c111 * ax
    c0 = c00 * (1 - ay) + c10 * ay
    c1 = c01 * (1 - ay) + c11 * ay
    out = c0 * (1 - az) + c1 * az
    return out if channels else out[..., 0]


def sample_trilinear_3d(vol: torch.Tensor, p01: torch.Tensor) -> torch.Tensor:
    """Linear-filtered fetch at normalized coords (originalQueryTex semantics,
    volumeRender_kernel.cu:1864-1876)."""
    channels = vol.ndim == 4
    sizes = _axis_sizes(vol, channels)
    return _trilinear(vol, p01 * sizes - 0.5, channels)


def sample_trilinear_3d_unnormalized(vol: torch.Tensor,
                                     coords: torch.Tensor) -> torch.Tensor:
    """Linear-filtered fetch at *unnormalized* coords (flexBlockTex semantics,
    volumeRender_kernel.cu:1681-1691)."""
    channels = vol.ndim == 4
    return _trilinear(vol, coords - 0.5, channels)
