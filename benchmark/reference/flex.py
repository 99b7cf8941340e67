"""The plain flexible-block reference: every block's histogram counted
straight from the raw field, its statistics, and the frame of one of them.

The explorer picks a block size; the reference's flexible pipeline
(``volumeRender_kernel.cu:892-1126``, driven at ``:1735-1796``) cuts the
field into blocks of that size, finds each block's 64-bin histogram, and
``d_computeBlock`` (``:1041-1115``) reduces it: negative counts clamped to
0, the histogram normalized to sum 1 (an empty one left as it is), each
bin clamped to [0, 1], then the mean and the variance about it over the
bin centres of [0, 255] and the Shannon entropy over ``log2`` of the bin
count. The program's explorer min-max maps the mean and the variance to
[0, 1] (``FlexibleBlockVolume.normalized``, the mapping the reference
left commented out at ``:1102-1104``) and keeps the entropy. ``bindToTex``
(``:1637-1691``) scatters the grid into a zero-filled array bound with
unnormalized coordinates, linear filtering and clamping, and queries
8/9/0 fetch it at ``p01 * n_blocks`` (``:654-680``): texel centres at
``k + 0.5``, the taps clamped to the array.

Departures, each leaving the numbers as the reference's:

- the histograms come from one ``bincount`` of block id x bins + bin over
  the whole field, in int64, where the reference decomposed each block
  into power-of-two spans and searched a span codebook (``:1248-1374``);
  the counts are the same integers;
- the zero-filled array is the grid padded by one zero on the high side of
  each axis, not a 500^3 array: a tap at ``p01 <= 1`` never reaches past
  index ``n_blocks``, so the rest of the array is never read;
- the planes are the program's rule, ``max(64, 2 (n_z + 1))`` over the
  padded depth ``n_z + 1``, and the sweep, shading and pack are
  :mod:`benchmark.reference.sweep`'s (the reference's ray marcher samples
  at its own step instead).

It imports nothing of the program under test. Each routine takes a
``dtype``: float32 is the reference, bfloat16 the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import sweep as ref

#: the flexible histograms' value range (volumeRender_kernel.cu:1083-1115)
FLEX_MAX_HISTOGRAM = 255.0
#: the stats channel each flexible query reads: 9 mean, 0 variance,
#: 8 entropy
CHANNEL = {9: 0, 0: 1, 8: 2}


def block_counts(field: torch.Tensor, block: int, n_bins: int, vmin: float,
                 vmax: float) -> torch.Tensor:
    """``(nbz, nby, nbx, n_bins)`` int64 voxel counts of every ``block``^3
    block of the ``(Z, Y, X)`` field (the last block of an axis cut short
    where ``block`` does not divide it), each voxel in bin ``floor((v -
    vmin) / (vmax - vmin) n_bins)`` clamped to the bins."""
    nz, ny, nx = field.shape
    dev = field.device
    nb = [-(-n // block) for n in (nz, ny, nx)]
    q = torch.floor((field - vmin) / (vmax - vmin) * n_bins)
    bins = q.to(torch.int64).clamp(0, n_bins - 1)
    bz, by, bx = (torch.arange(n, device=dev) // block for n in (nz, ny, nx))
    block_id = (bz[:, None, None] * nb[1] + by[None, :, None]) * nb[2] \
        + bx[None, None, :]
    key = (block_id * n_bins + bins).reshape(-1)
    counts = torch.bincount(key, minlength=nb[0] * nb[1] * nb[2] * n_bins)
    return counts.reshape(*nb, n_bins)


def block_stats(counts: torch.Tensor, dtype) -> torch.Tensor:
    """``d_computeBlock`` in ``dtype``: ``(..., n_bins)`` counts ->
    ``(..., 3)`` (mean, variance, entropy) over the bin centres
    ``w i + w / 2`` of [0, 255] (``w = 255 / n_bins``), not min-max
    mapped."""
    n_bins = counts.shape[-1]
    w = FLEX_MAX_HISTOGRAM / n_bins
    centres = np.float32(w) * np.arange(n_bins, dtype=np.float32) \
        + np.float32(w / 2.0)
    c = torch.as_tensor(centres, device=counts.device).to(dtype)
    h = torch.clamp(counts.to(dtype), min=0.0)
    total = h.sum(-1, keepdim=True)
    h = torch.where(total > 0, h / torch.where(total > 0, total, 1.0), h)
    h = torch.clamp(h, 0.0, 1.0)
    mean = (h * c).sum(-1)
    var = (h * (c - mean[..., None]) ** 2).sum(-1)
    safe = torch.where(h > 0, h, torch.ones_like(h))
    ent = -(h * torch.log2(safe)).sum(-1) / math.log2(n_bins)
    return torch.stack([mean, var, ent], -1)


def min_max(stats: torch.Tensor) -> torch.Tensor:
    """The mean and variance channels mapped to [0, 1] by their minimum and
    maximum over the blocks (a constant channel to 0); the entropy kept."""
    flat = stats.reshape(-1, 3)
    lo, hi = flat.amin(0), flat.amax(0)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    out = (stats - lo) / span
    return torch.cat([out[..., :2], stats[..., 2:]], -1)


def flex_taps(coord: torch.Tensor, n: int, dtype):
    """The texture fetch of a zero-padded axis of ``n`` blocks (``n + 1``
    texels, the last zero) at world coordinates ``coord``: unnormalized
    ``p01 n``, texel centres at ``k + 0.5``, both taps clamped to the
    array; lower and upper texel, the upper's weight, and whether the
    coordinate lies in the box."""
    p01 = (coord - ref.BOX_LO) / (ref.BOX_HI - ref.BOX_LO)
    xf = p01 * n - 0.5
    f0 = torch.floor(xf)
    i0 = f0.to(torch.int64)
    return (i0.clamp(0, n), (i0 + 1).clamp(0, n), (xf - f0).to(dtype),
            (p01 >= 0.0) & (p01 <= 1.0))


class FlexRays(ref.Rays):
    """:class:`benchmark.reference.sweep.Rays` fetching a padded block
    grid's planes by :func:`flex_taps`."""

    def sample(self, plane: torch.Tensor, z: float):
        ny, nx = plane.shape
        dz = z - self.oz
        ty = flex_taps(self.oy + dz * self.my, ny - 1, self.dtype)
        tx = flex_taps(self.ox + dz * self.mx, nx - 1, self.dtype)
        return ref.resample(plane, ty, tx)


@ref.float32_products()
def flex_frame(channel, inv_view, lut, density, brightness, toff, tscl, *,
               width, height, focal, dtype):
    """The uint8 frame of one stats channel ``(nbz, nby, nbx)`` of the
    block grid from an unrotated camera at ``inv_view[:, 3]``: the grid
    padded by one zero on the high side of each axis, pre-blended along z
    by the fetch's taps onto ``max(64, 2 (nbz + 1))`` planes, then swept
    front to back."""
    nz = channel.shape[0]
    pad = torch.nn.functional.pad(channel.to(dtype), (0, 1, 0, 1, 0, 1))
    n_planes = max(64, 2 * (nz + 1))
    spacing = (ref.BOX_HI - ref.BOX_LO) / n_planes
    zs = (ref.BOX_LO + spacing * (np.arange(n_planes, dtype=np.float32)
                                  + 0.5)).astype(np.float32)[::-1].copy()
    dev = channel.device
    i0, i1, az, _ = flex_taps(torch.as_tensor(zs, device=dev), nz, dtype)
    planes = pad[i0] * (1 - az)[:, None, None] + pad[i1] * az[:, None, None]
    rays = FlexRays(np.asarray(inv_view, np.float32)[:, 3],
                    ref.pixel_uv(width) / np.float32(-focal),
                    ref.pixel_uv(height) / np.float32(-focal), -1, spacing,
                    dev, dtype)
    lut_c = torch.as_tensor(lut, device=dev).to(dtype)
    return ref.pack_u8(ref.sweep(planes, zs, rays, lut_c, density, toff,
                                 tscl) * brightness)
