"""Bricks-on-chips distributed rendering with halo exchange (counterpart of
``vrdd_tpu/parallel/bricks.py``): the scan marcher on z-slabs.

The stats volume's Z axis is split into slabs over the ``bricks`` axis of
the mesh (``parallel/mesh.py``) and the pixels into row strips over
``rays``. Each brick marches every ray of a strip through its own slab only
(boundary trilinear taps from one ghost layer each side:
:func:`~.mesh.halo_exchange`, JAX's ``_halo_exchange``), producing a premultiplied partial RGBA per
ray; the partials compose in per-ray front-to-back order with the "over"
operator (sort-last compositing).

Exactness against the single-device marcher (``march/scan.py``):

- sample positions are identical: every brick advances the SAME global
  ``t = gnear + k * tstep`` grid and composites only the steps in its
  half-open window ``[bnear, bfar)`` (the windows partition the ray);
- early ray termination is EXACT by two passes: pass 1 marches every brick
  without cutoff and folds the partials per ray to find the first brick
  where the accumulated alpha crosses the threshold and the alpha entering
  it; pass 2 re-marches that brick with the local threshold ``tau = (thr -
  a_up) / (1 - a_up)`` (the global test is a monotone transform of the local
  alpha, so the cutoff lands on the sequential loop's sample).

Known measure-zero divergence (as in JAX): a sample exactly on an interior
slab plane with the ray origin on that plane (0 * inf = NaN in the slab
test), the reference's own intersectBox NaN class.
"""

from __future__ import annotations

import numpy as np
import torch

from vrdd_tpu_torch.core.geometry import camera_rays, intersect_box
from vrdd_tpu_torch.core.transfer import apply_transfer_function
from vrdd_tpu_torch.march.scan import _ALIVE_CHECK
from vrdd_tpu_torch.parallel.mesh import (
    Mesh,
    halo_exchange,
    replicate,
    replicated_output,
    slab_sum,
)
from vrdd_tpu_torch.parallel.sweep import _local_run, _two_pass
from vrdd_tpu_torch.utils.config import MarchConfig


def shard_stats_volume(stats, mesh: Mesh) -> torch.Tensor:
    """A ``(Z, Y, X, C)`` stats volume split over Z on the bricks axis:
    this process's run of slabs on the mesh's device."""
    return _local_run(stats, mesh)


def _slab_trilinear(padded: torch.Tensor, p01: torch.Tensor, z0: int,
                    nz: int) -> torch.Tensor:
    """CUDA-model trilinear fetch against a haloed slab.

    ``padded`` is ``(zl + 2, ny, nx, C)``; ``z0`` the slab's global first
    layer. Global Z indices clamp to the full volume, then localize into the
    halo frame (+1); X/Y as ``core.sampling.sample_trilinear_3d``."""
    zl2, ny, nx = padded.shape[:3]
    sizes = torch.tensor([nx, ny, nz], dtype=torch.float32,
                         device=p01.device)
    xf = p01 * sizes - 0.5
    i0f = torch.floor(xf)
    a = xf - i0f
    i0 = i0f.to(torch.int64)
    x0 = i0[..., 0].clamp(0, nx - 1)
    x1 = (i0[..., 0] + 1).clamp(0, nx - 1)
    y0 = i0[..., 1].clamp(0, ny - 1)
    y1 = (i0[..., 1] + 1).clamp(0, ny - 1)
    z0_loc = (i0[..., 2].clamp(0, nz - 1) - z0 + 1).clamp(0, zl2 - 1)
    z1_loc = ((i0[..., 2] + 1).clamp(0, nz - 1) - z0 + 1).clamp(0, zl2 - 1)
    ax, ay, az = a[..., 0:1], a[..., 1:2], a[..., 2:3]
    c00 = padded[z0_loc, y0, x0] * (1 - ax) + padded[z0_loc, y0, x1] * ax
    c10 = padded[z0_loc, y1, x0] * (1 - ax) + padded[z0_loc, y1, x1] * ax
    c01 = padded[z1_loc, y0, x0] * (1 - ax) + padded[z1_loc, y0, x1] * ax
    c11 = padded[z1_loc, y1, x0] * (1 - ax) + padded[z1_loc, y1, x1] * ax
    c0 = c00 * (1 - ay) + c10 * ay
    c1 = c01 * (1 - ay) + c11 * ay
    return c0 * (1 - az) + c1 * az


def _march_brick(padded, z0: int, nz: int, channel: int, origin, dirs,
                 tf_lut, density, transfer_offset, transfer_scale,
                 march: MarchConfig, brick_zlo: float, brick_zhi: float,
                 threshold: torch.Tensor) -> torch.Tensor:
    """Partial premultiplied RGBA of one brick for a flat ray batch ``dirs
    (N, 3)``; ``threshold`` a per-ray local opacity cutoff (> 1: none)."""
    origin_b = origin.expand(dirs.shape)
    gnear, gfar, hit = intersect_box(origin_b, dirs, march.box_min,
                                     march.box_max)
    gnear = torch.clamp(gnear, min=0.0)
    bmin = torch.tensor([march.box_min[0], march.box_min[1], brick_zlo],
                        dtype=torch.float32, device=dirs.device)
    bmax = torch.tensor([march.box_max[0], march.box_max[1], brick_zhi],
                        dtype=torch.float32, device=dirs.device)
    inv_d = 1.0 / dirs
    tbot = inv_d * (bmin - origin_b)
    ttop = inv_d * (bmax - origin_b)
    bnear = torch.minimum(ttop, tbot).amax(-1)
    bfar = torch.maximum(ttop, tbot).amin(-1)

    pos = origin_b + dirs * gnear[:, None]
    step = dirs * march.tstep
    summ = torch.zeros(dirs.shape[:1] + (4,), dtype=torch.float32,
                       device=dirs.device)
    t = gnear
    running = hit
    saturated = torch.zeros_like(hit)
    for i in range(march.max_steps):
        # a ray past its window, stopped or saturated never composites again
        if i % _ALIVE_CHECK == 0 and not bool(
                (running & ~saturated & (t < bfar)).any()):
            break
        in_win = (t >= bnear) & (t < bfar)
        active = running & in_win & ~saturated & hit
        p01 = pos * 0.5 + 0.5
        sample = torch.where(
            active, _slab_trilinear(padded, p01, z0, nz)[..., channel], 0.0)
        col = apply_transfer_function(tf_lut, sample, transfer_offset,
                                      transfer_scale)
        a = col[:, 3] * density
        col = torch.cat([col[:, :3] * a[:, None], a[:, None]], dim=-1)
        new_sum = summ + col * (1.0 - summ[:, 3:4])
        summ = torch.where(active[:, None], new_sum, summ)
        saturated = saturated | (summ[:, 3] > threshold)
        t = t + march.tstep
        running = running & ~(t > gfar)
        pos = pos + step
    return summ


def distributed_render_image(
    stats: torch.Tensor,
    inv_view,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    width: int,
    height: int,
    channel: int = 0,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
) -> torch.Tensor:
    """Render with the stats volume split over bricks and pixel rows over
    rays. ``stats`` is this process's run of ``(Z, Y, X, C)`` slabs
    (:func:`shard_stats_volume`); any camera. Returns this process's rows
    of the ``(H, W, 4)`` float32 RGBA image (``(H * |local_rays| / rays, W,
    4)``; all of it in a world of one). Differentiable by autograd."""
    nb, nr = mesh.bricks, mesh.rays
    local = mesh.local_bricks
    if stats.shape[0] % len(local):
        raise ValueError(f"Z={stats.shape[0] * nb / len(local):g} must "
                         f"divide over {nb} bricks")
    zl = stats.shape[0] // len(local)
    nz = zl * nb
    if height % nr:
        raise ValueError(f"H={height} must divide over {nr} ray shards")
    dev = mesh.device
    origin, dirs = camera_rays(inv_view, width, height, focal, device=dev)
    dirs = dirs.reshape(-1, 3)
    lut, density, brightness, toff, tscl = (
        replicate(x, mesh) for x in (tf_lut, density, brightness,
                                     transfer_offset, transfer_scale))
    zmin, zmax = march.box_min[2], march.box_max[2]
    thr = march.opacity_threshold
    # each slab is held by its slab group: its gradient sums there
    padded_run = halo_exchange(slab_sum(stats, mesh), mesh)
    n_strip = (height // nr) * width

    def strip(r):
        dl = dirs[r * n_strip:(r + 1) * n_strip]

        def march_brick(d, threshold):
            z0 = d * zl
            k = d - local[0]
            # the window bounds in float32, as JAX forms them
            zlo = float(np.float32(zmin) + np.float32(zmax - zmin)
                        * np.float32(z0) / np.float32(nz))
            zhi = float(np.float32(zmin) + np.float32(zmax - zmin)
                        * np.float32(z0 + zl) / np.float32(nz))
            return _march_brick(
                padded_run[k * zl:k * zl + zl + 2], z0, nz, channel, origin,
                dl, lut, density, toff, tscl, march, zlo, zhi, threshold)

        # two passes, the bricks in per-ray front-to-back order
        rgba = _two_pass(march_brick, mesh, r, dl[:, 2] >= 0.0, thr, False)
        _, _, hit = intersect_box(origin.expand(dl.shape), dl, march.box_min,
                                  march.box_max)
        return torch.where(hit[:, None], rgba * brightness, rgba)

    out = torch.cat([strip(r) for r in mesh.local_rays])
    return replicated_output(out, mesh).reshape(-1, width, 4)
