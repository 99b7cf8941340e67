"""Distributed object-order sweep: z-slabs on bricks, image rows on rays
(counterpart of ``vrdd_tpu/parallel/sweep.py``, with its names).

The single-device slice sweep (``march/slice.py``; kernels K3/K4/K5 of
``kernels/slice_vjp.py``) scales over the ``(bricks, rays)`` mesh of
``parallel/mesh.py``:

- the volume's Z axis is split into slabs over ``bricks``; each brick
  sweeps only the planes inside its slab (pre-blended from its slab and one
  ghost layer each side, :func:`~.mesh.halo_exchange`, or streamed straight
  from the slab when every plane IS a layer);
- image rows are split into strips over ``rays``: each (brick, strip)
  shard sweeps its strip with slopes ``(mx[0], dmx, my_local[0], dmy)``;
- the per-slab partial images combine front to back with the associative
  "over" operator (sort-last compositing);
- early ray termination is EXACT at plane granularity by two passes. Pass 1
  sweeps the slabs and finds, per pixel, the slab where the accumulated
  alpha crosses the threshold and the upstream prefix entering it. Pass 2
  re-sweeps that slab from the true prefix: on the kernels (``backend``
  'pallas') as a seeded sweep (``acc_init``), every other pixel seeded
  frozen at alpha 2, so its blocks exit at once; on the plain sweep
  ('xla') with the equivalent local threshold ``tau = (thr - a_up) / (1 -
  a_up)``. On the kernels pass 1 keeps their own cutoff: slabs before the
  crossing never truncate, and a truncated partial at or after it still
  registers the crossing.

The shards of one process run in turn on its device, strip by strip in
ascending order and, within a strip, its bricks of that strip in ascending
order; the bricks of other processes join through the collectives of
``parallel/mesh.py`` (over the strip's group), and each process returns
its own ray strips in ascending order: rows ``H * |local_rays| / rays`` of
the image, JAX's ``P(RAY_AXIS)`` output as that process holds it
(``multihost.gather_image`` joins them; the rotated paths gather the m-grid
over the slab groups before the warp). Everything
is differentiable: the kernels' VJP (with the pass-2 seed cotangent
``d seed_a = g_a - S / T_0`` into the upstream bricks' prefixes) and autograd
through the pre-blend, the halo, the gather and the fold.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from vrdd_tpu_torch.kernels.slice_kernel import (
    _host_floats,
    _pixel_slopes,
    hist_render_supported,
    pallas_supported,
)
from vrdd_tpu_torch.kernels.slice_vjp import (
    sweep_preblended_hist_diff,
    sweep_preblended_planes_diff,
)
from vrdd_tpu_torch.march.shearwarp import (
    _warp_from_rotation_traced,
    slope_corner_bounds,
)
from vrdd_tpu_torch.march.slice import _chunk_rgba_fn, _composite
from vrdd_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    gather_rays,
    grad_sum,
    halo_exchange,
    psum,
    replicate,
    replicated_output,
    slab_sum,
    strip_slabs,
)
from vrdd_tpu_torch.utils.config import MarchConfig

#: JAX's row tile (vrdd_tpu/pallas/slice_kernel.py:87). The rotated paths
#: pad their m-grid rows to ``rays * STRIP`` and round its columns up to 128
#: as JAX does: that sets the m-grid's samples, so the images match JAX's
#: (the CUDA kernels themselves take any size).
STRIP = 128


def _local_run(x, mesh: Mesh) -> torch.Tensor:
    """This process's run of bricks of ``x`` along its leading axis, on the
    mesh's device (the whole of ``x`` in a world of one)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.bricks:
        raise ValueError(f"extent {n} must divide over {mesh.bricks} bricks")
    per = n // mesh.bricks
    b = mesh.local_bricks
    return x[b[0] * per:(b[-1] + 1) * per].to(mesh.device)


def shard_scalar_volume(volume, mesh: Mesh) -> torch.Tensor:
    """A ``(Z, Y, X)`` scalar volume split over Z on the bricks axis: this
    process's run of slabs on the mesh's device."""
    return _local_run(volume, mesh)


def shard_hist_volume(hist_bm, mesh: Mesh) -> torch.Tensor:
    """A bins-major ``(Z, B, Y, X)`` histogram volume split over Z on the
    bricks axis (the layout :func:`distributed_hist_render` takes: each
    brick streams its own slab into the in-kernel decode)."""
    return _local_run(hist_bm, mesh)


def _f32(x) -> float:
    return float(np.float32(x))


def _strip_slopes(mx: np.ndarray, my_local: np.ndarray):
    """A shard's ``(mx0, dmx, my0, dmy)``, float32 as JAX forms them."""
    dmx = _f32(mx[1] - mx[0]) if mx.shape[0] > 1 else 0.0
    dmy = _f32(my_local[1] - my_local[0]) if my_local.shape[0] > 1 else 0.0
    return (_f32(mx[0]), dmx, _f32(my_local[0]), dmy)


def _local_sweep(planes, zs, mx, my, origin, tf_lut, density, toff, tscl,
                 threshold, march, plane_chunk: int, dz_sign: int,
                 plane_spacing: float, length_correction: bool,
                 tex_offset: float = 0.5, axis_scale=(1.0, 1.0)):
    """Front-to-back composite of pre-blended ``planes`` on a row strip
    (slopes ``mx (W,)``, ``my (Hl,)``), the plain torch sweep with a
    per-pixel freeze level ``threshold (Hl, W)`` (> 1 disables the cutoff).
    Differentiable by autograd."""
    n_planes, ny, nx = planes.shape
    chunk_rgba = _chunk_rgba_fn(
        n_planes, ny, nx, zs, origin, mx, my, march, dz_sign, plane_spacing,
        length_correction, tex_offset, tuple(axis_scale), True,
        planes.device)
    return _composite(chunk_rgba, planes.to(torch.float32),
                      (tf_lut, density, toff, tscl), plane_chunk,
                      threshold[..., None], (my.shape[0], mx.shape[0]))


def _over(acc, part):
    return acc + part * (1.0 - acc[..., 3:4])


def _two_pass(sweep, mesh: Mesh, r: int, forward: torch.Tensor, thr: float,
              seeded: bool):
    """The sort-last composite of ray strip ``r`` (the parallel scan
    marcher of ``parallel/bricks.py`` shares it), over this process's
    bricks of the strip and, through the strip's group, the others'.

    ``sweep(d, arg)`` is brick ``d``'s partial premultiplied RGBA, ``(*rays,
    4)``: ``seeded`` (the kernels) with ``arg`` None (pass 1, the kernel's
    own cutoff) or a seed image; else with ``arg`` a per-ray threshold.
    ``forward (*rays)`` is True where brick 0 (the smallest z) is nearest
    the camera, i.e. where d_z >= 0."""
    shape = forward.shape
    dev = mesh.device
    nb = mesh.bricks
    local = mesh.bricks_of(r)
    if nb == 1:
        # one brick: the sweep's own cutoff is the global termination
        return sweep(0, None if seeded else torch.full(shape, thr,
                                                       device=dev))
    no_cut = None if seeded else torch.full(shape, 2.0, device=dev)
    parts = all_gather([sweep(d, no_cut) for d in local], mesh, r)
    # per ray, the bricks in front-to-back order
    kk = torch.arange(nb, device=dev).reshape((nb,) + (1,) * len(shape))
    order = torch.where(forward[None], kk, nb - 1 - kk)
    ordered = torch.gather(parts, 0, order[..., None].expand(parts.shape))
    acc = torch.zeros_like(ordered[0])
    prefixes = []
    for j in range(nb):
        prefixes.append(acc)
        acc = _over(acc, ordered[j])
    final_nc, prefixes = acc, torch.stack(prefixes)
    after_alpha = torch.cat([prefixes[1:, ..., 3], final_nc[None, ..., 3]])
    crossed = after_alpha > thr  # (nb, *rays)
    saturating = crossed.any(0)
    j_star = crossed.to(torch.uint8).argmax(0)  # the first crossing
    prefix_at = torch.gather(
        prefixes, 0, j_star[None, ..., None].expand((1,) + prefixes.shape[1:])
    )[0]
    a_up = prefix_at[..., 3]

    # pass 2: re-sweep only the crossing slab
    contrib = 0.0
    for d in local:
        flag = saturating & (j_star == torch.where(forward, d, nb - 1 - d))
        if seeded:
            frozen = torch.zeros(shape + (4,), device=dev)
            frozen[..., 3] = 2.0
            out = sweep(d, torch.where(flag[..., None], prefix_at, frozen))
        else:
            tau = (thr - a_up) / torch.clamp(1.0 - a_up, min=1e-6)
            out = sweep(d, torch.where(flag, tau, 2.0))
        contrib = contrib + torch.where(flag[..., None], out, 0.0)
    contrib = psum(contrib, mesh, r)
    exact = contrib if seeded else prefix_at + contrib * (1.0 - a_up[..., None])
    return torch.where(saturating[..., None], exact, final_nc)


def _forward(dz_sign: int, hl: int, width: int, mesh: Mesh) -> torch.Tensor:
    """:func:`_two_pass`'s ``forward`` of a strip swept with one d_z sign."""
    return torch.full((hl, width), dz_sign > 0, device=mesh.device)


def _strips(strip_fn, mesh: Mesh, height: int):
    """This process's rows of the image: ``strip_fn(r, my_rows)`` per ray
    strip it holds, in ascending order, concatenated (every process walks
    its strips in that order: a strip group's collectives pair up)."""
    hl = height // mesh.rays
    return torch.cat([strip_fn(r, slice(r * hl, (r + 1) * hl))
                      for r in mesh.local_rays])


def _sweep_slope_space_call(
    volume, origin, tf_lut, density, brightness, transfer_offset,
    transfer_scale, *, mx, my, march: MarchConfig, mesh: Mesh, dz_sign: int,
    n_planes: int, length_correction: bool, plane_chunk: int, backend: str,
    wrt: tuple, tex_offset: float = 0.5, axis_scale=(1.0, 1.0, 1.0),
    volume_mode: str = "slab",
) -> torch.Tensor:
    """Distributed sweep over the host float32 slope grids ``mx``/``my``
    (the core). ``dz_sign`` is the common sign of d_z over the grid: it flips
    the front-to-back plane order and the compositing order. See
    :func:`distributed_sweep_render` for backends and
    :func:`distributed_shearwarp_render` for rotated cameras."""
    mx = np.asarray(mx, np.float32)
    my = np.asarray(my, np.float32)
    width, height = mx.shape[0], my.shape[0]
    nb, nr = mesh.bricks, mesh.rays
    local = mesh.local_bricks
    if volume_mode == "slab":
        # z-slabs need the default filter grid: a scaled grid (the flexible
        # blocks' padded grid) maps a plane's z-taps outside its slab's
        # ghost layers; 'replicated' serves those
        if tex_offset != 0.5 or tuple(axis_scale) != (1.0, 1.0, 1.0):
            raise ValueError(
                "volume_mode='slab' supports only the default filter grid; "
                "use volume_mode='replicated' for tex_offset/axis_scale "
                "variants")
        if volume.shape[0] % len(local):
            raise ValueError(f"Z={volume.shape[0] * nb / len(local):g} must "
                             f"divide over {nb} bricks")
        zl = volume.shape[0] // len(local)
        nz = zl * nb
    elif volume_mode == "replicated":
        nz = volume.shape[0]
    else:
        raise ValueError(f"unknown volume_mode {volume_mode!r}")
    ny, nx = volume.shape[1:]
    if n_planes <= 0:
        n_planes = 2 * nz
    if n_planes % nb:
        raise ValueError(f"n_planes={n_planes} must divide over {nb} bricks")
    if height % nr:
        raise ValueError(f"H={height} must divide over {nr} ray shards")
    (xlo, ylo, zlo), (xhi, yhi, zhi) = march.box_min, march.box_max
    thr = march.opacity_threshold

    # ascending global plane schedule; brick d owns planes d*ppd .. +ppd
    spacing = (zhi - zlo) / n_planes
    zs_global = (zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)
                 ).astype(np.float32)
    ppd = n_planes // nb
    hl = height // nr
    # host-static pre-blend taps in the haloed slab frame: plane k of any
    # brick sits at lf = (k + 0.5) * nz / n_planes + 0.5 (JAX's derivation,
    # sweep.py:393-425); the halo replicates the volume's edge layers, so
    # the unclamped two-tap lerp equals the clamped one
    lf = (np.arange(ppd, dtype=np.float64) + 0.5) * nz / n_planes + 0.5
    if dz_sign < 0:
        lf = lf[::-1]  # front to back for dz < 0: descending z
    iz0_host = np.floor(lf).astype(np.int64)
    az_host = (lf - np.floor(lf)).astype(np.float32)
    # n_planes == nz lands every plane on a layer: pure (reversed) selection
    pure_select = bool(np.all(az_host < 1e-6)) and bool(np.all(lf >= 1.0))

    n_lut = len(tf_lut)
    if backend == "pallas" and not pallas_supported(
            (nz, ny, nx), width, hl, ppd, n_lut=n_lut):
        raise ValueError(f"backend='pallas' cannot take a {n_lut}-entry LUT")
    if backend not in ("pallas", "xla", "auto"):
        raise ValueError(f"unknown backend {backend!r}; use xla / pallas / "
                         "auto")
    use_pallas = backend == "pallas" or (
        backend == "auto" and volume.device.type == "cuda")

    lut, density, toff, tscl, brightness = (
        replicate(x, mesh) for x in (tf_lut, density, transfer_offset,
                                     transfer_scale, brightness))
    origin = _host_floats(origin, 3)
    padded_run = (halo_exchange(volume, mesh)
                  if volume_mode == "slab" and not pure_select else None)
    # one split for every brick: its backward writes one gradient, where
    # each brick's slice would materialize a volume-sized one
    slabs = volume.split(zl) if volume_mode == "slab" else None
    planes_of = {}

    def brick_planes(d):
        """Brick d's front-to-back planes and depths (built once)."""
        if d in planes_of:
            return planes_of[d]
        zs_ftb = zs_global[d * ppd:(d + 1) * ppd]
        if dz_sign < 0:
            zs_ftb = zs_ftb[::-1].copy()
        dl = d - local[0]
        if volume_mode == "replicated":
            # plane-schedule sharding: the whole (coarse) volume on every
            # brick, the exact clamp-from-the-unclipped-floor taps of the
            # single-device pre-blend for any tex_offset / axis_scale
            zf = ((zs_ftb - np.float32(zlo)) / np.float32(zhi - zlo)
                  * np.float32(nz * axis_scale[2]) - np.float32(tex_offset))
            izf = np.floor(zf)
            az = torch.as_tensor((zf - izf).astype(np.float32),
                                 device=volume.device)[:, None, None]
            iz0 = torch.as_tensor(np.clip(izf.astype(np.int64), 0, nz - 1),
                                  device=volume.device)
            iz1 = torch.as_tensor(np.clip(izf.astype(np.int64) + 1, 0,
                                          nz - 1), device=volume.device)
            planes = volume[iz0] * (1.0 - az) + volume[iz1] * az
        elif pure_select and use_pallas:
            # the kernels stream the slab, walked back to front for dz < 0
            planes = slabs[dl]
        elif pure_select:
            planes = slabs[dl][torch.as_tensor(iz0_host - 1,
                                               device=volume.device)]
        else:
            padded = padded_run[dl * zl:dl * zl + zl + 2]
            i0 = torch.as_tensor(iz0_host, device=volume.device)
            az = torch.as_tensor(az_host, device=volume.device)[:, None, None]
            planes = padded[i0] * (1.0 - az) + padded[i0 + 1] * az
        planes_of[d] = planes, zs_ftb
        return planes_of[d]

    def strip(r, rows):
        my_local = my[rows]
        slopes = _strip_slopes(mx, my_local)

        def sweep(d, arg):
            planes, zs_ftb = brick_planes(d)
            if use_pallas:
                return sweep_preblended_planes_diff(
                    planes, zs_ftb, origin, slopes, lut, density, 1.0, toff,
                    tscl, dz_sign=dz_sign, width=width, height=hl,
                    march=march, length_correction=length_correction,
                    plane_chunk=plane_chunk, plane_spacing=spacing, wrt=wrt,
                    tex_offset=tex_offset, axis_scale=tuple(axis_scale[:2]),
                    reverse_planes=pure_select and dz_sign < 0,
                    acc_init=arg)
            return _local_sweep(
                planes, zs_ftb, mx, my_local, origin, lut, density, toff,
                tscl, arg, march, plane_chunk, dz_sign, spacing,
                length_correction, tex_offset, axis_scale[:2])

        return _two_pass(sweep, mesh, r, _forward(dz_sign, hl, width, mesh),
                         thr, use_pallas)

    return replicated_output(_strips(strip, mesh, height) * brightness, mesh)


def distributed_sweep_slope_space(
    volume: torch.Tensor,
    origin,
    mx: np.ndarray,
    my: np.ndarray,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    dz_sign: int = -1,
    n_planes: int = 0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    backend: str = "auto",
    wrt: tuple = ("volume", "lut", "params"),
    tex_offset: float = 0.5,
    axis_scale: tuple = (1.0, 1.0, 1.0),
    volume_mode: str = "auto",
) -> torch.Tensor:
    """Distributed sweep over HOST slope grids ``mx (W,)`` / ``my (H,)``:
    the distributed twin of ``march/slice.py sweep_slope_space``.

    ``volume_mode``: 'slab' splits the volume's leading axis over bricks
    (``volume`` is this process's run of slabs, :func:`shard_scalar_volume`;
    halo exchange; default filter grid only), 'replicated' keeps the whole
    volume on every brick and splits the plane schedule instead (coarse
    flexible-block grids, any ``tex_offset``/``axis_scale``); 'auto' picks
    'replicated' exactly when a non-default filter grid needs it. Returns
    this process's rows, as :func:`distributed_sweep_render`."""
    if volume_mode == "auto":
        volume_mode = (
            "slab"
            if tex_offset == 0.5 and tuple(axis_scale) == (1.0, 1.0, 1.0)
            else "replicated"
        )
    # a slab is held by its slab group, a whole volume by every process
    volume = (slab_sum(volume, mesh) if volume_mode == "slab"
              else grad_sum(volume, mesh.group))
    return _sweep_slope_space_call(
        volume, origin, tf_lut, density, brightness, transfer_offset,
        transfer_scale, mx=mx, my=my, march=march, mesh=mesh,
        dz_sign=int(dz_sign), n_planes=int(n_planes),
        length_correction=length_correction, plane_chunk=plane_chunk,
        backend=backend, wrt=tuple(wrt), tex_offset=float(tex_offset),
        axis_scale=tuple(float(s) for s in axis_scale),
        volume_mode=volume_mode,
    )


def distributed_sweep_render(
    volume: torch.Tensor,
    origin,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    width: int,
    height: int,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    n_planes: int = 0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    backend: str = "auto",
    wrt: tuple = ("volume", "lut", "params"),
    tex_offset: float = 0.5,
    axis_scale: tuple = (1.0, 1.0, 1.0),
    volume_mode: str = "auto",
) -> torch.Tensor:
    """Sweep-render with the volume split over bricks and rows over rays.

    ``volume`` is this process's run of ``(Z, Y, X)`` slabs
    (:func:`shard_scalar_volume`); unrotated camera at ``origin`` looking
    down -z. Returns this process's rows of the ``(H, W, 4)`` float32 RGBA
    image (``(H * |local_rays| / rays, W, 4)``; all of it in a world of
    one). Matches ``slice_render_image`` to float32 rounding (exact two-pass
    termination). Rotated cameras: :func:`distributed_shearwarp_render`.

    ``backend``: 'pallas' runs both passes of every shard on the sweep
    kernels (K3, or K4/K5 under autograd; their plain versions for a CPU
    volume), 'xla' the plain torch sweep, 'auto' the kernels for a volume on
    the card. Differentiable on both; ``wrt`` prunes the kernels' cotangents
    ('volume', 'lut', 'params') as in JAX.
    """
    mx, my = _pixel_slopes(width, height, focal)
    return distributed_sweep_slope_space(
        volume, origin, mx, my, tf_lut, density, brightness, transfer_offset,
        transfer_scale, march=march, mesh=mesh, dz_sign=-1,
        n_planes=n_planes, length_correction=length_correction,
        plane_chunk=plane_chunk, backend=backend, wrt=wrt,
        tex_offset=tex_offset, axis_scale=axis_scale,
        volume_mode=volume_mode,
    )


def _hist_sweep_slope_space_call(
    hist_bm, weights, origin, tf_lut, density, brightness, transfer_offset,
    transfer_scale, *, mx, my, march: MarchConfig, mesh: Mesh, dz_sign: int,
    length_correction: bool, plane_chunk: int, wrt: tuple, stat: str,
    slab_groups: bool,
) -> torch.Tensor:
    """The distribution-native distributed sweep over host slope grids (core
    of :func:`distributed_hist_render` and
    :func:`distributed_shearwarp_hist_render`): every brick sweeps its
    histogram slab through K3 (K4/K5 under autograd) with the statistic
    decoded in the kernel, one plane per layer, walked back to front for
    ``dz_sign < 0``. ``slab_groups``: ``hist_bm``'s slabs are held by their
    slab groups (their gradient sums there), else cut from a volume whose
    gradient sums over the world."""
    mx = np.asarray(mx, np.float32)
    my = np.asarray(my, np.float32)
    width, height = mx.shape[0], my.shape[0]
    nb, nr = mesh.bricks, mesh.rays
    local = mesh.local_bricks
    if hist_bm.shape[0] % len(local):
        raise ValueError(f"Z={hist_bm.shape[0] * nb / len(local):g} must "
                         f"divide over {nb} bricks")
    zl = hist_bm.shape[0] // len(local)
    n_planes = zl * nb  # pure selection: layers ARE planes
    if height % nr:
        raise ValueError(f"H={height} must divide over {nr} ray shards")
    hl = height // nr
    zlo, zhi = march.box_min[2], march.box_max[2]
    spacing = (zhi - zlo) / n_planes
    zs_global = (zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)
                 ).astype(np.float32)
    weights, lut, density, toff, tscl, brightness = (
        replicate(x, mesh) for x in (weights, tf_lut, density,
                                     transfer_offset, transfer_scale,
                                     brightness))
    origin = _host_floats(origin, 3)

    # a view of each of a strip's slabs: a strip's passes sum their bf16
    # cotangents there before the strips add up, the order of JAX's
    # per-device cotangents and their psum over rays, the same in one
    # process and in a world whose processes split the strips
    views = strip_slabs(hist_bm, mesh, slab_groups)

    def strip(r, rows):
        slopes = _strip_slopes(mx, my[rows])
        slabs = views(r)

        def sweep(d, seed):
            zs = zs_global[d * zl:(d + 1) * zl]
            return sweep_preblended_hist_diff(
                slabs[d], weights,
                zs[::-1].copy() if dz_sign < 0 else zs, origin, slopes, lut,
                density, 1.0, toff, tscl, dz_sign=dz_sign, width=width,
                height=hl, march=march, length_correction=length_correction,
                plane_chunk=plane_chunk, plane_spacing=spacing, wrt=wrt,
                stat=stat, acc_init=seed, reverse_planes=dz_sign < 0)

        return _two_pass(sweep, mesh, r, _forward(dz_sign, hl, width, mesh),
                         march.opacity_threshold, True)

    return replicated_output(_strips(strip, mesh, height) * brightness, mesh)


def distributed_hist_render(
    hist_bm: torch.Tensor,
    weights,
    origin,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    width: int,
    height: int,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    length_correction: bool = True,
    plane_chunk: int = 4,
    wrt: tuple = ("hist", "lut", "params"),
    stat: str = "linear",
) -> torch.Tensor:
    """Distribution-native distributed render: this process's run of the
    bins-major ``(Z, B, Y, X)`` histogram slabs (:func:`shard_hist_volume`),
    image rows over rays, the statistic decoded inside each brick's sweep
    kernel ('linear' / 'var' / 'entropy' with the rows of
    ``decode_weight_rows``): the decoded scalar volume never exists.

    Differentiable end to end (K4 forward, K5 backward per shard; the pass-2
    seed cotangent into upstream bricks; LUT and parameter gradients summed
    over the mesh). One plane per layer, unrotated -z camera, Z % bricks ==
    0, any image size. A CPU volume takes the kernels' plain versions.
    Returns this process's rows, as :func:`distributed_sweep_render`.
    Rotated cameras: :func:`distributed_shearwarp_hist_render`."""
    mx, my = _pixel_slopes(int(width), int(height), focal)
    # each slab is held by its slab group: its gradient sums there
    return _hist_sweep_slope_space_call(
        hist_bm, weights, origin, tf_lut, density, brightness,
        transfer_offset, transfer_scale, mx=mx, my=my, march=march,
        mesh=mesh, dz_sign=-1, length_correction=length_correction,
        plane_chunk=int(plane_chunk), wrt=tuple(wrt), stat=str(stat),
        slab_groups=True)


# ---- rotated views (shear-warp) -------------------------------------------

#: octant cache of the rotated paths' permuted volume: one slot per entry
#: point ('scalar' / 'hist'), each holding (source, perm, mesh, permuted).
#: Rotating within a principal-axis octant then moves no volume data; the
#: slot pins the source and its permuted copy (2x the volume's bytes) until
#: :func:`clear_octant_cache`.
_OCTANT_CACHE: dict = {}


def clear_octant_cache(slot: Optional[str] = None) -> None:
    """Release the octant cache's pinned tensors (``slot`` 'scalar' or
    'hist'; default both): call it when a long-lived process is done with
    a volume."""
    if slot is None:
        _OCTANT_CACHE.clear()
    else:
        _OCTANT_CACHE.pop(slot, None)


def _permuted_sharded(src, perm, mesh: Mesh, sharded: bool = True,
                      slot: str = "scalar") -> torch.Tensor:
    """``src`` permuted by ``perm``, made contiguous, and this process's run
    of bricks of it (the whole of it unless ``sharded``), memoized per
    (source identity, perm, mesh, sharded) in the entry point's slot. A
    source that requires grad bypasses the cache, so the permutation stays
    in the autograd graph."""
    def build():
        out = src.permute(perm).contiguous()
        return _local_run(out, mesh) if sharded else out.to(mesh.device)

    if src.requires_grad:
        return build()
    ent = _OCTANT_CACHE.get(slot)
    if ent is not None:
        s, p, m, sh, out = ent
        if s is src and p == perm and m == mesh and sh == sharded:
            return out
    out = build()
    _OCTANT_CACHE[slot] = (src, perm, mesh, sharded, out)
    return out


def _pad_grid(m: np.ndarray, mult: int) -> np.ndarray:
    """Extend a uniform slope grid to the next multiple of ``mult`` with the
    same spacing (JAX's ``_pad_grid``, slice_kernel.py:182)."""
    m = np.asarray(m, dtype=np.float32)
    n = m.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return m
    dm = float(m[1] - m[0]) if n > 1 else 1.0
    ext = m[-1] + dm * np.arange(1, pad + 1, dtype=np.float32)
    return np.concatenate([m, ext.astype(np.float32)])


def _rotated_frame(inv_view, width, height, focal, march, oversample,
                   round_up: bool, row_mult: int):
    """Host geometry of a rotated frame: ``(perm_world, dz_sign, march_p,
    origin_p, mx, my, mgrid)`` with the bounding m-grid built as JAX builds
    it (columns rounded up to 128 and rows extended to ``row_mult`` when
    ``round_up``)."""
    inv_view = np.asarray(inv_view, dtype=np.float32)
    _, (px, py, pz), dz_sign, ok, (mx_lo, mx_hi, my_lo, my_hi) = (
        slope_corner_bounds(inv_view, width, height, focal))
    if not ok:
        raise ValueError(
            "shear-warp inapplicable: d_z changes sign across the image; "
            "use the scan-marcher bricks path (parallel/bricks.py)")
    origin_w = inv_view[:, 3]
    origin_p = np.array([origin_w[px], origin_w[py], origin_w[pz]],
                        dtype=np.float32)
    bmin = np.asarray(march.box_min, dtype=np.float32)
    bmax = np.asarray(march.box_max, dtype=np.float32)
    march_p = MarchConfig(
        max_steps=march.max_steps, tstep=march.tstep,
        opacity_threshold=march.opacity_threshold,
        box_min=(float(bmin[px]), float(bmin[py]), float(bmin[pz])),
        box_max=(float(bmax[px]), float(bmax[py]), float(bmax[pz])),
    )
    wi = max(8, int(np.ceil(width * oversample)))
    hi = max(8, int(np.ceil(height * oversample)))
    if round_up:
        wi = -(-wi // 128) * 128
    mx_pad = max(1e-6, (mx_hi - mx_lo) / wi)
    my_pad = max(1e-6, (my_hi - my_lo) / hi)
    mx = np.linspace(mx_lo - mx_pad, mx_hi + mx_pad, wi, dtype=np.float32)
    my = np.linspace(my_lo - my_pad, my_hi + my_pad, hi, dtype=np.float32)
    my = _pad_grid(my, row_mult)
    # the warp's m-grid origin and spacing (spacing-based, so the row
    # extension never shifts in-range samples)
    mgrid = [float(np.float32(v)) for v in
             (mx[0], (mx[-1] - mx[0]) / (wi - 1), my[0], my[1] - my[0])]
    return (px, py, pz), dz_sign, march_p, origin_p, mx, my, mgrid


def _rot_hist_frame(hist_p, weights, origin, tf_lut, density, brightness,
                    transfer_offset, transfer_scale, inv_view, mgrid, *,
                    width, height, focal, perm_world, **sweep):
    """One rotated distribution-native frame: the m-grid sweep of the
    permuted volume ``hist_p`` (``sweep``: the keywords of
    :func:`_hist_sweep_slope_space_call`), then the homography warp to
    pixels, its index maps built on the device from the rotation."""
    img_m = gather_rays(_hist_sweep_slope_space_call(
        hist_p, weights, origin, tf_lut, density, brightness,
        transfer_offset, transfer_scale, **sweep), sweep["mesh"])
    return _warp_from_rotation_traced(
        img_m, np.asarray(inv_view, np.float32)[:, :3], mgrid, width, height,
        focal, perm_world)


def _rot_sweep_frame(vol_perm, origin, tf_lut, density, brightness,
                     transfer_offset, transfer_scale, inv_view, mgrid, *,
                     width, height, focal, perm_world, **sweep):
    """The scalar twin of :func:`_rot_hist_frame` (``sweep``: the keywords
    of :func:`_sweep_slope_space_call`)."""
    img_m = gather_rays(_sweep_slope_space_call(
        vol_perm, origin, tf_lut, density, brightness, transfer_offset,
        transfer_scale, **sweep), sweep["mesh"])
    return _warp_from_rotation_traced(
        img_m, np.asarray(inv_view, np.float32)[:, :3], mgrid, width, height,
        focal, perm_world)


def shearwarp_hist_supported(
    hist_shape,
    inv_view,
    width: int,
    height: int,
    *,
    focal: float = 2.0,
    oversample: float = 1.0,
    n_lut: int = 9,
    mesh: Optional[Mesh] = None,
) -> bool:
    """Can :func:`distributed_shearwarp_hist_render` serve this view on the
    kernels? The port's :func:`hist_render_supported` on the PERMUTED volume
    shape and the m-grid the call sweeps (the CUDA kernels take any size,
    so only the LUT and decode rows' shared memory bound it); False when
    shear-warp is inapplicable (d_z changes sign) or the principal extent
    does not divide over the mesh's bricks."""
    nz, B, ny, nx = hist_shape
    _, (px, py, pz), _, ok, _ = slope_corner_bounds(
        np.asarray(inv_view, np.float32), width, height, focal)
    if not ok:
        return False
    sp = lambda a: 0 if a == 2 else 3 - a  # noqa: E731
    dims = {0: nz, 2: ny, 3: nx}
    shape_p = (dims[sp(pz)], B, dims[sp(py)], dims[sp(px)])
    nr = mesh.rays if mesh is not None else 1
    nb = mesh.bricks if mesh is not None else 1
    if shape_p[0] % nb:
        return False
    wi = -(-max(8, math.ceil(width * oversample)) // 128) * 128
    hi = max(8, math.ceil(height * oversample))
    hi += (-hi) % (nr * STRIP)
    return hist_render_supported(shape_p, wi, hi // nr, n_lut=n_lut)


def distributed_shearwarp_hist_render(
    hist_bm: torch.Tensor,
    weights,
    inv_view: np.ndarray,
    width: int,
    height: int,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    oversample: float = 2.0,
    length_correction: bool = True,
    plane_chunk: int = 4,
    wrt: tuple = ("hist", "lut", "params"),
    stat: str = "linear",
) -> torch.Tensor:
    """Rotated views of a bins-major ``(Z, B, Y, X)`` histogram volume
    (the whole volume, on every process), distribution-native, on the mesh:
    shear-warp (``march/shearwarp.py``) x in-kernel decode x sort-last
    sharding.

    The volume's SPATIAL axes permute so the view's principal world axis
    becomes the sweep and shard axis (B stays put; the permuted copy is
    cached per octant, :func:`clear_octant_cache`), each brick sweeps the
    bounding m-grid with the statistic decoded in K3 (K4/K5 under autograd),
    rows split over rays, walked in storage order for ``dz > 0`` and back to
    front for ``dz < 0``, and the m-space image warps to pixels. The m-grid
    is JAX's: columns rounded up to 128, rows extended to ``rays * STRIP``.
    The m-grid's strips are gathered over the slab groups before the warp,
    so every process returns the whole frame. Differentiable like
    :func:`distributed_hist_render`."""
    if not isinstance(hist_bm, torch.Tensor):
        hist_bm = torch.as_tensor(hist_bm)
    perm_world, dz_sign, march_p, origin_p, mx, my, mgrid = _rotated_frame(
        inv_view, width, height, focal, march, oversample, True,
        mesh.rays * STRIP)
    px, py, pz = perm_world
    sp = lambda a: 0 if a == 2 else 3 - a  # noqa: E731
    if hist_bm.shape[sp(pz)] % mesh.bricks:
        raise ValueError(
            f"principal axis extent {hist_bm.shape[sp(pz)]} must divide "
            f"over {mesh.bricks} bricks")
    hist_p = _permuted_sharded(grad_sum(hist_bm, mesh.group),
                               (sp(pz), 1, sp(py), sp(px)), mesh, slot="hist")
    return _rot_hist_frame(
        hist_p, weights, origin_p, tf_lut, density, brightness,
        transfer_offset, transfer_scale, inv_view, mgrid, mx=mx, my=my,
        march=march_p, mesh=mesh, dz_sign=dz_sign,
        length_correction=length_correction, plane_chunk=int(plane_chunk),
        wrt=tuple(wrt), stat=str(stat), slab_groups=False, width=int(width),
        height=int(height), focal=float(focal), perm_world=perm_world)


def distributed_shearwarp_render(
    volume: torch.Tensor,
    inv_view: np.ndarray,
    width: int,
    height: int,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    n_planes: int = 0,
    oversample: float = 2.0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    backend: str = "auto",
    wrt: tuple = ("volume", "lut", "params"),
    tex_offset: float = 0.5,
    axis_scale: tuple = (1.0, 1.0, 1.0),
    volume_mode: str = "auto",
) -> torch.Tensor:
    """Rotated views on the distributed sweep (shear-warp): the scalar
    ``(Z, Y, X)`` volume (whole, on every process) permuted so the principal
    axis is the sweep and shard axis (cached per octant), the bounding
    m-grid swept with rows split over rays, then warped to pixels. Matches
    the single-device ``shearwarp_render_image`` on the same backend's
    m-grid ('xla': the grid as built; 'pallas' and 'auto' on the card: JAX's
    128-rounded columns and rows extended to ``rays * STRIP``). Every
    process returns the whole frame."""
    if not isinstance(volume, torch.Tensor):
        volume = torch.as_tensor(volume)
    want_pallas = backend == "pallas" or (
        backend == "auto" and mesh.device.type == "cuda")
    perm_world, dz_sign, march_p, origin_p, mx, my, mgrid = _rotated_frame(
        inv_view, width, height, focal, march, oversample, want_pallas,
        mesh.rays * (STRIP if want_pallas else 1))
    px, py, pz = perm_world
    ascale_p = (float(axis_scale[px]), float(axis_scale[py]),
                float(axis_scale[pz]))
    if volume_mode == "auto":
        volume_mode = ("slab" if tex_offset == 0.5
                       and ascale_p == (1.0, 1.0, 1.0) else "replicated")
    if volume_mode == "slab" and volume.shape[2 - pz] % mesh.bricks:
        raise ValueError(
            f"principal axis extent {volume.shape[2 - pz]} must divide over "
            f"{mesh.bricks} bricks")
    vol_perm = _permuted_sharded(grad_sum(volume, mesh.group),
                                 (2 - pz, 2 - py, 2 - px), mesh,
                                 sharded=volume_mode == "slab")
    return _rot_sweep_frame(
        vol_perm, origin_p, tf_lut, density, brightness, transfer_offset,
        transfer_scale, inv_view, mgrid, mx=mx, my=my, march=march_p,
        mesh=mesh, dz_sign=dz_sign, n_planes=int(n_planes),
        length_correction=length_correction, plane_chunk=int(plane_chunk),
        backend=backend, wrt=tuple(wrt), tex_offset=float(tex_offset),
        axis_scale=ascale_p, volume_mode=volume_mode, width=int(width),
        height=int(height), focal=float(focal), perm_world=perm_world)


__all__ = [
    "STRIP", "clear_octant_cache",
    "distributed_hist_render", "distributed_shearwarp_hist_render",
    "distributed_shearwarp_render", "distributed_sweep_render",
    "distributed_sweep_slope_space", "shard_hist_volume",
    "shard_scalar_volume", "shearwarp_hist_supported",
]
