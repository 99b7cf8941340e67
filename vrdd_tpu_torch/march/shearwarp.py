"""Perspective shear-warp renderer: rotated views on the plane sweep
(counterpart of ``vrdd_tpu/march/shearwarp.py``, with its names).

The slice sweep (``march/slice.py``, kernels K3/K4/K5 of
``kernels/slice_vjp.py``) composites along volume z; a rotated pinhole view
becomes that sweep by the perspective shear-warp factorization (Lacroute &
Levoy, SIGGRAPH '94):

1. **Principal axis**: the volume axis ``a`` maximizing ``|view_dir_a|`` is
   permuted to z (one ``permute`` and a contiguous copy).
2. **Ray-slope space**: a ray through the camera is its slope ``m = (d_x /
   d_z, d_y / d_z)`` in the permuted axes; on every volume plane its
   position is affine in m, so the unrotated sweep runs unchanged on a
   bounding uniform m-grid, per-ray exact.
3. **Final 2-D warp**: pixels map to slopes by the projective map ``m(u, v)
   = (R (u, v, -f))_{xy} / (R (u, v, -f))_z``; one bilinear resample of
   the m-space image, the only gather of the render.

Host geometry (principal axis, ``dz_sign``, m-grid bounds) is numpy on the
3x3 rotation, O(1) per frame for the fused path (:func:`_pallas_frame`: the
bounds come from the four corners, :func:`slope_corner_bounds`; the
per-pixel warp maps are built on the device). Differentiable with respect
to the volume and the render parameters: the warp is linear (its backward
is an accumulating scatter, atomics on the card, so not bitwise
reproducible) and the sweep has its analytic VJP. Requires d_z of one sign
over the image (:func:`shearwarp_applicable`); accuracy against the scan
marcher is ~1e-2 at oversample 2 (one extra bilinear filtering step).
"""

from __future__ import annotations

import numpy as np
import torch

from vrdd_tpu_torch.core.image import rgba_to_uint8
from vrdd_tpu_torch.kernels.slice_kernel import _device_f32, _pixel_uv
from vrdd_tpu_torch.march.slice import sweep_slope_space
from vrdd_tpu_torch.utils import profiling
from vrdd_tpu_torch.utils.config import MarchConfig

# permutation per principal axis: world-axis indices (x=0, y=1, z=2) of the
# sweep's (x', y', z'); volume arrays are (Z, Y, X) = world axes (2, 1, 0).
_PERMS = {
    2: (0, 1, 2),  # z-principal: identity
    1: (0, 2, 1),  # y-principal: (x, z, y)
    0: (2, 1, 0),  # x-principal: (z, y, x)
}


def _pixel_grid(width: int, height: int, focal: float):
    uu, vv = np.meshgrid(*_pixel_uv(width, height))  # (H, W)
    return np.stack([uu, vv, -focal * np.ones_like(uu)], axis=-1)


def shearwarp_geometry(
    inv_view: np.ndarray, width: int, height: int, focal: float = 2.0
):
    """Host-side geometry: principal axis, slopes per pixel, validity.

    Returns ``(axis, perm, slopes (H, W, 2), dz_sign, ok)`` where slopes are
    (mx, my) in PERMUTED volume axes.
    """
    inv_view = np.asarray(inv_view, dtype=np.float32)
    rot = inv_view[:, :3]
    d_world = _pixel_grid(width, height, focal) @ rot.T  # (H, W, 3) x, y, z
    view_dir = rot @ np.array([0.0, 0.0, -1.0], dtype=np.float32)
    axis = int(np.argmax(np.abs(view_dir)))  # world axis index
    px, py, pz = _PERMS[axis]
    dz = d_world[..., pz]
    ok = bool((dz > 1e-6).all() or (dz < -1e-6).all())
    dz_sign = 1 if float(dz.flat[0]) > 0 else -1
    mx = d_world[..., px] / dz
    my = d_world[..., py] / dz
    return axis, (px, py, pz), np.stack([mx, my], axis=-1), dz_sign, ok


def _principal_axis_geometry(
    inv_view: np.ndarray, width: int, height: int, focal: float = 2.0
):
    """O(1) host geometry: ``(axis, perm, dz_sign, ok)`` from the 3x3 alone.

    ``d_z(u, v)`` is affine in the pixel coordinates, so its sign over the
    image is decided at the four corners of the pixel rectangle (u in [-1,
    1 - 2/W], v in [-1, 1 - 2/H]): the same answer as
    :func:`shearwarp_geometry`'s all-pixels test."""
    inv_view = np.asarray(inv_view, dtype=np.float32)
    rot = inv_view[:, :3]
    view_dir = rot @ np.array([0.0, 0.0, -1.0], dtype=np.float32)
    axis = int(np.argmax(np.abs(view_dir)))
    px, py, pz = _PERMS[axis]
    u_ext = np.array([-1.0, 1.0 - 2.0 / width], dtype=np.float32)
    v_ext = np.array([-1.0, 1.0 - 2.0 / height], dtype=np.float32)
    dz = (
        u_ext[None, :] * rot[pz, 0]
        + v_ext[:, None] * rot[pz, 1]
        - focal * rot[pz, 2]
    )
    ok = bool((dz > 1e-6).all() or (dz < -1e-6).all())
    dz_sign = 1 if float(dz[0, 0]) > 0 else -1
    return axis, (px, py, pz), dz_sign, ok


def shearwarp_applicable(
    inv_view: np.ndarray, width: int = 64, height: int = 64, focal: float = 2.0
) -> bool:
    """True if d_z keeps one sign over the image for the best principal axis."""
    *_, ok = _principal_axis_geometry(inv_view, width, height, focal)
    return ok


def slope_corner_bounds(
    inv_view: np.ndarray, width: int, height: int, focal: float = 2.0
):
    """O(1) host geometry ``(axis, (px, py, pz), dz_sign, ok, (mx_lo, mx_hi,
    my_lo, my_hi))``: the slopes are linear-fractional in the pixel
    coordinates with a denominator of one sign, so each is monotone along an
    edge of the pixel rectangle and its extremes sit at the four corners;
    the m-grid bounds :func:`shearwarp_geometry` reads off the full grid."""
    inv_view = np.asarray(inv_view, dtype=np.float32)
    axis, (px, py, pz), dz_sign, ok = _principal_axis_geometry(
        inv_view, width, height, focal
    )
    rot = inv_view[:, :3]
    u_ext = np.array([-1.0, 1.0 - 2.0 / width], dtype=np.float32)
    v_ext = np.array([-1.0, 1.0 - 2.0 / height], dtype=np.float32)
    uu, vv = np.meshgrid(u_ext, v_ext)
    d = np.stack([uu, vv, -focal * np.ones_like(uu)], axis=-1) @ rot.T
    mx = d[..., px] / d[..., pz]
    my = d[..., py] / d[..., pz]
    return axis, (px, py, pz), dz_sign, ok, (
        float(mx.min()), float(mx.max()), float(my.min()), float(my.max())
    )


def _bilinear_warp_2d_traced(img: torch.Tensor, ix: torch.Tensor,
                             iy: torch.Tensor) -> torch.Tensor:
    """Sample the ``(Hi, Wi, C)`` image at fractional index maps ``ix``/``iy``
    ``(H, W)`` that live on its device (edge-clamped bilinear)."""
    hi, wi = img.shape[0], img.shape[1]
    fx0, fy0 = torch.floor(ix), torch.floor(iy)
    x0 = fx0.to(torch.int64).clamp(0, wi - 1)
    y0 = fy0.to(torch.int64).clamp(0, hi - 1)
    x1 = (x0 + 1).clamp(0, wi - 1)
    y1 = (y0 + 1).clamp(0, hi - 1)
    fx = (ix - fx0)[..., None]
    fy = (iy - fy0)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def _bilinear_warp_2d(img: torch.Tensor, ix: np.ndarray,
                      iy: np.ndarray) -> torch.Tensor:
    """:func:`_bilinear_warp_2d_traced` with host (numpy float32) index
    maps."""
    return _bilinear_warp_2d_traced(img, _device_f32(ix, img.device, "warp"),
                                    _device_f32(iy, img.device, "warp"))


def _pixel_slope_maps(rot: torch.Tensor, width: int, height: int,
                      focal: float, perm_world):
    """Per-pixel slopes ``(mx, my)``, each ``(H, W)``, on the device of
    ``rot`` (the 3x3 rotation, float32): ``d_world_i = u rot[i, 0] + v
    rot[i, 1] - focal rot[i, 2]`` over the permuted axes."""
    px, py, pz = perm_world
    u, v = (_device_f32(t, rot.device, "warp")
            for t in _pixel_uv(width, height))
    u, v = u[None, :], v[:, None]

    def d_world(i):
        return u * rot[i, 0] + v * rot[i, 1] - focal * rot[i, 2]

    dzc = d_world(pz)
    return d_world(px) / dzc, d_world(py) / dzc


def _warp_from_rotation_traced(img_m, rot, mgrid, width, height, focal,
                               perm_world):
    """Homography warp m-space -> pixels, the per-pixel index maps built on
    the device of ``img_m`` from the 3x3 rotation; ``mgrid = [mx0, dmx,
    my0, dmy]`` is the m-grid's origin and spacing, ``perm_world = (px, py,
    pz)``."""
    rot = _device_f32(rot, img_m.device, "warp")
    mx_all, my_all = _pixel_slope_maps(rot, width, height, focal, perm_world)
    mx0, dmx, my0, dmy = (float(v) for v in mgrid)
    return _bilinear_warp_2d_traced(
        img_m, (mx_all - mx0) / dmx, (my_all - my0) / dmy)


def mgrid_params(lo: float, hi: float, n: int):
    """``(m0, dm)`` of the 'pallas' backend's n-point uniform slope grid over
    ``[lo, hi]`` (the :func:`slope_corner_bounds` of one axis) plus a
    one-cell margin, in float32 arithmetic as JAX's ``_pallas_frame`` does
    it on the device (shearwarp.py:258-265)."""
    f = np.float32
    lo, hi = f(lo), f(hi)
    pad = max(f(1e-6), (hi - lo) / f(n))
    return float(lo - pad), float((hi - lo + f(2.0) * pad) / f(n - 1))


def _permuted_copy(volume, perm_axes):
    """The volume with its principal axis first, made contiguous: a copy
    unless the permuted view already is (a strided channel of a stacked
    decode always copies). The bytes it writes are counted as
    ``shearwarp.copy_bytes`` (it reads as many)."""
    with profiling.annotate("shearwarp.permute"):
        view = volume.permute(perm_axes)
        if not view.is_contiguous():
            profiling.count("shearwarp.copy_bytes",
                            view.numel() * view.element_size())
        return view.contiguous()


def _pack(img, pack_u8):
    """False: float RGBA; True/4: uint8 RGBA; 3: uint8 RGB."""
    if not pack_u8:
        return img
    with profiling.annotate("pipeline.pack"):
        out = rgba_to_uint8(img)
        return out[..., :3] if pack_u8 == 3 else out


def _pallas_frame(
    volume, rot, origin, tf_lut, density, brightness,
    transfer_offset, transfer_scale, *, width, height, wi, hi, focal, march,
    dz_sign, n_planes, length_correction, plane_chunk, tex_offset, wrt,
    axis_scale, perm_axes, perm_world, pack_u8, bounds,
):
    """One rotated frame on the fused sweep: the permuted volume made
    contiguous (:func:`_permuted_copy`), the bounding m-grid from the host
    corner ``bounds`` (:func:`slope_corner_bounds`, float32), the sweep through
    ``kernels.slice_vjp._diff_call`` (K3 without gradients, K4/K5 under
    autograd; the plain versions for a CPU volume), the per-pixel warp maps
    and the warp on the device, and the optional uint8 pack. JAX computes
    the bounds on the device over the full (H, W) grid inside its one jitted
    call; the corners give the same values without a readback."""
    from vrdd_tpu_torch.kernels.slice_vjp import _diff_call, _norm_wrt

    px, py, pz = perm_world
    vol_perm = _permuted_copy(volume, perm_axes)
    with profiling.annotate("shearwarp.geometry"):
        mx_lo, mx_hi, my_lo, my_hi = bounds
        mx0, dmx = mgrid_params(mx_lo, mx_hi, wi)
        my0, dmy = mgrid_params(my_lo, my_hi, hi)
        origin_p = [float(origin[px]), float(origin[py]), float(origin[pz])]
    img_m = _diff_call(
        vol_perm, origin_p, (mx0, dmx, my0, dmy), tf_lut, density,
        brightness, transfer_offset, transfer_scale, dz_sign=dz_sign,
        width=wi, height=hi, march=march, n_planes=n_planes,
        length_correction=length_correction, precision="f32",
        plane_chunk=plane_chunk, tex_offset=tex_offset, wrt=_norm_wrt(wrt),
        axis_scale=axis_scale,
    )
    with profiling.annotate("shearwarp.warp"):
        img = _warp_from_rotation_traced(img_m, rot, (mx0, dmx, my0, dmy),
                                         width, height, focal, perm_world)
    return _pack(img, pack_u8)


def shearwarp_render_image(
    volume: torch.Tensor,
    inv_view: np.ndarray,
    width: int,
    height: int,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    march: MarchConfig = MarchConfig(),
    focal: float = 2.0,
    n_planes: int = 0,
    oversample: float = 2.0,
    length_correction: bool = True,
    plane_chunk: int = 0,
    use_custom_vjp: bool = True,
    backend: str = "auto",
    tex_offset: float = 0.5,
    wrt: tuple = ("volume", "lut", "params"),
    axis_scale=(1.0, 1.0, 1.0),
    pack_u8=False,
) -> torch.Tensor:
    """Render ``(H, W, 4)`` RGBA of the scalar ``(Z, Y, X)`` volume for an
    ARBITRARY view.

    ``inv_view`` is the reference's 3x4 camera-to-world matrix (host numpy).
    ``oversample`` scales the intermediate m-grid relative to the output
    image (2.0 keeps the warp's filtering loss ~1e-2). ``axis_scale`` are
    per-world-axis filter-grid scales, permuted with the volume axes.

    ``backend``: 'xla' (the plain torch sweep of ``march/slice.py`` on host
    m-grids, as JAX's XLA branch), 'pallas' (the fused sweep of
    ``kernels/slice_vjp.py``: K3, or K4/K5 under autograd, on the card; its
    plain versions for a CPU volume), or 'auto' ('pallas' for a CUDA
    volume, which raises if the kernels cannot take it; else 'xla'). The
    'pallas' m-grid is rounded up to a multiple of 128 as in JAX: the TPU
    kernel's tiling, kept because it sets the image's sampling (the CUDA
    kernels take any size).
    """
    inv_view = np.asarray(inv_view, dtype=np.float32)
    with profiling.annotate("shearwarp.geometry"):
        axis, (px, py, pz), dz_sign, ok, bounds = slope_corner_bounds(
            inv_view, width, height, focal
        )
    if not ok:
        raise ValueError(
            "shear-warp inapplicable: d_z changes sign across the image "
            "(FOV too wide / degenerate view); use the scan marcher"
        )
    origin_w = inv_view[:, 3]
    box_min = np.asarray(march.box_min, dtype=np.float32)
    box_max = np.asarray(march.box_max, dtype=np.float32)
    march_p = MarchConfig(
        max_steps=march.max_steps,
        tstep=march.tstep,
        opacity_threshold=march.opacity_threshold,
        box_min=(float(box_min[px]), float(box_min[py]), float(box_min[pz])),
        box_max=(float(box_max[px]), float(box_max[py]), float(box_max[pz])),
    )
    ascale_p = (
        float(axis_scale[px]), float(axis_scale[py]), float(axis_scale[pz])
    )
    perm_axes = (2 - pz, 2 - py, 2 - px)

    wi = max(8, int(np.ceil(width * oversample)))
    hi = max(8, int(np.ceil(height * oversample)))
    if backend == "auto":
        backend = "pallas" if volume.device.type == "cuda" else "xla"

    if backend == "pallas":  # round the m-grid up as JAX does
        wi = -(-wi // 128) * 128
        hi = -(-hi // 128) * 128
        if n_planes <= 0:
            n_planes = 2 * int(volume.shape[2 - pz])
        return _pallas_frame(
            volume, inv_view[:, :3], origin_w, tf_lut, density, brightness,
            transfer_offset, transfer_scale, width=width, height=height,
            wi=wi, hi=hi, focal=focal, march=march_p, dz_sign=dz_sign,
            n_planes=n_planes, length_correction=length_correction,
            # 0 = the fused backward's default chunk
            plane_chunk=plane_chunk or 4, tex_offset=tex_offset,
            wrt=tuple(wrt), axis_scale=ascale_p, perm_axes=perm_axes,
            perm_world=(px, py, pz), pack_u8=pack_u8, bounds=bounds,
        )
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}; use xla / pallas / "
                         "auto")

    # xla backend: host per-pixel slopes, host m-grid and warp index maps
    with profiling.annotate("shearwarp.geometry"):
        *_, slopes, _, _ = shearwarp_geometry(inv_view, width, height, focal)
        mx_all, my_all = slopes[..., 0], slopes[..., 1]
        mx_lo, mx_hi = float(mx_all.min()), float(mx_all.max())
        my_lo, my_hi = float(my_all.min()), float(my_all.max())
        mx_pad = max(1e-6, (mx_hi - mx_lo) / wi)
        my_pad = max(1e-6, (my_hi - my_lo) / hi)
        mx = np.linspace(mx_lo - mx_pad, mx_hi + mx_pad, wi, dtype=np.float32)
        my = np.linspace(my_lo - my_pad, my_hi + my_pad, hi, dtype=np.float32)
        ix = (mx_all - mx[0]) / (mx[-1] - mx[0]) * (wi - 1)
        iy = (my_all - my[0]) / (my[-1] - my[0]) * (hi - 1)

    vol_perm = _permuted_copy(volume, perm_axes)
    origin_p = np.array(
        [origin_w[px], origin_w[py], origin_w[pz]], dtype=np.float32
    )
    img_m = sweep_slope_space(
        vol_perm, origin_p, mx, my, tf_lut,
        density, brightness, transfer_offset, transfer_scale, march_p,
        dz_sign=dz_sign, n_planes=n_planes,
        length_correction=length_correction,
        plane_chunk=plane_chunk or 8, use_custom_vjp=use_custom_vjp,
        tex_offset=tex_offset, axis_scale=ascale_p,
    )
    with profiling.annotate("shearwarp.warp"):
        img = _bilinear_warp_2d(img_m, ix, iy)
    return _pack(img, pack_u8)
