"""The plain plane sweep, its reverse step, and the two frame paths.

The renderer casts one ray per pixel from a pinhole camera: pixel ``(i,
j)`` of a ``W x H`` image has NDC coordinates ``u = 2 j / W - 1``, ``v = 2 i
/ H - 1`` (pixel corners, as the reference renderer's ``d_render``) and the
ray through it has the slopes ``m = (u, v) / -focal`` against the view axis.
On a plane of depth ``z`` the ray sits at ``o + (z - o_z) m``; the plane is
sampled there by the CUDA texture model (texel centres at ``(k + 0.5) /
n``, both taps clamped to the edge, nothing outside the box), the sample
goes through the clamped RGBA LUT, its opacity is scaled by the slab
length over the marcher's unit step, and the planes are composited front
to back with the "over" operator until the ray's alpha passes the cutoff.

The fit step's gradients come from plain autograd, a chunk of planes at a
time: the forward keeps the accumulated RGBA at the start of each chunk,
and the backward replays one chunk under autograd from its saved start
and hands the start's cotangent to the chunk before it. Nothing here is
written against any kernel.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

BOX_LO, BOX_HI = -1.0, 1.0  # the volume's box, on every axis
TSTEP = 0.01                # the marcher's step: the opacity's unit length
THRESHOLD = 0.95            # early ray termination: alpha past it freezes
#: raw block-histogram decode (volumeRender_kernel.cu:355, 742-769)
MAX_HISTOGRAM = 0.0217
MEAN_NORM = 0.0217
VARIANCE_NORM = 0.000021
#: world-axis indices (x=0, y=1, z=2) of the shear-warp sweep's (x', y',
#: z') for each principal axis
_PERMS = {2: (0, 1, 2), 1: (0, 2, 1), 0: (2, 1, 0)}
_F32 = np.float32


@contextlib.contextmanager
def float32_products():
    """Float32 products stay float32: no TF32 inside (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def pixel_uv(n: int) -> np.ndarray:
    """NDC coordinates of ``n`` pixels along one image axis (corners)."""
    return (np.arange(n, dtype=_F32) / _F32(n)) * _F32(2.0) - _F32(1.0)


def taps(coord: torch.Tensor, n: int, dtype, tex_offset: float = 0.5):
    """The linear filter of ``n`` texels at world coordinates ``coord``:
    lower and upper texel, the upper's weight and whether the coordinate
    lies in the box."""
    p01 = (coord - BOX_LO) / (BOX_HI - BOX_LO)
    xf = p01 * n - tex_offset
    f0 = torch.floor(xf)
    i0 = f0.to(torch.int64)
    return (i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1),
            (xf - f0).to(dtype), (p01 >= 0.0) & (p01 <= 1.0))


def resample(plane: torch.Tensor, ty, tx):
    """``plane (ny, nx)`` sampled at every (row, column) of the taps:
    ``(H, W)`` values and the mask of samples inside the box."""
    y0, y1, ay, iny = ty
    x0, x1, ax, inx = tx
    rows = (plane.index_select(0, y0) * (1 - ay)[:, None]
            + plane.index_select(0, y1) * ay[:, None])
    s = (rows.index_select(1, x0) * (1 - ax)[None, :]
         + rows.index_select(1, x1) * ax[None, :])
    return s, iny[:, None] & inx[None, :]


def tf_lookup(s: torch.Tensor, lut: torch.Tensor, toff: float, tscl: float):
    """RGBA of the ``(n, 4)`` LUT, linearly filtered and clamped, at the
    scalars ``s``. Off the clamp, the derivative in ``s`` is the slope of
    the knot interval that ends at or after the coordinate; on it, 0."""
    n = lut.shape[0]
    q_raw = (s - toff) * (tscl * n) - 0.5
    inside = (q_raw > 0.0) & (q_raw < n - 1.0)
    q = torch.where(inside, q_raw, q_raw.clamp(0.0, n - 1.0).detach())
    i0 = (torch.ceil(q) - 1.0).clamp(0, n - 2)
    f = (q - i0)[..., None]
    # the two knots' weights as a row over the LUT, so that the LUT's
    # gradient is a product and not a scatter onto n entries
    k = torch.arange(n, device=s.device, dtype=s.dtype)
    w = (torch.where(k == i0[..., None], 1 - f, 0.0)
         + torch.where(k == i0[..., None] + 1, f, 0.0))
    return w @ lut


def shade(s, covered, lut, density, toff, tscl, alpha_scale):
    """Premultiplied RGBA of the samples ``s``; 0 outside the box."""
    col = tf_lookup(s, lut, toff, tscl)
    a = torch.where(covered,
                    torch.clamp(col[..., 3] * density * alpha_scale, max=1.0),
                    0.0)
    return torch.cat([col[..., :3] * a[..., None], a[..., None]], -1)


def over(acc: torch.Tensor, rgba: torch.Tensor) -> torch.Tensor:
    """One front-to-back step; a ray past the cutoff keeps its colour."""
    new = acc + rgba * (1 - acc[..., 3:4])
    return torch.where(acc[..., 3:4] > THRESHOLD, acc, new)


class Rays:
    """A slope grid seen from ``origin``: ``mx (W,)`` and ``my (H,)`` host
    float32 slopes, ``dz_sign`` the sign of every ray's d_z, ``spacing``
    the distance between planes."""

    def __init__(self, origin, mx, my, dz_sign, spacing, device, dtype):
        self.ox, self.oy, self.oz = (float(v) for v in origin)
        self.mx = torch.as_tensor(np.asarray(mx, _F32), device=device)
        self.my = torch.as_tensor(np.asarray(my, _F32), device=device)
        self.dz_sign, self.dtype = dz_sign, dtype
        stretch = torch.sqrt(1.0 + self.my[:, None] ** 2 + self.mx[None, :] ** 2)
        self.alpha_scale = (spacing * stretch / TSTEP).to(dtype)
        self.shape = (self.my.shape[0], self.mx.shape[0])

    def in_front(self, z: float) -> bool:
        return (z - self.oz) * self.dz_sign > 0

    def sample(self, plane: torch.Tensor, z: float):
        """The plane at depth ``z`` under every ray: ``(values, covered)``."""
        ny, nx = plane.shape
        dz = z - self.oz
        ty = taps(self.oy + dz * self.my, ny, self.dtype)
        tx = taps(self.ox + dz * self.mx, nx, self.dtype)
        return resample(plane, ty, tx)


def sweep(planes, zs, rays: Rays, lut, density, toff, tscl):
    """``(H, W, 4)`` premultiplied RGBA of the plane stack ``planes (P, ny,
    nx)`` at depths ``zs``, front to back."""
    acc = torch.zeros((*rays.shape, 4), dtype=rays.dtype, device=planes.device)
    for k in range(planes.shape[0]):
        z = float(zs[k])
        if rays.in_front(z):
            s, cov = rays.sample(planes[k], z)
            acc = over(acc, shade(s, cov, lut, density, toff, tscl,
                                  rays.alpha_scale))
    return acc


# ---- the fit step ----------------------------------------------------------

def decode(h: torch.Tensor, rows: torch.Tensor, stat: str) -> torch.Tensor:
    """A bins-major ``(C, B, ny, nx)`` chunk of histograms -> ``(C, ny, nx)``
    of the statistic with the decode rows ``rows (R, B)``: 'mean' the dot
    with row 0; 'var' ``sum h (e - m)^2 s`` as ``C2 - 2 m C1 + m^2 C0`` with
    ``m, C1, C2, C0`` the dots with rows 0-3; 'entropy' ``rows[0, 0] * sum -h
    log2 h`` (empty bins add nothing)."""
    def dot(r):
        return (h * rows[r][None, :, None, None]).sum(1)

    if stat == "mean":
        return dot(0)
    if stat == "var":
        m, c1, c2, c0 = (dot(r) for r in range(4))
        return c2 - 2 * m * c1 + m * m * c0
    if stat == "entropy":
        safe = torch.where(h > 0, h, torch.ones_like(h))
        return rows[0, 0] * (-(h * torch.log2(safe))).sum(1)
    raise ValueError(f"unknown statistic {stat!r}")


def hist_rays(nz, width, height, focal, origin, device, dtype):
    """The fit's camera: one plane per layer, front to back (``zs[k]`` is
    the depth of layer ``nz - 1 - k``), looking down -z."""
    spacing = (BOX_HI - BOX_LO) / nz
    zs = (BOX_LO + spacing * (np.arange(nz, dtype=_F32) + 0.5)).astype(_F32)
    rays = Rays(origin, pixel_uv(width) / _F32(-focal),
                pixel_uv(height) / _F32(-focal), -1, spacing, device, dtype)
    return zs[::-1].copy(), rays


@float32_products()
def fit_step(hist, rows, stat, lut, density, toff, tscl, *, width, height,
             origin, focal, chunk, dtype, on_d_hist=None):
    """One fit step of the bins-major histogram volume ``hist (nz, B, ny,
    nx)``: the image, ``loss = mean((img - 0.25)^2)``, the loss's gradient
    to the LUT, and the samples the sweep evaluates (inside the box, before
    the cutoff). The gradient to the histograms is handed, a chunk of
    layers at a time, to ``on_d_hist(z0, z1, d)`` for layers ``[z0, z1)``;
    it is never whole. Computed in ``dtype``."""
    nz = hist.shape[0]
    dev = hist.device
    zs, rays = hist_rays(nz, width, height, focal, origin, dev, dtype)
    rows_c = torch.as_tensor(rows, device=dev).to(dtype)

    def run(acc, c0, c1, hc, lut_c, live=None):
        """Planes ``c0 .. c1 - 1`` from ``acc``; ``hc`` holds their layers
        ``nz - c1 .. nz - c0 - 1``, ascending."""
        dec = decode(hc, rows_c, stat)
        for k in range(c0, c1):
            z = float(zs[k])
            s, cov = rays.sample(dec[c1 - 1 - k], z)
            if live is not None:
                live += (cov & (acc[..., 3] <= THRESHOLD)).sum()
            acc = over(acc, shade(s, cov, lut_c, density, toff, tscl,
                                  rays.alpha_scale))
        return acc

    lut_c = torch.as_tensor(lut, device=dev).to(dtype)
    starts = list(range(0, nz, chunk))
    saved = []
    live = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        acc = torch.zeros((*rays.shape, 4), dtype=dtype, device=dev)
        for c0 in starts:
            c1 = min(c0 + chunk, nz)
            saved.append(acc)
            acc = run(acc, c0, c1, hist[nz - c1:nz - c0].to(dtype), lut_c,
                      live)
    img = acc.float()
    loss = torch.mean((img - 0.25) ** 2)
    g = ((2.0 / img.numel()) * (img - 0.25)).to(dtype)
    d_lut = torch.zeros(lut_c.shape, dtype=torch.float32, device=dev)
    for c0, acc0 in zip(reversed(starts), reversed(saved)):
        c1 = min(c0 + chunk, nz)
        with torch.enable_grad():
            hc = hist[nz - c1:nz - c0].to(dtype).requires_grad_()
            lc = lut_c.detach().requires_grad_()
            a0 = acc0.detach().requires_grad_()
            out = run(a0, c0, c1, hc, lc)
            dh, dl, g = torch.autograd.grad(out, [hc, lc, a0], g)
        if on_d_hist is not None:
            on_d_hist(nz - c1, nz - c0, dh)
        d_lut += dl.float()
    return img, loss, d_lut, int(live)


# ---- the frames ------------------------------------------------------------

def raw_stats(hist: torch.Tensor, dtype) -> torch.Tensor:
    """``(Z, Y, X, B)`` block histograms -> ``(Z, Y, X, 3)`` (mean,
    variance, entropy) as the reference's raw path: the mean over bin
    centres and the variance about it over left bin edges of the
    ``[0, MAX_HISTOGRAM]`` range, each normalized by its constant, and the
    Shannon entropy over ``log2 B``."""
    nb = hist.shape[-1]
    i = np.arange(nb, dtype=_F32)
    bw = MAX_HISTOGRAM / nb
    centers = _F32(bw) * i + _F32(bw / 2.0)
    edges = (i / _F32(nb)) * _F32(MAX_HISTOGRAM)
    dev = hist.device
    c = torch.as_tensor(centers, device=dev).to(dtype)
    e = torch.as_tensor(edges, device=dev).to(dtype)
    h = hist.to(dtype)
    mean = (h * c).sum(-1)
    var = (h * (e - mean[..., None]) ** 2).sum(-1) / VARIANCE_NORM
    safe = torch.where(h > 0, h, torch.ones_like(h))
    ent = -(h * torch.log2(safe)).sum(-1) / math.log2(nb)
    return torch.stack([mean / MEAN_NORM, var, ent], -1)


def preblend(vol: torch.Tensor, n_planes: int, dz_sign: int,
             tex_offset: float = 0.5):
    """``n_planes`` planes evenly through the box along the volume's first
    axis, front to back for ``dz_sign``, each the linear blend of the two
    layers about its depth (taps clamped to the edge): ``(planes, zs,
    spacing)``."""
    nz = vol.shape[0]
    spacing = (BOX_HI - BOX_LO) / n_planes
    zs = (BOX_LO + spacing * (np.arange(n_planes, dtype=_F32) + 0.5)).astype(_F32)
    if dz_sign < 0:
        zs = zs[::-1].copy()
    zf = (zs - BOX_LO) / (BOX_HI - BOX_LO) * nz - tex_offset
    f0 = np.floor(zf)
    az = torch.as_tensor((zf - f0).astype(_F32), device=vol.device)
    az = az.to(vol.dtype)[:, None, None]
    i0 = torch.as_tensor(np.clip(f0.astype(np.int64), 0, nz - 1),
                         device=vol.device)
    i1 = torch.as_tensor(np.clip(f0.astype(np.int64) + 1, 0, nz - 1),
                         device=vol.device)
    return vol[i0] * (1 - az) + vol[i1] * az, zs, spacing


def pack_u8(img: torch.Tensor) -> torch.Tensor:
    """RGBA in [0, 1] -> uint8, saturated and truncated (rgbaFloatToInt)."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


@float32_products()
def axis_frame(channel, inv_view, lut, density, brightness, toff, tscl, *,
               width, height, focal, n_planes, dtype):
    """The uint8 frame of the scalar ``(Z, Y, X)`` channel from an
    unrotated camera at ``inv_view[:, 3]``."""
    planes, zs, spacing = preblend(channel.to(dtype), n_planes, -1)
    rays = Rays(np.asarray(inv_view, _F32)[:, 3],
                pixel_uv(width) / _F32(-focal),
                pixel_uv(height) / _F32(-focal), -1, spacing,
                channel.device, dtype)
    lut_c = torch.as_tensor(lut, device=channel.device).to(dtype)
    return pack_u8(sweep(planes, zs, rays, lut_c, density, toff, tscl)
                   * brightness)


def _mgrid(lo, hi, n):
    """Origin and spacing of ``n`` slopes over ``[lo, hi]`` with a margin
    of one cell, in float32."""
    lo, hi = _F32(lo), _F32(hi)
    pad = max(_F32(1e-6), (hi - lo) / _F32(n))
    return _F32(lo - pad), _F32((hi - lo + _F32(2.0) * pad) / _F32(n - 1))


@float32_products()
def orbit_frame(channel, inv_view, lut, density, brightness, toff, tscl, *,
                width, height, focal, n_planes, oversample, dtype):
    """The uint8 frame of the scalar ``(Z, Y, X)`` channel for the rotated
    camera ``inv_view`` (3 x 4, rows of camera-to-world, translation in the
    last column) by the perspective shear-warp factorization: the volume
    axis nearest the view direction becomes the sweep's depth; the sweep
    runs over a uniform grid of ray slopes bounding the image's (the
    slopes are monotone along the image's edges, so the corners bound
    them), with ``oversample`` times the image's samples rounded up to a
    multiple of 128; each pixel then takes the bilinear sample of that
    image at its own slopes."""
    inv_view = np.asarray(inv_view, _F32)
    rot = inv_view[:, :3]
    view_dir = rot @ np.array([0.0, 0.0, -1.0], _F32)
    px, py, pz = _PERMS[int(np.argmax(np.abs(view_dir)))]
    uu, vv = np.meshgrid(np.array([-1.0, 1.0 - 2.0 / width], _F32),
                         np.array([-1.0, 1.0 - 2.0 / height], _F32))
    d = np.stack([uu, vv, _F32(-focal) * np.ones_like(uu)], -1) @ rot.T
    dz = d[..., pz]
    if not ((dz > 1e-6).all() or (dz < -1e-6).all()):
        raise ValueError("d_z changes sign over the image")
    dz_sign = 1 if float(dz[0, 0]) > 0 else -1
    mxc, myc = d[..., px] / dz, d[..., py] / dz
    wi = -(-max(8, math.ceil(width * oversample)) // 128) * 128
    hi = -(-max(8, math.ceil(height * oversample)) // 128) * 128
    mx0, dmx = _mgrid(mxc.min(), mxc.max(), wi)
    my0, dmy = _mgrid(myc.min(), myc.max(), hi)
    dev = channel.device
    vol_p = channel.permute(2 - pz, 2 - py, 2 - px).to(dtype)
    planes, zs, spacing = preblend(vol_p, n_planes, dz_sign)
    o = inv_view[:, 3]
    rays = Rays((o[px], o[py], o[pz]),
                mx0 + dmx * np.arange(wi, dtype=_F32),
                my0 + dmy * np.arange(hi, dtype=_F32), dz_sign, spacing, dev,
                dtype)
    lut_c = torch.as_tensor(lut, device=dev).to(dtype)
    img_m = sweep(planes, zs, rays, lut_c, density, toff, tscl) * brightness

    rot_t = torch.as_tensor(rot, device=dev)
    u = torch.as_tensor(pixel_uv(width), device=dev)[None, :]
    v = torch.as_tensor(pixel_uv(height), device=dev)[:, None]

    def d_world(i):
        return u * rot_t[i, 0] + v * rot_t[i, 1] - focal * rot_t[i, 2]

    ix = (d_world(px) / d_world(pz) - float(mx0)) / float(dmx)
    iy = (d_world(py) / d_world(pz) - float(my0)) / float(dmy)
    fx0, fy0 = torch.floor(ix), torch.floor(iy)
    x0 = fx0.to(torch.int64).clamp(0, wi - 1)
    y0 = fy0.to(torch.int64).clamp(0, hi - 1)
    x1, y1 = (x0 + 1).clamp(0, wi - 1), (y0 + 1).clamp(0, hi - 1)
    fx = (ix - fx0).to(dtype)[..., None]
    fy = (iy - fy0).to(dtype)[..., None]
    img = (img_m[y0, x0] * (1 - fx) * (1 - fy) + img_m[y0, x1] * fx * (1 - fy)
           + img_m[y1, x0] * (1 - fx) * fy + img_m[y1, x1] * fx * fy)
    return pack_u8(img)
