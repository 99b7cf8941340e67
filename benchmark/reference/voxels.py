"""The plain multi-view fit step of a per-voxel Gaussian volume (the
``fit-voxels`` job, BASELINE.json config 3): its loss, its renders, the
loss's gradients to ``(mu, log sigma)`` (:func:`fit_step`) and the Adam
update they make (:func:`adam_update`). The job's ground truth is made
here from the seed (:func:`blob_truth`), not taken from the program.

The parameters decode to two scalar channels, the mean ``mu`` and the
variance ``sigma^2`` (``sigma = exp(log sigma)``). Each view renders both
channels with the 9-entry grayscale LUT (the mean at TF scale 1, the
variance at ``1 / max(sigma_true)^2``), density 0.05, ``n_planes`` planes;
the loss is the mean over views of the two channels' mean squared errors
against the same renders of the ground truth, which this module makes
itself. A view is a rotation (rx, ry) in degrees about x and y of a camera
at distance 4 (:func:`camera`). The unrotated view is the plane sweep along
z (``sweep.axis_frame``'s camera); a rotated one is the perspective
shear-warp factorization (``sweep.orbit_frame``): the volume axis nearest
the view direction becomes the sweep's depth (a permutation), the planes
are swept over a uniform grid of ray slopes bounding the image's with
``oversample`` times its samples rounded up to a multiple of ``round_to``,
front to back in the direction of the rays' ``d_z``, and each pixel takes
the bilinear sample of that image at its own slopes.

The gradients come from plain autograd, a chunk of planes at a time, as
``sweep.fit_step`` does: the forward keeps the accumulated RGBA at each
chunk's start; the backward replays one chunk from its saved start, its
planes made again from the layers they blend, and hands the start's
cotangent to the chunk before it. The warp is differentiated whole. A
chunk's planes are sampled and shaded together, and only on the rays that
enter the box on one of them: the others keep their colour through it.

Departures from the published description (``fit-voxels`` of the JAX
package, ``vrdd_tpu/cli.py``), each also the program's:

- the m-grid is rounded up to a multiple of 128 (``round_to``), the TPU
  kernel's tiling that the port keeps because it sets the sampling;
  ``round_to=1`` is the 'xla' backend's grid;
- the TF's derivative at an exact knot is the slope of the interval below
  (JAX's kernel; JAX's plain sweep takes the mean of both);
- the LUT is read by a gather of its two knots, not by the one-hot row
  product of ``sweep.tf_lookup``: the same values, and the LUT takes no
  gradient here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.sweep import (
    _PERMS,
    BOX_HI,
    BOX_LO,
    THRESHOLD,
    Rays,
    _mgrid,
    float32_products,
    over,
    pixel_uv,
    taps,
)

_F32 = np.float32
DISTANCE = 4.0
DENSITY = 0.05


def view_list(views: int, view_angle: float) -> list:
    """The first ``views`` of (0, 0), (a, 0), (0, a), (-a, 0), (0, -a)."""
    a = float(view_angle)
    return [(0.0, 0.0), (a, 0.0), (0.0, a), (-a, 0.0), (0.0, -a)][
        : max(1, views)]


def camera(rx: float, ry: float) -> np.ndarray:
    """The 3 x 4 camera-to-world matrix of the view: the modelview
    ``Rx(-rx) Ry(-ry) T(0, 0, -4)``'s top rows, in float64 then float32."""
    ax, ay = np.deg2rad(-rx), np.deg2rad(-ry)
    cx, sx, cy, sy = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay)
    m = np.eye(4)
    m[:3, :3] = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
                 @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]))
    t = np.eye(4)
    t[2, 3] = DISTANCE
    return (m @ t)[:3].astype(_F32)


def grayscale_lut() -> np.ndarray:
    g = np.linspace(0.0, 1.0, 9, dtype=_F32)
    return np.stack([g, g, g, g], -1)


def tf_gather(s, lut, tscl):
    """RGBA of the clamped, linearly filtered LUT at the scalars ``s`` (TF
    offset 0): the knots' gather. Off the clamp, the derivative in ``s`` is
    the slope of the knot interval that ends at or after the coordinate;
    on it, 0."""
    n = lut.shape[0]
    q_raw = s * (tscl * n) - 0.5
    inside = (q_raw > 0.0) & (q_raw < n - 1.0)
    q = torch.where(inside, q_raw, q_raw.clamp(0.0, n - 1.0).detach())
    i0 = (torch.ceil(q) - 1.0).clamp(0, n - 2)
    f = (q - i0)[..., None]
    k = i0.detach().to(torch.int64)
    return lut[k] * (1 - f) + lut[k + 1] * f


def shade(s, covered, lut, tscl, alpha_scale):
    col = tf_gather(s, lut, tscl)
    a = torch.where(covered,
                    torch.clamp(col[..., 3] * DENSITY * alpha_scale, max=1.0),
                    0.0)
    return torch.cat([col[..., :3] * a[..., None], a[..., None]], -1)


class View:
    """One camera over one ``(Z, Y, X)`` volume shape: the permutation that
    puts the sweep's depth first, the planes' depths and their two layers
    and weight along it, the rays, and (rotated) the warp's taps."""

    def __init__(self, rx, ry, shape, *, image, n_planes, oversample, focal,
                 round_to, device, dtype):
        self.rotated = (rx, ry) != (0.0, 0.0)
        inv_view = camera(rx, ry)
        rot, o = inv_view[:, :3], inv_view[:, 3]
        self.perm = (0, 1, 2)
        dz_sign = -1
        if self.rotated:
            view_dir = rot @ np.array([0.0, 0.0, -1.0], _F32)
            px, py, pz = _PERMS[int(np.argmax(np.abs(view_dir)))]
            self.perm = (2 - pz, 2 - py, 2 - px)
            uu, vv = np.meshgrid(
                np.array([-1.0, 1.0 - 2.0 / image], _F32),
                np.array([-1.0, 1.0 - 2.0 / image], _F32))
            d = (np.stack([uu, vv, _F32(-focal) * np.ones_like(uu)], -1)
                 @ rot.T)
            dz = d[..., pz]
            if not ((dz > 1e-6).all() or (dz < -1e-6).all()):
                raise ValueError("d_z changes sign over the image")
            dz_sign = 1 if float(dz[0, 0]) > 0 else -1
            mxc, myc = d[..., px] / dz, d[..., py] / dz
            wi = max(8, math.ceil(image * oversample))
            wi = -(-wi // round_to) * round_to
            mx0, dmx = _mgrid(mxc.min(), mxc.max(), wi)
            my0, dmy = _mgrid(myc.min(), myc.max(), wi)
            mx = mx0 + dmx * np.arange(wi, dtype=_F32)
            my = my0 + dmy * np.arange(wi, dtype=_F32)
            origin = (o[px], o[py], o[pz])
            self._warp_taps(rot, (px, py, pz), (mx0, dmx, my0, dmy), wi,
                            image, focal, device, dtype)
        else:
            mx = my = pixel_uv(image) / _F32(-focal)
            origin = tuple(o)
        nz = shape[self.perm[0]]
        spacing = (BOX_HI - BOX_LO) / n_planes
        zs = (BOX_LO + spacing * (np.arange(n_planes, dtype=_F32) + 0.5)
              ).astype(_F32)
        if dz_sign < 0:
            zs = zs[::-1].copy()
        zf = (zs - BOX_LO) / (BOX_HI - BOX_LO) * nz - 0.5
        f0 = np.floor(zf)
        self.zs = zs
        self.i0 = np.clip(f0.astype(np.int64), 0, nz - 1)
        self.i1 = np.clip(f0.astype(np.int64) + 1, 0, nz - 1)
        self.az = (zf - f0).astype(_F32)
        self.rays = Rays(origin, mx, my, dz_sign, spacing, device, dtype)
        self.mx_host = np.asarray(mx, np.float64)
        self.my_host = np.asarray(my, np.float64)
        self.device, self.dtype = device, dtype

    def _warp_taps(self, rot, perm_world, mgrid, wi, image, focal, device,
                   dtype):
        px, py, pz = perm_world
        mx0, dmx, my0, dmy = mgrid
        rot_t = torch.as_tensor(rot, device=device)
        u = torch.as_tensor(pixel_uv(image), device=device)[None, :]
        v = torch.as_tensor(pixel_uv(image), device=device)[:, None]

        def d_world(i):
            return u * rot_t[i, 0] + v * rot_t[i, 1] - focal * rot_t[i, 2]

        ix = (d_world(px) / d_world(pz) - float(mx0)) / float(dmx)
        iy = (d_world(py) / d_world(pz) - float(my0)) / float(dmy)
        fx0, fy0 = torch.floor(ix), torch.floor(iy)
        x0 = fx0.to(torch.int64).clamp(0, wi - 1)
        y0 = fy0.to(torch.int64).clamp(0, wi - 1)
        x1, y1 = (x0 + 1).clamp(0, wi - 1), (y0 + 1).clamp(0, wi - 1)
        fx = (ix - fx0).to(dtype)[..., None]
        fy = (iy - fy0).to(dtype)[..., None]
        self.warp_taps = (x0, x1, y0, y1, fx, fy)

    def warp(self, img_m):
        """The ``(H, W, 4)`` image of the m-space image (rotated views)."""
        x0, x1, y0, y1, fx, fy = self.warp_taps
        return (img_m[y0, x0] * (1 - fx) * (1 - fy)
                + img_m[y0, x1] * fx * (1 - fy)
                + img_m[y1, x0] * (1 - fx) * fy + img_m[y1, x1] * fx * fy)

    def layers(self, c0, c1):
        """The first and one past the last layer planes ``c0 .. c1 - 1``
        blend."""
        lo = int(min(self.i0[c0:c1].min(), self.i1[c0:c1].min()))
        hi = int(max(self.i0[c0:c1].max(), self.i1[c0:c1].max())) + 1
        return lo, hi

    def rect(self, c0, c1):
        """The rows and columns of the rays some plane ``c0 .. c1 - 1``
        covers (inside the box there), with a margin of two rays, or None.
        The other rays' samples are all outside the box: they leave the
        accumulated RGBA as it is, so the chunk skips them."""
        dz = self.zs[c0:c1].astype(np.float64) - self.rays.oz

        def span(grid, o):
            a, b = (BOX_LO - o) / dz, (BOX_HI - o) / dz
            lo, hi = np.minimum(a, b).min(), np.maximum(a, b).max()
            hit = np.nonzero((grid >= lo) & (grid <= hi))[0]
            if hit.size == 0:
                return None
            return slice(max(int(hit[0]) - 2, 0),
                         min(int(hit[-1]) + 3, grid.size))

        rows = span(self.my_host, self.rays.oy)
        cols = span(self.mx_host, self.rays.ox)
        return None if rows is None or cols is None else (rows, cols)

    def run(self, acc, c0, c1, seg, lo, lut, tscl, rect, live=None):
        """Planes ``c0 .. c1 - 1`` over ``acc``, the rays of ``rect``
        (``(h, w, 4)``), from the layers ``seg`` (the permuted volume's
        ``lo ..``), each plane the lerp of its two layers; ``live`` adds
        the samples evaluated (inside the box, before the cutoff). The
        planes are sampled and shaded together (``sweep.Rays.sample``'s and
        ``sweep.resample``'s arithmetic, a gather a plane), then composited
        one by one."""
        rows, cols = rect
        dev, rays = seg.device, self.rays
        i0 = torch.as_tensor(self.i0[c0:c1] - lo, device=dev)
        i1 = torch.as_tensor(self.i1[c0:c1] - lo, device=dev)
        az = torch.as_tensor(self.az[c0:c1], device=dev).to(seg.dtype)
        az = az[:, None, None]
        planes = seg.index_select(0, i0) * (1 - az) + seg.index_select(
            0, i1) * az
        n_p, ny, nx = planes.shape
        dz = torch.as_tensor([float(z) - rays.oz for z in self.zs[c0:c1]],
                             dtype=torch.float32, device=dev)[:, None]
        y0, y1, ay, iny = taps(dz * rays.my[rows][None, :] + rays.oy, ny,
                               rays.dtype)
        x0, x1, ax, inx = taps(dz * rays.mx[cols][None, :] + rays.ox, nx,
                               rays.dtype)
        h, w = y0.shape[1], x0.shape[1]
        tmp = (planes.gather(1, y0[:, :, None].expand(n_p, h, nx))
               * (1 - ay)[:, :, None]
               + planes.gather(1, y1[:, :, None].expand(n_p, h, nx))
               * ay[:, :, None])
        s = (tmp.gather(2, x0[:, None, :].expand(n_p, h, w))
             * (1 - ax)[:, None, :]
             + tmp.gather(2, x1[:, None, :].expand(n_p, h, w))
             * ax[:, None, :])
        cov = iny[:, :, None] & inx[:, None, :]
        rgba = shade(s, cov, lut, tscl, rays.alpha_scale[rows, cols])
        for k in range(c0, c1):
            if not rays.in_front(float(self.zs[k])):
                continue
            if live is not None:
                live += (cov[k - c0] & (acc[..., 3] <= THRESHOLD)).sum()
            acc = over(acc, rgba[k - c0])
        return acc


def _permuted(vol, view):
    return vol.permute(view.perm).contiguous()


def _unpermute(d, view):
    inv = [0, 0, 0]
    for i, p in enumerate(view.perm):
        inv[p] = i
    return d.permute(inv)


def render(vol, view: View, lut, tscl, chunk, live=None, keep=False):
    """The view's ``(H, W, 4)`` image of the scalar channel ``vol``; with
    ``keep`` the m-space image (rotated views) and what :func:`render_grad`
    needs (the permuted channel and each chunk's start on its rays)."""
    vol_p = _permuted(vol, view)
    n_planes = len(view.zs)
    acc = torch.zeros((*view.rays.shape, 4), dtype=view.dtype,
                      device=vol.device)
    saved = []
    with torch.no_grad():
        for c0 in range(0, n_planes, chunk):
            c1 = min(c0 + chunk, n_planes)
            rect = view.rect(c0, c1)
            if rect is None:
                saved.append(None)
                continue
            lo, hi = view.layers(c0, c1)
            if keep:
                saved.append(acc[rect].clone())
            acc[rect] = view.run(acc[rect], c0, c1, vol_p[lo:hi], lo, lut,
                                 tscl, rect, live)
    if not keep:
        return view.warp(acc) if view.rotated else acc
    return acc, (vol_p, saved)


def render_grad(view: View, kept, img_m, g, lut, tscl, chunk):
    """The channel's cotangent ``(Z, Y, X)`` float32 for the image's
    cotangent ``g``: the warp's transpose (rotated views), then the chunks
    replayed back to front, each on its rays."""
    vol_p, saved = kept
    if view.rotated:
        with torch.enable_grad():
            m = img_m.detach().requires_grad_()
            (g,) = torch.autograd.grad(view.warp(m), [m], g)
    g = g.clone()
    d_vol = torch.zeros(vol_p.shape, dtype=torch.float32, device=g.device)
    n_planes = len(view.zs)
    starts = list(range(0, n_planes, chunk))
    for c0, acc0 in zip(reversed(starts), reversed(saved)):
        if acc0 is None:
            continue
        c1 = min(c0 + chunk, n_planes)
        rect = view.rect(c0, c1)
        lo, hi = view.layers(c0, c1)
        with torch.enable_grad():
            seg = vol_p[lo:hi].detach().requires_grad_()
            a0 = acc0.requires_grad_()
            out = view.run(a0, c0, c1, seg, lo, lut, tscl, rect)
            d_seg, d_a0 = torch.autograd.grad(out, [seg, a0], g[rect],
                                              allow_unused=True)
        if d_seg is not None:
            d_vol[lo:hi] += d_seg.float()
        g[rect] = d_a0
    return _unpermute(d_vol, view)


def blob(n: int, seed: int, device, n_blobs: int = 4):
    """A sum-of-Gaussians ``(n, n, n)`` float32 volume in [0, 1] from
    ``seed``: for each of ``n_blobs`` blobs a centre uniform in [0.2, 0.8]^3,
    a width uniform in [0.05, 0.2] and an amplitude uniform in [0.5, 1],
    drawn in that order from numpy's default generator; the grid is
    ``linspace(0, 1, n)`` on each axis, the sum is taken in float64 on
    ``device`` and divided by its largest value."""
    rng = np.random.default_rng(seed)
    g = torch.linspace(0, 1, n, dtype=torch.float64, device=device)
    vol = torch.zeros((n, n, n), dtype=torch.float64, device=device)
    for _ in range(n_blobs):
        c = rng.uniform(0.2, 0.8, size=3)
        s = rng.uniform(0.05, 0.2)
        a = rng.uniform(0.5, 1.0)
        vol += a * torch.exp(-(((g - c[0]) ** 2)[:, None, None]
                               + ((g - c[1]) ** 2)[:, None]
                               + (g - c[2]) ** 2) / (2 * s * s))
    return (vol / vol.max()).to(torch.float32)


def blob_truth(n: int, seed: int, device):
    """The job's ground truth ``(mu, sigma)``: ``mu`` the blob of ``seed``,
    ``sigma = 0.05 + 0.15 blob`` of ``seed + 1``."""
    return blob(n, seed, device), 0.05 + 0.15 * blob(n, seed + 1, device)


def adam_update(params, grads, state, *, lr, betas, eps,
                dtype=torch.float32):
    """The parameters after one Adam step (Kingma and Ba, with bias
    correction, no weight decay), computed in ``dtype`` and returned in
    float32: ``state`` holds each parameter's ``(exp_avg, exp_avg_sq,
    step)`` before the step (a step of 0 and zero moments for a fresh
    optimizer)."""
    b1, b2 = betas
    out = []
    for p, g, (m, v, t) in zip(params, grads, state):
        p, g, m, v = (x.to(dtype) for x in (p, g, m, v))
        t = int(t) + 1
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = lr / (1 - b1 ** t)
        denom = torch.sqrt(v) / math.sqrt(1 - b2 ** t) + eps
        out.append((p - step * m / denom).float())
    return out


def decode(mu, log_sigma, dtype):
    """The mean and variance channels in ``dtype``."""
    sigma = torch.exp(log_sigma.to(dtype))
    return mu.to(dtype), sigma * sigma


def _setup(truth, views, view_angle, image, n_planes, oversample, focal,
           round_to, dtype):
    mu_true, sigma_true = truth
    dev = mu_true.device
    n_planes = n_planes or 2 * mu_true.shape[0]
    var_scale = 1.0 / float(torch.max(sigma_true) ** 2)
    lut = torch.as_tensor(grayscale_lut(), device=dev).to(dtype)
    cams = [View(rx, ry, tuple(mu_true.shape), image=image,
                 n_planes=n_planes, oversample=oversample, focal=focal,
                 round_to=round_to, device=dev, dtype=dtype)
            for rx, ry in view_list(views, view_angle)]
    return cams, lut, (1.0, var_scale)


@float32_products()
def fit_step(mu, log_sigma, truth, *, views, view_angle, image, n_planes=0,
             oversample=2.0, focal=2.0, round_to=128, chunk=8,
             dtype=torch.float32):
    """One step's ``(loss, renders, d_mu, d_log_sigma, live)`` at the
    parameters ``(mu, log_sigma)`` for the ground truth ``truth = (mu,
    sigma)``: the loss a float32 scalar, the renders one ``(mean, variance)``
    pair of ``(H, W, 4)`` images a view, the gradients float32 like the
    parameters, ``live`` the samples the forward evaluated. ``n_planes`` 0
    is ``2 n``. Computed in ``dtype``, the loss and the gradients' sums in
    float32."""
    cams, lut, tscls = _setup(truth, views, view_angle, image, n_planes,
                              oversample, focal, round_to, dtype)
    live = torch.zeros((), dtype=torch.int64, device=mu.device)
    targets = decode(truth[0], torch.log(truth[1]), dtype)
    chans = decode(mu, log_sigma, dtype)
    loss = torch.zeros((), dtype=torch.float32, device=mu.device)
    renders, grads = [], [None, None]
    for view in cams:
        pair = []
        for c, (ch, tgt, tscl) in enumerate(zip(chans, targets, tscls)):
            want = render(tgt, view, lut, tscl, chunk).float()
            img_m, kept = render(ch, view, lut, tscl, chunk, live, keep=True)
            img = (view.warp(img_m) if view.rotated else img_m).float()
            loss += torch.mean((img - want) ** 2)
            g = ((2.0 / img.numel() / len(cams)) * (img - want)).to(dtype)
            d = render_grad(view, kept, img_m, g, lut, tscl, chunk)
            grads[c] = d if grads[c] is None else grads[c] + d
            pair.append(img)
        renders.append(tuple(pair))
    with torch.enable_grad():
        ls = log_sigma.detach().to(dtype).requires_grad_()
        sigma = torch.exp(ls)
        (d_ls,) = torch.autograd.grad(sigma * sigma, [ls],
                                      grads[1].to(dtype))
    return (loss / len(cams), renders, grads[0], d_ls.float(), int(live))
