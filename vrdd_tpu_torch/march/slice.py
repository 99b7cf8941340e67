"""Object-order slice sweep in plain torch ops, with its analytic VJP.

The counterpart of ``vrdd_tpu/march/slice.py`` and the plain version of the
hand-written sweep kernels (``kernels/slice_kernel.py``, forward;
``kernels/slice_vjp.py``, checkpoints and reverse sweep): the CPU path, and
the oracle the kernels are held against on the card.

Rays are parameterized by their slope ``m = (d_x / d_z, d_y / d_z)``; on the
plane ``z = zk`` the ray sits at ``o + (zk - o_z) * m``, so every plane maps
onto the uniform slope grid by a per-plane scale and translate — a separable
resample ``Wy(zk) @ plane @ Wx(zk)^T`` with dense CUDA-model bilinear
weights (two nonzeros per row), done here as two batched matmuls exactly as
the JAX package does. The transfer function is an unrolled tent-basis sum
over the LUT, and compositing is the masked front-to-back "over" with the
opacity cutoff. Per-ray slab length ``dz * sqrt(1 + mx^2 + my^2)`` corrects
the opacity (``length_correction``).

The backward is the JAX package's analytic two-pass VJP
(``use_custom_vjp``, :class:`_AnalyticSweep`); the seeded resume
(``acc_init``) is later work; ``compute_dtype`` is float32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from vrdd_tpu_torch.utils.config import MarchConfig


def _axis_weights(
    coords: torch.Tensor, n: int, lo: float, hi: float,
    tex_offset: float = 0.5, scale: float = 1.0, linear: bool = True,
) -> torch.Tensor:
    """Dense CUDA-model bilinear weight matrix (P, n) for world coords (P,).

    Out-of-box coords (outside [lo, hi]) get all-zero rows; in-box coords
    clamp to edge texels exactly like the texture unit. ``tex_offset`` 0.5 is
    the CUDA texture model (texel centers at (i + 0.5) / n), 0.0 the block
    grid of query 7; ``scale`` decouples the filter grid from the coverage
    box (flexible blocks); ``linear=False`` is point sampling.
    """
    p01 = (coords - lo) / (hi - lo)
    xf = p01 * (n * scale) - tex_offset
    i0 = torch.floor(xf)
    a = xf - i0
    if not linear:
        a = torch.floor(a + 0.5)
    i0i = i0.to(torch.int64)
    lo_idx = i0i.clamp(0, n - 1)
    hi_idx = (i0i + 1).clamp(0, n - 1)
    in_box = (p01 >= 0.0) & (p01 <= 1.0)
    cols = torch.arange(n, device=coords.device)
    w = (
        torch.where(cols == lo_idx[:, None], (1.0 - a)[:, None], 0.0)
        + torch.where(cols == hi_idx[:, None], a[:, None], 0.0)
    )
    return torch.where(in_box[:, None], w, 0.0)


def _tf_onehot_matmul(sample, lut, offset, scale) -> torch.Tensor:
    """TF lookup as an unrolled tent-basis sum: scalars (...,) -> RGBA (..., 4).

    With ``q = clip(u * n - 0.5, 0, n - 1)``, clamped linear LUT interpolation
    is ``col = sum_l max(0, 1 - |q - l|) * lut[l]``.
    """
    n = lut.shape[0]
    q = torch.clamp((sample - offset) * scale * n - 0.5, 0.0, n - 1.0)
    col = None
    for li in range(n):
        w = torch.clamp(1.0 - torch.abs(q - li), min=0.0)[..., None]
        term = w * lut[li]
        col = term if col is None else col + term
    return col


def preblend_planes(volume, n_planes, box_min, box_max, dz_sign=-1,
                    tex_offset=0.5, z_scale=1.0, filter_linear=True):
    """Front-to-back plane stack ``(n_planes, ny, nx)`` and its depths.

    CUDA-model z-resample by a static two-tap gather lerp; BOTH taps clamp
    from the unclipped floor, so a below-range sample hits the edge texel
    twice, exactly like the texture unit (``vrdd_tpu/march/slice.py``
    :193-213 and ``vrdd_tpu/pallas/slice_kernel.py`` ``_preblend_planes``).
    When every lerp weight is 0 the stack is a pure (reversed) selection.
    Returns ``(planes, zs)`` with ``zs`` a host float32 array.
    """
    nz = volume.shape[0]
    zlo, zhi = box_min[2], box_max[2]
    spacing = (zhi - zlo) / n_planes
    zs = (zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)).astype(
        np.float32
    )
    if dz_sign < 0:
        zs = zs[::-1].copy()
    zf_all = (zs - zlo) / (zhi - zlo) * (nz * z_scale) - tex_offset
    iz0_all = np.floor(zf_all)
    az = (zf_all - iz0_all).astype(np.float32)
    if not filter_linear:  # point sampling: snap the z lerp to the near tap
        az = np.floor(az + 0.5).astype(np.float32)
    iz1 = torch.as_tensor(
        np.clip(iz0_all.astype(np.int64) + 1, 0, nz - 1), device=volume.device
    )
    iz0 = torch.as_tensor(
        np.clip(iz0_all.astype(np.int64), 0, nz - 1), device=volume.device
    )
    if np.all(az < 1e-6):
        return volume[iz0], zs
    azj = torch.as_tensor(az, device=volume.device)[:, None, None]
    return volume[iz0] * (1.0 - azj) + volume[iz1] * azj, zs


def sweep_slope_space(
    volume: torch.Tensor,
    origin,
    mx: np.ndarray,
    my: np.ndarray,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    march: MarchConfig = MarchConfig(),
    dz_sign: int = -1,
    n_planes: int = 0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    tex_offset: float = 0.5,
    axis_scale=(1.0, 1.0, 1.0),
    filter_linear: bool = True,
    use_custom_vjp: bool = True,
) -> torch.Tensor:
    """Plane sweep over a ray-slope grid: returns ``(Hi, Wi, 4)`` RGBA.

    ``volume`` is a scalar field ``(Z, Y, X)`` on any device; ``origin`` the
    camera position (volume axes); ``mx (Wi,)`` / ``my (Hi,)`` host slope
    grids; ``dz_sign`` the common sign of d_z over the grid. ``n_planes``
    defaults to 2 * Z.
    """
    if n_planes <= 0:
        n_planes = 2 * volume.shape[0]
    planes_all, zs = preblend_planes(
        volume, n_planes, march.box_min, march.box_max, dz_sign, tex_offset,
        z_scale=axis_scale[2], filter_linear=filter_linear,
    )
    return sweep_preblended_planes_xla(
        planes_all, zs, origin, mx, my, tf_lut, density, brightness,
        transfer_offset, transfer_scale, march, dz_sign=dz_sign,
        plane_spacing=(march.box_max[2] - march.box_min[2]) / n_planes,
        length_correction=length_correction, plane_chunk=plane_chunk,
        use_custom_vjp=use_custom_vjp, tex_offset=tex_offset,
        axis_scale=axis_scale[:2], filter_linear=filter_linear,
    )


def _chunk_rgba_fn(n_planes, ny, nx, zs, origin, mx, my, march, dz_sign,
                   plane_spacing, length_correction, tex_offset, axis_scale,
                   filter_linear, dev):
    """The per-chunk plane decode of the sweep (``chunk_rgba`` of
    ``vrdd_tpu/march/slice.py:297``): ``f(c0, planes, lut, density, toff,
    tscl)`` -> premultiplied RGBA ``(C, H, W, 4)`` of planes ``c0 ..
    c0 + C``: separable resample (batched matmuls), TF lookup, opacity
    scaling and coverage masking; everything except compositing. The
    camera geometry is fixed (the origin gets no cotangent, as in JAX)."""
    (xlo, ylo, zlo) = march.box_min
    (xhi, yhi, zhi) = march.box_max
    mx = np.asarray(mx, dtype=np.float32)
    my = np.asarray(my, dtype=np.float32)
    width, height = mx.shape[0], my.shape[0]
    zs_t = torch.as_tensor(np.asarray(zs, np.float32), device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev).detach()
    ox, oy, oz = origin[0], origin[1], origin[2]
    sx, sy = axis_scale
    if plane_spacing is None:
        plane_spacing = (zhi - zlo) / n_planes
    stretch = np.sqrt(1.0 + my[:, None] ** 2 + mx[None, :] ** 2)
    alpha_scale = torch.as_tensor(
        (plane_spacing * stretch / march.tstep).astype(np.float32)
        if length_correction
        else np.ones((height, width), dtype=np.float32),
        device=dev,
    )
    mx_t = torch.as_tensor(mx, device=dev)
    my_t = torch.as_tensor(my, device=dev)

    def chunk_rgba(c0, planes, lut, density, toff, tscl):
        chunk = planes.shape[0]
        z = zs_t[c0:c0 + chunk]
        x_at = ox + (z[:, None] - oz) * mx_t[None, :]  # (C, W)
        y_at = oy + (z[:, None] - oz) * my_t[None, :]  # (C, H)
        wx = _axis_weights(
            x_at.reshape(-1), nx, xlo, xhi, tex_offset, sx, filter_linear
        ).reshape(chunk, width, nx)
        wy = _axis_weights(
            y_at.reshape(-1), ny, ylo, yhi, tex_offset, sy, filter_linear
        ).reshape(chunk, height, ny)
        tmp = torch.bmm(wy, planes)  # (C, H, X)
        resampled = torch.bmm(tmp, wx.transpose(1, 2))  # (C, H, W)
        col = _tf_onehot_matmul(resampled, lut, toff, tscl)
        in_front = (torch.sign(z - oz) * dz_sign) > 0  # (C,)
        covered = (
            (torch.sum(torch.abs(wy), dim=2) > 0.0)[:, :, None]
            & (torch.sum(torch.abs(wx), dim=2) > 0.0)[:, None, :]
            & in_front[:, None, None]
        )
        # opacity is a probability: clamp to 1 (the slab length correction
        # can overshoot), keeping alpha monotone for the cutoff
        a = torch.where(
            covered,
            torch.clamp(col[..., 3] * density * alpha_scale[None], max=1.0),
            0.0,
        )
        return torch.cat([col[..., :3] * a[..., None], a[..., None]], dim=-1)

    return chunk_rgba


def _composite(chunk_rgba, planes_all, args, plane_chunk, thr, shape):
    """The masked front-to-back "over" of every chunk's RGBA."""
    acc = torch.zeros((*shape, 4), dtype=torch.float32,
                      device=planes_all.device)
    for c0 in range(0, planes_all.shape[0], plane_chunk):
        rgba = chunk_rgba(c0, planes_all[c0:c0 + plane_chunk], *args)
        for k in range(rgba.shape[0]):
            new_acc = acc + rgba[k] * (1.0 - acc[..., 3:4])
            acc = torch.where(acc[..., 3:4] > thr, acc, new_acc)
    return acc


class _AnalyticSweep(torch.autograd.Function):
    """The analytic two-pass VJP of the sweep (vrdd_tpu/march/slice.py
    :372-454): with ``T_{k-1}`` the prefix transmittance, ``m_k`` the freeze
    mask and ``P_k = m_k (g . c_k) T_{k-1}``, pass 1 totals ``P``, pass 2
    recomputes each chunk's RGBA under autograd and transposes it with the
    per-plane cotangents

        dL/dc_k[rgb] = m_k T_{k-1} g[rgb]
        dL/dc_k[a]   = m_k (T_{k-1} g[a] - S_k / (1 - a_k)),
        S_k = sum_{j>k} P_j,

    so the backward holds one chunk's graph at a time, never the planes'.
    The plain version of the reverse-sweep kernel (K5)."""

    @staticmethod
    def forward(ctx, chunk_rgba, plane_chunk, thr, shape, planes, lut,
                density, toff, tscl):
        ctx.chunk_rgba, ctx.plane_chunk, ctx.thr = chunk_rgba, plane_chunk, thr
        ctx.save_for_backward(planes, lut, density, toff, tscl)
        return _composite(chunk_rgba, planes, (lut, density, toff, tscl),
                          plane_chunk, thr, shape)

    @staticmethod
    def backward(ctx, g):
        planes, lut, density, toff, tscl = ctx.saved_tensors
        chunk_rgba, chunk, thr = ctx.chunk_rgba, ctx.plane_chunk, ctx.thr
        need = ctx.needs_input_grad[4:]
        args = (lut, density, toff, tscl)
        n_planes = planes.shape[0]
        T0 = torch.ones(g.shape[:2], dtype=torch.float32, device=g.device)

        # pass 1: P_total
        T, ptot = T0, torch.zeros_like(T0)
        for c0 in range(0, n_planes, chunk):
            rgba = chunk_rgba(c0, planes[c0:c0 + chunk], *args)
            for k in range(rgba.shape[0]):
                m = T >= 1.0 - thr
                ptot = ptot + torch.where(m, torch.sum(g * rgba[k], -1) * T, 0.0)
                T = torch.where(m, T * (1.0 - rgba[k][..., 3]), T)

        # pass 2: per-plane cotangents, transposed chunk by chunk
        grads = [torch.zeros_like(planes) if need[0] else None] + [
            torch.zeros_like(t) if n else None for t, n in zip(args, need[1:])
        ]
        T, ppre = T0, torch.zeros_like(T0)
        for c0 in range(0, n_planes, chunk):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) for t, n in
                          zip((planes[c0:c0 + chunk], *args), need)]
                rgba = chunk_rgba(c0, *leaves)
            d_rgba = []
            for k in range(rgba.shape[0]):
                c_k = rgba[k].detach()
                m = T >= 1.0 - thr
                ppre = ppre + torch.where(m, torch.sum(g * c_k, -1) * T, 0.0)
                s_k = ptot - ppre
                mT = torch.where(m, T, 0.0)
                one_minus_a = 1.0 - c_k[..., 3]
                chain = torch.where(torch.abs(one_minus_a) > 1e-6,
                                    s_k / one_minus_a, 0.0)
                d_a = torch.where(m, T * g[..., 3] - chain, 0.0)
                d_rgba.append(torch.cat([mT[..., None] * g[..., :3],
                                         d_a[..., None]], -1))
                T = torch.where(m, T * one_minus_a, T)
            wanted = [(i, t) for i, t in enumerate(leaves) if need[i]]
            if not wanted:
                continue
            got = torch.autograd.grad(rgba, [t for _, t in wanted],
                                      torch.stack(d_rgba), allow_unused=True)
            for (i, _), d in zip(wanted, got):
                if d is None:
                    continue
                if i == 0:
                    grads[0][c0:c0 + chunk] += d
                else:
                    grads[i] += d
        return (None, None, None, None, *grads)


def sweep_preblended_planes_xla(
    planes_all: torch.Tensor,
    zs,
    origin,
    mx: np.ndarray,
    my: np.ndarray,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    march: MarchConfig = MarchConfig(),
    *,
    dz_sign: int = -1,
    plane_spacing=None,
    length_correction: bool = True,
    plane_chunk: int = 8,
    use_custom_vjp: bool = True,
    tex_offset: float = 0.5,
    axis_scale=(1.0, 1.0),
    filter_linear: bool = True,
) -> torch.Tensor:
    """Masked "over" sweep over an ALREADY pre-blended plane stack.

    ``planes_all (P, NY, NX)`` is front-to-back, ``zs (P,)`` its plane
    depths, ``mx``/``my`` the slope grids. ``plane_spacing`` must be the FULL
    stack's inter-plane distance when ``planes_all`` is a partial stack.
    Planes are processed ``plane_chunk`` at a time (batched matmuls); the
    chunking changes memory, not the result.

    Gradients flow to the planes, the LUT, ``density``, the TF offset and
    scale (tensors that require grad) and ``brightness``. With
    ``use_custom_vjp`` (the default) the backward is the analytic two-pass
    VJP (:class:`_AnalyticSweep`, O(chunk) memory); ``False`` is plain
    autograd through the forward, the oracle the tests hold it against.
    """
    dev = planes_all.device
    planes_all = planes_all.to(torch.float32)
    n_planes, ny, nx = planes_all.shape
    width, height = np.asarray(mx).shape[0], np.asarray(my).shape[0]
    chunk_rgba = _chunk_rgba_fn(
        n_planes, ny, nx, zs, origin, mx, my, march, dz_sign, plane_spacing,
        length_correction, tex_offset, axis_scale, filter_linear, dev,
    )

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    args = (f32(tf_lut), f32(density), f32(transfer_offset),
            f32(transfer_scale))
    thr = march.opacity_threshold
    if use_custom_vjp:
        acc = _AnalyticSweep.apply(chunk_rgba, plane_chunk, thr,
                                   (height, width), planes_all, *args)
    else:
        acc = _composite(chunk_rgba, planes_all, args, plane_chunk, thr,
                         (height, width))
    return acc * brightness


def transmittance_checkpoints(
    planes_all: torch.Tensor, zs, origin, mx, my, tf_lut, density=0.05,
    transfer_offset=0.0, transfer_scale=1.0,
    march: MarchConfig = MarchConfig(), *, ck_stride: int, dz_sign: int = -1,
    plane_spacing=None, length_correction: bool = True,
    tex_offset: float = 0.5, axis_scale=(1.0, 1.0),
    filter_linear: bool = True,
) -> torch.Tensor:
    """The backward's transmittance ``T`` at the start of every block of
    ``ck_stride`` planes: ``(ceil(P / ck_stride), H, W)``, with the
    recursion ``T <- T - [T >= 1 - thr] T a`` (vrdd_tpu/pallas/slice_kernel.py
    :1046-1051). The plain version of the checkpoints K4 writes."""
    dev = planes_all.device
    planes_all = planes_all.to(torch.float32)
    n_planes, ny, nx = planes_all.shape
    chunk_rgba = _chunk_rgba_fn(
        n_planes, ny, nx, zs, origin, mx, my, march, dz_sign, plane_spacing,
        length_correction, tex_offset, axis_scale, filter_linear, dev,
    )
    lut = torch.as_tensor(tf_lut, dtype=torch.float32, device=dev)
    thr = march.opacity_threshold
    T = torch.ones((np.asarray(my).shape[0], np.asarray(mx).shape[0]),
                   dtype=torch.float32, device=dev)
    rows = []
    for c0 in range(0, n_planes, ck_stride):
        rows.append(T)
        a = chunk_rgba(c0, planes_all[c0:c0 + ck_stride], lut, density,
                       transfer_offset, transfer_scale)[..., 3]
        for k in range(a.shape[0]):
            T = T - torch.where(T >= 1.0 - thr, T, 0.0) * a[k]
    return torch.stack(rows)


def slice_render_image(
    volume: torch.Tensor,
    origin,
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
    length_correction: bool = True,
    plane_chunk: int = 8,
    tex_offset: float = 0.5,
    axis_scale=(1.0, 1.0, 1.0),
    filter_linear: bool = True,
    use_custom_vjp: bool = True,
) -> torch.Tensor:
    """Render ``(H, W, 4)`` RGBA by plane sweep (unrotated camera at ``origin``).

    The reference's NDC frustum looking down -z: ray slopes are
    ``m = (u, v) / -focal``, so the slope grid IS the pixel grid.
    """
    u = ((np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0).astype(
        np.float32
    )
    v = ((np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0).astype(
        np.float32
    )
    return sweep_slope_space(
        volume, origin, u / (-focal), v / (-focal), tf_lut,
        density, brightness, transfer_offset, transfer_scale, march,
        dz_sign=-1, n_planes=n_planes, length_correction=length_correction,
        plane_chunk=plane_chunk, tex_offset=tex_offset, axis_scale=axis_scale,
        filter_linear=filter_linear, use_custom_vjp=use_custom_vjp,
    )
