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
(``use_custom_vjp``, :class:`_AnalyticSweep`). ``acc_init`` seeds the sweep
with a premultiplied RGBA image and resumes the "over" recursion from it
(a streamed decode chunk, the back half of a split stack); its cotangent is
``d seed_rgb = g_rgb``, ``d seed_a = g_a - P_total / T_0`` with
``T_0 = 1 - seed_a``. ``compute_dtype`` is float32 throughout.

``precision='bf16'`` is the plain version of the kernels' bf16 mode (JAX's
``precision='bf16'``, ``vrdd_tpu/pallas/slice_kernel.py:1324``): the two
matmuls of the resample take bf16-rounded operands, the intermediate
``tmp`` included, and accumulate in f32; the planes' cotangent is JAX's
transpose (:class:`_Bf16Resample`).
"""

from __future__ import annotations

import numpy as np
import torch

from vrdd_tpu_torch.utils import profiling
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


def _tent_weights(
    coords: torch.Tensor, n: int, lo: float, hi: float,
    tex_offset: float = 0.5, scale: float = 1.0, linear: bool = True,
) -> torch.Tensor:
    """The dense weights of :func:`_axis_weights` in JAX's tent form
    (``vrdd_tpu/pallas/slice_kernel.py`` ``_tent_weights``, :222): ``q =
    clip(p01 * n * scale - tex_offset, 0, n - 1)``, ``w_l = max(0, 1 - |q -
    l|)``, zero rows outside the box. The same values up to rounding; the
    bf16 mode takes these, whose rounding the kernels' ``axis_taps`` and
    the TPU kernel share, so that bf16 rounds the same weights."""
    p01 = (coords - lo) / (hi - lo)
    q = torch.clamp(p01 * float(np.float32(n) * np.float32(scale))
                    - tex_offset, 0.0, n - 1.0)
    if not linear:
        q = torch.floor(q + 0.5)
    cols = torch.arange(n, device=coords.device, dtype=coords.dtype)
    w = torch.clamp(1.0 - torch.abs(q[:, None] - cols), min=0.0)
    in_box = (p01 >= 0.0) & (p01 <= 1.0)
    return torch.where(in_box[:, None], w, 0.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bfloat16 (ties to even), in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _Bf16Resample(torch.autograd.Function):
    """JAX's bf16 resample of a chunk of planes and its transpose.

    Forward: ``tmp = r(wy) @ r(planes)``, ``res = r(tmp) @ r(wx)^T`` with
    ``r`` the rounding to bf16 and f32 sums (vrdd_tpu/pallas/
    slice_kernel.py:969-973, :1011-1015). Backward, the planes' cotangent
    of vrdd_tpu/pallas/slice_vjp.py:486-528: ``dtmp = r(d_res) @ r(wx)``
    summed over the image row, then ``d_planes = r(wy)^T @ r(dtmp)``. The
    weights are geometry and get no cotangent. Autograd through the casts
    would round the cotangents elsewhere (torch's backward of ``.to(bf16)``
    rounds the gradient), so the transpose is written out."""

    @staticmethod
    def forward(ctx, wy, planes, wx):
        wy, wx = _bf16(wy), _bf16(wx)
        ctx.save_for_backward(wy, wx)
        tmp = _bf16(torch.bmm(wy, _bf16(planes)))
        return torch.bmm(tmp, wx.transpose(1, 2))

    @staticmethod
    def backward(ctx, d_res):
        wy, wx = ctx.saved_tensors
        d_planes = None
        if ctx.needs_input_grad[1]:
            d_planes = bf16_y_transpose(wy, torch.bmm(_bf16(d_res), wx))
        return None, d_planes, None


def bf16_y_transpose(wy: torch.Tensor, dtmp: torch.Tensor) -> torch.Tensor:
    """``r(wy)^T @ r(dtmp)`` per plane: ``wy (P, H, NY)``, the row sums
    ``dtmp (P, H, NX)`` -> ``(P, NY, NX)``; the plain version of the bf16
    backward's y-transpose kernel (``csrc/dplane_bf16.cu``)."""
    return torch.bmm(_bf16(wy).transpose(1, 2), _bf16(dtmp))


class _TentLookup(torch.autograd.Function):
    """``col = sum_l max(0, 1 - |q - l|) lut[l]`` at the clamped coordinate
    ``q (...,)`` -> ``(..., 4)``, with JAX's kernel's derivative in ``q``
    (vrdd_tpu/pallas/slice_vjp.py:466): the slope of the knot interval below
    ``q``, ``lut[ceil(q)] - lut[ceil(q) - 1]``, for ``0 < q < n - 1`` and 0
    at the clamp's ends. At a knot (an integer ``q``: frequent in the bf16
    mode) that is the interval ending there; autograd through the tent would
    add both intervals' slopes. The LUT's cotangent is the tent weights'."""

    @staticmethod
    def forward(ctx, q, lut):
        ctx.save_for_backward(q, lut)
        col = None
        for li in range(lut.shape[0]):
            w = torch.clamp(1.0 - torch.abs(q - li), min=0.0)[..., None]
            term = w * lut[li]
            col = term if col is None else col + term
        return col

    @staticmethod
    def backward(ctx, g):
        q, lut = ctx.saved_tensors
        n = lut.shape[0]
        d_q = d_lut = None
        if ctx.needs_input_grad[0]:
            ls = (torch.ceil(q) - 1.0).clamp(0, n - 2).long()
            slope = lut[ls + 1] - lut[ls]
            d_q = torch.where((q > 0.0) & (q < n - 1.0),
                              (g * slope).sum(-1), 0.0)
        if ctx.needs_input_grad[1]:
            d_lut = torch.stack([
                (torch.clamp(1.0 - torch.abs(q - li), min=0.0)[..., None] * g)
                .reshape(-1, g.shape[-1]).sum(0) for li in range(n)])
        return d_q, d_lut


def _tf_onehot_matmul(sample, lut, offset, scale) -> torch.Tensor:
    """TF lookup as an unrolled tent-basis sum: scalars (...,) -> RGBA (..., 4).

    With ``q = clip(u * n - 0.5, 0, n - 1)``, clamped linear LUT interpolation
    is ``col = sum_l max(0, 1 - |q - l|) * lut[l]`` (:class:`_TentLookup`:
    its derivative in ``q`` is JAX's kernel's).
    """
    n = lut.shape[0]
    q = torch.clamp((sample - offset) * scale * n - 0.5, 0.0, n - 1.0)
    return _TentLookup.apply(q, lut)


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
    with profiling.annotate("sweep.preblend"):
        nz = volume.shape[0]
        zlo, zhi = box_min[2], box_max[2]
        spacing = (zhi - zlo) / n_planes
        zs = (zlo + spacing * (np.arange(n_planes, dtype=np.float32)
                               + 0.5)).astype(np.float32)
        if dz_sign < 0:
            zs = zs[::-1].copy()
        zf_all = (zs - zlo) / (zhi - zlo) * (nz * z_scale) - tex_offset
        iz0_all = np.floor(zf_all)
        az = (zf_all - iz0_all).astype(np.float32)
        if not filter_linear:  # point sampling: the z lerp's near tap
            az = np.floor(az + 0.5).astype(np.float32)
        dev = volume.device
        iz1 = profiling.to_device(
            np.clip(iz0_all.astype(np.int64) + 1, 0, nz - 1), dev, "preblend")
        iz0 = profiling.to_device(
            np.clip(iz0_all.astype(np.int64), 0, nz - 1), dev, "preblend")
        if np.all(az < 1e-6):
            return volume[iz0], zs
        azj = profiling.to_device(az, dev, "preblend")[:, None, None]
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
                   filter_linear, dev, ess=None, precision="f32"):
    """The per-chunk plane decode of the sweep (``chunk_rgba`` of
    ``vrdd_tpu/march/slice.py:297``): ``f(c0, planes, lut, density, toff,
    tscl)`` -> premultiplied RGBA ``(C, H, W, 4)`` of planes ``c0 ..
    c0 + C``: separable resample (batched matmuls), TF lookup, opacity
    scaling and coverage masking; everything except compositing. The
    camera geometry is fixed (the origin gets no cotangent, as in JAX).

    ``ess = (bitmap, chunk, (tile_h, tile_w))``: the empty-space-skipping
    bitmap of ``kernels.slice_kernel.ess_bitmap``; samples of a culled
    (tile, chunk) get alpha exactly 0, as the kernel skips them.
    ``precision='bf16'``: the resample of :class:`_Bf16Resample` on the
    tent-form weights (:func:`_tent_weights`)."""
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
    if ess is not None:
        bitmap, ess_chunk, (tile_h, tile_w) = ess
        tile_i = torch.arange(height, device=dev) // tile_h
        tile_j = torch.arange(width, device=dev) // tile_w

    weights = _tent_weights if precision == "bf16" else _axis_weights

    def chunk_rgba(c0, planes, lut, density, toff, tscl):
        chunk = planes.shape[0]
        z = zs_t[c0:c0 + chunk]
        x_at = ox + (z[:, None] - oz) * mx_t[None, :]  # (C, W)
        y_at = oy + (z[:, None] - oz) * my_t[None, :]  # (C, H)
        wx = weights(
            x_at.reshape(-1), nx, xlo, xhi, tex_offset, sx, filter_linear
        ).reshape(chunk, width, nx)
        wy = weights(
            y_at.reshape(-1), ny, ylo, yhi, tex_offset, sy, filter_linear
        ).reshape(chunk, height, ny)
        if precision == "bf16":
            resampled = _Bf16Resample.apply(wy, planes, wx)
        else:
            tmp = torch.bmm(wy, planes)  # (C, H, X)
            resampled = torch.bmm(tmp, wx.transpose(1, 2))  # (C, H, W)
        col = _tf_onehot_matmul(resampled, lut, toff, tscl)
        in_front = (torch.sign(z - oz) * dz_sign) > 0  # (C,)
        covered = (
            (torch.sum(torch.abs(wy), dim=2) > 0.0)[:, :, None]
            & (torch.sum(torch.abs(wx), dim=2) > 0.0)[:, None, :]
            & in_front[:, None, None]
        )
        if ess is not None:
            ks = torch.arange(c0, c0 + chunk, device=dev) // ess_chunk
            covered = covered & (bitmap[ks][:, tile_i][:, :, tile_j] != 0)
        # opacity is a probability: clamp to 1 (the slab length correction
        # can overshoot), keeping alpha monotone for the cutoff
        a = torch.where(
            covered,
            torch.clamp(col[..., 3] * density * alpha_scale[None], max=1.0),
            0.0,
        )
        return torch.cat([col[..., :3] * a[..., None], a[..., None]], dim=-1)

    return chunk_rgba


def _composite(chunk_rgba, planes_all, args, plane_chunk, thr, shape,
               acc0=None):
    """The masked front-to-back "over" of every chunk's RGBA, from the seed
    ``acc0`` (zeros when None)."""
    acc = (torch.zeros((*shape, 4), dtype=torch.float32,
                       device=planes_all.device) if acc0 is None else acc0)
    for c0 in range(0, planes_all.shape[0], plane_chunk):
        rgba = chunk_rgba(c0, planes_all[c0:c0 + plane_chunk], *args)
        for k in range(rgba.shape[0]):
            new_acc = acc + rgba[k] * (1.0 - acc[..., 3:4])
            acc = torch.where(acc[..., 3:4] > thr, acc, new_acc)
    return acc


def _p_total(chunk_rgba, planes, args, chunk, thr, g, T0):
    """Pass 1 of the VJP: ``P_total = sum_k m_k (g . c_k) T_{k-1}`` per ray,
    the transmittance starting at ``T0``."""
    T, ptot = T0, torch.zeros_like(T0)
    for c0 in range(0, planes.shape[0], chunk):
        rgba = chunk_rgba(c0, planes[c0:c0 + chunk], *args)
        for k in range(rgba.shape[0]):
            m = T >= 1.0 - thr
            ptot = ptot + torch.where(m, torch.sum(g * rgba[k], -1) * T, 0.0)
            T = torch.where(m, T * (1.0 - rgba[k][..., 3]), T)
    return ptot


def _seed_t0(acc0, shape, dev):
    """The transmittance entering plane 0: ``1 - seed_a`` (1 unseeded)."""
    if acc0 is None:
        return torch.ones(shape, dtype=torch.float32, device=dev)
    return 1.0 - acc0[..., 3]


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
    A seed ``acc0`` starts T at ``T_0 = 1 - seed_a``; every later T is
    proportional to it, so ``d seed_rgb = g_rgb`` and ``d seed_a = g_a -
    P_total / T_0`` (0 where ``T_0 <= 1e-6``: a saturated seed has
    ``P_total = 0``). The plain version of the reverse-sweep kernel (K5)."""

    @staticmethod
    def forward(ctx, chunk_rgba, plane_chunk, thr, shape, planes, lut,
                density, toff, tscl, acc0):
        ctx.chunk_rgba, ctx.plane_chunk, ctx.thr = chunk_rgba, plane_chunk, thr
        ctx.save_for_backward(planes, lut, density, toff, tscl, acc0)
        return _composite(chunk_rgba, planes, (lut, density, toff, tscl),
                          plane_chunk, thr, shape, acc0)

    @staticmethod
    def backward(ctx, g):
        planes, lut, density, toff, tscl, acc0 = ctx.saved_tensors
        chunk_rgba, chunk, thr = ctx.chunk_rgba, ctx.plane_chunk, ctx.thr
        need = ctx.needs_input_grad[4:9]
        args = (lut, density, toff, tscl)
        n_planes = planes.shape[0]
        T0 = _seed_t0(acc0, g.shape[:2], g.device)

        # pass 1: P_total
        ptot = _p_total(chunk_rgba, planes, args, chunk, thr, g, T0)

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
        d_acc0 = None
        if ctx.needs_input_grad[9]:
            live = T0 > 1e-6
            d_a = g[..., 3] - torch.where(
                live, ptot / torch.where(live, T0, 1.0), 0.0)
            d_acc0 = torch.cat([g[..., :3], d_a[..., None]], -1)
        return (None, None, None, None, *grads, d_acc0)


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
    ess=None,
    acc_init=None,
    precision: str = "f32",
) -> torch.Tensor:
    """Masked "over" sweep over an ALREADY pre-blended plane stack.

    ``planes_all (P, NY, NX)`` is front-to-back, ``zs (P,)`` its plane
    depths, ``mx``/``my`` the slope grids. ``plane_spacing`` must be the FULL
    stack's inter-plane distance when ``planes_all`` is a partial stack.
    Planes are processed ``plane_chunk`` at a time (batched matmuls); the
    chunking changes memory, not the result. ``acc_init`` is an optional
    ``(H, W, 4)`` premultiplied-RGBA seed the "over" recursion resumes from:
    seeded pixels past the opacity threshold stay frozen.

    Gradients flow to the planes, the LUT, ``density``, the TF offset and
    scale (tensors that require grad), ``brightness`` and the seed. With
    ``use_custom_vjp`` (the default) the backward is the analytic two-pass
    VJP (:class:`_AnalyticSweep`, O(chunk) memory); ``False`` is plain
    autograd through the forward, the oracle the tests hold it against.
    ``ess`` and ``precision``: see :func:`_chunk_rgba_fn`.
    """
    dev = planes_all.device
    planes_all = planes_all.to(torch.float32)
    n_planes, ny, nx = planes_all.shape
    width, height = np.asarray(mx).shape[0], np.asarray(my).shape[0]
    chunk_rgba = _chunk_rgba_fn(
        n_planes, ny, nx, zs, origin, mx, my, march, dz_sign, plane_spacing,
        length_correction, tex_offset, axis_scale, filter_linear, dev, ess,
        precision,
    )

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    args = (f32(tf_lut), f32(density), f32(transfer_offset),
            f32(transfer_scale))
    acc0 = None if acc_init is None else f32(acc_init)
    thr = march.opacity_threshold
    if use_custom_vjp:
        acc = _AnalyticSweep.apply(chunk_rgba, plane_chunk, thr,
                                   (height, width), planes_all, *args, acc0)
    else:
        acc = _composite(chunk_rgba, planes_all, args, plane_chunk, thr,
                         (height, width), acc0)
    return acc * brightness


def transmittance_checkpoints(
    planes_all: torch.Tensor, zs, origin, mx, my, tf_lut, density=0.05,
    transfer_offset=0.0, transfer_scale=1.0,
    march: MarchConfig = MarchConfig(), *, ck_stride: int, dz_sign: int = -1,
    plane_spacing=None, length_correction: bool = True,
    tex_offset: float = 0.5, axis_scale=(1.0, 1.0),
    filter_linear: bool = True, ess=None, acc_init=None,
    precision: str = "f32", live_tile=None,
):
    """The backward's transmittance ``T`` at the start of every block of
    ``ck_stride`` planes: ``(ceil(P / ck_stride), H, W)``, with the
    recursion ``T <- T - [T >= 1 - thr] T a`` (vrdd_tpu/pallas/slice_kernel.py
    :1046-1051) from ``T_0 = 1 - seed_a`` (1 without ``acc_init``). The
    plain version of the checkpoints K4 writes; ``ess`` and ``precision``:
    see :func:`_chunk_rgba_fn`.

    ``live_tile = (tile_h, tile_w)`` also returns the plain version of K4's
    live map: uint8 ``(n_chunks, ceil(H / tile_h), ceil(W / tile_w))``, 1
    where some ray of the tile is not done at the chunk's first plane (its
    image alpha at most the cutoff, or its T still at least ``1 - thr``),
    and the map of the tiles where some ray's alpha or T lies within
    :data:`LIVE_TIE` of its cutoff there (a kernel that rounds in another order may
    decide those rays either way). The result is then ``(tck, live,
    tied)``."""
    dev = planes_all.device
    planes_all = planes_all.to(torch.float32)
    n_planes, ny, nx = planes_all.shape
    chunk_rgba = _chunk_rgba_fn(
        n_planes, ny, nx, zs, origin, mx, my, march, dz_sign, plane_spacing,
        length_correction, tex_offset, axis_scale, filter_linear, dev, ess,
        precision,
    )
    lut = torch.as_tensor(tf_lut, dtype=torch.float32, device=dev)
    thr = march.opacity_threshold
    acc0 = (None if acc_init is None
            else torch.as_tensor(acc_init, dtype=torch.float32, device=dev))
    shape = (np.asarray(my).shape[0], np.asarray(mx).shape[0])
    T = _seed_t0(acc0, shape, dev)
    # the image's alpha, for the live map's done test
    acc_a = (torch.zeros(shape, dtype=torch.float32, device=dev)
             if acc0 is None else acc0[..., 3])
    rows, live, tied = [], [], []
    for c0 in range(0, n_planes, ck_stride):
        rows.append(T)
        if live_tile is not None:
            live.append(_tile_any(~((acc_a > thr) & ~(T >= 1.0 - thr)),
                                  live_tile))
            tied.append(_tile_any(((acc_a - thr).abs() <= LIVE_TIE)
                                  | ((T - (1.0 - thr)).abs() <= LIVE_TIE),
                                  live_tile))
        a = chunk_rgba(c0, planes_all[c0:c0 + ck_stride], lut, density,
                       transfer_offset, transfer_scale)[..., 3]
        for k in range(a.shape[0]):
            T = T - torch.where(T >= 1.0 - thr, T, 0.0) * a[k]
            acc_a = torch.where(acc_a > thr, acc_a,
                                acc_a + a[k] * (1.0 - acc_a))
    if live_tile is not None:
        return torch.stack(rows), torch.stack(live), torch.stack(tied)
    return torch.stack(rows)


#: how close to a cutoff a ray's alpha or T may lie for a kernel that rounds
#: in another order to decide its liveness either way (the live map's ties)
LIVE_TIE = 1e-6


def _tile_any(mask: torch.Tensor, tile) -> torch.Tensor:
    """uint8 ``(ceil(H / th), ceil(W / tw))``: 1 where some element of the
    ``(th, tw)`` tile of the ``(H, W)`` mask is set."""
    th, tw = tile
    H, W = mask.shape
    pad = torch.zeros((-(-H // th) * th, -(-W // tw) * tw), dtype=torch.bool,
                      device=mask.device)
    pad[:H, :W] = mask
    return pad.reshape(pad.shape[0] // th, th, pad.shape[1] // tw,
                       tw).any(3).any(1).to(torch.uint8)


def sweep_p_total(
    planes_all: torch.Tensor, zs, origin, mx, my, tf_lut, density=0.05,
    transfer_offset=0.0, transfer_scale=1.0,
    march: MarchConfig = MarchConfig(), *, g, acc_init=None,
    dz_sign: int = -1, plane_spacing=None, length_correction: bool = True,
    plane_chunk: int = 8, tex_offset: float = 0.5, axis_scale=(1.0, 1.0),
    filter_linear: bool = True, precision: str = "f32",
) -> torch.Tensor:
    """``P_total = sum_k m_k (g . c_k) T_{k-1}`` per ray for the image
    cotangent ``g (H, W, 4)``, T starting at ``1 - seed_a``: the ``(H, W)``
    total the seed cotangent needs (``d seed_a = g_a - P_total / T_0``).
    The plain version of the ``S`` image the reverse-sweep kernel writes."""
    dev = planes_all.device
    planes_all = planes_all.to(torch.float32)
    n_planes, ny, nx = planes_all.shape
    chunk_rgba = _chunk_rgba_fn(
        n_planes, ny, nx, zs, origin, mx, my, march, dz_sign, plane_spacing,
        length_correction, tex_offset, axis_scale, filter_linear, dev,
        precision=precision,
    )
    args = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in
            (tf_lut, density, transfer_offset, transfer_scale)]
    g = torch.as_tensor(g, dtype=torch.float32, device=dev)
    acc0 = (None if acc_init is None
            else torch.as_tensor(acc_init, dtype=torch.float32, device=dev))
    with torch.no_grad():
        return _p_total(chunk_rgba, planes_all, args, plane_chunk,
                        march.opacity_threshold, g,
                        _seed_t0(acc0, g.shape[:2], dev))


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
