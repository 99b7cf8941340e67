"""Fused slice-sweep render kernels: wrappers, host pieces and plain versions.

The counterpart of ``vrdd_tpu/pallas/slice_kernel.py``. Two kernels, one
CUDA C++ source (``csrc/slice_sweep.cu``, built by ``kernels/_build.py``):

- **K1**, the scalar sweep over a front-to-back plane stack, launched by
  :func:`sweep_preblended_planes` (TPU: ``pallas_call`` at
  ``slice_kernel.py:1351``) and reached through :func:`pallas_slice_render`
  -> :func:`pallas_sweep_slope_space` -> :func:`_sweep_call`;
- **K2**, the same sweep with the per-voxel histogram decode (linear mean,
  variance, entropy) in its prologue, launched by :func:`pallas_hist_render`
  (TPU: ``pallas_call`` at ``slice_kernel.py:1595``), the ``render-hist``
  path.

Each wrapper dispatches on the device of its volume: a CUDA tensor goes to
the kernel, or the wrapper raises; a CPU tensor takes the plain torch
version (:func:`sweep_preblended_planes_reference`,
:func:`hist_render_reference`). There is no fallback from the card to the
plain version. Each wrapper counts its kernel launches in a plain int
attribute, ``sweep_preblended_planes.launches`` and
``pallas_hist_render.launches``.

Not ported yet (they raise ``NotImplementedError``): empty-space skipping
(``empty_space_skip``/``ess_stats``), the seeded resume (``acc_init``) and
``precision='bf16'``. The kernels take any image size, so the TPU's
padding, banding and VMEM budgets have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vrdd_tpu_torch.march.slice import (
    preblend_planes,
    sweep_preblended_planes_xla,
)
from vrdd_tpu_torch.utils.config import (
    FLEX_MAX_HISTOGRAM, MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM, MarchConfig,
)

#: decode mode of the kernel template (csrc/slice_sweep.cu DecodeMode)
_MODES = {"none": 0, "linear": 1, "var": 2, "entropy": 3}
#: decode-weight rows each histogram statistic contracts against
_N_ROWS = {"linear": 1, "var": 4, "entropy": 1}
#: the LUT and the decode rows share the kernel's 48 KB of dynamic shared
#: memory: (4 * n_lut + n_rows * B) floats
_SMEM_FLOATS = 48 * 1024 // 4


def _smem_ok(n_lut: int, row_elems: int) -> bool:
    return n_lut >= 1 and 4 * n_lut + row_elems <= _SMEM_FLOATS


def pallas_supported(
    volume_shape: Tuple[int, int, int], width: int, height: int,
    n_planes: int, n_lut: int = 9,
) -> bool:
    """Can K1 render this configuration? Any image size and volume shape;
    only the LUT must fit the kernel's shared memory."""
    return (
        len(volume_shape) == 3 and min(volume_shape) >= 1
        and width >= 1 and height >= 1 and n_planes >= 1
        and _smem_ok(n_lut, 0)
    )


def hist_render_supported(hist_shape, width: int, height: int,
                          n_lut: int = 9) -> bool:
    """Can K2 render this bins-major ``(nz, B, ny, nx)`` histogram volume?
    Any image size and volume shape; the LUT and the variance decode's four
    weight rows must fit the kernel's shared memory."""
    return (
        len(hist_shape) == 4 and min(hist_shape) >= 1
        and width >= 1 and height >= 1
        and _smem_ok(n_lut, 4 * hist_shape[1])
    )


def _uniform_grid_params(m: np.ndarray, name: str):
    """(m0, dm) of a uniform host grid; validates uniformity."""
    m = np.asarray(m, dtype=np.float32)
    if m.shape[0] < 2:
        return float(m[0]), 0.0
    dm = (float(m[-1]) - float(m[0])) / (m.shape[0] - 1)
    if not np.allclose(m, m[0] + dm * np.arange(m.shape[0]),
                       atol=1e-5 * (abs(dm) + 1e-6) * m.shape[0]):
        raise ValueError(f"{name} slope grid must be uniform for the sweep kernel")
    return float(m[0]), dm


def _pixel_slopes(width: int, height: int, focal: float):
    """The unrotated NDC pixel grid's ray slopes (march/slice.py semantics;
    not pixel-centred, exactly as the JAX package)."""
    u = ((np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0)
    v = ((np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0)
    return (u / (-focal)).astype(np.float32), (v / (-focal)).astype(np.float32)


def decode_weight_rows(stat: str, n_bins: int, *, family: str = "raw"):
    """Decode-weight rows + kernel combine mode for one histogram statistic.

    Returns ``(rows, mode)``: ``rows`` is the ``(n_w, B)`` float32 matrix the
    decode contracts against, ``mode`` the combine:

    - ``'mean'`` -> ``'linear'``, 1 row of bin centers (over the family's
      mean normalizer): dec = w . h;
    - ``'var'`` -> ``'var'``, 4 rows ``[m, s*e, s*e^2, s*1]``:
      dec = C2 - 2 m C1 + m^2 C0 = s * sum h (e - m)^2, no sum(h) = 1
      assumed. The raw family deviates around bin *edges* while the mean
      uses *centers* (volumeRender_kernel.cu:742-755);
    - ``'entropy'`` -> ``'entropy'``, 1 row whose [0, 0] is the 1/log2(B)
      normalizer (Shannon entropy, :761-769).

    ``family``: 'raw', 'fractal' (center deviation, :841-867), 'flex'
    ([0, 255] range, unnormalized, :1083-1115) or 'unit' (centers on
    [0, 1], no normalization).
    """
    vmax, mnorm, vnorm = {
        "raw": (MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM),
        "fractal": (MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM),
        "flex": (FLEX_MAX_HISTOGRAM, 1.0, 1.0),
        "unit": (1.0, 1.0, 1.0),
    }[family]
    bw = vmax / n_bins
    i = np.arange(n_bins, dtype=np.float64)
    centers = bw * i + bw / 2.0
    edges = (i / n_bins) * vmax
    if stat == "mean":
        return (centers / mnorm).astype(np.float32)[None, :], "linear"
    if stat == "var":
        e = edges if family == "raw" else centers
        s = 1.0 / vnorm
        rows = np.stack([
            centers, s * e, s * e * e, s * np.ones_like(e),
        ])
        return rows.astype(np.float32), "var"
    if stat == "entropy":
        rows = np.zeros((1, n_bins), dtype=np.float32)
        rows[0, 0] = 1.0 / np.log2(n_bins)
        return rows, "entropy"
    raise ValueError(f"unknown stat {stat!r}; use mean / var / entropy")


#: smallest positive value fed to log2 by the entropy chain; it only ever
#: multiplies an exactly-zero bin (vrdd_tpu/pallas/slice_kernel.py _ENT_TINY)
_ENT_TINY = 1e-30
_INV_LN2 = float(np.float32(1.0 / np.log(2.0)))


def _z_step(hist_bm: torch.Tensor) -> int:
    """z-layers per chunk of the materialized decode and its chains: about
    32 M float32 temporaries, so no float32 copy of the whole histogram
    volume exists (8.6 GB at 512^3 x 16)."""
    _, B, ny, nx = hist_bm.shape
    return max(1, (1 << 25) // (B * ny * nx))


def _moments(hf: torch.Tensor, rows: torch.Tensor):
    """(m, C1, C2, C0) of the variance decode of a float32 chunk."""
    return [torch.einsum("zbyx,b->zyx", hf, rows[r]) for r in range(4)]


def _decode_plain(hist_bm: torch.Tensor, rows: torch.Tensor,
                  mode: str) -> torch.Tensor:
    nz, B, ny, nx = hist_bm.shape
    out = torch.empty((nz, ny, nx), dtype=torch.float32, device=hist_bm.device)
    step = _z_step(hist_bm)
    for z0 in range(0, nz, step):
        hf = hist_bm[z0:z0 + step].to(torch.float32)
        if mode == "linear":
            dec = torch.einsum("zbyx,b->zyx", hf, rows[0])
        elif mode == "var":
            m, c1, c2, c0 = _moments(hf, rows)
            dec = c2 - 2.0 * m * c1 + m * m * c0
        else:
            safe = torch.where(hf > 0.0, hf, 1.0)
            dec = rows[0, 0] * torch.sum(-hf * torch.log2(safe), dim=1)
        out[z0:z0 + step] = dec
    return out


def decode_chain(hist_bm: torch.Tensor, rows: torch.Tensor, mode: str,
                 d_dec: torch.Tensor, mom=None) -> torch.Tensor:
    """The histogram cotangent from the decoded-volume cotangent ``d_dec``
    ``(nz, ny, nx)``, in the histogram's storage dtype (as
    vrdd_tpu/pallas/slice_vjp.py:874-908):

    - linear: ``d h_b = d_dec * w_b`` (a broadcast);
    - var: ``d h_b = d_dec * (w2_b - 2 m w1_b + m^2 w3_b + e w0_b)`` with the
      moments ``m`` and ``e = 2 (m C0 - C1)`` from ``mom (nz, 2, ny, nx)``
      (the reverse kernel writes them) or, without it, from the histograms;
    - entropy: ``d h_b = -d_dec * w00 (log2 h_b + 1/ln2)``, exactly 0 at
      ``h_b == 0``.

    Runs a few z-layers at a time: no ``(nz, B, ny, nx)`` float32 temporary
    exists. Shared by the in-kernel route's backward and the materialized
    decode's (:class:`_Decode`)."""
    d_hist = torch.empty_like(hist_bm)
    step = _z_step(hist_bm)
    for z0 in range(0, hist_bm.shape[0], step):
        sl = slice(z0, z0 + step)
        dz = d_dec[sl, None]
        if mode == "linear":
            d = dz * rows[0][None, :, None, None]
        elif mode == "var":
            if mom is not None:
                m, e = mom[sl, 0, None], mom[sl, 1, None]
            else:
                m, c1, _, c0 = _moments(hist_bm[sl].to(torch.float32), rows)
                e = (2.0 * (m * c0 - c1))[:, None]
                m = m[:, None]
            w = [r[None, :, None, None] for r in rows]
            d = dz * (w[2] - 2.0 * m * w[1] + m * m * w[3] + e * w[0])
        else:
            hf = hist_bm[sl].to(torch.float32)
            dlog = torch.where(
                hf > 0.0,
                -rows[0, 0] * (torch.log2(torch.clamp(hf, min=_ENT_TINY))
                               + _INV_LN2),
                0.0,
            )
            d = dz * dlog
        d_hist[sl] = d.to(hist_bm.dtype)
    return d_hist


def _decode_rows_grad(hist_bm, rows, mode, d_dec) -> torch.Tensor:
    """Cotangent of the decode rows, z-chunked."""
    d_rows = torch.zeros_like(rows)
    step = _z_step(hist_bm)
    for z0 in range(0, hist_bm.shape[0], step):
        hf = hist_bm[z0:z0 + step].to(torch.float32)
        dz = d_dec[z0:z0 + step]
        if mode == "linear":
            d_rows[0] += torch.einsum("zbyx,zyx->b", hf, dz)
        elif mode == "var":
            m, c1, _, c0 = _moments(hf, rows)
            # dec = C2 - 2 m C1 + m^2 C0: d/dm, d/dC1, d/dC2, d/dC0
            for r, dc in enumerate((2.0 * (m * c0 - c1), -2.0 * m,
                                    torch.ones_like(m), m * m)):
                d_rows[r] += torch.einsum("zbyx,zyx->b", hf, dz * dc)
        else:
            safe = torch.where(hf > 0.0, hf, 1.0)
            d_rows[0, 0] += torch.sum(
                dz * torch.sum(-hf * torch.log2(safe), dim=1))
    return d_rows


class _Decode(torch.autograd.Function):
    """The materialized decode under autograd, with the explicit z-chunked
    chain of :func:`decode_chain` as its backward: plain autograd through
    the chunked einsums would keep float32 copies of the histograms alive."""

    @staticmethod
    def forward(ctx, hist_bm, rows, mode):
        ctx.save_for_backward(hist_bm, rows)
        ctx.mode = mode
        return _decode_plain(hist_bm, rows, mode)

    @staticmethod
    def backward(ctx, d_dec):
        hist_bm, rows = ctx.saved_tensors
        d_dec = d_dec.contiguous()
        d_hist = d_rows = None
        if ctx.needs_input_grad[0]:
            d_hist = decode_chain(hist_bm, rows, ctx.mode, d_dec)
        if ctx.needs_input_grad[1]:
            d_rows = _decode_rows_grad(hist_bm, rows, ctx.mode, d_dec)
        return d_hist, d_rows, None


def decode_with_rows(hist_bm: torch.Tensor, rows, mode: str) -> torch.Tensor:
    """Materialized decode: bins-major ``(nz, B, ny, nx)`` histogram volume
    -> ``(nz, ny, nx)`` float32 scalar volume, same rows/mode as
    :func:`decode_weight_rows`. The plain version of K2's prologue.

    Works a few z-layers at a time, so no float32 copy of the whole
    histogram volume exists (8.6 GB at 512^3 x 16), in the forward or, under
    autograd, in the backward (:class:`_Decode`)."""
    if mode not in _N_ROWS:
        raise ValueError(f"unknown decode mode {mode!r}")
    rows = torch.as_tensor(rows, dtype=torch.float32, device=hist_bm.device)
    if rows.ndim == 1:
        rows = rows[None, :]
    if torch.is_grad_enabled() and (hist_bm.requires_grad
                                    or rows.requires_grad):
        return _Decode.apply(hist_bm, rows, mode)
    return _decode_plain(hist_bm, rows, mode)


def _host_floats(x, n: int) -> list:
    """A length-n vector (sequence, numpy array or tensor) as Python floats."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    vals = [float(v) for v in np.asarray(x, dtype=np.float32).reshape(-1)]
    if len(vals) != n:
        raise ValueError(f"expected {n} values, got {len(vals)}")
    return vals


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain
    version); any other device raises — there is no silent fallback."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: use 'cuda' or 'cpu'")


def _check_unported(precision, empty_space_skip=False, ess_stats=None,
                    acc_init=None):
    if precision != "f32":
        raise NotImplementedError(
            f"precision={precision!r}: only 'f32' is ported (ROADMAP.md queue 2)"
        )
    if empty_space_skip or ess_stats is not None:
        raise NotImplementedError(
            "empty-space skipping is not ported yet (ROADMAP.md queue 2, K1/K2 "
            "ess mode)"
        )
    if acc_init is not None:
        raise NotImplementedError(
            "the seeded sweep (acc_init) is not ported yet (ROADMAP.md queue 2, "
            "K1/K2 seed mode)"
        )


def _launch(vol: torch.Tensor, mode: str, zs, tf_lut, rows,
            params: dict, ck_stride: int = 0):
    """Validate, allocate the (H, W, 4) output and launch the CUDA kernel on
    the current stream of the volume's device. ``ck_stride > 0`` also writes
    the transmittance checkpoints (K4) and returns ``(out, tck)``."""
    from vrdd_tpu_torch.kernels import _build

    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"volume dtype {vol.dtype}: use float32 or bfloat16")
    if not vol.is_contiguous():
        raise ValueError("the volume must be contiguous")
    dev = vol.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()

    zs_t, lut_t = f32(zs), f32(tf_lut)
    rows_t = None if rows is None else f32(rows)  # K1 reads no decode rows
    if lut_t.ndim != 2 or lut_t.shape[1] != 4:
        raise ValueError(f"tf_lut must be (n_lut, 4), got {tuple(lut_t.shape)}")
    if zs_t.numel() != params["n_planes"]:
        raise ValueError("zs must hold one depth per plane")
    H, W = params["height"], params["width"]
    out = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    tck = None
    if ck_stride:
        n_chunks = -(-params["n_planes"] // ck_stride)
        tck = torch.empty((n_chunks, H, W), dtype=torch.float32, device=dev)
    p = _build.SweepParams(n_lut=lut_t.shape[0], **params)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vrdd_slice_sweep(
            p, _MODES[mode], int(vol.dtype == torch.bfloat16),
            vol.data_ptr(), zs_t.data_ptr(), lut_t.data_ptr(),
            None if rows_t is None else rows_t.data_ptr(), out.data_ptr(),
            ck_stride, None if tck is None else tck.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"vrdd_slice_sweep launch failed: CUDA error {rc}")
    return (out, tck) if ck_stride else out


def _sweep_params(origin, slopes, density, brightness, transfer_offset,
                  transfer_scale, spacing, march, *, width, height, ny, nx,
                  n_planes, n_layers, dz_sign, reverse, length_correction,
                  tex_offset, axis_scale, filter_linear, n_bins=1,
                  n_rows=1) -> dict:
    ox, oy, oz = _host_floats(origin, 3)
    mx0, dmx, my0, dmy = _host_floats(slopes, 4)
    return dict(
        ox=ox, oy=oy, oz=oz, density=float(density),
        brightness=float(brightness), tf_off=float(transfer_offset),
        tf_scale=float(transfer_scale), spacing=float(spacing),
        mx0=mx0, dmx=dmx, my0=my0, dmy=dmy,
        xlo=march.box_min[0], ylo=march.box_min[1],
        xhi=march.box_max[0], yhi=march.box_max[1],
        tstep=march.tstep, threshold=march.opacity_threshold,
        tex_offset=float(tex_offset), sx=float(axis_scale[0]),
        sy=float(axis_scale[1]), height=int(height), width=int(width),
        ny=int(ny), nx=int(nx), n_planes=int(n_planes),
        n_layers=int(n_layers), n_bins=int(n_bins), n_rows=int(n_rows),
        dz_sign=int(dz_sign), reverse=int(bool(reverse)),
        length_correction=int(bool(length_correction)),
        filter_linear=int(bool(filter_linear)),
    )


def _slope_grids(slopes, width: int, height: int):
    """The host slope grids ``mx0 + dmx * j``, ``my0 + dmy * i`` in float32,
    rounded as the kernels build them (multiply, then add)."""
    mx0, dmx, my0, dmy = _host_floats(slopes, 4)
    mx = np.float32(mx0) + np.float32(dmx) * np.arange(width, dtype=np.float32)
    my = np.float32(my0) + np.float32(dmy) * np.arange(height, dtype=np.float32)
    return mx, my


def sweep_preblended_planes_reference(
    planes_all, zs, origin, slopes, tf_lut, density=0.05, brightness=1.0,
    transfer_offset=0.0, transfer_scale=1.0, *, dz_sign=-1, width, height,
    march: MarchConfig = MarchConfig(), length_correction=True,
    plane_chunk=8, tex_offset=0.5, plane_spacing=None, axis_scale=(1.0, 1.0),
    filter_linear=True, reverse_planes=False,
):
    """Plain torch version of K1, on the device of ``planes_all``: the slope
    grid ``mx0 + dmx * j`` is built in float32 exactly as the kernel builds
    it, then :func:`sweep_preblended_planes_xla` sweeps (a flipped copy of
    the stack when ``reverse_planes``)."""
    mx, my = _slope_grids(slopes, width, height)
    if reverse_planes:
        planes_all = planes_all.flip(0)
    return sweep_preblended_planes_xla(
        planes_all, zs, origin, mx, my, tf_lut, density, brightness,
        transfer_offset, transfer_scale, march, dz_sign=dz_sign,
        plane_spacing=plane_spacing, length_correction=length_correction,
        plane_chunk=plane_chunk, tex_offset=tex_offset,
        axis_scale=axis_scale, filter_linear=filter_linear,
    )


def sweep_preblended_planes(
    planes_all, zs, origin, slopes, tf_lut, density=0.05, brightness=1.0,
    transfer_offset=0.0, transfer_scale=1.0, *, dz_sign=-1, width, height,
    march: MarchConfig = MarchConfig(), length_correction=True,
    precision="f32", plane_chunk=8, tex_offset=0.5, empty_space_skip=False,
    acc_init=None, plane_spacing=None, axis_scale=(1.0, 1.0),
    ess_stats=None, filter_linear=True, reverse_planes=False,
):
    """K1: fused sweep over an ALREADY pre-blended, front-to-back plane stack.

    ``planes_all (P, NY, NX)`` (float32 or bfloat16), ``zs (P,)`` plane
    depths in stack order, ``origin (3,)``, ``slopes (4,) = [mx0, dmx, my0,
    dmy]`` (ray ``(i, j)`` has slope ``(mx0 + dmx j, my0 + dmy i)``).
    ``reverse_planes``: the stack is stored z-ascending and walked back to
    front (plane p reads layer P-1-p), so a pure-selection schedule streams
    the volume itself. ``plane_spacing`` defaults to the box z-extent over P
    (only right for a full stack). ``plane_chunk`` sizes the plain version's
    batches; the kernel ignores it. Returns ``(height, width, 4)``.
    """
    _check_unported(precision, empty_space_skip, ess_stats, acc_init)
    n_planes, ny, nx = planes_all.shape
    if plane_spacing is None:
        plane_spacing = (march.box_max[2] - march.box_min[2]) / n_planes
    if not _on_card(planes_all):
        return sweep_preblended_planes_reference(
            planes_all, zs, origin, slopes, tf_lut, density, brightness,
            transfer_offset, transfer_scale, dz_sign=dz_sign, width=width,
            height=height, march=march, length_correction=length_correction,
            plane_chunk=plane_chunk, tex_offset=tex_offset,
            plane_spacing=plane_spacing, axis_scale=axis_scale,
            filter_linear=filter_linear, reverse_planes=reverse_planes,
        )
    if not pallas_supported(planes_all.shape, width, height, n_planes,
                            n_lut=len(tf_lut)):
        raise ValueError(
            f"the sweep kernel cannot render planes {tuple(planes_all.shape)} "
            f"-> {width}x{height} with a {len(tf_lut)}-entry LUT"
        )
    params = _sweep_params(
        origin, slopes, density, brightness, transfer_offset, transfer_scale,
        plane_spacing, march, width=width, height=height, ny=ny, nx=nx,
        n_planes=n_planes, n_layers=n_planes, dz_sign=dz_sign,
        reverse=reverse_planes, length_correction=length_correction,
        tex_offset=tex_offset, axis_scale=axis_scale,
        filter_linear=filter_linear,
    )
    out = _launch(planes_all, "none", zs, tf_lut, None, params)
    sweep_preblended_planes.launches += 1
    return out


sweep_preblended_planes.launches = 0


def _sweep_call(
    volume, origin, slopes, tf_lut, density, brightness, transfer_offset,
    transfer_scale, *, dz_sign, width, height, march, n_planes,
    length_correction, precision, plane_chunk, tex_offset=0.5,
    empty_space_skip=False, axis_scale=(1.0, 1.0, 1.0), ess_stats=None,
    filter_linear=True,
):
    nz = volume.shape[0]
    # PURE-SELECTION fast path: with n_planes == nz (and the default z
    # filter grid) every plane IS a volume layer, zf = (p+0.5)*nz/n_planes
    # - 0.5 = p exactly — so stream the volume itself and let the kernel
    # walk it back to front instead of materializing a flipped copy
    pure_sel = n_planes == nz and tex_offset == 0.5 and axis_scale[2] == 1.0
    if pure_sel:
        zlo, zhi = march.box_min[2], march.box_max[2]
        spacing = (zhi - zlo) / n_planes
        zs = (
            zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)
        ).astype(np.float32)
        if dz_sign < 0:
            zs = zs[::-1].copy()
        planes_all = volume
    else:
        planes_all, zs = preblend_planes(
            volume, n_planes, march.box_min, march.box_max, dz_sign,
            tex_offset, z_scale=axis_scale[2], filter_linear=filter_linear,
        )
    return sweep_preblended_planes(
        planes_all, zs, origin, slopes, tf_lut, density, brightness,
        transfer_offset, transfer_scale, dz_sign=dz_sign, width=width,
        height=height, march=march, length_correction=length_correction,
        precision=precision, plane_chunk=plane_chunk, tex_offset=tex_offset,
        empty_space_skip=empty_space_skip, axis_scale=axis_scale[:2],
        ess_stats=ess_stats, filter_linear=filter_linear,
        reverse_planes=pure_sel and dz_sign < 0,
    )


def pallas_sweep_slope_space(
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
    dz_sign: int = -1,
    n_planes: int = 0,
    length_correction: bool = True,
    precision: str = "f32",
    plane_chunk: int = 8,
    tex_offset: float = 0.5,
    empty_space_skip: bool = False,
    axis_scale=(1.0, 1.0, 1.0),
    ess_stats=None,
    filter_linear: bool = True,
) -> torch.Tensor:
    """Fused plane sweep over a UNIFORM ray-slope grid: (Hm, Wm, 4) RGBA.

    ``mx (Wm,)`` / ``my (Hm,)`` are host slope grids of any length;
    ``n_planes`` defaults to 2 * Z."""
    mx0, dmx = _uniform_grid_params(mx, "mx")
    my0, dmy = _uniform_grid_params(my, "my")
    if n_planes <= 0:
        n_planes = 2 * volume.shape[0]
    return _sweep_call(
        volume, origin, (mx0, dmx, my0, dmy), tf_lut, density, brightness,
        transfer_offset, transfer_scale, dz_sign=int(dz_sign),
        width=int(np.asarray(mx).shape[0]), height=int(np.asarray(my).shape[0]),
        march=march, n_planes=n_planes, length_correction=length_correction,
        precision=precision, plane_chunk=plane_chunk,
        tex_offset=float(tex_offset), empty_space_skip=empty_space_skip,
        axis_scale=tuple(axis_scale), ess_stats=ess_stats,
        filter_linear=filter_linear,
    )


def pallas_slice_render(
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
    focal: float = 2.0,
    n_planes: int = 0,
    length_correction: bool = True,
    precision: str = "f32",
    plane_chunk: int = 8,
    tex_offset: float = 0.5,
    empty_space_skip: bool = False,
    axis_scale=(1.0, 1.0, 1.0),
    ess_stats=None,
    filter_linear: bool = True,
) -> torch.Tensor:
    """Fused forward render of a scalar ``(nz, ny, nx)`` volume; same
    semantics as ``march.slice.slice_render_image``."""
    if n_planes <= 0:
        n_planes = 2 * volume.shape[0]
    mx, my = _pixel_slopes(width, height, focal)
    return pallas_sweep_slope_space(
        volume, origin, mx, my, tf_lut, density, brightness,
        transfer_offset, transfer_scale, march=march, dz_sign=-1,
        n_planes=n_planes, length_correction=length_correction,
        precision=precision, plane_chunk=plane_chunk, tex_offset=tex_offset,
        empty_space_skip=empty_space_skip, axis_scale=axis_scale,
        ess_stats=ess_stats, filter_linear=filter_linear,
    )


def _hist_geometry(nz: int, width: int, height: int, focal: float,
                   march: MarchConfig):
    """Plane depths (front to back for the -z camera), slopes and spacing
    of the in-kernel decode sweep (one plane per z-layer)."""
    zlo, zhi = march.box_min[2], march.box_max[2]
    spacing = (zhi - zlo) / nz
    zs = (
        zlo + spacing * (np.arange(nz, dtype=np.float32) + 0.5)
    ).astype(np.float32)[::-1].copy()
    mxh, myh = _pixel_slopes(width, height, focal)
    slopes = (
        float(mxh[0]), float(mxh[1] - mxh[0]) if width > 1 else 0.0,
        float(myh[0]), float(myh[1] - myh[0]) if height > 1 else 0.0,
    )
    return zs, slopes, spacing


def _decode_rows(weights, stat: str, B: int, device) -> torch.Tensor:
    if stat not in _N_ROWS:
        raise ValueError(f"unknown stat {stat!r}; use linear / var / entropy")
    rows = torch.as_tensor(weights, dtype=torch.float32, device=device)
    if rows.ndim == 1:
        rows = rows[None, :]
    if tuple(rows.shape) != (_N_ROWS[stat], B):
        raise ValueError(
            f"stat {stat!r} needs ({_N_ROWS[stat]}, {B}) decode rows, got "
            f"{tuple(rows.shape)}"
        )
    return rows


def hist_render_reference(
    hist_bm: torch.Tensor, weights, origin, tf_lut, density=0.05,
    brightness=1.0, transfer_offset=0.0, transfer_scale=1.0, *, width: int,
    height: int, march: MarchConfig = MarchConfig(),
    length_correction: bool = True, plane_chunk: int = 0, focal: float = 2.0,
    stat: str = "linear",
) -> torch.Tensor:
    """Plain torch version of K2 on the device of ``hist_bm``: materialized
    :func:`decode_with_rows`, then the plain sweep over the decoded layers
    walked back to front."""
    nz, B, ny, nx = hist_bm.shape
    rows = _decode_rows(weights, stat, B, hist_bm.device)
    zs, slopes, spacing = _hist_geometry(nz, width, height, focal, march)
    return sweep_preblended_planes_reference(
        decode_with_rows(hist_bm, rows, stat), zs, origin, slopes, tf_lut,
        density, brightness, transfer_offset, transfer_scale, dz_sign=-1,
        width=width, height=height, march=march,
        length_correction=length_correction, plane_chunk=plane_chunk or 8,
        plane_spacing=spacing, reverse_planes=True,
    )


def pallas_hist_render(
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
    length_correction: bool = True,
    precision: str = "f32",
    plane_chunk: int = 0,
    focal: float = 2.0,
    stat: str = "linear",
) -> torch.Tensor:
    """K2: render STRAIGHT FROM A DISTRIBUTION VOLUME, decoding each voxel's
    histogram inside the sweep kernel.

    ``hist_bm`` is the bins-major ``(nz, B, ny, nx)`` histogram volume,
    float32 or bfloat16 (kept in its storage type; the kernel widens in
    registers). ``stat`` selects the decode: ``'linear'`` with ``weights
    (B,)`` or ``(1, B)`` (density = sum_b w[b] hist[b]), ``'var'`` with the
    ``(4, B)`` rows and ``'entropy'`` with the ``(1, B)`` normalizer row of
    :func:`decode_weight_rows`. One plane per z-layer (``n_planes == nz``),
    unrotated camera at ``origin``; any image size. ``plane_chunk`` sizes
    the plain version's batches; the kernel ignores it. Returns
    ``(height, width, 4)`` premultiplied RGBA.
    """
    _check_unported(precision)
    nz, B, ny, nx = hist_bm.shape
    rows = _decode_rows(weights, stat, B, hist_bm.device)
    if not _on_card(hist_bm):
        return hist_render_reference(
            hist_bm, rows, origin, tf_lut, density, brightness,
            transfer_offset, transfer_scale, width=width, height=height,
            march=march, length_correction=length_correction,
            plane_chunk=plane_chunk, focal=focal, stat=stat,
        )
    if not hist_render_supported(hist_bm.shape, width, height,
                                 n_lut=len(tf_lut)):
        raise ValueError(
            f"the decode kernel cannot render {tuple(hist_bm.shape)} -> "
            f"{width}x{height} with a {len(tf_lut)}-entry LUT"
        )
    zs, slopes, spacing = _hist_geometry(nz, width, height, focal, march)
    params = _sweep_params(
        origin, slopes, density, brightness, transfer_offset, transfer_scale,
        spacing, march, width=width, height=height, ny=ny, nx=nx,
        n_planes=nz, n_layers=nz, dz_sign=-1, reverse=True,
        length_correction=length_correction, tex_offset=0.5,
        axis_scale=(1.0, 1.0), filter_linear=True, n_bins=B,
        n_rows=rows.shape[0],
    )
    out = _launch(hist_bm, stat, zs, tf_lut, rows, params)
    pallas_hist_render.launches += 1
    return out


pallas_hist_render.launches = 0
