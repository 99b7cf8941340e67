"""Fused slice-sweep render kernels: wrappers, host pieces and plain versions.

The counterpart of ``vrdd_tpu/pallas/slice_kernel.py``. Two sweep kernels
in one CUDA C++ source (``csrc/slice_sweep.cu``, built by
``kernels/_build.py``), and the ESS bitmap kernel (``csrc/ess_bitmap.cu``):

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
``pallas_hist_render.launches``; ``sweep_preblended_planes.ess_launches``
counts those of them that culled by an ESS bitmap, ``.seed_launches`` those
that resumed from a seed, ``.staged_launches`` those that took the staged
fetch path (below).

**Empty-space skipping** (``empty_space_skip``, ``ess_stats``) is K1's
exact TF-interval culling: :func:`ess_bitmap` marks each (tile, chunk) —
the kernel's CUDA block of :data:`ESS_TILE` pixels by ``plane_chunk``
planes — whose samples provably map to alpha 0, from the block min/max of
:func:`ess_plane_stats` (cached per volume by the caller through
:func:`precompute_ess_stats`). On the card the bitmap is one launch
(``ess_bitmap.launches``), whose plain version is
:func:`ess_bitmap_reference` (JAX: the XLA code ``_ess_bitmap``, :397).
The sweep kernel skips culled chunks; its plain version zeroes their alpha,
so both give the image without ESS.

**The seeded resume** (``acc_init`` of :func:`sweep_preblended_planes`) is
K1's seed mode: an ``(H, W, 4)`` premultiplied-RGBA image the "over"
recursion resumes from (the back half of a split stack, a streamed chunk),
on the card passed to the kernel as its ``seed`` pointer (null: unseeded).
Brightness scales seed and sweep together. Seed and ESS together raise, as
JAX asserts.

**Two fetch paths** in every sweep kernel (K1-K5): *staged*, where each
block copies its footprint on a plane (the tap rectangle of its corner rays)
into shared memory and decodes each voxel there once, and *direct*, where
every sample fetches its four taps from device memory. Both give the same
images, checkpoints and LUT cotangents bit for bit (K5's plane cotangent,
summed with atomics, to rounding). :func:`stage_bound` bounds the footprint over the launch on the host;
the launch takes the staged path whenever that bound's tile fits
:data:`_STAGE_BUDGET` bytes of shared memory (:func:`stage_smem_bytes`), the
direct path otherwise (an image much coarser than the volume). Every wrapper
counts its staged launches in ``.staged_launches``. The internal ``staged``
argument of ``_launch`` and of the K3-K5 wrappers, and :func:`_fetch_path`
around a public call, force either path (tests and ``chip_smoke.py``).

Not ported yet (it raises ``NotImplementedError``): ``precision='bf16'``
(ROADMAP.md queue 2 item 2). The kernels take any image size, so the TPU's
padding, banding and VMEM budgets have no counterpart here.
"""

from __future__ import annotations

import contextlib
import math
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
#: the forward kernel's CUDA block in pixels, (rows, columns), one thread per
#: ray: also the pixel footprint of an ESS tile. Defined here once; every
#: launch passes it to the kernel (csrc/slice_sweep.cu) as its block shape.
ESS_TILE = (8, 32)
#: block grid of the ESS plane statistics: 8 x 8 blocks per plane, as the
#: JAX package's _ESS_YB / _ESS_XB
_ESS_YB = _ESS_XB = 8
#: margin on the culled LUT-coordinate interval: covers the f32 rounding of
#: a sample's value (the resample's weights sum to 1 only up to an ulp) and
#: of its LUT coordinate, which the interval argument in exact arithmetic
#: does not see
_ESS_Q_MARGIN = 1e-3
#: LUT knots the bitmap tests at once (one broadcast per group)
_ESS_KNOTS = 16


#: dynamic shared memory (bytes) the staged path may take per block: two
#: forward blocks of 256 threads or K5 blocks of 128 fit on one SM's 227 KB
_STAGE_BUDGET = 100 * 1024
#: the most dynamic shared memory one block can take on an H100
_SMEM_MAX = 227 * 1024
#: K5's block in rays, (columns, rows): csrc/bwd_common.cuh kBwdX, kBwdY
BWD_BLOCK = (32, 4)
#: a staged path forced by :func:`_fetch_path` (None: by geometry)
_FORCED_PATH = None


def stage_bound(params: dict, zs, block) -> Tuple[int, int]:
    """``(tw, th)``: an upper bound, in voxels, of the tap rectangle of any
    block of ``block = (columns, rows)`` rays on any plane at depths ``zs``
    of a launch with the kernels' ``params`` (:func:`_sweep_params`).

    A ray's filter coordinate on an axis is ``q = (o + dz m - lo) / (hi -
    lo) * n * scale - tex_offset``, monotone in its slope ``m``; the block's
    corner rays are ``(columns - 1) |dm|`` apart in slope, so their
    coordinates differ by at most ``dq = |dz|max (columns - 1) |dm| n scale
    / |hi - lo|`` (clamping to the grid only shrinks it). The rectangle's
    first taps then differ by at most ``floor(dq) + 1`` (also for nearest
    filtering, which rounds both the same way) and the second tap adds one:
    ``floor(dq + margin) + 3`` voxels, capped at ``n``. The margin covers the
    kernels' float32 rounding of the slopes and coordinates: 1e-4 relative
    to the magnitudes they pass through, some 800 times their rounding.
    Holds for either ``dz_sign``, any walk order and a camera inside the
    box: ``|dz|`` is the largest over all the planes."""
    cols, rows = block
    oz = params["oz"]
    d_max = float(np.max(np.abs(np.asarray(zs, np.float64) - oz)))

    def axis(o, m0, dm, extent, rays, n, lo, hi, scale):
        k = n * scale / abs(hi - lo)
        m_max = max(abs(m0), abs(m0 + dm * (extent - 1)))
        dq = d_max * abs(dm) * (min(rays, extent) - 1) * k
        margin = 1e-4 * (1.0 + k * (abs(o) + d_max * m_max + abs(lo)
                                    + abs(hi)))
        return int(min(n, math.floor(dq + margin) + 3))

    tw = axis(params["ox"], params["mx0"], params["dmx"], params["width"],
              cols, params["nx"], params["xlo"], params["xhi"], params["sx"])
    th = axis(params["oy"], params["my0"], params["dmy"], params["height"],
              rows, params["ny"], params["ylo"], params["yhi"], params["sy"])
    return tw, th


def stage_smem_bytes(tw: int, th: int, *, n_bins: int, elem_size: int,
                     n_lut: int, row_floats: int, slots: int = 2,
                     bwd_ck: int = 0, g_planes: bool = False,
                     momt: bool = False, g_small: bool = False) -> int:
    """Dynamic shared memory of a staged launch with ``tw`` x ``th``-voxel
    footprints: ``slots`` ring slots of raw rows (each bin of each voxel row
    in 16-byte chunks from the 16-byte boundary below it; the forward takes
    three for scalar planes, two otherwise), the LUT, the decode rows
    (``row_floats``), the decoded tile and the slots' row offsets;
    K5 (``bwd_ck``, its chunk of planes) adds the per-ray caches of a
    chunk, two d tiles (``g_planes``), the variance moments and touch flags
    (``momt``) and the per-thread LUT columns (``g_small``). Mirrors
    ``stage_layout`` (csrc/stage_tile.cuh) and ``bwd_extra``
    (csrc/slice_vjp_staged.cu)."""
    rc = (tw * elem_size + 30) // 16
    tile = tw * th
    threads = BWD_BLOCK[0] * BWD_BLOCK[1]
    total = (slots * th * n_bins * rc * 16
             + 4 * (4 * n_lut + row_floats + tile) + 4 * slots * th * n_bins)
    if bwd_ck:
        total += 4 * (3 * bwd_ck * threads + (2 * tile if g_planes else 0)
                      + (3 * tile if momt else 0)
                      + ((4 * n_lut + 3) * threads if g_small else 0))
    return total


def _stage_dims(staged, bound, smem: int, prefer: bool = True):
    """The kernels' ``(stage_w, stage_h)``: the bound on the staged path,
    ``(0, 0)`` on the direct path. ``staged=None`` chooses by geometry
    (staged when ``prefer`` and the tile fits :data:`_STAGE_BUDGET`, unless
    :func:`_fetch_path` forces a path); True forces the staged path, which
    raises when no block can hold the tile."""
    if staged is None:
        staged = (_FORCED_PATH if _FORCED_PATH is not None
                  else prefer and smem <= _STAGE_BUDGET)
    if not staged:
        return 0, 0
    if smem > _SMEM_MAX:
        raise ValueError(
            f"a {bound[0]} x {bound[1]}-voxel footprint needs {smem} bytes of "
            f"shared memory, more than a block has ({_SMEM_MAX})"
        )
    return bound


@contextlib.contextmanager
def _fetch_path(staged):
    """Force every sweep launch inside the block onto the staged (True) or
    the direct (False) fetch path, through public entry points that take no
    ``staged`` argument (chip_smoke.py times both)."""
    global _FORCED_PATH
    prev, _FORCED_PATH = _FORCED_PATH, staged
    try:
        yield
    finally:
        _FORCED_PATH = prev


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


def _pixel_uv(width: int, height: int):
    """The NDC pixel coordinates ``u (W,)`` and ``v (H,)``, float32 (not
    pixel-centred, exactly as the JAX package)."""
    u = ((np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0)
    v = ((np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0)
    return u.astype(np.float32), v.astype(np.float32)


def _pixel_slopes(width: int, height: int, focal: float):
    """The unrotated camera's ray slopes over the pixel grid (march/slice.py
    semantics)."""
    u, v = _pixel_uv(width, height)
    return (u / (-focal)).astype(np.float32), (v / (-focal)).astype(np.float32)


def pixel_slope_params(width: int, height: int, focal: float = 2.0):
    """``(mx0, dmx, my0, dmy)`` of the unrotated camera's pixel grid (ray
    ``(i, j)`` has slope ``(mx0 + dmx j, my0 + dmy i)``), the ``slopes`` of
    :func:`sweep_preblended_planes` and :func:`ess_bitmap` for the render
    of :func:`pallas_slice_render`."""
    mx, my = _pixel_slopes(width, height, focal)
    return (*_uniform_grid_params(mx, "mx"), *_uniform_grid_params(my, "my"))


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


def _device_f32(x, dev: torch.device) -> torch.Tensor:
    """``x`` (sequence, numpy array or tensor) as a contiguous float32
    tensor on ``dev``. A host array goes up to the card through pinned
    memory without blocking: a pageable upload would wait for all the work
    queued on the stream before it."""
    if isinstance(x, torch.Tensor):
        if x.device == dev:
            return x.detach().to(torch.float32).contiguous()
        x = x.detach().cpu()
    host = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    if dev.type != "cuda":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def _check_unported(precision):
    if precision != "f32":
        raise NotImplementedError(
            f"precision={precision!r}: only 'f32' is ported (ROADMAP.md queue "
            "2 item 2)"
        )


def _check_seed(acc_init, empty_space_skip):
    if acc_init is not None and empty_space_skip:
        raise ValueError(
            "a seeded sweep (acc_init) takes no empty-space skipping, as in "
            "JAX (its ESS bitmap does not see the seed)"
        )


def _launch(vol: torch.Tensor, mode: str, zs, tf_lut, rows,
            params: dict, ck_stride: int = 0, ess=None, ess_chunk: int = 0,
            seed=None, staged=None, zs_host=None):
    """Validate, allocate the (H, W, 4) output and launch the CUDA kernel on
    the current stream of the volume's device, in blocks of
    :data:`ESS_TILE` pixels. ``ck_stride > 0`` also writes the transmittance
    checkpoints (K4): the result is then ``(out, tck)``. ``ess``: the uint8
    ``(n_chunks, n_tile_rows, n_tile_cols)`` bitmap of :func:`ess_bitmap`
    over chunks of ``ess_chunk`` planes (None: no culling). ``seed``: the
    ``(H, W, 4)`` image the sweep resumes from (None: unseeded); host data
    goes up through :func:`_device_f32`. ``staged``: the fetch path (None:
    by geometry, :func:`_stage_dims`); ``zs_host``: the depths on the host
    for the footprint bound, when ``zs`` is already on the card. Returns
    ``(result, staged)``, the second saying which path the launch took."""
    from vrdd_tpu_torch.kernels import _build

    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"volume dtype {vol.dtype}: use float32 or bfloat16")
    if not vol.is_contiguous():
        raise ValueError("the volume must be contiguous")
    dev = vol.device
    if zs_host is None:
        zs_host = (zs.detach().cpu().numpy() if isinstance(zs, torch.Tensor)
                   else zs)

    zs_t, lut_t = _device_f32(zs, dev), _device_f32(tf_lut, dev)
    # K1 reads no decode rows
    rows_t = None if rows is None else _device_f32(rows, dev)
    if lut_t.ndim != 2 or lut_t.shape[1] != 4:
        raise ValueError(f"tf_lut must be (n_lut, 4), got {tuple(lut_t.shape)}")
    if zs_t.numel() != params["n_planes"]:
        raise ValueError("zs must hold one depth per plane")
    H, W = params["height"], params["width"]
    if ess is not None:
        want = _ess_shape(params["n_planes"], ess_chunk, H, W)
        if (ess.dtype != torch.uint8 or tuple(ess.shape) != want
                or ess.device != dev or not ess.is_contiguous()):
            raise ValueError(
                f"ess bitmap {tuple(ess.shape)} {ess.dtype} on {ess.device}: "
                f"want a contiguous uint8 {want} on {dev}"
            )
    seed_t = None if seed is None else _device_f32(seed, dev)
    if seed_t is not None and tuple(seed_t.shape) != (H, W, 4):
        raise ValueError(f"acc_init {tuple(seed_t.shape)}: want ({H}, {W}, 4)")
    out = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    tck = None
    if ck_stride:
        n_chunks = -(-params["n_planes"] // ck_stride)
        tck = torch.empty((n_chunks, H, W), dtype=torch.float32, device=dev)
    n_lut = lut_t.shape[0]
    n_bins = params.get("n_bins", 1) if mode != "none" else 1
    bound = stage_bound(params, zs_host, (ESS_TILE[1], ESS_TILE[0]))
    stage = _stage_dims(staged, bound, stage_smem_bytes(
        *bound, n_bins=n_bins, elem_size=vol.element_size(), n_lut=n_lut,
        row_floats=0 if rows_t is None else rows_t.numel(),
        slots=3 if mode == "none" else 2))
    p = _build.SweepParams(n_lut=n_lut, **params)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vrdd_slice_sweep(
            p, _MODES[mode], int(vol.dtype == torch.bfloat16),
            vol.data_ptr(), zs_t.data_ptr(), lut_t.data_ptr(),
            None if rows_t is None else rows_t.data_ptr(), out.data_ptr(),
            ck_stride, None if tck is None else tck.data_ptr(),
            None if ess is None else ess.data_ptr(), int(ess_chunk),
            None if seed_t is None else seed_t.data_ptr(),
            ESS_TILE[1], ESS_TILE[0], *stage, stream,
        )
    if rc != 0:
        raise RuntimeError(f"vrdd_slice_sweep launch failed: CUDA error {rc}")
    return ((out, tck) if ck_stride else out), stage[0] > 0


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


# ---- empty-space skipping (ESS) -------------------------------------------

@torch.no_grad()
def ess_plane_stats(planes_all: torch.Tensor):
    """Per-PLANE block min/max of a front-to-back plane stack: two
    ``(n_planes, 8, 8)`` float32 tensors (JAX ``ess_plane_stats``,
    slice_kernel.py:355; edge-padded to whole blocks).

    The expensive part of the ESS bitmap (one pass over the stack). It
    depends only on the pre-blended stack, not on the camera, the TF or the
    chunking, so a caller rendering the same volume many times computes it
    once (:func:`precompute_ess_stats`) and passes it as ``ess_stats``."""
    n_planes, NY, NX = planes_all.shape
    by = -(-NY // _ESS_YB)
    bx = -(-NX // _ESS_XB)
    dev = planes_all.device
    ri = torch.arange(_ESS_YB * by, device=dev).clamp(max=NY - 1)
    ci = torch.arange(_ESS_XB * bx, device=dev).clamp(max=NX - 1)
    p = planes_all.to(torch.float32)[:, ri][:, :, ci]
    p = p.reshape(n_planes, _ESS_YB, by, _ESS_XB, bx)
    return p.amin(dim=(2, 4)), p.amax(dim=(2, 4))


def precompute_ess_stats(volume, *, n_planes=0, march=MarchConfig(),
                         dz_sign=-1, tex_offset=0.5, z_scale=1.0):
    """Pre-blend ``volume`` exactly as the sweep will and return the ESS
    plane statistics for it (JAX ``precompute_ess_stats``, :378). The stats
    are camera- and TF-independent, but they ARE a function of everything the
    pre-blend sees: key a cache on (volume identity, n_planes, dz_sign,
    tex_offset, z_scale, march.box_min, march.box_max). Stats reused across
    a change in ANY of those cull non-conservatively (wrong pixels) with no
    shape mismatch to catch it."""
    if n_planes <= 0:
        n_planes = 2 * volume.shape[0]
    planes_all, _ = preblend_planes(
        volume, n_planes, march.box_min, march.box_max, dz_sign, tex_offset,
        z_scale=z_scale,
    )
    return ess_plane_stats(planes_all)


def _ess_shape(n_planes: int, plane_chunk: int, height: int, width: int):
    """Shape of the ESS bitmap: (chunks, tile rows, tile columns)."""
    th, tw = ESS_TILE
    return (-(-n_planes // plane_chunk), -(-height // th), -(-width // tw))


@torch.no_grad()
def ess_bitmap(plane_stats, zs, origin, slopes, tf_lut, tf_off, tf_scale, *,
               width: int, height: int, ny: int, nx: int, plane_chunk: int,
               march: MarchConfig = MarchConfig(), tex_offset: float = 0.5,
               axis_scale=(1.0, 1.0)) -> torch.Tensor:
    """The ESS bitmap: uint8 ``(n_chunks, ceil(H / 8), ceil(W / 32))``, 1
    where the tile of :data:`ESS_TILE` pixels can contribute during the
    chunk of ``plane_chunk`` planes, 0 where it provably cannot. On the
    device of ``plane_stats`` (``(n_planes, 8, 8)`` block min and max of
    :func:`ess_plane_stats`): on the card one launch of the bitmap kernel
    (``csrc/ess_bitmap.cu``), which computes the bytes of
    :func:`ess_bitmap_reference`; on the CPU that plain version. Counts its
    launches in ``ess_bitmap.launches``."""
    pmin, pmax = plane_stats
    if not _on_card(pmin):
        return ess_bitmap_reference(
            plane_stats, zs, origin, slopes, tf_lut, tf_off, tf_scale,
            width=width, height=height, ny=ny, nx=nx,
            plane_chunk=plane_chunk, march=march, tex_offset=tex_offset,
            axis_scale=axis_scale,
        )
    from vrdd_tpu_torch.kernels import _build

    dev = pmin.device
    n_planes = pmin.shape[0]
    want = (n_planes, _ESS_YB, _ESS_XB)
    pmin, pmax = (t.to(torch.float32).contiguous() for t in (pmin, pmax))
    if tuple(pmax.shape) != want or pmax.device != dev:
        raise ValueError(f"plane_stats must be two {want} tensors on {dev}")
    zs_t, lut_t = _device_f32(zs, dev), _device_f32(tf_lut, dev)
    if zs_t.numel() != n_planes:
        raise ValueError("zs must hold one depth per plane")
    if lut_t.ndim != 2 or lut_t.shape[1] != 4:
        raise ValueError(f"tf_lut must be (n_lut, 4), got {tuple(lut_t.shape)}")
    out = torch.empty(_ess_shape(n_planes, plane_chunk, height, width),
                      dtype=torch.uint8, device=dev)
    ox, oy, oz = _host_floats(origin, 3)
    mx0, dmx, my0, dmy = _host_floats(slopes, 4)
    th, tw = ESS_TILE
    p = _build.EssParams(
        ox=ox, oy=oy, oz=oz, mx0=mx0, dmx=dmx, my0=my0, dmy=dmy,
        xlo=march.box_min[0], xhi=march.box_max[0], ylo=march.box_min[1],
        yhi=march.box_max[1], tex_offset=float(tex_offset),
        sx=float(axis_scale[0]), sy=float(axis_scale[1]),
        tf_off=float(tf_off), tf_scale=float(tf_scale),
        q_margin=_ESS_Q_MARGIN, n_planes=n_planes,
        plane_chunk=int(plane_chunk), height=int(height), width=int(width),
        tile_h=th, tile_w=tw, ny=int(ny), nx=int(nx), n_lut=lut_t.shape[0],
        n_by=_ESS_YB, n_bx=_ESS_XB,
    )
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vrdd_ess_bitmap(p, pmin.data_ptr(), pmax.data_ptr(),
                                 zs_t.data_ptr(), lut_t.data_ptr(),
                                 out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"vrdd_ess_bitmap launch failed: CUDA error {rc}")
    ess_bitmap.launches += 1
    return out


ess_bitmap.launches = 0


@torch.no_grad()
def ess_bitmap_reference(plane_stats, zs, origin, slopes, tf_lut, tf_off,
                         tf_scale, *, width: int, height: int, ny: int,
                         nx: int, plane_chunk: int,
                         march: MarchConfig = MarchConfig(),
                         tex_offset: float = 0.5,
                         axis_scale=(1.0, 1.0)) -> torch.Tensor:
    """Plain version of :func:`ess_bitmap`, on the device of
    ``plane_stats``: host geometry in float64, the block and LUT tests in
    torch.

    The conservative interval argument of JAX's ``_ess_bitmap`` (:397-506)
    over this port's own tiles: a ray's world (x, y) on a plane is affine in
    its depth and its slope, so over a (tile, chunk) it ranges between the
    four corners' values; the resample is a convex combination of taps in
    the 1-voxel-dilated texel footprint, so the sample lies in [min, max] of
    the blocks that footprint touches; the LUT's alpha is piecewise linear
    in the LUT coordinate, so its largest magnitude over that value interval
    is at the interval's ends or at a knot inside. A culled tile's samples
    have alpha exactly 0: they change neither the image nor the
    transmittance, so skipping them is exact for the image and for volume
    cotangents (not for LUT / density / TF cotangents). ``tf_scale`` may be
    negative. The interval is widened by :data:`_ESS_Q_MARGIN` in LUT
    coordinates against float rounding."""
    pmin, pmax = plane_stats
    dev = pmin.device
    n_planes = pmin.shape[0]
    n_chunks, n_ty, n_tx = _ess_shape(n_planes, plane_chunk, height, width)
    pad = n_chunks * plane_chunk - n_planes  # a ragged last chunk: repeat
    if pad:
        pmin = torch.cat([pmin, pmin[-1:].expand(pad, -1, -1)])
        pmax = torch.cat([pmax, pmax[-1:].expand(pad, -1, -1)])
    bmin = pmin.reshape(n_chunks, plane_chunk, _ESS_YB, _ESS_XB).amin(1)
    bmax = pmax.reshape(n_chunks, plane_chunk, _ESS_YB, _ESS_XB).amax(1)

    # host geometry (float64): world-coordinate ranges per (tile, chunk)
    z = np.asarray(_host_floats(zs, n_planes), np.float64)
    z = np.concatenate([z, np.repeat(z[-1:], pad)]).reshape(n_chunks, -1)
    z_lo, z_hi = z.min(1)[None, :], z.max(1)[None, :]  # (1, C)
    ox, oy, oz = _host_floats(origin, 3)
    mx0, dmx, my0, dmy = _host_floats(slopes, 4)
    th, tw = ESS_TILE

    def corner_range(o, m0, dm, size, n_tiles, extent):
        first = np.arange(n_tiles, dtype=np.float64)[:, None] * size
        last = np.minimum(first + size, extent) - 1
        m_a, m_b = m0 + dm * first, m0 + dm * last
        c = np.stack([o + (z_lo - oz) * m_a, o + (z_lo - oz) * m_b,
                      o + (z_hi - oz) * m_a, o + (z_hi - oz) * m_b])
        return c.min(0), c.max(0)  # (n_tiles, C)

    def block_range(lo_w, hi_w, axis, N, nb, scale):
        # coordinate range -> 1-voxel-dilated texel range -> block range
        lo_box, hi_box = march.box_min[axis], march.box_max[axis]
        bsz = -(-N // nb)
        u_lo = (lo_w - lo_box) / (hi_box - lo_box)
        u_hi = (hi_w - lo_box) / (hi_box - lo_box)
        v_lo = np.floor(u_lo * (N * scale) - tex_offset) - 1.0
        v_hi = np.ceil(u_hi * (N * scale) - tex_offset) + 2.0
        return (np.clip(np.floor(v_lo / bsz), 0, nb - 1),
                np.clip(np.floor(v_hi / bsz), 0, nb - 1))

    sx, sy = axis_scale
    y_rng = corner_range(oy, my0, dmy, th, n_ty, height)
    x_rng = corner_range(ox, mx0, dmx, tw, n_tx, width)
    yb = block_range(*y_rng, 1, ny, _ESS_YB, sy)
    xb = block_range(*x_rng, 0, nx, _ESS_XB, sx)
    ranges = torch.as_tensor(  # one upload: (2, n_ty + n_tx, C)
        np.stack([np.concatenate([yb[0], xb[0]]),
                  np.concatenate([yb[1], xb[1]])]).astype(np.int64),
        device=dev)
    yb_lo, yb_hi = ranges[0, :n_ty, :, None], ranges[1, :n_ty, :, None]
    xb_lo, xb_hi = ranges[0, n_ty:, :, None], ranges[1, n_ty:, :, None]

    # min / max over the selected blocks, rows first then columns
    ybi = torch.arange(_ESS_YB, device=dev)
    xbi = torch.arange(_ESS_XB, device=dev)
    ym = ((ybi >= yb_lo) & (ybi <= yb_hi))[..., None]  # (n_ty, C, YB, 1)
    vmin_y = torch.where(ym, bmin[None], np.inf).amin(2)  # (n_ty, C, XB)
    vmax_y = torch.where(ym, bmax[None], -np.inf).amax(2)
    xm = ((xbi >= xb_lo) & (xbi <= xb_hi))[None]  # (1, n_tx, C, XB)
    vmin = torch.where(xm, vmin_y[:, None], np.inf).amin(-1)  # (ty, tx, C)
    vmax = torch.where(xm, vmax_y[:, None], -np.inf).amax(-1)

    # max |alpha| of the clamped piecewise-linear LUT over [vmin, vmax]
    lut = torch.as_tensor(tf_lut, dtype=torch.float32, device=dev)
    n_lut = lut.shape[0]
    la = lut[:, 3].abs()
    toff, tscl = float(tf_off), float(tf_scale)
    q_a = (vmin - toff) * tscl * n_lut - 0.5
    q_b = (vmax - toff) * tscl * n_lut - 0.5
    q_lo = torch.clamp(torch.minimum(q_a, q_b) - _ESS_Q_MARGIN, 0.0, n_lut - 1.0)
    q_hi = torch.clamp(torch.maximum(q_a, q_b) + _ESS_Q_MARGIN, 0.0, n_lut - 1.0)

    def alpha_at(q):
        i0 = torch.floor(q)
        i0i = i0.to(torch.int64).clamp(0, n_lut - 1)
        i1i = (i0i + 1).clamp(max=n_lut - 1)
        f = q - i0
        return la[i0i] * (1.0 - f) + la[i1i] * f

    amax = torch.maximum(alpha_at(q_lo), alpha_at(q_hi))
    knots = torch.arange(n_lut, dtype=torch.float32, device=dev)
    for k0 in range(0, n_lut, _ESS_KNOTS):  # knots inside [q_lo, q_hi]
        kn, lk = knots[k0:k0 + _ESS_KNOTS], la[k0:k0 + _ESS_KNOTS]
        inside = (q_lo[..., None] <= kn) & (q_hi[..., None] >= kn)
        amax = torch.maximum(amax, torch.where(inside, lk, 0.0).amax(-1))
    return (amax > 0.0).permute(2, 0, 1).contiguous().to(torch.uint8)


def _resolve_ess(empty_space_skip, ess_stats, planes_all, zs, origin, slopes,
                 tf_lut, transfer_offset, transfer_scale, *, width, height,
                 plane_chunk, march, tex_offset, axis_scale, reverse_planes):
    """The ESS bitmap of a sweep over ``planes_all``, or None without ESS.
    ``ess_stats`` describe the logical (front-to-back) plane order; without
    them the stats come from the stack, flipped when it is walked back to
    front."""
    if not empty_space_skip:
        return None
    n_planes, ny, nx = planes_all.shape
    if ess_stats is None:
        pmin, pmax = ess_plane_stats(planes_all)
        ess_stats = (pmin.flip(0), pmax.flip(0)) if reverse_planes else (pmin,
                                                                         pmax)
    want = (n_planes, _ESS_YB, _ESS_XB)
    if any(tuple(t.shape) != want for t in ess_stats):
        raise ValueError(f"ess_stats must be two {want} tensors")
    return ess_bitmap(
        ess_stats, zs, origin, slopes, tf_lut, transfer_offset,
        transfer_scale, width=width, height=height, ny=ny, nx=nx,
        plane_chunk=plane_chunk, march=march, tex_offset=tex_offset,
        axis_scale=axis_scale,
    )


def sweep_preblended_planes_reference(
    planes_all, zs, origin, slopes, tf_lut, density=0.05, brightness=1.0,
    transfer_offset=0.0, transfer_scale=1.0, *, dz_sign=-1, width, height,
    march: MarchConfig = MarchConfig(), length_correction=True,
    plane_chunk=8, tex_offset=0.5, plane_spacing=None, axis_scale=(1.0, 1.0),
    filter_linear=True, reverse_planes=False, ess=None, acc_init=None,
):
    """Plain torch version of K1, on the device of ``planes_all``: the slope
    grid ``mx0 + dmx * j`` is built in float32 exactly as the kernel builds
    it, then :func:`sweep_preblended_planes_xla` sweeps (a flipped copy of
    the stack when ``reverse_planes``), from the seed ``acc_init`` when
    given. ``ess``: the bitmap of :func:`ess_bitmap` over chunks of
    ``plane_chunk`` planes; culled samples get alpha exactly 0, as the
    kernel skips them."""
    mx, my = _slope_grids(slopes, width, height)
    if reverse_planes:
        planes_all = planes_all.flip(0)
    return sweep_preblended_planes_xla(
        planes_all, zs, origin, mx, my, tf_lut, density, brightness,
        transfer_offset, transfer_scale, march, dz_sign=dz_sign,
        plane_spacing=plane_spacing, length_correction=length_correction,
        plane_chunk=plane_chunk, tex_offset=tex_offset,
        axis_scale=axis_scale, filter_linear=filter_linear,
        ess=None if ess is None else (ess, plane_chunk, ESS_TILE),
        acc_init=acc_init,
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
    batches and the ESS chunks. ``empty_space_skip`` culls (tile, chunk)
    pairs by :func:`ess_bitmap`, from ``ess_stats`` (cached
    :func:`ess_plane_stats` of the logical plane order) or from the stack;
    the image is the one without ESS. ``acc_init`` ``(height, width, 4)``
    seeds the sweep (premultiplied RGBA the recursion resumes from; not with
    ``empty_space_skip``). Returns ``(height, width, 4)``.
    """
    _check_unported(precision)
    _check_seed(acc_init, empty_space_skip)
    n_planes, ny, nx = planes_all.shape
    if plane_spacing is None:
        plane_spacing = (march.box_max[2] - march.box_min[2]) / n_planes
    zs_host = (zs.detach().cpu().numpy() if isinstance(zs, torch.Tensor)
               else np.asarray(zs, np.float32))
    if _on_card(planes_all):  # one upload each for the bitmap and K1
        zs = _device_f32(zs, planes_all.device)
        tf_lut = _device_f32(tf_lut, planes_all.device)
    ess = _resolve_ess(
        empty_space_skip, ess_stats, planes_all, zs, origin, slopes, tf_lut,
        transfer_offset, transfer_scale, width=width, height=height,
        plane_chunk=plane_chunk, march=march, tex_offset=tex_offset,
        axis_scale=axis_scale, reverse_planes=reverse_planes,
    )
    if not _on_card(planes_all):
        return sweep_preblended_planes_reference(
            planes_all, zs, origin, slopes, tf_lut, density, brightness,
            transfer_offset, transfer_scale, dz_sign=dz_sign, width=width,
            height=height, march=march, length_correction=length_correction,
            plane_chunk=plane_chunk, tex_offset=tex_offset,
            plane_spacing=plane_spacing, axis_scale=axis_scale,
            filter_linear=filter_linear, reverse_planes=reverse_planes,
            ess=ess, acc_init=acc_init,
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
    out, staged = _launch(planes_all, "none", zs, tf_lut, None, params,
                          ess=ess, ess_chunk=plane_chunk, seed=acc_init,
                          zs_host=zs_host)
    sweep_preblended_planes.launches += 1
    sweep_preblended_planes.staged_launches += staged
    sweep_preblended_planes.ess_launches += ess is not None
    sweep_preblended_planes.seed_launches += acc_init is not None
    return out


sweep_preblended_planes.launches = 0
#: the launches among ``launches`` that took the staged fetch path
sweep_preblended_planes.staged_launches = 0
#: the launches among ``launches`` that culled by an ESS bitmap
sweep_preblended_planes.ess_launches = 0
#: the launches among ``launches`` that resumed from a seed
sweep_preblended_planes.seed_launches = 0


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
    # walk it back to front instead of materializing a flipped copy. With
    # ESS it needs cached stats, as in JAX (slice_kernel.py:1244-1247)
    pure_sel = (
        n_planes == nz and tex_offset == 0.5 and axis_scale[2] == 1.0
        and (not empty_space_skip or ess_stats is not None)
    )
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
    out, staged = _launch(hist_bm, stat, zs, tf_lut, rows, params)
    pallas_hist_render.launches += 1
    pallas_hist_render.staged_launches += staged
    return out


pallas_hist_render.launches = 0
pallas_hist_render.staged_launches = 0
