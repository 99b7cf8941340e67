"""Fused slice-sweep render kernels: wrappers, host pieces and plain versions.

The counterpart of ``vrdd_tpu/pallas/slice_kernel.py``. Two sweep kernels
in one CUDA C++ source (``csrc/slice_sweep.cu``, built by
``kernels/_build.py``), and the ESS bitmap kernel (``csrc/ess_bitmap.cu``,
the sweeps' ESS bits as data: below):

- **K1**, the scalar sweep over a front-to-back plane stack, launched by
  :func:`sweep_preblended_planes` (TPU: ``pallas_call`` at
  ``slice_kernel.py:1351``) and reached through :func:`pallas_slice_render`
  -> :func:`pallas_sweep_slope_space`;
- **K2**, the same sweep with the per-voxel histogram decode (linear mean,
  variance, entropy) in its prologue, launched by :func:`pallas_hist_render`
  (TPU: ``pallas_call`` at ``slice_kernel.py:1595``), the ``render-hist``
  path.

Each wrapper dispatches on the device of its volume: a CUDA tensor goes to
the kernel, or the wrapper raises; a CPU tensor takes the plain torch
version (:func:`sweep_preblended_planes_reference`,
:func:`hist_render_reference`). There is no fallback from the card to the
plain version. The decode's histogram cotangent, :func:`decode_chain` (the
backward of every histogram sweep and of the materialized decode), is one
launch of ``csrc/decode_chain.cu`` on the card, and
:func:`decode_chain_reference` on the CPU. Every launch is readied and made
by ``kernels/launch.py``, and each wrapper's launch counters are declared
at its definition (``launch.counted``; that module's docstring lists them).

**Empty-space skipping** (``empty_space_skip``, ``ess_stats``) is K1's
exact TF-interval culling of each (tile, chunk) — the kernel's CUDA block
of :data:`ESS_TILE` pixels by ``plane_chunk`` planes — whose samples
provably map to alpha 0, from the block min/max of :func:`ess_plane_stats`
(cached per volume by the caller through :func:`precompute_ess_stats`). On
the card the sweep kernel tests each pair itself (``csrc/ess_common.cuh``),
given the statistics (an :class:`EssTest`): each block tests its tile's
chunks at its start into shared memory, which its chunk step reads; no
bitmap is launched or stored. The test's bits are those of
:func:`ess_bitmap_reference` (JAX: the XLA code ``_ess_bitmap``, :397),
the plain version, which zeroes the alpha of culled chunks; both give the
image without ESS. :func:`ess_bitmap` (one launch of
``csrc/ess_bitmap.cu``) computes the same bitmap as data, for the bench's
roofline and the tests; no sweep reads it.
:func:`_ess_bits` collects the bits the kernels tested.

**The seeded resume** (``acc_init`` of :func:`sweep_preblended_planes`) is
K1's seed mode: an ``(H, W, 4)`` premultiplied-RGBA image the "over"
recursion resumes from (the back half of a split stack, a streamed chunk),
on the card passed to the kernel as its ``seed`` pointer (null: unseeded).
Brightness scales seed and sweep together. Seed and ESS together raise, as
JAX asserts.

**Two fetch paths** in every sweep kernel (K1-K5), *staged* (each block's
plane footprint decoded once in shared memory) and *direct*, which give the
same images: ``launch.stage_dims`` chooses between them, and the internal
``staged`` argument of :func:`_launch` and :func:`_fetch_path` around a
public call force either (tests and ``chip_smoke.py``).

**``precision='bf16'``** is JAX's bf16 resample (``mm_dtype``,
``slice_kernel.py:1324, :1581``): the kernels round the tap values (the
decoded values in the decode modes), the tent weights and the
y-interpolated pair to bf16 and sum in f32, as the TPU kernel's two bf16
matmuls do (``csrc/sweep_common.cuh`` ``bilerp``); the plain version rounds
the operands of its two matmuls (``march/slice.py`` ``_Bf16Resample``). A
runtime field of the kernels' parameters, on both fetch paths. With ESS the
bitmap's LUT-coordinate margin widens by the bf16 rounding of the plane
values (:func:`_ess_q_margin`), so culling stays exact. Any other value
than 'f32' and 'bf16' raises ``ValueError``. The kernels take any image
size, so the TPU's padding, banding and VMEM budgets have no counterpart
here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from vrdd_tpu_torch.kernels import _build
# _fetch_path stays reachable here: chip_smoke.py and the tests force the
# fetch path through slice_kernel
from vrdd_tpu_torch.kernels.launch import (  # noqa: F401
    _MODES, ESS_TILE, _device_f32, _fetch_path, _host_floats, _sweep_params,
    call, counted, lut_fits, prepare, ptrs, record,
)
from vrdd_tpu_torch.march.slice import (
    preblend_planes,
    sweep_preblended_planes_xla,
)
from vrdd_tpu_torch.utils import profiling
from vrdd_tpu_torch.utils.config import (
    FLEX_MAX_HISTOGRAM, MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM, MarchConfig,
)

#: decode-weight rows each histogram statistic contracts against
_N_ROWS = {"linear": 1, "var": 4, "entropy": 1}
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
#: in the bf16 mode a resampled value may leave the [min, max] of its taps
#: by about 2^-7 of their magnitude (the taps, the weights and the
#: y-interpolated pair each round to bf16, 2^-9 relative); the ESS margin
#: takes twice that
_BF16_SPREAD = 2.0 ** -6
#: inside :func:`_ess_bits`: the bits of each in-kernel ESS test
_ESS_BITS = None


@contextlib.contextmanager
def _ess_bits():
    """Yields a list that gets, for every sweep launch inside the block
    that tests ESS in the kernel, ``(bits, test)``: the uint8 ``(n_chunks,
    n_tile_rows, n_tile_cols)`` bits its blocks tested and its
    :class:`EssTest`, to hold against ``test.reference()`` (tests,
    ``chip_smoke.py``). The kernels write the bits only here: outside the
    block the launches take no buffer."""
    global _ESS_BITS
    prev, _ESS_BITS = _ESS_BITS, []
    try:
        yield _ESS_BITS
    finally:
        _ESS_BITS = prev


def pallas_supported(
    volume_shape: Tuple[int, int, int], width: int, height: int,
    n_planes: int, n_lut: int = 9,
) -> bool:
    """Can K1 render this configuration? Any image size and volume shape;
    only the LUT must fit the kernel's shared memory."""
    return (
        len(volume_shape) == 3 and min(volume_shape) >= 1
        and width >= 1 and height >= 1 and n_planes >= 1
        and lut_fits(n_lut)
    )


def hist_render_supported(hist_shape, width: int, height: int,
                          n_lut: int = 9) -> bool:
    """Can K2 render this bins-major ``(nz, B, ny, nx)`` histogram volume?
    Any image size and volume shape; the LUT and the variance decode's four
    weight rows must fit the kernel's shared memory."""
    return (
        len(hist_shape) == 4 and min(hist_shape) >= 1
        and width >= 1 and height >= 1
        and lut_fits(n_lut, 4 * hist_shape[1])
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


@counted("dchain")
def decode_chain(hist_bm: torch.Tensor, rows: torch.Tensor, mode: str,
                 d_dec: torch.Tensor, mom=None) -> torch.Tensor:
    """The histogram cotangent from the decoded-volume cotangent ``d_dec``
    ``(nz, ny, nx)`` float32, in the histogram's storage dtype (as
    vrdd_tpu/pallas/slice_vjp.py:874-908): the chain of
    :func:`decode_chain_reference`, whose docstring gives it per mode.

    On the card one launch of ``csrc/decode_chain.cu`` writes every element
    of ``d_hist`` in one pass over the volume; it takes a contiguous
    bfloat16 or float32 ``hist_bm`` and, on the same device, ``d_dec``,
    ``mom`` (``(nz, 2, ny, nx)`` float32) and the ``(n_rows, B)`` decode
    rows, and raises on anything else. A CPU tensor takes the plain version.
    Shared by the in-kernel route's backward and the materialized decode's
    (:class:`_Decode`)."""
    if not _on_card(hist_bm):
        return decode_chain_reference(hist_bm, rows, mode, d_dec, mom)
    if mode not in _N_ROWS:
        raise ValueError(f"unknown decode mode {mode!r}")
    _check_chain_hist(hist_bm)
    dev = hist_bm.device
    nz, B, ny, nx = hist_bm.shape
    for name, t, shape in (("d_dec", d_dec, (nz, ny, nx)),
                           ("mom", mom, (nz, 2, ny, nx))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32 or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"decode_chain: {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (rows.device != dev or rows.ndim != 2 or rows.shape[1] != B
            or rows.shape[0] < _N_ROWS[mode]):
        raise ValueError(f"decode_chain: rows must be ({_N_ROWS[mode]}, {B}) "
                         f"on {dev}, got {tuple(rows.shape)} on {rows.device}")
    rows = rows.detach().to(torch.float32).contiguous()
    d_hist = torch.empty_like(hist_bm)
    if d_hist.numel() == 0:
        return d_hist
    call("vrdd_decode_chain", dev, _MODES[mode],
         int(hist_bm.dtype == torch.bfloat16),
         *ptrs(hist_bm, rows, d_dec, mom if mode == "var" else None, d_hist),
         nz, B, ny * nx)
    record(decode_chain)
    return d_hist


def _check_chain_hist(hist_bm: torch.Tensor) -> None:
    """Raise unless the chain kernel takes ``hist_bm`` on the card: a
    contiguous bfloat16 or float32 ``(nz, B, ny, nx)`` volume."""
    if hist_bm.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_chain: histograms must be float32 or "
                         f"bfloat16 on the card, got {hist_bm.dtype}")
    if hist_bm.ndim != 4 or not hist_bm.is_contiguous():
        raise ValueError("decode_chain: the (nz, B, ny, nx) histogram volume "
                         "must be contiguous on the card")


def decode_chain_reference(hist_bm: torch.Tensor, rows: torch.Tensor,
                           mode: str, d_dec: torch.Tensor,
                           mom=None) -> torch.Tensor:
    """Plain version of :func:`decode_chain`, on any device:

    - linear: ``d h_b = d_dec * w_b`` (a broadcast);
    - var: ``d h_b = d_dec * (w2_b - 2 m w1_b + m^2 w3_b + e w0_b)`` with the
      moments ``m`` and ``e = 2 (m C0 - C1)`` from ``mom (nz, 2, ny, nx)``
      (the reverse kernel writes them) or, without it, from the histograms;
    - entropy: ``d h_b = -d_dec * w00 (log2 h_b + 1/ln2)``, exactly 0 at
      ``h_b == 0``.

    Runs a few z-layers at a time: no ``(nz, B, ny, nx)`` float32 temporary
    exists."""
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
    """The materialized decode under autograd, with the explicit chain of
    :func:`decode_chain` as its backward (one kernel on the card, z-chunked
    on the CPU): plain autograd through the chunked einsums would keep
    float32 copies of the histograms alive."""

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
    autograd, in the backward (:class:`_Decode`). On the card, a histogram
    volume that needs its gradient must be one :func:`decode_chain` takes,
    which raises here rather than after the forward."""
    if mode not in _N_ROWS:
        raise ValueError(f"unknown decode mode {mode!r}")
    if (hist_bm.device.type == "cuda" and hist_bm.requires_grad
            and torch.is_grad_enabled()):
        _check_chain_hist(hist_bm)
    rows = profiling.to_device(rows, hist_bm.device, "rows",
                               dtype=torch.float32)
    if rows.ndim == 1:
        rows = rows[None, :]
    if torch.is_grad_enabled() and (hist_bm.requires_grad
                                    or rows.requires_grad):
        return _Decode.apply(hist_bm, rows, mode)
    return _decode_plain(hist_bm, rows, mode)


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain
    version); any other device raises — there is no silent fallback."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: use 'cuda' or 'cpu'")


#: the kernels' SweepParams.precision of each ``precision`` JAX accepts
_PRECISIONS = {"f32": 0, "bf16": 1}


def _precision_flag(precision) -> int:
    """SweepParams.precision of ``precision``: 0 for 'f32', 1 for 'bf16';
    anything else raises."""
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision={precision!r}: use one of {sorted(_PRECISIONS)}"
        )
    return _PRECISIONS[precision]


def _check_seed(acc_init, empty_space_skip):
    if acc_init is not None and empty_space_skip:
        raise ValueError(
            "a seeded sweep (acc_init) takes no empty-space skipping, as in "
            "JAX (its ESS bitmap does not see the seed)"
        )


def _launch(vol: torch.Tensor, mode: str, zs, tf_lut, rows,
            params: dict, ck_stride: int = 0, ess=None, ess_chunk: int = 0,
            seed=None, staged=None, zs_host=None, live_map=False):
    """The forward launch, K1-K4: ready it (``launch.prepare``), allocate
    the (H, W, 4) output and launch the CUDA kernel on the current stream of
    the volume's device, in blocks of :data:`ESS_TILE` pixels.
    ``ck_stride > 0`` also writes the transmittance checkpoints (K4): the
    result is then ``(out, tck)``. ``ess``, over chunks of ``ess_chunk``
    planes: an :class:`EssTest` (the kernel tests each (tile, chunk) itself;
    inside :func:`_ess_bits` it also writes the bits it tested), or None (no
    culling). ``seed``: the ``(H, W, 4)`` image the sweep resumes from
    (None: unseeded); host data goes up through :func:`_device_f32`.
    ``staged``: the fetch path (None: by geometry); ``zs_host``: the depths
    on the host for the footprint bound, when ``zs`` is already on the card.
    ``live_map`` (K4 only): also fill K4's live map, a zeroed uint8
    ``(n_chunks, n_tile_rows, n_tile_cols)`` tensor over :data:`ESS_TILE`
    tiles, and return ``(out, tck, live)``. Returns ``(result, staged)``,
    the second saying which path the launch took."""
    with profiling.annotate("sweep.prepare"):
        zs_t, lut_t, rows_t, p, stage = prepare(
            "fwd", vol, mode, zs, tf_lut, rows, params, staged=staged,
            zs_host=zs_host, ess_chunk=0 if ess is None else ess_chunk)
        dev = vol.device
        H, W, n_planes = params["height"], params["width"], params["n_planes"]
        ess_min = ess_max = bits = None
        if ess is not None:
            if not isinstance(ess, EssTest):
                raise TypeError(f"ess: an EssTest or None, not {type(ess)}")
            if mode != "none":
                raise ValueError("ESS culls scalar plane sweeps only")
            want = (n_planes, _ESS_YB, _ESS_XB)
            ess_min, ess_max = ess.pmin, ess.pmax
            if any(t.dtype != torch.float32 or tuple(t.shape) != want
                   or t.device != dev or not t.is_contiguous()
                   for t in (ess_min, ess_max)):
                raise ValueError(f"ESS plane stats: want two contiguous "
                                 f"float32 {want} tensors on {dev}")
            if ess.kwargs["plane_chunk"] != ess_chunk:
                raise ValueError(f"an ESS test over chunks of "
                                 f"{ess.kwargs['plane_chunk']} planes, a "
                                 f"launch over chunks of {ess_chunk}")
            if _ESS_BITS is not None:
                bits = torch.zeros(_ess_shape(n_planes, ess_chunk, H, W),
                                   dtype=torch.uint8, device=dev)
                _ESS_BITS.append((bits, ess))
            p.ess = _ess_params(params, ess.q_margin, ess_chunk, p.n_lut)
            counts = profiling.ess_counts(dev)  # tracing: the pairs tested
            if counts is not None:
                p.ess.counts = counts.data_ptr()
        seed_t = None if seed is None else _device_f32(seed, dev, "seed")
        if seed_t is not None and tuple(seed_t.shape) != (H, W, 4):
            raise ValueError(f"acc_init {tuple(seed_t.shape)}: want "
                             f"({H}, {W}, 4)")
        out = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
        tck = live = None
        if ck_stride:
            tck = torch.empty((-(-n_planes // ck_stride), H, W),
                              dtype=torch.float32, device=dev)
        if live_map:
            if not ck_stride:
                raise ValueError("the live map is K4's: it needs "
                                 "ck_stride > 0")
            live = torch.zeros(_ess_shape(n_planes, ck_stride, H, W),
                               dtype=torch.uint8, device=dev)
    rows_p, tck_p, min_p, max_p, bits_p, seed_p, live_p = ptrs(
        rows_t, tck, ess_min, ess_max, bits, seed_t, live)
    call("vrdd_slice_sweep", dev, p, _MODES[mode],
         int(vol.dtype == torch.bfloat16), vol.data_ptr(), zs_t.data_ptr(),
         lut_t.data_ptr(), rows_p, out.data_ptr(), ck_stride, tck_p, min_p,
         max_p, bits_p, int(ess_chunk), seed_p, live_p, ESS_TILE[1],
         ESS_TILE[0], *stage)
    result = out
    if ck_stride:
        result = (out, tck, live) if live_map else (out, tck)
    return result, stage[0] > 0


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


@counted("bitmap")
@torch.no_grad()
def ess_bitmap(plane_stats, zs, origin, slopes, tf_lut, tf_off, tf_scale, *,
               width: int, height: int, ny: int, nx: int, plane_chunk: int,
               march: MarchConfig = MarchConfig(), tex_offset: float = 0.5,
               axis_scale=(1.0, 1.0), q_margin: float = _ESS_Q_MARGIN
               ) -> torch.Tensor:
    """The ESS bitmap: uint8 ``(n_chunks, ceil(H / 8), ceil(W / 32))``, 1
    where the tile of :data:`ESS_TILE` pixels can contribute during the
    chunk of ``plane_chunk`` planes, 0 where it provably cannot. On the
    device of ``plane_stats`` (``(n_planes, 8, 8)`` block min and max of
    :func:`ess_plane_stats`): on the card one launch of the bitmap kernel
    (``csrc/ess_bitmap.cu``), which computes the bytes of
    :func:`ess_bitmap_reference`; on the CPU that plain version.
    ``q_margin``: the widening of each culled LUT-coordinate interval
    (:func:`_ess_q_margin`). The sweep kernels test the same bits themselves
    (:class:`EssTest`); this is for the callers that need the bitmap as
    data."""
    pmin, pmax = plane_stats
    if not _on_card(pmin):
        return ess_bitmap_reference(
            plane_stats, zs, origin, slopes, tf_lut, tf_off, tf_scale,
            width=width, height=height, ny=ny, nx=nx,
            plane_chunk=plane_chunk, march=march, tex_offset=tex_offset,
            axis_scale=axis_scale, q_margin=q_margin,
        )
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
    p = _ess_params(dict(
        ox=ox, oy=oy, oz=oz, mx0=mx0, dmx=dmx, my0=my0, dmy=dmy,
        xlo=march.box_min[0], xhi=march.box_max[0], ylo=march.box_min[1],
        yhi=march.box_max[1], tex_offset=float(tex_offset),
        sx=float(axis_scale[0]), sy=float(axis_scale[1]),
        tf_off=float(tf_off), tf_scale=float(tf_scale), n_planes=n_planes,
        height=int(height), width=int(width), ny=int(ny), nx=int(nx),
    ), q_margin, plane_chunk, lut_t.shape[0])
    call("vrdd_ess_bitmap", dev, p, *ptrs(pmin, pmax, zs_t, lut_t, out))
    record(ess_bitmap)
    return out


def _ess_params(params: dict, q_margin: float, plane_chunk: int, n_lut: int):
    """The kernels' ``EssParams`` (csrc/ess_common.cuh): the geometry,
    offsets and scales of ``params`` (the host's Python floats, the
    float64 values :func:`ess_bitmap_reference` computes with; the sweep's
    own :func:`_sweep_params` carry them too), tiles of :data:`ESS_TILE`
    and the statistics' 8 x 8 blocks."""
    th, tw = ESS_TILE
    return _build.EssParams(
        **{k: params[k] for k in (
            "ox", "oy", "oz", "mx0", "dmx", "my0", "dmy", "xlo", "xhi", "ylo",
            "yhi", "tex_offset", "sx", "sy", "tf_off", "tf_scale",
            "n_planes", "height", "width", "ny", "nx")},
        q_margin=float(q_margin), plane_chunk=int(plane_chunk), tile_h=th,
        tile_w=tw, n_lut=int(n_lut), n_by=_ESS_YB, n_bx=_ESS_XB,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class EssTest:
    """ESS by the sweep kernels' own interval test: the ``(n_planes, 8,
    8)`` float32 plane min and max of the logical (front-to-back) order on
    the device of the sweep, and the LUT-coordinate margin. The kernel takes
    the rest of the test from the sweep's own parameters. ``args`` and
    ``kwargs`` are :func:`ess_bitmap`'s other arguments, for the same bits
    as data: :meth:`bitmap` (the bitmap kernel on the card) and
    :meth:`reference` (:func:`ess_bitmap_reference`, the plain version)."""

    pmin: torch.Tensor
    pmax: torch.Tensor
    q_margin: float
    args: tuple
    kwargs: dict

    def bitmap(self) -> torch.Tensor:
        return ess_bitmap((self.pmin, self.pmax), *self.args,
                          q_margin=self.q_margin, **self.kwargs)

    def reference(self) -> torch.Tensor:
        return ess_bitmap_reference((self.pmin, self.pmax), *self.args,
                                    q_margin=self.q_margin, **self.kwargs)


def _plain_bitmap(ess):
    """The bitmap a plain version culls by: the plain bitmap of an
    :class:`EssTest`, or None."""
    return None if ess is None else ess.reference()


def _count_plain_ess(ess):
    """Tracing: the (tile, chunk) pairs a plain version's ESS tests and
    finds live (the bitmap's size and set bits), as the kernels count
    theirs (``profiling.ess_counts``); nothing while the tracer is off."""
    if ess is not None and profiling.enabled():
        bits = _plain_bitmap(ess)
        profiling.count("ess.pairs_tested", bits.numel())
        profiling.count("ess.pairs_live", int(bits.sum()))


@torch.no_grad()
def ess_bitmap_reference(plane_stats, zs, origin, slopes, tf_lut, tf_off,
                         tf_scale, *, width: int, height: int, ny: int,
                         nx: int, plane_chunk: int,
                         march: MarchConfig = MarchConfig(),
                         tex_offset: float = 0.5,
                         axis_scale=(1.0, 1.0),
                         q_margin: float = _ESS_Q_MARGIN) -> torch.Tensor:
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
    negative. The interval is widened by ``q_margin`` (:data:`_ESS_Q_MARGIN`
    in f32) in LUT coordinates against float rounding."""
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
    ranges = profiling.to_device(  # one upload: (2, n_ty + n_tx, C)
        np.stack([np.concatenate([yb[0], xb[0]]),
                  np.concatenate([yb[1], xb[1]])]).astype(np.int64),
        dev, "ess_ranges")
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
    lut = profiling.to_device(tf_lut, dev, "lut", dtype=torch.float32)
    n_lut = lut.shape[0]
    la = lut[:, 3].abs()
    toff, tscl = float(tf_off), float(tf_scale)
    q_a = (vmin - toff) * tscl * n_lut - 0.5
    q_b = (vmax - toff) * tscl * n_lut - 0.5
    q_lo = torch.clamp(torch.minimum(q_a, q_b) - q_margin, 0.0, n_lut - 1.0)
    q_hi = torch.clamp(torch.maximum(q_a, q_b) + q_margin, 0.0, n_lut - 1.0)

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


def _ess_q_margin(ess_stats, tf_lut, transfer_scale, bf16: bool) -> float:
    """The bitmap's LUT-coordinate margin: :data:`_ESS_Q_MARGIN` for f32;
    in the bf16 mode also the LUT-coordinate image of a resampled value's
    bf16 spread (:data:`_BF16_SPREAD` of the largest plane magnitude), which
    the interval argument does not see. Reads the stats' largest magnitude
    back to the host in the bf16 mode."""
    if not bf16:
        return _ESS_Q_MARGIN
    vabs = max(float(profiling.to_host(t.abs().max(), "ess_margin"))
               for t in ess_stats)
    return (_ESS_Q_MARGIN + _BF16_SPREAD * vabs * abs(float(transfer_scale))
            * len(tf_lut))


def _resolve_ess(empty_space_skip, ess_stats, planes_all, zs, origin, slopes,
                 tf_lut, transfer_offset, transfer_scale, *, width, height,
                 plane_chunk, march, tex_offset, axis_scale, reverse_planes,
                 bf16=False):
    """The ESS of a sweep over ``planes_all``: an :class:`EssTest`, which
    the sweep kernel runs itself, or None without ESS.
    ``ess_stats`` describe the logical (front-to-back) plane order; without
    them the stats come from the stack, flipped when it is walked back to
    front. ``bf16``: the sweep's resample rounds (:func:`_ess_q_margin`)."""
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
    pmin, pmax = (t.to(torch.float32).contiguous() for t in ess_stats)
    test = EssTest(
        pmin, pmax, _ess_q_margin(ess_stats, tf_lut, transfer_scale, bf16),
        (zs, origin, slopes, tf_lut, transfer_offset, transfer_scale),
        dict(width=width, height=height, ny=ny, nx=nx,
             plane_chunk=plane_chunk, march=march, tex_offset=tex_offset,
             axis_scale=axis_scale),
    )
    return test


def sweep_preblended_planes_reference(
    planes_all, zs, origin, slopes, tf_lut, density=0.05, brightness=1.0,
    transfer_offset=0.0, transfer_scale=1.0, *, dz_sign=-1, width, height,
    march: MarchConfig = MarchConfig(), length_correction=True,
    plane_chunk=8, tex_offset=0.5, plane_spacing=None, axis_scale=(1.0, 1.0),
    filter_linear=True, reverse_planes=False, ess=None, acc_init=None,
    precision="f32",
):
    """Plain torch version of K1, on the device of ``planes_all``: the slope
    grid ``mx0 + dmx * j`` is built in float32 exactly as the kernel builds
    it, then :func:`sweep_preblended_planes_xla` sweeps (a flipped copy of
    the stack when ``reverse_planes``), from the seed ``acc_init`` when
    given. ``ess``: the bitmap of :func:`ess_bitmap` over chunks of
    ``plane_chunk`` planes; culled samples get alpha exactly 0, as the
    kernel skips them. ``precision``: 'f32' or 'bf16' (JAX's bf16
    resample)."""
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
        acc_init=acc_init, precision=precision,
    )


@counted("k1", "staged", "ess", "seed", "bf16")
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
    pairs by the kernel's own interval test (:class:`EssTest`), from
    ``ess_stats`` (cached :func:`ess_plane_stats` of the logical plane
    order) or from the stack; the image is the one without ESS.
    ``acc_init`` ``(height, width, 4)`` seeds the sweep (premultiplied RGBA
    the recursion resumes from; not with ``empty_space_skip``).
    ``precision``: 'f32' or 'bf16' (JAX's bf16 resample; module
    docstring). Returns ``(height, width, 4)``.
    """
    bf16 = _precision_flag(precision)
    _check_seed(acc_init, empty_space_skip)
    n_planes, ny, nx = planes_all.shape
    if plane_spacing is None:
        plane_spacing = (march.box_max[2] - march.box_min[2]) / n_planes
    card = _on_card(planes_all)
    with profiling.annotate("sweep.prepare"):
        zs_host = (profiling.to_host(zs.detach(), "zs").numpy()
                   if isinstance(zs, torch.Tensor)
                   else np.asarray(zs, np.float32))
        if card:  # one upload each for the ESS test and K1
            zs = _device_f32(zs, planes_all.device, "zs")
            tf_lut = _device_f32(tf_lut, planes_all.device, "lut")
        ess = _resolve_ess(
            empty_space_skip, ess_stats, planes_all, zs, origin, slopes,
            tf_lut, transfer_offset, transfer_scale, width=width,
            height=height, plane_chunk=plane_chunk, march=march,
            tex_offset=tex_offset, axis_scale=axis_scale,
            reverse_planes=reverse_planes, bf16=bf16,
        )
    if not card:
        _count_plain_ess(ess)
        return sweep_preblended_planes_reference(
            planes_all, zs, origin, slopes, tf_lut, density, brightness,
            transfer_offset, transfer_scale, dz_sign=dz_sign, width=width,
            height=height, march=march, length_correction=length_correction,
            plane_chunk=plane_chunk, tex_offset=tex_offset,
            plane_spacing=plane_spacing, axis_scale=axis_scale,
            filter_linear=filter_linear, reverse_planes=reverse_planes,
            ess=_plain_bitmap(ess), acc_init=acc_init, precision=precision,
        )
    if not pallas_supported(planes_all.shape, width, height, n_planes,
                            n_lut=len(tf_lut)):
        raise ValueError(
            f"the sweep kernel cannot render planes {tuple(planes_all.shape)} "
            f"-> {width}x{height} with a {len(tf_lut)}-entry LUT"
        )
    with profiling.annotate("sweep.prepare"):
        params = _sweep_params(
            origin, slopes, density, brightness, transfer_offset,
            transfer_scale, plane_spacing, march, width=width, height=height,
            ny=ny, nx=nx, n_planes=n_planes, n_layers=n_planes,
            dz_sign=dz_sign, reverse=reverse_planes,
            length_correction=length_correction, tex_offset=tex_offset,
            axis_scale=axis_scale, filter_linear=filter_linear,
            precision=bf16,
        )
    out, staged = _launch(planes_all, "none", zs, tf_lut, None, params,
                          ess=ess, ess_chunk=plane_chunk, seed=acc_init,
                          zs_host=zs_host)
    record(sweep_preblended_planes, staged=staged, ess=ess is not None,
           seed=acc_init is not None, bf16=bf16)
    return out


def _layer_zs(n: int, march: MarchConfig, dz_sign: int = -1):
    """The depths of ``n`` planes at the centres of ``n`` layers over the
    box, front to back for ``dz_sign``, and their spacing."""
    zlo, zhi = march.box_min[2], march.box_max[2]
    spacing = (zhi - zlo) / n
    zs = (zlo + spacing * (np.arange(n, dtype=np.float32) + 0.5)
          ).astype(np.float32)
    return (zs[::-1].copy() if dz_sign < 0 else zs), spacing


def _plane_stack(volume, n_planes: int, march: MarchConfig, dz_sign: int,
                 tex_offset=0.5, z_scale=1.0, filter_linear=True,
                 pure_ok=True):
    """``(planes_all, zs, pure_sel)``: the front-to-back plane stack a sweep
    of ``volume`` walks, its depths, and whether it is the PURE-SELECTION
    fast path. With ``n_planes == nz`` (and the default z filter grid) every
    plane IS a volume layer, zf = (p+0.5)*nz/n_planes - 0.5 = p exactly, so
    the stack is the volume itself, which the kernel walks back to front
    for ``dz_sign < 0`` instead of a flipped copy; ``pure_ok`` False (ESS
    whose stats come from the stack) keeps the pre-blend."""
    if (pure_ok and n_planes == volume.shape[0] and tex_offset == 0.5
            and z_scale == 1.0):
        return volume, _layer_zs(n_planes, march, dz_sign)[0], True
    planes_all, zs = preblend_planes(
        volume, n_planes, march.box_min, march.box_max, dz_sign, tex_offset,
        z_scale=z_scale, filter_linear=filter_linear)
    return planes_all, zs, False


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
    dz_sign, tex_offset = int(dz_sign), float(tex_offset)
    # with ESS the pure selection needs cached stats, as in JAX
    # (slice_kernel.py:1244-1247)
    planes_all, zs, pure_sel = _plane_stack(
        volume, n_planes, march, dz_sign, tex_offset, axis_scale[2],
        filter_linear, pure_ok=not empty_space_skip or ess_stats is not None)
    return sweep_preblended_planes(
        planes_all, zs, origin, (mx0, dmx, my0, dmy), tf_lut, density,
        brightness, transfer_offset, transfer_scale, dz_sign=dz_sign,
        width=int(np.asarray(mx).shape[0]),
        height=int(np.asarray(my).shape[0]), march=march,
        length_correction=length_correction, precision=precision,
        plane_chunk=plane_chunk, tex_offset=tex_offset,
        empty_space_skip=empty_space_skip, axis_scale=tuple(axis_scale[:2]),
        ess_stats=ess_stats, filter_linear=filter_linear,
        reverse_planes=pure_sel and dz_sign < 0,
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
    zs, spacing = _layer_zs(nz, march)
    mxh, myh = _pixel_slopes(width, height, focal)
    slopes = (
        float(mxh[0]), float(mxh[1] - mxh[0]) if width > 1 else 0.0,
        float(myh[0]), float(myh[1] - myh[0]) if height > 1 else 0.0,
    )
    return zs, slopes, spacing


def _decode_rows(weights, stat: str, B: int, device) -> torch.Tensor:
    if stat not in _N_ROWS:
        raise ValueError(f"unknown stat {stat!r}; use linear / var / entropy")
    rows = profiling.to_device(weights, device, "rows", dtype=torch.float32)
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
    stat: str = "linear", precision: str = "f32",
) -> torch.Tensor:
    """Plain torch version of K2 on the device of ``hist_bm``: materialized
    :func:`decode_with_rows`, then the plain sweep over the decoded layers
    walked back to front (in the bf16 mode the decoded values are the
    rounded operand, as the TPU kernel's ``dec_ref``)."""
    nz, B, ny, nx = hist_bm.shape
    rows = _decode_rows(weights, stat, B, hist_bm.device)
    zs, slopes, spacing = _hist_geometry(nz, width, height, focal, march)
    return sweep_preblended_planes_reference(
        decode_with_rows(hist_bm, rows, stat), zs, origin, slopes, tf_lut,
        density, brightness, transfer_offset, transfer_scale, dz_sign=-1,
        width=width, height=height, march=march,
        length_correction=length_correction, plane_chunk=plane_chunk or 8,
        plane_spacing=spacing, reverse_planes=True, precision=precision,
    )


@counted("k2", "staged", "bf16")
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
    the plain version's batches; the kernel ignores it. ``precision``: 'f32'
    or 'bf16' (JAX's bf16 resample of the decoded values). Returns
    ``(height, width, 4)`` premultiplied RGBA.
    """
    bf16 = _precision_flag(precision)
    nz, B, ny, nx = hist_bm.shape
    rows = _decode_rows(weights, stat, B, hist_bm.device)
    if not _on_card(hist_bm):
        return hist_render_reference(
            hist_bm, rows, origin, tf_lut, density, brightness,
            transfer_offset, transfer_scale, width=width, height=height,
            march=march, length_correction=length_correction,
            plane_chunk=plane_chunk, focal=focal, stat=stat,
            precision=precision,
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
        n_rows=rows.shape[0], precision=bf16,
    )
    out, staged = _launch(hist_bm, stat, zs, tf_lut, rows, params)
    record(pallas_hist_render, staged=staged, bf16=bf16)
    return out
