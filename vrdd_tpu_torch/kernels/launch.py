"""The host side of every kernel launch, each decision made in one place:
readying a sweep launch of K1-K5 (:func:`prepare`), its fetch path
(:func:`stage_dims`), its shared memory (:func:`lut_fits`,
:func:`stage_smem_bytes`), the library call (:func:`call`) and the launch
counters (:func:`counted`, :func:`record`).

**The fetch path.** Every sweep kernel has two: *staged*, where each block
copies its footprint on a plane (the tap rectangle of its corner rays) into
shared memory and decodes each voxel there once, and *direct*, where every
sample fetches its four taps from device memory. Both give the same images,
checkpoints and LUT cotangents bit for bit (K5's plane cotangent, summed
with atomics, to rounding). A forward launch (K1-K4) stages when the tile
of the footprint bound fits :data:`_STAGE_BUDGET` bytes of shared memory,
with three ring slots on scalar planes and two in the decode modes; K5
stages only in the decode modes (on scalar planes a voxel is one load, and
the staged K5 measured slower than the direct one on an H100, PERF.md). An
image much coarser than the volume goes direct. The internal ``staged``
argument of the wrappers, and :func:`_fetch_path` around a public call,
force either path (tests and ``chip_smoke.py``); a forced staged path
raises when no block can hold the tile.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Tuple

import numpy as np
import torch

from vrdd_tpu_torch.kernels import _build
from vrdd_tpu_torch.utils import profiling

#: decode mode of the kernel template (csrc/slice_sweep.cu DecodeMode)
_MODES = {"none": 0, "linear": 1, "var": 2, "entropy": 3}
#: the forward kernel's CUDA block in pixels, (rows, columns), one thread per
#: ray: also the pixel footprint of an ESS tile. Defined here once; every
#: launch passes it to the kernel (csrc/slice_sweep.cu) as its block shape.
ESS_TILE = (8, 32)
#: K5's block in rays, (columns, rows): csrc/bwd_common.cuh kBwdX, kBwdY
BWD_BLOCK = (32, 4)
#: threads per K5 block; each keeps its own column of LUT/param cotangents
#: in shared memory (csrc/bwd_common.cuh kBwdThreads)
_BWD_THREADS = BWD_BLOCK[0] * BWD_BLOCK[1]
#: the shared memory a direct launch takes without asking for more: what
#: the LUT, the decode rows and K5's LUT columns must fit
_DIRECT_SMEM = 48 * 1024
#: dynamic shared memory (bytes) the staged path may take per block: two
#: forward blocks of 256 threads or K5 blocks of 128 fit on one SM's 227 KB
_STAGE_BUDGET = 100 * 1024
#: the most dynamic shared memory one block can take on an H100
_SMEM_MAX = 227 * 1024
#: a staged path forced by :func:`_fetch_path` (None: by geometry)
_FORCED_PATH = None


# ---- shared memory ----------------------------------------------------------

def _lut_smem_bytes(n_lut: int, row_floats: int = 0, *, g_small: bool = False,
                    ess_bytes: int = 0) -> int:
    """Shared memory of a launch on either path: the LUT, the decode rows,
    K5's per-thread LUT and parameter cotangents (``g_small``) and ESS."""
    lut_cols = (4 * n_lut + 3) * _BWD_THREADS if g_small else 0
    return 4 * (4 * n_lut + row_floats + lut_cols) + ess_bytes


def lut_fits(n_lut: int, row_elems: int = 0, bwd: bool = False) -> bool:
    """The support predicates' test: do ``n_lut`` LUT entries and
    ``row_elems`` floats of decode rows fit a direct launch of the forward,
    or with ``bwd`` of K5 with its LUT columns (n_lut <= 23 on scalars)?"""
    return n_lut >= 1 and _lut_smem_bytes(n_lut, row_elems,
                                          g_small=bwd) <= _DIRECT_SMEM


def _ess_smem_bytes(n_lut: int, n_chunks: int) -> int:
    """Shared memory of a forward launch's ESS (csrc/slice_sweep.cu
    ``ess_smem``): the sparse table of the LUT's |alpha| (floor(log2 n) + 1
    levels of n floats, csrc/ess_common.cuh), then a byte per chunk,
    rounded up to 4."""
    return 4 * n_lut * n_lut.bit_length() + -(-n_chunks // 4) * 4


def stage_smem_bytes(tw: int, th: int, *, n_bins: int, elem_size: int,
                     n_lut: int, row_floats: int, slots: int = 2,
                     bwd_ck: int = 0, g_planes: bool = False,
                     momt: bool = False, g_small: bool = False,
                     ess_bytes: int = 0) -> int:
    """Dynamic shared memory of a staged launch with ``tw`` x ``th``-voxel
    footprints: ``slots`` ring slots of raw rows (each bin of each voxel row
    in 16-byte chunks from the 16-byte boundary below it) and their row
    offsets, the decoded tile, and :func:`_lut_smem_bytes`; K5 (``bwd_ck``,
    its chunk of planes) adds the per-ray caches of a chunk, two d tiles
    (``g_planes``) and the variance moments and touch flags (``momt``).
    Mirrors ``stage_layout`` (csrc/stage_tile.cuh) and ``bwd_extra``
    (csrc/slice_vjp_staged.cu)."""
    rc = (tw * elem_size + 30) // 16
    tile = tw * th
    total = (slots * th * n_bins * (rc * 16 + 4) + 4 * tile
             + _lut_smem_bytes(n_lut, row_floats, g_small=g_small,
                               ess_bytes=ess_bytes))
    if bwd_ck:
        total += 4 * (3 * bwd_ck * _BWD_THREADS + (2 * tile if g_planes else 0)
                      + (3 * tile if momt else 0))
    return total


# ---- the fetch path ---------------------------------------------------------

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


def stage_dims(kind: str, mode: str, params: dict, zs, *, elem_size: int,
               n_lut: int, row_floats: int = 0, staged=None,
               ck_stride: int = 0, g_planes: bool = False,
               g_small: bool = False, ess_bytes: int = 0) -> Tuple[int, int]:
    """The fetch path of a launch of ``kind`` 'fwd' (K1-K4) or 'bwd' (K5),
    by the rule of the module docstring: the kernels' ``(stage_w,
    stage_h)``, :func:`stage_bound` over the host depths ``zs`` when staged,
    else ``(0, 0)``. K5 passes its chunk and cotangents (``g_small``: LUT or
    parameters), a forward with ESS its ``ess_bytes``."""
    bwd, hist = kind == "bwd", mode != "none"
    bound = stage_bound(params, zs, BWD_BLOCK if bwd else ESS_TILE[::-1])
    smem = stage_smem_bytes(
        *bound, n_bins=params["n_bins"] if hist else 1, elem_size=elem_size,
        n_lut=n_lut, row_floats=row_floats, slots=2 if bwd or hist else 3,
        bwd_ck=ck_stride if bwd else 0, g_planes=g_planes,
        momt=bwd and mode == "var" and g_planes, g_small=g_small,
        ess_bytes=ess_bytes)
    if staged is None:
        staged = (_FORCED_PATH if _FORCED_PATH is not None
                  else (hist or not bwd) and smem <= _STAGE_BUDGET)
    if not staged:
        # the direct path holds the LUT, rows and ESS alone: only a long
        # LUT's ESS can overflow a block (the predicates bound the rest)
        direct = _lut_smem_bytes(n_lut, row_floats, g_small=g_small,
                                 ess_bytes=ess_bytes)
        if direct > _SMEM_MAX:
            raise ValueError(
                f"a {n_lut}-entry LUT with its decode rows and ESS needs "
                f"{direct} bytes of shared memory, more than a block has "
                f"({_SMEM_MAX})")
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


# ---- the launch ------------------------------------------------------------

def _host_floats(x, n: int) -> list:
    """A length-n vector (sequence, numpy array or tensor) as Python floats."""
    if isinstance(x, torch.Tensor):
        x = profiling.to_host(x.detach(), "host_floats")
    vals = [float(v) for v in np.asarray(x, dtype=np.float32).reshape(-1)]
    if len(vals) != n:
        raise ValueError(f"expected {n} values, got {len(vals)}")
    return vals


def host_scalars(*xs) -> tuple:
    """Scalars (Python or numpy numbers, one-element tensors) as Python
    floats rounded to float32: the values the kernels' ``c_float`` fields
    hold. A host number costs no transfer; the tensors on a card among
    ``xs`` are read back together, one copy that waits for the work queued
    before it (one ``sync.sweep_params``)."""
    vals = list(xs)
    card = [i for i, x in enumerate(xs)
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"]
    if card:
        got = profiling.to_host(torch.stack(
            [xs[i].detach().reshape(()).to(torch.float32) for i in card]),
            "sweep_params")
        for i, v in zip(card, got):
            vals[i] = v
    return tuple(float(v.detach().reshape(()).to(torch.float32))
                 if isinstance(v, torch.Tensor)
                 else float(np.asarray(v, dtype=np.float32).reshape(()))
                 for v in vals)


def _device_f32(x, dev: torch.device, site: str = "f32") -> torch.Tensor:
    """``x`` (sequence, numpy array or tensor) as a contiguous float32
    tensor on ``dev``. A host array goes up to the card through pinned
    memory without blocking (``profiling.to_device``, counted under
    ``site``): a pageable upload would wait for all the work queued on the
    stream before it."""
    if isinstance(x, torch.Tensor):
        if x.device == dev:
            return x.detach().to(torch.float32).contiguous()
        x = profiling.to_host(x.detach(), site)
    host = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    if dev.type != "cuda":
        return host
    return profiling.to_device(host, dev, site, pinned=True)


def _sweep_params(origin, slopes, density, brightness, transfer_offset,
                  transfer_scale, spacing, march, *, width, height, ny, nx,
                  n_planes, n_layers, dz_sign, reverse, length_correction,
                  tex_offset, axis_scale, filter_linear, n_bins=1,
                  n_rows=1, precision=0) -> dict:
    """The kernels' ``SweepParams`` but ``n_lut`` and ``ess``, as a dict of
    Python numbers."""
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
        thr1=1.0 - float(march.opacity_threshold),
        tex_offset=float(tex_offset), sx=float(axis_scale[0]),
        sy=float(axis_scale[1]), height=int(height), width=int(width),
        ny=int(ny), nx=int(nx), n_planes=int(n_planes),
        n_layers=int(n_layers), n_bins=int(n_bins), n_rows=int(n_rows),
        dz_sign=int(dz_sign), reverse=int(bool(reverse)),
        length_correction=int(bool(length_correction)),
        filter_linear=int(bool(filter_linear)), precision=int(precision),
    )


def prepare(kind: str, vol: torch.Tensor, mode: str, zs, tf_lut, rows,
            params: dict, *, staged=None, zs_host=None, ess_chunk: int = 0,
            ck_stride: int = 0, g_planes: bool = False,
            g_small: bool = False):
    """Ready a sweep launch of ``kind`` 'fwd' or 'bwd' over ``vol`` in
    decode ``mode``: check the volume, upload the depths, the LUT and the
    decode rows (None on scalar planes) to its device and choose the fetch
    path (:func:`stage_dims`) from the host depths (``zs_host`` when ``zs``
    is on the card). ``ess_chunk``: a forward's ESS chunk (0: no ESS).
    Returns ``(zs, lut, rows, p, stage)``: the tensors, the kernels'
    ``SweepParams`` and ``(stage_w, stage_h)``."""
    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"volume dtype {vol.dtype}: use float32 or bfloat16")
    if not vol.is_contiguous():
        raise ValueError("the volume must be contiguous")
    dev = vol.device
    zs_t = _device_f32(zs, dev, "zs")
    lut_t = _device_f32(tf_lut, dev, "lut")
    rows_t = None if rows is None else _device_f32(rows, dev, "rows")
    if lut_t.ndim != 2 or lut_t.shape[1] != 4:
        raise ValueError(f"tf_lut must be (n_lut, 4), got "
                         f"{tuple(lut_t.shape)}")
    if zs_t.numel() != params["n_planes"]:
        raise ValueError("zs must hold one depth per plane")
    n_lut = lut_t.shape[0]
    row_floats = 0 if rows_t is None else rows_t.numel()
    ess_bytes = 0 if not ess_chunk else _ess_smem_bytes(
        n_lut, -(-params["n_planes"] // ess_chunk))
    stage = stage_dims(
        kind, mode, params, zs if zs_host is None else zs_host,
        elem_size=vol.element_size(), n_lut=n_lut, row_floats=row_floats,
        staged=staged, ck_stride=ck_stride, g_planes=g_planes,
        g_small=g_small, ess_bytes=ess_bytes)
    p = _build.SweepParams(n_lut=n_lut, **params)
    return zs_t, lut_t, rows_t, p, stage


def ptrs(*tensors) -> list:
    """The tensors' device pointers, None (a null pointer) for None."""
    return [None if t is None else t.data_ptr() for t in tensors]


def call(entry: str, dev: torch.device, *args) -> None:
    """Launch the library's ``entry`` with ``args`` and the current stream
    of ``dev``, under its device guard and the ``sweep.launch`` span."""
    fn = getattr(_build.library(), entry)
    with profiling.annotate("sweep.launch"), torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


# ---- launch counters --------------------------------------------------------

def counted(prefix: str, *flags: str, sizes: bool = False):
    """Declare a wrapper's launch counters, plain attributes of the function
    set to zero: ``.launches``, and ``.<flag>_launches`` for each of
    ``flags``, the launches among them that were staged (the staged fetch
    path), ess (tested ESS in the kernel), seed (resumed from a seed; K5:
    wrote ``S``), bf16 (the bf16 mode) or live (K4 with its live map). A
    traced window reports them as ``<prefix>.<attribute>``: k1-k5, ``ytr``
    (``dplane_bf16``), ``dchain`` (``decode_chain``), ``bitmap``
    (``ess_bitmap``) and ``flexq`` (``flex_blocks.block_stats``).
    ``sizes`` (K3-K5) adds the Counters ``.size_launches`` and
    ``.size_staged_launches``, per image (H, W)."""
    names = ("launches",) + tuple(f"{f}_launches" for f in flags)

    def declare(fn):
        for name in names:
            setattr(fn, name, 0)
        if sizes:
            fn.size_launches = collections.Counter()
            fn.size_staged_launches = collections.Counter()
        profiling.watch(prefix, fn, names)
        return fn

    return declare


def record(fn, size=None, staged=False, ess=False, seed=False, bf16=False,
           live=False) -> None:
    """Count one launch of ``fn`` from its flags and image ``size``."""
    fn.launches += 1
    if staged:
        fn.staged_launches += 1
    if ess:
        fn.ess_launches += 1
    if seed:
        fn.seed_launches += 1
    if bf16:
        fn.bf16_launches += 1
    if live:
        fn.live_launches += 1
    if size is not None:
        fn.size_launches[size] += 1
        fn.size_staged_launches[size] += staged
