"""Differentiable fused slice sweep: the K3/K4/K5 wrappers, their plain
versions and the public training API.

The counterpart of ``vrdd_tpu/pallas/slice_vjp.py``, with its names and
signatures. Three kernels, hand-written in CUDA C++ for Hopper:

- **K3** (TPU: ``pallas_call`` at ``slice_vjp.py:698``, ``_fwd_call``), the
  primal when no input needs a gradient: the forward sweep of
  ``csrc/slice_sweep.cu`` without checkpoints, launched by
  :func:`sweep_fwd`;
- **K4** (``slice_vjp.py:714``, ``_fwd_ckpt_call``), the same sweep also
  writing the per-ray transmittance ``T`` at the start of every block of
  ``ck_stride`` planes, launched by :func:`sweep_fwd_ckpt` in the forward of
  the autograd Functions;
- **K5** (``slice_vjp.py:787``, ``_bwd_call``), the reverse sweep of
  ``csrc/slice_vjp.cu``, launched by :func:`sweep_bwd` in their backward.

Each wrapper dispatches on the device of its volume: a CUDA tensor goes to
the kernel or the wrapper raises; a CPU tensor takes the plain torch version
(:func:`sweep_fwd_reference`, :func:`sweep_fwd_ckpt_reference`,
:func:`sweep_bwd_reference`: the plain sweep, its transmittance recursion,
the analytic VJP of ``march/slice.py`` and its ``P_total``). Each counts
its kernel launches in ``.launches``; K3's and K4's ``.ess_launches`` count
those of them that culled by an ESS bitmap, every wrapper's
``.seed_launches`` those that resumed from a seed (K5: that wrote ``S``),
``.staged_launches`` those that took the staged fetch path (each block's
plane footprint decoded once in shared memory; see ``slice_kernel``), and
``.size_launches`` and ``.size_staged_launches`` (Counters) its launches
and staged launches per image ``(H, W)``. Each wrapper takes an internal
``staged`` argument that forces a fetch path; K5 stages by default only in
the decode modes (on scalar planes the direct path measured faster).

Brightness is folded outside the kernels (they run at brightness 1 and the
image is scaled in torch), so it stays differentiable. In the histogram
modes K5 returns the decoded-plane cotangent and the chain to the
histograms is plain torch (``slice_kernel.decode_chain``), as JAX runs it in
XLA outside the kernel.

**Seeded sweeps** (``acc_init`` of :func:`sweep_preblended_planes_diff` and
:func:`sweep_preblended_hist_diff`): K3/K4 resume the "over" recursion from
the ``(H, W, 4)`` seed (K4's checkpoint row 0 is ``T_0 = 1 - seed_a``), K5
also writes each ray's ``S = P_total``, and the seed's cotangent is
``d seed_rgb = g_rgb``, ``d seed_a = g_a - S / T_0`` (0 where ``|T_0| <=
1e-6``, JAX's kernel-route guard, slice_vjp.py:920, 976), whatever ``wrt``
says, so chained sweeps (a streamed decode) backpropagate exactly. The seed
is scaled by brightness with the rest of the image: a chain of seeded
sweeps passes brightness 1 and scales once at the end.

``wrt`` prunes cotangents as in JAX: an input that needs a gradient but is
not listed gets exact zeros. Empty-space skipping (``empty_space_skip`` of
:func:`pallas_slice_render_diff`) culls in K3/K4 with the bitmap of
``slice_kernel.ess_bitmap``; it is exact only for ``wrt=('volume',)`` and
raises otherwise, as in JAX; it takes no seed. K5 takes no bitmap: it
replays the culled samples, whose alpha and slope are zero. Not ported yet
(they raise ``NotImplementedError``): ``precision='bf16'`` (ROADMAP.md
queue 2 item 2) and :func:`live_fractions` (item 3).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vrdd_tpu_torch.march.slice import (
    preblend_planes,
    sweep_p_total,
    transmittance_checkpoints,
)
from vrdd_tpu_torch.kernels.slice_kernel import (
    BWD_BLOCK, ESS_TILE, _MODES, _SMEM_FLOATS, _check_unported,
    _decode_plain, _decode_rows, _decode_rows_grad, _device_f32,
    _hist_geometry, _host_floats, _launch, _on_card, _pixel_slopes,
    _resolve_ess, _slope_grids, _stage_dims, _sweep_params,
    _uniform_grid_params, decode_chain, decode_with_rows,
    hist_render_supported, pallas_supported, stage_bound, stage_smem_bytes,
    sweep_preblended_planes_reference,
)
from vrdd_tpu_torch.utils.config import MarchConfig

__all__ = [
    "pallas_slice_render_diff",
    "pallas_sweep_slope_space_diff",
    "sweep_preblended_planes_diff",
    "sweep_preblended_hist_diff",
    "pallas_hist_render_diff",
    "pallas_diff_supported",
    "live_fractions",
]

#: checkpoint strides K5 is compiled for (csrc/slice_vjp.cu dispatch_ck)
CK_STRIDES = (4, 8)
#: threads per K5 block; each keeps its own column of LUT/param cotangents
#: in shared memory (csrc/bwd_common.cuh kBwdThreads)
_BWD_THREADS = BWD_BLOCK[0] * BWD_BLOCK[1]
#: the TPU's HBM budget in JAX's route='auto' rule (slice_vjp.py:1396): a
#: 16 GB chip's; kept verbatim until the H100 policy is measured
_TPU_AUTO_BUDGET = 13 * 1024 ** 3


def _bwd_smem_ok(n_lut: int, row_elems: int) -> bool:
    return 4 * n_lut + row_elems + (4 * n_lut + 3) * _BWD_THREADS <= _SMEM_FLOATS


def pallas_diff_supported(volume_shape, width, height, n_planes,
                          n_lut: int = 9) -> bool:
    """Can K3-K5 take this configuration? Any image and volume size; the
    LUT must fit the forward's shared memory and the reverse sweep's
    per-thread LUT cotangent columns (n_lut <= 23)."""
    return (pallas_supported(volume_shape, width, height, n_planes, n_lut)
            and _bwd_smem_ok(n_lut, 0))


def _norm_wrt(wrt) -> tuple:
    """Canonical form of a scalar sweep's ``wrt``."""
    allowed = ("volume", "lut", "params")
    wset = set(wrt)
    bad = wset - set(allowed)
    if bad:
        raise ValueError(f"unknown wrt entries {sorted(bad)}; use {allowed}")
    return tuple(w for w in allowed if w in wset)


def _norm_hist_wrt(wrt, stat: str) -> tuple:
    allowed = ("hist", "weights", "lut", "params")
    wset = set(wrt)
    bad = wset - set(allowed)
    if bad:
        raise ValueError(f"unknown wrt entries {sorted(bad)}; use {allowed}")
    if "weights" in wset and stat != "linear":
        raise ValueError("decode-weight cotangents are linear-mode only")
    return tuple(w for w in allowed if w in wset)


def _ck_stride(plane_chunk: int) -> int:
    """The backward's chunk: K5 caches one chunk of planes in registers and
    is compiled for 4 (JAX's default plane_chunk) and 8."""
    if plane_chunk not in CK_STRIDES:
        raise ValueError(
            f"plane_chunk={plane_chunk}: the reverse sweep takes {CK_STRIDES}"
        )
    return plane_chunk


@dataclasses.dataclass(frozen=True, eq=False)
class _Sweep:
    """Host-side configuration of one differentiable sweep: the plane
    schedule, the camera and the decode mode ('none' for a plane stack).
    ``ess``: the ESS bitmap K3/K4 cull by, over chunks of ``ck_stride``
    planes (None: no culling)."""

    zs: np.ndarray
    origin: Tuple[float, float, float]
    slopes: Tuple[float, float, float, float]
    width: int
    height: int
    march: MarchConfig
    plane_spacing: float
    ck_stride: int
    mode: str = "none"
    dz_sign: int = -1
    reverse: bool = False
    length_correction: bool = True
    tex_offset: float = 0.5
    axis_scale: Tuple[float, float] = (1.0, 1.0)
    filter_linear: bool = True
    ess: Optional[torch.Tensor] = None

    @property
    def n_chunks(self) -> int:
        return -(-len(self.zs) // self.ck_stride)

    def params(self, vol, rows, density, toff, tscl) -> dict:
        """The kernels' SweepParams (brightness 1: folded outside)."""
        if self.mode == "none":
            n_layers, ny, nx = vol.shape
            n_bins, n_rows = 1, 1
        else:
            n_layers, n_bins, ny, nx = vol.shape
            n_rows = rows.shape[0]
        return _sweep_params(
            self.origin, self.slopes, float(density), 1.0, float(toff),
            float(tscl), self.plane_spacing, self.march, width=self.width,
            height=self.height, ny=ny, nx=nx, n_planes=len(self.zs),
            n_layers=n_layers, dz_sign=self.dz_sign, reverse=self.reverse,
            length_correction=self.length_correction,
            tex_offset=self.tex_offset, axis_scale=self.axis_scale,
            filter_linear=self.filter_linear, n_bins=n_bins, n_rows=n_rows,
        )

    def check(self, vol, lut):
        n_lut = lut.shape[0]
        if self.mode == "none":
            ok = pallas_diff_supported(vol.shape, self.width, self.height,
                                       len(self.zs), n_lut)
            row_elems = 0
        else:
            ok = hist_render_supported(vol.shape, self.width, self.height,
                                       n_lut)
            row_elems = 4 * vol.shape[1]
        if not (ok and _bwd_smem_ok(n_lut, row_elems)):
            raise ValueError(
                f"the differentiable sweep cannot take {tuple(vol.shape)} -> "
                f"{self.width}x{self.height} with a {n_lut}-entry LUT"
            )

    # -- plain versions ---------------------------------------------------

    def planes(self, vol, rows):
        """The plain versions' scalar planes: the stack, or the decode."""
        return vol if self.mode == "none" else _decode_plain(vol, rows,
                                                             self.mode)

    def reference_image(self, planes, lut, density, toff, tscl, ess=True,
                        acc0=None):
        """The plain image from the seed ``acc0``; ``ess=False`` ignores the
        bitmap (the plain version of K5 replays culled samples, as K5
        does)."""
        return sweep_preblended_planes_reference(
            planes, self.zs, self.origin, self.slopes, lut, density, 1.0,
            toff, tscl, dz_sign=self.dz_sign, width=self.width,
            height=self.height, march=self.march,
            length_correction=self.length_correction,
            plane_chunk=self.ck_stride, tex_offset=self.tex_offset,
            plane_spacing=self.plane_spacing, axis_scale=self.axis_scale,
            filter_linear=self.filter_linear, reverse_planes=self.reverse,
            ess=self.ess if ess else None, acc_init=acc0,
        )

    def slope_grids(self):
        return _slope_grids(self.slopes, self.width, self.height)

    def stack(self, planes):
        """The plain versions' front-to-back stack of decoded planes."""
        return planes.flip(0) if self.reverse else planes


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


# ---- K3 ----------------------------------------------------------------

def sweep_fwd_reference(cfg: _Sweep, vol, rows, lut, density, toff, tscl,
                        acc0=None):
    """Plain version of K3 (and of K4's image): the plain sweep over the
    plane stack or the materialized decode, from the seed ``acc0``."""
    with torch.no_grad():
        return cfg.reference_image(cfg.planes(vol, rows), lut, density, toff,
                                   tscl, acc0=acc0)


def sweep_fwd(cfg: _Sweep, vol, rows, lut, density, toff, tscl, acc0=None,
              staged=None):
    """K3: the differentiable sweep's primal without checkpoints, for calls
    where no input needs a gradient, resumed from the seed ``acc0 (H, W, 4)``
    when given. ``staged`` forces a fetch path (None: by geometry). Returns
    ``(H, W, 4)`` at brightness 1."""
    if not _on_card(vol):
        return sweep_fwd_reference(cfg, vol, rows, lut, density, toff, tscl,
                                   acc0)
    cfg.check(vol, lut)
    out, st = _launch(vol, cfg.mode, cfg.zs, lut.detach(), rows,
                      cfg.params(vol, rows, density, toff, tscl),
                      ess=cfg.ess, ess_chunk=cfg.ck_stride, seed=acc0,
                      staged=staged)
    sweep_fwd.launches += 1
    sweep_fwd.staged_launches += st
    sweep_fwd.ess_launches += cfg.ess is not None
    sweep_fwd.seed_launches += acc0 is not None
    sweep_fwd.size_launches[(cfg.height, cfg.width)] += 1
    sweep_fwd.size_staged_launches[(cfg.height, cfg.width)] += st
    return out


sweep_fwd.launches = 0
sweep_fwd.staged_launches = 0
sweep_fwd.ess_launches = 0
sweep_fwd.seed_launches = 0
sweep_fwd.size_launches = collections.Counter()
sweep_fwd.size_staged_launches = collections.Counter()


# ---- K4 ----------------------------------------------------------------

def sweep_fwd_ckpt_reference(cfg: _Sweep, vol, rows, lut, density, toff,
                             tscl, acc0=None):
    """Plain version of K4: the image and the plain transmittance
    recursion's checkpoints (``march.slice.transmittance_checkpoints``),
    from the seed ``acc0``."""
    with torch.no_grad():
        planes = cfg.planes(vol, rows)
        img = cfg.reference_image(planes, lut, density, toff, tscl,
                                  acc0=acc0)
        mx, my = cfg.slope_grids()
        tck = transmittance_checkpoints(
            cfg.stack(planes), cfg.zs, cfg.origin,
            mx, my, lut, density, toff, tscl, cfg.march,
            ck_stride=cfg.ck_stride, dz_sign=cfg.dz_sign,
            plane_spacing=cfg.plane_spacing,
            length_correction=cfg.length_correction,
            tex_offset=cfg.tex_offset, axis_scale=cfg.axis_scale,
            filter_linear=cfg.filter_linear,
            ess=None if cfg.ess is None else (cfg.ess, cfg.ck_stride,
                                              ESS_TILE),
            acc_init=acc0,
        )
    return img, tck


def sweep_fwd_ckpt(cfg: _Sweep, vol, rows, lut, density, toff, tscl,
                   acc0=None, staged=None):
    """K4: the primal plus ``tck (n_chunks, H, W)``, the transmittance at
    the start of every block of ``cfg.ck_stride`` planes under the
    backward's recursion ``T <- T - [T >= 1-thr] T a``, from ``1 - seed_a``
    for a seed ``acc0``. K4's image is bitwise K3's. ``staged`` forces a
    fetch path (None: by geometry)."""
    if not _on_card(vol):
        return sweep_fwd_ckpt_reference(cfg, vol, rows, lut, density, toff,
                                        tscl, acc0)
    cfg.check(vol, lut)
    out, st = _launch(vol, cfg.mode, cfg.zs, lut.detach(), rows,
                      cfg.params(vol, rows, density, toff, tscl),
                      ck_stride=cfg.ck_stride, ess=cfg.ess,
                      ess_chunk=cfg.ck_stride, seed=acc0, staged=staged)
    sweep_fwd_ckpt.launches += 1
    sweep_fwd_ckpt.staged_launches += st
    sweep_fwd_ckpt.ess_launches += cfg.ess is not None
    sweep_fwd_ckpt.seed_launches += acc0 is not None
    sweep_fwd_ckpt.size_launches[(cfg.height, cfg.width)] += 1
    sweep_fwd_ckpt.size_staged_launches[(cfg.height, cfg.width)] += st
    return out


sweep_fwd_ckpt.launches = 0
sweep_fwd_ckpt.staged_launches = 0
sweep_fwd_ckpt.ess_launches = 0
sweep_fwd_ckpt.seed_launches = 0
sweep_fwd_ckpt.size_launches = collections.Counter()
sweep_fwd_ckpt.size_staged_launches = collections.Counter()


# ---- K5 ----------------------------------------------------------------

def _small(n_lut: int, dev, lut=None, params=(None, None, None)):
    """Pack LUT and (density, toff, tscl) cotangents as K5's (4n+3,) row;
    missing ones are zeros."""
    small = torch.zeros(4 * n_lut + 3, dtype=torch.float32, device=dev)
    if lut is not None:
        small[:4 * n_lut] = lut.reshape(-1)
    for i, p in enumerate(params):
        if p is not None:
            small[4 * n_lut + i] = p
    return small


def sweep_bwd_reference(cfg: _Sweep, vol, rows, lut, density, toff, tscl, g,
                        g_planes, g_lut, g_params, acc0=None):
    """Plain version of K5: the analytic VJP of ``march/slice.py`` over the
    plain planes from the seed ``acc0``, and for a seed its ``P_total``
    (``march.slice.sweep_p_total``). Returns ``(d_planes, small, mom,
    s_img)`` like :func:`sweep_bwd` (``mom`` None: the torch chain computes
    the moments itself)."""
    planes = cfg.planes(vol.detach(), rows).detach().to(torch.float32)
    acc0 = None if acc0 is None else acc0.detach()
    with torch.enable_grad():
        leaves = [planes.requires_grad_(g_planes),
                  lut.detach().requires_grad_(g_lut)] + [
            t.detach().requires_grad_(g_params) for t in (density, toff, tscl)
        ]
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(())
        if wanted:
            img = cfg.reference_image(*leaves, ess=False, acc0=acc0)
            got = iter(torch.autograd.grad(img, wanted, g))
    d = [next(got) if t.requires_grad else None for t in leaves]
    s_img = None
    if acc0 is not None:
        mx, my = cfg.slope_grids()
        s_img = sweep_p_total(
            cfg.stack(planes.detach()), cfg.zs, cfg.origin, mx, my, lut,
            density, toff, tscl, cfg.march, g=g, acc_init=acc0,
            dz_sign=cfg.dz_sign, plane_spacing=cfg.plane_spacing,
            length_correction=cfg.length_correction,
            plane_chunk=cfg.ck_stride, tex_offset=cfg.tex_offset,
            axis_scale=cfg.axis_scale, filter_linear=cfg.filter_linear,
        )
    return d[0], _small(lut.shape[0], vol.device, d[1], d[2:]), None, s_img


def sweep_bwd(cfg: _Sweep, vol, rows, lut, density, toff, tscl, g, tck,
              g_planes: bool, g_lut: bool, g_params: bool, acc0=None,
              staged=None):
    """K5: one reverse sweep from K4's checkpoints. Returns ``(d_planes,
    small, mom, s_img)``: the plane (or decoded-plane) cotangent
    ``(n_layers, ny, nx)`` float32 in storage layer order (None unless
    ``g_planes``), the ``(4 n_lut + 3,)`` LUT / density / TF offset / TF
    scale cotangents (zeros where pruned), in variance mode the per-voxel
    chain moments ``(n_layers, 2, ny, nx)``, and for a seeded sweep
    (``acc0``, the seed K4 ran from) each ray's ``P_total`` ``(H, W)`` that
    the seed cotangent needs (else None). ``staged`` forces a fetch path
    (None: by geometry)."""
    if not _on_card(vol):
        return sweep_bwd_reference(cfg, vol, rows, lut, density, toff, tscl,
                                   g, g_planes, g_lut, g_params, acc0)
    from vrdd_tpu_torch.kernels import _build

    cfg.check(vol, lut)
    if not (g_planes or g_lut or g_params):
        raise ValueError("sweep_bwd: K5 needs a volume, LUT or parameter "
                         "cotangent (S alone is not a mode of it)")
    dev = vol.device
    H, W = cfg.height, cfg.width
    if tuple(g.shape) != (H, W, 4) or tuple(tck.shape) != (cfg.n_chunks, H, W):
        raise ValueError(f"g {tuple(g.shape)} / tck {tuple(tck.shape)} do not "
                         f"fit a {W}x{H} image with {cfg.n_chunks} checkpoints")
    params = cfg.params(vol, rows, density, toff, tscl)
    ny, nx, n_layers = params["ny"], params["nx"], params["n_layers"]
    lut_t = _device_f32(lut.detach(), dev)
    n_lut = lut_t.shape[0]
    g = g.to(torch.float32).contiguous()
    zs_t = _device_f32(cfg.zs, dev)
    rows_t = None if rows is None else rows.detach().contiguous()
    d_planes = (torch.zeros((n_layers, ny, nx), dtype=torch.float32,
                            device=dev) if g_planes else None)
    n_blocks = (-(-W // BWD_BLOCK[0])) * (-(-H // BWD_BLOCK[1]))
    partials = (torch.empty((n_blocks, 4 * n_lut + 3), dtype=torch.float32,
                            device=dev)
                if (g_lut or g_params) else None)
    mom = (torch.zeros((n_layers, 2, ny, nx), dtype=torch.float32, device=dev)
           if (cfg.mode == "var" and g_planes) else None)
    s_img = (None if acc0 is None
             else torch.empty((H, W), dtype=torch.float32, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    hist = cfg.mode != "none"
    bound = stage_bound(params, cfg.zs, BWD_BLOCK)
    # by default only the decode modes stage: on scalar planes a voxel is
    # one load and the staged K5 measured slower than the direct one on an
    # H100 (PERF.md)
    stage = _stage_dims(staged, bound, stage_smem_bytes(
        *bound, n_bins=params["n_bins"] if hist else 1,
        elem_size=vol.element_size(), n_lut=n_lut,
        row_floats=rows_t.numel() if hist else 0, bwd_ck=cfg.ck_stride,
        g_planes=g_planes, momt=mom is not None,
        g_small=partials is not None), prefer=hist)
    p = _build.SweepParams(n_lut=n_lut, **params)
    bp = _build.BwdParams(ck_stride=cfg.ck_stride, n_chunks=cfg.n_chunks,
                          g_planes=int(g_planes), g_lut=int(g_lut),
                          g_params=int(g_params))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vrdd_slice_bwd(
            p, bp, _MODES[cfg.mode], int(vol.dtype == torch.bfloat16),
            vol.data_ptr(), zs_t.data_ptr(), lut_t.data_ptr(), ptr(rows_t),
            g.data_ptr(), tck.data_ptr(), ptr(d_planes), ptr(partials),
            ptr(mom), ptr(s_img), *stage, stream,
        )
    if rc != 0:
        raise RuntimeError(f"vrdd_slice_bwd launch failed: CUDA error {rc}")
    sweep_bwd.launches += 1
    sweep_bwd.staged_launches += stage[0] > 0
    sweep_bwd.seed_launches += acc0 is not None
    sweep_bwd.size_launches[(H, W)] += 1
    sweep_bwd.size_staged_launches[(H, W)] += stage[0] > 0
    small = (partials.sum(0) if partials is not None
             else torch.zeros(4 * n_lut + 3, dtype=torch.float32, device=dev))
    return d_planes, small, mom, s_img


sweep_bwd.launches = 0
sweep_bwd.staged_launches = 0
sweep_bwd.seed_launches = 0
sweep_bwd.size_launches = collections.Counter()
sweep_bwd.size_staged_launches = collections.Counter()


# ---- autograd ------------------------------------------------------------

def _unpack_small(small, n_lut, need, flags):
    """LUT and parameter gradients from K5's small row; exact zeros where
    the input needs a gradient but ``wrt`` pruned it."""
    g_lut = small[:4 * n_lut].reshape(n_lut, 4) if need[0] else None
    if need[0] and not flags[0]:
        g_lut = torch.zeros_like(g_lut)
    params = [small[4 * n_lut + i].clone() if n else None
              for i, n in enumerate(need[1:])]
    return [g_lut] + params


def _save(ctx, cfg, wrt, vol, rows, lut, density, toff, tscl, acc0):
    """K4 forward of both Functions; keeps what K5 needs. Every tensor goes
    through ``save_for_backward``, so a recompute under
    ``torch.utils.checkpoint`` replaces all of them."""
    img, tck = sweep_fwd_ckpt(cfg, vol, rows, lut, density, toff, tscl,
                              acc0)
    ctx.cfg, ctx.wrt = cfg, wrt
    ctx.save_for_backward(vol, rows, lut, density, toff, tscl, acc0, tck)
    return img


def _seed_cotangent(g, acc0, s_img):
    """``d acc0 = [g_rgb, g_a - S / T_0]``, ``T_0 = 1 - seed_a``, with JAX's
    kernel-route guard ``|T_0| > 1e-6`` (a seed frozen past the cutoff has
    ``S = 0``, so the guard never hides a contribution)."""
    t0 = 1.0 - acc0[..., 3]
    live = t0.abs() > 1e-6
    d_a = g[..., 3] - torch.where(live, s_img / torch.where(live, t0, 1.0),
                                  0.0)
    return torch.cat([g[..., :3], d_a[..., None]], -1)


def _grads(ctx, g, need):
    """K5 backward of both Functions: gradients of (volume or histograms,
    decode rows, LUT, density, TF offset, TF scale, seed) for the inputs in
    ``need``; exact zeros where ``wrt`` prunes one that needs a gradient
    (the seed's is never pruned)."""
    vol, rows, lut, density, toff, tscl, acc0, tck = ctx.saved_tensors
    cfg, wrt = ctx.cfg, ctx.wrt
    hist = cfg.mode != "none"
    want_vol = need[0] and ("hist" if hist else "volume") in wrt
    want_rows = need[1] and "weights" in wrt
    flags = (want_vol or want_rows, need[2] and "lut" in wrt,
             any(need[3:6]) and "params" in wrt)
    d_planes, mom, s_img = None, None, None
    small = _small(lut.shape[0], g.device)
    if any(flags) or need[6]:
        # a seed alone (a constant stack resumed from a differentiable
        # prefix) still needs K5 for S: it runs with the parameter sums, as
        # JAX's backward always computes them, and drops them
        d_planes, small_k5, mom, s_img = sweep_bwd(
            cfg, vol, None if rows is None else rows.detach(), lut, density,
            toff, tscl, g, tck, *(flags if any(flags) else (False, False,
                                                            True)),
            acc0=acc0 if need[6] else None)
        if any(flags):
            small = small_k5
    d_vol = d_rows = None
    if need[0] and not want_vol:
        d_vol = torch.zeros_like(vol)
    elif need[0] and hist:
        d_vol = decode_chain(vol, rows.detach(), cfg.mode, d_planes, mom)
    elif need[0]:
        d_vol = d_planes.to(vol.dtype)
    if need[1]:
        d_rows = (_decode_rows_grad(vol, rows.detach(), "linear", d_planes)
                  if want_rows else torch.zeros_like(rows))
    d_acc0 = _seed_cotangent(g, acc0, s_img) if need[6] else None
    return [d_vol, d_rows] + _unpack_small(small, lut.shape[0], need[2:6],
                                           flags[1:]) + [d_acc0]


class _PlanesDiff(torch.autograd.Function):
    """The scalar sweep: K4 forward, K5 backward (gradients to the plane
    stack, the LUT, density, TF offset, TF scale and the seed)."""

    @staticmethod
    def forward(ctx, cfg, wrt, planes, lut, density, toff, tscl, acc0):
        return _save(ctx, cfg, wrt, planes, None, lut, density, toff, tscl,
                     acc0)

    @staticmethod
    def backward(ctx, g):
        n = ctx.needs_input_grad
        d = _grads(ctx, g, (n[2], False, *n[3:]))
        return (None, None, d[0], *d[2:])


class _HistDiff(torch.autograd.Function):
    """The in-kernel decode sweep: K4 forward, K5 backward to the decoded
    planes, then the torch chain to the histograms (and, linear mode, to the
    decode weights), and the seed's cotangent."""

    @staticmethod
    def forward(ctx, cfg, wrt, hist, rows, lut, density, toff, tscl, acc0):
        return _save(ctx, cfg, wrt, hist, rows, lut, density, toff, tscl,
                     acc0)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *_grads(ctx, g, ctx.needs_input_grad[2:]))


def _diff_sweep(cfg: _Sweep, wrt, vol, rows, tf_lut, density, toff, tscl,
                acc_init=None):
    """K3 when nothing needs a gradient, else the autograd Function; from
    the seed ``acc_init`` when given."""
    dev = vol.device
    lut, density, toff, tscl = (_f32(x, dev)
                                for x in (tf_lut, density, toff, tscl))
    acc0 = None
    if acc_init is not None:
        acc0 = _f32(acc_init, dev)
        if tuple(acc0.shape) != (cfg.height, cfg.width, 4):
            raise ValueError(f"acc_init {tuple(acc0.shape)}: want "
                             f"({cfg.height}, {cfg.width}, 4)")
    tensors = [vol, lut, density, toff, tscl] + [
        t for t in (rows, acc0) if t is not None]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return sweep_fwd(cfg, vol, rows, lut, density, toff, tscl, acc0)
    if rows is None:
        return _PlanesDiff.apply(cfg, wrt, vol, lut, density, toff, tscl,
                                 acc0)
    return _HistDiff.apply(cfg, wrt, vol, rows, lut, density, toff, tscl,
                           acc0)


# ---- public API -----------------------------------------------------------

def planes_config(zs, origin, slopes, *, dz_sign=-1, width, height,
                  march=MarchConfig(), plane_spacing=None, n_planes,
                  length_correction=True, plane_chunk=4, tex_offset=0.5,
                  axis_scale=(1.0, 1.0), reverse_planes=False,
                  ess=None) -> _Sweep:
    """The sweep of a scalar ``(n_planes, NY, NX)`` plane stack with depths
    ``zs`` and ``slopes = [mx0, dmx, my0, dmy]``, culled by the ESS bitmap
    ``ess`` (of :func:`~vrdd_tpu_torch.kernels.slice_kernel.ess_bitmap` over
    chunks of ``plane_chunk`` planes) when given: the handle to call
    :func:`sweep_fwd`, :func:`sweep_fwd_ckpt` and :func:`sweep_bwd` (or
    their plain versions) on a stack directly, as :func:`render_config` is
    for one plane per layer."""
    if plane_spacing is None:
        plane_spacing = (march.box_max[2] - march.box_min[2]) / n_planes
    return _Sweep(
        zs=np.asarray(zs, np.float32), origin=tuple(_host_floats(origin, 3)),
        slopes=tuple(_host_floats(slopes, 4)), width=int(width),
        height=int(height), march=march, plane_spacing=float(plane_spacing),
        ck_stride=_ck_stride(plane_chunk), dz_sign=int(dz_sign),
        reverse=bool(reverse_planes), length_correction=length_correction,
        tex_offset=float(tex_offset), axis_scale=tuple(axis_scale), ess=ess,
    )


def sweep_preblended_planes_diff(
    planes_all,
    zs,
    origin,
    slopes,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    dz_sign=-1,
    width,
    height,
    march: MarchConfig = MarchConfig(),
    length_correction=True,
    precision="f32",
    plane_chunk=4,
    tex_offset=0.5,
    wrt: tuple = ("volume", "lut", "params"),
    acc_init=None,
    plane_spacing=None,
    axis_scale=(1.0, 1.0),
    reverse_planes=False,
):
    """Differentiable twin of ``sweep_preblended_planes``: ``planes_all (P,
    NY, NX)`` front to back (stored z-ascending and walked back to front
    when ``reverse_planes``, with ``d_planes`` in the same storage order),
    ``zs (P,)`` plane depths, ``slopes = [mx0, dmx, my0, dmy]``. Under
    autograd the forward is K4 and the backward K5; otherwise K3.
    ``plane_chunk`` (4 or 8) is the backward's chunk. ``acc_init (H, W,
    4)`` seeds the sweep and gets its own cotangent (see the module
    docstring); ``plane_spacing`` must then be the full stack's."""
    _check_unported(precision)
    cfg = planes_config(
        zs, origin, slopes, dz_sign=dz_sign, width=width, height=height,
        march=march, plane_spacing=plane_spacing,
        n_planes=planes_all.shape[0], length_correction=length_correction,
        plane_chunk=plane_chunk, tex_offset=tex_offset,
        axis_scale=axis_scale, reverse_planes=reverse_planes,
    )
    out = _diff_sweep(cfg, _norm_wrt(wrt), planes_all, None, tf_lut, density,
                      transfer_offset, transfer_scale, acc_init)
    return out * brightness


def sweep_preblended_hist_diff(
    hist_bm,
    weights,
    zs,
    origin,
    slopes,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    dz_sign=-1,
    width,
    height,
    march: MarchConfig = MarchConfig(),
    length_correction=True,
    precision="f32",
    plane_chunk=4,
    wrt: tuple = ("hist", "lut", "params"),
    stat: str = "linear",
    acc_init=None,
    plane_spacing=None,
    reverse_planes=True,
):
    """``sweep_preblended_planes_diff`` for a bins-major histogram slab
    ``(P, B, NY, NX)``: the planes ARE the layers (walked back to front when
    ``reverse_planes``), decoded per voxel in the kernels (``stat`` =
    'linear' / 'var' / 'entropy' with the rows of ``decode_weight_rows``).
    ``wrt``: 'hist', 'weights' (linear only), 'lut', 'params'; ``acc_init``
    seeds the sweep, as in :func:`sweep_preblended_planes_diff`."""
    _check_unported(precision)
    n_planes, B = hist_bm.shape[:2]
    rows = _decode_rows(weights, stat, B, hist_bm.device)
    if plane_spacing is None:
        plane_spacing = (march.box_max[2] - march.box_min[2]) / n_planes
    cfg = _Sweep(
        zs=np.asarray(zs, np.float32), origin=tuple(_host_floats(origin, 3)),
        slopes=tuple(_host_floats(slopes, 4)), width=int(width),
        height=int(height), march=march, plane_spacing=float(plane_spacing),
        ck_stride=_ck_stride(plane_chunk), mode=stat, dz_sign=int(dz_sign),
        reverse=bool(reverse_planes), length_correction=length_correction,
    )
    out = _diff_sweep(cfg, _norm_hist_wrt(wrt, stat), hist_bm, rows, tf_lut,
                      density, transfer_offset, transfer_scale, acc_init)
    return out * brightness


def _diff_call(
    volume, origin, slopes, tf_lut, density, brightness, transfer_offset,
    transfer_scale, *, dz_sign, width, height, march, n_planes,
    length_correction, precision, plane_chunk, tex_offset=0.5,
    wrt=("volume", "lut", "params"), empty_space_skip=False,
    axis_scale=(1.0, 1.0, 1.0),
):
    _check_unported(precision)
    nz = volume.shape[0]
    if n_planes <= 0:
        n_planes = 2 * nz
    if empty_space_skip and tuple(wrt) != ("volume",):
        raise ValueError(
            "empty_space_skip is exact only for wrt=('volume',): alpha-LUT / "
            "density / TF-offset / TF-scale cotangents are nonzero in empty "
            "space (raising a LUT alpha entry would make it visible)"
        )
    # pure selection (slice_vjp.py:1076-1086): every plane IS a layer, so
    # the kernels stream the volume walked back to front and K5 writes the
    # cotangent in layer order; otherwise the torch pre-blend (autograd
    # takes its transpose). ESS keeps the pre-blend, as in JAX: its plane
    # stats come from the stack
    pure_sel = (n_planes == nz and tex_offset == 0.5 and axis_scale[2] == 1.0
                and not empty_space_skip)
    if pure_sel:
        zlo, zhi = march.box_min[2], march.box_max[2]
        spacing = (zhi - zlo) / n_planes
        zs = (zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)
              ).astype(np.float32)
        if dz_sign < 0:
            zs = zs[::-1].copy()
        planes_all = volume
    else:
        planes_all, zs = preblend_planes(
            volume, n_planes, march.box_min, march.box_max, dz_sign,
            tex_offset, z_scale=axis_scale[2],
        )
    ess = _resolve_ess(
        empty_space_skip, None, planes_all, zs, origin, slopes, tf_lut,
        transfer_offset, transfer_scale, width=width, height=height,
        plane_chunk=_ck_stride(plane_chunk), march=march,
        tex_offset=tex_offset, axis_scale=axis_scale[:2],
        reverse_planes=False,
    )
    cfg = planes_config(
        zs, origin, slopes, dz_sign=dz_sign, width=width, height=height,
        march=march, plane_spacing=None, n_planes=n_planes,
        length_correction=length_correction, plane_chunk=plane_chunk,
        tex_offset=tex_offset, axis_scale=axis_scale[:2],
        reverse_planes=pure_sel and dz_sign < 0, ess=ess,
    )
    out = _diff_sweep(cfg, wrt, planes_all, None, tf_lut, density,
                      transfer_offset, transfer_scale)
    return out * brightness


def pallas_sweep_slope_space_diff(
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
    plane_chunk: int = 4,
    tex_offset: float = 0.5,
    wrt: tuple = ("volume", "lut", "params"),
    empty_space_skip: bool = False,
    axis_scale=(1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Differentiable fused sweep over a UNIFORM ray-slope grid: ``(Hm, Wm,
    4)``. Any grid length (the kernels take any image size)."""
    mx0, dmx = _uniform_grid_params(mx, "mx")
    my0, dmy = _uniform_grid_params(my, "my")
    return _diff_call(
        volume, origin, (mx0, dmx, my0, dmy), tf_lut, density, brightness,
        transfer_offset, transfer_scale, dz_sign=int(dz_sign),
        width=int(np.asarray(mx).shape[0]), height=int(np.asarray(my).shape[0]),
        march=march, n_planes=n_planes, length_correction=length_correction,
        precision=precision, plane_chunk=plane_chunk,
        tex_offset=float(tex_offset), wrt=_norm_wrt(wrt),
        empty_space_skip=empty_space_skip, axis_scale=tuple(axis_scale),
    )


def pallas_slice_render_diff(
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
    plane_chunk: int = 4,
    tex_offset: float = 0.5,
    wrt: tuple = ("volume", "lut", "params"),
    empty_space_skip: bool = False,
    axis_scale=(1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Differentiable fused render of a scalar volume: same value as
    ``pallas_slice_render``; gradients to the volume, LUT, density,
    brightness and TF offset/scale, pruned by ``wrt`` ('volume', 'lut',
    'params': pruned inputs get exact zeros)."""
    if n_planes <= 0:
        n_planes = 2 * volume.shape[0]
    mx, my = _pixel_slopes(width, height, focal)
    return pallas_sweep_slope_space_diff(
        volume, origin, mx, my, tf_lut, density, brightness,
        transfer_offset, transfer_scale, march=march, dz_sign=-1,
        n_planes=n_planes, length_correction=length_correction,
        precision=precision, plane_chunk=plane_chunk, tex_offset=tex_offset,
        wrt=wrt, empty_space_skip=empty_space_skip, axis_scale=axis_scale,
    )


def auto_route(hist_shape, hist_dtype, stat: str) -> str:
    """JAX's ``route='auto'`` rule verbatim (slice_vjp.py:1392-1397):
    'inkernel' for entropy and whenever the materialized route's extra
    residency would crowd the TPU's 13 GiB budget, else 'materialized'. Not
    yet re-measured for the H100 (ROADMAP.md queue 2 item 4)."""
    hist_bytes = int(np.prod(hist_shape)) * torch.empty(
        (), dtype=hist_dtype).element_size()
    voxels = hist_shape[0] * hist_shape[2] * hist_shape[3]
    fits = 2 * hist_bytes + 12 * voxels < _TPU_AUTO_BUDGET
    return "materialized" if (stat != "entropy" and fits) else "inkernel"


def pallas_hist_render_diff(
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
    plane_chunk: int = 4,
    focal: float = 2.0,
    wrt: tuple = ("hist", "lut"),
    stat: str = "linear",
    route: str = "inkernel",
) -> torch.Tensor:
    """Differentiable render straight from a bins-major ``(nz, B, ny, nx)``
    histogram volume (f32 or bf16 storage), one plane per layer, unrotated
    camera at ``origin``, any image size.

    ``route``: 'inkernel' decodes inside K3/K4/K5 (nothing decoded is
    stored; K5 returns the decoded-plane cotangent and the chain to
    ``d_hist`` is torch, z-chunked); 'materialized' decodes with torch
    (``decode_with_rows``, whose backward is the same chain) and runs the
    scalar sweep's kernels; 'auto' is :func:`auto_route`. ``wrt``: 'hist',
    'weights' (linear only), 'lut', 'params'; ``d_hist`` comes back in the
    storage dtype."""
    if route == "auto":
        route = auto_route(hist_bm.shape, hist_bm.dtype, stat)
    if route == "materialized":
        nz = hist_bm.shape[0]
        vol = decode_with_rows(hist_bm, weights, stat)
        if "hist" not in wrt:
            vol = vol.detach()
        kw = tuple(w for w in ("volume", "lut", "params")
                   if w in wrt or (w == "volume" and "hist" in wrt))
        return pallas_slice_render_diff(
            vol, origin, tf_lut, density, brightness, transfer_offset,
            transfer_scale, width=width, height=height, march=march,
            focal=focal, n_planes=nz, length_correction=length_correction,
            precision=precision, plane_chunk=plane_chunk or 4, wrt=kw,
        )
    if route != "inkernel":
        raise ValueError(f"unknown route {route!r}; use inkernel / "
                         "materialized / auto")
    _check_unported(precision)
    cfg = render_config(hist_bm.shape, origin, stat=stat, width=width,
                        height=height, march=march, focal=focal,
                        plane_chunk=plane_chunk or 4,
                        length_correction=length_correction)
    rows = _decode_rows(weights, stat, hist_bm.shape[1], hist_bm.device)
    out = _diff_sweep(cfg, _norm_hist_wrt(wrt, stat), hist_bm, rows, tf_lut,
                      density, transfer_offset, transfer_scale)
    return out * brightness


def render_config(shape, origin, *, stat: str = "none", width: int,
                  height: int, march: MarchConfig = MarchConfig(),
                  focal: float = 2.0, plane_chunk: int = 4,
                  length_correction: bool = True) -> _Sweep:
    """The sweep of an unrotated render with one plane per layer, walked
    back to front: of a scalar ``(nz, ny, nx)`` volume (``stat='none'``) or
    a bins-major ``(nz, B, ny, nx)`` histogram volume (``stat`` 'linear' /
    'var' / 'entropy'). The in-kernel route's configuration, and the handle
    to call :func:`sweep_fwd`, :func:`sweep_fwd_ckpt` and :func:`sweep_bwd`
    (or their plain versions) directly."""
    zs, slopes, spacing = _hist_geometry(shape[0], width, height, focal, march)
    return _Sweep(
        zs=zs, origin=tuple(_host_floats(origin, 3)), slopes=slopes,
        width=int(width), height=int(height), march=march,
        plane_spacing=spacing, ck_stride=_ck_stride(plane_chunk), mode=stat,
        reverse=True, length_correction=length_correction,
    )


def live_fractions(*args, **kwargs) -> dict:
    """Not ported: the TPU kernel's live-tile bitmap is a (strip, chunk,
    x-tile) quantity of its tiling; what it means per warp or block on the
    card is still to decide (ROADMAP.md queue 2 item 3)."""
    raise NotImplementedError(
        "live_fractions is not ported yet (ROADMAP.md queue 2 item 3)"
    )
