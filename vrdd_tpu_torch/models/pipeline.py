"""Full render pipeline (counterpart of ``vrdd_tpu/models/pipeline.py``).

The analogue of the reference's startup sequence (initCuda ->
dataProcessing -> basicDataProcessing, volumeRender.cpp:1200-1221): given
any subset of {raw histograms, fractal codebooks, flexible-block data},
precompute the corresponding stats volumes once, then render with any query
method 0-9 (volumeRender.cpp:129 legend):

    1/2/3  raw mean / variance / entropy          (originalQueryTex)
    4/5/6  fractal mean / variance / entropy      (fractalQueryTex)
    7      on-the-fly interpolated mean           (in-march decode)
    8/9/0  flexible entropy / mean / variance     (flexBlockTex)

through one of the renderers of the JAX package: ``scan`` (the ray marcher,
``march/scan.py``), ``slice`` (the plain torch plane sweep,
``march/slice.py``), ``pallas`` (the fused sweep kernel K1,
``kernels/slice_kernel.py``, with empty-space skipping on by default),
``shearwarp`` (rotated views on the sweep, ``march/shearwarp.py``: the fused
K3 for a volume on the card, the plain sweep on the CPU) or ``auto``.
Everything runs on the device of the volumes given.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
from vrdd_tpu_torch.core.image import rgba_to_uint8
from vrdd_tpu_torch.core.transfer import default_transfer_function
from vrdd_tpu_torch.kernels.slice_kernel import (
    pallas_slice_render,
    precompute_ess_stats,
)
from vrdd_tpu_torch.march.scan import render_image
from vrdd_tpu_torch.march.shearwarp import (
    shearwarp_applicable,
    shearwarp_render_image,
)
from vrdd_tpu_torch.march.slice import slice_render_image
from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume
from vrdd_tpu_torch.models.renderer import (
    flex_sample_fn,
    interp_mean_sample_fn,
    interp_mean_volume,
    stats_sample_fn,
)
from vrdd_tpu_torch.models.volumes import (
    FractalHistogramVolume,
    RawHistogramVolume,
    compute_stats_volume,
)
from vrdd_tpu_torch.utils import profiling
from vrdd_tpu_torch.utils.config import QueryMethod, RenderConfig, query_channel
from vrdd_tpu_torch.utils.timing import StageTimer

_RAW = (QueryMethod.RAW_MEAN, QueryMethod.RAW_VARIANCE, QueryMethod.RAW_ENTROPY)
_FRACTAL = (QueryMethod.FRACTAL_MEAN, QueryMethod.FRACTAL_VARIANCE,
            QueryMethod.FRACTAL_ENTROPY)
_FLEX = (QueryMethod.FLEX_ENTROPY, QueryMethod.FLEX_MEAN,
         QueryMethod.FLEX_VARIANCE)


class RenderPipeline:
    """Holds precomputed query volumes and renders by query method."""

    def __init__(
        self,
        raw: Optional[RawHistogramVolume] = None,
        fractal: Optional[FractalHistogramVolume] = None,
        flexible: Optional[FlexibleBlockVolume] = None,
        tf_lut: Optional[np.ndarray] = None,
    ):
        timer = StageTimer()
        self.raw = raw
        self.fractal = fractal
        self.flexible = flexible
        self.raw_stats = (
            timer.time("basic_data_processing/raw",
                       lambda: compute_stats_volume(raw))
            if raw is not None
            else None
        )
        self.fractal_stats = (
            timer.time("basic_data_processing/fractal",
                       lambda: compute_stats_volume(fractal))
            if fractal is not None
            else None
        )
        self.timings: Dict[str, float] = timer.as_dict()
        if flexible is not None and flexible.timings:
            self.timings.update(
                {f"data_processing/{k}": v for k, v in flexible.timings.items()}
            )
        device = next((t.device for t in (
            raw.histograms if raw is not None else None,
            fractal.templates if fractal is not None else None,
            flexible.stats_grid if flexible is not None else None,
        ) if t is not None), None)
        self.tf_lut = profiling.to_device(
            default_transfer_function() if tf_lut is None else tf_lut,
            device, "tf_lut", dtype=torch.float32,
        )
        self._interp_mean_vol = None  # query-7 field, built on first use
        self._flex_padded = None  # zero-padded flex grid, built on first use
        # ESS TF-interval culling on the fused-kernel path: exact for the
        # image, so ON by default wherever it applies; the plane stats are
        # camera/TF-independent and cached here per (volume, schedule) —
        # precompute_ess_stats's cache-key contract
        self.empty_space_skip = True
        self._ess_cache: Dict[tuple, tuple] = {}
        self._channel_cache: Dict[QueryMethod, torch.Tensor] = {}

    def set_flexible(self, flexible: FlexibleBlockVolume) -> None:
        """Render queries 8/9/0 from ``flexible`` from now on (a new block
        size of the explorer's slider). Drops exactly the state derived
        from the old grid: its zero-padded copy, its channels and their ESS
        plane stats; the raw, fractal and query-7 state stays."""
        old = [self._channel_cache.pop(m) for m in _FLEX
               if m in self._channel_cache]
        self._ess_cache = {k: e for k, e in self._ess_cache.items()
                           if not any(e[0] is t for t in old)}
        self._flex_padded = None
        self.flexible = flexible

    def _need(self, method: QueryMethod):
        """Raise unless the volume that ``method`` reads is loaded."""
        if method in _RAW and self.raw_stats is None:
            raise ValueError("no raw histogram volume loaded")
        if method in _FRACTAL and self.fractal_stats is None:
            raise ValueError("no fractal codebook volume loaded")
        if method == QueryMethod.INTERP_MEAN and self.raw is None:
            raise ValueError("query 7 needs the raw histogram volume")
        if method in _FLEX and self.flexible is None:
            raise ValueError("no flexible-block volume loaded")

    def sample_source(self, method: QueryMethod, linear: bool = True):
        """(source tensor, tensor -> SampleFn builder) for a query method.

        ``linear=False`` selects point filtering for the stats-volume fetch
        (the reference's 'f' key, volumeRender.cpp:311-314); query 7 and the
        flexible-block fetch stay linear like the reference's textures."""
        method = QueryMethod(method)
        self._need(method)
        if method in _RAW or method in _FRACTAL:
            ch = query_channel(method)
            src = self.raw_stats if method in _RAW else self.fractal_stats
            return src, lambda a: stats_sample_fn(a, ch, linear)
        if method == QueryMethod.INTERP_MEAN:
            return self.raw.histograms, interp_mean_sample_fn
        ch = query_channel(method)
        return self.flexible.stats_grid, lambda a: flex_sample_fn(a, ch)

    def sample_fn(self, method: QueryMethod):
        src, build = self.sample_source(method)
        return build(src)

    def _stats_channel(self, method: QueryMethod) -> torch.Tensor:
        """(Z, Y, X) contiguous scalar field for the object-order paths.

        Memoized per method: the ESS plane-stats cache keys on the IDENTITY
        of the returned tensor — a fresh slice per call would defeat it."""
        method = QueryMethod(method)
        cached = self._channel_cache.get(method)
        if cached is not None:
            return cached
        self._need(method)
        if method in _RAW:
            out = self.raw_stats[..., query_channel(method)].contiguous()
        elif method in _FRACTAL:
            out = self.fractal_stats[..., query_channel(method)].contiguous()
        elif method == QueryMethod.INTERP_MEAN:
            if self._interp_mean_vol is None:
                self._interp_mean_vol = interp_mean_volume(self.raw.histograms)
            out = self._interp_mean_vol
        else:
            # flexible-block queries 8/9/0 on the object-order paths: the
            # CUDA unnormalized fetch (p01 * n_blocks - 0.5 against the
            # zero-padded scatter array, volumeRender_kernel.cu:654-680,
            # 1637-1691) is the same two-tap filter on an (n_blocks + 1)
            # zero-padded grid with the filter grid scaled off the coverage
            # box — see _flex_axis_scale
            if self._flex_padded is None:
                self._flex_padded = torch.nn.functional.pad(
                    self.flexible.stats_grid, (0, 0, 0, 1, 0, 1, 0, 1))
            out = self._flex_padded[..., query_channel(method)].contiguous()
        self._channel_cache[method] = out
        return out

    def _flex_axis_scale(self, method) -> tuple:
        """(sx, sy, sz) filter-grid scales for the object-order sweeps:
        n_blocks / (n_blocks + 1) per axis for flex queries (the padded-grid
        form of the unnormalized fetch), identity otherwise."""
        if QueryMethod(method) not in _FLEX:
            return (1.0, 1.0, 1.0)
        nzb, nyb, nxb = self.flexible.stats_grid.shape[:3]
        return (nxb / (nxb + 1), nyb / (nyb + 1), nzb / (nzb + 1))

    @staticmethod
    def _tex_offset(method) -> float:
        """Filtering convention per query: 7 interpolates on the block-
        boundary grid (volumeRender_kernel.cu:395-478, no -0.5 texel offset);
        everything else uses the CUDA texture model."""
        return 0.0 if QueryMethod(method) == QueryMethod.INTERP_MEAN else 0.5

    def resolve_renderer(
        self, renderer: str, inv_view, config: RenderConfig
    ) -> str:
        """'auto' -> the fastest applicable path for this view/method.

        Unrotated views of every query go object-order: the fused kernel
        ('pallas', which raises on a configuration it cannot take) when the
        stats channel is on the card, else the plain torch sweep ('slice'),
        as JAX picks 'slice' off the TPU. Rotated views take the shear-warp
        sweep ('shearwarp') where d_z keeps one sign over the image, else
        the scan marcher; point filtering at a rotated view goes to the scan
        marcher (the warp would re-soften its texels), as in JAX. A flex
        query without a flexible volume goes to the scan marcher, as in
        JAX (which then raises there)."""
        if renderer != "auto":
            return renderer
        method = QueryMethod(config.query_method)
        if method in _FLEX and self.flexible is None:
            return "scan"
        unrotated = np.allclose(
            np.asarray(inv_view)[:, :3], np.eye(3), atol=1e-6
        )
        if not config.filter_linear and not unrotated:
            return "scan"
        if not unrotated:
            return "shearwarp" if shearwarp_applicable(inv_view) else "scan"
        vol = self._stats_channel(method)
        return "pallas" if vol.device.type == "cuda" else "slice"

    def render(
        self,
        inv_view: Optional[np.ndarray] = None,
        config: RenderConfig = RenderConfig(),
        renderer: str = "scan",
        as_uint8: bool = False,
        channels: int = 4,
    ) -> torch.Tensor:
        """Render ``(H, W, 4)`` float RGBA on the volumes' device.

        ``renderer``: 'scan' (general ray marcher, bit-faithful to d_render),
        'slice' (object-order plain torch sweep), 'pallas' (the fused CUDA
        kernel on the card; its plain version on the CPU), 'shearwarp'
        (any view on the sweep: the fused forward for a volume on the card,
        the plain sweep on the CPU) or 'auto' (fastest applicable). 'slice'
        and 'pallas' require an unrotated view. ``as_uint8=True`` packs to
        RGBA8; ``channels=3`` also drops alpha (uint8 only)."""
        with profiling.annotate("pipeline.render"):
            if inv_view is None:
                inv_view = default_benchmark_inv_view()
            if channels not in (3, 4):
                raise ValueError(f"channels must be 3 or 4, got {channels}")
            if channels == 3 and not as_uint8:
                raise ValueError("channels=3 requires as_uint8=True (the RGB "
                                 "drop is part of the uint8 pack)")
            pack_u8 = ((channels if channels != 4 else True) if as_uint8
                       else False)
            method = QueryMethod(config.query_method)
            self._need(method)
            with profiling.annotate("pipeline.resolve"):
                renderer = self.resolve_renderer(renderer, inv_view, config)
            params = (
                self.tf_lut, config.density, config.brightness,
                config.tf.offset, config.tf.scale,
            )
            if renderer == "shearwarp":
                vol = self._stats_channel(method)
                # distribution stats volumes are coarse (tens of blocks per
                # axis): floor the plane count so the sweep's axial sampling
                # stays comparable to the scan marcher's tstep; flex queries
                # ride it too (the axis permutation carries the filter-grid
                # scales, march/shearwarp.py axis_scale)
                return shearwarp_render_image(
                    vol, np.asarray(inv_view, dtype=np.float32),
                    config.camera.width, config.camera.height, *params,
                    march=config.march, n_planes=max(64, 2 * vol.shape[0]),
                    tex_offset=self._tex_offset(method),
                    axis_scale=self._flex_axis_scale(method),
                    backend="auto", pack_u8=pack_u8,
                )
            # ESS applies to the fused forward with linear filtering (the
            # cached plane stats describe the LINEAR pre-blend; point sampling
            # snaps the z taps, which would make them non-conservative)
            ess = (
                renderer == "pallas"
                and self.empty_space_skip
                and config.filter_linear
            )
            fn = self._compiled(
                method, config.camera.width, config.camera.height,
                config.march, renderer, linear=config.filter_linear,
                pack_u8=pack_u8, ess=ess,
            )
            if renderer in ("slice", "pallas"):
                src = self._stats_channel(method)
            else:
                src, _ = self.sample_source(method)
            if ess:
                with profiling.annotate("pipeline.ess_stats"):
                    stats = self._ess_stats(src, config)
                return fn(src, inv_view, *params, stats)
            return fn(src, inv_view, *params)

    def _ess_stats(self, vol, config):
        """Cached ESS plane stats for a stats-channel volume; keyed on the
        full pre-blend signature (volume identity, plane schedule,
        tex_offset, z_scale, box) per precompute_ess_stats's contract."""
        toff = self._tex_offset(config.query_method)
        zscale = self._flex_axis_scale(config.query_method)[2]
        n_planes = max(64, 2 * vol.shape[0])
        key = (
            id(vol), n_planes, toff, zscale,
            config.march.box_min, config.march.box_max,
        )
        # the entry holds a STRONG reference to the keyed volume and the
        # hit path verifies identity: id() alone could be reused by another
        # tensor after the original is freed, silently serving another
        # volume's plane stats (non-conservative culling = wrong pixels)
        entry = self._ess_cache.get(key)
        if entry is not None and entry[0] is vol:
            return entry[1]
        stats = precompute_ess_stats(
            vol, n_planes=n_planes, march=config.march, dz_sign=-1,
            tex_offset=toff, z_scale=zscale,
        )
        self._ess_cache[key] = (vol, stats)
        return stats

    def _compiled(self, method, width, height, march, renderer="scan",
                  linear=True, pack_u8=False, ess=False):
        """The render function of one configuration (JAX jits and caches
        it; here it runs eagerly): ``fn(src, inv_view, tf_lut, density,
        brightness, offset, scale[, ess_stats])``."""
        # pack_u8: False = float RGBA, True/4 = uint8 RGBA, 3 = uint8 RGB
        if pack_u8:
            def pack(x):
                with profiling.annotate("pipeline.pack"):
                    out = rgba_to_uint8(x)
                    return out[..., :3] if pack_u8 == 3 else out
        else:
            def pack(x):
                return x
        if renderer in ("slice", "pallas"):
            toff = self._tex_offset(method)
            ascale = self._flex_axis_scale(method)
            # point filtering ('f' key) applies to the stats-volume fetch of
            # queries 1-6 only — query 7 interpolates manually and the
            # flexible-block texture is always linear in the reference
            flin = (linear or QueryMethod(method) == QueryMethod.INTERP_MEAN
                    or QueryMethod(method) in _FLEX)

            def run_obj(volume, inv_view, tf_lut, density, brightness,
                        offset, scale, ess_stats=None):
                origin = torch.as_tensor(np.asarray(inv_view, np.float32)[:, 3])
                n_planes = max(64, 2 * volume.shape[0])
                if renderer == "pallas":
                    return pack(pallas_slice_render(
                        volume, origin, tf_lut, density, brightness,
                        offset, scale, width=width, height=height, march=march,
                        n_planes=n_planes, tex_offset=toff,
                        axis_scale=ascale, filter_linear=flin,
                        empty_space_skip=ess, ess_stats=ess_stats,
                    ))
                return pack(slice_render_image(
                    volume, origin, width, height, tf_lut, density,
                    brightness, offset, scale, march=march, n_planes=n_planes,
                    tex_offset=toff, axis_scale=ascale, filter_linear=flin,
                ))

            return run_obj
        if renderer != "scan":
            raise ValueError(f"unknown renderer {renderer!r}")
        _, build = self.sample_source(method, linear)

        def run(src, inv_view, tf_lut, density, brightness, offset, scale):
            return pack(render_image(
                build(src), inv_view, width, height, tf_lut,
                density, brightness, offset, scale, march,
                device=src.device,
            ))

        return run
