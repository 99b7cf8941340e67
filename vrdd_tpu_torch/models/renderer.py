"""User-facing renderer: volumes + query methods -> images (counterpart of
``vrdd_tpu/models/renderer.py``).

Each query method builds a ``sample_fn`` over the relevant precomputed stats
volume, exactly like d_render's per-method texture fetches
(volumeRender_kernel.cu:581-680); the scan marcher (``march/scan.py``)
consumes it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
from vrdd_tpu_torch.core.sampling import (
    sample_nearest_3d,
    sample_trilinear_3d,
    sample_trilinear_3d_unnormalized,
)
from vrdd_tpu_torch.core.transfer import default_transfer_function
from vrdd_tpu_torch.march.scan import render_image
from vrdd_tpu_torch.ops.histogram import _bin_centers
from vrdd_tpu_torch.utils.config import (
    INTERP_MEAN_SCALE,
    MAX_HISTOGRAM,
    N_BINS,
    MarchConfig,
    QueryMethod,
    RenderConfig,
    query_channel,
)

SampleFn = Callable[[torch.Tensor], torch.Tensor]


def scalar_sample_fn(values: torch.Tensor, linear: bool = True) -> SampleFn:
    """Sampling of a plain scalar volume ``(Z, Y, X)``; ``linear=False`` is
    the point-filter mode of the reference's 'f' key (setTextureFilterMode,
    volumeRender.cpp:311-314)."""

    def f(p01: torch.Tensor) -> torch.Tensor:
        if linear:
            return sample_trilinear_3d(values, p01)
        return sample_nearest_3d(values, p01)

    return f


def stats_sample_fn(
    stats_vol: torch.Tensor, channel: int, linear: bool = True
) -> SampleFn:
    """Channel fetch from a (Z, Y, X, 3) stats volume — queries 1-6 semantics
    (linear-filtered float4 fetch then channel select,
    volumeRender_kernel.cu:600-652); ``linear=False`` is the point-filter
    mode of the reference's 'f' key. The channel is selected before the
    fetch: every channel filters independently, so the values are the
    same."""
    return scalar_sample_fn(stats_vol[..., channel], linear)


def flex_sample_fn(flex_stats: torch.Tensor, channel: int) -> SampleFn:
    """Flexible-block fetch — queries 8/9/0 semantics.

    ``flex_stats`` is the compact ``(nZb, nYb, nXb, 3)`` per-block stats grid.
    The reference scatters it into a zero 500^3 array and samples with
    *unnormalized* coords ``p01 * nFlexBlock`` under linear filtering
    (volumeRender_kernel.cu:654-680, 1637-1691); the zero padding past the
    last block is visible at the far faces, so one zero layer is padded on
    each high side and the unnormalized fetch reproduced. The channel is
    selected before the fetch (every channel filters independently).
    """
    nzb, nyb, nxb = flex_stats.shape[:3]
    padded = torch.nn.functional.pad(flex_stats[..., channel], (0, 1, 0, 1, 0, 1))
    scale = torch.tensor([nxb, nyb, nzb], dtype=torch.float32,
                         device=flex_stats.device)

    def f(p01: torch.Tensor) -> torch.Tensor:
        return sample_trilinear_3d_unnormalized(padded, p01 * scale)

    return f


def interp_mean_volume(histograms: torch.Tensor) -> torch.Tensor:
    """Query-7 scalar field: per-block histogram means x50 ``(Z, Y, X)``.

    The decode half of the reference's query 7 (volumeRender_kernel.cu:
    354-367, x50 at :479). The mean is linear in the histogram, so
    interpolating this pre-reduced field equals the reference's per-corner
    in-march decode; the object-order sweeps consume it with
    ``tex_offset=0.0`` (query 7's block-boundary grid, :395-478)."""
    centers = _bin_centers(N_BINS, MAX_HISTOGRAM, histograms.device)
    return torch.sum(histograms * centers, dim=-1) * INTERP_MEAN_SCALE


def interp_mean_sample_fn(histograms: torch.Tensor) -> SampleFn:
    """Query 7 — on-the-fly trilinear-interpolated histogram mean.

    The only mode that decodes *during* the march (volumeRender_kernel.cu:
    354-480): the 8 surrounding block histograms are decoded to means (bin
    centers over [0, MaxHistogram]) and interpolated within the cell spanned by
    ``floor/ceil(p01 * N) / N``, then scaled x50. The mean is linear in the
    histogram, so each block is pre-reduced to its mean and that is
    interpolated — the same value as the reference's 8x32 in-loop fetch.

    Divergence (measure-zero): when a sample lands exactly on a cell boundary
    the reference computes 0/0 = NaN; this returns the boundary value.
    """
    centers = _bin_centers(N_BINS, MAX_HISTOGRAM, histograms.device)
    means = torch.sum(histograms * centers, dim=-1)  # (Z, Y, X)
    nz, ny, nx = means.shape
    dev = means.device
    sizes = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], device=dev)

    def f(p01: torch.Tensor) -> torch.Tensor:
        g = p01 * sizes  # (..., 3) block-boundary coordinates
        c0 = torch.floor(g)
        c1 = torch.ceil(g)
        frac = torch.where(
            c1 > c0, (g - c0) / torch.where(c1 > c0, c1 - c0, 1.0), 0.0)
        i0 = torch.minimum(c0.to(torch.int64).clamp(min=0), hi)
        i1 = torch.minimum(c1.to(torch.int64).clamp(min=0), hi)
        ax, ay, az = frac[..., 0], frac[..., 1], frac[..., 2]

        def m(iz, iy, ix):
            return means[iz, iy, ix]

        x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
        x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
        c00 = m(z0, y0, x0) * (1 - ax) + m(z0, y0, x1) * ax
        c10 = m(z0, y1, x0) * (1 - ax) + m(z0, y1, x1) * ax
        c01 = m(z1, y0, x0) * (1 - ax) + m(z1, y0, x1) * ax
        c11 = m(z1, y1, x0) * (1 - ax) + m(z1, y1, x1) * ax
        c0_ = c00 * (1 - ay) + c10 * ay
        c1_ = c01 * (1 - ay) + c11 * ay
        return (c0_ * (1 - az) + c1_ * az) * INTERP_MEAN_SCALE

    return f


def _render_stats_volume(
    stats_vol: torch.Tensor, inv_view, tf_lut, density, brightness,
    transfer_offset, transfer_scale, width: int, height: int, channel: int,
    march: MarchConfig,
) -> torch.Tensor:
    return render_image(
        stats_sample_fn(stats_vol, channel), inv_view, width, height, tf_lut,
        density, brightness, transfer_offset, transfer_scale, march,
        device=stats_vol.device,
    )


class DistributionRenderer:
    """Convenience façade: hold a volume's precomputed stats + render images.

    ``volume`` is any family of :mod:`vrdd_tpu_torch.models.volumes`; the
    stats decode runs once at construction (the dataProcessing /
    basicDataProcessing analogue), on the volume's device.
    """

    def __init__(self, volume, tf_lut: Optional[np.ndarray] = None):
        self.volume = volume
        self.stats = volume.stats_volume()
        self.tf_lut = torch.as_tensor(
            default_transfer_function() if tf_lut is None else tf_lut,
            dtype=torch.float32, device=self.stats.device,
        )

    def render(
        self,
        inv_view: Optional[np.ndarray] = None,
        config: RenderConfig = RenderConfig(),
    ) -> torch.Tensor:
        if inv_view is None:
            inv_view = default_benchmark_inv_view()
        return _render_stats_volume(
            self.stats, inv_view, self.tf_lut, config.density,
            config.brightness, config.tf.offset, config.tf.scale,
            config.camera.width, config.camera.height,
            query_channel(config.query_method)
            if config.query_method != QueryMethod.INTERP_MEAN
            else 0,
            config.march,
        )
