"""``HistRenderer``: the render-hist path as an ``nn.Module``, forward and
backward.

Holds the transfer-function LUT and the decode rows as buffers (so
``.to(device)`` moves them with the module) and the render parameters as
attributes. ``forward(hist_bm, origin)`` is :func:`pallas_hist_render` (K2)
when nothing needs a gradient, and :func:`pallas_hist_render_diff` (K4
forward, K5 backward, through ``route``) when grad is enabled and the
histogram volume or the LUT requires grad; a CPU volume takes the plain
versions either way.
"""

from __future__ import annotations

import torch
from torch import nn

from vrdd_tpu_torch.kernels.slice_kernel import pallas_hist_render
from vrdd_tpu_torch.kernels.slice_vjp import pallas_hist_render_diff
from vrdd_tpu_torch.utils.config import MarchConfig


class HistRenderer(nn.Module):
    """Render bins-major ``(nz, B, ny, nx)`` histogram volumes to
    ``(height, width, 4)`` premultiplied RGBA with an unrotated camera.

    ``rows``/``stat`` come from ``decode_weight_rows`` (``stat`` is its
    returned mode: 'linear', 'var' or 'entropy'). ``route`` ('inkernel',
    'materialized' or 'auto') and ``wrt`` are those of
    :func:`pallas_hist_render_diff`, used when a gradient is needed.
    """

    def __init__(self, tf_lut, rows, *, stat: str = "linear", width: int,
                 height: int, density: float = 0.05, brightness: float = 1.0,
                 transfer_offset: float = 0.0, transfer_scale: float = 1.0,
                 march: MarchConfig = MarchConfig(), focal: float = 2.0,
                 route: str = "inkernel", wrt=("hist", "lut"), device=None):
        super().__init__()
        self.register_buffer(
            "tf_lut", torch.as_tensor(tf_lut, dtype=torch.float32, device=device)
        )
        self.register_buffer(
            "rows", torch.as_tensor(rows, dtype=torch.float32, device=device)
        )
        self.stat = stat
        self.width = width
        self.height = height
        self.density = density
        self.brightness = brightness
        self.transfer_offset = transfer_offset
        self.transfer_scale = transfer_scale
        self.march = march
        self.focal = focal
        self.route = route
        self.wrt = tuple(wrt)

    def forward(self, hist_bm: torch.Tensor, origin) -> torch.Tensor:
        args = (hist_bm, self.rows, origin, self.tf_lut, self.density,
                self.brightness, self.transfer_offset, self.transfer_scale)
        kw = dict(width=self.width, height=self.height, march=self.march,
                  focal=self.focal, stat=self.stat)
        if torch.is_grad_enabled() and (hist_bm.requires_grad
                                        or self.tf_lut.requires_grad):
            return pallas_hist_render_diff(*args, wrt=self.wrt,
                                           route=self.route, **kw)
        return pallas_hist_render(*args, **kw)
