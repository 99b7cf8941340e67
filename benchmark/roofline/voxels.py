"""Operations and bytes of one multi-view fit step of a per-voxel Gaussian
volume (``fit-voxels``), and its least time on an H100 SXM, in the manner
of :mod:`benchmark.roofline.count` (the same peaks and sample counts).

What one step must do, whatever kernels do it, for ``voxels`` voxels of
``mu`` and ``log sigma`` (float32) and ``renders`` renders (a channel of a
view; ``rotated`` of them through shear-warp) of ``width x height`` RGBA
float32 images:

- **Bytes**: per render, read its channel once and write the channel's
  cotangent once (4 bytes a voxel each way), write the image and read its
  target; once a step, read both parameters for the decode, write both
  gradients, and Adam's update: read each parameter, its gradient and two
  moments, write the parameter and the moments (28 bytes a voxel and
  parameter). The permuted copies of shear-warp and the replay of the
  forward inside the reverse sweep are choices of implementation, not
  needed work, and are not counted; nor is the m-grid image of a rotated
  render, which a fused warp need not store.
- **Operations**: for every sample the renders need (a ray inside the box
  on a plane, before its alpha passed the cutoff: counted by
  :func:`benchmark.reference.voxels.fit_step`), the forward sample and its
  reverse step (:data:`count.FWD_SAMPLE_OPS`, :data:`count.REV_SAMPLE_OPS`);
  per voxel the decode and its chain (:data:`DECODE_VOXEL_OPS`), one add a
  render into the channel's gradient, and Adam's update of both parameters
  (:data:`ADAM_PARAM_OPS` each); per pixel of every render the loss and its
  cotangent (:data:`LOSS_PIXEL_OPS`), and of every rotated render the warp
  and its transpose (:data:`WARP_PIXEL_OPS`).

Operation counts (an FMA counts two, an exp, sqrt, division, floor or
compare one):

- :data:`DECODE_VOXEL_OPS` = 4: ``sigma = exp(log sigma)`` 1, ``var =
  sigma^2`` 1; the chain ``d log sigma = d var * 2 var`` 2.
- :data:`ADAM_PARAM_OPS` = 13: ``m = b1 m + (1 - b1) g`` 3, ``v = b2 v + (1 -
  b2) g^2`` 4, ``sqrt(v) / sqrt(c2) + eps`` 3, ``p -= (lr / c1) m / d`` 3.
- :data:`LOSS_PIXEL_OPS` = 20: four channels' difference and square summed,
  3 each, and their cotangent ``k (img - target)``, 2 each.
- :data:`WARP_PIXEL_OPS` = 92: the pixel's three direction components, two
  FMAs each, 12, its two slopes 2 and their m-grid coordinates 4, floor and
  fraction 4, 22; the four bilinear weights 6 and four channels' four taps,
  an FMA each, 32; the transpose, the image cotangent scattered to the four
  taps of four channels, a multiply and an add each, 32.
"""

from __future__ import annotations

from benchmark.roofline.count import (  # noqa: F401 (bound_s: the kind's)
    FWD_SAMPLE_OPS,
    REV_SAMPLE_OPS,
    bound_s,
)

DECODE_VOXEL_OPS = 2 + 2
ADAM_PARAM_OPS = 3 + 4 + 3 + 3
LOSS_PIXEL_OPS = 4 * 3 + 4 * 2
WARP_PIXEL_OPS = (12 + 2 + 4 + 4) + (6 + 32) + 32


def fit_step_work(*, voxels: int, renders: int, rotated: int, width: int,
                  height: int, live_samples: int):
    """``(bytes, operations)`` one fwd+bwd step must move and compute."""
    pixels = width * height
    n_bytes = (renders * (2 * 4 * voxels + 2 * 4 * 4 * pixels)
               + 2 * (4 + 4 + 28) * voxels)
    n_ops = (live_samples * (FWD_SAMPLE_OPS + REV_SAMPLE_OPS)
             + voxels * (DECODE_VOXEL_OPS + renders + 2 * ADAM_PARAM_OPS)
             + pixels * (renders * LOSS_PIXEL_OPS + rotated * WARP_PIXEL_OPS))
    return n_bytes, n_ops
