"""Operations and bytes of one fit step, and its least time on an H100 SXM.

The bound is the larger of the bytes the step must move over the card's
memory rate and the FP32 operations it must compute over the card's FP32
rate outside the tensor cores: the published peaks of the H100 SXM at its
full 700 W (NVIDIA's data sheet). A card set below 700 W runs slower under
load, so every share of the bound is printed beside the card's power
limit.

What one fwd+bwd step of the histogram render must do, whatever kernels
do it:

- **Bytes**: read the histogram volume once, write its gradient once in
  the storage dtype, write the image, read the LUT and write its gradient.
- **Operations**: decode every voxel once (forward) and chain the decoded
  value's cotangent back to its bins once (reverse), and, for every sample
  the image needs (a ray inside the box on a plane, before its alpha
  passed the cutoff: :func:`benchmark.reference.sweep.fit_step` counts
  them), the forward sample and its reverse step. Replaying the forward
  inside the reverse sweep is a choice of implementation, not needed work,
  and is not counted.

Operation counts (an FMA counts two, a min, max, compare, floor, ceil or
select one, a log2 or a division one):

- forward sample, :data:`FWD_SAMPLE_OPS` = 45: the bilinear resample as
  three lerps ``a + t (b - a)``, 3 each, 9; the LUT coordinate ``(s - off)
  scale n - 0.5`` 4, its clamp 2, the knot and fraction 2, the two-tap
  lerp of four channels 12, 20; the opacity ``min(a density stretch, 1)``
  3; the "over" step: premultiply 3, ``1 - acc_a`` 1, four FMAs 8, the
  cutoff test 1, 13. The ray-plane position and taps depend on one pixel
  coordinate each (the rays are a slope grid), so they are work per line
  and per plane, not per sample, and are left out.
- reverse step, :data:`REV_SAMPLE_OPS` = 74: ``P = (g . c) T`` 9, the
  suffix sum ``S`` 1, ``T <- T (1 - a)`` 2, ``d_a = T g_a - S / (1 - a)``
  5, the premultiplied colour's cotangent ``T g_rgb`` 3, to the LUT colour
  ``* a`` 3 and to alpha ``+= d_rgb . col_rgb`` 6, the opacity's chain and
  clamp gate 3, the LUT's cotangent at two knots, four channels, 16, the
  LUT coordinate's ``d_col . (lut[i1] - lut[i0])`` 12 and its scale 2, the
  scatter of the sample's cotangent to its four taps 12.
- decode a voxel of ``B`` bins, :func:`decode_voxel_ops`: the mean a dot
  of ``B`` bins, ``2 B``, and its reverse ``d h_b = d w_b``, ``B``; the
  entropy ``-sum h log2 h`` at ``log2``, multiply and add per bin ``3 B``
  plus the normalizer 1, and its reverse ``d h_b = -d w (log2 h_b +
  1/ln 2)`` at ``log2``, add, two multiplies per bin ``4 B``; the variance
  four dots ``8 B`` plus the combine 5, and its reverse ``d (w2 - 2 m w1 +
  m^2 w3 + e w0)`` at ``8 B`` plus the moments' 3.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
FP32_OPS_PER_S = 67e12     # H100 SXM, FP32 outside the tensor cores
FWD_SAMPLE_OPS = 9 + 20 + 3 + 13
REV_SAMPLE_OPS = 9 + 1 + 2 + 5 + 3 + 3 + 6 + 3 + 16 + 12 + 2 + 12


def decode_voxel_ops(stat: str, bins: int) -> int:
    """Forward and reverse FP32 operations of one voxel's decode."""
    return {"mean": 2 * bins + bins,
            "entropy": (3 * bins + 1) + 4 * bins,
            "var": (8 * bins + 5) + (8 * bins + 3)}[stat]


def fit_step_work(*, voxels: int, bins: int, storage_bytes: int, width: int,
                  height: int, n_lut: int, live_samples: int, stat: str):
    """``(bytes, operations)`` one fwd+bwd step of a histogram volume of
    ``voxels`` voxels must move and compute."""
    hist = voxels * bins * storage_bytes
    n_bytes = 2 * hist + width * height * 4 * 4 + 2 * n_lut * 4 * 4
    n_ops = (live_samples * (FWD_SAMPLE_OPS + REV_SAMPLE_OPS)
             + voxels * decode_voxel_ops(stat, bins))
    return n_bytes, n_ops


def bound_s(n_bytes: int, n_ops: int):
    """``(seconds, 'bytes' | 'operations')``: the least time and what sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
