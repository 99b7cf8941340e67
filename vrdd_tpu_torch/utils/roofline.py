"""The least time an NVIDIA H100 could take for a sweep: the operation and
byte counts shared by ``vrdd_tpu_torch/bench.py`` and ``chip_smoke.py``.

A bound is the larger of two times: the bytes a call must move (each input
byte it needs read once, each output written once) over the card's memory
rate, and its FP32 operations over the card's FP32 rate outside the tensor
cores. Both rates are the published ones of the H100 SXM at its full 700 W
power limit; a card set below it runs slower under load, so every share of
a bound is printed beside the card's name and power limit. Both counts are
what the call's data needs (:func:`live_samples`): samples the sweep
evaluates and the plane texels they read, not the most a sweep could.
"""

from __future__ import annotations

import torch

from vrdd_tpu_torch.utils.config import MarchConfig

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM, FP32 outside the tensor cores
#: FP32 operations per evaluated sample of the forward sweep (K1-K4),
#: counted from csrc/sweep_common.cuh and slice_sweep.cu (an FMA counts as
#: two; a min, max, abs, floor or compare as one): the bilinear resample 9,
#: the LUT tent 16 and its four channels 12, the opacity 3, the "over" step
#: 13. Left out, so that the bound stays a lower bound: the ray-plane taps
#: (20 per axis), which depend on the plane and only one pixel coordinate
#: (the sweep runs in slope space: a column's x taps, a row's y taps), so
#: the work they need is per line, at most 20 P (H + W) against the
#: samples' up to 53 P H W; and K4's transmittance step (3)
SAMPLE_OPS = 53
#: FP32 operations per evaluated sample of the reverse sweep (K5), counted
#: from bwd_common.cuh reverse_sample and slice_vjp.cu: the replay of the
#: forward's sample from the checkpoint 34 (resample 9, tent 16, alpha
#: channel 3, opacity 3, T step 3), then the reverse step 79 (three colour
#: channels 9, opacity 3, g . rgb 5, the chain S / (1 - a) 4, d_a 4, S 4,
#: T a 1, the clamp's gate 3, the LUT cotangent 18, the slope's gate 4 and
#: its value 8, dq 4, d_res 2, the scatter to the four taps 10), the tent
#: counted once; the taps are left out as in SAMPLE_OPS
K5_SAMPLE_OPS = 113


def decode_ops(mode, B):
    """FP32 operations of the in-kernel decode of one sample's four tap
    voxels (log2 counted as one operation)."""
    per_voxel = {"none": 0, "linear": 2 * B, "var": 8 * B + 6,
                 "entropy": 4 * B + 1}[mode]
    return 4 * per_voxel


def ess_pair_ops(plane_chunk):
    """Operations of the ESS interval test for one (tile, chunk), counted
    from csrc/ess_common.cuh (a float64 operation counts as one): the depth
    range and the corner and block geometry 60, the block min and max over
    the chunk's planes at 2 x 2 blocks, the LUT interval and its two ends
    20, the knots inside as one range maximum of the sparse table 8 (the
    bounds, the level, two reads' indices, two maxima)."""
    return 60 + 2 * 4 * plane_chunk + 20 + 8


def ess_table_ops(n_lut):
    """Operations of one block's sparse table of the LUT's |alpha|
    (ess_table_build): one maximum per entry of each level above the
    first, at most n_lut floor(log2 n_lut)."""
    return n_lut * (n_lut.bit_length() - 1)


def bound(n_bytes, n_ops):
    """``bound_ms`` and ``bound_by`` of a call that must move ``n_bytes``
    and compute ``n_ops`` FP32 operations."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def live_samples(planes, zs, slopes, lut, density, toff, tscl, W, H, *,
                 reverse=False, ess=None, chunk=8, tex_offset=0.5,
                 origin=(0.0, 0.0, 4.0), dz_sign=-1, seed_alpha=None,
                 axis_scale=(1.0, 1.0), spacing=None):
    """``(samples, texels)``: the samples the sweep kernels evaluate on
    these inputs, and the distinct plane texels those samples read. A sample
    is evaluated where the plane is in front of the camera, the ray inside
    the box there and not yet past the opacity cutoff, and the (tile,
    chunk) not culled by the ESS bitmap ``ess``; it reads the two x by two y
    taps of its resample. Counted with the plain version's per-plane alpha,
    front to back (``reverse``: the stack is stored z-ascending), from the
    camera at ``origin`` whose rays have d_z of sign ``dz_sign``, the
    accumulated alpha starting at ``seed_alpha`` (H, W) for a seeded
    sweep, on the filter grid scaled by ``axis_scale`` (flexible blocks),
    the planes ``spacing`` apart (None: the box's depth over ``P``; a slab
    of a longer stack passes the stack's)."""
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.march.slice import _chunk_rgba_fn

    march = MarchConfig()
    dev = planes.device
    P, ny, nx = planes.shape
    mx, my = sk._slope_grids(slopes, W, H)
    rgba = _chunk_rgba_fn(P, ny, nx, zs, torch.tensor(origin), mx, my, march,
                          dz_sign, spacing, True, tex_offset,
                          tuple(axis_scale), True, dev)
    mx_t, my_t = torch.as_tensor(mx, device=dev), torch.as_tensor(my, device=dev)
    th, tw = sk.ESS_TILE
    ti = torch.arange(H, device=dev) // th
    tj = torch.arange(W, device=dev) // tw
    lut_t = torch.as_tensor(lut, dtype=torch.float32, device=dev)
    ox, oy, oz = origin
    (xlo, ylo, _), (xhi, yhi, _) = march.box_min, march.box_max
    thr = march.opacity_threshold

    def taps(w, lo, hi, n, scale):
        """(rays, n) 0/1 matrix of the texels each ray's resample reads."""
        q = ((w - lo) / (hi - lo) * (n * scale) - tex_offset).clamp(0.0,
                                                                    n - 1.0)
        i0 = torch.floor(q).long()
        m = torch.zeros((w.shape[0], n), device=dev)
        rows = torch.arange(w.shape[0], device=dev)
        m[rows, i0] = 1.0
        m[rows, (i0 + 1).clamp(max=n - 1)] = 1.0
        return m

    acc = (torch.zeros((H, W), device=dev) if seed_alpha is None
           else seed_alpha.to(dev, torch.float32).clone())
    count = torch.zeros((), dtype=torch.int64, device=dev)
    texels = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for c0 in range(0, P, chunk):
            idx = torch.arange(c0, min(c0 + chunk, P), device=dev)
            a = rgba(c0, planes[P - 1 - idx if reverse else idx].float(),
                     lut_t, density, toff, tscl)[..., 3]
            for k in range(a.shape[0]):
                z = float(zs[c0 + k])
                if (z - oz) * dz_sign > 0:
                    xw, yw = ox + (z - oz) * mx_t, oy + (z - oz) * my_t
                    live = ((acc <= thr) & ((yw >= ylo) & (yw <= yhi))[:, None]
                            & ((xw >= xlo) & (xw <= xhi))[None, :])
                    if ess is not None:
                        live &= ess[(c0 + k) // chunk][ti][:, tj] != 0
                    count += live.sum()
                    read = (taps(yw, ylo, yhi, ny, axis_scale[1]).T
                            @ live.float()
                            @ taps(xw, xlo, xhi, nx, axis_scale[0]))
                    texels += (read > 0).sum()
                acc = torch.where(acc > thr, acc, acc + a[k] * (1.0 - acc))
    return int(count), int(texels)
