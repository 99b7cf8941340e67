"""Streamed distribution decode fused into the plane sweep (counterpart of
``vrdd_tpu/march/streaming.py``).

The plane schedule is cut into chunks of planes; each chunk decodes only
the volume z-layers its planes touch, pre-blends them and runs a SEEDED
sweep that resumes the front-to-back "over" recursion from the previous
chunk's accumulator, so the decoded scalar volume never exists whole. On one
device the chained seed is the true prefix: early termination is exact in a
single pass (seeded pixels past the opacity threshold freeze at once).

Differentiation: with ``remat`` each chunk body (decode -> pre-blend ->
seeded sweep) runs under ``torch.utils.checkpoint`` (non-reentrant), so the
backward recomputes the decoded layers chunk by chunk instead of keeping
them; the fused sweep's K4 therefore runs twice per chunk (forward and
recompute). The seeded sweeps' cotangents carry ``d seed_a = g_a - P_total
/ T_0``, so the chain rule walks the chunk chain exactly, and the decode's
autograd routes plane cotangents back to the distribution parameters.

Backends: 'pallas' (``kernels.slice_vjp.sweep_preblended_planes_diff``:
K3, or K4/K5 under autograd, on the card; their plain versions for CPU
data), 'xla' (``march.slice.sweep_preblended_planes_xla``), 'auto'
('pallas' for CUDA data, else 'xla').
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.utils.checkpoint

from vrdd_tpu_torch.kernels.slice_kernel import _pixel_slopes
from vrdd_tpu_torch.march.slice import sweep_preblended_planes_xla
from vrdd_tpu_torch.utils.config import MarchConfig


def _leaves(dist):
    """The tensors of ``dist``: one tensor, or a tuple / list / dict of them."""
    if isinstance(dist, torch.Tensor):
        return [dist]
    if isinstance(dist, dict):
        return [dist[k] for k in sorted(dist)]
    return list(dist)


def _with_leaves(dist, leaves):
    """``dist``'s structure with ``leaves`` in place of its tensors."""
    if isinstance(dist, torch.Tensor):
        return leaves[0]
    if isinstance(dist, dict):
        return dict(zip(sorted(dist), leaves))
    return type(dist)(leaves)


def streaming_decode_render(
    dist,
    decode_layers: Callable,
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
    n_planes: int = 0,
    chunk_planes: int = 64,
    backend: str = "auto",
    plane_chunk: int = 4,
    wrt: tuple = ("volume", "lut"),
    focal: float = 2.0,
    tex_offset: float = 0.5,
    remat: bool = True,
) -> torch.Tensor:
    """Render ``(H, W, 4)`` RGBA, decoding ``dist`` layer by layer in-stream.

    ``dist``: a tensor, or a tuple / list / dict of tensors, each with leading
    ``(Z, Y, X)`` axes (a ``(Z, Y, X, B)`` histogram volume, a ``(mu,
    sigma)`` pair). ``decode_layers`` maps a z-layer slice of ``dist`` (same
    structure, leaves ``(L, Y, X, ...)``) to scalar layers ``(L, Y, X)``; it
    is called once per chunk on the layers that chunk's planes touch.
    ``origin``: the camera of ``slice_render_image`` (unrotated, looking down
    -z). ``chunk_planes``: planes per chunk (the largest divisor of
    ``n_planes`` not above it). ``remat``: run each chunk under
    ``torch.utils.checkpoint``. Gradients reach ``dist`` (through
    ``decode_layers``), the LUT and the render parameters, as if the full
    volume had been decoded first.
    """
    leaves = _leaves(dist)
    nz = leaves[0].shape[0]
    dev = leaves[0].device
    if n_planes <= 0:
        n_planes = 2 * nz
    chunk_planes = min(chunk_planes, n_planes)
    while n_planes % chunk_planes:
        chunk_planes -= 1
    n_chunks = n_planes // chunk_planes

    (_, _, zlo), (_, _, zhi) = march.box_min, march.box_max
    spacing = (zhi - zlo) / n_planes
    zs = (
        zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)
    ).astype(np.float32)[::-1].copy()  # front-to-back for the -z camera

    # z-taps per plane: both clamp from the unclipped floor (the pre-blend
    # model of march/slice.py)
    zf = (zs - zlo) / (zhi - zlo) * nz - tex_offset
    az = (zf - np.floor(zf)).astype(np.float32)
    iz1 = np.clip(np.floor(zf).astype(np.int64) + 1, 0, nz - 1)
    iz0 = np.clip(np.floor(zf).astype(np.int64), 0, nz - 1)

    mx, my = _pixel_slopes(width, height, focal)

    if backend == "auto":
        # JAX also asks for width % 128 and height % STRIP (the TPU kernel's
        # tiling, which the CUDA kernels do not have) and for a supported
        # LUT; here the kernels raise on a configuration they cannot take
        backend = "pallas" if dev.type == "cuda" else "xla"
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}; use xla / pallas / "
                         "auto")

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    lut, density, toff, tscl = (f32(x) for x in (
        tf_lut, density, transfer_offset, transfer_scale))
    if backend == "pallas":
        from vrdd_tpu_torch.kernels.slice_vjp import (
            sweep_preblended_planes_diff,
        )

        slopes = (float(mx[0]), float(mx[1] - mx[0]) if width > 1 else 0.0,
                  float(my[0]), float(my[1] - my[0]) if height > 1 else 0.0)

    acc = torch.zeros((height, width, 4), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk_planes, (c + 1) * chunk_planes)
        lo = int(min(iz0[sl].min(), iz1[sl].min()))
        hi = int(max(iz0[sl].max(), iz1[sl].max()))
        li0 = torch.as_tensor(iz0[sl] - lo, device=dev)
        li1 = torch.as_tensor(iz1[sl] - lo, device=dev)
        azj = torch.as_tensor(az[sl], device=dev)[:, None, None]
        zs_chunk = zs[sl]
        layers_in = [t[lo:hi + 1] for t in leaves]

        def chunk_body(acc, lut, density, toff, tscl, *layers, li0=li0,
                       li1=li1, azj=azj, zs_chunk=zs_chunk):
            scal = decode_layers(_with_leaves(dist, list(layers)))
            planes = scal[li0] * (1.0 - azj) + scal[li1] * azj
            if backend == "pallas":
                return sweep_preblended_planes_diff(
                    planes.contiguous(), zs_chunk, origin, slopes, lut,
                    density, 1.0, toff, tscl, dz_sign=-1, width=width,
                    height=height, march=march, plane_chunk=plane_chunk,
                    plane_spacing=spacing, wrt=wrt, acc_init=acc,
                )
            return sweep_preblended_planes_xla(
                planes, zs_chunk, origin, mx, my, lut, density, 1.0, toff,
                tscl, march, dz_sign=-1, plane_spacing=spacing,
                plane_chunk=min(8, chunk_planes), tex_offset=tex_offset,
                acc_init=acc,
            )

        args = (acc, lut, density, toff, tscl, *layers_in)
        if remat:
            acc = torch.utils.checkpoint.checkpoint(chunk_body, *args,
                                                    use_reentrant=False)
        else:
            acc = chunk_body(*args)
    return acc * brightness
