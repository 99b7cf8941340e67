"""The ray marcher (counterpart of ``vrdd_tpu/march/scan.py``).

d_render's per-thread marching loop (volumeRender_kernel.cu:381-707) with
ALL rays advancing in lock-step, one step per loop iteration, and early ray
termination as a per-ray *alive mask* — the JAX package's ``lax.scan``
formulation, here a Python loop of plain torch ops on the rays' device.

The step ordering mirrors the reference exactly (composite -> opacity test
-> advance -> tfar test), so outputs match the JAX marcher up to float
associativity. The loop stops early once no ray is alive (checked every
``_ALIVE_CHECK`` steps): a dead ray's state never changes, so the result is
the same as running all ``max_steps``.

Differentiable through plain autograd (LUT fetch, volume gathers, masked
compositing); ``remat_chunk`` checkpoints each chunk of steps with
``torch.utils.checkpoint`` (non-reentrant: the autograd graph is the same,
only its saved tensors are recomputed), so images and gradients are bitwise
those without it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from vrdd_tpu_torch.core.geometry import camera_rays, intersect_box
from vrdd_tpu_torch.core.transfer import apply_transfer_function
from vrdd_tpu_torch.utils.config import MarchConfig

SampleFn = Callable[[torch.Tensor], torch.Tensor]  # (N, 3) p01 -> (N,)

#: steps between the host's "any ray alive?" reads (each synchronises)
_ALIVE_CHECK = 32


def march_rays(
    sample_fn: SampleFn,
    origin: torch.Tensor,
    dirs: torch.Tensor,
    tf_lut: torch.Tensor,
    density,
    brightness,
    transfer_offset,
    transfer_scale,
    march: MarchConfig = MarchConfig(),
    remat_chunk: int = 0,
) -> torch.Tensor:
    """March a flat batch of rays; returns float RGBA ``(N, 4)``.

    ``dirs`` is ``(N, 3)``; ``origin`` is ``(3,)`` (shared pinhole origin) or
    ``(N, 3)``.

    ``remat_chunk``: if > 0 and it divides ``max_steps``, the steps run in
    chunks of ``remat_chunk``, each under ``torch.utils.checkpoint``: the
    backward then holds the state at chunk boundaries instead of every
    step's temporaries, at the cost of recomputing each chunk once (the
    sqrt-remat trade of the JAX package's nested ``lax.scan``).
    """
    dirs = torch.as_tensor(dirs, dtype=torch.float32)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dirs.device)
    if origin.ndim == 1:
        origin = origin.expand(dirs.shape)
    tf_lut = torch.as_tensor(tf_lut, dtype=torch.float32, device=dirs.device)

    tnear, tfar, hit = intersect_box(origin, dirs, march.box_min, march.box_max)
    tnear = torch.clamp(tnear, min=0.0)

    pos = origin + dirs * tnear[:, None]
    step = dirs * march.tstep
    summ = torch.zeros(dirs.shape[:1] + (4,), dtype=torch.float32,
                       device=dirs.device)

    def body(summ, t, pos, alive):
        p01 = pos * 0.5 + 0.5
        sample = torch.where(alive, sample_fn(p01), 0.0)
        col = apply_transfer_function(tf_lut, sample, transfer_offset,
                                      transfer_scale)
        a = col[:, 3] * density
        col = torch.cat([col[:, :3] * a[:, None], a[:, None]], dim=-1)
        new_sum = summ + col * (1.0 - summ[:, 3:4])
        summ = torch.where(alive[:, None], new_sum, summ)
        alive = alive & ~(summ[:, 3] > march.opacity_threshold)
        t = torch.where(alive, t + march.tstep, t)
        alive = alive & ~(t > tfar)
        pos = torch.where(alive[:, None], pos + step, pos)
        return summ, t, pos, alive

    state = (summ, tnear, pos, hit)
    if remat_chunk and march.max_steps % remat_chunk == 0:

        def chunk(*state):
            for _ in range(remat_chunk):
                state = body(*state)
            return state

        for _ in range(march.max_steps // remat_chunk):
            if not bool(state[3].any()):
                break
            state = torch.utils.checkpoint.checkpoint(
                chunk, *state, use_reentrant=False)
    else:
        for i in range(march.max_steps):
            if i % _ALIVE_CHECK == 0 and not bool(state[3].any()):
                break
            state = body(*state)
    summ = state[0]
    return torch.where(hit[:, None], summ * brightness, summ)


def render_image(
    sample_fn: SampleFn,
    inv_view,
    width: int,
    height: int,
    tf_lut,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    march: MarchConfig = MarchConfig(),
    focal: float = 2.0,
    remat_chunk: int = 0,
    device=None,
) -> torch.Tensor:
    """Render a full ``(H, W, 4)`` float RGBA image on ``device`` (default:
    the inverse view's)."""
    origin, dirs = camera_rays(inv_view, width, height, focal, device=device)
    rgba = march_rays(
        sample_fn, origin, dirs.reshape(-1, 3), tf_lut,
        float(density), float(brightness), float(transfer_offset),
        float(transfer_scale), march, remat_chunk,
    )
    return rgba.reshape(height, width, 4)
