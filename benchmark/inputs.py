"""Seeded inputs, made on the device in a few large calls.

Every generator takes the run's ``--seed``: the same seed gives the same
arrays. A seed moves the shapes a little (centres, widths, noise) and
never their sizes, so every seed asks the renderer for about the same
work.
"""

from __future__ import annotations

import numpy as np
import torch


def _gauss(t: torch.Tensor, c: float, w: float) -> torch.Tensor:
    return torch.exp(-((t - c) ** 2) / w)


def blob_histograms(n: int, bins: int, *, seed: int, device, dtype,
                    blob: dict) -> torch.Tensor:
    """A bins-major ``(n, bins, n, n)`` volume of per-voxel softmax
    histograms around a separable-blob mean: bin ``b``'s logit is ``-(c_b -
    base)^2 / sharpness`` plus seeded Gaussian noise of ``blob['noise']``,
    with ``c_b`` the bin centres on [0, 1] and ``base`` the product of one
    Gaussian per axis whose centre and width the seed jitters about
    ``blob['centres']`` and ``blob['widths']`` (z, y, x). Made a few
    z-layers at a time: no float32 copy of the volume exists."""
    rng = np.random.default_rng(seed)
    jitter = blob["jitter"]
    cs = [c + rng.uniform(-jitter, jitter) for c in blob["centres"]]
    ws = [w * rng.uniform(1.0 - jitter, 1.0 + jitter) for w in blob["widths"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    gz, gy, gx = (_gauss(t, c, w) for c, w in zip(cs, ws))
    centres = (torch.arange(bins, device=device, dtype=torch.float32) + 0.5) / bins
    out = torch.empty((n, bins, n, n), dtype=dtype, device=device)
    step = max(1, (1 << 26) // (bins * n * n))
    for z0 in range(0, n, step):
        base = gz[z0:z0 + step, None, None] * gy[None, :, None] * gx[None, None, :]
        logits = -((centres[None, :, None, None] - base[:, None]) ** 2) / blob["sharpness"]
        logits += blob["noise"] * torch.randn(logits.shape, generator=gen,
                                              device=device)
        out[z0:z0 + step] = torch.softmax(logits, dim=1).to(dtype)
    return out


def smooth_field(shape, *, seed: int, device, blobs: list, jitter: float):
    """A smooth scalar ``(Z, Y, X)`` field in [0, 1]: a sum of separable
    Gaussian blobs ``[cz, cy, cx, width, amplitude]`` whose centres the
    seed moves by up to ``jitter`` and whose widths and amplitudes it
    scales by up to ``1 +- jitter``, over its maximum. Float32."""
    rng = np.random.default_rng(seed)
    axes = [torch.linspace(0, 1, n, dtype=torch.float32, device=device)
            for n in shape]
    vol = torch.zeros(shape, dtype=torch.float32, device=device)
    for cz, cy, cx, width, amp in blobs:
        c = [v + rng.uniform(-jitter, jitter) for v in (cz, cy, cx)]
        w = 2.0 * (width * rng.uniform(1 - jitter, 1 + jitter)) ** 2
        a = amp * rng.uniform(1 - jitter, 1 + jitter)
        gz, gy, gx = (_gauss(t, ci, w) for t, ci in zip(axes, c))
        vol += a * gz[:, None, None] * gy[None, :, None] * gx[None, None, :]
    return vol / vol.max()


def block_histograms(vol: torch.Tensor, block, n_bins: int,
                     vmax: float = 1.0) -> torch.Tensor:
    """The data reduction the reference assumes done offline: each block of
    the scalar volume -> its normalized histogram of ``n_bins`` bins over
    ``[0, vmax]``, ``(Zb, Yb, Xb, n_bins)`` float32 (float32 binning, exact
    counts, count over voxels a block)."""
    bz, by, bx = block
    nz, ny, nx = vol.shape
    if nz % bz or ny % by or nx % bx:
        raise ValueError(f"blocks {block} do not tile {tuple(vol.shape)}")
    zb, yb, xb = nz // bz, ny // by, nx // bx
    blocks = vol.reshape(zb, bz, yb, by, xb, bx).permute(0, 2, 4, 1, 3, 5)
    blocks = blocks.reshape(zb, yb, xb, -1)
    idx = torch.clamp((blocks / vmax * n_bins).to(torch.int64), 0, n_bins - 1)
    hist = torch.zeros((zb, yb, xb, n_bins), dtype=torch.float32,
                       device=vol.device)
    hist.scatter_add_(-1, idx, torch.ones_like(blocks))
    return hist / blocks.shape[-1]


def unit_decode_rows(stat: str, n_bins: int) -> np.ndarray:
    """Decode rows of a statistic of histograms over [0, 1] (bin centres
    ``(b + 0.5) / B``, no normalization): 'mean' the centres; 'var' the
    rows ``[c, c, c^2, 1]`` of ``sum h (c - m)^2``; 'entropy' one row whose
    first entry is ``1 / log2 B``."""
    c = (np.arange(n_bins, dtype=np.float64) + 0.5) / n_bins
    if stat == "mean":
        return c.astype(np.float32)[None, :]
    if stat == "var":
        return np.stack([c, c, c * c, np.ones_like(c)]).astype(np.float32)
    if stat == "entropy":
        rows = np.zeros((1, n_bins), dtype=np.float32)
        rows[0, 0] = 1.0 / np.log2(n_bins)
        return rows
    raise ValueError(f"unknown statistic {stat!r}")


def rainbow_lut() -> np.ndarray:
    """The reference's 9-entry RGBA ramp (volumeRender_kernel.cu:2323-2326)."""
    return np.array([
        [0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 1.0], [1.0, 0.5, 0.0, 1.0],
        [1.0, 1.0, 0.0, 1.0], [0.0, 1.0, 0.0, 1.0], [0.0, 1.0, 1.0, 1.0],
        [0.0, 0.0, 1.0, 1.0], [1.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0],
    ], dtype=np.float32)


def inv_view(pitch_deg: float, yaw_deg: float, distance: float) -> np.ndarray:
    """The 3 x 4 camera-to-world matrix of a camera ``distance`` from the
    centre, turned by ``pitch`` about x and ``yaw`` about y, as the
    reference's viewer builds it (modelview ``Rx(-pitch) Ry(-yaw)
    T(0, 0, -distance)``, its top rows)."""
    rx, ry = np.deg2rad(-pitch_deg), np.deg2rad(-yaw_deg)
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    m = np.eye(4)
    m[:3, :3] = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
                 @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]))
    t = np.eye(4)
    t[2, 3] = distance
    return (m @ t)[:3].astype(np.float32)
