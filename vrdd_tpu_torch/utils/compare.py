"""Distances between a kernel's output and its plain version on the card,
shared by ``chip_smoke.py`` and the diagnostics under ``tools/``."""

from __future__ import annotations

import torch


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 error of ``got`` against ``ref``, summed a few z-layers at
    a time in float64 (the full-size histogram cotangents are 2^31 values).
    Raises ValueError on a shape mismatch, a non-finite ``got`` or an
    all-zero ``ref``."""
    if got.shape != ref.shape:
        raise ValueError(f"shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if got.dim() <= 1:
        got, ref = got.reshape(1, -1), ref.reshape(1, -1)
    num = den = 0.0
    step = max(1, (1 << 26) // max(1, got[0].numel()))
    for z0 in range(0, got.shape[0], step):
        a = got[z0:z0 + step].double()
        b = ref[z0:z0 + step].double()
        if not torch.isfinite(a).all():
            raise ValueError("non-finite gradient")
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    if den == 0.0:
        raise ValueError("the reference is all zeros")
    return (num / den) ** 0.5


def storage_ulp(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` (bfloat16 or float32) at the
    magnitude of each element of the float32 tensor ``t``: the most one
    rounding to that dtype can move a value."""
    bits = 7 if dtype == torch.bfloat16 else 23
    mag = t.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - bits)


def where_off(d, ref, what, tau=2.0 ** -8):
    """Print where ``d`` misses ``ref`` by more than ``tau`` of the entry:
    the count, the share of the squared L2 gap they carry, their layers and
    y edges, and the five largest misses."""
    diff = d - ref
    off = (diff.abs() > tau * ref.abs()) & (ref != 0)
    idx = off.nonzero()
    gap2 = float((diff.double() ** 2).sum())
    off2 = float((diff[off].double() ** 2).sum())
    mag = ref.abs()
    print(f"  {what}: {idx.shape[0]} entries off by > {tau:g} carry "
          f"{off2 / max(gap2, 1e-300):.2%} of the squared gap; their median "
          f"|entry| {float(mag[off].median()) if idx.shape[0] else 0.0:.3e}"
          f" against {float(mag[ref != 0].median()):.3e} over all nonzero "
          f"entries (rms {float(ref.double().pow(2).mean().sqrt()):.3e})")
    if idx.shape[0] == 0:
        return
    z, y, x = idx.unbind(1)
    ny, nx = d.shape[1:]
    print(f"    layers {int(z.min())}-{int(z.max())} "
          f"({int(torch.unique(z).numel())} distinct), y edge "
          f"{float(((y == 0) | (y == ny - 1)).float().mean()):.2%}, x edge "
          f"{float(((x == 0) | (x == nx - 1)).float().mean()):.2%}")
    flat = diff.abs().reshape(-1)
    for i in torch.topk(flat, 5).indices.tolist():
        zz, rem = divmod(i, ny * nx)
        yy, xx = divmod(rem, nx)
        print(f"    ({zz}, {yy}, {xx}): {float(d[zz, yy, xx]):.6e} vs "
              f"{float(ref[zz, yy, xx]):.6e}")
