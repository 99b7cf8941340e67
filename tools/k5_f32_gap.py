#!/usr/bin/env python3
"""Locate the f32 gap between K5 and its plain version on the main path, on
one NVIDIA GPU.

    python3 tools/k5_f32_gap.py

The fixture is the headline's (``blob_histogram_volume(512, 16, bf16)`` ->
1024^2, in-kernel mean, density 0.05, precision 'f32'). K4 runs with a
checkpoint at every plane (``ck_stride=1``: the kernel's transmittance T
before each sample, each ray) beside the plain recursion's, and K5 runs on
both fetch paths from the usual stride-4 checkpoints against
``sweep_bwd_reference`` on the same cotangent. The script prints:

- where the plane cotangent misses the plain one by more than 2^-8 of the
  entry (``utils.compare.where_off``), for the staged and the direct K5, and
  how far the two paths are apart on those entries;
- each ray's freeze step (the number of planes with ``T >= thr1``, ``thr1 =
  f32(1 - threshold)``) under three recursions: K4's per-plane T (JAX's
  kernel: ``T <- T - [T >= thr1] T a``), the plain checkpoints' (the same
  formula in torch) and the plain backward's (JAX's reference VJP,
  ``march/slice.py``: ``T <- T (1 - a)``); for each ray where K4 and the
  plain backward split: the plane, K4's and the plain backward's T there
  against ``thr1``, how far apart their T were before that plane, and the
  live-map bits of its tile (K4's, the plain version's and the plain
  version's "tied" map);
- the gap again with the image cotangent of those rays set to 0.

A gap carried by those rays, at planes where the two T lie within rounding
of ``thr1``, is a tie of the freeze test between the two formulas; anything
else is a fault. Prints one JSON line of
the counts last; exits non-zero without a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k5_f32_gap: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import _chunk_rgba_fn
    from vrdd_tpu_torch.utils.compare import rel_l2, where_off

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n, B, W = 512, 16, 1024
    tf = default_transfer_function()
    origin = torch.tensor([0.0, 0.0, 4.0])
    hist = blob_histogram_volume(n, B, device=dev, dtype=torch.bfloat16)
    rows, mode = sk.decode_weight_rows("mean", B, family="unit")
    cfg = sv.render_config(hist.shape, origin, stat=mode, width=W, height=W)
    args = (cfg, hist, torch.as_tensor(rows, device=dev),
            torch.as_tensor(tf, device=dev), torch.tensor(0.05, device=dev),
            torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev))
    thr1 = float(torch.tensor(1.0 - cfg.march.opacity_threshold,
                              dtype=torch.float32))
    print(f"{torch.cuda.get_device_name(0)}: {n}^3 x {B} bf16 -> {W}^2, "
          f"mean, f32, ck_stride {cfg.ck_stride}, thr1 {thr1!r}")

    # ---- the backward on both fetch paths against the plain version
    img, tck, live = sv.sweep_fwd_ckpt(*args, live_map=True)
    g = (2.0 / img.numel()) * (img - 0.25)
    flags = (True, True, False)
    d = {s: sv.sweep_bwd(*args, g, tck, *flags, staged=s)[0]
         for s in (True, False)}
    d_ref = sv.sweep_bwd_reference(*args, g, *flags)[0]
    gap = {s: rel_l2(d[s], d_ref) for s in d}
    print(f"  K5 vs plain d_dec: rel L2 staged {gap[True]:.3e}, direct "
          f"{gap[False]:.3e}")
    tau = 2.0 ** -8
    off = ((d[True] - d_ref).abs() > tau * d_ref.abs()) & (d_ref != 0)
    where_off(d[True], d_ref, "staged K5 vs plain")
    where_off(d[False], d_ref, "direct K5 vs plain")
    off_d = ((d[False] - d_ref).abs() > tau * d_ref.abs()) & (d_ref != 0)
    apart = ((d[True] - d[False]).abs()[off]
             / d_ref.abs()[off]).max() if off.any() else torch.tensor(0.0)
    print(f"  off entries: staged {int(off.sum())}, direct "
          f"{int(off_d.sum())}, both {int((off & off_d).sum())}; on the "
          f"staged ones the paths are at most {float(apart):.3e} of the "
          "entry apart")

    # ---- each ray's freeze step in K4 and in the plain recursion
    cfg1 = dataclasses.replace(cfg, ck_stride=1)
    args1 = (cfg1,) + args[1:]
    _, t_k = sv.sweep_fwd_ckpt(*args1)            # (P, H, W): T before k
    if not torch.equal(t_k[::cfg.ck_stride], tck):
        print("  FAIL: K4's per-plane T is not its stride checkpoints")
        return 1
    _, t_p = sv.sweep_fwd_ckpt_reference(*args1)
    _, _, live_p, tied_p = sv.sweep_fwd_ckpt_reference(*args, live_map=True)
    # the plain backward's recursion on the same per-plane alpha
    planes = cfg.stack(cfg.planes(hist, args[2])).to(torch.float32)
    P, ny, nx = planes.shape
    mx, my = cfg.slope_grids()
    chunk_rgba = _chunk_rgba_fn(
        P, ny, nx, cfg.zs, cfg.origin, mx, my, cfg.march, cfg.dz_sign,
        cfg.plane_spacing, cfg.length_correction, cfg.tex_offset,
        cfg.axis_scale, cfg.filter_linear, dev, None, cfg.precision)
    t_v = torch.empty_like(t_p)
    T = torch.ones((W, W), device=dev)
    with torch.no_grad():
        for c0 in range(0, P, cfg.ck_stride):
            a = chunk_rgba(c0, planes[c0:c0 + cfg.ck_stride], *args[3:])
            for k in range(a.shape[0]):
                t_v[c0 + k] = T
                T = torch.where(T >= thr1, T * (1.0 - a[k][..., 3]), T)
    del planes
    step_k = (t_k >= thr1).sum(0)                 # samples each ray takes
    step_p = (t_p >= thr1).sum(0)
    step_v = (t_v >= thr1).sum(0)
    flip = step_k != step_v
    print(f"  rays whose freeze step differs: K4 vs plain checkpoints "
          f"{int((step_k != step_p).sum())}, plain checkpoints vs plain "
          f"backward {int((step_p != step_v).sum())}, K4 vs plain backward "
          f"{int(flip.sum())} of {W * W} (K4 later on "
          f"{int((step_k > step_v).sum())})")
    rel_t = ((t_k - t_v).abs() / t_v.abs().clamp_min(1e-30))
    print(f"  K4 and the plain backward's T, rays that do not split: at most "
          f"{float(rel_t[:, ~flip].max()):.3e} apart (relative, every "
          "plane)")
    th, tw = sk.ESS_TILE
    rows_out = []
    for i, j in flip.nonzero().tolist():
        k = int(min(step_k[i, j], step_v[i, j]))  # the first step they split
        c = k // cfg.ck_stride
        tile = (c, i // th, j // tw)
        before = float(rel_t[:k, i, j].max()) if k else 0.0
        rows_out.append({
            "ray": (i, j), "plane": k, "layer": P - 1 - k,
            "steps": (int(step_k[i, j]), int(step_v[i, j])),
            "t_k": float(t_k[k, i, j]) / thr1 - 1.0,
            "t_v": float(t_v[k, i, j]) / thr1 - 1.0,
            "rel_t_before": before,
            "live": (int(live[tile]), int(live_p[tile]), int(tied_p[tile])),
        })
    for r in rows_out[:40]:
        print(f"    ray {r['ray']}: plane {r['plane']} (layer {r['layer']}), "
              f"steps K4/plain backward {r['steps']}, T/thr1 - 1 there: K4 "
              f"{r['t_k']:+.3e}, plain backward {r['t_v']:+.3e}; T apart "
              f"before it {r['rel_t_before']:.3e}; live tile K4/plain/tied "
              f"{r['live']}")
    straddle = [r for r in rows_out if (r["t_k"] >= 0) != (r["t_v"] >= 0)]
    worst = max((max(abs(r["t_k"]), abs(r["t_v"])) for r in rows_out),
                default=0.0)
    print(f"  {len(straddle)} of {len(rows_out)} split rays straddle thr1 "
          f"at the step they split; the farthest T from thr1 there "
          f"{worst:.3e} (relative)")
    del t_k, t_p, t_v, rel_t

    # ---- the gap without those rays' cotangent
    g_m = torch.where(flip[..., None], 0.0, g)
    d_m = {s: sv.sweep_bwd(*args, g_m, tck, *flags, staged=s)[0]
           for s in (True, False)}
    d_m_ref = sv.sweep_bwd_reference(*args, g_m, *flags)[0]
    gap_m = {s: rel_l2(d_m[s], d_m_ref) for s in d_m}
    print(f"  K5 vs plain, flipped rays' cotangent 0: rel L2 staged "
          f"{gap_m[True]:.3e}, direct {gap_m[False]:.3e}")
    where_off(d_m[True], d_m_ref, "staged K5 vs plain, flipped rays' "
              "cotangent 0")
    off_m = ((d_m[True] - d_m_ref).abs() > tau * d_m_ref.abs()) & (
        d_m_ref != 0)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "gap_staged": gap[True], "gap_direct": gap[False],
        "off_staged": int(off.sum()), "off_direct": int(off_d.sum()),
        "off_both": int((off & off_d).sum()),
        "paths_apart_on_off": float(apart),
        "flipped_rays": len(rows_out), "straddle": len(straddle),
        "farthest_from_thr1": worst,
        "gap_masked_staged": gap_m[True], "gap_masked_direct": gap_m[False],
        "off_masked": int(off_m.sum()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
