#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vrdd_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compiles the CUDA kernels from ``vrdd_tpu_torch/csrc``;
3. each kernel against its plain torch version at small shapes, on the card:
   tolerance 1e-4 abs on all but <= 0.1% of pixels (those may flip at the
   0.95 opacity cutoff), launch counters advance, two runs bitwise equal;
3b. the training kernels K3/K4/K5 against their plain versions at small
   unaligned shapes: K4's image bitwise K3's, gradients within 1e-3
   relative L2 (atomics, cutoff flips), launch counters advance;
4. the ``render-hist`` CLI on a seeded 128^3 x 16 histogram file -> 512^2,
   for mean, var and entropy, checked against the plain version;
4b. the ``fit-hist`` CLI on the card at its default sizes, 5 steps: the
   loss must be finite and fall;
5. the forward main path at full size: a 512^3 x 16 bf16 histogram volume
   (the headline fixture) rendered to 1024^2 through ``HistRenderer`` for
   each statistic, and its decoded mean volume through
   ``pallas_slice_render``, with the launch counters reset before and read
   after; then each kernel against its plain version, timed (median of 10
   warm runs, CUDA events);
6. the training main path at full size: the headline loss
   mean((img - 0.25)^2) of ``pallas_hist_render_diff`` on the same volume
   with gradients to the histograms and the LUT, for mean (materialized,
   inkernel), var (inkernel, materialized) and entropy (inkernel), after an
   evaluation render without gradients; launch counters (and staged
   launches: K3/K4/K5 must take the fetch path the wrappers choose, staged
   but for K5 on the materialized route's scalar planes) reset before and
   read after each; gradients against the plain analytic VJP (1e-3
   relative L2); fwd+bwd on both fetch paths, and each of K3/K4/K5 on
   both, timed in turns (direct, staged, staged, direct) and held against
   its plain version; staged against direct: images and checkpoints
   bitwise, K5's LUT cotangents bitwise (and over two staged runs), its
   ``d_planes`` and variance moments within 1e-6 relative L2;
7. the ``render`` path (``RenderPipeline``, queries 1/2/3/7):
   7a. the reference's benchmark geometry, the Isabel-shaped 50 x 50 x 10
       blocks x 32 bins, to 512^2 with the ``scan``, ``slice`` and
       ``pallas`` renderers (ESS on and off): ``pallas`` against ``slice``
       at the image tolerance, ESS on bitwise ESS off, frame ms and
       MTexels/s of each;
   7b. full size, a smooth 256^3-block x 32-bin float32 raw volume (2.1 GB,
       made on the card from a seed, with empty space around its blobs) to
       1024^2 through ``renderer='auto'``, which must resolve to the fused
       kernel K1 with ESS on: launch counters (K1, its ESS launches, the
       ESS bitmap kernel) reset before and read after; the stats decode,
       the ESS plane stats, the per-frame bitmap kernel (byte for byte its
       plain version) and pre-blend, the K1 wrapper with ESS (bitmap and
       K1) and without, and the whole frame timed; the culled share and
       peak memory printed; ESS bitwise no-ESS, ``pallas`` against the
       plain ``slice`` renderer. Then the differentiable sweep
       with ESS (``wrt=('volume',)``) on the same volume: K3/K4 with ESS
       bitwise without (image and every checkpoint row), ``d_volume`` within
       1e-6 relative L2 of the gradient without ESS;
   7c. ``python -m vrdd_tpu_torch.cli render --file none`` at its defaults
       (and with ``--renderer auto``), printing its MTexels/s line;
8. BASELINE config 3 (per-voxel Gaussian mu/sigma, 256^3 -> 512^2) and
   rotated views:
   8a. the seeded kernels at full size on fit-voxels' mean channel (made on
       the card, checked against numpy's at 32^3), 512 planes -> 512^2: the
       back half seeded with the front half's K3 image through K1 and K3
       equals the one-pass sweep at the image tolerance; frozen seeds
       (alpha 0.99 and 1) come back as themselves with checkpoint rows T0
       and ``S`` 0; seeded K4 + K5 (``d_planes``, ``S``, ``d_acc0``)
       within 1e-3 relative L2 of the plain versions; K1 seeded timed.
       Then the seeded K3/K4/K5 at the shapes the streamed fit-voxels gives
       them: chunk 4 of 8 (64 planes at the full stack's spacing, 512^2,
       streaming's slopes) seeded with the chain of chunks 0-3, each held
       against its plain version (image tolerance; ``d_planes``, ``S`` and
       ``d_acc0`` within 1e-3 relative L2) and timed;
   8b. ``fit-voxels --size 256 --image 512 --views 3 --view-angle 25`` for
       5 steps, unstreamed and ``--streamed`` (8 chunks of 64 planes), with
       the launch counters (and the seeded ones) reset before and read
       after each run: the loss must be finite and fall, the streamed first
       loss equal the unstreamed one within 1e-5 relative, and the seeded
       K3/K4/K5 run in the streamed run; then a rotated view's K4 and K5
       on its 1024^2 m-grid timed against their plain versions;
   8c. 7b's volume at 1024^2 through ``renderer='auto'`` at three rotations
       (principal axes z, x and y; d_z of both signs), which must resolve
       to shear-warp and launch K3 once a frame; each frame against the
       ``'xla'`` shear-warp at the image tolerance, frame ms and MTexels/s,
       K3 on the 2048^2 m-grid timed against its plain version.

Every sweep kernel runs by default on the fetch path its wrapper chooses
(staged where the footprint fits shared memory, K5 on scalar planes
direct); phases 5, 7 and 8 also time the other path and hold the two
bitwise (K5: ``d_planes`` within 1e-6 relative L2).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Each kernel's record holds its launches
and its launches on the staged path (``staged_launches``; null for the ESS
bitmap, which has one path) in the main-path run (a seeded kernel's: its
seeded launches in the
streamed fit-voxels run; K1's seeded launches are those of 8a, its split
stack, as no fit-voxels path resumes K1; the rotated views' K4/K5: their
launches on the m-grid in the unstreamed run), its error against the plain
version, its ms on the staged path and ``direct_ms`` on the direct path
(each the mean of two medians of warm runs, CUDA events, timed in turns),
the plain version's ms, and ``bound_ms``: the
larger of the bytes the call must move over the H100's 3.35 TB/s and its
FP32 operations over its 67 TFLOP/s, with ``bound_by`` naming the larger.
Both count what this run's data needs: the samples evaluated (in front of
the camera and in the box, before the ray's cutoff, not ESS-culled;
counted with the plain version), the volume texels those samples read,
each once, and every output written once. No single PyTorch call computes
a sweep or the bitmap, so ``library_ms`` is null. Without a GPU it
exits with an error and prints no result. Needs nothing but the
repository, torch, numpy, nvcc.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4           # abs, per channel
FLIP_BUDGET = 1e-3   # share of pixels allowed past TOL (cutoff flips)
GRAD_TOL = 1e-3      # relative L2 of gradients (atomics, cutoff flips)
ORIGIN = (0.0, 0.0, 4.0)
TIMED_RUNS = 10
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM, FP32 outside the tensor cores
#: FP32 operations per evaluated sample of the forward sweep, counted from
#: csrc/sweep_common.cuh and slice_sweep.cu (an FMA counts as two): the
#: ray-plane taps 40, the bilinear resample 9, the LUT tent and lookup 24,
#: the opacity 3, the "over" step 12
SAMPLE_OPS = 88
#: the reverse sweep (K5) replays the forward's samples and transposes
#: them: counted as three forward samples
K5_SAMPLE_FACTOR = 3


def decode_ops(mode, B):
    """FP32 operations of the in-kernel decode of one sample's four tap
    voxels (log2 counted as one operation)."""
    per_voxel = {"none": 0, "linear": 2 * B, "var": 8 * B + 6,
                 "entropy": 4 * B + 1}[mode]
    return 4 * per_voxel


def ess_pair_ops(plane_chunk, n_lut):
    """Operations of the ESS bitmap kernel for one (tile, chunk), counted
    from csrc/ess_bitmap.cu (a float64 operation counts as one): the depth
    range and the corner and block geometry 60, the block min and max over
    the chunk's planes at 2 x 2 blocks, the LUT interval 20 and its knots."""
    return 60 + 2 * 4 * plane_chunk + 20 + 2 * n_lut


def fail(msg: str):
    sys.exit(f"chip_smoke FAIL: {msg}")


def blob_hist(nz, B, ny, nx, seed):
    """Bins-major softmax histograms around a smooth blob mean (numpy)."""
    import numpy as np

    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume

    base = gaussian_blob_volume((nz, ny, nx), seed=seed)
    centers = ((np.arange(B) + 0.5) / B).astype(np.float32)
    logits = -((centers[None, :, None, None] - base[:, None]) ** 2) / 0.02
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def compare(got, ref, what):
    """Max abs error and the share of pixels past TOL; fails past budget."""
    import torch

    if got.shape != ref.shape:
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite output")
    d = (got - ref).abs()
    err = float(d.max())
    share = float((d.amax(dim=-1) > TOL).float().mean())
    print(f"  {what}: max_abs_err {err:.3e}, pixels > {TOL:g}: {share:.4%}")
    if share > FLIP_BUDGET:
        fail(f"{what}: {share:.4%} of pixels past {TOL:g} (budget "
             f"{FLIP_BUDGET:.1%})")
    return err


def rel_l2(got, ref, what, limit=GRAD_TOL):
    """Relative L2 error, summed a few z-layers at a time in float64 (the
    full-size histogram cotangents are 2^31 values); fails past ``limit``."""
    import torch

    if got.shape != ref.shape:
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if got.dim() <= 1:
        got, ref = got.reshape(1, -1), ref.reshape(1, -1)
    num = den = 0.0
    step = max(1, (1 << 26) // max(1, got[0].numel()))
    for z0 in range(0, got.shape[0], step):
        a = got[z0:z0 + step].double()
        b = ref[z0:z0 + step].double()
        if not torch.isfinite(a).all():
            fail(f"{what}: non-finite gradient")
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    err = (num / max(den, 1e-300)) ** 0.5
    print(f"  {what}: rel L2 {err:.3e}")
    if err > limit or den == 0.0:
        fail(f"{what}: rel L2 {err:.3e} (limit {limit:g}, ref norm^2 {den})")
    return err


def bitwise(a, b, what):
    """Fails unless the two tensors are bitwise equal."""
    import torch

    if not torch.equal(a, b):
        fail(f"{what}: not bitwise equal")


def on_path(staged, fn):
    """``fn`` with every sweep launch inside it forced onto the staged
    (True) or the direct (False) fetch path."""
    from vrdd_tpu_torch.kernels import slice_kernel as sk

    def run():
        with sk._fetch_path(staged):
            return fn()
    return run


def paths_ms(fn_for, runs=TIMED_RUNS):
    """``(staged_ms, direct_ms)``: ``fn_for(staged)`` timed on both fetch
    paths in turns (direct, staged, staged, direct), each the mean of its
    two medians of ``runs`` warm runs."""
    t = {True: [], False: []}
    for staged in (False, True, True, False):
        t[staged].append(time_ms(fn_for(staged), runs))
    return sum(t[True]) / 2, sum(t[False]) / 2


def time_ms(fn, runs):
    """Median milliseconds of ``runs`` warm runs, timed with CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def timed_once(fn):
    """(milliseconds, result) of one run, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


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
                 origin=ORIGIN, dz_sign=-1, seed_alpha=None):
    """``(samples, texels)``: the samples the sweep kernels evaluate on
    these inputs, and the distinct plane texels those samples read. A sample
    is evaluated where the plane is in front of the camera, the ray inside
    the box there and not yet past the opacity cutoff, and the (tile,
    chunk) not culled by the ESS bitmap ``ess``; it reads the two x by two y
    taps of its resample. Counted with the plain version's per-plane alpha,
    front to back (``reverse``: the stack is stored z-ascending), from the
    camera at ``origin`` whose rays have d_z of sign ``dz_sign``, the
    accumulated alpha starting at ``seed_alpha`` (H, W) for a seeded
    sweep."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.march.slice import _chunk_rgba_fn
    from vrdd_tpu_torch.utils.config import MarchConfig

    march = MarchConfig()
    dev = planes.device
    P, ny, nx = planes.shape
    mx, my = sk._slope_grids(slopes, W, H)
    rgba = _chunk_rgba_fn(P, ny, nx, zs, torch.tensor(origin), mx, my, march,
                          dz_sign, None, True, tex_offset, (1.0, 1.0), True,
                          dev)
    mx_t, my_t = torch.as_tensor(mx, device=dev), torch.as_tensor(my, device=dev)
    th, tw = sk.ESS_TILE
    ti = torch.arange(H, device=dev) // th
    tj = torch.arange(W, device=dev) // tw
    lut_t = torch.as_tensor(lut, dtype=torch.float32, device=dev)
    ox, oy, oz = origin
    (xlo, ylo, _), (xhi, yhi, _) = march.box_min, march.box_max
    thr = march.opacity_threshold

    def taps(w, lo, hi, n):
        """(rays, n) 0/1 matrix of the texels each ray's resample reads."""
        q = ((w - lo) / (hi - lo) * n - tex_offset).clamp(0.0, n - 1.0)
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
                    read = (taps(yw, ylo, yhi, ny).T @ live.float()
                            @ taps(xw, xlo, xhi, nx))
                    texels += (read > 0).sum()
                acc = torch.where(acc > thr, acc, acc + a[k] * (1.0 - acc))
    return int(count), int(texels)


def host_ms(fn, runs):
    """Median milliseconds of ``runs`` warm calls on the host clock, each
    ending in a synchronize (a whole frame, host work included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2]


def diff_counters():
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    return (sv.sweep_fwd, sv.sweep_fwd_ckpt, sv.sweep_bwd)


def phase_3b(dev, tf, origin):
    """K3/K4/K5 against their plain versions at small unaligned shapes."""
    import numpy as np
    import torch

    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    print("[3b] K3/K4/K5 vs plain, small shapes")
    counters = diff_counters()

    def check(what, fn, names, make):
        leaves = make(dev)
        before = [c.launches for c in counters]
        with torch.no_grad():
            k3 = fn(*[t.detach() for t in leaves])
        img = fn(*leaves)
        g = torch.randn(img.shape, generator=torch.Generator().manual_seed(0))
        grads = torch.autograd.grad(img, leaves, g.to(dev))
        torch.cuda.synchronize()
        if [c.launches - b for c, b in zip(counters, before)] != [1, 1, 1]:
            fail(f"{what}: K3/K4/K5 launch counters did not advance by one")
        if not torch.equal(img.detach(), k3):
            fail(f"{what}: K4's image is not bitwise K3's")
        leaves_ref = make("cpu")
        img_ref = fn(*leaves_ref)
        grads_ref = torch.autograd.grad(img_ref, leaves_ref, g)
        compare(img.detach().cpu(), img_ref.detach(), what)
        for name, a, b in zip(names, grads, grads_ref):
            rel_l2(a.cpu(), b, f"{what} d_{name}")

    vol = gaussian_blob_volume((16, 24, 24))
    for n_planes in (16, 32):
        for density in (0.05, 5.0):
            check(
                f"scalar (16, 24, 24)->100x72 planes {n_planes} density "
                f"{density}",
                lambda v, lut, d, n_planes=n_planes:
                    sv.pallas_slice_render_diff(
                        v, origin, lut, d, 1.3, 0.1, 1.5, width=100,
                        height=72, n_planes=n_planes),
                ("volume", "lut", "density"),
                lambda device, density=density: [
                    torch.tensor(x, device=device, requires_grad=True)
                    for x in (vol, tf, np.float32(density))],
            )
    h32 = blob_hist(16, 8, 24, 24, seed=2)
    for stat in ("mean", "var", "entropy"):
        rows, mode = sk.decode_weight_rows(stat, 8, family="unit")
        for dtype in (torch.float32, torch.bfloat16):
            for density in (0.05, 5.0):
                check(
                    f"hist (16, 8, 24, 24) {str(dtype)[6:]} {stat}->136x96 "
                    f"density {density}",
                    lambda h, lut, rows=rows, mode=mode, density=density:
                        sv.pallas_hist_render_diff(
                            h, rows, origin, lut, density, width=136,
                            height=96, stat=mode,
                            transfer_scale=10.0 if mode == "var" else 1.0),
                    ("hist", "lut"),
                    lambda device, dtype=dtype: [
                        torch.from_numpy(h32).to(device, dtype)
                        .requires_grad_(),
                        torch.tensor(tf, device=device, requires_grad=True)],
                )


def phase_4b(work):
    """The fit-hist CLI on the card at its default sizes, 5 steps."""
    import contextlib
    import io
    import math
    import re

    from vrdd_tpu_torch import cli

    print("[4b] fit-hist CLI on the card, defaults (32^3 x 16 -> 128^2), "
          "5 steps")
    counters = diff_counters()
    before = [c.launches for c in counters]
    ckpt = work / "fit_hist.npz"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit-hist", "--iters", "5", "--checkpoint", str(ckpt)])
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"  {line}")
    losses = [float(v) for v in re.findall(r"step \d+: loss (\S+)",
                                           buf.getvalue())]
    launched = [c.launches - b for c, b in zip(counters, before)]
    print(f"  {wall:.2f} s, K3/K4/K5 launches {launched}")
    if rc != 0 or not ckpt.exists() or len(losses) != 5:
        fail(f"fit-hist: rc {rc}, checkpoint {ckpt.exists()}, {losses}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"fit-hist: loss not finite and falling: {losses}")
    if launched[1] != 5 or launched[2] != 5:
        fail(f"fit-hist did not train through K4/K5: {launched}")


def phase_6(dev, card, smi, hist, tf, origin, n, B, W):
    """The training main path at full size; returns the kernel records."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import slice_render_image

    print(f"[6] training main path, {n}^3 x {B} bf16 -> {W}^2, loss "
          f"mean((img - 0.25)^2), wrt (hist, lut), on {card} ({smi})")
    counters = diff_counters()
    lut0 = torch.as_tensor(tf, device=dev)
    records, mrays = [], {}
    for stat, route in (("mean", "materialized"), ("mean", "inkernel"),
                        ("var", "inkernel"), ("var", "materialized"),
                        ("entropy", "inkernel")):
        rows, mode = sk.decode_weight_rows(stat, B, family="unit")
        tscl = 10.0 if stat == "var" else 1.0
        tag = f"{stat},{route}"
        h = hist.detach().requires_grad_()
        lut = lut0.clone().requires_grad_()

        def render(hh, ll, mode=mode, tscl=tscl, route=route, rows=rows):
            return sv.pallas_hist_render_diff(
                hh, rows, origin, ll, width=W, height=W, stat=mode,
                transfer_scale=tscl, wrt=("hist", "lut"), route=route)

        def fwd_bwd(render=render, h=h, lut=lut):
            img = render(h, lut)
            loss = torch.mean((img - 0.25) ** 2)
            return (loss, img) + torch.autograd.grad(loss, [h, lut])

        # the main-path run: an evaluation render (K3), then fwd+bwd (K4, K5)
        for c in counters:
            c.launches = c.staged_launches = 0
        with torch.no_grad():
            img3 = render(hist, lut0)
        loss, img, gh, gl = fwd_bwd()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        staged = {c.__name__: c.staged_launches for c in counters}
        print(f"  [{tag}] launches in the main-path run: {launches}, on the "
              f"staged path: {staged}, loss {float(loss.detach()):.6f}")
        if any(v == 0 for v in launches.values()):
            fail(f"{tag}: a kernel of the training path was not launched")
        # K5 on scalar planes (the materialized route) goes direct by choice
        want = dict(launches, sweep_bwd=0) if route == "materialized" else (
            launches)
        if staged != want:
            fail(f"{tag}: K3/K4/K5 did not take the fetch paths the wrappers "
                 f"choose: staged {staged} of {launches}")
        if not torch.equal(img.detach(), img3):
            fail(f"{tag}: K4's image is not bitwise K3's")

        def plain(rows=rows, mode=mode, tscl=tscl):
            hp = hist.detach().requires_grad_()
            lp = lut0.clone().requires_grad_()
            vol = sk.decode_with_rows(hp, rows, mode)
            imgp = slice_render_image(vol, origin, W, W, lp,
                                      transfer_scale=tscl, n_planes=n)
            lossp = torch.mean((imgp - 0.25) ** 2)
            return (lossp, imgp) + torch.autograd.grad(lossp, [hp, lp])

        plain_ms, (lossp, imgp, ghp, glp) = timed_once(plain)
        err = compare(img.detach(), imgp.detach(), f"[{tag}] image")
        rel_l2(gh, ghp, f"[{tag}] d_hist")
        rel_l2(gl, glp, f"[{tag}] d_lut")
        del lossp, imgp, ghp, glp, loss, img, gh, gl
        torch.cuda.reset_peak_memory_stats()
        ms, direct_ms = paths_ms(lambda s: on_path(s, fwd_bwd))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mrays[tag] = (W * W / ms / 1e3, W * W / direct_ms / 1e3)
        print(f"  [{tag}] fwd+bwd: kernels staged {ms:.3f} ms "
              f"({mrays[tag][0]:.2f} Mrays/s), direct {direct_ms:.3f} ms "
              f"({mrays[tag][1]:.2f} Mrays/s), plain {plain_ms:.3f} ms "
              f"({W * W / plain_ms / 1e3:.2f} Mrays/s), peak "
              f"{peak:.2f} GiB")

        # each kernel alone, against its plain version on the same inputs
        inkernel = route == "inkernel"
        vol = hist if inkernel else sk.decode_with_rows(hist, rows, mode)
        cfg = sv.render_config(vol.shape, origin, stat=mode if inkernel
                               else "none", width=W, height=W)
        decoded = vol if not inkernel else sk.decode_with_rows(hist, rows,
                                                               mode)
        n_live, n_texels = live_samples(decoded, cfg.zs, cfg.slopes, tf, 0.05,
                                        0.0, tscl, W, W, reverse=True)
        del decoded
        fwd_ops = n_live * (SAMPLE_OPS
                            + decode_ops(mode if inkernel else "none", B))
        # the volume bytes the live samples' taps read, each once
        vol_bytes = n_texels * (vol.numel() // (n * n * n)) * vol.element_size()
        img_bytes, tck_bytes = W * W * 16, cfg.n_chunks * W * W * 4
        d_bytes = n * n * n * 4 * (3 if (inkernel and mode == "var") else 1)
        bounds = {
            "sweep_fwd": bound(vol_bytes + img_bytes, fwd_ops),
            "sweep_fwd_ckpt": bound(vol_bytes + img_bytes + tck_bytes,
                                    fwd_ops),
            "sweep_bwd": bound(vol_bytes + tck_bytes + img_bytes + d_bytes,
                               K5_SAMPLE_FACTOR * fwd_ops),
        }
        print(f"  [{tag}] evaluated samples {n_live} "
              f"({n_live / (W * W * n):.4f} of rays x planes), texels read "
              f"{n_texels} ({n_texels / (n * n * n):.4f} of the volume)")
        rows_t = torch.as_tensor(rows, device=dev) if inkernel else None
        args = (cfg, vol, rows_t, lut0,
                torch.tensor(0.05, device=dev), torch.tensor(0.0, device=dev),
                torch.tensor(tscl, device=dev))
        paths = (True, False)
        # K3 on both fetch paths: each against the plain version, staged
        # bitwise direct
        k3_ms, k3_direct = paths_ms(
            lambda s: lambda: sv.sweep_fwd(*args, staged=s))
        k3_plain_ms, ref3 = timed_once(lambda: sv.sweep_fwd_reference(*args))
        k3 = {s: sv.sweep_fwd(*args, staged=s) for s in paths}
        k3_err = compare(k3[True], ref3, f"[{tag}] K3 image, staged")
        compare(k3[False], ref3, f"[{tag}] K3 image, direct")
        bitwise(k3[True], k3[False], f"[{tag}] K3 image staged vs direct")
        # K4
        k4_ms, k4_direct = paths_ms(
            lambda s: lambda: sv.sweep_fwd_ckpt(*args, staged=s))
        k4_plain_ms, (ref4, tck_ref) = timed_once(
            lambda: sv.sweep_fwd_ckpt_reference(*args))
        k4 = {s: sv.sweep_fwd_ckpt(*args, staged=s) for s in paths}
        k4_err = [compare(k4[s][0], ref4, f"[{tag}] K4 image, "
                          f"{'staged' if s else 'direct'}") for s in paths][0]
        for s in paths:
            compare(k4[s][1][..., None], tck_ref[..., None],
                    f"[{tag}] K4 checkpoints, {'staged' if s else 'direct'}")
        bitwise(k4[True][0], k4[False][0], f"[{tag}] K4 image staged vs direct")
        bitwise(k4[True][1], k4[False][1],
                f"[{tag}] K4 checkpoints staged vs direct")
        bitwise(k4[True][0], k3[True], f"[{tag}] K4 image vs K3 image")
        img4, tck = k4[True]
        del k3, k4, ref3, ref4, tck_ref
        g = (2.0 / img4.numel()) * (img4 - 0.25)  # d loss / d image
        flags = (True, True, False)
        # K5
        k5_ms, k5_direct = paths_ms(
            lambda s: lambda: sv.sweep_bwd(*args, g, tck, *flags, staged=s))
        k5_plain_ms, (d_r, small_r, *_) = timed_once(
            lambda: sv.sweep_bwd_reference(*args, g, *flags))
        k5 = {s: sv.sweep_bwd(*args, g, tck, *flags, staged=s) for s in paths}
        for s in paths:
            path = "staged" if s else "direct"
            rel_l2(k5[s][0], d_r, f"[{tag}] K5 d_planes, {path}")
            rel_l2(k5[s][1], small_r, f"[{tag}] K5 d_lut, {path}")
        k5_err = float((k5[True][0] - d_r).abs().max())
        bitwise(k5[True][1], k5[False][1], f"[{tag}] K5 d_lut staged vs direct")
        rel_l2(k5[True][0], k5[False][0],
               f"[{tag}] K5 d_planes staged vs direct", 1e-6)
        if k5[True][2] is not None:
            rel_l2(k5[True][2], k5[False][2],
                   f"[{tag}] K5 var moments staged vs direct", 1e-6)
        again = sv.sweep_bwd(*args, g, tck, *flags, staged=True)
        bitwise(again[1], k5[True][1], f"[{tag}] K5 d_lut, two staged runs")
        del vol, img4, tck, k5, d_r, again
        for name, src, line, k_ms, d_ms, p_ms, e in (
            ("sweep_fwd", "slice_sweep.cu", 698, k3_ms, k3_direct,
             k3_plain_ms, k3_err),
            ("sweep_fwd_ckpt", "slice_sweep.cu", 714, k4_ms, k4_direct,
             k4_plain_ms, k4_err),
            ("sweep_bwd", "slice_vjp_staged.cu", 787, k5_ms, k5_direct,
             k5_plain_ms, k5_err),
        ):
            print(f"  [{tag}] {name}: staged {k_ms:.3f} ms, direct "
                  f"{d_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{bounds[name]['bound_ms']:.3f} ms "
                  f"({bounds[name]['bound_by']}), max_abs_err {e:.3e}")
            records.append({
                "name": f"{name}[{tag}]", "route": "cuda",
                "source": f"vrdd_tpu_torch/csrc/{src}",
                "replaces": f"vrdd_tpu/pallas/slice_vjp.py:{line}",
                "launches": launches[name],
                "staged_launches": staged[name], "max_abs_err": e,
                "ms": k_ms, "direct_ms": d_ms, "plain_ms": p_ms,
                **bounds[name],
            })
        torch.cuda.empty_cache()
    print("  fwd+bwd Mrays/s (staged / direct): " + ", ".join(
        f"{t} {a:.2f} / {b:.2f}" for t, (a, b) in mrays.items()))
    return records


def smooth_raw_histograms(n, B, dev, seed=0):
    """``(n, n, n, B)`` float32 items-major raw histograms, made on ``dev``
    a few z-layers at a time: per block a softmax over the bins around a
    smooth mean field in [0, 1] (four Gaussian blobs drawn from ``seed``).
    Away from the blobs the field is 0 and the mass sits in bin 0: the
    decoded mean is about 0.02, below 1/18, where the default LUT's alpha is
    still 0 — empty space for ESS to cull."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    blobs = [(rng.uniform(0.3, 0.7, 3), rng.uniform(0.06, 0.12),
              rng.uniform(0.6, 1.0)) for _ in range(4)]
    g = torch.linspace(0.0, 1.0, n, device=dev)
    centers = (torch.arange(B, device=dev, dtype=torch.float32) + 0.5) / B
    out = torch.empty((n, n, n, B), dtype=torch.float32, device=dev)
    step = max(1, (1 << 24) // (n * n * B))
    for z0 in range(0, n, step):
        z = g[z0:z0 + step]
        m = torch.zeros((z.shape[0], n, n), device=dev)
        for c, sd, a in blobs:
            r2 = ((z - c[0]) ** 2)[:, None, None] + ((g - c[1]) ** 2)[
                None, :, None] + ((g - c[2]) ** 2)[None, None, :]
            m += a * torch.exp(-r2 / (2 * sd * sd))
        logits = -((centers - m.clamp(max=1.0)[..., None]) ** 2) / 1e-3
        out[z0:z0 + step] = torch.softmax(logits, dim=-1)
    return out


def phase_7(dev, card, smi, tf, work):
    """The render path: RenderPipeline at the reference's benchmark geometry
    (7a), at full size through 'auto' (7b, the main-path run), the
    differentiable sweep with ESS (7b) and the render CLI (7c). Returns the
    kernel records."""
    import contextlib
    import dataclasses
    import io
    import re

    import torch

    from vrdd_tpu_torch import cli
    from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import preblend_planes
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.renderer import interp_mean_volume
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, MarchConfig, QueryMethod, RenderConfig,
        TransferFunctionConfig, query_channel,
    )

    k1, bm = sk.sweep_preblended_planes, sk.ess_bitmap
    iv = default_benchmark_inv_view()
    march = MarchConfig()

    def config(q, size, var_scale):
        """The render of query ``q``; the variance goes through the TF
        scaled by ``var_scale`` so that it lands on the LUT's ramp."""
        return RenderConfig(
            camera=CameraConfig(width=size, height=size),
            query_method=QueryMethod(q),
            tf=TransferFunctionConfig(scale=var_scale if q == 2 else 1.0))

    def check_image(img, what, size):
        if tuple(img.shape) != (size, size, 4) or not torch.isfinite(img).all():
            fail(f"{what}: bad output")
        if float(img[..., 3].max()) <= 0.0:
            fail(f"{what}: empty image")

    # ---- 7a: the reference's benchmark geometry
    S = 512
    print(f"[7a] RenderPipeline, 50 x 50 x 10 blocks x 32 bins -> {S}^2, "
          f"on {card} ({smi})")
    hist = torch.from_numpy(random_histogram_volume((10, 50, 50), 32,
                                                    seed=0)).to(dev)
    pipe = RenderPipeline(raw=RawHistogramVolume(hist))
    for q in (1, 2, 3, 7):
        cfg = config(q, S, 0.25)  # Dirichlet histograms: wide
        imgs, line = {}, []
        for name, renderer, ess in (("scan", "scan", True),
                                    ("slice", "slice", True),
                                    ("pallas+ess", "pallas", True),
                                    ("pallas", "pallas", False)):
            pipe.empty_space_skip = ess

            def frame(renderer=renderer, cfg=cfg):
                return pipe.render(iv, cfg, renderer)

            imgs[name] = frame()
            check_image(imgs[name], f"7a q{q} {name}", S)
            ms = host_ms(frame, {"scan": 3, "slice": 5}.get(renderer, 20))
            line.append(f"{name} {ms:.3f} ms ({S * S / ms / 1e3:.2f} "
                        "MTexels/s)")
        pipe.empty_space_skip = True
        if not torch.equal(imgs["pallas+ess"], imgs["pallas"]):
            fail(f"7a q{q}: K1 with ESS is not bitwise K1 without")
        compare(imgs["pallas+ess"], imgs["slice"], f"[7a q{q}] pallas vs slice")
        print(f"  [7a q{q}] " + ", ".join(line))
    del pipe, hist, imgs

    # ---- 7b: full size through 'auto', the main-path run
    n, B, W = 256, 32, 1024
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hist = smooth_raw_histograms(n, B, dev)
    print(f"[7b] RenderPipeline, {n}^3 blocks x {B} bins float32 "
          f"({hist.numel() * 4 / 1e9:.2f} GB) -> {W}^2, renderer auto")
    pipe = RenderPipeline(raw=RawHistogramVolume(hist))
    print(f"  compute_stats_volume "
          f"{1e3 * pipe.timings['basic_data_processing/raw']:.3f} ms (host "
          "clock, synchronized)")
    for q in (1, 2, 3, 7):
        if pipe.resolve_renderer("auto", iv, config(q, W, 6.0)) != "pallas":
            fail(f"7b q{q}: 'auto' did not resolve to the fused kernel")
    k1.launches = k1.ess_launches = k1.staged_launches = bm.launches = 0
    images, launches = {}, {}

    def counts():
        return (k1.launches, k1.ess_launches, bm.launches, k1.staged_launches)

    for q in (1, 2, 3, 7):
        before = counts()
        images[q] = pipe.render(iv, config(q, W, 6.0), "auto")
        launches[q] = tuple(c - b for c, b in zip(counts(), before))
    torch.cuda.synchronize()
    print(f"  launches in the main-path run: K1 {k1.launches}, with ESS "
          f"{k1.ess_launches}, ESS bitmap {bm.launches}, K1 staged "
          f"{k1.staged_launches} (per query, K1 / with ESS / bitmap / "
          f"staged: {launches})")
    if (k1.launches == 0 or k1.ess_launches != k1.launches
            or bm.launches != k1.launches):
        fail("7b: the render path did not run the ESS bitmap and K1 with ESS")
    if k1.staged_launches != k1.launches:
        fail("7b: the render path did not run K1 on the staged path")

    def channel(q):
        """The pipeline's scalar field of query q, from its public parts."""
        if q == 7:
            return interp_mean_volume(pipe.raw.histograms)
        return pipe.raw_stats[..., query_channel(QueryMethod(q))].contiguous()

    records = []
    P = max(64, 2 * n)
    slopes = sk.pixel_slope_params(W, W)
    img_bytes, lut_bytes = W * W * 16, tf.size * 4
    for q in (1, 2, 3, 7):
        cfg = config(q, W, 6.0)  # peaked histograms: narrow
        check_image(images[q], f"7b q{q}", W)
        vol = channel(q)
        toff = 0.0 if q == 7 else 0.5  # query 7: the block-boundary grid
        tscl = cfg.tf.scale
        ess_ms, stats = timed_once(lambda vol=vol, toff=toff:
                                   sk.precompute_ess_stats(
                                       vol, n_planes=P, march=march,
                                       tex_offset=toff))
        frame_ms = host_ms(lambda cfg=cfg: pipe.render(iv, cfg, "auto"), 5)
        blend_ms = time_ms(lambda vol=vol, toff=toff: preblend_planes(
            vol, P, march.box_min, march.box_max, -1, toff), TIMED_RUNS)
        planes, zs = preblend_planes(vol, P, march.box_min, march.box_max,
                                     -1, toff)
        bargs = (stats, zs, ORIGIN, slopes, tf, 0.0, tscl)
        bkw = dict(width=W, height=W, ny=n, nx=n, plane_chunk=8, march=march,
                   tex_offset=toff)
        bitmap_ms = time_ms(lambda: bm(*bargs, **bkw), TIMED_RUNS)
        ess = bm(*bargs, **bkw)
        bitmap_plain_ms, ess_ref = timed_once(
            lambda: sk.ess_bitmap_reference(*bargs, **bkw))
        n_diff = int((ess != ess_ref).sum())
        print(f"  [7b q{q}] ESS bitmap kernel vs plain: {n_diff} of "
              f"{ess.numel()} (tile, chunk) bytes differ")
        if n_diff:
            fail(f"7b q{q}: the ESS bitmap kernel differs from its plain "
                 "version")

        def k1_run(culled, planes=planes, zs=zs, stats=stats, tscl=tscl,
                   toff=toff):
            """The public K1 wrapper; with ESS it launches the bitmap
            kernel from the cached plane stats, then K1."""
            return k1(planes, zs, ORIGIN, slopes, tf, 0.05, 1.0, 0.0, tscl,
                      width=W, height=W, tex_offset=toff,
                      empty_space_skip=culled,
                      ess_stats=stats if culled else None)

        k1_ess_ms, k1_ess_direct = paths_ms(
            lambda st: on_path(st, lambda: k1_run(True)))
        k1_ms = time_ms(lambda: k1_run(False), TIMED_RUNS)
        img_ess, img_plain_k1 = k1_run(True), k1_run(False)
        bitwise(on_path(False, lambda: k1_run(True))(), img_ess,
                f"7b q{q}: K1+ESS staged vs direct")
        pipe.empty_space_skip = False
        no_ess = pipe.render(iv, cfg, "pallas")
        pipe.empty_space_skip = True
        if not (torch.equal(img_ess, img_plain_k1)
                and torch.equal(no_ess, images[q])):
            fail(f"7b q{q}: K1 with ESS is not bitwise K1 without")
        slice_ms, ref = timed_once(lambda cfg=cfg: pipe.render(iv, cfg,
                                                               "slice"))
        compare(images[q], ref, f"[7b q{q}] auto (pallas+ESS) vs slice")
        ref_ess_ms, ref_ess = timed_once(
            lambda: sk.sweep_preblended_planes_reference(
                planes, zs, ORIGIN, slopes, tf, 0.05, 1.0, 0.0, tscl,
                width=W, height=W, tex_offset=toff, ess=ess_ref))
        err = compare(img_ess, ref_ess, f"[7b q{q}] K1+ESS vs plain+bitmap")
        culled = float((ess == 0).float().mean())
        n_live, tex_live = live_samples(planes, zs, slopes, tf, 0.05, 0.0,
                                        tscl, W, W, ess=ess, tex_offset=toff)
        n_all, tex_all = live_samples(planes, zs, slopes, tf, 0.05, 0.0,
                                      tscl, W, W, tex_offset=toff)
        stats_bytes = 2 * stats[0].numel() * 4
        bitmap_ops = ess.numel() * ess_pair_ops(8, len(tf))
        bd_bm = bound(stats_bytes + P * 4 + lut_bytes + ess.numel(),
                      bitmap_ops)
        # K1 with ESS: the plane texels its live samples read, the stats,
        # the image; the bitmap in between need not reach memory
        bd = bound(tex_live * 4 + stats_bytes + img_bytes,
                   n_live * SAMPLE_OPS + bitmap_ops)
        bd_all = bound(tex_all * 4 + img_bytes, n_all * SAMPLE_OPS)
        print(f"  [7b q{q}] frame {frame_ms:.3f} ms "
              f"({W * W / frame_ms / 1e3:.2f} MTexels/s); ESS plane stats "
              f"{ess_ms:.3f} ms (once per volume); per frame: pre-blend "
              f"{blend_ms:.3f} ms, bitmap {bitmap_ms:.3f} ms (bound "
              f"{bd_bm['bound_ms']:.4f}, plain {bitmap_plain_ms:.3f}), K1+ESS "
              f"with its bitmap {k1_ess_ms:.3f} ms (direct fetch "
              f"{k1_ess_direct:.3f}; bound "
              f"{bd['bound_ms']:.4f}, {bd['bound_by']}), K1 {k1_ms:.3f} ms "
              f"(bound {bd_all['bound_ms']:.4f}, {bd_all['bound_by']}); "
              f"culled {culled:.4f} of (tile, chunk) pairs, evaluated samples "
              f"{n_live} with ESS / {n_all} without, texels read {tex_live} / "
              f"{tex_all} of {planes.numel()}; plain slice {slice_ms:.3f} ms, "
              f"plain bitmap + K1 {bitmap_plain_ms + ref_ess_ms:.3f} ms")
        records.append({
            "name": f"ess_bitmap[q{q}]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/ess_bitmap.cu",
            "replaces": "vrdd_tpu/pallas/slice_kernel.py:397",
            "launches": launches[q][2], "staged_launches": None,
            "max_abs_err": float(n_diff), "ms": bitmap_ms,
            "direct_ms": None, "plain_ms": bitmap_plain_ms, **bd_bm,
        })
        records.append({
            "name": f"sweep_preblended_planes[ess,q{q}]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_kernel.py:1351",
            "launches": launches[q][1], "staged_launches": launches[q][3],
            "max_abs_err": err, "ms": k1_ess_ms, "direct_ms": k1_ess_direct,
            "plain_ms": bitmap_plain_ms + ref_ess_ms, **bd,
        })
        del planes, ref, ref_ess, no_ess, vol
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")

    # the differentiable sweep with ESS on the same volume (K3/K4 ESS)
    vol = channel(1)
    P, ck = 2 * n, 4
    counters = diff_counters()
    for c in counters:
        c.launches = c.staged_launches = 0
    sv.sweep_fwd.ess_launches = sv.sweep_fwd_ckpt.ess_launches = 0
    bm.launches = 0
    kw = dict(width=W, height=W, n_planes=P, wrt=("volume",),
              plane_chunk=ck)
    out = {}
    for ess in (True, False):
        with torch.no_grad():
            img3 = sv.pallas_slice_render_diff(vol, ORIGIN, tf,
                                               empty_space_skip=ess, **kw)
        v = vol.clone().requires_grad_()
        img4 = sv.pallas_slice_render_diff(v, ORIGIN, tf,
                                           empty_space_skip=ess, **kw)
        (g,) = torch.autograd.grad(torch.mean((img4 - 0.25) ** 2), [v])
        out[ess] = (img3, img4.detach(), g)
        if ess:
            torch.cuda.synchronize()
            diff_launches = {c.__name__: c.launches for c in counters}
            diff_staged = {c.__name__: c.staged_launches for c in counters}
            ess_launches = {c.__name__: c.ess_launches for c in counters[:2]}
            diff_launches["ess_bitmap"] = bm.launches
    print(f"  [7b diff, wrt volume] launches with ESS: {diff_launches}, of "
          f"them culling: {ess_launches}, staged: {diff_staged}")
    if min(diff_launches.values()) == 0 or min(ess_launches.values()) == 0:
        fail("7b diff: the ESS bitmap, K3/K4 with ESS or K5 was not launched")
    if not (torch.equal(out[True][0], out[False][0])
            and torch.equal(out[True][1], out[False][1])):
        fail("7b diff: the image with ESS is not bitwise the one without")
    rel = rel_l2(out[True][2], out[False][2], "[7b diff] d_volume ESS vs no ESS")
    if rel > 1e-6:
        fail(f"7b diff: d_volume with ESS {rel:.3e} from without (limit 1e-6)")
    del out, img3, img4, g, v
    planes, zs = preblend_planes(vol, P, march.box_min, march.box_max, -1)
    cfg = sv.planes_config(zs, ORIGIN, slopes, width=W, height=W, n_planes=P,
                           plane_chunk=ck)
    ess = bm(sk.ess_plane_stats(planes), zs, ORIGIN, slopes, tf, 0.0, 1.0,
             width=W, height=W, ny=n, nx=n, plane_chunk=ck)
    ess_cfg = dataclasses.replace(cfg, ess=ess)
    args = (planes, None, torch.as_tensor(tf, device=dev),
            torch.tensor(0.05, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args)
    img_e, tck_e = sv.sweep_fwd_ckpt(ess_cfg, *args)
    if not (torch.equal(img_e, img) and torch.equal(tck_e, tck)
            and torch.equal(sv.sweep_fwd(ess_cfg, *args), img)):
        fail("7b diff: K3/K4 with ESS (image, checkpoints) not bitwise "
             "without")
    n_live, tex_live = live_samples(planes, zs, slopes, tf, 0.05, 0.0, 1.0,
                                    W, W, ess=ess, chunk=ck)
    for name, fn, ref_fn, extra in (
            ("sweep_fwd", sv.sweep_fwd, sv.sweep_fwd_reference, 0),
            ("sweep_fwd_ckpt", sv.sweep_fwd_ckpt,
             sv.sweep_fwd_ckpt_reference, cfg.n_chunks * W * W * 4)):
        k_ms, d_ms = paths_ms(
            lambda st, fn=fn: lambda: fn(ess_cfg, *args, staged=st))
        p_ms, ref = timed_once(lambda ref_fn=ref_fn: ref_fn(ess_cfg, *args))
        got = fn(ess_cfg, *args)
        direct = fn(ess_cfg, *args, staged=False)
        for a, b in (zip(got, direct) if isinstance(got, tuple)
                     else ((got, direct),)):
            bitwise(a, b, f"[7b diff] {name}+ESS staged vs direct")
        if name == "sweep_fwd_ckpt":
            compare(got[1][..., None], ref[1][..., None],
                    f"[7b diff] {name}+ESS checkpoints vs plain")
            got, ref = got[0], ref[0]
        e = compare(got, ref, f"[7b diff] {name}+ESS vs plain+bitmap")
        # the kernel alone, given the bitmap: its live texels, the bitmap,
        # the image (and K4's checkpoint rows, every one written)
        bd = bound(tex_live * 4 + ess.numel() + img_bytes + extra,
                   n_live * SAMPLE_OPS)
        print(f"  [7b diff] {name}+ESS: staged {k_ms:.3f} ms, direct "
              f"{d_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}; {n_live} evaluated samples, {tex_live} "
              f"texels read)")
        records.append({
            "name": f"{name}[ess]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_vjp.py:"
                        f"{698 if name == 'sweep_fwd' else 714}",
            "launches": ess_launches[name],
            "staged_launches": diff_staged[name], "max_abs_err": e,
            "ms": k_ms, "direct_ms": d_ms, "plain_ms": p_ms, **bd,
        })
    del pipe, hist, vol, planes, img, tck, img_e, tck_e
    torch.cuda.empty_cache()

    # ---- 7c: the render CLI at its defaults
    for extra in ([], ["--renderer", "auto"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["render", "--file", "none", "-o",
                           str(work / "render.ppm"), *extra])
        text = buf.getvalue()
        print(f"[7c] render --file none {' '.join(extra)}: rc {rc}")
        for line in text.splitlines():
            print(f"  {line}")
        if rc != 0 or not re.search(r"Throughput = \S+ MTexels/s", text):
            fail(f"render --file none {extra}: rc {rc}")
    return records


def seed_records(dev, tf, n, W, density):
    """8a: the seeded kernels at full size on fit-voxels' mean channel (a
    ``2n``-plane stack of the ``n``^3 Gaussian-blob mu, made on the card) at
    ``W``^2. The split stack: the back half seeded with the front half's
    image (K3) through K1 and K3 equals the one-pass sweep; a frozen seed
    comes back as itself; seeded K4 + K5 (``S``, ``d_acc0``) against the
    plain versions; K1 seeded timed. The streamed chunk: K3/K4/K5 on chunk
    4 of 8 as ``streaming_decode_render`` launches them, seeded with the
    chain of the chunks before it, each held against its plain version and
    timed, and ``d_acc0`` through the public wrapper. Returns ``(records,
    K1 seeded launches)``: the kernels' records and the seeded launches of
    K1's public wrapper in this run (no fit-voxels path resumes K1: its
    seeded callers are the split stack here and the multi-device sweep)."""
    import numpy as np
    import torch

    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import preblend_planes
    from vrdd_tpu_torch.utils.config import MarchConfig

    k1 = sk.sweep_preblended_planes
    march = MarchConfig()
    small = gaussian_blob_volume((32, 32, 32), seed=0)
    err = float(np.abs(gaussian_blob_volume((32, 32, 32), seed=0, device=dev)
                       .cpu().numpy() - small).max())
    print(f"[8a] the device-made Gaussian blob vs numpy's at 32^3: max abs "
          f"err {err:.3e}")
    if err > 1e-6:
        fail(f"8a: the device-made blob differs from numpy's by {err:.3e}")
    P, half = 2 * n, n
    mu = gaussian_blob_volume((n, n, n), seed=0, device=dev)
    planes, zs = preblend_planes(mu, P, march.box_min, march.box_max, -1)
    del mu
    front_p, back_p = planes[:half].contiguous(), planes[half:].contiguous()
    slopes = sk.pixel_slope_params(W, W)
    sp = (march.box_max[2] - march.box_min[2]) / P
    print(f"[8a] seeded kernels: fit-voxels' {n}^3 mean channel, {P} planes "
          f"-> {W}^2, split after plane {half}, density {density}")
    lut = torch.as_tensor(tf, device=dev)
    scal = [torch.tensor(v, device=dev) for v in (density, 0.0, 1.0)]

    def cfg(lo, hi):
        return sv.planes_config(zs[lo:hi], ORIGIN, slopes, width=W, height=W,
                                n_planes=hi - lo, plane_spacing=sp,
                                plane_chunk=4)

    cfg_all, cfg_f, cfg_b = cfg(0, P), cfg(0, half), cfg(half, P)
    kw = dict(width=W, height=W, plane_spacing=sp)
    k1.seed_launches = k1.staged_launches = 0
    one = sv.sweep_fwd(cfg_all, planes, None, lut, *scal)
    front = sv.sweep_fwd(cfg_f, front_p, None, lut, *scal)
    back_k1 = k1(back_p, zs[half:], ORIGIN, slopes, tf, density, acc_init=front,
                 **kw)
    back_k3 = sv.sweep_fwd(cfg_b, back_p, None, lut, *scal, front)
    torch.cuda.synchronize()
    k1_seeded, k1_staged = k1.seed_launches, k1.staged_launches
    compare(back_k1, one, "[8a] K1 seeded back half vs one pass (K3)")
    compare(back_k3, one, "[8a] K3 seeded back half vs one pass (K3)")
    # frozen seeds: 8 rows at alpha 0.99, 8 at exactly 1
    seed = front.clone()
    seed[:8, :, 3] = 0.99
    seed[8:16, :, 3] = 1.0
    got = k1(back_p, zs[half:], ORIGIN, slopes, tf, density, acc_init=seed,
             **kw)
    img4, tck = sv.sweep_fwd_ckpt(cfg_b, back_p, None, lut, *scal, seed)
    img3 = sv.sweep_fwd(cfg_b, back_p, None, lut, *scal, seed)
    torch.cuda.synchronize()
    t0 = 1.0 - seed[:16, :, 3]
    if not (torch.equal(got[:16], seed[:16]) and torch.equal(img4[:16],
                                                            seed[:16])):
        fail("8a: a frozen seed did not come back as itself (K1, K4)")
    if not torch.equal(tck[:, :16], t0.expand(tck.shape[0], 16, W)):
        fail("8a: K4's checkpoint rows of a frozen seed are not all T0")
    if not torch.equal(img4, img3):
        fail("8a: seeded K4's image is not bitwise seeded K3's")
    print("  frozen seeds (alpha 0.99 and 1): K1 and K4 return the seed, "
          "K4's checkpoint rows are T0, K4's image is bitwise K3's")
    # K5 seeded against the plain version; d_acc0 through the public wrapper
    g = (2.0 / img4.numel()) * (img4 - 0.25)
    d5, _, _, s5 = sv.sweep_bwd(cfg_b, back_p, None, lut, *scal, g, tck,
                                True, False, False, acc0=seed)
    d5r, _, _, s5r = sv.sweep_bwd_reference(cfg_b, back_p, None, lut, *scal,
                                            g, True, False, False, seed)
    rel_l2(d5, d5r, "[8a] K5 seeded d_planes")
    rel_l2(s5, s5r, "[8a] K5 S (P_total per ray)")
    if not torch.equal(s5[:16], torch.zeros_like(s5[:16])):
        fail("8a: K5's S of a frozen seed is not 0")
    grads = []
    for fn in (sv.sweep_preblended_planes_diff,
               sk.sweep_preblended_planes_reference):
        leaves = [back_p.clone().requires_grad_(),
                  seed.clone().requires_grad_()]
        img = fn(leaves[0], zs[half:], ORIGIN, slopes, tf, density,
                 acc_init=leaves[1], **kw)
        grads.append(torch.autograd.grad(torch.mean((img - 0.25) ** 2),
                                         leaves))
    rel_l2(grads[0][0], grads[1][0], "[8a] seeded d_planes (K4/K5 vs plain)")
    rel_l2(grads[0][1], grads[1][1], "[8a] d_acc0 (K4/K5 vs plain)")
    del grads, leaves, img

    # K1 seeded alone, timed against its plain version on the split stack
    n_live, tex = live_samples(back_p, zs[half:], slopes, tf, density, 0.0,
                               1.0, W, W, chunk=4, seed_alpha=front[..., 3])
    img_b = W * W * 16
    bd = bound(tex * 4 + 2 * img_b, n_live * SAMPLE_OPS)
    ms, direct_ms = paths_ms(lambda st: on_path(st, lambda: k1(
        back_p, zs[half:], ORIGIN, slopes, tf, density, acc_init=front,
        **kw)))
    bitwise(on_path(False, lambda: k1(back_p, zs[half:], ORIGIN, slopes, tf,
                                      density, acc_init=front, **kw))(),
            back_k1, "[8a] K1 seeded staged vs direct")
    p_ms, ref = timed_once(lambda: sk.sweep_preblended_planes_reference(
        back_p, zs[half:], ORIGIN, slopes, tf, density, acc_init=front, **kw))
    e = compare(back_k1, ref, "[8a] sweep_preblended_planes seeded vs plain")
    del ref
    print(f"  [8a] sweep_preblended_planes seeded ({half} planes): staged "
          f"{ms:.3f} ms, direct {direct_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}; {n_live} evaluated samples, {tex} texels "
          f"read)")
    records = [{
        "name": "sweep_preblended_planes[seed]", "route": "cuda",
        "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
        "replaces": "vrdd_tpu/pallas/slice_kernel.py:1351",
        "launches": k1_seeded, "staged_launches": k1_staged, "max_abs_err": e,
        "ms": ms, "direct_ms": direct_ms, "plain_ms": p_ms, **bd,
    }]

    # the seeded K3/K4/K5 as the streamed fit-voxels launches them: chunk
    # c of 8 (64 planes of the same stack at its full-stack spacing) at W^2
    # with streaming_decode_render's slopes, seeded with the image of the
    # chunks before it (the chain of seeded K3 its no-grad render runs)
    cp, c = P // 8, 4
    mxs, mys = sk._pixel_slopes(W, W, 2.0)
    s_slopes = (float(mxs[0]), float(mxs[1] - mxs[0]), float(mys[0]),
                float(mys[1] - mys[0]))

    def chunk(k):
        sl = slice(k * cp, (k + 1) * cp)
        return (sv.planes_config(zs[sl], ORIGIN, s_slopes, width=W, height=W,
                                 n_planes=cp, plane_spacing=sp, plane_chunk=4),
                planes[sl].contiguous(), zs[sl])

    acc = torch.zeros((W, W, 4), device=dev)
    for k in range(c):
        cfg_k, p_k, _ = chunk(k)
        acc = sv.sweep_fwd(cfg_k, p_k, None, lut, *scal, acc)
    cfg_c, p_c, zs_c = chunk(c)
    print(f"[8a] streamed chunk {c} of 8: planes {c * cp}-{(c + 1) * cp - 1}, "
          f"{W}^2, seeded with the chain of chunks 0-{c - 1} (seed alpha mean "
          f"{float(acc[..., 3].mean()):.4f}, frozen pixels "
          f"{int((acc[..., 3] > march.opacity_threshold).sum())})")
    args = (cfg_c, p_c, None, lut, *scal)
    img4, tck = sv.sweep_fwd_ckpt(*args, acc)
    g = (2.0 / img4.numel()) * (img4 - 0.25)
    n_live, tex = live_samples(p_c, zs_c, s_slopes, tf, density, 0.0, 1.0, W,
                               W, chunk=4, seed_alpha=acc[..., 3])
    ops = n_live * SAMPLE_OPS
    tck_b = cfg_c.n_chunks * W * W * 4
    cases = (
        ("sweep_fwd", lambda st: sv.sweep_fwd(*args, acc, staged=st),
         lambda: sv.sweep_fwd_reference(*args, acc),
         bound(tex * 4 + 2 * img_b, ops), 698, "slice_sweep.cu"),
        ("sweep_fwd_ckpt", lambda st: sv.sweep_fwd_ckpt(*args, acc, staged=st),
         lambda: sv.sweep_fwd_ckpt_reference(*args, acc),
         bound(tex * 4 + 2 * img_b + tck_b, ops), 714, "slice_sweep.cu"),
        ("sweep_bwd",
         lambda st: sv.sweep_bwd(*args, g, tck, True, False, False, acc0=acc,
                                 staged=st),
         lambda: sv.sweep_bwd_reference(*args, g, True, False, False, acc),
         bound(tex * 4 + tck_b + 2 * img_b + p_c.numel() * 4 + W * W * 4,
               K5_SAMPLE_FACTOR * ops), 787, "slice_vjp_staged.cu"),
    )
    for name, fn, ref_fn, bd, line, src in cases:
        ms, direct_ms = paths_ms(lambda st, fn=fn: lambda: fn(st))
        p_ms, ref = timed_once(ref_fn)
        got, direct = fn(True), fn(False)
        what = f"[8a chunk {c}] {name} seeded"
        if name == "sweep_bwd":
            rel_l2(got[0], ref[0], f"{what} d_planes")
            rel_l2(got[3], ref[3], f"{what} S (P_total per ray)")
            rel_l2(got[0], direct[0], f"{what} d_planes staged vs direct",
                   1e-6)
            rel_l2(got[3], direct[3], f"{what} S staged vs direct", 1e-6)
            e = float((got[0] - ref[0]).abs().max())
        elif name == "sweep_fwd_ckpt":
            e = compare(got[0], ref[0], f"{what} image vs plain")
            compare(got[1][..., None], ref[1][..., None],
                    f"{what} checkpoints vs plain")
            bitwise(got[0], direct[0], f"{what} image staged vs direct")
            bitwise(got[1], direct[1], f"{what} checkpoints staged vs direct")
        else:
            e = compare(got, ref, f"{what} vs plain")
            bitwise(got, direct, f"{what} staged vs direct")
        del got, ref, direct
        print(f"  {what}: staged {ms:.3f} ms, direct {direct_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; {n_live} evaluated "
              f"samples, {tex} texels read)")
        records.append({
            "name": f"{name}[seed]", "route": "cuda",
            "source": f"vrdd_tpu_torch/csrc/{src}",
            "replaces": f"vrdd_tpu/pallas/slice_vjp.py:{line}",
            "launches": None, "staged_launches": None, "max_abs_err": e,
            "ms": ms, "direct_ms": direct_ms, "plain_ms": p_ms, **bd,
        })
    # d_acc0 of the chunk through the public wrapper (K4/K5, the main path's
    # wrt) against the plain analytic VJP
    grads = []
    for fn, extra in ((sv.sweep_preblended_planes_diff, {"wrt": ("volume",)}),
                      (sk.sweep_preblended_planes_reference, {})):
        leaves = [p_c.clone().requires_grad_(), acc.clone().requires_grad_()]
        img = fn(leaves[0], zs_c, ORIGIN, s_slopes, tf, density,
                 acc_init=leaves[1], width=W, height=W, plane_spacing=sp,
                 plane_chunk=4, **extra)
        grads.append(torch.autograd.grad(torch.mean((img - 0.25) ** 2),
                                         leaves))
    rel_l2(grads[0][0], grads[1][0], f"[8a chunk {c}] seeded d_planes "
           "(K4/K5 vs plain)")
    rel_l2(grads[0][1], grads[1][1], f"[8a chunk {c}] d_acc0 (K4/K5 vs plain)")
    return records, k1_seeded


def fit_voxels_cli(work, n, W, steps, streamed):
    """8b: one ``fit-voxels`` run through the CLI: returns ``(losses, step
    ms, launches, seeded launches, launches per image size)``."""
    import contextlib
    import io
    import re

    import torch

    from vrdd_tpu_torch import cli

    counters = diff_counters()
    for c in counters:
        c.launches = c.seed_launches = c.staged_launches = 0
        c.size_launches.clear()
        c.size_staged_launches.clear()
    torch.cuda.reset_peak_memory_stats()
    ckpt = work / f"fit_voxels_{int(streamed)}.npz"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit-voxels", "--size", str(n), "--image", str(W),
                       "--views", "3", "--view-angle", "25", "--iters",
                       str(steps), "--checkpoint", str(ckpt)]
                      + (["--streamed"] if streamed else []))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    losses = [float(v) for v in re.findall(r"step \d+: loss (\S+)", text)]
    ms = [float(v) for v in re.findall(r"step \d+: loss \S+ \((\S+) ms\)",
                                       text)]
    launches = {c.__name__: c.launches for c in counters}
    seeded = {c.__name__: c.seed_launches for c in counters}
    staged = {c.__name__: c.staged_launches for c in counters}
    sizes = {c.__name__: dict(c.size_launches) for c in counters}
    staged_sizes = {c.__name__: dict(c.size_staged_launches)
                    for c in counters}
    tag = "streamed" if streamed else "unstreamed"
    for line in text.splitlines():
        print(f"  [{tag}] {line}")
    print(f"  [{tag}] {wall:.2f} s in all; launches {launches}, seeded "
          f"{seeded}, staged {staged}, per image size {sizes}")
    if rc != 0 or not ckpt.exists() or len(losses) != steps:
        fail(f"fit-voxels {tag}: rc {rc}, checkpoint {ckpt.exists()}, "
             f"{losses}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"fit-voxels {tag}: loss not finite and falling: {losses}")
    if "renderer: pallas" not in text or min(launches.values()) == 0:
        fail(f"fit-voxels {tag} did not train through K3/K4/K5: {launches}")
    if streamed and min(seeded.values()) == 0:
        fail(f"fit-voxels streamed did not run the seeded K3/K4/K5: {seeded}")
    return losses, ms, launches, seeded, sizes, staged, staged_sizes


def profile_step(step, what, top=8):
    """One warm call of ``step`` under torch.profiler: the ``top`` costliest
    CUDA kernels by device time, and the device's busy share of the step's
    host-clock time (idle share = 1 - busy; kernels run on one stream, so
    their times add). Counts kernel events only: the op that launched a
    kernel carries the same device time. Prints "not measured" where the
    profiler sees no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = sorted((e for e in prof.key_averages()
                     if getattr(e, "device_type", None) == DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy = 1e-3 * sum(dev_us(e) for e in events)
    if busy <= 0.0:
        print(f"  [{what}] profile: device time not measured (wall "
              f"{wall:.3f} ms)")
        return
    print(f"  [{what}] profiled step: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1.0 - busy / wall:.3f}); costliest:")
    for e in events[:top]:
        print(f"    {1e-3 * dev_us(e):8.3f} ms {dev_us(e) / 1e3 / busy:6.1%} "
              f"x{e.count:<4d} {e.key[:70]}")


def shearwarp_setup(vol, view, W, n_planes):
    """The fused sweep of one rotated shear-warp frame, as
    ``shearwarp_render_image(backend='pallas')`` builds it: ``(cfg, planes,
    wi, origin, dz_sign)`` for K3/K4/K5 and their plain versions."""
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march import shearwarp as sw
    from vrdd_tpu_torch.march.slice import preblend_planes
    from vrdd_tpu_torch.utils.config import MarchConfig

    march = MarchConfig()  # the box is a cube centred on 0: permutes to itself
    iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
    axis, (px, py, pz), dz_sign, ok, b = sw.slope_corner_bounds(iv, W, W)
    wi = -(-2 * W // 128) * 128
    mgrid = (*sw.mgrid_params(b[0], b[1], wi), *sw.mgrid_params(b[2], b[3], wi))
    vol_p = vol.permute(2 - pz, 2 - py, 2 - px).contiguous()
    planes, zs = preblend_planes(vol_p, n_planes, march.box_min,
                                 march.box_max, dz_sign)
    origin = tuple(float(iv[i, 3]) for i in (px, py, pz))
    cfg = sv.planes_config(zs, origin, mgrid, dz_sign=dz_sign, width=wi,
                           height=wi, n_planes=n_planes, plane_chunk=4)
    return cfg, planes, wi, origin, dz_sign, axis


def phase_8(dev, card, smi, tf, work, n=256, W=512, steps=5, n_raw=256,
            W_render=1024):
    """BASELINE config 3 and rotated views (8a seeded kernels, 8b fit-voxels
    unstreamed and streamed, 8c rotated RenderPipeline frames); returns the
    kernel records."""
    import numpy as np
    import torch

    from vrdd_tpu_torch import cli
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.core.transfer import grayscale_ramp
    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march import shearwarp as sw
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig)

    gray = grayscale_ramp(9)  # fit-voxels' LUT
    torch.cuda.empty_cache()
    records, k1_seeded = seed_records(dev, gray, n, W, 0.05)
    torch.cuda.empty_cache()

    # ---- 8b: BASELINE config 3 through the CLI, the main-path run
    print(f"[8b] fit-voxels --size {n} --image {W} --views 3 --view-angle 25 "
          f"--iters {steps}, on {card} ({smi})")
    runs = {s: fit_voxels_cli(work, n, W, steps, s) for s in (False, True)}
    first = [runs[s][0][0] for s in (False, True)]
    rel = abs(first[1] - first[0]) / abs(first[0])
    print(f"  first loss unstreamed {first[0]:.9g}, streamed {first[1]:.9g}: "
          f"rel {rel:.3e}")
    if rel > 1e-5:
        fail(f"8b: the streamed first loss is {rel:.3e} from the unstreamed")
    for streamed in (False, True):  # where a step's time goes
        loss_fn, _, _ = cli.fit_voxels_problem(n, W, 3, 25.0, 0, "auto",
                                               streamed, dev)
        params = [torch.zeros((n, n, n), device=dev, requires_grad=True),
                  torch.full((n, n, n), float(np.log(np.float32(0.1))),
                             device=dev, requires_grad=True)]
        profile_step(lambda: torch.autograd.grad(loss_fn(*params), params),
                     f"8b {'streamed' if streamed else 'unstreamed'}")
        del loss_fn, params
    for r in records:  # the seeded kernels' launches in the streamed run
        name = r["name"].split("[")[0]
        if name != "sweep_preblended_planes":
            # seeded and staged: all the run's seeded launches when every
            # launch was staged, none when none was
            total, staged = runs[True][2][name], runs[True][5][name]
            r["launches"] = runs[True][3][name]
            r["staged_launches"] = (r["launches"] if staged == total
                                    else 0 if staged == 0 else None)
        else:
            r["launches"] = k1_seeded

    # the rotated views' K4/K5 of fit-voxels on the m-grid, view (25, 0)
    mu = gaussian_blob_volume((n, n, n), seed=0, device=dev)
    cfg, planes, wi, origin, dz_sign, _ = shearwarp_setup(mu, (25.0, 0.0), W,
                                                          2 * n)
    del mu
    lut = torch.as_tensor(gray, device=dev)
    scal = [torch.tensor(v, device=dev) for v in (0.05, 0.0, 1.0)]
    args = (cfg, planes, None, lut, *scal)
    img4, tck = sv.sweep_fwd_ckpt(*args)
    g = (2.0 / img4.numel()) * (img4 - 0.25)
    n_live, tex = live_samples(planes, cfg.zs, cfg.slopes, gray, 0.05, 0.0,
                               1.0, wi, wi, chunk=4, origin=origin,
                               dz_sign=dz_sign)
    ops = n_live * SAMPLE_OPS
    img_b, tck_b = wi * wi * 16, cfg.n_chunks * wi * wi * 4
    sw_launches = {name: runs[False][4][name].get((wi, wi), 0)
                   for name in ("sweep_fwd_ckpt", "sweep_bwd")}
    sw_staged = {name: runs[False][6][name].get((wi, wi), 0)
                 for name in ("sweep_fwd_ckpt", "sweep_bwd")}
    print(f"  [8b] the unstreamed run's K4/K5 launches on the {wi}^2 m-grid "
          f"(the rotated views): {sw_launches}, staged {sw_staged}")
    if min(sw_launches.values()) == 0:
        fail(f"8b: the rotated views did not train through K4/K5 on the "
             f"m-grid: {runs[False][4]}")
    for name, fn, ref_fn, bd, line in (
            ("sweep_fwd_ckpt", lambda st: sv.sweep_fwd_ckpt(*args, staged=st),
             lambda: sv.sweep_fwd_ckpt_reference(*args),
             bound(tex * 4 + img_b + tck_b, ops), 714),
            ("sweep_bwd",
             lambda st: sv.sweep_bwd(*args, g, tck, True, False, False,
                                     staged=st),
             lambda: sv.sweep_bwd_reference(*args, g, True, False, False),
             bound(tex * 4 + tck_b + img_b + planes.numel() * 4,
                   K5_SAMPLE_FACTOR * ops), 787)):
        ms, direct_ms = paths_ms(lambda st, fn=fn: lambda: fn(st))
        p_ms, ref = timed_once(ref_fn)
        got, direct = fn(True), fn(False)
        if name == "sweep_bwd":
            rel_l2(got[0], ref[0], f"[8b] shear-warp {name} d_planes")
            rel_l2(got[0], direct[0],
                   f"[8b] shear-warp {name} d_planes staged vs direct", 1e-6)
            e = float((got[0] - ref[0]).abs().max())
        else:
            e = compare(got[0], ref[0], f"[8b] shear-warp {name} image")
            compare(got[1][..., None], ref[1][..., None],
                    f"[8b] shear-warp {name} checkpoints")
            for a, b in zip(got, direct):
                bitwise(a, b, f"[8b] shear-warp {name} staged vs direct")
        del got, ref, direct
        print(f"  [8b] shear-warp view (25, 0), {wi}^2 m-grid, {2 * n} "
              f"planes: {name} staged {ms:.3f} ms, direct {direct_ms:.3f} "
              f"ms, plain {p_ms:.3f} ms, "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {n_live} "
              f"evaluated samples, {tex} texels read)")
        records.append({
            "name": f"{name}[shearwarp,fit]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/"
                      f"{'slice_vjp_staged.cu' if name == 'sweep_bwd' else 'slice_sweep.cu'}",
            "replaces": f"vrdd_tpu/pallas/slice_vjp.py:{line}",
            "launches": sw_launches[name],
            "staged_launches": sw_staged[name], "max_abs_err": e, "ms": ms,
            "direct_ms": direct_ms, "plain_ms": p_ms, **bd,
        })
    del args, planes, img4, tck, g
    torch.cuda.empty_cache()

    # ---- 8c: rotated RenderPipeline frames (7b's volume) through 'auto'
    hist = smooth_raw_histograms(n_raw, 32, dev)
    pipe = RenderPipeline(raw=RawHistogramVolume(hist))
    cfg_r = RenderConfig(camera=CameraConfig(width=W_render, height=W_render),
                         query_method=QueryMethod(1))
    vol = pipe.raw_stats[..., 0].contiguous()
    P = max(64, 2 * n_raw)
    print(f"[8c] RenderPipeline, {n_raw}^3 blocks x 32 bins -> {W_render}^2, "
          f"query 1, rotated, renderer auto (shear-warp, K3)")
    k3 = sv.sweep_fwd
    seen_axes = set()
    for view in ((30.0, 20.0), (0.0, 60.0), (60.0, 0.0)):
        iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
        if pipe.resolve_renderer("auto", iv, cfg_r) != "shearwarp":
            fail(f"8c {view}: 'auto' did not resolve to shear-warp")
        k3.launches = k3.staged_launches = 0
        img = pipe.render(iv, cfg_r, "auto")
        torch.cuda.synchronize()
        launches, staged = k3.launches, k3.staged_launches
        if launches != 1:
            fail(f"8c {view}: the frame launched K3 {launches} times")
        frame_ms = host_ms(lambda: pipe.render(iv, cfg_r, "auto"), 5)
        xla_ms, ref = timed_once(lambda: sw.shearwarp_render_image(
            vol, iv, W_render, W_render, pipe.tf_lut, cfg_r.density,
            cfg_r.brightness, cfg_r.tf.offset, cfg_r.tf.scale,
            march=cfg_r.march, n_planes=P, backend="xla"))
        compare(img, ref, f"[8c {view}] auto (K3) vs 'xla' shear-warp")
        if float(img[..., 3].max()) <= 0.0:
            fail(f"8c {view}: empty image")
        del ref
        cfg, planes, wi, origin, dz_sign, axis = shearwarp_setup(vol, view,
                                                                 W_render, P)
        seen_axes.add((axis, dz_sign))
        args = (cfg, planes, None, torch.as_tensor(pipe.tf_lut, device=dev),
                *[torch.tensor(v, device=dev) for v in
                  (cfg_r.density, cfg_r.tf.offset, cfg_r.tf.scale)])
        ms, direct_ms = paths_ms(
            lambda st: lambda: sv.sweep_fwd(*args, staged=st))
        p_ms, ref = timed_once(lambda: sv.sweep_fwd_reference(*args))
        got = sv.sweep_fwd(*args)
        e = compare(got, ref, f"[8c {view}] K3 on the {wi}^2 m-grid vs plain")
        bitwise(got, sv.sweep_fwd(*args, staged=False),
                f"[8c {view}] K3 staged vs direct")
        del got
        n_live, tex = live_samples(planes, cfg.zs, cfg.slopes,
                                   pipe.tf_lut.cpu().numpy(), cfg_r.density,
                                   cfg_r.tf.offset, cfg_r.tf.scale, wi, wi,
                                   chunk=4, origin=origin, dz_sign=dz_sign)
        bd = bound(tex * 4 + wi * wi * 16, n_live * SAMPLE_OPS)
        print(f"  [8c {view}] principal axis {axis}, d_z sign {dz_sign:+d}: "
              f"frame {frame_ms:.3f} ms ({W_render * W_render / frame_ms / 1e3:.2f}"
              f" MTexels/s), K3 staged {ms:.3f} ms (direct {direct_ms:.3f}, "
              f"plain {p_ms:.3f}, bound "
              f"{bd['bound_ms']:.4f} ms, {bd['bound_by']}; {n_live} "
              f"evaluated samples, {tex} texels read), 'xla' frame "
              f"{xla_ms:.3f} ms")
        records.append({
            "name": f"sweep_fwd[shearwarp,{view[0]:g},{view[1]:g}]",
            "route": "cuda", "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_vjp.py:698",
            "launches": launches, "staged_launches": staged,
            "max_abs_err": e, "ms": ms, "direct_ms": direct_ms,
            "plain_ms": p_ms, **bd,
        })
        del planes, args, ref, img
    if {a for a, _ in seen_axes} != {0, 1, 2}:
        fail(f"8c: the views did not cover the three principal axes: "
             f"{seen_axes}")
    del pipe, hist, vol
    torch.cuda.empty_cache()
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from vrdd_tpu_torch import cli
    from vrdd_tpu_torch.core.image import rgba_to_uint8
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.io import formats
    from vrdd_tpu_torch.io.synthetic import (
        blob_histogram_volume, gaussian_blob_volume, random_histogram_volume,
    )
    from vrdd_tpu_torch.kernels import _build
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.march.slice import slice_render_image
    from vrdd_tpu_torch.models.hist_renderer import HistRenderer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tf = default_transfer_function()
    origin = torch.tensor(ORIGIN)
    k1, k2 = sk.sweep_preblended_planes, sk.pallas_hist_render

    # ---- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {card}, "
          f"count {torch.cuda.device_count()}")
    print(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    print(f"[2] built {Path(info['path']).name} from "
          f"{', '.join(str(s.relative_to(ROOT)) for s in _build.SOURCES)} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line:
            print(f"  {line.strip()}")

    # ---- 3. kernels against plain versions at small shapes
    print("[3] kernel vs plain, small shapes")
    for shape, (W, H) in [((16, 24, 24), (100, 72)), ((64, 64, 64), (256, 256))]:
        vol = torch.from_numpy(gaussian_blob_volume(shape)).to(dev)
        for n_planes in (shape[0], 2 * shape[0]):
            for density in (0.05, 5.0):
                before = k1.launches
                got = sk.pallas_slice_render(vol, origin, tf, density,
                                             width=W, height=H,
                                             n_planes=n_planes)
                again = sk.pallas_slice_render(vol, origin, tf, density,
                                               width=W, height=H,
                                               n_planes=n_planes)
                ref = slice_render_image(vol, origin, W, H, tf, density,
                                         n_planes=n_planes)
                torch.cuda.synchronize()
                if k1.launches != before + 2:
                    fail("K1 launch counter did not advance")
                if not torch.equal(got, again):
                    fail("K1: two runs differ")
                compare(got, ref, f"K1 {shape}->{W}x{H} planes {n_planes} "
                        f"density {density}")
    for (nz, B, ny, nx), (W, H) in [((16, 8, 24, 24), (136, 96)),
                                    ((64, 16, 64, 64), (256, 256))]:
        h32 = torch.from_numpy(blob_hist(nz, B, ny, nx, seed=1)).to(dev)
        for stat in ("mean", "var", "entropy"):
            rows, mode = sk.decode_weight_rows(stat, B, family="unit")
            tscl = 10.0 if stat == "var" else 1.0
            for hist in (h32, h32.to(torch.bfloat16)):
                before = k2.launches
                kw = dict(transfer_scale=tscl, width=W, height=H, stat=mode)
                got = k2(hist, rows, origin, tf, 0.3, **kw)
                again = k2(hist, rows, origin, tf, 0.3, **kw)
                ref = sk.hist_render_reference(hist, rows, origin, tf, 0.3, **kw)
                torch.cuda.synchronize()
                if k2.launches != before + 2:
                    fail("K2 launch counter did not advance")
                if not torch.equal(got, again):
                    fail("K2: two runs differ")
                compare(got, ref, f"K2 {(nz, B, ny, nx)} {hist.dtype} "
                        f"{stat}->{W}x{H}")

    # ---- 3b. the training kernels against plain versions at small shapes
    phase_3b(dev, tf, origin)

    # ---- 4. the render-hist CLI on the card
    print("[4] render-hist CLI, 128^3 x 16 -> 512^2")
    work = _build.BUILD_DIR / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    n = 128
    hist_np = random_histogram_volume((n, n, n), n_bins=16, seed=0)
    hist_file = work / "hist128.bin"
    formats.write_raw_histograms(str(hist_file), hist_np.reshape(-1, 16))
    hist_dev = formats.read_histograms_bins_major(
        str(hist_file), (n, n, n), 16).to(dev)
    for stat in ("mean", "var", "entropy"):
        out = work / f"{stat}.ppm"
        tscl = "10" if stat == "var" else "1"
        before = k2.launches
        rc = cli.main([
            "render-hist", "--hist-file", str(hist_file), "--dims", str(n),
            str(n), str(n), "--bins", "16", "--width", "512", "--height",
            "512", "--stat", stat, "--tf-scale", tscl, "-o", str(out),
            "--device", "cuda",
        ])
        if rc != 0 or not out.exists() or k2.launches != before + 1:
            fail(f"render-hist {stat}: rc {rc}, written {out.exists()}")
        img = formats.read_ppm(str(out))
        rows, mode = sk.decode_weight_rows(stat, 16, family="unit")
        ref = rgba_to_uint8(sk.hist_render_reference(
            hist_dev, rows, torch.tensor([0.0, 0.0, 4.0]), tf, 0.05,
            transfer_scale=float(tscl), width=512, height=512, stat=mode,
        )).cpu().numpy()[..., :3]
        level = np.abs(img.astype(int) - ref.astype(int)).max(-1)
        off = float((level > 0).mean())
        print(f"  {stat}: {img.shape} PPM, max level diff {level.max()}, "
              f"pixels off {off:.4%}, mean level {img.mean():.2f}")
        if img.shape != (512, 512, 3) or level.max() > 1 or off > 5e-3:
            fail(f"render-hist {stat} disagrees with the plain version")
    del hist_dev

    # ---- 4b. the fit-hist CLI on the card
    phase_4b(work)
    shutil.rmtree(work)

    # ---- 5. full size: 512^3 x 16 bf16 -> 1024^2
    n, B, W = 512, 16, 1024
    print(f"[5] main path, {n}^3 x {B} bf16 -> {W}^2 on {card} ({smi})")
    hist = blob_histogram_volume(n, B, device=dev, dtype=torch.bfloat16)
    renderers = {}
    for stat in ("mean", "var", "entropy"):
        rows, mode = sk.decode_weight_rows(stat, B, family="unit")
        renderers[mode] = HistRenderer(
            tf, rows, stat=mode, width=W, height=W,
            transfer_scale=10.0 if stat == "var" else 1.0, device=dev,
        )
    mean_vol = sk.decode_with_rows(hist, renderers["linear"].rows, "linear")
    torch.cuda.synchronize()

    k1.launches = k2.launches = k1.staged_launches = k2.staged_launches = 0
    launches, staged, images = {}, {}, {}
    for mode, renderer in renderers.items():
        before = (k2.launches, k2.staged_launches)
        images[mode] = renderer(hist, origin)
        launches[mode] = k2.launches - before[0]
        staged[mode] = k2.staged_launches - before[1]
    images["k1"] = sk.pallas_slice_render(mean_vol, origin, tf, width=W,
                                          height=W, n_planes=n)
    torch.cuda.synchronize()
    launches["k1"], staged["k1"] = k1.launches, k1.staged_launches
    print(f"  launches in the main-path run: K1 {k1.launches}, K2 "
          f"{k2.launches} {launches}; on the staged path {staged}")
    if k1.launches == 0 or any(launches[m] == 0 for m in renderers):
        fail("a kernel of the main path was not launched")
    if staged != launches:
        fail(f"the forward main path did not run on the staged path: {staged}")
    with sk._fetch_path(False):  # the direct path's images, bit for bit
        bitwise(sk.pallas_slice_render(mean_vol, origin, tf, width=W,
                                       height=W, n_planes=n), images["k1"],
                "K1 staged vs direct")
        for mode, renderer in renderers.items():
            bitwise(renderer(hist, origin), images[mode],
                    f"K2 {mode} staged vs direct")
    for name, img in images.items():
        if img.shape != (W, W, 4) or not torch.isfinite(img).all():
            fail(f"{name}: bad output")
        if float(img[..., 3].max()) <= 0.0:
            fail(f"{name}: empty image")

    records = []
    for mode, renderer in renderers.items():
        kw = dict(transfer_scale=renderer.transfer_scale, width=W, height=W,
                  stat=mode)

        def plain(mode=mode, kw=kw):
            return sk.hist_render_reference(hist, renderer.rows, origin, tf,
                                            **kw)

        ref = plain()
        err = compare(images[mode], ref, f"K2 {mode}")
        del ref
        ms, direct_ms = paths_ms(
            lambda st, r=renderer: on_path(st, lambda: r(hist, origin)))
        plain_ms = time_ms(plain, 1)
        zs, slopes, _ = sk._hist_geometry(n, W, W, 2.0, renderer.march)
        n_live, n_texels = live_samples(
            sk.decode_with_rows(hist, renderer.rows, mode), zs, slopes, tf,
            0.05, 0.0, renderer.transfer_scale, W, W, reverse=True)
        bd = bound(n_texels * B * hist.element_size() + W * W * 16,
                   n_live * (SAMPLE_OPS + decode_ops(mode, B)))
        print(f"  K2 {mode}: staged {ms:.3f} ms ({W * W / ms / 1e3:.2f} "
              f"Mrays/s), direct {direct_ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"({W * W / plain_ms / 1e3:.2f} Mrays/s), bound "
              f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}; {n_live} "
              f"evaluated samples, {n_texels} voxels read)")
        records.append({
            "name": f"pallas_hist_render[{mode}]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_kernel.py:1595",
            "launches": launches[mode], "staged_launches": staged[mode],
            "max_abs_err": err, "ms": ms, "direct_ms": direct_ms,
            "plain_ms": plain_ms, **bd,
        })

    def plain_k1():
        return slice_render_image(mean_vol, origin, W, W, tf, n_planes=n)

    ref = plain_k1()
    err = compare(images["k1"], ref, "K1 (decoded mean, n_planes = nz)")
    del ref
    ms, direct_ms = paths_ms(lambda st: on_path(st, lambda: sk.pallas_slice_render(
        mean_vol, origin, tf, width=W, height=W, n_planes=n)))
    plain_ms = time_ms(plain_k1, 1)
    zs, slopes, _ = sk._hist_geometry(n, W, W, 2.0, renderers["linear"].march)
    n_live, n_texels = live_samples(mean_vol, zs, slopes, tf, 0.05, 0.0, 1.0,
                                    W, W, reverse=True)
    bd = bound(n_texels * 4 + W * W * 16, n_live * SAMPLE_OPS)
    print(f"  K1: staged {ms:.3f} ms ({W * W / ms / 1e3:.2f} Mrays/s), direct "
          f"{direct_ms:.3f} ms, plain {plain_ms:.3f} ms ({W * W / plain_ms / 1e3:.2f} Mrays/s), bound "
          f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}; {n_live} evaluated "
          f"samples, {n_texels} texels read)")
    records.insert(0, {
        "name": "sweep_preblended_planes", "route": "cuda",
        "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
        "replaces": "vrdd_tpu/pallas/slice_kernel.py:1351",
        "launches": launches["k1"], "staged_launches": staged["k1"],
        "max_abs_err": err, "ms": ms, "direct_ms": direct_ms,
        "plain_ms": plain_ms, **bd,
    })
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del mean_vol

    # ---- 6. the training main path at full size
    records += phase_6(dev, card, smi, hist, tf, origin, n, B, W)
    del hist
    torch.cuda.empty_cache()

    # ---- 7. the render path
    work.mkdir(parents=True)
    records += phase_7(dev, card, smi, tf, work)

    # ---- 8. BASELINE config 3 (fit-voxels) and rotated views
    records += phase_8(dev, card, smi, tf, work)
    shutil.rmtree(work)

    # ---- result
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
