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
   evaluation render without gradients; launch counters reset before and
   read after each; gradients against the plain analytic VJP (1e-3
   relative L2); fwd+bwd and each of K3/K4/K5 timed against its plain
   version.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a GPU it exits with an error and
prints no result. Needs nothing but the repository, torch, numpy, nvcc.
"""

from __future__ import annotations

import json
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


def rel_l2(got, ref, what):
    """Relative L2 error, summed a few z-layers at a time in float64 (the
    full-size histogram cotangents are 2^31 values); fails past GRAD_TOL."""
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
    if err > GRAD_TOL or den == 0.0:
        fail(f"{what}: rel L2 {err:.3e} (limit {GRAD_TOL:g}, ref norm^2 {den})")
    return err


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
    records = []
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
            c.launches = 0
        with torch.no_grad():
            img3 = render(hist, lut0)
        loss, img, gh, gl = fwd_bwd()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        print(f"  [{tag}] launches in the main-path run: {launches}, loss "
              f"{float(loss.detach()):.6f}")
        if any(v == 0 for v in launches.values()):
            fail(f"{tag}: a kernel of the training path was not launched")
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
        ms = time_ms(fwd_bwd, TIMED_RUNS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  [{tag}] fwd+bwd: kernels {ms:.3f} ms ({W * W / ms / 1e3:.2f}"
              f" Mrays/s), plain {plain_ms:.3f} ms "
              f"({W * W / plain_ms / 1e3:.2f} Mrays/s), peak "
              f"{peak:.2f} GiB")

        # each kernel alone, against its plain version on the same inputs
        inkernel = route == "inkernel"
        vol = hist if inkernel else sk.decode_with_rows(hist, rows, mode)
        cfg = sv.render_config(vol.shape, origin, stat=mode if inkernel
                               else "none", width=W, height=W)
        rows_t = torch.as_tensor(rows, device=dev) if inkernel else None
        args = (cfg, vol, rows_t, lut0,
                torch.tensor(0.05, device=dev), torch.tensor(0.0, device=dev),
                torch.tensor(tscl, device=dev))
        k3_ms = time_ms(lambda: sv.sweep_fwd(*args), TIMED_RUNS)
        k3_plain_ms, ref3 = timed_once(lambda: sv.sweep_fwd_reference(*args))
        k3_err = compare(sv.sweep_fwd(*args), ref3, f"[{tag}] K3 image")
        img4, tck = sv.sweep_fwd_ckpt(*args)
        k4_ms = time_ms(lambda: sv.sweep_fwd_ckpt(*args), TIMED_RUNS)
        k4_plain_ms, (ref4, tck_ref) = timed_once(
            lambda: sv.sweep_fwd_ckpt_reference(*args))
        k4_err = compare(img4, ref4, f"[{tag}] K4 image")
        compare(tck[..., None], tck_ref[..., None], f"[{tag}] K4 checkpoints")
        g = (2.0 / img4.numel()) * (img4 - 0.25)  # d loss / d image
        flags = (True, True, False)
        k5_ms = time_ms(lambda: sv.sweep_bwd(*args, g, tck, *flags),
                        TIMED_RUNS)
        d_k, small_k, _ = sv.sweep_bwd(*args, g, tck, *flags)
        k5_plain_ms, (d_r, small_r, _) = timed_once(
            lambda: sv.sweep_bwd_reference(*args, g, *flags))
        rel_l2(d_k, d_r, f"[{tag}] K5 d_planes")
        rel_l2(small_k, small_r, f"[{tag}] K5 d_lut")
        k5_err = float((d_k - d_r).abs().max())
        del vol, ref3, img4, tck, ref4, tck_ref, d_k, d_r
        for name, src, line, k_ms, p_ms, e in (
            ("sweep_fwd", "slice_sweep.cu", 698, k3_ms, k3_plain_ms, k3_err),
            ("sweep_fwd_ckpt", "slice_sweep.cu", 714, k4_ms, k4_plain_ms,
             k4_err),
            ("sweep_bwd", "slice_vjp.cu", 787, k5_ms, k5_plain_ms, k5_err),
        ):
            print(f"  [{tag}] {name}: kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms, max_abs_err {e:.3e}")
            records.append({
                "name": f"{name}[{tag}]", "route": "cuda",
                "source": f"vrdd_tpu_torch/csrc/{src}",
                "replaces": f"vrdd_tpu/pallas/slice_vjp.py:{line}",
                "launches": launches[name], "max_abs_err": e, "ms": k_ms,
                "plain_ms": p_ms,
            })
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

    k1.launches = 0
    k2.launches = 0
    launches, images = {}, {}
    for mode, renderer in renderers.items():
        before = k2.launches
        images[mode] = renderer(hist, origin)
        launches[mode] = k2.launches - before
    images["k1"] = sk.pallas_slice_render(mean_vol, origin, tf, width=W,
                                          height=W, n_planes=n)
    torch.cuda.synchronize()
    launches["k1"] = k1.launches
    print(f"  launches in the main-path run: K1 {k1.launches}, K2 "
          f"{k2.launches} {launches}")
    if k1.launches == 0 or any(launches[m] == 0 for m in renderers):
        fail("a kernel of the main path was not launched")
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
        ms = time_ms(lambda r=renderer: r(hist, origin), TIMED_RUNS)
        plain_ms = time_ms(plain, 1)
        print(f"  K2 {mode}: kernel {ms:.3f} ms ({W * W / ms / 1e3:.2f} "
              f"Mrays/s), plain {plain_ms:.3f} ms "
              f"({W * W / plain_ms / 1e3:.2f} Mrays/s)")
        records.append({
            "name": f"pallas_hist_render[{mode}]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_kernel.py:1595",
            "launches": launches[mode], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
        })

    def plain_k1():
        return slice_render_image(mean_vol, origin, W, W, tf, n_planes=n)

    ref = plain_k1()
    err = compare(images["k1"], ref, "K1 (decoded mean, n_planes = nz)")
    del ref
    ms = time_ms(lambda: sk.pallas_slice_render(
        mean_vol, origin, tf, width=W, height=W, n_planes=n), TIMED_RUNS)
    plain_ms = time_ms(plain_k1, 1)
    print(f"  K1: kernel {ms:.3f} ms ({W * W / ms / 1e3:.2f} Mrays/s), plain "
          f"{plain_ms:.3f} ms ({W * W / plain_ms / 1e3:.2f} Mrays/s)")
    records.insert(0, {
        "name": "sweep_preblended_planes", "route": "cuda",
        "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
        "replaces": "vrdd_tpu/pallas/slice_kernel.py:1351",
        "launches": launches["k1"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
    })
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del mean_vol

    # ---- 6. the training main path at full size
    records += phase_6(dev, card, smi, hist, tf, origin, n, B, W)

    # ---- 7. result
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
