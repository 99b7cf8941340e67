#!/usr/bin/env python3
"""Hold this checkout's ESS and forward sweeps against another checkout's,
on one NVIDIA GPU: K1/K3 with ESS, the ESS bitmap kernel, the frames that
take ESS, and the forward sweeps without it.

    python3 tools/ab_ess.py --other DIR [--pairs 5] [--runs 20]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Both trees build their kernels (concurrently), then one worker
process per turn imports one tree's ``vrdd_tpu_torch`` through its public
entry points only, so that a tree whose sweeps take a precomputed bitmap
(one launch of ``csrc/ess_bitmap.cu``, then the sweep) runs against one
whose sweeps test ESS themselves. ``pairs`` pairs of turns, which tree
goes first alternating (other, this, this, other, ...). Each turn
measures, at
``chip_smoke.py``'s shapes:

- 7b (a smooth 256^3 x 32 raw volume -> 1024^2, 512 pre-blended planes,
  chunks of 8), queries 1, 2, 3 and 7: the ``RenderPipeline`` frame
  (host clock, median of ``runs``); K1 with ESS from cached plane stats
  on both fetch paths: ``call_ms`` (one call between CUDA events on an
  idle device, median), ``stream_ms`` (``runs`` calls back to back between
  two events, over ``runs``), ``host_ms`` (their enqueue on the host
  clock, over ``runs``) and ``sweep_ms`` / ``bitmap_ms`` (the device time
  of the sweep and of the bitmap kernel in one profiled call); the
  standalone bitmap (``ess_bitmap``): its raw ``vrdd_ess_bitmap`` launch
  back to back (``device_ms``), its wrapper's enqueue (``wrapper_host_ms``)
  and one wrapper call between events (``wrapper_event_ms``);
- 7b diff (query 1's channel, 512 planes in chunks of 4): K3 with ESS as
  ``pallas_slice_render_diff`` resolves it each call, then ``sweep_fwd``
  (and K4's image, checkpoints and live map with ESS, compared);
- the forward sweeps without ESS, both fetch paths (``call_ms``,
  ``stream_ms`` and the profiled ``sweep_ms``, as above): K1 and
  K1 seeded on 7b's query-1 planes; K3 and K4 on the 7b diff planes, plain
  and seeded; K2 mean, var and entropy and K3 / K4 mean decoding in the
  kernel, on ``blob_histogram_volume(512, 16, bf16)`` -> 1024^2;
- 9b's query-9 frame (Isabel's 500 x 500 x 100 raw volume in flexible
  blocks of 4 -> 1024^2) and 12e's viewer frame (Isabel's 50 x 50 x 10 x
  32 blocks -> 512^2, query 1, the uint8 render), host clock, with the
  sweep's and the bitmap's device time of one profiled frame;
- ``nvcc``'s register, stack and spill lines of every sweep kernel
  instance (``_build.build()["log"]``).

Prints the card's name and power limit, a line per measurement (each
tree's median over its turns, the range, and in how many pairs this tree
read lower), then one JSON line. Exits non-zero when an image differs between
the trees (ESS is bitwise the render without it on both), or without a
GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ORIGIN = (0.0, 0.0, 4.0)


def smooth_raw_histograms(n, B, dev, seed=0):
    """``chip_smoke.py``'s 7b volume: ``(n, n, n, B)`` float32 raw
    histograms, per block a softmax over the bins around a smooth mean field
    of four Gaussian blobs drawn from ``seed`` (empty space where the field
    is 0)."""
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


def instance(mangled: str):
    """``direct<MODE,T,CKPT[,ESS]>`` / ``staged<...>`` of a sweep kernel's
    mangled name, or None for another function."""
    m = re.search(r"slice_sweep_(kernel|staged)ILi(\d)E(f|13__nv_bfloat16)"
                  r"Lb(\d)E(?:Lb(\d)E)?", mangled)
    if m is None:
        return None
    path, mode, t, ckpt, ess = m.groups()
    args = [mode, "f32" if t == "f" else "bf16", f"ckpt{ckpt}"]
    args += [] if ess is None else [f"ess{ess}"]
    return ("direct" if path == "kernel" else "staged") + f"<{','.join(args)}>"


def ptxas_lines(log: str) -> dict:
    """Registers, stack frame and spill bytes of every sweep kernel
    instance in ``nvcc -Xptxas -v``'s log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = instance(m.group(1))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def worker(tree: Path, runs: int) -> None:
    sys.path.insert(0, str(tree))
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vrdd_tpu_torch.core.geometry import (
        default_benchmark_inv_view, inv_view_from_rotation_translation)
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.io.synthetic import (
        blob_histogram_volume, gaussian_blob_volume, random_histogram_volume)
    from vrdd_tpu_torch.kernels import _build
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import preblend_planes
    from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.renderer import interp_mean_volume
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, MarchConfig, QueryMethod, RenderConfig,
        TransferFunctionConfig, query_channel)

    assert Path(sk.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    rec, hashes = {}, {}

    def digest(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    def kernel_ms(fn):
        """Device ms of the sweep and the bitmap kernels in one call."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {"sweep_ms": 0.0, "bitmap_ms": 0.0}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", 0.0) / 1e3
            if "slice_sweep" in e.key:
                out["sweep_ms"] += t
            elif "ess_bitmap" in e.key:
                out["bitmap_ms"] += t
        return out

    def call_ms(fn):
        """Median of ``runs`` calls, each between two CUDA events on an
        idle device."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = []
        for _ in range(runs):
            start.record()
            fn()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end))
        return sorted(t)[len(t) // 2]

    def stream(fn):
        """``runs`` calls back to back: (events, host clock) over runs."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(runs):
            fn()
        host = 1e3 * (time.perf_counter() - t0) / runs
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / runs, host

    def host_ms(fn, n=runs):
        """Median of ``n`` calls on the host clock, each synchronized."""
        fn()
        torch.cuda.synchronize()
        t = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(1e3 * (time.perf_counter() - t0))
        return sorted(t)[len(t) // 2]

    def on_path(staged, fn):
        def run():
            with sk._fetch_path(staged):
                return fn()
        return run

    def paths_ms(fn):
        """Per fetch path: one call (events, median), ``runs`` calls back
        to back (events, over runs) and the sweep's device time (one
        profiled call)."""
        out = {}
        for path, staged in (("staged", True), ("direct", False)):
            f = on_path(staged, fn)
            out[path] = {"call_ms": call_ms(f), "stream_ms": stream(f)[0],
                         "sweep_ms": kernel_ms(f)["sweep_ms"]}
        return out

    tf = default_transfer_function()
    tf_dev = torch.as_tensor(tf, device=dev)
    march = MarchConfig()
    n, B, W, P = 256, 32, 1024, 512
    slopes = sk.pixel_slope_params(W, W)
    iv = default_benchmark_inv_view()
    pipe = RenderPipeline(raw=RawHistogramVolume(
        smooth_raw_histograms(n, B, dev)))

    # ---- 7b: frames, K1 with ESS, the bitmap
    for q in (1, 2, 3, 7):
        cfg = RenderConfig(camera=CameraConfig(width=W, height=W),
                           query_method=QueryMethod(q),
                           tf=TransferFunctionConfig(
                               scale=6.0 if q == 2 else 1.0))
        tscl, toff = cfg.tf.scale, 0.0 if q == 7 else 0.5
        frame = lambda cfg=cfg: pipe.render(iv, cfg, "auto")  # noqa: E731
        hashes[f"7b q{q} frame"] = digest(frame())
        r = {"frame_ms": host_ms(frame, 5),
             "frame_kernels": kernel_ms(frame)}
        vol = (interp_mean_volume(pipe.raw.histograms) if q == 7 else
               pipe.raw_stats[..., query_channel(QueryMethod(q))]
               .contiguous())
        stats = sk.precompute_ess_stats(vol, n_planes=P, march=march,
                                        tex_offset=toff)
        planes, zs = preblend_planes(vol, P, march.box_min, march.box_max,
                                     -1, toff)
        zs_dev = torch.as_tensor(zs, device=dev)

        def k1(culled=True, planes=planes, zs=zs, stats=stats, tscl=tscl,
               toff=toff, seed=None):
            return sk.sweep_preblended_planes(
                planes, zs, ORIGIN, slopes, tf, 0.05, 1.0, 0.0, tscl,
                width=W, height=W, tex_offset=toff,
                empty_space_skip=culled,
                ess_stats=stats if culled else None, acc_init=seed)

        for path, staged in (("staged", True), ("direct", False)):
            fn = on_path(staged, k1)
            hashes[f"7b q{q} K1 ESS {path}"] = digest(fn())
            s_ms, h_ms = stream(fn)
            r[f"k1_ess_{path}"] = {"call_ms": call_ms(fn), "stream_ms": s_ms,
                                   "host_ms": h_ms, **kernel_ms(fn)}
        # the standalone bitmap: the raw launch, the wrapper
        kw = dict(width=W, height=W, ny=n, nx=n, plane_chunk=8, march=march,
                  tex_offset=toff)
        wrapper = lambda: sk.ess_bitmap(  # noqa: E731
            stats, zs_dev, ORIGIN, slopes, tf_dev, 0.0, tscl, **kw)
        ref = wrapper()
        ox, oy, oz = sk._host_floats(ORIGIN, 3)
        mx0, dmx, my0, dmy = sk._host_floats(slopes, 4)
        p = _build.EssParams(
            ox=ox, oy=oy, oz=oz, mx0=mx0, dmx=dmx, my0=my0, dmy=dmy,
            xlo=march.box_min[0], xhi=march.box_max[0],
            ylo=march.box_min[1], yhi=march.box_max[1], tex_offset=toff,
            sx=1.0, sy=1.0, tf_off=0.0, tf_scale=tscl,
            q_margin=sk._ESS_Q_MARGIN, n_planes=P, plane_chunk=8, height=W,
            width=W, tile_h=sk.ESS_TILE[0], tile_w=sk.ESS_TILE[1], ny=n,
            nx=n, n_lut=len(tf), n_by=8, n_bx=8)
        pmin, pmax = (t.contiguous() for t in stats)
        raw = torch.empty_like(ref)
        lib = _build.library()
        cuda_stream = torch.cuda.current_stream().cuda_stream

        def launch(p=p, pmin=pmin, pmax=pmax, raw=raw):
            rc = lib.vrdd_ess_bitmap(p, pmin.data_ptr(), pmax.data_ptr(),
                                     zs_dev.data_ptr(), tf_dev.data_ptr(),
                                     raw.data_ptr(), cuda_stream)
            if rc:
                raise RuntimeError(f"vrdd_ess_bitmap: CUDA error {rc}")

        launch()
        hashes[f"7b q{q} bitmap"] = digest(ref)
        if digest(raw) != hashes[f"7b q{q} bitmap"]:
            raise RuntimeError("the raw bitmap launch differs from the "
                               "wrapper's")
        r["bitmap"] = {"device_ms": stream(launch)[0],
                       "wrapper_host_ms": stream(wrapper)[1],
                       "wrapper_event_ms": call_ms(wrapper),
                       "culled": float((ref == 0).float().mean())}
        if q == 1:  # the forward sweeps without ESS
            img = k1(False)
            hashes["K1"] = digest(img)
            seed = (0.5 * img).contiguous()
            r["k1"] = paths_ms(lambda: k1(False))
            r["k1_seed"] = paths_ms(lambda: k1(False, seed=seed))
            hashes["K1 seed"] = digest(k1(False, seed=seed))
        rec[f"7b q{q}"] = r
        del planes, stats, vol

    # ---- 7b diff: K3 with ESS resolved per call, K3 / K4 without
    vol = pipe.raw_stats[..., query_channel(QueryMethod(1))].contiguous()
    planes, zs = preblend_planes(vol, P, march.box_min, march.box_max, -1)
    cfg = sv.planes_config(zs, ORIGIN, slopes, width=W, height=W, n_planes=P,
                           plane_chunk=4)
    args = (planes, None, tf_dev, torch.tensor(0.05, device=dev),
            torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev))

    def ess_cfg():
        return dataclasses.replace(cfg, ess=sk._resolve_ess(
            True, None, planes, zs, ORIGIN, slopes, tf_dev, 0.0, 1.0,
            width=W, height=W, plane_chunk=4, march=march, tex_offset=0.5,
            axis_scale=(1.0, 1.0), reverse_planes=False))

    def k3_ess():
        return sv.sweep_fwd(ess_cfg(), *args)

    for name, t in zip(("image", "checkpoints", "live map"),
                       sv.sweep_fwd_ckpt(ess_cfg(), *args, live_map=True)):
        hashes[f"7b diff K4 ESS {name}"] = digest(t)

    img = sv.sweep_fwd(cfg, *args)
    seed = (0.5 * img).contiguous()
    r = {}
    for path, staged in (("staged", True), ("direct", False)):
        fn = on_path(staged, k3_ess)
        hashes[f"7b diff K3 ESS {path}"] = digest(fn())
        s_ms, h_ms = stream(fn)
        r[f"k3_ess_{path}"] = {"call_ms": call_ms(fn), "stream_ms": s_ms,
                               "host_ms": h_ms, **kernel_ms(fn)}
    hashes["K3"], hashes["K4"] = digest(img), digest(
        sv.sweep_fwd_ckpt(cfg, *args)[1])
    hashes["K3 seed"] = digest(sv.sweep_fwd(cfg, *args, seed))
    r["k3"] = paths_ms(lambda: sv.sweep_fwd(cfg, *args))
    r["k4"] = paths_ms(lambda: sv.sweep_fwd_ckpt(cfg, *args))
    r["k3_seed"] = paths_ms(lambda: sv.sweep_fwd(cfg, *args, seed))
    r["k4_seed"] = paths_ms(lambda: sv.sweep_fwd_ckpt(cfg, *args, seed))
    rec["7b diff"] = r
    del planes, vol, pipe, img, seed
    torch.cuda.empty_cache()

    # ---- K2 and K3 / K4 decoding in the kernel: 512^3 x 16 bf16 -> 1024^2
    hist = blob_histogram_volume(512, 16, device=dev, dtype=torch.bfloat16)
    r = {}
    for stat in ("mean", "var", "entropy"):
        rows, mode = sk.decode_weight_rows(stat, 16, family="unit")
        tscl = 10.0 if stat == "var" else 1.0

        def k2(rows=rows, mode=mode, tscl=tscl):
            return sk.pallas_hist_render(hist, rows, ORIGIN, tf, 0.05,
                                         transfer_scale=tscl, width=W,
                                         height=W, stat=mode)

        hashes[f"K2 {stat}"] = digest(k2())
        r[f"k2_{stat}"] = paths_ms(k2)
        if stat == "mean":
            hcfg = sv.render_config(hist.shape, ORIGIN, stat=mode, width=W,
                                    height=W)
            hargs = (hcfg, hist, torch.as_tensor(rows, device=dev), tf_dev,
                     torch.tensor(0.05, device=dev),
                     torch.tensor(0.0, device=dev),
                     torch.tensor(1.0, device=dev))
            r["k3_mean"] = paths_ms(lambda: sv.sweep_fwd(*hargs))
            r["k4_mean"] = paths_ms(lambda: sv.sweep_fwd_ckpt(*hargs))
            hashes["K4 mean"] = digest(sv.sweep_fwd_ckpt(*hargs)[1])
    rec["hist512"] = r
    del hist
    torch.cuda.empty_cache()

    # ---- 9b: query 9's frame on the flexible blocks of Isabel's raw volume
    raw = gaussian_blob_volume((100, 500, 500), seed=7, device=dev) * 255.0
    flex = FlexibleBlockVolume.from_raw(raw, block_size=4, vmax=256.0)
    del raw
    fpipe = RenderPipeline(flexible=flex.normalized())
    cfg9 = RenderConfig(camera=CameraConfig(width=W, height=W), density=0.05,
                        query_method=QueryMethod(9))
    frame = lambda: fpipe.render(iv, cfg9, "auto")  # noqa: E731
    hashes["9b q9 frame"] = digest(frame())
    rec["9b q9"] = {"frame_ms": host_ms(frame, 5),
                    "frame_kernels": kernel_ms(frame)}
    del fpipe, flex
    torch.cuda.empty_cache()

    # ---- 12e: the viewer's frame
    vpipe = RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(
        random_histogram_volume((10, 50, 50), n_bins=32, seed=0)).to(dev)))
    cfg = RenderConfig(camera=CameraConfig(width=512, height=512),
                       density=0.5, query_method=QueryMethod(1))
    viv = inv_view_from_rotation_translation(0.0, 0.0, (0.0, 0.0, -4.0))
    frame = lambda: vpipe.render(viv, cfg, "auto", as_uint8=True)  # noqa: E731
    hashes["12e frame"] = digest(frame())
    rec["12e"] = {"frame_ms": host_ms(frame, runs),
                  "frame_kernels": kernel_ms(frame)}
    print(json.dumps({"rec": rec, "hashes": hashes}))


def build(tree: Path) -> subprocess.Popen:
    """Build ``tree``'s kernels in a process of its own, which prints the
    sweep instances' ptxas lines as its last line."""
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--other", str(tree),
         "--build", str(tree)], cwd=tree, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def flat(rec, prefix=""):
    """``{"a b c": number}`` of a nested record."""
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k} "))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = float(v)
    return out


def median(xs):
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else (xs[m - 1] + xs[m]) / 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        worker(a.worker, a.runs)
        return 0
    if a.build is not None:
        sys.path.insert(0, str(a.build))
        from vrdd_tpu_torch.kernels import _build

        info = _build.build()
        print(json.dumps({"seconds": info["seconds"],
                          "ptxas": ptxas_lines(info["log"])}))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_ess: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    trees = {"other": a.other.resolve(), "this": HERE}
    procs = {k: build(t) for k, t in trees.items()}
    builds = {}
    for k, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(f"build of {k} failed:\n{log}", file=sys.stderr)
            return 1
        builds[k] = json.loads(log.strip().splitlines()[-1])
    turns = {"other": [], "this": []}
    order = [k for i in range(a.pairs)
             for k in (("other", "this") if i % 2 == 0 else ("this", "other"))]
    for turn, key in enumerate(order):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--other",
             str(a.other), "--worker", str(trees[key]), "--runs",
             str(a.runs)], cwd=trees[key], capture_output=True, text=True)
        if res.returncode != 0:
            print(f"turn {turn} ({key}) failed:\n{res.stdout}\n{res.stderr}",
                  file=sys.stderr)
            return 1
        turns[key].append(json.loads(res.stdout.strip().splitlines()[-1]))
    runs = {k: [flat(t["rec"]) for t in v] for k, v in turns.items()}
    summary = {}
    for key in runs["this"][0]:
        o = [r[key] for r in runs["other"] if key in r]
        t = [r[key] for r in runs["this"]]
        if len(o) != len(t):
            continue
        summary[key] = {"other": median(o), "this": median(t),
                        "other_range": [min(o), max(o)],
                        "this_range": [min(t), max(t)],
                        "this_lower": sum(y < x for x, y in zip(o, t))}
        s = summary[key]
        print(f"{key}: {s['other']:.4f} [{min(o):.4f}-{max(o):.4f}] / "
              f"{s['this']:.4f} [{min(t):.4f}-{max(t):.4f}], this lower in "
              f"{s['this_lower']} of {len(t)} pairs")
    hashes = {k: [t["hashes"] for t in turns[k]] for k in turns}
    differ = sorted(k for k in hashes["this"][0]
                    if len({h.get(k) for hs in hashes.values()
                            for h in hs}) != 1)
    for k, b in builds.items():
        spill = {e: v for e, v in b["ptxas"].items() if v.get("stack")}
        print(f"{k}: build {b['seconds']:.1f} s, {len(b['ptxas'])} sweep "
              f"instances, with a stack frame: {spill}")
    print(f"images differing between turns or trees: {differ or 'none'}")
    print(json.dumps({"card": smi, "turns": order, "summary": summary,
                      "builds": builds, "per_turn": runs,
                      "images_differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
