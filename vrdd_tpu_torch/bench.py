"""The port's benchmark (counterpart of the root ``bench.py``): every section
of the JAX harness, timed on one NVIDIA GPU through the CUDA kernels, against
the H100's own roofline.

    python -m vrdd_tpu_torch.bench [--sections ...] [--full]
    python -m vrdd_tpu_torch.cli bench --device cpu --size 16 --image 32 \\
        --iters 1 --sections headline,decode     # a CPU rehearsal

Headline: Mrays/s of the forward+backward at BASELINE.json config 5, a 512^3
x 16-bin bf16 distribution volume (bins-major histograms, 4.3 GB) rendered to
1024^2 with gradients to the histograms and the transfer-function LUT, both
routes of ``pallas_hist_render_diff``; the faster is ``value`` and
``hist512_fwdbwd_route`` names it. ``vs_baseline`` compares the 512^2
forward MTexels/s over the Isabel-shaped volume with the reference's 60 fps
at 512^2 (15.73 MTexels/s on a Quadro K5000).

Timing (:func:`time_amortized`): one warm-up call, then ``iters`` calls back
to back on the host clock, ending in ``torch.cuda.synchronize()``; the
minimum over ``repeats``. The headline keys also read CUDA events around the
same loop (which holds the device's idle gaps too) and the kernels' time
in one profiled call (:func:`device_busy_s`): the host clock's excess over
it is host time the device waits for. The port runs eagerly, so the host
time of each call (the torch glue between the kernels) is part of every
number.

On ``--device cuda`` (the default; it raises without a GPU) every section
runs the kernels: a shape they do not take raises, nothing falls back to
the plain versions, and a section that fails ends the run with the lines
already printed left standing. ``--device cpu`` runs the plain versions:
the record then says ``"device": "cpu"`` and its metric begins with ``cpu
rehearsal``. Shares of the roofline are written only for a run on the card.

Output: notes on stderr; after every measurement, on stdout, the full
merged record (JAX's keys where the port has them) and then a compact
summary of under 1500 characters, so the last line is always the summary
and the line before it the full record.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from vrdd_tpu_torch.utils import roofline as rl

REFERENCE_MTEXELS_PER_S = 60.0 * 512 * 512 / 1e6  # 15.73, presentation.pdf
SECTIONS = "headline,decode,dist,view,big,rot,scaling"
ORIGIN = (0.0, 0.0, 4.0)
#: keys of the last line besides ``sec_*_s``: the metric, and one number per
#: BASELINE config (1-2 the scalar volumes, 3 Gaussian, 4 16-bin histograms,
#: 5 ``value``)
SUMMARY_KEYS = ("metric", "value", "unit", "hist512_fwdbwd_route",
                "vs_baseline", "device", "scalar512_fwdbwd_mrays",
                "gaussian_decode_fwdbwd_mrays", "hist16_decode_fwdbwd_mrays")
#: the launch counters of the kernels of the bench's path: (name, wrapper
#: module, wrapper, counter); the run's counts close its record
KERNELS = (
    ("K1", "slice_kernel", "sweep_preblended_planes", "launches"),
    ("K1 ESS", "slice_kernel", "sweep_preblended_planes", "ess_launches"),
    ("K2", "slice_kernel", "pallas_hist_render", "launches"),
    ("K3", "slice_vjp", "sweep_fwd", "launches"),
    ("K4", "slice_vjp", "sweep_fwd_ckpt", "launches"),
    ("K5", "slice_vjp", "sweep_bwd", "launches"),
    ("y-transpose", "slice_vjp", "dplane_bf16", "launches"),
)


def blob_volume(n: int, seed: int = 0) -> np.ndarray:
    """Memory-light float32 sum-of-gaussians volume (n, n, n); bit for bit
    the root ``bench.py``'s."""
    rng = np.random.default_rng(seed)
    z = np.linspace(0, 1, n, dtype=np.float32)
    vol = np.zeros((n, n, n), dtype=np.float32)
    for _ in range(3):
        c = rng.uniform(0.3, 0.7, size=3).astype(np.float32)
        s = np.float32(rng.uniform(0.1, 0.25))
        gz = np.exp(-((z - c[0]) ** 2) / (2 * s * s))
        gy = np.exp(-((z - c[1]) ** 2) / (2 * s * s))
        gx = np.exp(-((z - c[2]) ** 2) / (2 * s * s))
        vol += gz[:, None, None] * gy[None, :, None] * gx[None, None, :]
    vol /= vol.max()
    return vol


def blob_volume_device(n: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """:func:`blob_volume`'s gaussians made on ``device`` (host parameters
    only): at 1024^3 the host array would be 4 GB to upload."""
    rng = np.random.default_rng(seed)
    cs = [rng.uniform(0.3, 0.7, size=3).astype(np.float32) for _ in range(3)]
    ss = [np.float32(rng.uniform(0.1, 0.25)) for _ in range(3)]
    z = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    vol = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for c, s in zip(cs, ss):
        g = [torch.exp(-((z - float(ci)) ** 2) / float(2 * s * s)) for ci in c]
        vol += g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
    return vol / vol.max()


def hist_supported(n: int, W: int, tf) -> bool:
    from vrdd_tpu_torch.kernels.slice_kernel import hist_render_supported

    return hist_render_supported((n, 16, n, n), W, W, n_lut=len(tf))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_amortized(fn, dev, *, iters: int = 1, repeats: int = 1):
    """``(host_s, device_s)`` per call: one warm-up call, then ``iters``
    calls back to back on the host clock, ending in a synchronize; the
    minimum over ``repeats``. ``device_s`` is read by CUDA events around the
    same loop (None on the CPU): it holds the device's idle gaps too, so the
    two differ by what the host adds after the last launch."""
    fn()
    _sync(dev)
    host = device = float("inf")
    for _ in range(max(1, repeats)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if dev.type == "cuda":
            end.record()
        _sync(dev)
        host = min(host, time.perf_counter() - t0)
        if dev.type == "cuda":
            device = min(device, start.elapsed_time(end) / 1e3)
    return host / iters, (device / iters if dev.type == "cuda" else None)


def device_busy_s(fn, dev):
    """Seconds the device spends in kernels during one warm call of ``fn``:
    the sum of the kernel events of ``torch.profiler`` (one stream, so they
    add). The host clock's excess over it is the call's idle share: time
    the device waits for the host. None off the card, or where the profiler
    sees no kernel."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA)
    return busy / 1e6 if busy > 0 else None


def summary(out: dict) -> dict:
    """The last line: :data:`SUMMARY_KEYS` and the ``sec_*_s`` keys."""
    s = {k: out.get(k) for k in SUMMARY_KEYS}
    s.update({k: v for k, v in out.items() if k.startswith("sec_")})
    return s


def emit(out: dict) -> None:
    """Print the merged record and then its summary, each one JSON line,
    after every measurement: a run cut short still leaves its record."""
    print(json.dumps(out), flush=True)
    print(json.dumps(summary(out), separators=(",", ":")), flush=True)


def _peak_temp_mb(fn, dev):
    """MB the call allocates beyond what was allocated before it (its
    inputs): the peak of ``torch.cuda.max_memory_allocated()`` after
    ``reset_peak_memory_stats()``. None on the CPU."""
    if dev.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e6


def _lut(tf, dev, grad=False):
    lut = torch.as_tensor(np.asarray(tf, np.float32), device=dev)
    return lut.requires_grad_(grad)


def _density(i):
    """The per-iteration density: a scalar changed each call, as JAX's
    loop-carry (the volume itself is never perturbed)."""
    return 0.05 * (1.0 + 1e-6 * i)


def _loss(img):
    return torch.mean((img - 0.25) ** 2)


def _fwdbwd(render, leaves):
    """A step: ``render(i)`` -> image, its loss and the gradients of the
    loss to ``leaves``; returns the loss."""
    counter = itertools.count()

    def step():
        loss = _loss(render(next(counter)))
        torch.autograd.grad(loss, leaves)
        return loss.detach()
    return step


def _scalar_fwdbwd(vol, tf, dev, n, W):
    """The fwd+bwd step of the scalar ``vol`` (n^3) -> W^2, one plane per
    layer, with gradients to the volume and the LUT: the headline's scalar
    fwd+bwd and the roofline's measured time."""
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_slice_render_diff

    vol = vol.detach().requires_grad_()
    lut = _lut(tf, dev, grad=True)
    return _fwdbwd(lambda i: pallas_slice_render_diff(
        vol, ORIGIN, lut, density=_density(i), width=W, height=W,
        n_planes=n, wrt=("volume", "lut")), [vol, lut])


def _forward(render):
    counter = itertools.count()

    def step():
        with torch.no_grad():
            return render(next(counter)).sum()
    return step


# ---- the roofline ------------------------------------------------------

def roofline(vol, tf, *, W, dt_fwd=None, dt_fb=None, dt_ess=None,
             ess_stats=None, live=None, origin=ORIGIN):
    """The least time of the forward (K1) and of the fwd+bwd (K4 + K5) of
    the scalar ``(n, n, n)`` volume ``vol`` -> ``W^2`` with one plane per
    layer, and the measured times' shares of it (JAX ``roofline``,
    bench.py:60; the count is the port's,
    :mod:`vrdd_tpu_torch.utils.roofline`).

    Bytes: the volume texels the evaluated samples read, each once, the
    image written once (forward) or the volume cotangent written once
    (fwd+bwd; the checkpoints and the image are internal to it). Operations:
    the evaluated samples (in the box, before the cutoff) times
    ``SAMPLE_OPS``, and times ``SAMPLE_OPS + K5_SAMPLE_OPS`` for the
    fwd+bwd (K4's forward and K5's replay and reverse step). ``*_nocull`` counts every ray on every plane and the whole
    volume. ``dt_*`` in seconds; a share is None where its time is (a run
    off the card). ``ess_stats``: the cached ESS plane statistics of the
    ESS forward timed in ``dt_ess`` (its bound counts only the samples the
    bitmap keeps). ``live``: :func:`live_fractions`' dict, printed and
    recorded beside (JAX's culling effectivity)."""
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.utils.config import MarchConfig

    n = vol.shape[0]
    march = MarchConfig()
    zs, slopes, _ = sk._hist_geometry(n, W, W, 2.0, march)
    n_live, n_tex = rl.live_samples(vol, zs, slopes, tf, 0.05, 0.0, 1.0, W,
                                    W, reverse=True, origin=origin)
    vol_b, img_b, all_samples = n * n * n * 4, W * W * 16, W * W * n
    fb_ops = rl.SAMPLE_OPS + rl.K5_SAMPLE_OPS
    counts = {
        "fwd": (n_tex * 4 + img_b, n_live * rl.SAMPLE_OPS,
                vol_b + img_b, all_samples * rl.SAMPLE_OPS, dt_fwd),
        "fwdbwd": (n_tex * 4 + vol_b, n_live * fb_ops, 2 * vol_b,
                   all_samples * fb_ops, dt_fb),
    }
    out = {"roofline_samples": n_live, "roofline_texels": n_tex}
    for tag, (nb, nops, nb_all, nops_all, dt) in counts.items():
        b, b_all = rl.bound(nb, nops), rl.bound(nb_all, nops_all)
        out.update({
            f"roofline_{tag}_gb": nb / 1e9,
            f"roofline_{tag}_gop": nops / 1e9,
            f"roofline_{tag}_bound_ms": b["bound_ms"],
            f"roofline_{tag}_bound_by": b["bound_by"],
            f"roofline_{tag}_sol_frac": (None if dt is None
                                         else b["bound_ms"] / (1e3 * dt)),
            f"roofline_{tag}_sol_frac_nocull": (
                None if dt is None else b_all["bound_ms"] / (1e3 * dt)),
        })
    if ess_stats is not None:
        dev = vol.device
        ess = sk._resolve_ess(
            True, ess_stats, vol, sk._device_f32(zs, dev), origin, slopes,
            sk._device_f32(tf, dev), 0.0, 1.0, width=W, height=W,
            plane_chunk=8, march=march, tex_offset=0.5, axis_scale=(1.0, 1.0),
            reverse_planes=True).bitmap()
        e_live, e_tex = rl.live_samples(vol, zs, slopes, tf, 0.05, 0.0, 1.0,
                                        W, W, reverse=True, ess=ess,
                                        origin=origin)
        b = rl.bound(e_tex * 4 + img_b, e_live * rl.SAMPLE_OPS)
        out["roofline_fwd_ess_bound_ms"] = b["bound_ms"]
        out["roofline_fwd_sol_frac_ess"] = (None if dt_ess is None else
                                            b["bound_ms"] / (1e3 * dt_ess))
    if live:
        out["roofline_tile_live_frac"] = live["tile_live_frac"]
        out["roofline_strip_live_frac"] = live["strip_live_frac"]
    return out


def _roofline_note(r, card, dt_fwd, dt_fb, note):
    def share(x):
        return "not measured" if x is None else f"{100 * x:.1f}%"

    lines = [f"roofline (H100 SXM published peaks: HBM "
             f"{rl.HBM_BYTES_PER_S / 1e12:.2f} TB/s, FP32 "
             f"{rl.FP32_OPS_PER_S / 1e12:.0f} TFLOP/s; card {card}; "
             f"FP32 operations a sample: forward {rl.SAMPLE_OPS}, fwd+bwd "
             f"{rl.SAMPLE_OPS + rl.K5_SAMPLE_OPS}; "
             f"{r['roofline_samples']} evaluated samples, "
             f"{r['roofline_texels']} texels read"
             + (f"; live tiles {r['roofline_tile_live_frac']:.3f}, strips "
                f"{r['roofline_strip_live_frac']:.3f}"
                if "roofline_tile_live_frac" in r else "") + "):"]
    for tag, dt in (("fwd", dt_fwd), ("fwdbwd", dt_fb)):
        lines.append(
            f"  {tag:7s}: {r[f'roofline_{tag}_gb']:.3f} GB, "
            f"{r[f'roofline_{tag}_gop']:.1f} Gop -> bound "
            f"{r[f'roofline_{tag}_bound_ms']:.3f} ms "
            f"({r[f'roofline_{tag}_bound_by']}); measured "
            + ("not measured" if dt is None else f"{dt * 1e3:.3f} ms")
            + f" = {share(r[f'roofline_{tag}_sol_frac'])} of the bound "
            f"({share(r[f'roofline_{tag}_sol_frac_nocull'])} without "
            "culling)")
    if "roofline_fwd_sol_frac_ess" in r:
        lines.append(f"  fwd ESS: bound {r['roofline_fwd_ess_bound_ms']:.3f}"
                     f" ms = {share(r['roofline_fwd_sol_frac_ess'])}")
    note("\n".join(lines))


# ---- the record ----------------------------------------------------------

class Record:
    """A run's merged record: :meth:`update` merges keys and prints the
    record and its summary (:func:`emit`), :meth:`note` prints a line on
    stderr with the seconds since the run began."""

    def __init__(self, out=None):
        self.out = dict(out or {})
        self.t0 = time.perf_counter()

    def update(self, keys: dict) -> None:
        self.out.update(keys)
        emit(self.out)

    def note(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t0:7.1f}s] {msg}",
              file=sys.stderr, flush=True)


def _ms(dt):
    return "not measured" if dt is None else f"{dt * 1e3:.3f} ms"


# ---- sections ----------------------------------------------------------

def bench_headline(rec, dev, tf, *, n=512, W=1024, K=4, W0=512,
                   isabel_shape=(10, 50, 50), isabel_planes=200):
    """The Isabel-shaped 512^2 forward (``vs_baseline``), the metric (the
    n^3 x 16 bf16 distribution fwd+bwd, both routes, ``max(20, K)``
    iterations) and the scalar n^3 fwd+bwd (JAX bench.py:331-480)."""
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.kernels.slice_kernel import pallas_slice_render
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_hist_render_diff

    lut = _lut(tf, dev)
    rng = np.random.default_rng(0)
    isabel = torch.from_numpy(
        rng.random(isabel_shape, dtype=np.float32)).to(dev)
    fwd = _forward(lambda i: pallas_slice_render(
        isabel, ORIGIN, lut, density=_density(i), width=W0, height=W0,
        n_planes=isabel_planes, plane_chunk=20))
    dt, dt_dev = time_amortized(fwd, dev, iters=4 * K)
    mtex = W0 * W0 / dt / 1e6
    rec.note(f"forward {W0}^2 Isabel-shaped {isabel_shape[::-1]}: "
             f"{dt * 1e3:.3f} ms host, {_ms(dt_dev)} CUDA events, kernels "
             f"{_ms(device_busy_s(fwd, dev))} of a profiled call -> "
             f"{mtex:.2f} MTexels/s")
    rec.update({"vs_baseline": round(mtex / REFERENCE_MTEXELS_PER_S, 3),
                "forward_512_mtexels_per_s": round(mtex, 2)})

    KH = max(20, K)
    if not hist_supported(n, W, tf):
        raise ValueError(f"the kernels cannot take the headline {n}^3 x 16 "
                         f"-> {W}^2")
    h = blob_histogram_volume(n, 16, device=dev,
                              dtype=torch.bfloat16).requires_grad_()
    dwh = torch.as_tensor((np.arange(16) + 0.5) / 16, dtype=torch.float32,
                          device=dev)
    lut_g = _lut(tf, dev, grad=True)
    route_mrays = {}
    for route in ("materialized", "inkernel"):
        step = _fwdbwd(lambda i, route=route: pallas_hist_render_diff(
            h, dwh, ORIGIN, lut_g, density=_density(i), width=W, height=W,
            wrt=("hist", "lut"), route=route), [h, lut_g])
        dt, dt_dev = time_amortized(step, dev, iters=KH, repeats=2)
        busy = device_busy_s(step, dev)
        route_mrays[route] = W * W / dt / 1e6
        rec.note(f"fwd+bwd DISTRIBUTION {n}^3x16 -> {W}^2 [{route}]: "
                 f"{dt * 1e3:.3f} ms host, {_ms(dt_dev)} CUDA events, "
                 f"kernels {_ms(busy)} of a profiled call -> "
                 f"{route_mrays[route]:.2f} Mrays/s")
        rec.update({
            f"hist512_fwdbwd_{route}_mrays": round(route_mrays[route], 2),
            f"hist512_fwdbwd_{route}_ms": dt * 1e3,
            f"hist512_fwdbwd_{route}_device_ms": (
                None if dt_dev is None else dt_dev * 1e3),
            f"hist512_fwdbwd_{route}_busy_ms": (
                None if busy is None else busy * 1e3),
        })
    best = max(route_mrays, key=route_mrays.get)
    rec.update({"value": round(route_mrays[best], 2),
                "hist512_fwdbwd_route": best, "hist512_fwdbwd_iters": KH})
    del h

    step = _scalar_fwdbwd(blob_volume_device(n, device=dev), tf, dev, n, W)
    dt, dt_dev = time_amortized(step, dev, iters=KH, repeats=2)
    busy = device_busy_s(step, dev)
    rec.note(f"fwd+bwd SCALAR {W}^2 over {n}^3: {dt * 1e3:.3f} ms host, "
             f"{_ms(dt_dev)} CUDA events, kernels {_ms(busy)} of a profiled "
             f"call -> {W * W / dt / 1e6:.2f} Mrays/s")
    rec.update({"scalar512_fwdbwd_mrays": round(W * W / dt / 1e6, 2),
                "scalar512_fwdbwd_ms": dt * 1e3})


def _gaussian_mean(mu, sigma, i):
    """The decoded density of the Gaussian family, mu perturbed per call
    as JAX's loop-carry; contiguous, as the kernels take it."""
    from vrdd_tpu_torch.ops.gaussian import gaussian_stats

    return gaussian_stats(mu * (1.0 + 1e-6 * i), sigma)[..., 0].contiguous()


def decode_config_gaussian(dev, n, W, K, tf):
    """BASELINE config 3: per-voxel Gaussian (mu, sigma) decoded to density
    inside the differentiated render; gradients to mu, sigma and the LUT
    (JAX bench.py:1005). Mrays/s."""
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_slice_render_diff

    rng = np.random.default_rng(1)
    mu = torch.from_numpy(blob_volume(n, seed=1)).to(dev).requires_grad_()
    sigma = torch.from_numpy(
        0.05 + 0.2 * rng.random((n, n, n), dtype=np.float32)).to(dev)
    sigma.requires_grad_()
    lut = _lut(tf, dev, grad=True)
    step = _fwdbwd(lambda i: pallas_slice_render_diff(
        _gaussian_mean(mu, sigma, i), ORIGIN, lut, width=W, height=W,
        n_planes=n, wrt=("volume", "lut")),
        [mu, sigma, lut])
    dt, _ = time_amortized(step, dev, iters=K)
    return W * W / dt / 1e6


def _hist16(dev, n, B=16):
    """Config 4's fixture: softmax(2 x N(0, 1)) histograms, (n, n, n, B),
    from a seeded generator on ``dev`` (not JAX's draws)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((n, n, n, B), generator=gen, device=dev)
    return torch.softmax(2.0 * logits, dim=-1)


def _mean_decode(h):
    from vrdd_tpu_torch.ops.histogram import flex_block_stats

    return flex_block_stats(h, channels=(0,))[..., 0] / 255.0


def decode_config_hist16(dev, n, W, K, tf):
    """BASELINE config 4: per-voxel 16-bin histograms decoded (mean) inside
    the differentiated render; gradients to the histograms and the LUT
    (JAX bench.py:1046). Mrays/s."""
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_slice_render_diff

    hist = _hist16(dev, n).requires_grad_()
    lut = _lut(tf, dev, grad=True)
    step = _fwdbwd(lambda i: pallas_slice_render_diff(
        _mean_decode(hist * (1.0 + 1e-6 * i)), ORIGIN, lut, width=W,
        height=W, n_planes=n, wrt=("volume", "lut")), [hist, lut])
    dt, _ = time_amortized(step, dev, iters=K)
    return W * W / dt / 1e6


def decode_config_hist16_streamed(dev, n, W, K, tf):
    """Config 4 with the decode streamed into seeded chunk sweeps of 64
    planes (``march/streaming.py``; JAX bench.py:1167). Mrays/s."""
    from vrdd_tpu_torch.march.streaming import streaming_decode_render

    hist = _hist16(dev, n).requires_grad_()
    lut = _lut(tf, dev, grad=True)
    step = _fwdbwd(lambda i: streaming_decode_render(
        hist * (1.0 + 1e-6 * i), _mean_decode, ORIGIN, lut, width=W,
        height=W, n_planes=n, chunk_planes=64, backend="auto"), [hist, lut])
    dt, _ = time_amortized(step, dev, iters=K)
    return W * W / dt / 1e6


def decode_config_hist16_inkernel(dev, n, W, K, tf):
    """Config 4 with the decode inside K3/K4/K5 (JAX bench.py:1089): Mrays/s
    of the bins-major volume in f32 and in bf16 storage (the bf16 case at
    ``precision='bf16'``, JAX's bf16 resample, so its backward runs the
    y-transpose kernel), and the MB of the in-kernel forward's temporaries
    against the materialized decode's (:func:`_peak_temp_mb`)."""
    from vrdd_tpu_torch.kernels.slice_kernel import (
        pallas_hist_render, pallas_slice_render)
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_hist_render_diff

    B = 16
    hist_bm = _hist16(dev, n, B).permute(0, 3, 1, 2).contiguous()
    hist16 = hist_bm.to(torch.bfloat16)
    dw = torch.as_tensor((np.arange(B) + 0.5) / B, dtype=torch.float32,
                         device=dev)
    lut = _lut(tf, dev, grad=True)
    out = {}
    for key, h in (("f32", hist_bm), ("bf16", hist16)):
        h = h.detach().requires_grad_()
        step = _fwdbwd(lambda i, h=h, precision=key: pallas_hist_render_diff(
            h, dw, ORIGIN, lut, density=_density(i), width=W, height=W,
            wrt=("hist", "lut"), precision=precision), [h, lut])
        dt, _ = time_amortized(step, dev, iters=K)
        out[key] = W * W / dt / 1e6
    lut0 = _lut(tf, dev)
    with torch.no_grad():
        out["fwd_temp_mb"] = _peak_temp_mb(lambda: pallas_hist_render(
            hist16, dw, ORIGIN, lut0, width=W, height=W), dev)
        hist_lm = hist_bm.permute(0, 2, 3, 1)
        out["mat_fwd_temp_mb"] = _peak_temp_mb(lambda: pallas_slice_render(
            _mean_decode(hist_lm), ORIGIN, lut0, width=W, height=W,
            n_planes=n), dev)
    return out


def bench_decode(rec, dev, tf, *, n=256, W=512, K=4):
    """BASELINE configs 3 and 4 (JAX bench.py:482-532)."""
    r = decode_config_gaussian(dev, n, W, K, tf)
    rec.note(f"fwd+bwd Gaussian-decode {W}^2 over {n}^3: {r:.2f} Mrays/s")
    rec.update({"gaussian_decode_fwdbwd_mrays": round(r, 2)})
    r = decode_config_hist16(dev, n, W, K, tf)
    rec.note(f"fwd+bwd 16-bin-histogram-decode {W}^2 over {n}^3: {r:.2f} "
             "Mrays/s")
    rec.update({"hist16_decode_fwdbwd_mrays": round(r, 2)})
    r = decode_config_hist16_streamed(dev, n, W, K, tf)
    rec.note(f"fwd+bwd CHUNK-STREAMED 16-bin-histogram-decode {W}^2 over "
             f"{n}^3: {r:.2f} Mrays/s")
    rec.update({"hist16_chunked_stream_fwdbwd_mrays": round(r, 2)})
    ik = decode_config_hist16_inkernel(dev, n, W, K, tf)
    rec.note(f"fwd+bwd IN-KERNEL 16-bin-histogram-decode {W}^2 over {n}^3: "
             f"f32 {ik['f32']:.2f} / bf16 {ik['bf16']:.2f} Mrays/s; forward "
             f"temporaries {ik['fwd_temp_mb']} MB in-kernel vs "
             f"{ik['mat_fwd_temp_mb']} MB materialized")
    rec.update({
        "hist16_streamed_fwdbwd_mrays": round(ik["bf16"], 2),
        "hist16_streamed_impl": ("in-kernel K3/K4/K5, bf16 storage, "
                                 "precision='bf16'"),
        "hist16_streamed_f32_fwdbwd_mrays": round(ik["f32"], 2),
        "hist16_streamed_f32_note": (
            "f32 = f32 storage and resample; bf16 = bf16 storage and JAX's "
            "bf16 resample (half the stream bytes)"),
        "hist16_streamed_fwd_temp_mb": ik["fwd_temp_mb"],
        "hist16_materialized_fwd_temp_mb": ik["mat_fwd_temp_mb"],
    })


def dist_overhead(dev, n, W, K, vol, tf):
    """The distributed sweep on a one-process 1 x 1 mesh against the
    unsharded K1, with and without ESS (cached plane stats), and the
    distributed fwd+bwd (JAX bench.py:1265). Returns the times and the ESS
    stats."""
    from vrdd_tpu_torch.kernels.slice_kernel import (
        pallas_slice_render, precompute_ess_stats)
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.parallel.sweep import (
        distributed_sweep_render, shard_scalar_volume)

    mesh = make_mesh(1, 1, devices=[dev])
    lut = _lut(tf, dev)
    stats = precompute_ess_stats(vol, n_planes=n)
    dt_un, _ = time_amortized(_forward(lambda i: pallas_slice_render(
        vol, ORIGIN, lut, density=_density(i), width=W, height=W,
        n_planes=n)), dev, iters=K)
    dt_ess, _ = time_amortized(_forward(lambda i: pallas_slice_render(
        vol, ORIGIN, lut, density=_density(i), width=W, height=W,
        n_planes=n, empty_space_skip=True, ess_stats=stats)), dev, iters=K)
    vs = shard_scalar_volume(vol, mesh).detach().requires_grad_()
    dt_d, _ = time_amortized(_forward(lambda i: distributed_sweep_render(
        vs, ORIGIN, lut, density=_density(i), width=W, height=W, mesh=mesh,
        n_planes=n, backend="pallas")), dev, iters=K)
    lut_g = _lut(tf, dev, grad=True)
    dt_db, _ = time_amortized(_fwdbwd(lambda i: distributed_sweep_render(
        vs, ORIGIN, lut_g, density=_density(i), width=W, height=W, mesh=mesh,
        n_planes=n, backend="pallas", plane_chunk=4, wrt=("volume", "lut")),
        [vs, lut_g]), dev, iters=K)
    return {
        "unsharded_fwd_ms": dt_un * 1e3,
        "unsharded_fwd_ess_ms": dt_ess * 1e3,
        "dist_fwd_ms": dt_d * 1e3,
        "dist_overhead_ratio": dt_d / dt_un,
        "dist_fwdbwd_ms": dt_db * 1e3,
        "dist_fwdbwd_mrays": W * W / dt_db / 1e6,
    }, stats


def bench_dist(rec, dev, tf, *, n=512, W=1024, K=4, card="cpu"):
    """The one-process distributed overhead, then the roofline at the
    headline's scalar shape, with the forward timed by
    :func:`dist_overhead` and the fwd+bwd timed here as the headline times
    it (``max(20, K)`` iterations; JAX bench.py:534-577)."""
    from vrdd_tpu_torch.kernels.slice_vjp import live_fractions

    vol = blob_volume_device(n, device=dev)
    dist, stats = dist_overhead(dev, n, W, K, vol, tf)
    rec.note(f"distributed (1 x 1 mesh, one process) fwd "
             f"{dist['dist_fwd_ms']:.3f} ms vs unsharded "
             f"{dist['unsharded_fwd_ms']:.3f} ms (ESS "
             f"{dist['unsharded_fwd_ess_ms']:.3f} ms) -> overhead ratio "
             f"{dist['dist_overhead_ratio']:.3f}; dist fwd+bwd "
             f"{dist['dist_fwdbwd_ms']:.3f} ms")
    rec.update({k: round(v, 3) for k, v in dist.items()})
    dt_fb, _ = time_amortized(_scalar_fwdbwd(vol, tf, dev, n, W), dev,
                              iters=max(20, K), repeats=2)
    rec.update({"roofline_fwdbwd_ms": dt_fb * 1e3})
    # shares of the H100's bound only for times taken on the card
    on_card = dev.type == "cuda"
    dt_fwd, dt_fb, dt_ess = (
        (dist["unsharded_fwd_ms"] / 1e3, dt_fb,
         dist["unsharded_fwd_ess_ms"] / 1e3) if on_card else (None,) * 3)
    live = live_fractions(vol, ORIGIN, tf, width=W, height=W, n_planes=n)
    roof = roofline(vol, tf, W=W, dt_fwd=dt_fwd, dt_fb=dt_fb, dt_ess=dt_ess,
                    ess_stats=stats, live=live)
    _roofline_note(roof, card, dt_fwd, dt_fb, rec.note)
    rec.update({k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in roof.items()})


def viewer_fps_config(dev, K, runs=1, width=512):
    """Frames per second through the viewer's frame path
    (``ViewerServer.render_frame``: the pipeline's 'auto' render, the uint8
    pack and the bytes) at the reference's interactive configuration, the
    Isabel-shaped 50 x 50 x 10 blocks x 32 bins at 512^2, unrotated and
    under a rotation drag; ``runs`` samples of each (JAX bench.py:1213)."""
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.viewer import ViewerServer

    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    pipe = RenderPipeline(raw=RawHistogramVolume(
        torch.from_numpy(hist).to(dev)))
    srv = ViewerServer(pipe, width=width, height=width, port=0)
    unrots, rots = [], []
    try:
        n_frames = max(16, 8 * K)
        for _ in range(runs):
            for i in range(3):  # the pipeline's fill, unrotated
                srv.render_frame(
                    {"density": 0.04 + 1e-7 * i, "fmt": "rgb", "pipe": "1"})
            t0 = time.perf_counter()
            for i in range(n_frames):
                srv.render_frame(
                    {"density": 0.05 + 1e-7 * i, "fmt": "rgb", "pipe": "1"})
            unrots.append(n_frames / (time.perf_counter() - t0))
            for i in range(3):  # the fill, shear-warp
                srv.render_frame({"rx": 9.0 + 0.05 * i, "ry": 5.0,
                                  "fmt": "rgb", "pipe": "1"})
            t0 = time.perf_counter()
            for i in range(n_frames):
                srv.render_frame({"rx": 10.0 + 0.05 * i, "ry": 5.0,
                                  "fmt": "rgb", "pipe": "1"})
            rots.append(n_frames / (time.perf_counter() - t0))
    finally:
        srv.httpd.server_close()
    return unrots, rots


def bench_view(rec, dev, tf, *, K=4, runs=5, width=512):
    """The viewer's fps, median and band of ``runs`` (JAX bench.py:579)."""
    unrots, rots = viewer_fps_config(dev, K, runs=runs, width=width)
    fu, fr = float(np.median(unrots)), float(np.median(rots))
    rec.note(f"viewer {width}^2 Isabel config: median {fu:.1f} fps "
             f"unrotated (band {min(unrots):.1f}-{max(unrots):.1f}), median "
             f"{fr:.1f} fps under rotation drag (band {min(rots):.1f}-"
             f"{max(rots):.1f}); reference: 60 fps")
    rec.update({
        "viewer_fps_512": round(fu, 1), "viewer_fps_rotated_512": round(fr, 1),
        "viewer_fps_512_band": [round(min(unrots), 1), round(max(unrots), 1)],
        "viewer_fps_rotated_512_band": [round(min(rots), 1),
                                        round(max(rots), 1)],
    })


def bench_big(rec, dev, tf, *, n=1024, W=1024, n_hist=512, iters=4,
              hist_iters=8):
    """n^3 scalar -> W^2 forward and fwd+bwd, then :func:`bench_big_hist`
    at ``n_hist`` (JAX bench.py:651)."""
    from vrdd_tpu_torch.kernels.slice_kernel import pallas_slice_render

    vol = blob_volume_device(n, device=dev)
    lut = _lut(tf, dev)
    dt, _ = time_amortized(_forward(lambda i: pallas_slice_render(
        vol, ORIGIN, lut, density=_density(i), width=W, height=W,
        n_planes=n)), dev, iters=iters)
    rec.note(f"forward {W}^2 over {n}^3: {dt * 1e3:.2f} ms -> "
             f"{W * W / dt / 1e6:.2f} Mrays/s ({W * W * n / dt / 1e9:.1f} "
             "Gsamples/s)")
    rec.update({"fwd_1024_ms": round(dt * 1e3, 2),
                "fwd_1024_mrays": round(W * W / dt / 1e6, 2)})
    dt, _ = time_amortized(_scalar_fwdbwd(vol, tf, dev, n, W), dev,
                           iters=iters)
    rec.note(f"fwd+bwd {W}^2 over {n}^3: {dt * 1e3:.2f} ms -> "
             f"{W * W / dt / 1e6:.2f} Mrays/s")
    rec.update({"fwdbwd_1024_ms": round(dt * 1e3, 2),
                "fwdbwd_1024_mrays": round(W * W / dt / 1e6, 2),
                "fwdbwd_1024_route": "direct: K4 + K5 on the whole volume"})
    del vol
    bench_big_hist(rec, dev, tf, n=n_hist, W=W, KB=hist_iters)


def bench_big_hist(rec, dev, tf, *, n=512, W=1024, B=16, KB=8):
    """Distribution-native at the headline scale (JAX bench.py:706): K2's
    mean forward at B and at 32 bins, the in-kernel variance and entropy
    forwards and their fwd+bwd on both routes, and the distributed
    in-kernel fwd+bwd on a one-process 1 x 1 mesh."""
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.kernels.slice_kernel import (
        decode_weight_rows, pallas_hist_render)
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_hist_render_diff
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.parallel.sweep import (
        distributed_hist_render, shard_hist_volume)

    lut = _lut(tf, dev)
    for b in (B, 32):  # 32: the reference's own bin count
        hist = blob_histogram_volume(n, b, device=dev, dtype=torch.bfloat16)
        dw = torch.as_tensor((np.arange(b) + 0.5) / b, dtype=torch.float32,
                             device=dev)
        dt, _ = time_amortized(_forward(lambda i: pallas_hist_render(
            hist, dw, ORIGIN, lut, density=_density(i), width=W, height=W)),
            dev, iters=KB)
        rec.note(f"{n}^3x{b} bf16 distribution-native fwd {W}^2: "
                 f"{dt * 1e3:.2f} ms -> {W * W / dt / 1e6:.2f} Mrays/s "
                 f"({n * b * n * n * 2 / dt / 1e9:.0f} GB/s of histograms)")
        tag = "inkernel" if b == B else "b32"
        rec.update({f"hist512_{tag}_fwd_ms": round(dt * 1e3, 2),
                    f"hist512_{tag}_fwd_mrays": round(W * W / dt / 1e6, 2)})
        if b != B:
            del hist
        else:
            h, dw_b = hist.requires_grad_(), dw

    lut_g = _lut(tf, dev, grad=True)
    for stat, tscl in (("var", 30.0), ("entropy", 1.0)):
        rows, mode = decode_weight_rows(stat, B, family="unit")
        rows = torch.as_tensor(rows, device=dev)
        dt, _ = time_amortized(_forward(
            lambda i, rows=rows, mode=mode, tscl=tscl: pallas_hist_render(
                h, rows, ORIGIN, lut, density=_density(i),
                transfer_scale=tscl, width=W, height=W, stat=mode)),
            dev, iters=KB)
        rec.note(f"{n}^3x{B} bf16 in-kernel {stat} fwd {W}^2: "
                 f"{dt * 1e3:.2f} ms -> {W * W / dt / 1e6:.2f} Mrays/s")
        rec.update({
            f"hist512_inkernel_{stat}_fwd_ms": round(dt * 1e3, 2),
            f"hist512_inkernel_{stat}_fwd_mrays": round(W * W / dt / 1e6, 2),
        })
        best = (None, None)
        for route in ("inkernel", "materialized"):
            dt, _ = time_amortized(_fwdbwd(
                lambda i, rows=rows, mode=mode, tscl=tscl, route=route:
                pallas_hist_render_diff(
                    h, rows, ORIGIN, lut_g, density=_density(i),
                    transfer_scale=tscl, width=W, height=W,
                    wrt=("hist", "lut"), stat=mode, route=route),
                [h, lut_g]), dev, iters=KB)
            rec.note(f"{n}^3x{B} bf16 {stat} fwd+bwd [{route}] {W}^2: "
                     f"{dt * 1e3:.2f} ms -> {W * W / dt / 1e6:.2f} Mrays/s")
            if route == "inkernel":
                rec.update({
                    f"hist512_inkernel_{stat}_fwdbwd_ms": round(dt * 1e3, 2),
                    f"hist512_inkernel_{stat}_fwdbwd_mrays": round(
                        W * W / dt / 1e6, 2),
                })
            if best[0] is None or dt < best[0]:
                best = (dt, route)
        rec.update({
            f"hist512_{stat}_fwdbwd_mrays": round(W * W / best[0] / 1e6, 2),
            f"hist512_{stat}_fwdbwd_route": best[1],
        })

    mesh = make_mesh(1, 1, devices=[dev])
    hs = shard_hist_volume(h, mesh)
    dt, _ = time_amortized(_fwdbwd(lambda i: distributed_hist_render(
        hs, dw_b, ORIGIN, lut_g, density=_density(i), width=W, height=W,
        mesh=mesh, wrt=("hist", "lut")), [h, lut_g]), dev, iters=KB)
    rec.note(f"{n}^3x{B} bf16 DISTRIBUTED in-kernel fwd+bwd {W}^2 (1 x 1 "
             f"mesh, one process): {dt * 1e3:.2f} ms -> "
             f"{W * W / dt / 1e6:.2f} Mrays/s")
    rec.update({"hist512_dist_fwdbwd_ms": round(dt * 1e3, 2),
                "hist512_dist_fwdbwd_mrays": round(W * W / dt / 1e6, 2)})


def bench_rot(rec, dev, tf, *, n=512, W=1024, B=16):
    """Rotated distribution-native frames, ``distributed_shearwarp_hist_
    render`` on a one-process 1 x 1 mesh at the zrot (20, 30) and yrot
    (80, 10) views, oversample 1 (JAX bench.py:861); the permuted copy is
    cached per octant, so each view's first frame pays for it and the three
    timed ones do not."""
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.parallel.sweep import (
        clear_octant_cache, distributed_shearwarp_hist_render)

    hist = blob_histogram_volume(n, B, device=dev, dtype=torch.bfloat16)
    dw = torch.as_tensor((np.arange(B) + 0.5) / B, dtype=torch.float32,
                         device=dev)
    lut = _lut(tf, dev)
    mesh = make_mesh(1, 1, devices=[dev])
    try:
        for tag, (rx, ry) in (("zrot", (20.0, 30.0)), ("yrot", (80.0, 10.0))):
            iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))

            def frame(i, iv=iv):
                with torch.no_grad():
                    return float(distributed_shearwarp_hist_render(
                        hist, dw, iv, W, W, lut, density=_density(i),
                        mesh=mesh, oversample=1.0).sum())

            frame(0)
            t0 = time.perf_counter()
            for i in range(1, 4):
                frame(i)
            dt = (time.perf_counter() - t0) / 3
            rec.note(f"{n}^3x{B} bf16 ROTATED ({tag}) distribution-native "
                     f"fwd {W}^2 (1 x 1 mesh, octant-cached permute): "
                     f"{dt * 1e3:.2f} ms")
            rec.update({f"hist512_{tag}_fwd_ms": round(dt * 1e3, 2)})
    finally:
        clear_octant_cache()


def bench_scaling(rec, dev, tf, *, K=4, size=0, image=0):
    """``parallel/scaling.py measure_scaling`` from this process: a world of
    one reports its one-shard times and no efficiency (its own default
    shapes for 0)."""
    from vrdd_tpu_torch.parallel.scaling import measure_scaling

    sc = measure_scaling([dev], size=size, image=image, iters=K)
    rec.note(f"scaling: {sc}")
    rec.update(sc)


def bench_variants(rec, dev, tf, *, n=512, W=1024, K=4):
    """The extras (JAX bench.py:914): ESS under a windowed TF over a sparse
    volume (cached plane stats) against the plain K1, and the distributed
    Gaussian decode fwd+bwd on a one-process 1 x 1 mesh."""
    from vrdd_tpu_torch.kernels.slice_kernel import (
        pallas_slice_render, precompute_ess_stats)
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.parallel.sweep import (
        distributed_sweep_render, shard_scalar_volume)

    sparse = np.zeros((n, n, n), dtype=np.float32)
    q = n // 4
    sparse[q:2 * q, q:3 * q, q:3 * q] = blob_volume(n, seed=3)[
        q:2 * q, q:3 * q, q:3 * q] + 0.6
    sparse = torch.from_numpy(np.clip(sparse, 0.0, 1.0)).to(dev)
    lutw = np.zeros((9, 4), dtype=np.float32)
    lutw[:, 0] = np.linspace(0.0, 1.0, 9)
    lutw[6:, 3] = [0.3, 0.7, 1.0]  # alpha only above ~0.6
    lutw = _lut(lutw, dev)
    stats = precompute_ess_stats(sparse, n_planes=n)

    def fwd(ess):
        return _forward(lambda i: pallas_slice_render(
            sparse, ORIGIN, lutw, density=_density(i), width=W, height=W,
            n_planes=n, precision="f32", empty_space_skip=ess,
            ess_stats=stats if ess else None))

    dt_plain, _ = time_amortized(fwd(False), dev, iters=K)
    dt_ess, _ = time_amortized(fwd(True), dev, iters=K)
    rec.note(f"ESS windowed-TF sparse {n}^3: plain {dt_plain * 1e3:.3f} ms "
             f"vs ESS (cached stats) {dt_ess * 1e3:.3f} ms "
             f"({dt_plain / dt_ess:.2f}x)")
    rec.update({"ess_windowed_plain_ms": round(dt_plain * 1e3, 3),
                "ess_windowed_cached_ms": round(dt_ess * 1e3, 3)})
    del sparse, stats

    mesh = make_mesh(1, 1, devices=[dev])
    rng = np.random.default_rng(2)
    mu = shard_scalar_volume(blob_volume_device(n, device=dev), mesh)
    sigma = shard_scalar_volume(torch.from_numpy(
        0.05 + 0.2 * rng.random((n, n, n), dtype=np.float32)), mesh)
    mu, sigma = mu.requires_grad_(), sigma.requires_grad_()
    lut = _lut(tf, dev, grad=True)
    dt, _ = time_amortized(_fwdbwd(lambda i: distributed_sweep_render(
        _gaussian_mean(mu, sigma, i), ORIGIN, lut, width=W, height=W,
        mesh=mesh, n_planes=n, backend="pallas",
        plane_chunk=4, wrt=("volume", "lut")), [mu, sigma, lut]), dev,
        iters=K)
    rec.note(f"distributed Gaussian-decode fwd+bwd {W}^2 over {n}^3 (1 x 1 "
             f"mesh): {dt * 1e3:.3f} ms -> {W * W / dt / 1e6:.2f} Mrays/s")
    rec.update({"dist_gaussian_fwdbwd_mrays": round(W * W / dt / 1e6, 2)})


# ---- main ----------------------------------------------------------------

def card_info(dev):
    """The record's ``device``: name, power limit (``nvidia-smi``) and
    count on the card; "cpu" off it."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]
    return {"name": torch.cuda.get_device_name(dev),
            "power_limit": smi.rsplit(",", 1)[1].strip(),
            "count": torch.cuda.device_count()}


def _counters():
    from vrdd_tpu_torch.kernels import slice_kernel, slice_vjp

    mods = {"slice_kernel": slice_kernel, "slice_vjp": slice_vjp}
    return [(name, getattr(mods[m], fn), attr)
            for name, m, fn, attr in KERNELS]


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The flags of the root ``bench.py``, and ``--device``."""
    p.add_argument("--size", type=int, default=512, help="volume edge")
    p.add_argument("--image", type=int, default=1024, help="image edge")
    p.add_argument("--iters", type=int, default=4,
                   help="iterations timed back to back")
    p.add_argument(
        "--sections",
        default=os.environ.get("VRDD_BENCH_SECTIONS", SECTIONS),
        help="comma list of sections to run, in order: headline (forward "
        "MTexels/s, the distribution fwd+bwd - the metric - and the scalar "
        "fwd+bwd), decode (BASELINE configs 3 and 4), dist (one-process "
        "distributed overhead and the roofline), view (viewer fps, median "
        "of 5), big ((2 size)^3 scalar and the size^3 statistics), rot "
        "(rotated distribution-native frames), scaling (parallel/scaling.py "
        "from this process), extras (ESS under a windowed TF, distributed "
        "Gaussian decode; also --full)",
    )
    p.add_argument("--full", action="store_true",
                   help="also run the extras section")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels; raises without a GPU) or 'cpu' "
                   "(the plain versions: a rehearsal)")


def run(args) -> int:
    """Run the sections of ``args`` (:func:`add_arguments`) and return 0; a
    section's failure propagates. The record's ``launches`` holds the
    run's count of each kernel of :data:`KERNELS`."""
    from vrdd_tpu_torch.cli import _device
    from vrdd_tpu_torch.core.transfer import default_transfer_function

    dev = _device(args.device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sections = [s.strip() for s in args.sections.split(",") if s.strip()]
    if args.full and "extras" not in sections:
        sections.append("extras")
    n, W, K = args.size, args.image, args.iters
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = card_info(dev)
    card = f"{device['name']}, {device['power_limit']}" if on_card else "cpu"
    rec = Record({
        "metric": (("" if on_card else "cpu rehearsal: ")
                   + f"Mrays/s fwd+bwd {n}^3x16-bin distribution vol {W}^2 "
                   "img (in-kernel decode, slice sweep)"),
        "value": None,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "reference_mtexels_per_s": REFERENCE_MTEXELS_PER_S,
        "device": device,
    })
    rec.note(f"device: {card}; sections: {','.join(sections)}")
    if on_card:  # the build before any timed section
        from vrdd_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        _build.build()
        _build.library()
        rec.note(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)
    tf = default_transfer_function()
    # JAX's sizes at the defaults (the Isabel forward and the viewer at
    # 512^2, big at (2 size)^3); a CPU rehearsal keeps images to --image
    w512 = 512 if on_card else min(512, W)
    run_sec = {
        "headline": lambda: bench_headline(rec, dev, tf, n=n, W=W, K=K,
                                           W0=w512),
        "decode": lambda: bench_decode(rec, dev, tf, n=min(n, 256),
                                       W=min(W, 512), K=K),
        "dist": lambda: bench_dist(rec, dev, tf, n=n, W=W, K=K, card=card),
        "view": lambda: bench_view(rec, dev, tf, K=K, width=w512),
        "big": lambda: bench_big(rec, dev, tf, n=2 * n, W=W, n_hist=n),
        "rot": lambda: bench_rot(rec, dev, tf, n=n, W=W),
        "scaling": lambda: bench_scaling(rec, dev, tf, K=K),
        "extras": lambda: bench_variants(rec, dev, tf, n=n, W=W, K=K),
    }
    unknown = [name for name in sections if name not in run_sec]
    if unknown:
        raise ValueError(f"unknown sections {unknown}; use "
                         f"{','.join(run_sec)}")
    for name in sections:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run_sec[name]()
        secs = round(time.perf_counter() - t0, 1)
        gc.collect()
        peak = "not measured"
        if on_card:
            peak = f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB"
            torch.cuda.empty_cache()
        rec.note(f"section {name}: {secs} s, peak allocated {peak}")
        rec.update({f"sec_{name}_s": secs})
    counts = {name: getattr(fn, attr) for name, fn, attr in _counters()}
    rec.note(f"kernel launches: {counts}")
    rec.update({"launches": counts})
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vrdd_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
