"""Interactive frames: ``RenderPipeline.render`` of a raw block-histogram
volume, packed to uint8 on the device and copied to pinned host memory,
one frame at a time (the view server's frame: the next request comes when
the last frame is in host memory).

The set-up bins a seeded smooth scalar field into block histograms and
builds the pipeline on them (the stats decode). Each frame of the window
takes its query, TF window and camera from a schedule drawn from the seed
by the mix's parameters. A sample of the window's frames, drawn from the
seed, keeps its bytes; after the window the plain reference renders those
frames again from the histograms and the two are compared.

Configuration keys: ``field_shape``, ``field`` (the generator's blobs and
jitter), ``block``, ``bins``, ``image``, ``focal``, ``n_planes``,
``oversample``, ``density``, ``brightness``, ``kept_frames`` and
``limits``. Mix keys: ``frames`` (the schedule's length, cycled),
``queries``, ``tf_offset`` and ``tf_scale`` (uniform ranges), ``var_scale``
(multiplies the variance's TF scale), and ``camera``: ``distance``,
``yaw0`` and ``pitch0`` (ranges of the start), ``yaw_step`` and
``pitch_step`` (ranges of a frame's turn), ``pitch_limit``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from vrdd_tpu_torch.models import pipeline
from vrdd_tpu_torch.models.volumes import RawHistogramVolume
from vrdd_tpu_torch.utils.config import (
    CameraConfig, QueryMethod, RenderConfig, TransferFunctionConfig)

from benchmark import inputs
from benchmark.reference import sweep as ref

#: the stats channel each raw query reads: mean, variance, entropy
_CHANNEL = {1: 0, 2: 1, 3: 2}


def schedule(mix: dict, seed: int) -> list:
    """``[(query, tf_offset, tf_scale, pitch, yaw)]`` of the mix's frames:
    the query uniform over the mix's, the TF window uniform in its ranges
    (the variance's scale times ``var_scale``), and the camera from a
    seeded start turned by a seeded step each frame, the pitch reflected
    at ``pitch_limit``."""
    rng = np.random.default_rng(seed)
    cam = mix["camera"]
    n = mix["frames"]
    q = rng.choice(mix["queries"], size=n)
    toff = rng.uniform(*mix["tf_offset"], size=n)
    tscl = rng.uniform(*mix["tf_scale"], size=n) * np.where(
        q == 2, mix["var_scale"], 1.0)
    yaw = rng.uniform(*cam["yaw0"]) + np.cumsum(rng.uniform(*cam["yaw_step"], n))
    lim = cam["pitch_limit"]
    walk = rng.uniform(*cam["pitch0"]) + np.cumsum(rng.uniform(*cam["pitch_step"], n))
    # reflect the walk into [-lim, lim] (a triangle wave of period 4 lim)
    pitch = (lim - np.abs(np.mod(walk + lim, 4 * lim) - 2 * lim)
             if lim > 0 else np.zeros(n))
    return [(int(a), float(b), float(c), float(d), float(e) % 360.0)
            for a, b, c, d, e in zip(q, toff, tscl, pitch, yaw)]


class Cell:
    unit = "frames"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.c, self.mix, self.seed, self.dev = config, mix, seed, device
        self.limits = config["limits"]
        self.failed = 0
        self.kept = []
        self._pick = np.random.default_rng(seed)
        self.frame_ms, self.host_ms = [], []
        self.cuda = device.type == "cuda"

    def make_inputs(self):
        c = self.c
        field = inputs.smooth_field(tuple(c["field_shape"]), seed=self.seed,
                                    device=self.dev, **c["field"])
        self.hist = inputs.block_histograms(field, c["block"], c["bins"])
        del field
        self.pipe = pipeline.RenderPipeline(raw=RawHistogramVolume(self.hist),
                                            tf_lut=inputs.rainbow_lut())
        W = c["image"]
        dist = self.mix["camera"]["distance"]
        self.frames = []
        for q, toff, tscl, pitch, yaw in schedule(self.mix, self.seed):
            cfg = RenderConfig(
                camera=CameraConfig(width=W, height=W, focal=c["focal"]),
                tf=TransferFunctionConfig(offset=toff, scale=tscl),
                density=c["density"], brightness=c["brightness"],
                query_method=QueryMethod(q))
            self.frames.append((cfg, inputs.inv_view(pitch, yaw, dist)))
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.dev)

    def _frame(self, i: int, spans=None):
        """Frame ``i`` of the schedule in host memory, and its milliseconds
        from the call into ``render`` until its bytes are in host memory (by
        the device's clock on the card); the call alone is a span."""
        cfg, view = self.frames[i % len(self.frames)]
        if self.cuda:
            self.start.record()
        t0 = time.perf_counter()
        with torch.no_grad():
            img = self.pipe.render(view, cfg, "auto", as_uint8=True)
        t1 = time.perf_counter()
        if self.cuda:
            host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            host.copy_(img, non_blocking=True)
            self.end.record()
            self.end.synchronize()
            ms = self.start.elapsed_time(self.end)
        else:
            host = img.clone()
            ms = 1e3 * (time.perf_counter() - t0)
        if spans is not None:
            spans.seconds.setdefault("render", []).append(t1 - t0)
        return host, ms

    def warm(self):
        """The first frames of the schedule and a frame of every query and
        principal axis the schedule reaches."""
        seen = set()
        for i, (cfg, view) in enumerate(self.frames):
            axis = int(np.argmax(np.abs(view[:, 2])))
            key = (int(cfg.query_method), axis)
            if i < 8 or key not in seen:
                seen.add(key)
                self._frame(i)

    def step(self, i: int, spans):
        host, ms = self._frame(i, spans)
        self.frame_ms.append(ms)
        self.host_ms.append(spans.seconds["render"][-1] * 1e3)
        k = self.c["kept_frames"]
        if i < k:
            self.kept.append((i, host))
        else:
            slot = self._pick.integers(0, i + 1)
            if slot < k:
                self.kept[slot] = (i, host)

    def end_to_end(self, n: int, window_s: float) -> dict:
        W = self.c["image"]
        return {"frame_mtexels_s": n * W * W / window_s / 1e6,
                "frame_p95_ms": float(np.percentile(self.frame_ms, 95))}

    def counters(self) -> dict:
        """Frames by query and by renderer (a fall-back to the scan
        marcher shows here), and the frame times' median."""
        n = len(self.frame_ms)
        by_q, by_r = {}, {}
        for i in range(n):
            cfg, view = self.frames[i % len(self.frames)]
            q = int(cfg.query_method)
            r = self.pipe.resolve_renderer("auto", view, cfg)
            by_q[q] = by_q.get(q, 0) + 1
            by_r[r] = by_r.get(r, 0) + 1
        return {"frames_by_query": by_q, "frames_by_renderer": by_r,
                "frame_median_ms": statistics.median(self.frame_ms),
                "render_median_ms": statistics.median(self.host_ms)}

    def release(self):
        self.pipe = None
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, i: int, dtype):
        """Frame ``i`` by the plain reference in ``dtype``, from the
        histograms: the stats decode, then the axis sweep or the
        shear-warp, then the uint8 pack."""
        c = self.c
        cfg, view = self.frames[i % len(self.frames)]
        stats = ref.raw_stats(self.hist, dtype)
        channel = stats[..., _CHANNEL[int(cfg.query_method)]].contiguous()
        rotated = not np.allclose(view[:, :3], np.eye(3), atol=1e-6)
        kw = dict(width=c["image"], height=c["image"], focal=c["focal"],
                  n_planes=c["n_planes"], dtype=dtype)
        args = (channel, view, inputs.rainbow_lut(),
                c["density"], c["brightness"], cfg.tf.offset, cfg.tf.scale)
        if rotated:
            return ref.orbit_frame(*args, oversample=c["oversample"], **kw)
        return ref.axis_frame(*args, **kw)

    def control(self):
        """The kept frames as the control renders them: the plain
        reference in the program's place, one precision lower."""
        return [(i, self.reference(i, torch.bfloat16).cpu())
                for i, _ in self.kept]

    def check(self, outputs=None) -> dict:
        """The kept frames (or ``outputs``, the control's) against the
        plain reference in float32, in uint8 levels over every channel of
        every kept frame: the widest gap, and the share of channels more
        than one level apart (a float32 rounding may move a level by one)."""
        kept = self.kept if outputs is None else outputs
        widest, over1, total = 0, 0, 0
        for i, got in kept:
            want = self.reference(i, torch.float32).cpu()
            gap = (got.cpu().to(torch.int16) - want.to(torch.int16)).abs()
            widest = max(widest, int(gap.max()))
            over1 += int((gap > 1).sum())
            total += gap.numel()
        return {"frame_gap_max": float(widest),
                "frame_gap_over1_pct": 100.0 * over1 / max(1, total)}
