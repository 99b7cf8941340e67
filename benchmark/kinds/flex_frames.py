"""The flexible-block explorer: a block-size slider over a raw field. Each
frame renders query 8, 9 or 0 (the block grid's entropy, mean or variance)
through ``RenderPipeline.render``, packed to uint8 on the device and copied
to pinned host memory, one frame at a time, as
:mod:`benchmark.kinds.pipeline_frames` does; where the slider has moved
since the last frame, the frame first re-queries the program's resident
integral histogram at the new block size
(``vrdd_tpu_torch.models.flexible.IntegralVolume.blocks``), min-max maps
the grid and hands it to the pipeline (``RenderPipeline.set_flexible``).

The set-up makes the seeded field and builds the integral histogram once;
the window never rebuilds it. A frame's time runs from the re-query (or
the render, on a frame that does not move the slider) until its bytes are
in host memory, by the device's clock on the card. Each block size's grid
of the window, before the min-max map, is kept; so is a sample of the
window's frames, drawn from the seed. After the window the plain reference
(:mod:`benchmark.reference.flex`) counts every block's histogram from the
field, derives the grids and renders the kept frames again, and the two
are compared.

The program's module is imported inside :meth:`Cell.make_inputs`, never at
import: a checkout without it still imports this kind (the traced runs of
every cell import every kind), and only this cell fails there.

Configuration keys: ``field_shape``, ``field`` (the generator's blobs and
jitter), ``bins``, ``value_range``, ``image``, ``focal``, ``density``,
``brightness``, ``normalize`` (min-max map the mean and variance before
rendering), ``kept_frames`` and ``limits``. Mix keys: ``frames`` (the
schedule's length, cycled), ``blocks`` (the slider's range), ``drag`` and
``rest`` (ranges of frames), ``queries``, ``tf_offset`` and ``tf_scale``
(uniform ranges) and ``camera``: ``distance``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from vrdd_tpu_torch.models import pipeline
from vrdd_tpu_torch.utils.config import (
    CameraConfig, QueryMethod, RenderConfig, TransferFunctionConfig)

from benchmark import inputs
from benchmark.kinds import pipeline_frames
from benchmark.reference import flex as ref
from benchmark.roofline import flex as count


def schedule(mix: dict, seed: int):
    """``(start, [(block, query, tf_offset, tf_scale)])``: the slider's
    block size before the first frame, and each frame's. The slider moves
    in drags, each of ``drag`` frames stepping the size by 1 a frame in a
    seeded direction (reflected at the ends of ``blocks``), then rests
    ``rest`` frames; query and TF window are drawn a frame."""
    rng = np.random.default_rng(seed)
    lo, hi = mix["blocks"]
    n = mix["frames"]
    start = int(rng.integers(lo, hi + 1))
    sizes, b = [], start
    while len(sizes) < n:
        step = int(rng.choice([-1, 1]))
        for _ in range(int(rng.integers(mix["drag"][0], mix["drag"][1] + 1))):
            if not lo <= b + step <= hi:
                step = -step
            b += step
            sizes.append(b)
        sizes.extend([b] * int(rng.integers(mix["rest"][0],
                                            mix["rest"][1] + 1)))
    q = rng.choice(mix["queries"], size=n)
    toff = rng.uniform(*mix["tf_offset"], size=n)
    tscl = rng.uniform(*mix["tf_scale"], size=n)
    return start, [(int(a), int(b), float(c), float(d))
                   for a, b, c, d in zip(sizes[:n], q, toff, tscl)]


class Cell(pipeline_frames.Cell):
    unit = "frames"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        super().__init__(config, mix, seed, device)
        self.grids = {}  # block size -> its latest grid, before the map
        self.window_blocks = []  # the block size of each re-query
        self.moved = []  # whether each window frame re-queried
        self._ref = {}  # (block size, dtype) -> the reference's grid

    def make_inputs(self):
        from vrdd_tpu_torch.models.flexible import IntegralVolume

        c = self.c
        self.field = inputs.smooth_field(tuple(c["field_shape"]),
                                         seed=self.seed, device=self.dev,
                                         **c["field"])
        vmin, vmax = c["value_range"]
        self.integral = IntegralVolume.from_raw(self.field, c["bins"], vmin,
                                                vmax)
        self.first_block, frames = schedule(self.mix, self.seed)
        vol = self.integral.blocks(self.first_block)
        self.pipe = pipeline.RenderPipeline(flexible=self._mapped(vol),
                                            tf_lut=inputs.rainbow_lut())
        self.block = self.first_block
        self.grids[self.first_block] = vol.stats_grid
        W = c["image"]
        self.view = inputs.inv_view(0.0, 0.0, self.mix["camera"]["distance"])
        self.frames = [(b, RenderConfig(
            camera=CameraConfig(width=W, height=W, focal=c["focal"]),
            tf=TransferFunctionConfig(offset=toff, scale=tscl),
            density=c["density"], brightness=c["brightness"],
            query_method=QueryMethod(q))) for b, q, toff, tscl in frames]
        if self.cuda:
            self.start_ev = torch.cuda.Event(enable_timing=True)
            self.end_ev = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.dev)

    def _mapped(self, vol):
        return vol.normalized() if self.c["normalize"] else vol

    def _requery(self, block: int):
        """The program's grid of ``block`` from the resident integral
        histogram, min-max mapped (``normalize``), into the pipeline; the
        grid before the map is kept for the check."""
        vol = self.integral.blocks(block)
        self.pipe.set_flexible(self._mapped(vol))
        self.block = block
        self.grids[block] = vol.stats_grid

    def _frame(self, i: int, spans=None):
        """Frame ``i`` of the schedule in host memory, and its milliseconds
        from the re-query (or the render) until its bytes are in host
        memory (by the device's clock on the card); the calls alone are a
        span."""
        block, cfg = self.frames[i % len(self.frames)]
        if self.cuda:
            self.start_ev.record()
        t0 = time.perf_counter()
        with torch.no_grad():
            if spans is not None:
                self.moved.append(block != self.block)
            if block != self.block:
                self._requery(block)
                if spans is not None:
                    self.window_blocks.append(block)
            img = self.pipe.render(self.view, cfg, "auto", as_uint8=True)
        t1 = time.perf_counter()
        if self.cuda:
            host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            host.copy_(img, non_blocking=True)
            self.end_ev.record()
            self.end_ev.synchronize()
            ms = self.start_ev.elapsed_time(self.end_ev)
        else:
            host = img.clone()
            ms = 1e3 * (time.perf_counter() - t0)
        if spans is not None:
            spans.seconds.setdefault("render", []).append(t1 - t0)
        return host, ms

    def warm(self):
        """A frame of every block size and query the schedule reaches, the
        first frames of the schedule, and back to the slider's first
        block size."""
        seen = set()
        for i, (block, cfg) in enumerate(self.frames):
            key = (block, int(cfg.query_method))
            if i < 8 or key not in seen:
                seen.add(key)
                self._frame(i)
        with torch.no_grad():
            self._requery(self.first_block)

    def counters(self) -> dict:
        """Frames by query and block size, the window's re-queries by block
        size, and the frame times' median: of all frames, of those that
        kept the block size (the host's pace) and of those that re-queried
        (the p95 falls among these)."""
        n = len(self.frame_ms)
        by_q, by_b, moved_b = {}, {}, {}
        for i in range(n):
            block, cfg = self.frames[i % len(self.frames)]
            q = int(cfg.query_method)
            by_q[q] = by_q.get(q, 0) + 1
            by_b[block] = by_b.get(block, 0) + 1
        for b in self.window_blocks:
            moved_b[b] = moved_b.get(b, 0) + 1
        still = [t for t, m in zip(self.frame_ms, self.moved) if not m]
        moved = [t for t, m in zip(self.frame_ms, self.moved) if m]
        return {"frames_by_query": by_q,
                "frames_by_block": dict(sorted(by_b.items())),
                "requeries": len(self.window_blocks),
                "requeries_by_block": dict(sorted(moved_b.items())),
                "frame_median_ms": statistics.median(self.frame_ms),
                "still_frame_median_ms": (statistics.median(still)
                                          if still else None),
                "requery_frame_median_ms": (statistics.median(moved)
                                            if moved else None),
                "render_median_ms": statistics.median(self.host_ms)}

    def roofline(self):
        """The least time of the window's re-queries together."""
        if not self.window_blocks:
            return None
        shape, bins = tuple(self.c["field_shape"]), self.c["bins"]
        n_bytes = n_ops = 0
        for b in self.window_blocks:
            nb, no = count.requery_work(shape, b, bins)
            n_bytes, n_ops = n_bytes + nb, n_ops + no
        t, by = count.bound_s(n_bytes, n_ops)
        return {"bound_s": t, "bound_by": by, "bytes": n_bytes, "ops": n_ops,
                "requeries": len(self.window_blocks)}

    def release(self):
        self.integral = None
        super().release()

    def _grid(self, block: int, dtype) -> torch.Tensor:
        """The reference's stats grid of ``block``, before the map."""
        key = (block, dtype)
        if key not in self._ref:
            c = self.c
            counts = ref.block_counts(self.field, block, c["bins"],
                                      *c["value_range"])
            self._ref[key] = ref.block_stats(counts, dtype)
        return self._ref[key]

    def reference(self, i: int, dtype):
        """Frame ``i`` by the plain reference in ``dtype``, from the field:
        the block histograms, their stats (min-max mapped where the
        configuration says), the frame."""
        c = self.c
        block, cfg = self.frames[i % len(self.frames)]
        grid = self._grid(block, dtype)
        if c["normalize"]:
            grid = ref.min_max(grid)
        channel = grid[..., ref.CHANNEL[int(cfg.query_method)]].contiguous()
        return ref.flex_frame(channel, self.view, inputs.rainbow_lut(),
                              c["density"], c["brightness"], cfg.tf.offset,
                              cfg.tf.scale, width=c["image"],
                              height=c["image"], focal=c["focal"],
                              dtype=dtype)

    def _kept_blocks(self, kept) -> list:
        return sorted({self.frames[i % len(self.frames)][0] for i, _ in kept})

    def control(self):
        """The kept frames and their grids as the control computes them:
        the plain reference in the program's place, one precision lower."""
        grids = {b: self._grid(b, torch.bfloat16)
                 for b in self._kept_blocks(self.kept)}
        return super().control(), grids

    def check(self, outputs=None) -> dict:
        """The kept frames against the plain reference in float32
        (:meth:`pipeline_frames.Cell.check`), and the grid of each kept
        frame's block size before the min-max map: ``stats_max_abs``, the
        widest gap over the grids' entries, each channel in units of the
        reference channel's largest magnitude."""
        if outputs is None:
            frames = self.kept
            grids = {b: self.grids[b] for b in self._kept_blocks(frames)}
        else:
            frames, grids = outputs
        out = super().check(frames)
        widest = 0.0
        for b, got in grids.items():
            want = self._grid(b, torch.float32)
            scale = want.abs().reshape(-1, 3).amax(0).clamp(min=1e-30)
            gap = ((got.float() - want) / scale).abs().max()
            widest = max(widest, float(gap))
        out["stats_max_abs"] = widest
        return out
