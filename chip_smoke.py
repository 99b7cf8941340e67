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
6b. the decode's histogram cotangent (``csrc/decode_chain.cu``) on the
   same volume for linear, var from K5's moments, var from its own and
   entropy: one launch a call and one in each of phase 6's backwards,
   linear and var from K5's moments bitwise the plain version, entropy
   within one bf16 rounding (at most 1e-4 of the elements off) and 0 at
   empty bins, var from its own moments (summed in another order) within
   one bf16 rounding over 1e-5 of the largest element; the kernel timed
   beside its byte bound and the plain chain;
7. the ``render`` path (``RenderPipeline``, queries 1/2/3/7):
   7a. the reference's benchmark geometry, the Isabel-shaped 50 x 50 x 10
       blocks x 32 bins, to 512^2 with the ``scan``, ``slice`` and
       ``pallas`` renderers (ESS on and off): ``pallas`` against ``slice``
       at the image tolerance, ESS on bitwise ESS off, frame ms and
       MTexels/s of each;
   7b. full size, a smooth 256^3-block x 32-bin float32 raw volume (2.1 GB,
       made on the card from a seed, with empty space around its blobs) to
       1024^2 through ``renderer='auto'``, which must resolve to the fused
       kernel K1 testing ESS itself: launch counters (K1, its
       ESS launches, the ESS bitmap kernel) reset before and read after,
       no bitmap kernel launched; the bits the kernels tested held byte
       for byte against the plain bitmap on both fetch paths; the stats
       decode, the ESS plane stats, the pre-blend, the bitmap kernel (byte
       for byte its plain version; its device time, its wrapper's host
       time and a call), the K1 wrapper with ESS on both fetch paths and
       without, and the whole frame timed; the culled share and peak
       memory printed; ESS bitwise no-ESS, ``pallas`` against the plain
       ``slice`` renderer. Then the differentiable sweep with ESS
       (``wrt=('volume',)``) on the same volume: K3/K4 testing ESS bitwise
       without (image, every checkpoint row, the live map), their bits
       byte for byte the plain bitmap and the bitmap kernel's, timed on
       both fetch paths; ``d_volume`` within 1e-6 relative L2 of the
       gradient without ESS;
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
       K3 on the 2048^2 m-grid timed against its plain version;
9. the fractal and flexible-block render at full size:
   9a. a fractal volume of 256^3 blocks x 32 bins (16 templates, up to 8
       sparse errors; made on the card from a seed): the decode timed and
       held against the per-voxel oracle on 4096 voxels (1e-6 abs), then
       queries 4/5/6 to 1024^2 through ``renderer='auto'``, which must
       resolve to K1 testing ESS in the kernel and launch no bitmap kernel
       (counters reset before, read after; the tested bits byte for byte
       the plain bitmap on both fetch paths), each
       frame bitwise on the direct path and without ESS and against the
       plain ``slice`` renderer at the image tolerance; one rotated view
       (30, 20) through shear-warp, which must launch K3 once, against the
       ``'xla'`` shear-warp;
   9b. the flexible blocks of an Isabel-sized raw volume (500 x 500 x 100
       float32, smooth seeded blobs over [0, 255], made on the card):
       ``from_raw`` with blocks of 4 (125 x 125 x 25 x 64 bins), each stage
       timed and the peak memory printed; the resident ``IntegralVolume``
       (int32): its grid query's counts against a direct per-block count
       (exact), ``from_raw``'s stats bitwise the direct count's; queries
       8/9/0 (normalized)
       to 1024^2 as in 9a (K1 on the zero-padded 126 x 126 x 26 grid with
       axis scale (125/126, 125/126, 25/26), ESS at that z scale; the
       504-byte rows take the staged copy's per-row offsets), query 9
       rotated through shear-warp K3; K1 on the grid with and without ESS
       and K3 on the rotated view's m-grid timed on both fetch paths
       against their plain versions; the explorer's slider at blocks of 2,
       16 and 4 (a re-query of the resident table, ``set_flexible``,
       queries 8/9/0 through 'auto'), which must launch the re-query
       kernel once a re-query (counter reset before, read after), each
       frame bitwise a fresh pipeline's; the re-query kernel
       (``csrc/flex_blocks.cu``) at those sizes against its plain version
       on the same card tensors (each channel within 2e-6 of its largest
       magnitude, bitwise on a second launch), both timed, with its bound;
   9c. ``from_codebooks`` at the reference's Fuel scale (64^3, the full
       262,144-span Fenwick universe, blocks of 6) on the card against
       ``from_raw`` of the same raw volume (1e-4 relative and absolute);
   9d. ``python -m vrdd_tpu_torch.cli render --file none --query 9`` at its
       defaults and with ``--renderer auto --flex-normalize``;
10. ``fit-tf --blocks 50 50 10 --size 512 --iters 5 --renderer auto`` (the
    Isabel geometry): it must take the fused kernels, launch K3 for its
    target and K4 + K5 (``wrt=('lut',)``) once a step (counters reset before,
    read after), and its loss must be finite and fall; K4 and K5 at that
    shape timed on both fetch paths against their plain versions (K5's LUT
    cotangents within 1e-3 relative L2, bitwise across paths); ``encode``
    at its defaults on the card, byte for byte the file it writes with
    ``--device cpu``;
11. the distributed sweep of ``parallel/`` on one card (counters reset
    before and read after each drive):
    11a. ``distributed_hist_render`` at bricks=4 x rays=2 in one process,
         the headline 512^3 x 16 bf16 volume -> 1024^2, mean and entropy,
         density 0.2 (some 30% of the rays reach the cutoff, so pass 2
         runs): K3 twice per shard (pass 2 seeded), the image against the
         single-device K2; fwd+bwd (``wrt=("hist", "lut")``, K4 and K5
         per shard and pass) against ``pallas_hist_render_diff`` (loss
         1e-4 relative, ``d_hist`` within one bf16 rounding, the LUT's
         1e-3 relative L2); the calls the path makes recorded
         (``ShardCalls``) and each pass's shards replayed alone: K3 per
         pass and, for the mean, K4 and K5 (with the seeded shards' ``S``)
         held against their plain versions, timed by CUDA events around
         the launches and bounded; the mean's fwd+bwd profiled;
    11b. ``distributed_shearwarp_hist_render`` on a 1 x 1 mesh at phase
         8c's three views (axes z, x, y; d_z of both signs), oversample 1:
         K3 once a view, its m-grid image and the frame against the plain
         version of the same call, timed and bounded;
    11c. ``render-hist --rot-x 30 --rot-y 20`` on a 128^3 x 16 file: its
         path line must name ``distributed_shearwarp_hist_render``;
    11d. ``distributed_sweep_render`` and ``distributed_shearwarp_render``
         at bricks=2 x rays=2 on 7b's 256^3 mean channel -> 1024^2 against
         K1 and the same call on one device (and, to 1e-2, the
         single-device shear-warp's other m-grid), each pass's shards
         replayed against their plain versions, the rotated m-grid image
         against the plain sweep ('xla') on the slopes the kernels sample
         (and, printed, on the m-grid's own points: JAX's slope step),
         then one ``make_sweep_fit_step`` step against the single-device
         step, its K4/K5 shards against their plain versions;
    11e. ``bricks.distributed_render_image`` at bricks=2 on Isabel's 50 x
         50 x 10 x 32 stats -> 512^2 against ``RenderPipeline``'s scan
         frame;
    11f. (run after 11b, on its volume) processes that split the ray
         strips: 11a's mean at density 0.2 on three worlds of worker
         processes of this script (``--worker-11f``), ``(2 processes,
         bricks=1 x rays=2)``, JAX's ``global_mesh()`` default, ``(4, 2 x
         2)``, one shard a process, and the ragged ``(3, 2 x 3)`` at 1024
         x 1152 (three 384-row strips; rank 1 holds brick 0 of strip 2 and
         brick 1 of strip 0); each joins a Gloo group whose mesh
         is on the card (NCCL, one card a process, where there are as many
         cards as processes), reads its bricks from a ``.npy`` copy of the
         volume, and renders and differentiates its strips with the
         counters reset before and read after: each process must launch
         K3 (and, with more than one brick, the seeded pass 2), K4 and K5
         on the card for its shards; the gathered frame within 1e-6 abs of
         the same mesh in one process and within the image tolerance of
         K2; the loss and ``d_lut`` within 1e-5 (relative L2; 1e-7 for the
         ragged world) of one process's, ``d_hist`` within 1e-5 or 1.5 times the floor, two
         runs in one process measured in the same run (they differ: K5's
         f32 atomics through the bf16 rounding), whichever is larger; all
         three within 11a's limits of the single-device ones; frame and fwd+bwd
         ms of rank 0 (host clock, median of 3,
         the collectives through host memory included) beside the same
         mesh in one process; the last rank holding the most bricks (the
         front brick, where the rays cross the cutoff; rank 1 of the
         ragged world, both bricks) then replays its shards' K3/K4/K5
         launches against their plain versions (11a's records);
12. (run right after phase 6, on its 512^3 x 16 bf16 volume, before phase
    7) ``precision='bf16'``, K4's live map, the native loader and the
    viewer, each drive with its counters reset before and read after:
    12a. K2 at ``precision='bf16'`` for mean, var and entropy to 1024^2 on
         both fetch paths: bitwise equal, against the plain bf16 version
         (image tolerance), its distance from the f32 image printed (must
         not be 0), ``.bf16_launches`` advanced, timed and bounded;
    12b. in-kernel mean fwd+bwd at ``precision='bf16'`` (``wrt=("hist",
         "lut")``) and the materialized mean, against the plain bf16
         backward (JAX's transpose; 1e-3 relative L2), K4, K5 and the
         y-transpose kernel (``csrc/dplane_bf16.cu``) launched in bf16;
         K5 + the transpose's decoded-plane cotangent also within the share
         limit (``BF16_SHARE_LIMIT``), read beside a noise floor and
         planted faults (the row sums or the cotangent unrounded, the f32
         kernels), each of which must miss a limit;
         K4, K5 (with its transpose) and the transpose alone timed against
         their plain versions, the transpose also against ``torch.bmm`` of
         the bf16-rounded dense ``wy`` (its ``library_ms``); Mrays/s and
         peak memory;
    12c. ``live_fractions`` on the decoded mean channel at density 0.05 and
         0.2: K4's live bytes on both paths equal the plain version's
         except tiles with a ray within 1e-6 of a cutoff, the image and
         checkpoints bitwise those without the map, K4 with the map timed
         against K4 without it in turns;
    12d. a 128^3 x 16 file through ``io/native.py
         read_histograms_bins_major`` (bf16 and f32), byte for byte the
         Python reader's, both timed in turns (host clock): the native load
         must not be the slower, and ``render-hist`` must name it;
    12e. ``ViewerServer`` on port 0 over a ``RenderPipeline`` on the card
         (Isabel's 50 x 50 x 10 x 32 raw blocks, 512^2): four ``/frame``
         requests (one rotated, two ``fmt=rgb``) byte for byte the
         pipeline's uint8 render of the same parameters, the unrotated
         ones testing ESS in K1 (bits held) with no bitmap kernel
         launched, and the pipelined protocol's lag and flush; the frame
         (query 1) timed;
13a. the shapes only the bench gives the kernels (its ``big`` section):
    the bench's own calls on its own fixtures, K1 and the fwd+bwd (K4 + K5,
    ``wrt=("volume", "lut")``) of the 1024^3 float32 volume -> 1024^2 and
    K2's mean over the 512^3 x 32 bf16 volume (2^32 elements, past 32-bit
    indexing), once with the counters reset before and read after (each
    must launch once), each output against its plain version (image
    tolerance; gradients 1e-3 relative L2), then K4 and K5 alone against
    theirs; each kernel timed (median of 10, CUDA events) and bounded;
13. (run last) ``python -m vrdd_tpu_torch.cli bench --full`` at its full
    sizes as a subprocess, every section: it must exit 0 with a last line
    under 1500 characters that parses and holds a ``value``, its route and
    one number per BASELINE config, every number of its record finite (the
    scaling efficiencies of a world of one excepted), every roofline share
    at most 1.05, every kernel of its path launched, and its in-kernel mean
    fwd+bwd rate within 25% of phase 6's (staged, CUDA events).

Every sweep kernel runs by default on the fetch path its wrapper chooses
(staged where the footprint fits shared memory, K5 on scalar planes
direct); phases 5, 7 and 8 also time the other path and hold the two
bitwise (K5: ``d_planes`` within 1e-6 relative L2).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Each kernel's record holds its launches
and its launches on the staged path (``staged_launches``; null for the ESS
bitmap, which has one path and no launch on the main path: the sweeps
test ESS themselves) in the main-path run (a seeded kernel's: its
seeded launches in the
streamed fit-voxels run; K1's seeded launches are those of 8a, its split
stack, as no fit-voxels path resumes K1; the rotated views' K4/K5: their
launches on the m-grid in the unstreamed run; phase 11's: their launches in
its drive, with ``ms`` the time of the path's per-shard launches,
replayed, and ``staged_launches`` null), its error against the plain
version, its ms on the staged path and ``direct_ms`` on the direct path
(each the mean of two medians of warm runs, CUDA events, timed in turns),
the plain version's ms (with ESS also the frame's ``frame_ms``; the
bitmap's ``device_ms`` and ``wrapper_host_ms`` beside its call's ``ms``),
and
``bound_ms``: the
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

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

from vrdd_tpu_torch.utils.compare import rel_l2 as compare_rel_l2
from vrdd_tpu_torch.utils.compare import storage_ulp, where_off
from vrdd_tpu_torch.utils.roofline import (
    K5_SAMPLE_OPS, SAMPLE_OPS, bound, decode_ops, ess_pair_ops,
    ess_table_ops, live_samples,
)

ROOT = Path(__file__).resolve().parent
TOL = 1e-4           # abs, per channel
FLIP_BUDGET = 1e-3   # share of pixels allowed past TOL (cutoff flips)
GRAD_TOL = 1e-3      # relative L2 of gradients (atomics, cutoff flips)
FLEX_STATS_TOL = 2e-6  # of a channel's largest (float32 rounding, log2f)
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


def rel_l2(got, ref, what, limit=GRAD_TOL):
    """Relative L2 error (``utils.compare.rel_l2``); fails past ``limit``,
    on a non-finite ``got`` or an all-zero ``ref``."""
    try:
        err = compare_rel_l2(got, ref)
    except ValueError as e:
        fail(f"{what}: {e}")
    print(f"  {what}: rel L2 {err:.3e}")
    if err > limit:
        fail(f"{what}: rel L2 {err:.3e} (limit {limit:g})")
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


def held_bits(fn, what):
    """Runs ``fn`` on both fetch paths with the bits of its in-kernel ESS
    tests written out; fails unless it tested ESS in the kernel and every
    launch's bits are byte for byte its test's plain bitmap
    (``ess_bitmap_reference``). Returns the staged run's ``(bits, test)``
    pairs."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk

    got = {}
    for staged in (True, False):
        with sk._fetch_path(staged), sk._ess_bits() as pairs:
            fn()
        torch.cuda.synchronize()
        if not pairs:
            fail(f"{what}: no launch tested ESS in the kernel")
        for bits, test in pairs:
            n_diff = int((bits != test.reference()).sum())
            if n_diff:
                path = "staged" if staged else "direct"
                fail(f"{what}: {n_diff} of {bits.numel()} in-kernel ESS "
                     f"bits differ from the plain bitmap ({path} fetch)")
        got[staged] = pairs
    print(f"  [{what}] in-kernel ESS bits of {len(got[True])} + "
          f"{len(got[False])} launches (staged, direct fetch) byte for byte "
          f"ess_bitmap_reference ({got[True][0][0].numel()} (tile, chunk) "
          "bytes each)")
    return got[True]


def bitmap_times(stats, zs, slopes, lut, tscl, *, width, height, ny, nx,
                 tex_offset, chunk=8, runs=100):
    """The standalone ESS bitmap's time, split into the kernel's and the
    wrapper's: ``(device_ms, host_ms, event_ms)``, the raw
    ``vrdd_ess_bitmap`` launch (parameters built once) ``runs`` times back
    to back between two CUDA events, over ``runs``; the wrapper
    ``ess_bitmap`` called ``runs`` times on the host clock, over ``runs``
    (its enqueue); one wrapper call between two CUDA events on an idle
    device, the median of ``runs`` (what ``time_ms`` reads). ``zs`` and
    ``lut`` on the card, as the render path passes them; fails unless the
    raw launch writes the wrapper's bytes."""
    import torch

    from vrdd_tpu_torch.kernels import _build
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.utils.config import MarchConfig

    march = MarchConfig()

    def wrapper():
        return sk.ess_bitmap(stats, zs, ORIGIN, slopes, lut, 0.0, tscl,
                             width=width, height=height, ny=ny, nx=nx,
                             plane_chunk=chunk, march=march,
                             tex_offset=tex_offset)

    ref = wrapper()
    ox, oy, oz = sk._host_floats(ORIGIN, 3)
    mx0, dmx, my0, dmy = sk._host_floats(slopes, 4)
    p = sk._ess_params(dict(
        ox=ox, oy=oy, oz=oz, mx0=mx0, dmx=dmx, my0=my0, dmy=dmy,
        xlo=march.box_min[0], xhi=march.box_max[0], ylo=march.box_min[1],
        yhi=march.box_max[1], tex_offset=float(tex_offset), sx=1.0, sy=1.0,
        tf_off=0.0, tf_scale=float(tscl), n_planes=zs.numel(),
        height=height, width=width, ny=ny, nx=nx,
    ), sk._ESS_Q_MARGIN, chunk, lut.shape[0])
    pmin, pmax = (t.contiguous() for t in stats)
    raw = torch.empty_like(ref)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.vrdd_ess_bitmap(p, pmin.data_ptr(), pmax.data_ptr(),
                                 zs.data_ptr(), lut.data_ptr(),
                                 raw.data_ptr(), stream)
        if rc:
            fail(f"vrdd_ess_bitmap: CUDA error {rc}")

    launch()
    torch.cuda.synchronize()
    if not torch.equal(raw, ref):
        fail("the raw bitmap launch differs from the wrapper's bitmap")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        launch()
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        wrapper()
    host = 1e3 * (time.perf_counter() - t0) / runs
    torch.cuda.synchronize()
    return device_ms, host, time_ms(wrapper, runs)


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
    """The training main path at full size; returns the kernel records, the
    Mrays/s by stat and route, and the decode chain's launches in each
    route's main-path run."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import slice_render_image

    print(f"[6] training main path, {n}^3 x {B} bf16 -> {W}^2, loss "
          f"mean((img - 0.25)^2), wrt (hist, lut), on {card} ({smi})")
    counters = diff_counters()
    lut0 = torch.as_tensor(tf, device=dev)
    records, mrays, chain_launches = [], {}, {}
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
        sk.decode_chain.launches = 0
        with torch.no_grad():
            img3 = render(hist, lut0)
        loss, img, gh, gl = fwd_bwd()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        staged = {c.__name__: c.staged_launches for c in counters}
        chain_launches[tag] = sk.decode_chain.launches
        print(f"  [{tag}] launches in the main-path run: {launches}, on the "
              f"staged path: {staged}, decode_chain: {chain_launches[tag]}, "
              f"loss {float(loss.detach()):.6f}")
        if any(v == 0 for v in launches.values()):
            fail(f"{tag}: a kernel of the training path was not launched")
        if chain_launches[tag] != 1:
            fail(f"{tag}: the backward launched the decode chain kernel "
                 f"{chain_launches[tag]} times, not once")
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
        dec_ops = decode_ops(mode if inkernel else "none", B)
        fwd_ops = n_live * (SAMPLE_OPS + dec_ops)
        # the volume bytes the live samples' taps read, each once
        vol_bytes = n_texels * (vol.numel() // (n * n * n)) * vol.element_size()
        img_bytes, tck_bytes = W * W * 16, cfg.n_chunks * W * W * 4
        d_bytes = n * n * n * 4 * (3 if (inkernel and mode == "var") else 1)
        bounds = {
            "sweep_fwd": bound(vol_bytes + img_bytes, fwd_ops),
            "sweep_fwd_ckpt": bound(vol_bytes + img_bytes + tck_bytes,
                                    fwd_ops),
            "sweep_bwd": bound(vol_bytes + tck_bytes + img_bytes + d_bytes,
                               n_live * (K5_SAMPLE_OPS + dec_ops)),
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
    return records, mrays, chain_launches


# FP32 ops a bin and voxel: the variance without K5's moments adds its own
# three moment FMAs a bin
CHAIN_OPS = {"linear": 1, "var": 9, "var_own": 15, "entropy": 5}


def phase_6b(dev, card, smi, hist, n, B, chain_launches):
    """The decode's histogram cotangent at full size: the chain kernel
    against its plain version, timed, for linear, the variance from K5's
    moments (the in-kernel route's backward) and from its own (the
    materialized route's), and entropy; returns the kernel records, each
    with the launches counted in the phase 6 main-path run that calls the
    kernel so (``chain_launches``, by that run's tag)."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk

    print(f"[6b] decode chain, {n}^3 x {B} {hist.dtype} d_hist from a "
          f"seeded d_dec, on {card} ({smi})")
    gen = torch.Generator(device=dev).manual_seed(16)
    d_dec = torch.randn((n, n, n), device=dev, generator=gen)
    vox, elem = n ** 3, hist.element_size()
    records = []
    for chain, stat, tag in (("linear", "mean", "mean,inkernel"),
                             ("var", "var", "var,inkernel"),
                             ("var_own", "var", "var,materialized"),
                             ("entropy", "entropy", "entropy,inkernel")):
        rows_np, mode = sk.decode_weight_rows(stat, B, family="unit")
        rows = torch.from_numpy(rows_np).to(dev)
        mom = None
        if chain == "var":
            # K5's moments [m, 2 (m C0 - C1)], a few z-layers at a time
            mom = torch.empty((n, 2, n, n), device=dev)
            for z0 in range(0, n, 32):
                m, c1, _, c0 = sk._moments(hist[z0:z0 + 32].float(), rows)
                mom[z0:z0 + 32, 0] = m
                mom[z0:z0 + 32, 1] = 2.0 * (m * c0 - c1)

        def kernel(rows=rows, mode=mode, mom=mom):
            return sk.decode_chain(hist, rows, mode, d_dec, mom)

        def plain(rows=rows, mode=mode, mom=mom):
            return sk.decode_chain_reference(hist, rows, mode, d_dec, mom)

        before = sk.decode_chain.launches
        got = kernel()
        torch.cuda.synchronize()
        if sk.decode_chain.launches != before + 1:
            fail(f"[6b {chain}] decode_chain did not launch its kernel once")
        ref = plain()
        if chain in ("var_own", "entropy"):
            # entropy's log2 is the card's: within one bf16 rounding on at
            # most 1e-4 of the elements, 0 at every empty bin. The variance's
            # own moments sum in bin order, the plain einsum's in its own:
            # within one bf16 rounding over the float32 noise of the
            # cancellation, 1e-5 of the largest (the card tests' limit)
            noise = 1e-5 * float(ref.abs().max()) if chain == "var_own" else 0
            n_off = n_ulp = n_far = n_zero = 0
            for z0 in range(0, n, 64):  # float32 copies of 64 layers at most
                a, b = got[z0:z0 + 64].float(), ref[z0:z0 + 64].float()
                ulp = storage_ulp(torch.maximum(a.abs(), b.abs()), hist.dtype)
                n_off += int((a != b).sum())
                n_ulp += int(((a - b).abs() > ulp).sum())
                n_far += int(((a - b).abs() > ulp + noise).sum())
                if chain == "entropy":
                    n_zero += int((a[hist[z0:z0 + 64] == 0] != 0).sum())
            share = n_off / got.numel()
            print(f"  [6b {chain}] elements off: {share:.3e}, past one bf16 "
                  f"rounding: {n_ulp}"
                  + (f", nonzero at an empty bin: {n_zero}"
                     if chain == "entropy" else
                     f", past it and {noise:.3e}: {n_far}"))
            if chain == "entropy" and (n_ulp or share > 1e-4 or n_zero):
                fail(f"[6b {chain}] kernel differs from the plain chain")
            if n_far:
                fail(f"[6b {chain}] kernel differs from the plain chain")
            del a, b, ulp
        else:
            bitwise(got, ref, f"[6b {chain}] decode chain")
        del got, ref
        ms = time_ms(kernel, TIMED_RUNS)
        plain_ms = time_ms(plain, 3)
        reads_hist = chain in ("var_own", "entropy")
        n_bytes = (vox * B * elem + vox * 4
                   + (vox * B * elem if reads_hist else 0)
                   + (vox * 8 if mom is not None else 0))
        bd = bound(n_bytes, vox * B * CHAIN_OPS[chain])
        print(f"  [6b {chain}] kernel {ms:.3f} ms ({n_bytes / ms / 1e9:.3f} "
              f"TB/s), bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}: "
              f"{n_bytes / 1e9:.3f} GB), {ms / bd['bound_ms']:.2f}x; plain "
              f"{plain_ms:.3f} ms; launches in phase 6's {tag} backward: "
              f"{chain_launches[tag]}")
        records.append({
            "name": f"decode_chain[{chain}]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/decode_chain.cu",
            "replaces": "vrdd_tpu/pallas/slice_vjp.py:877-908 (XLA)",
            "launches": chain_launches[tag], "staged_launches": None,
            "max_abs_err": None, "ms": ms, "direct_ms": None,
            "plain_ms": plain_ms, **bd,
        })
        del mom
        torch.cuda.empty_cache()
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
    print(f"  launches in the main-path run: K1 {k1.launches}, testing ESS "
          f"in the kernel {k1.ess_launches}, ESS bitmap kernel "
          f"{bm.launches}, K1 staged {k1.staged_launches} (per query, K1 / "
          f"testing ESS / bitmap / staged: {launches})")
    if (k1.launches == 0 or k1.ess_launches != k1.launches
            or bm.launches != 0):
        fail("7b: the render path did not run K1 with its in-kernel ESS "
             "test alone (no bitmap kernel)")
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
    tf_dev = torch.as_tensor(tf, device=dev)
    for q in (1, 2, 3, 7):
        cfg = config(q, W, 6.0)  # peaked histograms: narrow
        check_image(images[q], f"7b q{q}", W)
        held_bits(lambda cfg=cfg: pipe.render(iv, cfg, "auto"),
                  f"7b q{q} frame")
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
        zs_dev = torch.as_tensor(zs, device=dev)
        bargs = (stats, zs, ORIGIN, slopes, tf, 0.0, tscl)
        bkw = dict(width=W, height=W, ny=n, nx=n, plane_chunk=8, march=march,
                   tex_offset=toff)
        bm_dev_ms, bm_host_ms, bitmap_ms = bitmap_times(
            stats, zs_dev, slopes, tf_dev, tscl, width=W, height=W, ny=n,
            nx=n, tex_offset=toff)
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
            """The public K1 wrapper, with ESS from the cached plane stats
            (tested in the kernel) or without."""
            return k1(planes, zs, ORIGIN, slopes, tf, 0.05, 1.0, 0.0, tscl,
                      width=W, height=W, tex_offset=toff,
                      empty_space_skip=culled,
                      ess_stats=stats if culled else None)

        for bits, _ in held_bits(lambda: k1_run(True), f"7b q{q} K1"):
            if not torch.equal(bits, ess_ref):
                fail(f"7b q{q}: K1's in-kernel ESS bits differ from the "
                     "plain bitmap of this run's own arguments")
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
        n_tiles = ess[0].numel()
        test_ops = (ess.numel() * ess_pair_ops(8)
                    + n_tiles * ess_table_ops(len(tf)))
        # the bitmap kernel: a table per block of 256 threads
        bd_bm = bound(stats_bytes + P * 4 + lut_bytes + ess.numel(),
                      ess.numel() * ess_pair_ops(8)
                      + -(-ess.numel() // 256) * ess_table_ops(len(tf)))
        # K1 testing ESS: the plane texels its live samples read, the
        # stats, the image; and the tests of every (tile, chunk)
        bd = bound(tex_live * 4 + stats_bytes + img_bytes,
                   n_live * SAMPLE_OPS + test_ops)
        bd_all = bound(tex_all * 4 + img_bytes, n_all * SAMPLE_OPS)
        print(f"  [7b q{q}] frame {frame_ms:.3f} ms "
              f"({W * W / frame_ms / 1e3:.2f} MTexels/s); ESS plane stats "
              f"{ess_ms:.3f} ms (once per volume); per frame: pre-blend "
              f"{blend_ms:.3f} ms; K1 testing ESS {k1_ess_ms:.3f} ms "
              f"(direct fetch {k1_ess_direct:.3f}; bound "
              f"{bd['bound_ms']:.4f}, {bd['bound_by']}), K1 {k1_ms:.3f} ms "
              f"(bound {bd_all['bound_ms']:.4f}, {bd_all['bound_by']}); "
              f"the bitmap kernel alone: device {bm_dev_ms:.4f} ms, its "
              f"wrapper's enqueue {bm_host_ms:.4f} ms (host clock), a call "
              f"{bitmap_ms:.4f} ms (CUDA events; bound "
              f"{bd_bm['bound_ms']:.4f}, plain {bitmap_plain_ms:.3f}); "
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
            "device_ms": bm_dev_ms, "wrapper_host_ms": bm_host_ms,
            "direct_ms": None, "plain_ms": bitmap_plain_ms, **bd_bm,
        })
        records.append({
            "name": f"sweep_preblended_planes[ess,q{q}]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_kernel.py:1351",
            "launches": launches[q][1], "staged_launches": launches[q][3],
            "max_abs_err": err, "ms": k1_ess_ms, "direct_ms": k1_ess_direct,
            "frame_ms": frame_ms,
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
    for c in counters[:2]:
        c.ess_launches = 0
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
            bitmap_launches = bm.launches
    print(f"  [7b diff, wrt volume] launches with ESS: {diff_launches}, of "
          f"them testing ESS in the kernel: {ess_launches}, ESS bitmap "
          f"kernel {bitmap_launches}; staged: {diff_staged}")
    if (min(diff_launches.values()) == 0 or min(ess_launches.values()) == 0
            or bitmap_launches):
        fail("7b diff: K3/K4 testing ESS in the kernel or K5 was not "
             "launched, or the bitmap kernel was")
    if not (torch.equal(out[True][0], out[False][0])
            and torch.equal(out[True][1], out[False][1])):
        fail("7b diff: the image with ESS is not bitwise the one without")
    rel = rel_l2(out[True][2], out[False][2], "[7b diff] d_volume ESS vs no ESS")
    if rel > 1e-6:
        fail(f"7b diff: d_volume with ESS {rel:.3e} from without (limit 1e-6)")
    held_bits(lambda: sv.pallas_slice_render_diff(
        vol.clone().requires_grad_(), ORIGIN, tf, empty_space_skip=True,
        **kw), "7b diff K4")
    del out, img3, img4, g, v
    planes, zs = preblend_planes(vol, P, march.box_min, march.box_max, -1)
    cfg = sv.planes_config(zs, ORIGIN, slopes, width=W, height=W, n_planes=P,
                           plane_chunk=ck)
    test = sk._resolve_ess(
        True, None, planes, zs, ORIGIN, slopes, tf, 0.0, 1.0, width=W,
        height=W, plane_chunk=ck, march=march, tex_offset=0.5,
        axis_scale=(1.0, 1.0), reverse_planes=False)
    ess = bm(sk.ess_plane_stats(planes), zs, ORIGIN, slopes, tf, 0.0, 1.0,
             width=W, height=W, ny=n, nx=n, plane_chunk=ck)
    ess_cfg = dataclasses.replace(cfg, ess=test)
    args = (planes, None, torch.as_tensor(tf, device=dev),
            torch.tensor(0.05, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    k4 = {name: sv.sweep_fwd_ckpt(dataclasses.replace(cfg, ess=e), *args,
                                  live_map=True)
          for name, e in (("none", None), ("test", test))}
    if not (all(torch.equal(a, b) for a, b in zip(k4["test"], k4["none"]))
            and torch.equal(sv.sweep_fwd(ess_cfg, *args), k4["none"][0])):
        fail("7b diff: K3/K4 with ESS (image, checkpoints, live map) not "
             "bitwise without")
    for fn in (sv.sweep_fwd, sv.sweep_fwd_ckpt):
        for bits, _ in held_bits(lambda fn=fn: fn(ess_cfg, *args),
                                 f"7b diff {fn.__name__}"):
            if not torch.equal(bits, ess):
                fail(f"7b diff {fn.__name__}: in-kernel ESS bits differ from "
                     "the bitmap kernel's")
    n_live, tex_live = live_samples(planes, zs, slopes, tf, 0.05, 0.0, 1.0,
                                    W, W, ess=ess, chunk=ck)
    test_ops = (ess.numel() * ess_pair_ops(ck)
                + ess[0].numel() * ess_table_ops(len(tf)))
    for name, fn, ref_fn, extra in (
            ("sweep_fwd", sv.sweep_fwd, sv.sweep_fwd_reference, 0),
            ("sweep_fwd_ckpt", sv.sweep_fwd_ckpt,
             sv.sweep_fwd_ckpt_reference, cfg.n_chunks * W * W * 4)):
        def run(fn=fn):
            return fn(ess_cfg, *args)

        k_ms, d_ms = paths_ms(lambda st: on_path(st, run))
        p_ms, ref = timed_once(lambda ref_fn=ref_fn: ref_fn(ess_cfg, *args))
        got = fn(ess_cfg, *args)
        direct = on_path(False, run)()
        for a, b in (zip(got, direct) if isinstance(got, tuple)
                     else ((got, direct),)):
            bitwise(a, b, f"[7b diff] {name}+ESS staged vs direct")
        if name == "sweep_fwd_ckpt":
            compare(got[1][..., None], ref[1][..., None],
                    f"[7b diff] {name}+ESS checkpoints vs plain")
            got, ref = got[0], ref[0]
        e = compare(got, ref, f"[7b diff] {name}+ESS vs plain+bitmap")
        # the kernel testing ESS: its live texels, the stats, the image
        # (and K4's checkpoint rows, every one written), and its tests
        bd = bound(tex_live * 4 + 2 * planes.shape[0] * 64 * 4 + img_bytes
                   + extra, n_live * SAMPLE_OPS + test_ops)
        print(f"  [7b diff] {name} testing ESS: staged {k_ms:.3f} ms, direct "
              f"{d_ms:.3f} ms; plain {p_ms:.3f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; {n_live} evaluated "
              f"samples, {tex_live} texels read)")
        records.append({
            "name": f"{name}[ess]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_vjp.py:"
                        f"{698 if name == 'sweep_fwd' else 714}",
            "launches": ess_launches[name],
            "staged_launches": diff_staged[name], "max_abs_err": e,
            "ms": k_ms, "direct_ms": d_ms, "plain_ms": p_ms, **bd,
        })
    del pipe, hist, vol, planes, k4
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
               n_live * K5_SAMPLE_OPS), 787, "slice_vjp_staged.cu"),
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


def profile_step(step, what, top=8, cpu_top=0):
    """One warm call of ``step`` under torch.profiler: the ``top`` costliest
    CUDA kernels by device time, and the device's busy share of the step's
    host-clock time (idle share = 1 - busy; kernels run on one stream, so
    their times add). Counts kernel events only: the op that launched a
    kernel carries the same device time. Prints "not measured" where the
    profiler sees no kernel. ``cpu_top``: also the costliest host ops by
    their own (self) CPU time."""
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
    if cpu_top:
        print(f"  [{what}] costliest host ops (self CPU time):")
        host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                      reverse=True)
        for e in host[:cpu_top]:
            print(f"    {1e-3 * e.self_cpu_time_total:8.3f} ms x{e.count:<5d} "
                  f"{e.key[:70]}")


def shearwarp_setup(vol, view, W, n_planes, axis_scale=(1.0, 1.0, 1.0)):
    """The fused sweep of one rotated shear-warp frame, as
    ``shearwarp_render_image(backend='pallas')`` builds it: ``(cfg, planes,
    wi, origin, dz_sign, axis)`` for K3/K4/K5 and their plain versions;
    ``axis_scale`` are per-world-axis filter-grid scales, permuted with the
    volume (``cfg.axis_scale`` holds the permuted x and y ones)."""
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
    ascale = tuple(float(axis_scale[i]) for i in (px, py, pz))
    vol_p = vol.permute(2 - pz, 2 - py, 2 - px).contiguous()
    planes, zs = preblend_planes(vol_p, n_planes, march.box_min,
                                 march.box_max, dz_sign, z_scale=ascale[2])
    origin = tuple(float(iv[i, 3]) for i in (px, py, pz))
    cfg = sv.planes_config(zs, origin, mgrid, dz_sign=dz_sign, width=wi,
                           height=wi, n_planes=n_planes, plane_chunk=4,
                           axis_scale=ascale[:2])
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
                   n_live * K5_SAMPLE_OPS), 787)):
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


def render_cfg(q, W, density=0.05, tf_scale=1.0):
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig, TransferFunctionConfig)

    return RenderConfig(camera=CameraConfig(width=W, height=W),
                        density=density, query_method=QueryMethod(q),
                        tf=TransferFunctionConfig(scale=tf_scale))


def check_frame(img, what, W):
    import torch

    if tuple(img.shape) != (W, W, 4) or not torch.isfinite(img).all():
        fail(f"{what}: bad output")
    if float(img[..., 3].max()) <= 0.0:
        fail(f"{what}: empty image")


def auto_frames(pipe, cfgs, W, tag):
    """The unrotated main-path run of ``cfgs`` (query -> config) through
    ``renderer='auto'``, which must resolve to K1 testing ESS in the kernel:
    the launch counters (K1, its ESS and staged launches, the bitmap
    kernel) reset before and read after; no frame may launch the bitmap
    kernel. Then per query: the in-kernel ESS bits against the plain bitmap
    on both fetch paths, the frame bitwise on the direct fetch path and
    without ESS, against the plain 'slice' renderer at the image tolerance,
    and its ms (host clock, median of 5). Returns the per-query launches
    ``(K1, with ESS, bitmap, staged)`` of the main-path run and the frame
    times ``{q: ms}``."""
    import torch

    from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
    from vrdd_tpu_torch.kernels import slice_kernel as sk

    k1, bm = sk.sweep_preblended_planes, sk.ess_bitmap
    iv = default_benchmark_inv_view()
    for q, cfg in cfgs.items():
        if pipe.resolve_renderer("auto", iv, cfg) != "pallas":
            fail(f"{tag} q{q}: 'auto' did not resolve to the fused kernel")

    def counts():
        return (k1.launches, k1.ess_launches, bm.launches, k1.staged_launches)

    k1.launches = k1.ess_launches = k1.staged_launches = bm.launches = 0
    images, launches, frames = {}, {}, {}
    for q, cfg in cfgs.items():
        before = counts()
        images[q] = pipe.render(iv, cfg, "auto")
        launches[q] = tuple(c - b for c, b in zip(counts(), before))
    torch.cuda.synchronize()
    print(f"  [{tag}] launches in the main-path run (per query, K1 / "
          f"testing ESS / bitmap kernel / staged): {launches}")
    if any(v != (1, 1, 0, 1) for v in launches.values()):
        fail(f"{tag}: each frame must launch K1 testing ESS in the kernel "
             f"once, on the staged path, and no bitmap kernel: {launches}")
    for q, cfg in cfgs.items():
        img = images[q]
        check_frame(img, f"{tag} q{q}", cfg.camera.width)
        held_bits(lambda cfg=cfg: pipe.render(iv, cfg, "auto"),
                  f"{tag} q{q} frame")
        bitwise(on_path(False, lambda cfg=cfg: pipe.render(iv, cfg, "auto"))(),
                img, f"{tag} q{q}: K1+ESS staged vs direct")
        pipe.empty_space_skip = False
        bitwise(pipe.render(iv, cfg, "pallas"), img,
                f"{tag} q{q}: K1 with ESS vs without")
        pipe.empty_space_skip = True
        slice_ms, ref = timed_once(lambda cfg=cfg: pipe.render(iv, cfg,
                                                               "slice"))
        compare(img, ref, f"[{tag} q{q}] auto (K1+ESS) vs slice")
        frames[q] = host_ms(lambda cfg=cfg: pipe.render(iv, cfg, "auto"), 5)
        print(f"  [{tag} q{q}] frame {frames[q]:.3f} ms "
              f"({W * W / frames[q] / 1e3:.2f} MTexels/s), plain slice "
              f"{slice_ms:.3f} ms")
        del ref
    return launches, frames


def rotated_frame(pipe, cfg, view, tag):
    """One rotated frame through 'auto', which must resolve to shear-warp
    and launch K3 once; against the 'xla' shear-warp (same channel, scales
    and plane count) at the image tolerance. Returns ``(launches, staged)``
    of K3."""
    import torch

    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march import shearwarp as sw

    W = cfg.camera.width
    iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
    if pipe.resolve_renderer("auto", iv, cfg) != "shearwarp":
        fail(f"{tag} {view}: 'auto' did not resolve to shear-warp")
    k3 = sv.sweep_fwd
    k3.launches = k3.staged_launches = 0
    img = pipe.render(iv, cfg, "auto")
    torch.cuda.synchronize()
    launches, staged = k3.launches, k3.staged_launches
    if launches != 1:
        fail(f"{tag} {view}: the frame launched K3 {launches} times")
    check_frame(img, f"{tag} {view}", W)
    q = cfg.query_method
    vol = pipe._stats_channel(q)
    xla_ms, ref = timed_once(lambda: sw.shearwarp_render_image(
        vol, iv, W, W, pipe.tf_lut, cfg.density, cfg.brightness,
        cfg.tf.offset, cfg.tf.scale, march=cfg.march,
        n_planes=max(64, 2 * vol.shape[0]), tex_offset=pipe._tex_offset(q),
        axis_scale=pipe._flex_axis_scale(q), backend="xla"))
    compare(img, ref, f"[{tag} {view}] auto (K3) vs 'xla' shear-warp")
    frame_ms = host_ms(lambda: pipe.render(iv, cfg, "auto"), 5)
    print(f"  [{tag} {view}] shear-warp frame {frame_ms:.3f} ms "
          f"({W * W / frame_ms / 1e3:.2f} MTexels/s), K3 launches {launches} "
          f"(staged {staged}), 'xla' frame {xla_ms:.3f} ms")
    return launches, staged


def fractal_decode_oracle(t, cb, eb, ev, idx):
    """The decode of voxels ``idx`` by the reference's per-voxel steps, in
    numpy (the loop of io/synthetic.synthetic_fractal_volume): template,
    flip, shift, each error added with a clamp after it, renormalize."""
    import numpy as np

    t = t.cpu().numpy()
    cb, eb, ev = (a.reshape(-1, a.shape[-1])[idx].cpu().numpy()
                  for a in (cb, eb, ev))
    n_bins = t.shape[1]
    out = np.zeros((len(idx), n_bins), np.float32)
    for i, (tid, shift, flip, ne) in enumerate(cb):
        tt = t[tid][::-1] if flip else t[tid]
        dec = np.roll(tt, shift).astype(np.float32)
        for b, v in zip(eb[i, :ne], ev[i, :ne]):
            dec[b] = max(np.float32(0.0), dec[b] + v)
        s = dec.sum()
        out[i] = dec / s if s > 0 else dec
    return out


def flex_counts(sat, raw, block, vmax):
    """``(integral-histogram counts, direct counts)`` of every block of a
    volume that tiles: the grid query of the integral histogram ``sat``
    (``block_edges``, ``query_blocks``) and a direct per-block count of the
    voxels' bins, each ``(Zb, Yb, Xb, n_bins)`` float32."""
    import torch

    from vrdd_tpu_torch.ops.integral import block_edges, query_blocks

    n_bins = sat.shape[3]
    nz, ny, nx = raw.shape
    zb, yb, xb = nz // block, ny // block, nx // block
    counts = query_blocks(sat, [block_edges(n, block, raw.device)
                                for n in raw.shape])
    bins = torch.clamp((raw / vmax * n_bins).to(torch.int32), 0, n_bins - 1)
    blocks = bins.reshape(zb, block, yb, block, xb, block).permute(
        0, 2, 4, 1, 3, 5).reshape(zb, yb, xb, -1).long()
    direct = torch.zeros((zb, yb, xb, n_bins), dtype=torch.float32,
                         device=raw.device)
    direct.scatter_add_(-1, blocks, torch.ones_like(blocks,
                                                    dtype=torch.float32))
    return counts, direct


def flex_slider(pipe, integral, cfgs, W, sizes):
    """The explorer's main path: at each block size of ``sizes`` a re-query
    of the resident integral histogram (``IntegralVolume.blocks``), its
    min-max map handed to the pipeline (``set_flexible``) and the frames of
    ``cfgs`` through 'auto', with the re-query kernel's launch counter reset
    before and read after (one launch a re-query); each frame bitwise a
    fresh pipeline's at that block size. Returns ``{block: launches}``."""
    import torch

    from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
    from vrdd_tpu_torch.kernels import flex_blocks as fb
    from vrdd_tpu_torch.models.pipeline import RenderPipeline

    iv = default_benchmark_inv_view()
    launches = {}
    for b in sizes:
        torch.cuda.synchronize()
        fb.block_stats.launches = 0
        t0 = time.perf_counter()
        vol = integral.blocks(b).normalized()
        pipe.set_flexible(vol)
        images = {q: pipe.render(iv, cfg, "auto") for q, cfg in cfgs.items()}
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches[b] = fb.block_stats.launches
        print(f"  [9b slider] blocks of {b} -> {vol.n_blocks}: a re-query "
              f"and {len(cfgs)} frames in {ms:.3f} ms (host clock, the first "
              f"at this size), re-query kernel launches {launches[b]}")
        if launches[b] != 1:
            fail(f"9b: the re-query at blocks of {b} launched the re-query "
                 f"kernel {launches[b]} times")
        fresh = RenderPipeline(flexible=vol)
        for q, cfg in cfgs.items():
            check_frame(images[q], f"9b slider b{b} q{q}", W)
            bitwise(fresh.render(iv, cfg, "auto"), images[q],
                    f"9b slider b{b} q{q}: after set_flexible vs a fresh "
                    "pipeline")
        del fresh, images
    return launches


def flex_requery_records(integral, shape, slider):
    """The re-query kernel (``kernels/flex_blocks.py block_stats``) on the
    resident integral histogram at each block size of ``slider`` (block ->
    its launches in the main-path run): held to its plain version
    (``query_blocks``, then the clamp-normalize and the stats) on the same
    card tensors, each channel within ``FLEX_STATS_TOL`` of its largest
    magnitude, and bitwise on a second launch; both timed (CUDA events,
    medians of 10 and 3); bound: each distinct corner row of the table read
    once and the grid written once (``benchmark/roofline/flex.py``).
    Returns a record a block size."""
    import torch

    from benchmark.roofline.flex import requery_work
    from vrdd_tpu_torch.kernels import flex_blocks as fb
    from vrdd_tpu_torch.models.flexible import _stats
    from vrdd_tpu_torch.ops.integral import query_blocks

    sat = integral.sat
    B = sat.shape[3]
    records = []
    for b, launches in slider.items():
        edges = integral.edges(b)

        def plain():
            return _stats(query_blocks(sat, edges))

        def kernel():
            return fb.block_stats(sat, edges)

        got, want = kernel(), plain()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"9b: the re-query kernel at blocks of {b} gave "
                 f"{tuple(got.shape)} (plain {tuple(want.shape)}) or a "
                 "non-finite stat")
        scale = want.abs().reshape(-1, 3).amax(0).clamp(min=1e-30)
        err = float((got - want).abs().max())
        gap = ((got - want).abs() / scale).reshape(-1, 3).amax(0).tolist()
        bitwise(kernel(), got, f"9b: the re-query kernel at blocks of {b}, "
                "two launches")
        ms = time_ms(kernel, TIMED_RUNS)
        p_ms = time_ms(plain, 3)
        n_bytes, n_ops = requery_work(shape, b, B)
        bd = bound(n_bytes, n_ops)
        print(f"  [9b] re-query kernel, blocks of {b} -> "
              f"{tuple(got.shape[:3])}: {ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; "
              f"{n_bytes} bytes); against the plain version: max abs "
              f"{err:.3e}, of each channel's largest (mean, variance, "
              f"entropy) {gap[0]:.3e}, {gap[1]:.3e}, {gap[2]:.3e}")
        if max(gap) > FLEX_STATS_TOL:
            fail(f"9b: the re-query kernel at blocks of {b} is {max(gap):.3e} "
                 f"of a channel's largest from its plain version (limit "
                 f"{FLEX_STATS_TOL:g})")
        records.append({
            "name": f"flex_block_stats[b{b}]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/flex_blocks.cu",
            "replaces": "vrdd_tpu/ops/integral.py:66", "launches": launches,
            "max_abs_err": err, "max_gap_of_largest": max(gap), "ms": ms,
            "plain_ms": p_ms, **bd,
        })
        del got, want
    return records


def flex_k1_records(pipe, tf, q, W):
    """K1 on query ``q``'s zero-padded flex grid with its filter-grid scales
    (the pipeline's own channel), with ESS (tested in the kernel from
    cached plane stats at the grid's z scale; its bits held against the
    plain bitmap) and without: each timed on both fetch paths, held against
    its plain version and bitwise across paths; bounds from this run's live
    samples. Returns two records."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.march.slice import preblend_planes
    from vrdd_tpu_torch.utils.config import MarchConfig

    march = MarchConfig()
    k1, bm = sk.sweep_preblended_planes, sk.ess_bitmap
    vol = pipe._stats_channel(q)
    nz, ny, nx = vol.shape
    sx, sy, sz = pipe._flex_axis_scale(q)
    P = max(64, 2 * nz)
    slopes = sk.pixel_slope_params(W, W)
    planes, zs = preblend_planes(vol, P, march.box_min, march.box_max, -1,
                                 0.5, z_scale=sz)
    stats = sk.precompute_ess_stats(vol, n_planes=P, march=march,
                                    z_scale=sz)
    bkw = dict(width=W, height=W, ny=ny, nx=nx, plane_chunk=8, march=march,
               axis_scale=(sx, sy))
    ess = bm(stats, zs, ORIGIN, slopes, tf, 0.0, 1.0, **bkw)
    ess_ref = sk.ess_bitmap_reference(stats, zs, ORIGIN, slopes, tf, 0.0,
                                      1.0, **bkw)
    if not torch.equal(ess, ess_ref):
        fail(f"flex q{q}: the ESS bitmap kernel differs from its plain version")

    def run(culled):
        return k1(planes, zs, ORIGIN, slopes, tf, 0.05, 1.0, 0.0, 1.0,
                  width=W, height=W, axis_scale=(sx, sy),
                  empty_space_skip=culled,
                  ess_stats=stats if culled else None)

    img_bytes = W * W * 16
    stats_bytes = 2 * stats[0].numel() * 4
    test_ops = (ess.numel() * ess_pair_ops(8)
                + ess[0].numel() * ess_table_ops(len(tf)))
    for bits, _ in held_bits(lambda: run(True), f"9 flex q{q} K1"):
        if not torch.equal(bits, ess_ref):
            fail(f"flex q{q}: K1's in-kernel ESS bits differ from the plain "
                 "bitmap of this run's own arguments")
    records = []
    for culled in (True, False):
        ms, direct_ms = paths_ms(lambda st: on_path(st,
                                                    lambda: run(culled)))
        got = run(culled)
        bitwise(on_path(False, lambda: run(culled))(), got,
                f"flex q{q} K1{'+ESS' if culled else ''} staged vs direct")
        p_ms, ref = timed_once(lambda: sk.sweep_preblended_planes_reference(
            planes, zs, ORIGIN, slopes, tf, 0.05, 1.0, 0.0, 1.0, width=W,
            height=W, axis_scale=(sx, sy), ess=ess_ref if culled else None))
        e = compare(got, ref, f"[9 flex q{q}] K1{'+ESS' if culled else ''} "
                    "vs plain")
        n_live, tex = live_samples(planes, zs, slopes, tf, 0.05, 0.0, 1.0, W,
                                   W, ess=ess if culled else None,
                                   axis_scale=(sx, sy))
        bd = (bound(tex * 4 + stats_bytes + img_bytes,
                    n_live * SAMPLE_OPS + test_ops) if culled
              else bound(tex * 4 + img_bytes, n_live * SAMPLE_OPS))
        print(f"  [9 flex q{q}] K1{' testing ESS' if culled else ''}"
              f" on the {nz} x {ny} x {nx} padded grid, axis scale "
              f"({sx:.6f}, {sy:.6f}, {sz:.6f}), {P} planes: staged "
              f"{ms:.3f} ms, direct {direct_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {n_live} "
              f"evaluated samples, {tex} texels read); culled "
              f"{float((ess == 0).float().mean()):.4f} of (tile, chunk) pairs")
        records.append({
            "name": f"sweep_preblended_planes[{'ess,' if culled else ''}"
                    f"flex,q{q}]",
            "route": "cuda", "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_kernel.py:1351",
            "max_abs_err": e, "ms": ms, "direct_ms": direct_ms,
            "plain_ms": p_ms, **bd,
        })
        del got, ref
    return records


def flex_shearwarp_record(pipe, tf, q, view, W):
    """K3 on the m-grid of query ``q``'s rotated flex view, the grid's
    filter scales permuted with its axes: timed on both fetch paths, held
    against its plain version and bitwise across paths. Returns a record."""
    import torch

    from vrdd_tpu_torch.kernels import slice_vjp as sv

    vol = pipe._stats_channel(q)
    P = max(64, 2 * vol.shape[0])
    cfg, planes, wi, origin, dz_sign, axis = shearwarp_setup(
        vol, view, W, P, pipe._flex_axis_scale(q))
    dev = vol.device
    args = (cfg, planes, None, torch.as_tensor(tf, device=dev),
            *[torch.tensor(v, device=dev) for v in (0.05, 0.0, 1.0)])
    ms, direct_ms = paths_ms(lambda st: lambda: sv.sweep_fwd(*args,
                                                            staged=st))
    p_ms, ref = timed_once(lambda: sv.sweep_fwd_reference(*args))
    got = sv.sweep_fwd(*args)
    e = compare(got, ref, f"[9 flex q{q} {view}] K3 on the {wi}^2 m-grid "
                "vs plain")
    bitwise(got, sv.sweep_fwd(*args, staged=False),
            f"flex q{q} {view}: K3 staged vs direct")
    n_live, tex = live_samples(planes, cfg.zs, cfg.slopes, tf, 0.05, 0.0,
                               1.0, wi, wi, chunk=4, origin=origin,
                               dz_sign=dz_sign, axis_scale=cfg.axis_scale)
    bd = bound(tex * 4 + wi * wi * 16, n_live * SAMPLE_OPS)
    print(f"  [9 flex q{q} {view}] principal axis {axis}, permuted scales "
          f"{cfg.axis_scale}: K3 staged {ms:.3f} ms, direct {direct_ms:.3f} "
          f"ms, plain {p_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}; {n_live} evaluated samples, {tex} texels "
          "read)")
    return {
        "name": f"sweep_fwd[shearwarp,flex,q{q},{view[0]:g},{view[1]:g}]",
        "route": "cuda", "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
        "replaces": "vrdd_tpu/pallas/slice_vjp.py:698", "max_abs_err": e,
        "ms": ms, "direct_ms": direct_ms, "plain_ms": p_ms, **bd,
    }


def cli_lines(argv, tag):
    """Run the port's CLI in this process; prints and returns its stdout."""
    import contextlib
    import io

    from vrdd_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    print(f"[{tag}] {' '.join(argv)}: rc {rc}")
    for line in text.splitlines():
        print(f"  {line}")
    if rc != 0:
        fail(f"{tag}: rc {rc}")
    return text


def phase_9(dev, card, smi, tf, work):
    """Fractal and flexible-block render at full size: queries 4/5/6 on a
    256^3-block x 32-bin fractal volume and 8/9/0 on the flexible blocks of
    an Isabel-sized raw volume, to 1024^2 through 'auto' (K1 + ESS) and one
    rotated view each (shear-warp, K3); ``from_raw`` against the direct
    block count; ``from_codebooks`` at the Fuel scale; the render CLI on
    query 9. Returns the kernel records."""
    import re

    import numpy as np
    import torch

    from vrdd_tpu_torch.io.synthetic import (
        fractal_volume_on_device, gaussian_blob_volume,
        synthetic_flexible_dataset)
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.models.flexible import (
        FlexibleBlockVolume, IntegralVolume)
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import FractalHistogramVolume
    from vrdd_tpu_torch.ops.histogram import (
        flex_block_stats, normalize_histogram)

    W = 1024
    records = []
    # ---- 9a: the fractal family, 256^3 blocks x 32 bins
    n, B = 256, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t, cb, eb, ev = fractal_volume_on_device((n, n, n), B, 16, 8, seed=11,
                                             device=dev)
    frac = FractalHistogramVolume(cb, eb, ev, t)
    nbytes = sum(a.numel() * a.element_size() for a in (t, cb, eb, ev))
    print(f"[9a] fractal volume {n}^3 blocks x {B} bins, 16 templates, 8 "
          f"errors ({nbytes / 1e9:.2f} GB codebook) -> {W}^2, on {card} "
          f"({smi})")
    dec_ms, dec = timed_once(frac.decode)
    idx = np.random.default_rng(0).choice(n ** 3, 4096, replace=False)
    oracle = fractal_decode_oracle(t, cb, eb, ev, idx)
    got = dec.reshape(-1, B)[torch.as_tensor(idx, device=dev)].cpu().numpy()
    err = float(np.abs(got - oracle).max())
    print(f"  decode {dec_ms:.3f} ms ({dec.numel() * 4 / 1e9:.2f} GB, CUDA "
          f"events); 4096 voxels against the per-voxel oracle: max abs err "
          f"{err:.3e}")
    if err > 1e-6 or not torch.isfinite(dec).all():
        fail(f"9a: the fractal decode is {err:.3e} from the oracle")
    del dec
    pipe = RenderPipeline(fractal=frac)
    print(f"  stats decode (basic_data_processing/fractal) "
          f"{1e3 * pipe.timings['basic_data_processing/fractal']:.3f} ms "
          "(host clock, synchronized); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cfgs = {q: render_cfg(q, W, tf_scale=0.25 if q == 5 else 1.0)
            for q in (4, 5, 6)}
    auto_frames(pipe, cfgs, W, "9a")
    rotated_frame(pipe, cfgs[4], (30.0, 20.0), "9a q4")
    del pipe, frac, t, cb, eb, ev
    torch.cuda.empty_cache()

    # ---- 9b: the flexible blocks of an Isabel-sized raw volume
    raw = gaussian_blob_volume((100, 500, 500), seed=7, device=dev) * 255.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    flex = FlexibleBlockVolume.from_raw(raw, block_size=4, vmax=256.0)
    peak = torch.cuda.max_memory_allocated()
    print(f"[9b] from_raw: raw {tuple(raw.shape)} float32 (Isabel's "
          f"500 x 500 x 100), blocks of 4 -> {flex.n_blocks} x 64 bins: "
          + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in
                      flex.timings.items())
          + f" (host clock, synchronized); peak device memory "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the raw "
          "volume)")
    int_ms, integral = timed_once(
        lambda: IntegralVolume.from_raw(raw, 64, 0.0, 256.0))
    print(f"  the resident integral histogram {tuple(integral.sat.shape)} "
          f"{integral.sat.dtype} ({integral.sat.numel() * 4 / 1e9:.2f} GB) "
          f"built in {int_ms:.3f} ms (CUDA events)")
    counts, direct = flex_counts(integral.sat, raw, 4, 256.0)
    cerr = (counts - direct).abs().amax(dim=-1)
    print(f"  integral-histogram counts vs the direct per-block count: max "
          f"abs error {float(cerr.max()):g} counts, {int((cerr > 0).sum())} "
          f"of {cerr.numel()} blocks off")
    if float(cerr.max()) != 0.0:
        fail("9b: integral-histogram counts are off (int32 counts are exact)")
    sdirect = flex_block_stats(normalize_histogram(direct)[0])
    serr = (flex.stats_grid - sdirect).abs().reshape(-1, 3).amax(0).tolist()
    print(f"  stats vs those of the direct count: max abs error mean "
          f"{serr[0]:.3e}, variance {serr[1]:.3e}, entropy {serr[2]:.3e} "
          f"(of ranges {[round(float(v), 3) for v in flex.stat_ranges()[:, 1]]})")
    if not torch.isfinite(flex.stats_grid).all():
        fail("9b: non-finite flexible stats")
    if not torch.equal(flex.stats_grid, sdirect):
        fail("9b: from_raw's stats differ from those of the direct count "
             "(the same counts, the same stages)")
    del counts, direct, cerr, sdirect
    torch.cuda.empty_cache()
    pipe = RenderPipeline(flexible=flex.normalized())
    cfgs = {q: render_cfg(q, W) for q in (8, 9, 0)}
    launches, frames = auto_frames(pipe, cfgs, W, "9b")
    sw_launches, sw_staged = rotated_frame(pipe, cfgs[9], (30.0, 20.0),
                                           "9b q9")
    for r, culled in zip(flex_k1_records(pipe, tf, 9, W), (True, False)):
        # launches: with ESS, query 9's frame of the main-path run; the main
        # path always takes ESS on the flex grid, so K1 without it has none
        r["launches"], r["staged_launches"] = (
            (launches[9][1], launches[9][3]) if culled else (None, None))
        if culled:
            r["frame_ms"] = frames[9]
        records.append(r)
    r = flex_shearwarp_record(pipe, tf, 9, (30.0, 20.0), W)
    r["launches"], r["staged_launches"] = sw_launches, sw_staged
    records.append(r)
    slider = flex_slider(pipe, integral, cfgs, W, (2, 16, 4))
    del pipe, flex
    torch.cuda.empty_cache()
    records += flex_requery_records(integral, tuple(raw.shape), slider)
    del integral, raw
    torch.cuda.empty_cache()

    # ---- 9c: from_codebooks at the reference's Fuel scale
    t0 = time.perf_counter()
    ds = synthetic_flexible_dataset(dims=(64, 64, 64), n_bins=64, seed=5)
    gen_s = time.perf_counter() - t0
    keys = ("fractal_spans", "fractal_codebook", "fractal_error_bins",
            "fractal_error_values", "templates", "simple_spans",
            "simple_bin_ids", "simple_freqs", "simple_counts")
    fb = FlexibleBlockVolume.from_codebooks(
        volume_dim=ds["volume_dim"], block_size=6, device=dev,
        **{k: ds[k] for k in keys})
    via_raw = FlexibleBlockVolume.from_raw(
        torch.from_numpy(ds["raw"]).to(dev), block_size=6, vmax=256.0)
    d = (fb.stats_grid - via_raw.stats_grid).abs()
    rel = d / via_raw.stats_grid.abs().clamp(min=1e-30)
    ok = bool((d <= 1e-4 + 1e-4 * via_raw.stats_grid.abs()).all())
    print(f"[9c] from_codebooks, Fuel 64^3 (the {64 ** 3} spans of the "
          f"Fenwick universe; dataset made on the host in {gen_s:.1f} s), "
          f"blocks of 6 -> {fb.n_blocks}: "
          + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in fb.timings.items())
          + f"; against from_raw: max abs {float(d.max()):.3e}, max rel "
          f"{float(rel.max()):.3e}")
    if not ok or fb.n_blocks != tuple(-(-d // 6)
                                      for d in ds["volume_dim"][::-1]):
        fail("9c: from_codebooks disagrees with from_raw (rtol 1e-4, atol "
             "1e-4)")
    del fb, via_raw, ds

    # ---- 9d: the render CLI on query 9 at its defaults
    for extra in ([], ["--renderer", "auto", "--flex-normalize"]):
        text = cli_lines(["render", "--file", "none", "--query", "9", "-o",
                          str(work / "q9.ppm"), *extra], "9d")
        if not re.search(r"Throughput = \S+ MTexels/s", text):
            fail(f"9d: render --query 9 {extra} printed no throughput")
    return records


def phase_10(dev, card, smi, work):
    """fit-tf at the Isabel geometry through 'auto' (K3 target, K4 + K5 per
    step with wrt=('lut',)) and encode on the card against the CPU; K4 and
    K5 at fit-tf's shape timed against their plain versions. Returns the
    kernel records."""
    import re

    import numpy as np
    import torch

    from vrdd_tpu_torch.core.transfer import (
        default_transfer_function, grayscale_ramp)
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import preblend_planes
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import MarchConfig

    S, iters = 512, 5
    counters = diff_counters()
    for c in counters:
        c.launches = c.staged_launches = 0
        c.size_launches.clear()
        c.size_staged_launches.clear()
    print(f"[10] fit-tf, 50 x 50 x 10 blocks -> {S}^2, on {card} ({smi})")
    text = cli_lines(["fit-tf", "--blocks", "50", "50", "10", "--size",
                      str(S), "--iters", str(iters), "--renderer", "auto",
                      "--checkpoint", str(work / "tf.npz")], "10 fit-tf")
    torch.cuda.synchronize()
    losses = [float(v) for v in re.findall(r"step \d+: loss (\S+)", text)]
    launches = {c.__name__: c.size_launches[(S, S)] for c in counters}
    staged = {c.__name__: c.size_staged_launches[(S, S)] for c in counters}
    print(f"  launches at {S}^2: {launches}, staged {staged}; losses "
          f"{losses}")
    if "renderer: pallas" not in text:
        fail("10: fit-tf --renderer auto did not take the fused kernels")
    if (launches["sweep_fwd"] < 1 or launches["sweep_fwd_ckpt"] != iters
            or launches["sweep_bwd"] != iters):
        fail(f"10: fit-tf did not run K3 and K4/K5 once a step: {launches}")
    if (len(losses) != iters or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        fail(f"10: fit-tf's loss is not finite and falling: {losses}")

    # K4 / K5 at fit-tf's shape: the raw mean channel, 64 planes -> 512^2
    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    vol = RawHistogramVolume(torch.from_numpy(hist).to(dev)).stats_volume()[
        ..., 0].contiguous()
    march = MarchConfig()
    P = max(64, 2 * vol.shape[0])
    planes, zs = preblend_planes(vol, P, march.box_min, march.box_max, -1)
    slopes = sk.pixel_slope_params(S, S)
    cfg = sv.planes_config(zs, ORIGIN, slopes, width=S, height=S, n_planes=P,
                           plane_chunk=4)
    gray = grayscale_ramp(9)
    scal = [torch.tensor(v, device=dev) for v in (0.05, 0.0, 1.0)]
    args = (cfg, planes, None, torch.as_tensor(gray, device=dev), *scal)
    target = sv.sweep_fwd(cfg, planes, None, torch.as_tensor(
        default_transfer_function(), device=dev), *scal)
    img4, tck = sv.sweep_fwd_ckpt(*args)
    g = (2.0 / img4.numel()) * (img4 - target)
    n_live, tex = live_samples(planes, zs, slopes, gray, 0.05, 0.0, 1.0, S,
                               S, chunk=4)
    ops = n_live * SAMPLE_OPS
    img_b, tck_b = S * S * 16, cfg.n_chunks * S * S * 4
    records = []
    n_lut = len(gray)
    for name, fn, ref_fn, bd, line in (
            ("sweep_fwd_ckpt", lambda st: sv.sweep_fwd_ckpt(*args, staged=st),
             lambda: sv.sweep_fwd_ckpt_reference(*args),
             bound(tex * 4 + img_b + tck_b, ops), 714),
            ("sweep_bwd",
             lambda st: sv.sweep_bwd(*args, g, tck, False, True, False,
                                     staged=st),
             lambda: sv.sweep_bwd_reference(*args, g, False, True, False),
             bound(tex * 4 + tck_b + img_b + (4 * n_lut + 3) * 4,
                   n_live * K5_SAMPLE_OPS), 787)):
        ms, direct_ms = paths_ms(lambda st, fn=fn: lambda: fn(st))
        p_ms, ref = timed_once(ref_fn)
        got, direct = fn(None), fn(False)
        if name == "sweep_bwd":
            lut_g, lut_ref = got[1][:4 * n_lut], ref[1][:4 * n_lut]
            rel_l2(lut_g, lut_ref, "[10] K5 wrt=lut LUT cotangents vs plain")
            bitwise(got[1], fn(True)[1], "[10] K5 LUT cotangents staged vs "
                    "direct")
            e = float((lut_g - lut_ref).abs().max())
        else:
            e = compare(got[0], ref[0], f"[10] {name} image vs plain")
            compare(got[1][..., None], ref[1][..., None],
                    f"[10] {name} checkpoints vs plain")
            for a, b in zip(got, direct):
                bitwise(a, b, f"[10] {name} staged vs direct")
        print(f"  [10] {name} (wrt=lut), {P} planes of {tuple(vol.shape)} -> "
              f"{S}^2: staged {ms:.3f} ms, direct {direct_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}; {n_live} evaluated samples, {tex} texels "
              "read)")
        records.append({
            "name": f"{name}[fit_tf,lut]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/"
                      f"{'slice_vjp.cu' if name == 'sweep_bwd' else 'slice_sweep.cu'}",
            "replaces": f"vrdd_tpu/pallas/slice_vjp.py:{line}",
            "launches": launches[name], "staged_launches": staged[name],
            "max_abs_err": e, "ms": ms, "direct_ms": direct_ms,
            "plain_ms": p_ms, **bd,
        })
        del got, ref, direct

    # ---- encode on the card against the card's CPU
    on_card, on_cpu = work / "enc_cuda.bin", work / "enc_cpu.bin"
    cli_lines(["encode", "-o", str(on_card)], "10 encode")
    cli_lines(["encode", "-o", str(on_cpu), "--device", "cpu"], "10 encode")
    a, b = on_card.read_bytes(), on_cpu.read_bytes()
    print(f"  encode: {len(a)} bytes on the card, {len(b)} on the CPU, "
          f"equal {a == b}")
    if a != b or not a:
        fail("10: encode on the card wrote another file than on the CPU")
    return records



# ---- phase 11: the distributed sweep (parallel/) ---------------------------

#: 11a/11b's density: some 30% of the rays reach the 0.95 cutoff, so pass 2
#: re-sweeps the crossing slabs
DIST_DENSITY = 0.2
#: phase 8c's views: principal axes z, x and y, d_z of both signs
DIST_VIEWS = ((30.0, 20.0), (0.0, 60.0), (60.0, 0.0))


def reset_diff_counters():
    for c in diff_counters():
        c.launches = c.staged_launches = c.seed_launches = 0
        c.size_launches.clear()
        c.size_staged_launches.clear()


def diff_launches():
    """``{name: (launches, seeded launches)}`` of K3/K4/K5."""
    return {c.__name__: (c.launches, c.seed_launches)
            for c in diff_counters()}


class ShardCalls:
    """Records the arguments of every per-shard sweep call
    ``parallel/sweep.py`` makes through its name ``name``
    (sweep_preblended_hist_diff or sweep_preblended_planes_diff) inside the
    ``with`` block, for replaying each shard's kernel alone."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __enter__(self):
        from vrdd_tpu_torch.parallel import sweep as ps

        self.orig = getattr(ps, self.name)

        def wrapped(*a, **kw):
            self.calls.append((a, kw))
            return self.orig(*a, **kw)

        setattr(ps, self.name, wrapped)
        return self.calls

    def __exit__(self, *exc):
        from vrdd_tpu_torch.parallel import sweep as ps

        setattr(ps, self.name, self.orig)


def hist_shard(call):
    """``(cfg, slab, rows, lut, scalars, seed)`` of one recorded
    ``sweep_preblended_hist_diff`` call, for K3/K4/K5 and their plain
    versions on that shard."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    a, kw = call
    slab = a[0]
    cfg = sv.hist_config(
        a[2], a[3], a[4], stat=kw["stat"], dz_sign=kw["dz_sign"],
        width=kw["width"], height=kw["height"], march=kw["march"],
        plane_spacing=kw["plane_spacing"], plane_chunk=kw["plane_chunk"],
        length_correction=kw["length_correction"],
        reverse_planes=kw["reverse_planes"])
    rows = sk._decode_rows(a[1], kw["stat"], slab.shape[1], slab.device)
    return (cfg, slab.detach(), rows.detach()) + _shard_tail(a[5:], kw, slab)


def planes_shard(call):
    """The same for one recorded ``sweep_preblended_planes_diff`` call (a
    scalar plane stack: ``rows`` None)."""
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    a, kw = call
    planes = a[0]
    cfg = sv.planes_config(
        a[1], a[2], a[3], dz_sign=kw["dz_sign"], width=kw["width"],
        height=kw["height"], march=kw["march"],
        plane_spacing=kw["plane_spacing"], n_planes=planes.shape[0],
        length_correction=kw["length_correction"],
        plane_chunk=kw["plane_chunk"], tex_offset=kw["tex_offset"],
        axis_scale=kw["axis_scale"], reverse_planes=kw["reverse_planes"])
    return (cfg, planes.detach(), None) + _shard_tail(a[4:], kw, planes)


def _shard_tail(a, kw, vol):
    """``(lut, (density, toff, tscl), seed)`` from a recorded call's
    arguments after the volume's (``a = (lut, density, brightness, toff,
    tscl)``)."""
    import torch

    lut, density, _, toff, tscl = a[:5]
    scal = [torch.as_tensor(v, dtype=torch.float32, device=vol.device)
            .detach() for v in (density, toff, tscl)]
    seed = kw.get("acc_init")
    return (torch.as_tensor(lut, dtype=torch.float32,
                            device=vol.device).detach(), scal,
            None if seed is None else seed.detach())


def recorded_passes(fn, name):
    """The shards of one run of ``fn()``, by pass: ``{False: pass 1's,
    True: pass 2's (the seeded calls)}``."""
    with ShardCalls(name) as calls:
        fn()
    shard = hist_shard if name == "sweep_preblended_hist_diff" else \
        planes_shard
    out = {False: [], True: []}
    for c in calls:
        out[c[1].get("acc_init") is not None].append(shard(c))
    return out


def shard_work(shards, mode):
    """``(samples, texels)`` the K3 sweeps of these shards evaluate and read
    (``live_samples`` on each decoded slab or plane stack, from its
    seed)."""
    from vrdd_tpu_torch.kernels import slice_kernel as sk

    n_live = n_tex = 0
    for cfg, slab, rows, lut, scal, seed in shards:
        planes = slab if rows is None else sk.decode_with_rows(slab, rows,
                                                               mode)
        n, t = live_samples(
            planes, cfg.zs, cfg.slopes, lut.cpu().numpy(), *map(float, scal),
            cfg.width, cfg.height, reverse=cfg.reverse, chunk=cfg.ck_stride,
            origin=cfg.origin, dz_sign=cfg.dz_sign,
            seed_alpha=None if seed is None else seed[..., 3],
            spacing=cfg.plane_spacing)
        n_live, n_tex = n_live + n, n_tex + t
        del planes
    return n_live, n_tex


def k3_shard_record(name, shards, mode, B, elem, launches, what):
    """The record of K3 over ``shards`` (the recorded calls of one pass):
    the shards' launches replayed and timed with CUDA events, the kernel's
    outputs against the plain versions on the same shards, the plain
    versions timed, the bound from the samples they evaluate."""
    import torch

    from vrdd_tpu_torch.kernels import slice_vjp as sv

    def k3():
        return [sv.sweep_fwd(cfg, slab, rows, lut, *scal, seed)
                for cfg, slab, rows, lut, scal, seed in shards]

    def plain():
        return [sv.sweep_fwd_reference(cfg, slab, rows, lut, *scal, seed)
                for cfg, slab, rows, lut, scal, seed in shards]

    ms = time_ms(k3, 3)
    got = torch.stack(k3())
    p_ms, ref = timed_once(plain)
    err = compare(got, torch.stack(ref), f"{what} vs plain")
    del got, ref
    n_live, tex = shard_work(shards, mode)
    io = sum(cfg.width * cfg.height * 16 * (1 if seed is None else 2)
             for cfg, _, _, _, _, seed in shards)
    bd = bound(tex * B * elem + io, n_live * (SAMPLE_OPS + decode_ops(mode, B)))
    print(f"  {what}: {len(shards)} launches, {ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; "
          f"{n_live} evaluated samples, {tex} voxels read)")
    return {"name": name, "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_vjp.py:698",
            "launches": launches, "staged_launches": None,
            "max_abs_err": err, "ms": ms, "direct_ms": None,
            "plain_ms": p_ms, **bd}


def k3_pass_records(fn, name, mode, B, elem, counts, tag, what):
    """K3's records of pass 1 and pass 2 of one run of ``fn()`` (one
    distributed render): its shards replayed against their plain versions
    (:func:`k3_shard_record`); ``counts``: the render's K3 ``(launches,
    seeded)``."""
    passes = recorded_passes(fn, name)
    return [k3_shard_record(
        f"sweep_fwd[{tag},pass{1 + seeded}]", passes[seeded], mode, B, elem,
        counts[1] if seeded else counts[0] - counts[1],
        f"{what} K3 pass {1 + seeded}") for seeded in (False, True)]


def k4_k5_records(shards, mode, B, elem, counts, wrt, tag, what):
    """K4 and K5 over the recorded shards of one fwd+bwd, each replayed,
    timed and held against its plain version on the same shards: K4's
    images, K5's volume and LUT cotangents (those ``wrt`` asks for) and,
    for the seeded shards, ``S``."""
    import torch

    from vrdd_tpu_torch.kernels import slice_vjp as sv

    flags = (bool({"hist", "volume"} & set(wrt)), "lut" in wrt,
             "params" in wrt)
    n_lut = shards[0][3].shape[0]
    outs = [sv.sweep_fwd_ckpt(cfg, s, r, lut, *sc, seed)
            for cfg, s, r, lut, sc, seed in shards]
    gs = [(2.0 / img4.numel()) * (img4 - 0.25) for img4, _ in outs]

    def k4():
        return [sv.sweep_fwd_ckpt(cfg, s, r, lut, *sc, seed)
                for cfg, s, r, lut, sc, seed in shards]

    def k4_plain():
        return [sv.sweep_fwd_ckpt_reference(cfg, s, r, lut, *sc, seed)
                for cfg, s, r, lut, sc, seed in shards]

    def k5():
        return [sv.sweep_bwd(cfg, s, r, lut, *sc, g, tck, *flags, acc0=seed)
                for (cfg, s, r, lut, sc, seed), g, (_, tck)
                in zip(shards, gs, outs)]

    def k5_plain():
        return [sv.sweep_bwd_reference(cfg, s, r, lut, *sc, g, *flags,
                                       acc0=seed)
                for (cfg, s, r, lut, sc, seed), g in zip(shards, gs)]

    n_live, tex = shard_work(shards, mode)
    img_b = sum(c.width * c.height * 16 for c, *_ in shards)
    tck_b = sum(c.n_chunks * c.width * c.height * 4 for c, *_ in shards)
    ops = n_live * (SAMPLE_OPS + decode_ops(mode, B))
    records = []
    for name, fn, ref_fn, bd, line, src in (
            ("sweep_fwd_ckpt", k4, k4_plain,
             bound(tex * B * elem + img_b + tck_b, ops), 714,
             "slice_sweep.cu"),
            ("sweep_bwd", k5, k5_plain,
             bound(tex * (B * elem + 4 * flags[0]) + tck_b + img_b
                   + (4 * n_lut + 3) * 4,
                   n_live * (K5_SAMPLE_OPS + decode_ops(mode, B))), 787,
             "slice_vjp.cu")):
        ms = time_ms(fn, 3)
        p_ms, ref = timed_once(ref_fn)
        got = fn()
        if name == "sweep_fwd_ckpt":
            e = compare(torch.stack([g[0] for g in got]),
                        torch.stack([r[0] for r in ref]),
                        f"{what} K4 images vs plain")
        else:
            if flags[0]:
                rel_l2(torch.cat([g[0].float().flatten() for g in got]),
                       torch.cat([r[0].float().flatten() for r in ref]),
                       f"{what} K5 d_planes vs plain")
            lg = torch.stack([g[1][:4 * n_lut] for g in got])
            lr = torch.stack([r[1][:4 * n_lut] for r in ref])
            if flags[1]:
                rel_l2(lg, lr, f"{what} K5 LUT cotangents vs plain")
            seeded = [(g[3], r[3]) for g, r in zip(got, ref)
                      if r[3] is not None]
            if seeded:
                s_got = torch.stack([g for g, _ in seeded])
                s_ref = torch.stack([r for _, r in seeded])
                what_s = f"{what} K5 S of the {len(seeded)} seeded shards"
                if float(s_ref.abs().max()) > 0.0:
                    rel_l2(s_got, s_ref, f"{what_s} vs plain")
                elif float(s_got.abs().max()) > 0.0:
                    fail(f"{what_s}: not 0 where the plain S is 0 on every "
                         "ray (no ray crosses the cutoff)")
                else:
                    print(f"  {what_s}: 0 on every ray, as plain (no ray "
                          "crosses the cutoff)")
            e = float((lg - lr).abs().max())
        del got, ref
        print(f"  {what} {name} over the {len(shards)} shard launches: "
              f"{ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        records.append({
            "name": f"{name}[{tag}]", "route": "cuda",
            "source": f"vrdd_tpu_torch/csrc/{src}",
            "replaces": f"vrdd_tpu/pallas/slice_vjp.py:{line}",
            "launches": counts[name][0], "staged_launches": None,
            "max_abs_err": e, "ms": ms, "direct_ms": None,
            "plain_ms": p_ms, **bd,
        })
    return records


def phase_11a(dev, card, smi, tf, hist, n, B, W, mesh):
    """distributed_hist_render at bricks=4 x rays=2 in one process."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.parallel import sweep as ps

    origin = torch.tensor(ORIGIN)
    elem = hist.element_size()
    records = []
    for stat in ("mean", "entropy"):
        rows, mode = sk.decode_weight_rows(stat, B, family="unit")

        def render(h=hist, lut=tf, wrt=("hist", "lut", "params")):
            return ps.distributed_hist_render(
                h, rows, origin, lut, DIST_DENSITY, width=W, height=W,
                mesh=mesh, stat=mode, wrt=wrt)

        reset_diff_counters()
        img = render()
        torch.cuda.synchronize()
        counts = diff_launches()
        print(f"[11a] distributed_hist_render {stat}, {n}^3 x {B} "
              f"{hist.dtype} -> {W}^2, bricks={mesh.bricks} x "
              f"rays={mesh.rays}, density {DIST_DENSITY}, on {card} ({smi}): "
              f"launches (all, seeded) {counts}")
        shards = mesh.bricks * mesh.rays
        if counts["sweep_fwd"] != (2 * shards, shards):
            fail(f"11a {stat}: K3 ran {counts['sweep_fwd']} (launches, "
                 f"seeded), want ({2 * shards}, {shards})")
        k3_launches = counts["sweep_fwd"]
        ref = sk.pallas_hist_render(hist, rows, origin, tf, DIST_DENSITY,
                                    width=W, height=W, stat=mode)
        sat = float((ref[..., 3] > 0.95).float().mean())
        print(f"  rays past the cutoff: {sat:.2%}")
        if sat <= 0.0:
            fail("11a: no ray reaches the cutoff: pass 2 is not exercised")
        compare(img, ref, f"[11a {stat}] distributed (K3, two passes) vs "
                "single-device K2")
        del ref
        frame_ms = host_ms(render, 3)
        recs = k3_pass_records(render, "sweep_preblended_hist_diff", mode, B,
                               elem, k3_launches, f"dist_hist,{mode}",
                               f"[11a {stat}]")
        print(f"  frame {frame_ms:.3f} ms (host clock), K3 pass 1 "
              f"{recs[0]['ms']:.3f} ms, pass 2 {recs[1]['ms']:.3f} ms (CUDA "
              "events around each pass's shard launches, replayed)")
        records += recs
        del img

        # fwd + bwd against the single-device differentiable render
        def fwdbwd(fn):
            h = hist.detach().requires_grad_(True)
            lut = torch.tensor(tf, device=dev, requires_grad=True)
            img = fn(h, lut)
            loss = torch.mean((img - 0.25) ** 2)
            loss.backward()
            return loss.detach(), h.grad, lut.grad

        def dist(h, lut):
            return render(h, lut, ("hist", "lut"))

        def single(h, lut):
            return sv.pallas_hist_render_diff(
                h, rows, origin, lut, DIST_DENSITY, width=W, height=W,
                wrt=("hist", "lut"), stat=mode, route="inkernel")

        reset_diff_counters()
        loss, g_hist, g_lut = fwdbwd(dist)
        torch.cuda.synchronize()
        counts = diff_launches()
        print(f"  fwd+bwd (wrt hist, lut): launches (all, seeded) {counts}")
        if (counts["sweep_fwd_ckpt"][0] != 2 * shards
                or counts["sweep_bwd"][0] != 2 * shards):
            fail(f"11a {stat}: fwd+bwd did not run K4 and K5 per shard and "
                 f"pass: {counts}")
        loss_s, g_hist_s, g_lut_s = fwdbwd(single)
        print(f"  loss {float(loss):.8f}, single-device {float(loss_s):.8f}")
        if abs(float(loss) - float(loss_s)) > 1e-4 * abs(float(loss_s)):
            fail(f"11a {stat}: the loss differs from the single-device one")
        # d_hist comes back in the storage dtype: the two sums round to
        # bf16 apart (one rounding is 2^-8 relative)
        rel_l2(g_hist, g_hist_s, f"[11a {stat}] d_hist vs single-device",
               limit=2.0 ** -8 if hist.dtype == torch.bfloat16 else GRAD_TOL)
        rel_l2(g_lut, g_lut_s, f"[11a {stat}] d_lut vs single-device")
        del g_hist, g_hist_s
        fb_ms = host_ms(lambda: fwdbwd(dist), 3)
        fb1_ms = host_ms(lambda: fwdbwd(single), 3)
        print(f"  fwd+bwd {fb_ms:.3f} ms (host clock; single-device "
              f"{fb1_ms:.3f} ms)")
        if stat != "mean":
            continue

        # where the fwd+bwd's time goes, then K4 and K5 on every shard of
        # it against their plain versions
        profile_step(lambda: fwdbwd(dist), f"11a {stat} fwd+bwd", top=12,
                     cpu_top=12)
        with ShardCalls("sweep_preblended_hist_diff") as calls:
            fwdbwd(dist)
        records += k4_k5_records([hist_shard(c) for c in calls], mode, B,
                                 elem, counts, ("hist", "lut"),
                                 f"dist_hist,{mode}", f"[11a {stat}]")
        del calls
    return records


def phase_11b(dev, card, smi, tf, hist, n, B, W):
    """distributed_shearwarp_hist_render on a 1 x 1 mesh, three views."""
    import torch

    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.shearwarp import (
        _warp_from_rotation_traced, slope_corner_bounds)
    from vrdd_tpu_torch.parallel import sweep as ps
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.utils.config import MarchConfig

    mesh = make_mesh(1, 1)
    rows, mode = sk.decode_weight_rows("mean", B, family="unit")
    elem = hist.element_size()
    records, seen = [], set()
    for view in DIST_VIEWS:
        iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
        if not ps.shearwarp_hist_supported(hist.shape, iv, W, W,
                                           oversample=1.0, mesh=mesh):
            fail(f"11b {view}: shearwarp_hist_supported refused the view")

        def render():
            return ps.distributed_shearwarp_hist_render(
                hist, rows, iv, W, W, tf, DIST_DENSITY, mesh=mesh, stat=mode,
                oversample=1.0)

        reset_diff_counters()
        img = render()
        torch.cuda.synchronize()
        counts = diff_launches()
        if counts["sweep_fwd"][0] != 1:
            fail(f"11b {view}: K3 ran {counts['sweep_fwd']} times, want 1")
        frame_ms = host_ms(render, 3)
        with ShardCalls("sweep_preblended_hist_diff") as calls:
            render()
        (cfg, slab, r, lut, scal, _), = [hist_shard(c) for c in calls]
        seen.add((cfg.dz_sign, slope_corner_bounds(iv, W, W)[0]))
        del calls
        ms = time_ms(lambda: sv.sweep_fwd(cfg, slab, r, lut, *scal), 3)
        p_ms, ref_m = timed_once(
            lambda: sv.sweep_fwd_reference(cfg, slab, r, lut, *scal))
        got_m = sv.sweep_fwd(cfg, slab, r, lut, *scal)
        e = compare(got_m, ref_m, f"[11b {view}] K3 on the "
                    f"{cfg.width}x{cfg.height} m-grid vs plain")
        perm, _, _, _, _, _, mgrid = ps._rotated_frame(
            iv, W, W, 2.0, MarchConfig(), 1.0, True, ps.STRIP)
        compare(img, _warp_from_rotation_traced(ref_m, iv[:, :3], mgrid, W,
                                                W, 2.0, perm),
                f"[11b {view}] frame vs the plain version of the call")
        if float(img[..., 3].max()) <= 0.0:
            fail(f"11b {view}: empty image")
        del got_m, ref_m, img
        n_live, tex = shard_work([(cfg, slab, r, lut, scal, None)], mode)
        bd = bound(tex * B * elem + cfg.width * cfg.height * 16,
                   n_live * (SAMPLE_OPS + decode_ops(mode, B)))
        print(f"[11b {view}] distributed_shearwarp_hist_render mean, 1 x 1 "
              f"mesh, {tuple(slab.shape)} -> {cfg.width}x{cfg.height} m-grid "
              f"-> {W}^2, d_z sign {cfg.dz_sign:+d}, on {card} ({smi}): "
              f"frame {frame_ms:.3f} ms (host clock), K3 {ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}; {n_live} evaluated samples, {tex} voxels "
              "read)")
        records.append({
            "name": f"sweep_fwd[rot_hist,{view[0]:g},{view[1]:g}]",
            "route": "cuda", "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_vjp.py:698",
            "launches": counts["sweep_fwd"][0], "staged_launches": None,
            "max_abs_err": e, "ms": ms, "direct_ms": None, "plain_ms": p_ms,
            **bd,
        })
        del slab
        ps.clear_octant_cache()
        torch.cuda.empty_cache()
    if len({s for s, _ in seen}) != 2 or len({a for _, a in seen}) != 3:
        fail(f"11b: the views did not cover both d_z signs and the three "
             f"principal axes: {seen}")
    return records


def phase_11c(work, n=128):
    """render-hist --rot-x 30 --rot-y 20 on an n^3 x 16 file."""
    import torch

    from vrdd_tpu_torch.io import formats
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume

    hist_file = work / "hist128_rot.bin"
    formats.write_raw_histograms(
        str(hist_file), random_histogram_volume((n, n, n), n_bins=16,
                                                seed=1).reshape(-1, 16))
    out = work / "rot.ppm"
    reset_diff_counters()
    text = cli_lines(["render-hist", "--hist-file", str(hist_file), "--dims",
                      str(n), str(n), str(n), "--bins", "16", "--rot-x", "30",
                      "--rot-y", "20", "-o", str(out)], "11c render-hist")
    torch.cuda.synchronize()
    launches = diff_launches()["sweep_fwd"][0]
    path = [ln for ln in text.splitlines() if ln.startswith("wrote")]
    img = formats.read_ppm(str(out))
    print(f"  path line: {path}; K3 launches {launches}; {img.shape} PPM, "
          f"mean level {img.mean():.2f}")
    if (not path or "distributed_shearwarp_hist_render" not in path[0]
            or launches != 1 or img.max() == 0):
        fail("11c: render-hist --rot-* did not render through "
             "distributed_shearwarp_hist_render on K3")


def phase_11d(dev, card, smi, tf, W=1024, n=256):
    """The scalar distributed sweep at bricks=2 x rays=2 on 7b's volume:
    unrotated against K1, rotated against the plain torch sweep on the
    slopes the kernels sample, each pass's shards against their plain
    versions, one make_sweep_fit_step step against the single-device step
    and its K4/K5 shards against their plain versions. Returns the kernel
    records."""
    import numpy as np
    import torch

    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.core.transfer import grayscale_ramp
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.march import shearwarp as sw
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.parallel import sweep as ps
    from vrdd_tpu_torch.parallel import train as pt
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.utils.config import MarchConfig

    pipe = RenderPipeline(raw=RawHistogramVolume(smooth_raw_histograms(
        n, 32, dev)))
    vol = pipe.raw_stats[..., 0].contiguous()
    del pipe
    torch.cuda.empty_cache()
    mesh, one = make_mesh(2, 2), make_mesh(1, 1)
    origin = torch.tensor(ORIGIN)
    shards = mesh.bricks * mesh.rays
    print(f"[11d] the scalar distributed sweep, 7b's {n}^3 mean channel -> "
          f"{W}^2, bricks={mesh.bricks} x rays={mesh.rays}, on {card} ({smi})")

    def flat():
        return ps.distributed_sweep_render(vol, origin, tf, width=W,
                                           height=W, mesh=mesh)

    reset_diff_counters()
    img = flat()
    torch.cuda.synchronize()
    counts = diff_launches()
    if counts["sweep_fwd"] != (2 * shards, shards):
        fail(f"11d: K3 ran {counts['sweep_fwd']} (launches, seeded)")
    compare(img, sk.pallas_slice_render(vol, origin, tf, width=W, height=W),
            "[11d] distributed_sweep_render (2 nz planes, halo) vs K1")
    ms = host_ms(flat, 3)
    k1_ms = host_ms(lambda: sk.pallas_slice_render(vol, origin, tf, width=W,
                                                   height=W), 3)
    print(f"  frame {ms:.3f} ms, K1 single-device {k1_ms:.3f} ms (host "
          f"clock); launches (all, seeded) {counts}")
    records = k3_pass_records(flat, "sweep_preblended_planes_diff", "none",
                              1, 4, counts["sweep_fwd"], "dist_scalar",
                              "[11d]")

    iv = inv_view_from_rotation_translation(30.0, 20.0, (0.0, 0.0, -4.0))

    def rot():
        return ps.distributed_shearwarp_render(vol, iv, W, W, tf, mesh=mesh)

    reset_diff_counters()
    img = rot()
    torch.cuda.synchronize()
    counts = diff_launches()
    if counts["sweep_fwd"] != (2 * shards, shards):
        fail(f"11d: the rotated frame ran K3 {counts['sweep_fwd']}")
    compare(img, ps.distributed_shearwarp_render(vol, iv, W, W, tf,
                                                 mesh=one),
            "[11d] distributed_shearwarp_render (30, 20) vs the same call on "
            "one device")
    records += k3_pass_records(rot, "sweep_preblended_planes_diff", "none",
                               1, 4, counts["sweep_fwd"], "dist_scalar_rot",
                               "[11d rotated]")
    # the m-grid image against the plain torch sweep ('xla') of the same
    # call: on the slopes the kernels sample (each strip's first slope and
    # the float32 step to the next, JAX's per-shard slopes), and on the
    # m-grid's own points, which the warp assumes
    perm, dz_sign, march_p, origin_p, mx, my, mgrid = ps._rotated_frame(
        iv, W, W, 2.0, MarchConfig(), 2.0, True, mesh.rays * ps.STRIP)
    px, py, pz = perm
    vol_p = ps._permuted_sharded(vol, (2 - pz, 2 - py, 2 - px), mesh)
    hl = my.shape[0] // mesh.rays
    grids = [sk._slope_grids(ps._strip_slopes(mx, my[r * hl:(r + 1) * hl]),
                             mx.shape[0], hl) for r in range(mesh.rays)]
    mx_k, my_k = grids[0][0], np.concatenate([g[1] for g in grids])

    def m_image(backend, gx, gy):
        return ps._sweep_slope_space_call(
            vol_p, origin_p, tf, 0.05, 1.0, 0.0, 1.0, mx=gx, my=gy,
            march=march_p, mesh=mesh, dz_sign=dz_sign, n_planes=0,
            length_correction=True, plane_chunk=8, backend=backend,
            wrt=("volume", "lut", "params"))

    img_m = m_image("pallas", mx, my)
    compare(img_m, m_image("xla", mx_k, my_k),
            "[11d rotated] m-grid image (K3) vs the plain torch sweep on the "
            "slopes the kernels sample")
    d = (img_m - m_image("xla", mx, my)).abs().amax(-1)
    step = float(np.float32(mx[1] - mx[0]))
    print(f"  the slope step: K3's m-grid image against the plain sweep on "
          f"the m-grid's own points: max abs {float(d.max()):.3e}, pixels > "
          f"{TOL:g}: {float((d > TOL).float().mean()):.4%}; the last "
          f"column's slope is {(len(mx) - 1) * (step - mgrid[1]) / mgrid[1]:+.4f}"
          f" m-grid cells off the warp's ({len(mx)} columns, step "
          f"{step:.9e} vs {mgrid[1]:.9e})")
    del img_m, d, vol_p
    # the single-device shear-warp samples another m-grid (its own margin
    # and step, sweep and warp consistent): the difference is the resampling
    d = (img - sw.shearwarp_render_image(vol, iv, W, W, tf,
                                         backend="pallas")).abs()
    print(f"  vs the single-device shear-warp's m-grid: max abs "
          f"{float(d.max()):.3e}, pixels > {TOL:g}: "
          f"{float((d.amax(-1) > TOL).float().mean()):.4%}")
    if float(d.max()) > 1e-2:
        fail("11d: the rotated frame is further than 1e-2 from the "
             "single-device shear-warp")
    ms = host_ms(rot, 3)
    print(f"  rotated frame {ms:.3f} ms (host clock); launches {counts}")
    ps.clear_octant_cache()
    del img, d

    target = sk.pallas_slice_render(vol, origin, tf, width=W, height=W,
                                    n_planes=n)
    steps = {}
    for name, m in (("distributed", mesh), ("single-device", one)):
        init_fn, step_fn = pt.make_sweep_fit_step(m, W, W, n_planes=n)
        params, opt = init_fn(grayscale_ramp(9))
        reset_diff_counters()
        with ShardCalls("sweep_preblended_planes_diff") as calls:
            params, opt, loss = step_fn(params, opt, vol, ORIGIN, target)
        torch.cuda.synchronize()
        steps[name] = (float(loss), params["tf_lut"].grad.clone(),
                       params["tf_lut"].detach().clone(), diff_launches(),
                       calls)
    (l_d, g_d, lut_d, c_d, calls), (l_s, g_s, lut_s, _, _) = steps.values()
    print(f"  make_sweep_fit_step (n_planes {n}, wrt lut): loss {l_d:.8f}, "
          f"single-device {l_s:.8f}; updated LUT max diff "
          f"{float((lut_d - lut_s).abs().max()):.3e}; launches {c_d}")
    if c_d["sweep_fwd_ckpt"][0] != 2 * shards or c_d["sweep_bwd"][0] != 2 * shards:
        fail(f"11d: the step did not run K4/K5 per shard and pass: {c_d}")
    if abs(l_d - l_s) > 1e-4 * abs(l_s):
        fail("11d: the distributed step's loss differs from the "
             "single-device one")
    rel_l2(g_d, g_s, "[11d] step LUT gradient vs single-device")
    records += k4_k5_records([planes_shard(c) for c in calls], "none", 1, 4,
                             c_d, calls[0][1]["wrt"], "dist_scalar_fit",
                             "[11d step]")
    del vol, target, steps, calls
    torch.cuda.empty_cache()
    return records


def phase_11e(dev, card, smi, S=512):
    """The scan marcher on bricks=2 against RenderPipeline's scan frame."""
    import torch

    from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.parallel import bricks as pb
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig, query_channel)

    iv = default_benchmark_inv_view()
    pipe = RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(
        random_histogram_volume((10, 50, 50), 32, seed=0)).to(dev)))
    cfg = RenderConfig(camera=CameraConfig(width=S, height=S),
                       query_method=QueryMethod(1))
    mesh = make_mesh(2, 1)

    def dist():
        return pb.distributed_render_image(
            pipe.raw_stats, iv, pipe.tf_lut, cfg.density, cfg.brightness,
            cfg.tf.offset, cfg.tf.scale, width=S, height=S,
            channel=query_channel(QueryMethod(1)), march=cfg.march,
            mesh=mesh)

    img = dist()
    compare(img, pipe.render(iv, cfg, "scan"),
            "[11e] bricks.distributed_render_image (bricks=2) vs the "
            "pipeline's scan frame")
    if float(img[..., 3].max()) <= 0.0:
        fail("11e: empty image")
    ms = host_ms(dist, 1)
    scan_ms = host_ms(lambda: pipe.render(iv, cfg, "scan"), 1)
    print(f"[11e] Isabel 50 x 50 x 10 x 32 stats -> {S}^2, bricks=2, on "
          f"{card} ({smi}): {ms:.3f} ms, the pipeline's scan frame "
          f"{scan_ms:.3f} ms (host clock; torch ops, no hand-written kernel)")


#: 11f's worlds, (processes, bricks, rays, image height, d_lut's limit
#: against one process): JAX's ``global_mesh()`` default on two processes
#: (each one ray strip), one shard a process, then a ragged layout (rank 1
#: holds bricks of two strips, its strips 0 and 2), 1152 rows for three
#: strips
RAY_WORLDS = ((2, 1, 2, 1024, 1e-5), (4, 2, 2, 1024, 1e-5),
              (3, 2, 3, 1152, 1e-7))
#: how long a world's workers may take, start-up included
WORKER_LIMIT_S = 120
#: 11f's d_hist against the same mesh in one process: rel L2 within
#: DIST_DHIST_TOL, or within DIST_FLOOR_FACTOR times the same run's floor
#: (two one-process runs, 7.5e-6 to 8.5e-6 on an H100) where that is
#: larger; a factor of 2 in the gradient reads 0.5 or 1
DIST_DHIST_TOL = 1e-5
DIST_FLOOR_FACTOR = 1.5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(cfg, out):
    """Run ``cfg["world"]`` worker processes of this script on the card
    (``--worker-11f``), each logging to ``out``; fails if one fails or
    outlives ``WORKER_LIMIT_S``, and kills every one it started."""
    world = cfg["world"]
    addr = f"127.0.0.1:{free_port()}"
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(out / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--worker-11f",
                 json.dumps(dict(cfg, rank=r, addr=addr, out=str(out)))],
                cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + WORKER_LIMIT_S
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"11f world {world}: rank {r} still running after "
                     f"{WORKER_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (out / f"rank{r}.log").read_text()[-3000:]
            fail(f"11f world {world}: rank {r} exited {p.returncode}:\n{tail}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def worker_11f(cfg):
    """One process of an 11f world: joins the group, renders and
    differentiates its ray strips of the 512^3 x 16 mean through
    ``distributed_hist_render`` on the card, writes what the parent checks;
    the rank ``cfg["replay"]`` then replays its shards' K3/K4/K5 launches
    against their plain versions."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.kernels import _build
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.parallel import multihost
    from vrdd_tpu_torch.parallel import sweep as ps
    from vrdd_tpu_torch.parallel.mesh import image_mean

    torch.backends.cuda.matmul.allow_tf32 = False
    world, rank, B, W, H = (cfg[k] for k in ("world", "rank", "B", "W",
                                             "H"))
    out = Path(cfg["out"])
    _build.library()  # built by the parent
    multihost.initialize(cfg["addr"], world, rank, backend=cfg["backend"])
    mesh = multihost.global_mesh(cfg["bricks"], cfg["rays"])
    dev = mesh.device
    res = {"rank": rank, "device": str(dev), "shards": mesh.shards,
           "bricks": list(mesh.local_bricks), "rays": list(mesh.local_rays)}
    if dev.type != "cuda":
        (out / f"rank{rank}.json").write_text(json.dumps(res))
        sys.exit(f"rank {rank}: the mesh is on {dev}, not the card")
    # this process's bricks, read from the parent's file
    vol = np.load(cfg["path"], mmap_mode="r")
    zl = vol.shape[0] // mesh.bricks
    b = mesh.local_bricks
    hist = torch.from_numpy(np.array(
        vol[b[0] * zl:(b[-1] + 1) * zl])).view(torch.bfloat16).to(dev)
    del vol
    tf = default_transfer_function()
    origin = torch.tensor(ORIGIN)
    rows, mode = sk.decode_weight_rows("mean", B, family="unit")

    def render(h=hist, lut=tf, wrt=("hist", "lut", "params")):
        return ps.distributed_hist_render(
            h, rows, origin, lut, DIST_DENSITY, width=W, height=H,
            mesh=mesh, stat=mode, wrt=wrt)

    def frame():
        return multihost.gather_image(render(), mesh)

    def fwdbwd():
        h = hist.detach().requires_grad_(True)
        lut = torch.tensor(tf, device=dev, requires_grad=True)
        loss = image_mean((render(h, lut, ("hist", "lut")) - 0.25) ** 2,
                          mesh)
        loss.backward()
        return loss.detach(), h.grad, lut.grad

    def timed3(fn):
        """``fn()`` three times on the host clock: ``(the first run's
        result, its launch counts (set to 0 just before, read just after),
        its recorded shard calls, the median ms)``."""
        times = []
        reset_diff_counters()
        with ShardCalls("sweep_preblended_hist_diff") as calls:
            t0 = time.perf_counter()
            first = fn()
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        counts = diff_launches()
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return first, counts, calls, sorted(times)[1]

    # the main-path runs, each checked on its first run
    img, res["frame_counts"], frame_calls, res["frame_ms"] = timed3(frame)
    if rank == 0:
        np.save(out / "frame.npy", img)
    (loss, g_hist, g_lut), res["fwdbwd_counts"], fb_calls, \
        res["fwdbwd_ms"] = timed3(fwdbwd)
    for i, d in enumerate(b):  # each slab from its first holder
        if mesh.slab_holders(d)[0] == rank:
            np.save(out / f"dhist{d}.npy", g_hist[i * zl:(i + 1) * zl]
                    .view(torch.int16).cpu().numpy())
    if rank == 0:
        np.save(out / "dlut.npy", g_lut.cpu().numpy())
        res["loss"] = float(loss)
    del g_hist, g_lut
    dist.barrier()
    dist.destroy_process_group()
    if rank == cfg["replay"]:
        # this process's shards alone, against their plain versions
        passes = {False: [], True: []}
        for c in frame_calls:
            passes[c[1].get("acc_init") is not None].append(hist_shard(c))
        tag = f"dist_rays{world},{mesh.bricks}x{mesh.rays},{mode}"
        k3 = res["frame_counts"]["sweep_fwd"]
        records = [k3_shard_record(
            f"sweep_fwd[{tag},pass{1 + seeded}]", passes[seeded], mode, B,
            hist.element_size(), k3[1] if seeded else k3[0] - k3[1],
            f"[11f rank {rank}] K3 pass {1 + seeded}")
            for seeded in (False, True) if passes[seeded]]
        records += k4_k5_records([hist_shard(c) for c in fb_calls], mode, B,
                                 hist.element_size(), res["fwdbwd_counts"],
                                 ("hist", "lut"), tag, f"[11f rank {rank}]")
        res["records"] = records
    (out / f"rank{rank}.json").write_text(json.dumps(res))


def phase_11f(dev, card, smi, tf, hist, n, B, W, work):
    """Processes that split the ray strips (JAX's rays-on-hosts), and a
    ragged layout, on the card: each world against the same mesh in one
    process and the single-device render; returns the replaying ranks'
    kernel records."""
    import numpy as np
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.parallel import multihost
    from vrdd_tpu_torch.parallel import sweep as ps
    from vrdd_tpu_torch.parallel.mesh import make_mesh, placement

    t_phase = time.perf_counter()
    origin = torch.tensor(ORIGIN)
    rows, mode = sk.decode_weight_rows("mean", B, family="unit")
    path = work / "hist11f.npy"
    np.save(path, hist.view(torch.int16).cpu().numpy())

    def fwdbwd(fn):
        h = hist.detach().requires_grad_(True)
        lut = torch.tensor(tf, device=dev, requires_grad=True)
        loss = torch.mean((fn(h, lut) - 0.25) ** 2)
        loss.backward()
        return loss.detach(), h.grad, lut.grad

    singles = {}

    def single_device(H):
        """The single-device K2 frame and fwd+bwd at ``W x H`` (the last
        height's only: each holds a 4 GiB d_hist)."""
        if H not in singles:
            singles.clear()

            def single(h, lut):
                return sv.pallas_hist_render_diff(
                    h, rows, origin, lut, DIST_DENSITY, width=W, height=H,
                    wrt=("hist", "lut"), stat=mode, route="inkernel")

            singles[H] = (sk.pallas_hist_render(
                hist, rows, origin, tf, DIST_DENSITY, width=W, height=H,
                stat=mode),) + fwdbwd(single)
        return singles[H]

    records = []
    for world, bricks, rays, H, dlut_limit in RAY_WORLDS:
        t_world = time.perf_counter()
        frame_s, loss_s, g_hist_s, g_lut_s = single_device(H)
        backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
        transport = "nccl, one card a process" if backend == "nccl" else (
            "gloo via host, every process on card 0")
        mesh1 = make_mesh(bricks, rays)

        def render1(h=hist, lut=tf, wrt=("hist", "lut", "params"),
                    mesh1=mesh1, H=H):
            return ps.distributed_hist_render(
                h, rows, origin, lut, DIST_DENSITY, width=W, height=H,
                mesh=mesh1, stat=mode, wrt=wrt)

        def fwdbwd1():
            return fwdbwd(lambda h, lut: render1(h, lut, ("hist", "lut")))

        frame1 = render1()
        loss1, g_hist1, g_lut1 = fwdbwd1()
        # two runs of one process differ: K5's f32 atomics, through the
        # bf16 rounding of d_hist; the world's d_hist is held against this
        # run's floor
        floor = rel_l2(fwdbwd1()[1], g_hist1, f"[11f {world}p] d_hist of two "
                       "runs in one process (the floor)", limit=math.inf)
        dhist_limit = max(DIST_DHIST_TOL, DIST_FLOOR_FACTOR * floor)
        frame1_ms = host_ms(
            lambda: multihost.gather_image(render1(), mesh1), 3)
        fb1_ms = host_ms(fwdbwd1, 3)
        out = work / f"world{world}"
        out.mkdir(exist_ok=True)
        torch.cuda.empty_cache()
        # the replaying rank: the last of those holding the most bricks
        replay = max(range(world), key=lambda p: (
            len({b for b, _ in placement(bricks, rays, world, p)}), p))
        t0 = time.perf_counter()
        ranks = run_workers(dict(world=world, bricks=bricks, rays=rays,
                                 backend=backend, path=str(path), B=B, W=W,
                                 H=H, replay=replay), out)
        wall = time.perf_counter() - t0
        print(f"[11f] distributed_hist_render mean on {world} processes, "
              f"bricks={bricks} x rays={rays}, {n}^3 x {B} bf16 -> {W} x "
              f"{H}, density {DIST_DENSITY}, transport {transport}, on "
              f"{card} ({smi}); the workers took {wall:.1f} s")
        log = (out / f"rank{replay}.log").read_text().strip()
        print("  " + log.replace("\n", "\n  "))
        for r in ranks:
            s = len(r["shards"])
            print(f"  rank {r['rank']} on {r['device']}: shards "
                  f"{r['shards']} (bricks {r['bricks']}, rays {r['rays']}); "
                  f"frame launches {r['frame_counts']}, fwd+bwd launches "
                  f"{r['fwdbwd_counts']}")
            if not r["device"].startswith("cuda"):
                fail(f"11f: rank {r['rank']} ran on {r['device']}")
            passes = 2 if bricks > 1 else 1
            k3 = r["frame_counts"]["sweep_fwd"]
            if tuple(k3) != (passes * s, (passes - 1) * s):
                fail(f"11f: rank {r['rank']} ran K3 {k3} (launches, seeded)"
                     f" for its {s} shards")
            for name in ("sweep_fwd_ckpt", "sweep_bwd"):
                if r["fwdbwd_counts"][name][0] != passes * s:
                    fail(f"11f: rank {r['rank']} ran {name} "
                         f"{r['fwdbwd_counts'][name]} for its {s} shards")
        img = torch.from_numpy(np.load(out / "frame.npy")).to(dev)
        e = float((img - frame1).abs().max())
        print(f"  frame vs the same mesh in one process: max abs "
              f"{e:.3e} ({'bitwise' if e == 0.0 else 'not bitwise'})")
        if e > 1e-6:
            fail(f"11f world {world}: the frame is {e:.3e} from the same "
                 "mesh in one process (limit 1e-6)")
        compare(img, frame_s, f"[11f {world}p] frame vs single-device K2")
        loss = ranks[0]["loss"]
        print(f"  loss {loss:.8f}, one process {float(loss1):.8f}, "
              f"single-device {float(loss_s):.8f}")
        if abs(loss - float(loss1)) > 1e-5 * abs(float(loss1)):
            fail(f"11f world {world}: the loss differs from one process's")
        if abs(loss - float(loss_s)) > 1e-4 * abs(float(loss_s)):
            fail(f"11f world {world}: the loss differs from the "
                 "single-device one")
        g_hist = torch.cat([torch.from_numpy(np.load(
            out / f"dhist{d}.npy")).view(torch.bfloat16)
            for d in range(bricks)]).to(dev)
        rel_l2(g_hist, g_hist1, f"[11f {world}p] d_hist vs one process "
               f"(limit {dhist_limit:.3e})", limit=dhist_limit)
        rel_l2(g_hist, g_hist_s, f"[11f {world}p] d_hist vs single-device",
               limit=2.0 ** -8)
        del g_hist, g_hist1
        g_lut = torch.from_numpy(np.load(out / "dlut.npy")).to(dev)
        rel_l2(g_lut, g_lut1, f"[11f {world}p] d_lut vs one process",
               limit=dlut_limit)
        rel_l2(g_lut, g_lut_s, f"[11f {world}p] d_lut vs single-device")
        print(f"  frame {ranks[0]['frame_ms']:.3f} ms, fwd+bwd "
              f"{ranks[0]['fwdbwd_ms']:.3f} ms on {world} processes (rank "
              f"0, host clock, median of 3, {transport} collectives "
              f"included; every rank: frame "
              f"{[round(r['frame_ms'], 3) for r in ranks]}, fwd+bwd "
              f"{[round(r['fwdbwd_ms'], 3) for r in ranks]}); the same mesh "
              f"in one process {frame1_ms:.3f} / {fb1_ms:.3f} ms; the world "
              f"took {time.perf_counter() - t_world:.1f} s")
        records += ranks[replay]["records"]
        shutil.rmtree(out)
        del frame1, frame_s, g_hist_s
        torch.cuda.empty_cache()
    singles.clear()
    path.unlink()
    print(f"  phase 11f: {time.perf_counter() - t_phase:.1f} s")
    return records


def phase_11(dev, card, smi, tf, work):
    """The distributed sweep of parallel/ on one card: 11a-11f. Returns the
    kernel records."""
    import torch

    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.parallel.mesh import make_mesh

    n, B, W = 512, 16, 1024
    hist = blob_histogram_volume(n, B, device=dev, dtype=torch.bfloat16)
    records = phase_11a(dev, card, smi, tf, hist, n, B, W, make_mesh(4, 2))
    records += phase_11b(dev, card, smi, tf, hist, n, B, W)
    records += phase_11f(dev, card, smi, tf, hist, n, B, W, work)
    del hist
    torch.cuda.empty_cache()
    phase_11c(work)
    records += phase_11d(dev, card, smi, tf)
    phase_11e(dev, card, smi)
    return records


# ---- phase 12: precision='bf16', K4's live map, the native loader, view ----

#: FP32 operations the bf16 mode adds to an evaluated sample: ten
#: round trips through bf16 (the four taps, the four weights, the
#: y-interpolated pair), two conversions each
BF16_SAMPLE_OPS = 20


#: the bf16 backward's second limit, on the decoded-plane cotangent: at
#: most BF16_SHARE_LIMIT of its nonzero entries off the plain bf16
#: version's by more than BF16_SHARE_TAU of the entry. Where the kernels'
#: f32 arithmetic differs from the plain version's in the last bits, the
#: bf16 roundings turn a little of it into whole bf16 steps of a row sum;
#: a skipped rounding moves a third or more of all entries, at a relative
#: L2 within 1.4-2.1x of GRAD_TOL. 12b reads the kernel, a noise floor and
#: planted faults at the main path's shape and fails if a fault passes
#: both limits (on an H100: the kernel 0.11% at 8.1e-5, the floor 1.8%,
#: the faults 33-94% at 1.4e-3 to 1.8e-2).
BF16_SHARE_TAU = 2.0 ** -12
BF16_SHARE_LIMIT = 0.08


def share_off(got, ref, tau=BF16_SHARE_TAU):
    """Share of the nonzero entries of ``ref`` that ``got`` misses by more
    than ``tau`` of the entry."""
    nz = ref != 0
    return float(((got - ref).abs() > tau * ref.abs())[nz].float().mean())


@contextlib.contextmanager
def y_transpose_fault(sv, skip):
    """A planted fault of the bf16 backward: K5's row buffer goes through the
    plain y-transpose with one of JAX's roundings skipped (``'dtmp'``: the
    row sums, ``'wy'``: the y weights), for every caller of
    ``slice_vjp.dplane_bf16`` inside the block."""
    import torch

    def r(t):
        return t.to(torch.bfloat16).float()

    def transpose(wy, dtmp):
        return torch.bmm((wy if skip == "wy" else r(wy)).transpose(1, 2),
                         dtmp if skip == "dtmp" else r(dtmp))

    def dplane(cfg, dtmp, d_planes):
        d_planes.copy_(sv.dplane_bf16_reference(cfg, dtmp,
                                                *d_planes.shape[:2]))

    keep = sv.dplane_bf16, sv.bf16_y_transpose
    sv.dplane_bf16, sv.bf16_y_transpose = dplane, transpose
    try:
        yield
    finally:
        sv.dplane_bf16, sv.bf16_y_transpose = keep


def phase_12a(dev, card, smi, hist, tf, origin, n, B, W, counts):
    """K2 at precision='bf16' for mean, var and entropy on both fetch paths
    against the plain bf16 version; returns the kernel records."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk

    k2 = sk.pallas_hist_render
    print(f"[12a] K2 precision='bf16', {n}^3 x {B} bf16 -> {W}^2 on {card} "
          f"({smi})")
    cases = {}
    for stat in ("mean", "var", "entropy"):
        rows, mode = sk.decode_weight_rows(stat, B, family="unit")
        cases[mode] = (rows, dict(
            transfer_scale=10.0 if stat == "var" else 1.0, width=W, height=W,
            stat=mode))
    # the main-path run: each statistic on both fetch paths
    k2.launches = k2.staged_launches = k2.bf16_launches = 0
    images, launches = {}, {}
    for mode, (rows, kw) in cases.items():
        before = (k2.launches, k2.staged_launches, k2.bf16_launches)
        images[mode] = {s: on_path(s, lambda rows=rows, kw=kw: k2(
            hist, rows, origin, tf, precision="bf16", **kw))()
            for s in (True, False)}
        launches[mode] = tuple(a - b for a, b in zip(
            (k2.launches, k2.staged_launches, k2.bf16_launches), before))
    torch.cuda.synchronize()
    print(f"  launches in the main-path run (K2, staged, bf16): {launches}")
    if any(v != (2, 1, 2) for v in launches.values()):
        fail(f"12a: K2's bf16 launches were not counted: {launches}")
    records = []
    for mode, (rows, kw) in cases.items():
        img = images[mode][True]
        bitwise(img, images[mode][False], f"K2 {mode} bf16 staged vs direct")

        def plain(rows=rows, kw=kw):
            return sk.hist_render_reference(hist, rows, origin, tf,
                                            precision="bf16", **kw)

        plain_ms, ref = timed_once(plain)
        err = compare(img, ref, f"K2 {mode} bf16 vs plain bf16")
        f32 = k2(hist, rows, origin, tf, **kw)
        dist = float((img - f32).abs().max())
        share = float(((img - f32).abs().amax(-1) > TOL).float().mean())
        print(f"  K2 {mode}: bf16 vs f32 image max {dist:.3e}, pixels > "
              f"{TOL:g}: {share:.4%}")
        if dist == 0.0:
            fail(f"12a: K2 {mode} bf16 image equals the f32 image")
        del ref, f32
        ms, direct_ms = paths_ms(lambda s, rows=rows, kw=kw: on_path(
            s, lambda: k2(hist, rows, origin, tf, precision="bf16", **kw)))
        n_live, n_texels = counts[mode]
        bd = bound(n_texels * B * hist.element_size() + W * W * 16,
                   n_live * (SAMPLE_OPS + BF16_SAMPLE_OPS
                             + decode_ops(mode, B)))
        print(f"  K2 {mode} bf16: staged {ms:.3f} ms, direct {direct_ms:.3f} "
              f"ms, plain {plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
              f"({bd['bound_by']})")
        records.append({
            "name": f"pallas_hist_render[{mode},bf16]", "route": "cuda",
            "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_kernel.py:1595",
            "launches": launches[mode][2],
            "staged_launches": launches[mode][1], "max_abs_err": err,
            "ms": ms, "direct_ms": direct_ms, "plain_ms": plain_ms, **bd,
        })
    return records


def phase_12b(dev, card, smi, hist, tf, origin, n, B, W, counts):
    """In-kernel mean fwd+bwd at precision='bf16' (K4, K5, the y-transpose)
    and the materialized mean, against the plain bf16 backward; K4, K5 and
    the transpose timed; returns the kernel records."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    print(f"[12b] fwd+bwd precision='bf16', mean, wrt (hist, lut), {n}^3 x "
          f"{B} bf16 -> {W}^2 on {card} ({smi})")
    rows, mode = sk.decode_weight_rows("mean", B, family="unit")
    lut0 = torch.as_tensor(tf, device=dev)
    counters = diff_counters() + (sv.dplane_bf16,)

    def fwd_bwd(route, precision="bf16"):
        h = hist.detach().requires_grad_()
        lut = lut0.clone().requires_grad_()
        img = sv.pallas_hist_render_diff(
            h, rows, origin, lut, width=W, height=W, stat=mode,
            wrt=("hist", "lut"), route=route, precision=precision)
        loss = torch.mean((img - 0.25) ** 2)
        return (loss, img) + torch.autograd.grad(loss, [h, lut])

    def plain():
        hp = hist.detach().requires_grad_()
        lp = lut0.clone().requires_grad_()
        imgp = sk.hist_render_reference(hp, rows, origin, lp, width=W,
                                        height=W, stat=mode,
                                        precision="bf16")
        lossp = torch.mean((imgp - 0.25) ** 2)
        return (lossp, imgp) + torch.autograd.grad(lossp, [hp, lp])

    plain_ms, (lossp, imgp, ghp, glp) = timed_once(plain)
    mrays, main = {}, {}
    for route in ("inkernel", "materialized"):
        for c in counters:
            c.launches = 0
        for c in diff_counters():
            c.bf16_launches = 0
        loss, img, gh, gl = fwd_bwd(route)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        bf16 = {c.__name__: c.bf16_launches for c in diff_counters()}
        print(f"  [{route}] launches in the main-path run: {launches}, bf16 "
              f"{bf16}, loss {float(loss.detach()):.6f}")
        if (launches["sweep_fwd_ckpt"] == 0 or launches["sweep_bwd"] == 0
                or launches["dplane_bf16"] == 0
                or bf16["sweep_fwd_ckpt"] != launches["sweep_fwd_ckpt"]
                or bf16["sweep_bwd"] != launches["sweep_bwd"]):
            fail(f"12b {route}: the bf16 kernels did not run: {launches}, "
                 f"{bf16}")
        main[route] = launches
        compare(img.detach(), imgp.detach(), f"[{route}] bf16 image")
        rel_l2(gh, ghp, f"[{route}] bf16 d_hist vs plain bf16")
        rel_l2(gl, glp, f"[{route}] bf16 d_lut vs plain bf16")
        del loss, img, gh, gl
    # witnesses: the same limit on kernels that skip JAX's roundings
    for name in ("dtmp unrounded", "f32 kernel"):
        if name == "f32 kernel":
            gh = fwd_bwd("inkernel", "f32")[2]
        else:
            with y_transpose_fault(sv, name.split()[0]):
                gh = fwd_bwd("inkernel")[2]
        if rel_l2(gh, ghp, f"[witness: {name}] d_hist vs plain bf16",
                  math.inf) <= GRAD_TOL:
            print(f"  (the d_hist limit alone passes '{name}')")
        del gh
    del lossp, imgp, ghp, glp
    for route in ("inkernel", "materialized"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda route=route: fwd_bwd(route), 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mrays[route] = W * W / ms / 1e3
        print(f"  [{route}] bf16 fwd+bwd {ms:.3f} ms ({mrays[route]:.2f} "
              f"Mrays/s), plain {plain_ms:.3f} ms, peak {peak:.2f} GiB")

    # K4, K5 and the y-transpose alone, on the in-kernel route's inputs
    cfg = sv.render_config(hist.shape, origin, stat=mode, width=W, height=W,
                           precision="bf16")
    rows_t = torch.as_tensor(rows, device=dev)
    args = (cfg, hist, rows_t, lut0, torch.tensor(0.05, device=dev),
            torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev))
    k4_ms, k4_direct = paths_ms(
        lambda s: lambda: sv.sweep_fwd_ckpt(*args, staged=s))
    k4_plain_ms, (ref4, tck_ref) = timed_once(
        lambda: sv.sweep_fwd_ckpt_reference(*args))
    img4, tck = sv.sweep_fwd_ckpt(*args)
    k4_err = compare(img4, ref4, "K4 bf16 image vs plain")
    compare(tck[..., None], tck_ref[..., None], "K4 bf16 checkpoints")
    del ref4, tck_ref
    g = (2.0 / img4.numel()) * (img4 - 0.25)
    flags = (True, True, False)
    k5_ms, k5_direct = paths_ms(
        lambda s: lambda: sv.sweep_bwd(*args, g, tck, *flags, staged=s))
    k5_plain_ms, (d_r, small_r, *_) = timed_once(
        lambda: sv.sweep_bwd_reference(*args, g, *flags))
    got = {s: sv.sweep_bwd(*args, g, tck, *flags, staged=s)
           for s in (True, False)}
    for s in (True, False):
        path = "staged" if s else "direct"
        rel_l2(got[s][0], d_r, f"K5+transpose bf16 d_dec, {path}")
        rel_l2(got[s][1], small_r, f"K5 bf16 d_lut, {path}")
    bitwise(got[True][1], got[False][1], "K5 bf16 d_lut staged vs direct")
    k5_err = float((got[True][0] - d_r).abs().max())
    for s in (True, False):
        share = share_off(got[s][0], d_r)
        print(f"  K5+transpose bf16 d_dec, {'staged' if s else 'direct'}: "
              f"{share:.4%} of entries off by more than 2^-12")
        if share > BF16_SHARE_LIMIT:
            fail(f"12b: the bf16 d_dec is off on {share:.4%} of its entries")
    bf16_witnesses(dev, sv, args, g, tck, flags, got[True][0], d_r)
    del got, d_r

    # the transpose kernel on a row buffer of the main path's shape
    P, nx, ny = len(cfg.zs), hist.shape[3], hist.shape[2]
    dtmp = torch.randn((P, W, nx), device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
    d_planes = torch.empty((n, ny, nx), device=dev)
    tr_ms = time_ms(lambda: sv.dplane_bf16(cfg, dtmp, d_planes), TIMED_RUNS)
    tr_plain_ms, d_ref = timed_once(
        lambda: sv.dplane_bf16_reference(cfg, dtmp, n, ny))
    tr_rel = rel_l2(d_planes, d_ref, "transpose kernel vs plain", 1e-6)
    tr_err = float((d_planes - d_ref).abs().max())
    print(f"  transpose kernel vs plain: max_abs_err {tr_err:.3e} (entries "
          f"up to {float(d_ref.abs().max()):.3e})")
    del d_ref
    # the library call on the same function: torch.bmm of the bf16-rounded
    # dense wy (the plain version's) and dtmp, f32 accumulation
    y0, y1, w0, w1, inbox = sv._row_taps(cfg, ny, dev)
    wy = torch.zeros((P, W, ny), device=dev)
    wy.scatter_add_(2, y0[..., None], torch.where(inbox, w0, 0.0)[..., None])
    wy.scatter_add_(2, y1[..., None], torch.where(inbox, w1, 0.0)[..., None])
    wy_t = wy.to(torch.bfloat16).float().transpose(1, 2)
    dt16 = dtmp.to(torch.bfloat16).float()
    del wy, y0, y1, w0, w1, inbox
    lib_ms = time_ms(lambda: torch.bmm(wy_t, dt16), TIMED_RUNS)
    del wy_t, dt16, dtmp
    torch.cuda.empty_cache()

    n_live, n_texels = counts["linear"]
    fwd_ops = n_live * (SAMPLE_OPS + BF16_SAMPLE_OPS + decode_ops(mode, B))
    vol_bytes = n_texels * B * hist.element_size()
    img_bytes, tck_bytes = W * W * 16, cfg.n_chunks * W * W * 4
    dtmp_bytes, d_bytes = 4 * P * W * nx, 4 * n * ny * nx
    bounds = {
        "sweep_fwd_ckpt": bound(vol_bytes + img_bytes + tck_bytes, fwd_ops),
        "sweep_bwd": bound(vol_bytes + tck_bytes + img_bytes + d_bytes,
                           n_live * (K5_SAMPLE_OPS + BF16_SAMPLE_OPS
                                     + decode_ops(mode, B))),
        "dplane_bf16": bound(dtmp_bytes + d_bytes, 4 * P * W * nx),
    }
    bounds["dplane_bf16"]["library_ms"] = lib_ms
    records = []
    for name, src, line, k_ms, d_ms, p_ms, e in (
        ("sweep_fwd_ckpt", "slice_sweep.cu", "slice_vjp.py:714", k4_ms,
         k4_direct, k4_plain_ms, k4_err),
        ("sweep_bwd", "slice_vjp_staged.cu", "slice_vjp.py:787", k5_ms,
         k5_direct, k5_plain_ms, k5_err),
        ("dplane_bf16", "dplane_bf16.cu", "slice_vjp.py:509", tr_ms, None,
         tr_plain_ms, tr_err),
    ):
        lib = bounds[name]["library_ms"]
        print(f"  {name}[mean,inkernel,bf16]: {k_ms:.3f} ms"
              + (f" (direct {d_ms:.3f} ms)" if d_ms is not None else "")
              + f", plain {p_ms:.3f} ms, bound "
              f"{bounds[name]['bound_ms']:.3f} ms "
              f"({bounds[name]['bound_by']})"
              + (f", torch.bmm {lib:.3f} ms" if lib is not None else "")
              + f", err {e:.3e}")
        records.append({
            "name": f"{name}[mean,inkernel,bf16]", "route": "cuda",
            "source": f"vrdd_tpu_torch/csrc/{src}",
            "replaces": f"vrdd_tpu/pallas/{line}",
            "launches": main["inkernel"][name],
            "max_abs_err": e, "ms": k_ms, "direct_ms": d_ms,
            "plain_ms": p_ms, **bounds[name],
        })
    print("  (sweep_bwd's ms holds K5 and its transpose launch, as the "
          "wrapper runs them)")
    return records


def bf16_witnesses(dev, sv, args, g, tck, flags, d_dec, d_ref):
    """K5 + the transpose's decoded-plane cotangent ``d_dec`` against the
    plain bf16 version's ``d_ref``, beside what the limits must tell apart:
    the noise floor (the plain bf16 backward against itself, its cotangent
    perturbed so that the plain f32 backward moves by the kernels' f32 gap)
    and kernels that skip JAX's roundings (a planted transpose fault, the
    f32 kernels). Fails if the kernel or the floor misses the share limit,
    or if a fault meets both limits."""
    import dataclasses

    import torch

    from vrdd_tpu_torch.march import slice as ms

    def _d_res_unrounded(ctx, d_res):
        wy, wx = ctx.saved_tensors
        return None, ms.bf16_y_transpose(wy, torch.bmm(d_res, wx)), None

    cfg = args[0]
    args32 = (dataclasses.replace(cfg, precision="f32"),) + args[1:]
    got = {"kernel": d_dec}
    with y_transpose_fault(sv, "dtmp"):
        got["dtmp unrounded"] = sv.sweep_bwd(*args, g, tck, *flags)[0]
    _, tck32 = sv.sweep_fwd_ckpt(*args32)
    got["f32 kernel"] = sv.sweep_bwd(*args32, g, tck32, *flags)[0]
    del tck32
    d32 = sv.sweep_bwd_reference(*args32, g, *flags)[0]
    gap = rel_l2(got["f32 kernel"], d32, "f32 K5 vs plain f32 d_dec (the "
                 "kernels' f32 gap)", math.inf)
    where_off(got["f32 kernel"], d32, "f32 K5 vs plain f32")
    where_off(d_dec, d_ref, "bf16 K5 vs plain bf16")
    noise = torch.randn(g.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(9))
    eps0 = 2.0 ** -16
    r0 = rel_l2(sv.sweep_bwd_reference(*args32, g * (1 + eps0 * noise),
                                       *flags)[0], d32,
                f"plain f32 d_dec, cotangent x (1 + {eps0:g} N)", math.inf)
    eps = eps0 * gap / r0
    del d32
    got["noise floor"] = sv.sweep_bwd_reference(
        *args, g * (1 + eps * noise), *flags)[0]
    print(f"  noise floor: the cotangent x (1 + {eps:.3e} N) moves the plain "
          f"f32 d_dec by the f32 gap {gap:.3e}")
    keep = ms._Bf16Resample.backward
    ms._Bf16Resample.backward = staticmethod(_d_res_unrounded)
    try:
        got["d_res unrounded (plain)"] = sv.sweep_bwd_reference(
            *args, g, *flags)[0]
    finally:
        ms._Bf16Resample.backward = keep
    readings = {}
    for name, d in got.items():
        rel = rel_l2(d, d_ref, f"[{name}] d_dec vs plain bf16", math.inf)
        shares = {t: share_off(d, d_ref, 2.0 ** -t) for t in (14, 12, 10, 8)}
        readings[name] = (rel, shares[12])
        print(f"  [{name}] d_dec entries off by more than 2^-k of the entry: "
              + ", ".join(f"k={t}: {v:.4%}" for t, v in shares.items()))
    del got
    torch.cuda.empty_cache()
    limit = f"{BF16_SHARE_LIMIT:.0%} of entries off by 2^-12"
    if readings["kernel"][1] > BF16_SHARE_LIMIT:
        fail(f"12b: the bf16 d_dec misses the limit ({limit})")
    if readings["noise floor"][1] > BF16_SHARE_LIMIT:
        fail(f"12b: the noise floor misses the limit ({limit}): the limit "
             "would fail a correct kernel")
    for name in ("dtmp unrounded", "f32 kernel", "d_res unrounded (plain)"):
        rel, share = readings[name]
        if share <= BF16_SHARE_LIMIT and rel <= GRAD_TOL:
            fail(f"12b: the planted fault '{name}' passes both limits")
    return readings


def phase_12c(dev, card, smi, hist, tf, origin, n, B, W):
    """K4's live map and live_fractions on the decoded mean channel at
    density 0.05 and 0.2: the kernel's bytes (both paths) against the plain
    version's, K4 with the map timed against K4 without it."""
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    print(f"[12c] K4 live map and live_fractions, decoded mean {n}^3 -> "
          f"{W}^2 on {card} ({smi})")
    rows, _ = sk.decode_weight_rows("mean", B, family="unit")
    mean_vol = sk.decode_with_rows(hist, rows, "linear")
    cfg = sv.render_config(mean_vol.shape, origin, width=W, height=W)
    lut = torch.as_tensor(tf, device=dev)
    records = []
    for density in (0.05, 0.2):
        args = (cfg, mean_vol, None, lut, torch.tensor(density, device=dev),
                torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev))
        k4 = sv.sweep_fwd_ckpt
        k4.launches = k4.live_launches = 0
        lf = sv.live_fractions(mean_vol, origin, tf, density, width=W,
                               height=W, n_planes=n)
        torch.cuda.synchronize()
        launches = (k4.launches, k4.live_launches)
        print(f"  density {density}: live_fractions {lf}; K4 launches "
              f"(all, with the map) {launches}")
        if launches != (1, 1):
            fail(f"12c: live_fractions did not run K4 with its map: "
                 f"{launches}")
        got = {s: sv.sweep_fwd_ckpt(*args, staged=s, live_map=True)
               for s in (True, False)}
        plain_ms, (img_r, tck_r, live_r, tied) = timed_once(
            lambda: sv.sweep_fwd_ckpt_reference(*args, live_map=True))
        err = 0.0
        for s in (True, False):
            path = "staged" if s else "direct"
            err = max(err, compare(got[s][0], img_r, f"K4 with the map, "
                                   f"{path}: image vs plain"))
            compare(got[s][1][..., None], tck_r[..., None],
                    f"K4 with the map, {path}: checkpoints vs plain")
            live = got[s][2]
            differ = (live != live_r) & (tied == 0)
            print(f"  K4 live map, {path}: {int((live != live_r).sum())} of "
                  f"{live.numel()} bytes differ from the plain version, "
                  f"{int(differ.sum())} outside tied tiles "
                  f"({int(tied.sum())} tied)")
            if bool(differ.any()):
                fail(f"12c: K4's live map ({path}) differs from the plain "
                     f"version outside the cutoff ties")
        bitwise(got[True][2], got[False][2], "K4 live map staged vs direct")
        bits = got[True][2].bool()
        if abs(float(bits.float().mean()) - lf["tile_live_frac"]) > 1e-12:
            fail("12c: live_fractions disagrees with the kernel's bytes")
        plain_img, plain_tck = sv.sweep_fwd_ckpt(*args)
        bitwise(got[True][0], plain_img, "K4 image with the map vs without")
        bitwise(got[True][1], plain_tck, "K4 checkpoints with the map vs "
                "without")
        del got, img_r, tck_r, live_r, tied, plain_img, plain_tck
        # in turns: without, with, with, without (each on the staged path)
        t = {False: [], True: []}
        for with_map in (False, True, True, False):
            t[with_map].append(time_ms(
                lambda m=with_map: sv.sweep_fwd_ckpt(*args, live_map=m),
                TIMED_RUNS))
        ms, ms_plain_k4 = sum(t[True]) / 2, sum(t[False]) / 2
        print(f"  K4 with the map {ms:.3f} ms, without {ms_plain_k4:.3f} ms "
              f"({100 * (ms / ms_plain_k4 - 1):+.2f}%), plain version "
              f"{plain_ms:.3f} ms")
        n_live, n_texels = live_samples(mean_vol, cfg.zs, cfg.slopes, tf,
                                        density, 0.0, 1.0, W, W,
                                        reverse=True)
        bd = bound(n_texels * 4 + W * W * 16 + cfg.n_chunks * W * W * 4
                   + bits.numel(), n_live * SAMPLE_OPS)
        records.append({
            "name": f"sweep_fwd_ckpt[live,density {density}]",
            "route": "cuda", "source": "vrdd_tpu_torch/csrc/slice_sweep.cu",
            "replaces": "vrdd_tpu/pallas/slice_vjp.py:714",
            "launches": launches[1], "max_abs_err": err, "ms": ms,
            "no_map_ms": ms_plain_k4, "plain_ms": plain_ms, **bd,
        })
    del mean_vol
    torch.cuda.empty_cache()
    return records


def phase_12d(work):
    """The native loader: a 128^3 x 16 file through
    native.read_histograms_bins_major, byte for byte the Python reader's,
    both timed; render-hist must report the native loader."""
    import contextlib
    import io

    import torch

    from vrdd_tpu_torch import cli
    from vrdd_tpu_torch.io import formats, native
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume

    print("[12d] native loader, 128^3 x 16")
    if not native.available():
        fail("12d: the native loader does not build on this machine")
    n, B = 128, 16
    path = work / "native128.bin"
    formats.write_raw_histograms(str(path), random_histogram_volume(
        (n, n, n), n_bins=B, seed=3).reshape(-1, B))
    for dtype in ("bfloat16", "float32"):
        ms, out = {"native": [], "python": []}, {}
        for which in ("native", "python", "python", "native"):  # in turns
            reader = native if which == "native" else formats
            t0 = time.perf_counter()
            out[which] = reader.read_histograms_bins_major(
                str(path), (n, n, n), B, dtype=dtype)
            ms[which].append(1e3 * (time.perf_counter() - t0))
        if not torch.equal(out["native"], out["python"]):
            fail(f"12d: native {dtype} load differs from the Python reader")
        del out
        print(f"  {dtype}: native {ms['native']} ms, python {ms['python']} "
              f"ms, bytes equal (host clock, in turns)")
        if sum(ms["native"]) > sum(ms["python"]):
            fail(f"12d: the native {dtype} load is slower than the Python "
                 "reader, which render-hist would then take")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["render-hist", "--hist-file", str(path), "--dims",
                       str(n), str(n), str(n), "--bins", str(B), "--width",
                       "256", "--height", "256", "-o",
                       str(work / "native.ppm")])
    line = out.getvalue().strip().splitlines()[0]
    print(f"  render-hist: {line}")
    if rc != 0 or "(native loader)" not in line:
        fail("12d: render-hist did not take the native loader")


def phase_12e(dev, tf):
    """The viewer: ViewerServer on port 0 over a RenderPipeline on the card;
    each /frame's bytes equal the pipeline's uint8 render of the same
    parameters; the unrotated frames test ESS in K1 (their bits byte for
    byte the plain bitmap) and launch no bitmap kernel; the viewer's frame
    (the pipeline's uint8 render) timed."""
    import urllib.request

    import numpy as np
    import torch

    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.core.geometry import (
        inv_view_from_rotation_translation)
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig, TransferFunctionConfig)
    from vrdd_tpu_torch.viewer import ViewerServer

    S = 512
    print(f"[12e] viewer, Isabel's 50 x 50 x 10 x 32 raw blocks -> {S}^2")
    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    pipe = RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(hist).to(
        dev)))
    srv = ViewerServer(pipe, width=S, height=S, port=0)
    srv.start_background()
    frames = [dict(density="0.5", query="1"),
              dict(density="0.5", query="2", tscale="0.2", fmt="rgb"),
              dict(density="0.3", query="3"),
              dict(density="0.5", query="1", rx="30", ry="-20", fmt="rgb")]
    k1, bm = sk.sweep_preblended_planes, sk.ess_bitmap
    try:
        secs = []
        for q in frames:
            before = (k1.ess_launches, bm.launches)
            url = srv.address + "frame?" + "&".join(f"{k}={v}"
                                                   for k, v in q.items())
            with urllib.request.urlopen(url, timeout=120) as r:
                body, hdr = r.read(), dict(r.headers)
            secs.append(float(hdr["X-Render-Seconds"]))
            cfg = RenderConfig(
                camera=CameraConfig(width=S, height=S),
                tf=TransferFunctionConfig(offset=0.0,
                                          scale=float(q.get("tscale", 1.0))),
                density=float(q["density"]),
                query_method=QueryMethod(int(q["query"])))
            iv = inv_view_from_rotation_translation(
                float(q.get("rx", 0.0)), float(q.get("ry", 0.0)),
                (0.0, 0.0, -4.0))
            ch = 3 if q.get("fmt") == "rgb" else 4
            with torch.no_grad():
                ref = pipe.render(iv, cfg, "auto", as_uint8=True,
                                  channels=ch).cpu().numpy()
            tested, bitmaps = (k1.ess_launches - before[0],
                               bm.launches - before[1])
            print(f"  /frame {q}: {len(body)} bytes, renderer "
                  f"{pipe.resolve_renderer('auto', iv, cfg)}, "
                  f"X-Render-Seconds {hdr['X-Render-Seconds']}, lag "
                  f"{hdr['X-Frame-Lag']}; K1 launches testing ESS {tested}, "
                  f"bitmap kernel launches {bitmaps} (with the check's "
                  "render)")
            if bitmaps or ("rx" not in q and tested != 2):
                fail(f"12e: /frame {q} and its check must test ESS in K1 "
                     "and launch no bitmap kernel")
            if "rx" not in q:
                held_bits(lambda iv=iv, cfg=cfg, ch=ch: pipe.render(
                    iv, cfg, "auto", as_uint8=True, channels=ch),
                    f"12e /frame query {q['query']}")
            if body != ref.tobytes() or np.asarray(ref).max() == 0:
                fail(f"12e: /frame {q} differs from RenderPipeline's render "
                     "(or is black)")
        # the pipelined protocol: the second request answers with the first
        # frame, flagged; its repeat flushes to the second
        pipe_q = "frame?density=0.02&query=1&pipe=1&fmt=rgb"
        got = []
        for path in (pipe_q, pipe_q.replace("0.02", "0.05"),
                     pipe_q.replace("0.02", "0.05")):
            with urllib.request.urlopen(srv.address + path,
                                        timeout=120) as r:
                got.append((r.read(), r.headers["X-Frame-Lag"]))
        if not (got[1][0] == got[0][0] and got[1][1] == "1"
                and got[2][1] == "0" and got[2][0] != got[0][0]):
            fail("12e: the pipelined /frame protocol is broken")
        print(f"  pipelined: lag flags {[g[1] for g in got]}, median frame "
              f"{1e3 * sorted(secs)[len(secs) // 2]:.1f} ms (server clock)")
        cfg = RenderConfig(camera=CameraConfig(width=S, height=S),
                           density=0.5, query_method=QueryMethod(1))
        iv = inv_view_from_rotation_translation(0.0, 0.0, (0.0, 0.0, -4.0))
        frame_ms = host_ms(lambda: pipe.render(iv, cfg, "auto",
                                               as_uint8=True), 20)
        print(f"  the viewer's frame (query 1, uint8 render, host clock, "
              f"median of 20): {frame_ms:.3f} ms, testing ESS in K1")
    finally:
        srv.shutdown()


def phase_12(dev, card, smi, hist, tf, origin, n, B, W, counts, work):
    """precision='bf16', the live map, the native loader and the viewer
    (12a-12e); returns the kernel records."""
    t0 = time.perf_counter()
    records = phase_12a(dev, card, smi, hist, tf, origin, n, B, W, counts)
    records += phase_12b(dev, card, smi, hist, tf, origin, n, B, W, counts)
    records += phase_12c(dev, card, smi, hist, tf, origin, n, B, W)
    phase_12d(work)
    phase_12e(dev, tf)
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s")
    return records


# ---- phase 13a: the bench's own shapes against the plain versions ----------

def phase_13a(dev, card, smi, tf, n=1024, W=1024, n_hist=512, B=32):
    """The kernels at the shapes only the bench gives them (its ``big``
    section, JAX's defaults): K1 and the fwd+bwd (K4 + K5) of the n^3
    float32 volume (4 GiB) -> W^2 with one plane per layer, and K2's mean
    over the n_hist^3 x B bf16 volume, whose 2^32 elements are the first
    past 32-bit indexing. The bench's own calls on its own fixtures run
    once with the counters reset before and read after, and each output is
    held against its plain version on the same inputs (image tolerance;
    gradients GRAD_TOL); K4 and K5 also alone. Returns the kernel
    records."""
    import numpy as np
    import torch

    from vrdd_tpu_torch import bench
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv
    from vrdd_tpu_torch.march.slice import slice_render_image
    from vrdd_tpu_torch.utils.config import MarchConfig

    t0 = time.perf_counter()
    print(f"[13a] the bench's big shapes: {n}^3 f32 -> {W}^2 (K1, K4 + K5) "
          f"and {n_hist}^3 x {B} bf16 -> {W}^2 (K2 mean) on {card} ({smi})")
    k1, k2 = sk.sweep_preblended_planes, sk.pallas_hist_render
    counters = (k1, k2) + diff_counters()
    origin = torch.tensor(ORIGIN)
    lut = torch.as_tensor(tf, device=dev)
    vol = bench.blob_volume_device(n, device=dev)
    hist = blob_histogram_volume(n_hist, B, device=dev, dtype=torch.bfloat16)
    dw = torch.as_tensor((np.arange(B) + 0.5) / B, dtype=torch.float32,
                         device=dev)
    vg, lg = vol.detach().requires_grad_(), lut.clone().requires_grad_()

    # the main-path run: the bench's calls, once each
    for c in counters:
        c.launches = c.staged_launches = 0
    with torch.no_grad():
        img1 = sk.pallas_slice_render(vol, ORIGIN, lut, density=0.05,
                                      width=W, height=W, n_planes=n)
        img2 = k2(hist, dw, ORIGIN, lut, density=0.05, width=W, height=W)
    img = sv.pallas_slice_render_diff(vg, ORIGIN, lg, density=0.05, width=W,
                                      height=W, n_planes=n,
                                      wrt=("volume", "lut"))
    gv, gl = torch.autograd.grad(torch.mean((img - 0.25) ** 2), [vg, lg])
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    staged = {c.__name__: c.staged_launches for c in counters}
    print(f"  launches in the main-path run: {launches}, on the staged "
          f"path: {staged}")
    if launches != {"sweep_preblended_planes": 1, "pallas_hist_render": 1,
                    "sweep_fwd": 0, "sweep_fwd_ckpt": 1, "sweep_bwd": 1}:
        fail(f"13a: the bench's calls did not launch their kernels once "
             f"each: {launches}")

    # K2 mean over 2^32 bf16 elements
    k2_plain_ms, ref = timed_once(lambda: sk.hist_render_reference(
        hist, dw, origin, tf, 0.05, width=W, height=W))
    k2_err = compare(img2, ref, f"K2 mean {n_hist}^3 x {B} bf16")
    k2_ms = time_ms(lambda: k2(hist, dw, ORIGIN, lut, density=0.05,
                               width=W, height=W), TIMED_RUNS)
    zs, slopes, _ = sk._hist_geometry(n_hist, W, W, 2.0, MarchConfig())
    mean = sk.decode_with_rows(hist, dw, "linear")
    h_live, h_tex = live_samples(mean, zs, slopes, tf, 0.05, 0.0, 1.0, W, W,
                                 reverse=True)
    del hist, mean, img2, ref
    torch.cuda.empty_cache()
    bounds = {"pallas_hist_render": bound(
        h_tex * B * 2 + W * W * 16,
        h_live * (SAMPLE_OPS + decode_ops("linear", B)))}

    # K1 and the fwd+bwd over the 4 GiB volume
    k1_plain_ms, ref = timed_once(lambda: slice_render_image(
        vol, origin, W, W, tf, 0.05, n_planes=n))
    k1_err = compare(img1, ref, f"K1 {n}^3 f32")
    compare(img.detach(), ref, f"K4 image (the fwd+bwd) {n}^3 f32")
    del ref

    def plain():
        vp, lp = vol.detach().requires_grad_(), lut.clone().requires_grad_()
        imgp = slice_render_image(vp, origin, W, W, lp, 0.05, n_planes=n)
        lossp = torch.mean((imgp - 0.25) ** 2)
        return torch.autograd.grad(lossp, [vp, lp])

    fb_plain_ms, (gvp, glp) = timed_once(plain)
    rel_l2(gv, gvp, f"fwd+bwd {n}^3 f32 d_volume")
    rel_l2(gl, glp, f"fwd+bwd {n}^3 f32 d_lut")
    print(f"  fwd+bwd plain {fb_plain_ms:.1f} ms")
    del vg, lg, img, gv, gl, gvp, glp
    torch.cuda.empty_cache()
    k1_ms = time_ms(lambda: sk.pallas_slice_render(
        vol, ORIGIN, lut, density=0.05, width=W, height=W, n_planes=n),
        TIMED_RUNS)

    # K4 and K5 alone, at the fwd+bwd's configuration
    cfg = sv.render_config(vol.shape, origin, width=W, height=W)
    args = (cfg, vol, None, lut, torch.tensor(0.05, device=dev),
            torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev))
    img4, tck = sv.sweep_fwd_ckpt(*args)
    k4_plain_ms, (ref4, tck_ref) = timed_once(
        lambda: sv.sweep_fwd_ckpt_reference(*args))
    k4_err = compare(img4, ref4, f"K4 image {n}^3 f32")
    compare(tck[..., None], tck_ref[..., None], f"K4 checkpoints {n}^3 f32")
    del ref4, tck_ref
    k4_ms = time_ms(lambda: sv.sweep_fwd_ckpt(*args), TIMED_RUNS)
    g = (2.0 / img4.numel()) * (img4 - 0.25)
    flags = (True, True, False)
    d, small, *_ = sv.sweep_bwd(*args, g, tck, *flags)
    k5_plain_ms, (d_r, small_r, *_) = timed_once(
        lambda: sv.sweep_bwd_reference(*args, g, *flags))
    rel_l2(d, d_r, f"K5 d_planes {n}^3 f32")
    rel_l2(small, small_r, f"K5 d_lut {n}^3 f32")
    k5_err = float((d - d_r).abs().max())
    del d, small, d_r, small_r
    k5_ms = time_ms(lambda: sv.sweep_bwd(*args, g, tck, *flags), TIMED_RUNS)
    n_live, n_tex = live_samples(vol, cfg.zs, cfg.slopes, tf, 0.05, 0.0, 1.0,
                                 W, W, reverse=True)
    img_b, tck_b, vol_b = W * W * 16, cfg.n_chunks * W * W * 4, vol.numel() * 4
    bounds.update({
        "sweep_preblended_planes": bound(n_tex * 4 + img_b,
                                         n_live * SAMPLE_OPS),
        "sweep_fwd_ckpt": bound(n_tex * 4 + img_b + tck_b,
                                n_live * SAMPLE_OPS),
        "sweep_bwd": bound(n_tex * 4 + tck_b + img_b + vol_b,
                           n_live * K5_SAMPLE_OPS),
    })
    print(f"  evaluated samples {n_live} ({n_live / (W * W * n):.4f} of rays "
          f"x planes), texels read {n_tex}; K2: {h_live} samples, {h_tex} "
          "voxels")
    del vol, img1, img4, tck, g
    torch.cuda.empty_cache()
    records = []
    for name, shape, src, replaces, k_ms, p_ms, e in (
        ("sweep_preblended_planes", f"{n}^3 f32", "slice_sweep.cu",
         "slice_kernel.py:1351", k1_ms, k1_plain_ms, k1_err),
        ("pallas_hist_render", f"linear,{n_hist}^3x{B} bf16",
         "slice_sweep.cu", "slice_kernel.py:1595", k2_ms, k2_plain_ms,
         k2_err),
        ("sweep_fwd_ckpt", f"{n}^3 f32", "slice_sweep.cu", "slice_vjp.py:714",
         k4_ms, k4_plain_ms, k4_err),
        ("sweep_bwd", f"{n}^3 f32", "slice_vjp.cu", "slice_vjp.py:787",
         k5_ms, k5_plain_ms, k5_err),
    ):
        bd = bounds[name]
        print(f"  {name}[{shape}]: {k_ms:.3f} ms, plain {p_ms:.1f} ms, bound "
              f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}), max_abs_err "
              f"{e:.3e}")
        records.append({
            "name": f"{name}[{shape}]", "route": "cuda",
            "source": f"vrdd_tpu_torch/csrc/{src}",
            "replaces": f"vrdd_tpu/pallas/{replaces}",
            "launches": launches[name], "staged_launches": staged[name],
            "max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **bd,
        })
    print(f"  phase 13a: {time.perf_counter() - t0:.1f} s")
    return records


# ---- phase 13: the bench ---------------------------------------------------

BENCH_TIMEOUT_S = 600
#: the bench's in-kernel mean fwd+bwd (host clock, 20 calls back to back)
#: against phase 6's (CUDA events around one call, median of 10)
BENCH_RATE_TOL = 0.25
BENCH_SOL_LIMIT = 1.05
#: keys of the bench's record that may be null: a world of one process
#: measures no scaling efficiency
BENCH_NULLABLE = {"scaling_efficiency", "scaling_fwdbwd_efficiency"}


def _numbers(key, v):
    """(key, number) of every number in a record value, lists and dicts
    walked."""
    if isinstance(v, dict):
        for k, x in v.items():
            yield from _numbers(f"{key}.{k}", x)
    elif isinstance(v, list):
        for i, x in enumerate(v):
            yield from _numbers(f"{key}[{i}]", x)
    elif isinstance(v, (int, float)) and not isinstance(v, bool):
        yield key, v


def phase_13(card, smi, ref_mrays):
    """``python -m vrdd_tpu_torch.cli bench --full`` as a subprocess, at its
    full sizes, held to its contract and to phase 6's in-kernel mean rate
    ``ref_mrays`` (Mrays/s)."""
    import os

    import torch

    from vrdd_tpu_torch.bench import SECTIONS

    torch.cuda.empty_cache()
    argv = [sys.executable, "-m", "vrdd_tpu_torch.cli", "bench",
            "--sections", SECTIONS, "--full"]
    print(f"[13] {' '.join(argv[1:])} on {card} ({smi})")
    env = {k: v for k, v in os.environ.items()
           if k != "VRDD_BENCH_SECTIONS"}
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S, env=env)
    for line in proc.stderr.splitlines():
        print(f"  {line}")
    lines = proc.stdout.strip().splitlines()
    print(f"  rc {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or len(lines) < 2:
        fail(f"13: the bench exited {proc.returncode}")
    last = lines[-1]
    print(f"  last line ({len(last)} characters): {last}")
    if len(last) >= 1500:
        fail(f"13: the bench's last line has {len(last)} characters")
    summary, record = json.loads(last), json.loads(lines[-2])
    for key in ("value", "hist512_fwdbwd_route", "scalar512_fwdbwd_mrays",
                "gaussian_decode_fwdbwd_mrays", "hist16_decode_fwdbwd_mrays"):
        if summary.get(key) is None:
            fail(f"13: the last line has no {key}")
    nulls = sorted(k for k, v in record.items()
                   if v is None and k not in BENCH_NULLABLE)
    bad = [name for k, v in record.items() for name, x in _numbers(k, v)
           if not math.isfinite(x)]
    if nulls or bad:
        fail(f"13: null {nulls}, not finite {bad}")
    shares = {k: v for k, v in record.items()
              if k.startswith("roofline_") and "sol_frac" in k}
    print(f"  roofline shares (H100 SXM peaks, {smi}): {shares}")
    if not shares or max(shares.values()) > BENCH_SOL_LIMIT:
        fail(f"13: roofline shares {shares} (limit {BENCH_SOL_LIMIT})")
    launches = record["launches"]
    print(f"  kernel launches in the bench: {launches}")
    if not all(launches.values()):
        fail(f"13: a kernel of the bench's path did not launch: {launches}")
    got = record["hist512_fwdbwd_inkernel_mrays"]
    host_ms, ev_ms, busy_ms = (record[f"hist512_fwdbwd_inkernel_{k}"]
                               for k in ("ms", "device_ms", "busy_ms"))
    rel = got / ref_mrays - 1.0
    print(f"  in-kernel mean fwd+bwd: bench {got:.2f} Mrays/s ({host_ms:.3f} "
          f"ms host, {ev_ms:.3f} ms CUDA events, kernels {busy_ms:.3f} ms: "
          f"host share {1.0 - busy_ms / host_ms:.4f}) against phase 6's "
          f"{ref_mrays:.2f} Mrays/s ({1024 * 1024 / ref_mrays / 1e3:.3f} ms, "
          f"CUDA events): {rel:+.2%}")
    if abs(rel) > BENCH_RATE_TOL:
        fail(f"13: the bench's in-kernel mean rate is {rel:+.2%} off phase "
             f"6's (limit {BENCH_RATE_TOL:.0%})")
    return record


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

    records, counts = [], {}
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
        counts[mode] = (n_live, n_texels)  # phase 12's bounds
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
    recs, mrays6, chain_launches = phase_6(dev, card, smi, hist, tf, origin,
                                           n, B, W)
    records += recs
    records += phase_6b(dev, card, smi, hist, n, B, chain_launches)

    # ---- 12. precision='bf16', K4's live map, the native loader, the viewer
    work.mkdir(parents=True)
    records += phase_12(dev, card, smi, hist, tf, origin, n, B, W, counts,
                        work)
    del hist
    torch.cuda.empty_cache()

    # ---- 7. the render path
    records += phase_7(dev, card, smi, tf, work)

    # ---- 8. BASELINE config 3 (fit-voxels) and rotated views
    records += phase_8(dev, card, smi, tf, work)

    # ---- 9. fractal and flexible-block render at full size
    records += phase_9(dev, card, smi, tf, work)

    # ---- 10. fit-tf and encode
    records += phase_10(dev, card, smi, work)

    # ---- 11. the distributed sweep (parallel/)
    records += phase_11(dev, card, smi, tf, work)
    shutil.rmtree(work)

    # ---- 13a. the bench's own shapes against the plain versions
    records += phase_13a(dev, card, smi, tf)

    # ---- 13. the bench
    phase_13(card, smi, mrays6["mean,inkernel"][0])

    # ---- result
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker-11f"]:
        sys.path.insert(0, str(ROOT))
        worker_11f(json.loads(sys.argv[2]))
    else:
        sys.exit(main())
