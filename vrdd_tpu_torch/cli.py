"""Command-line interface of the port (counterpart of ``vrdd_tpu/cli.py``).

Subcommands ported so far:

- ``render``       render a dataset (a raw block-histogram file, or the
                   seeded synthetic raw, fractal and flexible-block volumes)
                   through ``RenderPipeline`` for queries 0-9 with the
                   ``scan``, ``slice``, ``pallas``,
                   ``shearwarp`` (rotated views) or ``auto`` renderer, to
                   PPM/NPY; ``--file ref.ppm`` is the
                   benchmark + golden mode of the reference's ``-file`` flag
                   (warm-up, ``--iters`` timed renders, the MTexels/s line,
                   PPM compare with exit code 1 on a fail; ``--file none``
                   skips the compare).
- ``encode``       raw scalar volume -> block-histogram file (the
                   reference's raw blob), byte for byte JAX's.
- ``fit-tf``       fit the transfer-function LUT to the render of the raw
                   mean channel with Adam (``pallas_slice_render_diff``
                   with ``wrt=('lut',)``: K3, K4, K5); JAX's checkpoint
                   layout, ``--resume``.
- ``render-hist``  render straight from a block-histogram file: bins-major
                   load (the native C++ reader of ``io/native.py`` where
                   it builds, else the Python one), the in-kernel decode sweep (``pallas_hist_render``
                   through ``HistRenderer``; rotated views through
                   ``parallel/sweep.py distributed_shearwarp_hist_render``),
                   PPM out.
- ``fit-hist``     fit a per-voxel histogram volume to renders of a decoded
                   statistic, differentiating through
                   ``pallas_hist_render_diff`` (K4 forward, K5 backward) with
                   Adam; writes an ``.npz`` checkpoint.
- ``fit-voxels``   fit a per-voxel Gaussian ``(mu, sigma)`` volume (BASELINE
                   config 3) to multi-view renders of its mean and variance:
                   unrotated views through the fused sweep (or, with
                   ``--streamed``, the seeded streamed decode), rotated views
                   through the shear-warp sweep; Adam; ``.npz`` checkpoint.
- ``view``         the interactive browser viewer (``viewer.py``): page and
                   frames of ``RenderPipeline`` over HTTP.
- ``bench``        the benchmark (``vrdd_tpu_torch/bench.py``): every
                   section of the root ``bench.py`` through the kernels,
                   one JSON record per measurement, the H100's roofline.

``--device cuda`` (the default) runs the CUDA kernels and raises when no GPU
is present; ``--device cpu`` runs the plain torch versions. Run as
``python -m vrdd_tpu_torch.cli render --file none --query 9``,
``python -m vrdd_tpu_torch.cli fit-tf --iters 5``, ``python -m
vrdd_tpu_torch.cli encode -o h.bin``,
``python -m vrdd_tpu_torch.cli render-hist --hist-file F --dims NZ NY NX
...``, ``python -m vrdd_tpu_torch.cli fit-hist --iters 50`` or ``python -m
vrdd_tpu_torch.cli fit-voxels --size 256 --image 512`` or ``python -m
vrdd_tpu_torch.cli view --port 8412`` or ``python -m vrdd_tpu_torch.cli
bench``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (use --device cpu for "
            "the plain torch version)"
        )
    return device


def _add_render_params(p: argparse.ArgumentParser) -> None:
    """The render flags of ``vrdd_tpu/cli.py`` (``_add_render_params``)."""
    p.add_argument("--query", type=int, default=1,
                   help="query method 0-9: 1/2/3 raw, 4/5/6 fractal "
                   "mean/variance/entropy, 7 interpolated mean, 8/9/0 "
                   "flexible-block entropy/mean/variance")
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--brightness", type=float, default=1.0)
    p.add_argument("--tf-offset", type=float, default=0.0)
    p.add_argument("--tf-scale", type=float, default=1.0)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--rot-x", type=float, default=0.0)
    p.add_argument("--rot-y", type=float, default=0.0)
    p.add_argument("--translate-z", type=float, default=-4.0)
    p.add_argument("--tf-checkpoint", help="load fitted TF LUT from checkpoint")
    p.add_argument(
        "--flex-normalize", action="store_true",
        help="min-max map flexible-block mean/variance onto [0,1] for the TF "
        "(the reference leaves them in raw bin-domain units)",
    )


def _on_device(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _raw_volume(args, device):
    """The raw family on ``device``: ``--volume <file>`` reads a raw
    block-histogram blob, ``--volume synthetic`` makes
    ``random_histogram_volume`` from ``--seed``."""
    from vrdd_tpu_torch.io import formats
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume

    bx, by, bz = args.blocks
    if args.volume and args.volume != "synthetic":
        hist = formats.read_raw_histograms(
            args.volume, bx * by * bz, args.bins
        ).reshape(bz, by, bx, args.bins)
    else:
        hist = random_histogram_volume((bz, by, bx), n_bins=args.bins,
                                       seed=args.seed)
    return RawHistogramVolume(_on_device(hist, device))


def _build_pipeline(args, device):
    """``RenderPipeline`` of ``vrdd_tpu/cli.py`` (``_build_pipeline``) on
    ``device``: the raw family (:func:`_raw_volume`; the only one for
    ``--volume <file>``), and for ``--volume synthetic``, as JAX does, the
    fractal family (``synthetic_fractal_volume`` from ``--seed + 1``) and
    the flexible blocks (``from_raw`` of ``synthetic_flexible_dataset``'s
    16^3 raw volume from ``--seed + 2``, blocks of ``--flex-block``, 256 as
    the top of the bin range), min-max mapped by ``--flex-normalize``."""
    from vrdd_tpu_torch.io.synthetic import (
        synthetic_flexible_dataset,
        synthetic_fractal_volume,
    )
    from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import FractalHistogramVolume

    tf_lut = None
    if getattr(args, "tf_checkpoint", None):
        from vrdd_tpu_torch.io.checkpoint import load_checkpoint

        tf_lut = np.asarray(load_checkpoint(args.tf_checkpoint)["tf_lut"])

    raw = _raw_volume(args, device)
    if args.volume and args.volume != "synthetic":
        return RenderPipeline(raw=raw, tf_lut=tf_lut)

    bx, by, bz = args.blocks
    t, cb, eb, ev, _ = synthetic_fractal_volume(
        (bz, by, bx), n_bins=args.bins, seed=args.seed + 1)
    ds = synthetic_flexible_dataset(dims=(16, 16, 16), seed=args.seed + 2)
    flexible = FlexibleBlockVolume.from_raw(
        _on_device(ds["raw"], device), block_size=args.flex_block, vmax=256.0)
    if getattr(args, "flex_normalize", False):
        # min-max map the raw-unit mean/variance channels onto the TF domain
        # (the normalization the reference left as a TODO; queries 9/0 are
        # otherwise black until transferScale is wound down manually)
        flexible = flexible.normalized()
    return RenderPipeline(
        raw=raw,
        fractal=FractalHistogramVolume(
            *(_on_device(a, device) for a in (cb, eb, ev, t))),
        flexible=flexible,
        tf_lut=tf_lut,
    )


def cmd_render(args) -> int:
    """Render a dataset through ``RenderPipeline`` (``vrdd_tpu/cli.py``
    ``cmd_render``); ``--file`` is the benchmark + golden-test mode."""
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.core.image import rgba_to_uint8
    from vrdd_tpu_torch.io import formats
    from vrdd_tpu_torch.utils.config import (
        CameraConfig,
        QueryMethod,
        RenderConfig,
        TransferFunctionConfig,
    )

    device = _device(args.device)
    pipeline = _build_pipeline(args, device)
    config = RenderConfig(
        camera=CameraConfig(width=args.width, height=args.height),
        tf=TransferFunctionConfig(offset=args.tf_offset, scale=args.tf_scale),
        density=args.density,
        brightness=args.brightness,
        query_method=QueryMethod(args.query),
    )
    inv_view = inv_view_from_rotation_translation(
        args.rot_x, args.rot_y, (0.0, 0.0, args.translate_z)
    )
    renderer = pipeline.resolve_renderer(args.renderer, inv_view, config)

    if args.file:
        # benchmark + golden test (runSingleTest semantics)
        img = pipeline.render(inv_view, config, renderer)  # warm-up
        img.cpu()
        n_iter = args.iters
        t0 = time.perf_counter()
        for _ in range(n_iter):
            img = pipeline.render(inv_view, config, renderer)
        img.cpu()  # waits for the device
        avg = (time.perf_counter() - t0) / n_iter
        print(
            f"vrdd_tpu_torch render ({renderer}, {device}), Throughput = "
            f"{args.width * args.height / avg / 1e6:.4f} MTexels/s, Time = "
            f"{avg:.5f} s, Size = {args.width * args.height} Texels"
        )
        out = rgba_to_uint8(img).cpu().numpy()
        formats.write_ppm(args.output or "volume.ppm", out)
        if args.file == "none":
            return 0
        ref = formats.read_ppm(args.file)
        ok, frac = formats.compare_ppm(out[..., :3], ref, args.epsilon,
                                       args.threshold)
        print(f"golden compare: outlier fraction {frac:.4f} -> "
              f"{'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1

    img = pipeline.render(inv_view, config, renderer)
    out_path = args.output or "volume.ppm"
    if out_path.endswith(".npy"):
        np.save(out_path, img.cpu().numpy())
    else:
        formats.write_ppm(out_path, rgba_to_uint8(img).cpu().numpy())
    for k, v in pipeline.timings.items():
        print(f"{k}: {v * 1e3:.3f} ms", file=sys.stderr)
    print(f"wrote {out_path} ({renderer}, {device})")
    return 0


def cmd_encode(args) -> int:
    """Offline data reduction (``vrdd_tpu/cli.py`` cmd_encode): a raw scalar
    volume (``--input synthetic``: ``gaussian_blob_volume`` from ``--seed``,
    made with numpy as JAX makes it; or a float32 file) -> per-block
    normalized histograms, binned on ``--device``, written as the raw
    block-histogram blob. The file is byte for byte JAX's."""
    from vrdd_tpu_torch.io import formats
    from vrdd_tpu_torch.io.synthetic import (
        block_histograms_from_scalar,
        gaussian_blob_volume,
    )

    device = _device(args.device)
    if args.input == "synthetic":
        vol = gaussian_blob_volume(tuple(args.dims[::-1]), seed=args.seed)
    else:
        vol = np.fromfile(args.input, dtype=np.float32).reshape(args.dims[::-1])
    hist = block_histograms_from_scalar(
        torch.from_numpy(vol).to(device), tuple(args.block[::-1]),
        n_bins=args.bins, vmax=float(vol.max()) + 1e-6,
    ).cpu().numpy()
    formats.write_raw_histograms(args.output, hist.reshape(-1, args.bins))
    print(
        f"encoded {vol.shape} -> {hist.shape[:3][::-1]} blocks x {args.bins} "
        f"bins -> {args.output} (on {device})"
    )
    return 0


def fit_tf_problem(stats: torch.Tensor, size: int, steps: int, renderer: str):
    """The ``fit-tf`` loss (``vrdd_tpu/cli.py`` cmd_fit_tf): returns
    ``(loss_fn, renderer)``.

    The mean channel of the raw stats volume ``stats`` is rendered from the
    benchmark camera to ``size``^2 with the default LUT as the target;
    ``loss_fn(lut)`` is the mean squared image error of the render with
    ``lut``. ``renderer`` 'pallas' renders through
    ``pallas_slice_render_diff(wrt=('lut',))`` (K3 for the target, K4 and
    K5 per step; the plain versions on the CPU), 'slice' through the plain
    sweep, 'scan' through the ray marcher (``steps`` steps for the fit, the
    default march for the target, as in JAX); 'auto' is 'pallas' on the card
    and 'slice' on the CPU. On the card a shape the kernels cannot take
    raises."""
    from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.kernels.slice_vjp import (
        pallas_diff_supported,
        pallas_slice_render_diff,
    )
    from vrdd_tpu_torch.march.scan import render_image
    from vrdd_tpu_torch.march.slice import slice_render_image
    from vrdd_tpu_torch.models.renderer import stats_sample_fn
    from vrdd_tpu_torch.utils.config import MarchConfig

    device = stats.device
    inv_view = default_benchmark_inv_view()
    march = MarchConfig(max_steps=steps, tstep=2.0 / steps)
    W = H = size
    tf0 = torch.as_tensor(default_transfer_function(), device=device)
    n_planes = max(64, 2 * stats.shape[0])
    if renderer == "auto":
        renderer = "pallas" if device.type == "cuda" else "slice"
    if (renderer == "pallas" and device.type == "cuda"
            and not pallas_diff_supported(tuple(stats.shape[:3]), W, H,
                                          n_planes, n_lut=len(tf0))):
        raise ValueError(
            f"fit-tf: the CUDA kernels cannot take volume "
            f"{tuple(stats.shape[:3])} -> {W}x{H}")

    if renderer in ("slice", "pallas"):
        vol = stats[..., 0].contiguous()  # mean channel, query method 1
        origin = tuple(float(v) for v in inv_view[:, 3])

        def fwd(lut):
            if renderer == "pallas":
                # the fit trains only the LUT: prune the volume/param
                # cotangent paths in the fused backward
                return pallas_slice_render_diff(
                    vol, origin, lut, width=W, height=H, n_planes=n_planes,
                    wrt=("lut",))
            return slice_render_image(vol, origin, W, H, lut,
                                      n_planes=n_planes)

        with torch.no_grad():
            target = fwd(tf0)

        def loss_fn(lut):
            return torch.mean((fwd(lut) - target) ** 2)
    elif renderer == "scan":
        with torch.no_grad():
            target = render_image(stats_sample_fn(stats, 0), inv_view, W, H,
                                  tf0, device=device)

        def loss_fn(lut):
            img = render_image(stats_sample_fn(stats, 0), inv_view, W, H, lut,
                               march=march, device=device)
            return torch.mean((img - target) ** 2)
    else:
        raise ValueError(f"unknown renderer {renderer!r}")
    return loss_fn, renderer


def cmd_fit_tf(args) -> int:
    """Differentiable transfer-function fitting (``vrdd_tpu/cli.py``
    cmd_fit_tf): Adam on a 9-entry grayscale LUT against the render with
    the default LUT (:func:`fit_tf_problem`). The checkpoint keeps JAX's
    layout: the leaves of ``{"opt_state": ((count, mu, nu), ()), "step":
    ..., "tf_lut": ...}`` in JAX's order (optax's Adam state: step count,
    first and second moments). ``--resume`` reads such a file, written by
    either package, and goes on from its step."""
    from vrdd_tpu_torch.core.transfer import grayscale_ramp
    from vrdd_tpu_torch.io.checkpoint import load_leaves, save_checkpoint
    from vrdd_tpu_torch.models.volumes import compute_stats_volume

    device = _device(args.device)
    # the fit reads only the raw family's stats
    stats = compute_stats_volume(_raw_volume(args, device))
    loss_fn, renderer = fit_tf_problem(stats, args.size, args.steps,
                                       args.renderer)
    print(f"fit-tf renderer: {renderer} on {device}")

    start = 0
    if args.resume:
        count, mu, nu, step, lut0 = load_leaves(args.resume)
        start = int(step)
        print(f"resumed from {args.resume} at step {start}")
    else:
        lut0 = grayscale_ramp(9)
    lut = torch.nn.Parameter(torch.as_tensor(np.asarray(lut0, np.float32),
                                             device=device))
    opt = torch.optim.Adam([lut], lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    if args.resume:
        opt.state[lut] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(np.asarray(mu, np.float32),
                                       device=device),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu, np.float32),
                                          device=device),
        }
    loss = float("nan")
    for i in range(start, start + args.iters):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss_t = loss_fn(lut)
        loss_t.backward()
        opt.step()
        loss = float(loss_t.detach())
        ms = 1e3 * (time.perf_counter() - t0)
        if (i + 1) % max(1, args.iters // 10) == 0:
            print(f"step {i + 1}: loss {loss:.6f} ({ms:.3f} ms)")
    state = opt.state[lut]
    count = int(state["step"]) if state else 0
    save_checkpoint(args.checkpoint, {
        "opt_state": ((np.asarray(count, np.int32),
                       state.get("exp_avg", torch.zeros_like(lut)),
                       state.get("exp_avg_sq", torch.zeros_like(lut))), ()),
        "step": np.asarray(start + args.iters),
        "tf_lut": lut.detach(),
    })
    print(f"saved {args.checkpoint} (final loss {loss:.6f})")
    return 0


def fit_hist_problem(size: int, image: int, bins: int, stat: str, seed: int,
                     route: str, device):
    """The ``fit-hist`` inverse problem (``vrdd_tpu/cli.py`` cmd_fit_hist):
    returns ``(loss_fn, to_hist, logits_true)``.

    Ground truth: softmax histograms (over bins) around a Gaussian-blob
    mean, made with numpy from ``seed``; the target is their render.
    ``loss_fn(logits)`` is the mean squared image error of
    ``to_hist(logits)``, rendered through ``pallas_hist_render_diff``
    (``wrt=('hist',)``) on an unrotated camera at (0, 0, 4), a 9-entry
    grayscale LUT, and the TF window JAX picks per statistic."""
    from vrdd_tpu_torch.core.transfer import grayscale_ramp
    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
    from vrdd_tpu_torch.kernels.slice_kernel import decode_weight_rows
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_hist_render_diff

    n, W, B = size, image, bins
    lut = torch.as_tensor(grayscale_ramp(9), device=device)
    origin = (0.0, 0.0, 4.0)
    rows, mode = decode_weight_rows(stat, B, family="unit")
    # window the TF so each statistic lands mid-ramp with live gradients
    toff, tscl = {"mean": (0.0, 1.0), "var": (0.0, 12.0),
                  "entropy": (0.55, 2.0)}[stat]
    centers = ((np.arange(B) + 0.5) / B).astype(np.float32)
    base = gaussian_blob_volume((n, n, n), seed=seed)
    logits_true = -((centers[:, None, None, None] - base[None]) ** 2) / 0.02

    def to_hist(logits):  # (B, Z, Y, X) logits -> bins-major simplex
        return torch.softmax(logits, dim=0).permute(1, 0, 2, 3).contiguous()

    def render(hist_bm):
        return pallas_hist_render_diff(
            hist_bm, rows, origin, lut, width=W, height=W,
            transfer_offset=toff, transfer_scale=tscl, wrt=("hist",),
            stat=mode, route=route,
        )

    with torch.no_grad():
        target = render(to_hist(torch.as_tensor(logits_true, device=device)))

    def loss_fn(logits):
        return torch.mean((render(to_hist(logits)) - target) ** 2)

    return loss_fn, to_hist, logits_true


def cmd_fit_hist(args) -> int:
    """BASELINE config 4: recover a per-voxel histogram volume from the
    render of a decoded statistic, through the differentiable in-kernel
    decode. Histograms are softmax-parameterized so they stay on the
    simplex; the logits train with Adam from a small seeded random init
    (the uniform histogram is a saddle of the entropy statistic)."""
    from vrdd_tpu_torch.io.checkpoint import save_checkpoint

    device = _device(args.device)
    n, B = args.size, args.bins
    loss_fn, to_hist, logits_true = fit_hist_problem(
        n, args.image, B, args.stat, args.seed, args.route, device)
    print(f"fit-hist ({args.stat}, route {args.route}) on {device}")
    gen = torch.Generator().manual_seed(args.seed + 1)
    logits = torch.nn.Parameter(
        (0.05 * torch.randn((B, n, n, n), generator=gen)).to(device))
    opt = torch.optim.Adam([logits], lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    loss = float("nan")
    for i in range(args.iters):
        opt.zero_grad(set_to_none=True)
        loss_t = loss_fn(logits)
        loss_t.backward()
        opt.step()
        loss = float(loss_t.detach())
        if (i + 1) % max(1, args.iters // 10) == 0:
            print(f"step {i + 1}: loss {loss:.6f}")
    with torch.no_grad():
        hist = to_hist(logits).cpu().numpy()
    centers = ((np.arange(B) + 0.5) / B).astype(np.float32)
    e = np.exp(logits_true - logits_true.max(axis=0, keepdims=True))
    hist_true = e / e.sum(axis=0, keepdims=True)
    mean_err = float(np.sqrt(np.mean(
        (np.einsum("zbyx,b->zyx", hist, centers)
         - np.einsum("bzyx,b->zyx", hist_true, centers)) ** 2)))
    save_checkpoint(args.checkpoint, {"hist": hist, "loss": np.float32(loss)})
    print(f"saved {args.checkpoint} (final loss {loss:.6f}, "
          f"decoded-mean RMSE {mean_err:.4f})")
    return 0


def fit_voxels_problem(size: int, image: int, views: int, view_angle: float,
                       seed: int, renderer: str, streamed: bool, device):
    """The ``fit-voxels`` inverse problem (``vrdd_tpu/cli.py``
    cmd_fit_voxels), built by ``models/voxel_fit.py``: returns ``(loss_fn,
    mu_true, renderer)``.

    Ground truth: a Gaussian-blob ``mu`` and a spatially varying ``sigma =
    0.05 + 0.15 blob``, made from ``seed`` (``voxel_fit.blob_truth``). Up to
    five views (0, then +-``view_angle`` about x and y); each renders the
    decoded mean (TF scale 1) and variance (TF scale ``1 / max(sigma)^2``)
    through a 9-entry grayscale LUT, ``2 size`` planes. ``renderer``
    'pallas' takes the fused kernels (their plain versions on the CPU),
    'slice' the plain torch sweeps, 'auto' 'pallas' on the card and 'slice'
    on the CPU. ``streamed`` renders the unrotated view by the seeded
    streamed decode (``march/streaming.py``). ``loss_fn(mu, log_sigma)`` is
    the mean over views of the two channels' mean squared image errors
    against the targets."""
    from vrdd_tpu_torch.models import voxel_fit

    truth = voxel_fit.blob_truth(size, seed, device)
    fit = voxel_fit.fit_problem(truth, views=views, view_angle=view_angle,
                                image=image, renderer=renderer, device=device,
                                streamed=streamed)

    def loss_fn(mu, log_sigma):
        return fit.loss(mu, log_sigma)[0]

    return loss_fn, truth[0], fit.renderer


def cmd_fit_voxels(args) -> int:
    """BASELINE config 3: per-voxel Gaussian (mu, sigma) recovered from
    multi-view renders through the differentiable renderer
    (:func:`fit_voxels_problem`), with Adam over ``(mu, log sigma)`` from
    JAX's start (0 and log 0.1), a step ``voxel_fit.train_step``. Prints the
    loss and the step time (host clock; the loss readback waits for the
    device) of each reported step, and the peak device memory on the
    card."""
    from vrdd_tpu_torch.io.checkpoint import save_checkpoint
    from vrdd_tpu_torch.models import voxel_fit

    device = _device(args.device)
    n = args.size
    mu_true, sigma_true = voxel_fit.blob_truth(n, args.seed, device)
    fit = voxel_fit.fit_problem(
        (mu_true, sigma_true), views=args.views, view_angle=args.view_angle,
        image=args.image, renderer=args.renderer, device=device,
        streamed=args.streamed)
    print(f"fit-voxels renderer: {fit.renderer}"
          f"{', streamed' if args.streamed else ''} on {device}")
    mu = torch.zeros((n, n, n), dtype=torch.float32, device=device,
                     requires_grad=True)
    log_sigma = torch.full((n, n, n), float(np.log(np.float32(0.1))),
                           dtype=torch.float32, device=device,
                           requires_grad=True)
    opt = torch.optim.Adam([mu, log_sigma], lr=args.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    loss = float("nan")
    for i in range(args.iters):
        t0 = time.perf_counter()
        loss_t, _ = voxel_fit.train_step(fit, opt, mu, log_sigma)
        loss = float(loss_t.detach())
        ms = 1e3 * (time.perf_counter() - t0)
        if (i + 1) % max(1, args.iters // 10) == 0:
            print(f"step {i + 1}: loss {loss:.9g} ({ms:.3f} ms)")
    if device.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} GiB")
    with torch.no_grad():
        mu_np = mu.cpu().numpy()
        sigma_np = torch.exp(log_sigma).cpu().numpy()
        err = float(torch.sqrt(torch.mean((mu - mu_true) ** 2)))
    save_checkpoint(args.checkpoint,
                    {"mu": mu_np, "sigma": sigma_np, "loss": np.float32(loss)})
    print(f"saved {args.checkpoint} (final loss {loss:.6f}, mu RMSE "
          f"{err:.4f} over {len(fit.views)} views)")
    return 0


def cmd_render_hist(args) -> int:
    """Histogram file -> decode statistic -> sweep -> PPM, camera at ``(0,
    0, -translate_z)`` rotated by ``--rot-x``/``--rot-y`` as ``vrdd_tpu.cli``
    places it. Rotated views on the card go through
    ``distributed_shearwarp_hist_render`` on a one-shard mesh (the in-kernel
    decode on the shear-warp m-grid, oversample 1); on the CPU through JAX's
    non-TPU branch, the materialized decode and the plain shear-warp."""
    from vrdd_tpu_torch.core.image import rgba_to_uint8
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.io import formats, native
    from vrdd_tpu_torch.kernels.slice_kernel import decode_weight_rows
    from vrdd_tpu_torch.models.hist_renderer import HistRenderer

    device = _device(args.device)
    nz, ny, nx = args.dims
    B = args.bins
    # the native reader transposes and rounds during the read, as JAX's CLI
    # reads (vrdd_tpu/cli.py:559-577); the Python reader where it cannot
    # be built
    use_native = native.available()
    loader = (native.read_histograms_bins_major if use_native
              else formats.read_histograms_bins_major)
    hist = loader(args.hist_file, (nz, ny, nx), B, dtype=args.dtype).to(
        device)
    print(f"loaded {args.hist_file}: {tuple(hist.shape)} {hist.dtype} "
          f"on {device} ({'native' if use_native else 'python'} loader)")
    # decode statistic (reference queries 1/2/3); 'unit' family = centers
    # on [0, 1], the natural range for standalone histogram files
    rows, mode = decode_weight_rows(args.stat, B, family="unit")
    tf = default_transfer_function()
    W, H = args.width, args.height
    on_card = device.type == "cuda"
    if args.rot_x != 0.0 or args.rot_y != 0.0:
        from vrdd_tpu_torch.core.geometry import (
            inv_view_from_rotation_translation)

        iv = inv_view_from_rotation_translation(
            args.rot_x, args.rot_y, (0.0, 0.0, args.translate_z))
        if on_card:
            from vrdd_tpu_torch.parallel.mesh import make_mesh
            from vrdd_tpu_torch.parallel.sweep import (
                distributed_shearwarp_hist_render, shearwarp_hist_supported)

            if not shearwarp_hist_supported((nz, B, ny, nx), iv, W, H,
                                            oversample=1.0):
                raise ValueError(
                    "the rotated in-kernel decode cannot take this view "
                    "(d_z changes sign, or the decode rows and LUT outgrow "
                    "the kernels' shared memory)")
            img = distributed_shearwarp_hist_render(
                hist, rows, iv, W, H, tf, density=args.density,
                transfer_scale=args.tf_scale,
                mesh=make_mesh(1, 1, devices=[device]), stat=mode,
                oversample=1.0)
            path = (f"rotated in-kernel fused decode ({args.stat}), "
                    "distributed_shearwarp_hist_render on a 1 x 1 mesh, "
                    "CUDA kernel")
        else:
            from vrdd_tpu_torch.kernels.slice_kernel import decode_with_rows
            from vrdd_tpu_torch.march.shearwarp import shearwarp_render_image

            vol = decode_with_rows(hist, rows, mode)
            img = shearwarp_render_image(
                vol, iv, W, H, tf, density=args.density,
                transfer_scale=args.tf_scale, n_planes=nz, backend="xla")
            path = f"rotated materialized decode ({args.stat}), plain torch"
    else:
        renderer = HistRenderer(
            tf, rows, stat=mode, width=W, height=H, density=args.density,
            transfer_scale=args.tf_scale, device=device,
        )
        origin = torch.tensor([0.0, 0.0, args.translate_z * -1.0])
        img = renderer(hist, origin)
        path = (f"in-kernel decode, {args.stat}, "
                f"{'CUDA kernel' if on_card else 'plain torch'}")
    formats.write_ppm(args.output, rgba_to_uint8(img).cpu().numpy())
    print(f"wrote {args.output} ({path})")
    return 0


def cmd_view(args) -> int:
    """Interactive browser viewer, the GLUT main-loop replacement
    (``vrdd_tpu/cli.py`` ``cmd_view``): serves the page and frames of
    ``RenderPipeline`` on ``--device`` from a stateless HTTP server; the
    browser holds the camera and render state and maps the reference's
    keyboard and mouse interactions (volumeRender.cpp:302-432). See
    ``vrdd_tpu_torch/viewer.py``."""
    from vrdd_tpu_torch.viewer import ViewerServer

    pipeline = _build_pipeline(args, _device(args.device))
    server = ViewerServer(
        pipeline, width=args.width, height=args.height,
        renderer=args.renderer, query=args.query, host=args.host,
        port=args.port,
    )
    server.serve_forever()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vrdd-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a dataset to an image")
    pr.add_argument("--volume", default="synthetic",
                    help="'synthetic' or path to a raw block-histogram blob")
    pr.add_argument("--blocks", type=int, nargs=3, default=[50, 50, 10],
                    metavar=("X", "Y", "Z"))
    pr.add_argument("--bins", type=int, default=32)
    pr.add_argument("--flex-block", type=int, default=4,
                    help="flexible-block size of the synthetic flexible "
                    "volume (queries 8/9/0)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--output", "-o", default=None)
    pr.add_argument("--file", default=None,
                    help="reference PPM for benchmark+golden mode ('none' to "
                    "skip compare)")
    pr.add_argument("--iters", type=int, default=10)
    pr.add_argument("--epsilon", type=float, default=5.0)
    pr.add_argument("--threshold", type=float, default=0.30)
    pr.add_argument(
        "--renderer",
        choices=("scan", "slice", "pallas", "shearwarp", "auto"),
        default="scan",
        help="scan = general ray marcher (reference-faithful); slice = "
        "object-order plain torch sweep (unrotated); pallas = the fused CUDA "
        "sweep kernel (unrotated; its plain version on --device cpu); "
        "shearwarp = any view on the sweep (the fused kernel on the card, "
        "the plain sweep on --device cpu); auto = fastest applicable",
    )
    pr.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    _add_render_params(pr)
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser("encode", help="raw volume -> block histogram files")
    pe.add_argument("--input", default="synthetic")
    pe.add_argument("--dims", type=int, nargs=3, default=[64, 64, 64],
                    metavar=("X", "Y", "Z"))
    pe.add_argument("--block", type=int, nargs=3, default=[8, 8, 8])
    pe.add_argument("--bins", type=int, default=32)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--output", "-o", default="histograms.bin")
    pe.add_argument("--device", default="cuda",
                    help="'cuda' or 'cpu': where the blocks are binned (the "
                    "file is the same)")
    pe.set_defaults(fn=cmd_encode)

    pf = sub.add_parser("fit-tf", help="fit the transfer function LUT")
    pf.add_argument("--volume", default="synthetic")
    pf.add_argument("--blocks", type=int, nargs=3, default=[16, 16, 8])
    pf.add_argument("--bins", type=int, default=32)
    pf.add_argument("--flex-block", type=int, default=4)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--size", type=int, default=64)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--iters", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--checkpoint", default="tf_fit.npz")
    pf.add_argument("--resume", default=None)
    pf.add_argument(
        "--renderer", default="auto", choices=["auto", "scan", "slice", "pallas"],
        help="forward for the fit: scan (the ray marcher), slice (the plain "
        "sweep), pallas (the fused CUDA kernels K3/K4/K5; their plain "
        "versions on --device cpu), or auto (pallas on the card, else slice)",
    )
    pf.add_argument("--tf-checkpoint", default=None, help=argparse.SUPPRESS)
    pf.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    pf.set_defaults(fn=cmd_fit_tf)

    prh = sub.add_parser(
        "render-hist",
        help="render straight from a histogram file (in-kernel decode)",
    )
    prh.add_argument("--hist-file", required=True)
    prh.add_argument("--dims", type=int, nargs=3, required=True,
                     metavar=("NZ", "NY", "NX"))
    prh.add_argument("--bins", type=int, default=16)
    prh.add_argument("--dtype", default="bfloat16",
                     choices=["bfloat16", "bf16", "float32"])
    prh.add_argument("--width", type=int, default=512)
    prh.add_argument("--height", type=int, default=512)
    prh.add_argument("--density", type=float, default=0.05)
    prh.add_argument("--translate-z", type=float, default=-4.0)
    prh.add_argument("--stat", default="mean",
                     choices=["mean", "var", "entropy"],
                     help="decoded statistic (reference queries 1/2/3)")
    prh.add_argument("--tf-scale", type=float, default=1.0, dest="tf_scale")
    prh.add_argument("--rot-x", type=float, default=0.0,
                     help="camera rotation about x (degrees; rotated views "
                     "take the distributed shear-warp sweep on the card, the "
                     "plain shear-warp of the decoded volume on the CPU)")
    prh.add_argument("--rot-y", type=float, default=0.0)
    prh.add_argument("-o", "--output", default="hist_render.ppm")
    prh.add_argument("--device", default="cuda",
                     help="'cuda' (the kernel) or 'cpu' (the plain version)")
    prh.set_defaults(fn=cmd_render_hist)

    ph = sub.add_parser(
        "fit-hist",
        help="fit a per-voxel histogram volume through the in-kernel decode",
    )
    ph.add_argument("--size", type=int, default=32, help="volume dimension")
    ph.add_argument("--image", type=int, default=128)
    ph.add_argument("--bins", type=int, default=16)
    ph.add_argument("--iters", type=int, default=50)
    ph.add_argument("--lr", type=float, default=0.05)
    ph.add_argument("--seed", type=int, default=0)
    ph.add_argument("--stat", default="mean",
                    choices=["mean", "var", "entropy"],
                    help="observed statistic to invert through")
    ph.add_argument("--route", default="inkernel",
                    choices=["inkernel", "materialized", "auto"],
                    help="'inkernel' decodes inside the kernels in both "
                    "directions; 'materialized' decodes once with torch and "
                    "runs the scalar sweep's kernels")
    ph.add_argument("--checkpoint", default="fit_hist.npz")
    ph.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    ph.set_defaults(fn=cmd_fit_hist)

    pv = sub.add_parser(
        "fit-voxels",
        help="fit per-voxel Gaussian (mu, sigma) from multi-view renders",
    )
    pv.add_argument("--size", type=int, default=32, help="volume dimension")
    pv.add_argument("--image", type=int, default=128)
    pv.add_argument("--views", type=int, default=3, help="1-5 views")
    pv.add_argument("--view-angle", type=float, default=25.0)
    pv.add_argument("--iters", type=int, default=100)
    pv.add_argument("--lr", type=float, default=3e-2)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--checkpoint", default="voxel_fit.npz")
    pv.add_argument(
        "--renderer", default="auto", choices=["auto", "slice", "pallas"],
        help="pallas = the fused CUDA kernels (their plain versions on "
        "--device cpu); slice = the plain torch sweeps; auto = pallas on "
        "the card, else slice",
    )
    pv.add_argument(
        "--streamed", action="store_true",
        help="decode (mu, sigma) per plane chunk inside the seeded sweep for "
        "the unrotated view (march/streaming.py)",
    )
    pv.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    pv.set_defaults(fn=cmd_fit_voxels)

    pw = sub.add_parser(
        "view",
        help="interactive browser viewer (the GLUT window replacement)",
    )
    pw.add_argument("--volume", default="synthetic",
                    help="'synthetic' or path to a raw block-histogram blob")
    pw.add_argument("--blocks", type=int, nargs=3, default=[50, 50, 10],
                    metavar=("X", "Y", "Z"))
    pw.add_argument("--bins", type=int, default=32)
    pw.add_argument("--flex-block", type=int, default=4)
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--width", type=int, default=512)
    pw.add_argument("--height", type=int, default=512)
    pw.add_argument("--query", type=int, default=1)
    pw.add_argument("--renderer", default="auto",
                    choices=("scan", "slice", "pallas", "auto"),
                    help="auto picks the fastest applicable path per view "
                    "(the fused kernel or shear-warp on the card, the plain "
                    "sweep on --device cpu, scan where the sweep cannot "
                    "take the view)")
    pw.add_argument("--host", default="127.0.0.1")
    pw.add_argument("--port", type=int, default=8412)
    pw.add_argument("--tf-checkpoint", help="load fitted TF LUT")
    pw.add_argument("--flex-normalize", action="store_true",
                    help="min-max map flexible-block stats onto the TF domain")
    pw.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    pw.set_defaults(fn=cmd_view)

    from vrdd_tpu_torch import bench

    pb = sub.add_parser("bench", help="performance benchmark")
    bench.add_arguments(pb)
    pb.set_defaults(fn=bench.run)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
