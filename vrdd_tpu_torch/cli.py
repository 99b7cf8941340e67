"""Command-line interface of the port (counterpart of ``vrdd_tpu/cli.py``).

Subcommands ported so far:

- ``render-hist``  render straight from a block-histogram file: bins-major
                   load, the in-kernel decode sweep (``pallas_hist_render``
                   through ``HistRenderer``), PPM out.
- ``fit-hist``     fit a per-voxel histogram volume to renders of a decoded
                   statistic, differentiating through
                   ``pallas_hist_render_diff`` (K4 forward, K5 backward) with
                   Adam; writes an ``.npz`` checkpoint.

``--device cuda`` (the default) runs the CUDA kernels and raises when no GPU
is present; ``--device cpu`` runs the plain torch versions. Run as
``python -m vrdd_tpu_torch.cli render-hist --hist-file F --dims NZ NY NX
...`` or ``python -m vrdd_tpu_torch.cli fit-hist --iters 50``. The other
subcommands of ``vrdd_tpu.cli`` are later work (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys

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


def cmd_render_hist(args) -> int:
    """Histogram file -> decode statistic -> sweep -> PPM, unrotated camera
    at ``(0, 0, -translate_z)`` as ``vrdd_tpu.cli`` places it."""
    from vrdd_tpu_torch.core.image import rgba_to_uint8
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.io import formats
    from vrdd_tpu_torch.kernels.slice_kernel import decode_weight_rows
    from vrdd_tpu_torch.models.hist_renderer import HistRenderer

    if args.rot_x != 0.0 or args.rot_y != 0.0:
        raise NotImplementedError(
            "rotated views need the shear-warp sweep, which is not ported yet "
            "(ROADMAP.md queue 1: march/shearwarp.py)"
        )
    device = _device(args.device)
    nz, ny, nx = args.dims
    B = args.bins
    hist = formats.read_histograms_bins_major(
        args.hist_file, (nz, ny, nx), B, dtype=args.dtype
    ).to(device)
    print(f"loaded {args.hist_file}: {tuple(hist.shape)} {hist.dtype} "
          f"on {device}")
    # decode statistic (reference queries 1/2/3); 'unit' family = centers
    # on [0, 1], the natural range for standalone histogram files
    rows, mode = decode_weight_rows(args.stat, B, family="unit")
    renderer = HistRenderer(
        default_transfer_function(), rows, stat=mode, width=args.width,
        height=args.height, density=args.density,
        transfer_scale=args.tf_scale, device=device,
    )
    origin = torch.tensor([0.0, 0.0, args.translate_z * -1.0])
    img = renderer(hist, origin)
    formats.write_ppm(args.output, rgba_to_uint8(img).cpu().numpy())
    path = "CUDA kernel" if device.type == "cuda" else "plain torch"
    print(f"wrote {args.output} (in-kernel decode, {args.stat}, {path})")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vrdd-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

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
                     help="camera rotation about x (degrees; not ported yet: "
                     "nonzero raises)")
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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
