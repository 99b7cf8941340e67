#!/usr/bin/env python3
"""Hold the one-process distributed histogram step of this checkout against
another checkout's, on one NVIDIA GPU: its time, its peak memory and its
outputs.

    python3 tools/ab_dist_hist_step.py --other DIR

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Both trees build their kernels (concurrently), then one worker
process per turn imports one tree's ``vrdd_tpu_torch`` and runs
``parallel.sweep.distributed_hist_render`` on a bricks=4 x rays=2 mesh in
one process, as ``chip_smoke.py`` phase 11a does: the mean of
``blob_histogram_volume(512, 16, bf16)`` (made on the card from its fixed
formula) -> 1024^2 at density 0.2, a frame and a fwd+bwd wrt the
histograms and the LUT. Turns: other, this, this, other. Each turn times
the frame and the fwd+bwd (host clock, median of ``--runs``, after one
warm-up) and reads the fwd+bwd's peak allocated memory.

Reports, beside the times and peaks: whether the frames are bitwise equal;
``d_hist``'s relative L2 between the trees' first turns and between this
tree's two turns (the floor: K5's f32 atomics through the bf16 rounding);
``d_lut``'s between the trees. Prints one JSON line; exits non-zero when a
frame differs, ``d_hist`` differs by more than 2^-8 or ``d_lut`` by more
than 1e-5, or without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def worker(tree: Path, save: str, runs: int) -> None:
    sys.path.insert(0, str(tree))
    import torch

    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.parallel import sweep as ps
    from vrdd_tpu_torch.parallel.mesh import make_mesh

    assert Path(ps.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    n, B, W = 512, 16, 1024
    tf = default_transfer_function()
    origin = torch.tensor([0.0, 0.0, 4.0])
    hist = blob_histogram_volume(n, B, device=dev, dtype=torch.bfloat16)
    rows, mode = sk.decode_weight_rows("mean", B, family="unit")
    mesh = make_mesh(4, 2)

    def render(h=hist, lut=tf, wrt=("hist", "lut", "params")):
        return ps.distributed_hist_render(
            h, rows, origin, lut, 0.2, width=W, height=W, mesh=mesh,
            stat=mode, wrt=wrt)

    def fwdbwd():
        h = hist.detach().requires_grad_(True)
        lut = torch.tensor(tf, device=dev, requires_grad=True)
        loss = torch.mean((render(h, lut, ("hist", "lut")) - 0.25) ** 2)
        loss.backward()
        return h.grad, lut.grad

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[len(times) // 2]

    frame_ms = host_ms(render)
    fb_ms = host_ms(fwdbwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g_hist, g_lut = fwdbwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
    if save:
        np.save(save + ".frame.npy", render().cpu().numpy())
        np.save(save + ".dhist.npy", g_hist.view(torch.int16).cpu().numpy())
        np.save(save + ".dlut.npy", g_lut.cpu().numpy())
    print(json.dumps({"frame_ms": frame_ms, "fwdbwd_ms": fb_ms,
                      "fwdbwd_peak_gib": peak}))


def build(tree: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         "from vrdd_tpu_torch.kernels import _build; _build.build()",
         str(tree)], cwd=tree, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def rel_l2(a: np.ndarray, b: np.ndarray, bf16: bool) -> float:
    """Relative L2 of ``a`` against ``b``, a few layers at a time in
    float64 (``bf16``: the arrays hold bfloat16 bits as int16)."""
    num = den = 0.0
    for z in range(0, a.shape[0], 8):
        x, y = a[z:z + 8], b[z:z + 8]
        if bf16:
            x = (x.astype(np.int32) << 16).view(np.float32)
            y = (y.astype(np.int32) << 16).view(np.float32)
        x, y = x.astype(np.float64), y.astype(np.float64)
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        worker(a.worker, a.save, a.runs)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_dist_hist_step: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": a.other.resolve(), "this": HERE}
    procs = {k: build(t) for k, t in trees.items()}
    for k, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(f"build of {k} failed:\n{log}", file=sys.stderr)
            return 1
    tmp = Path(tempfile.mkdtemp(prefix="ab_dist_"))
    turns = {"other": [], "this": []}
    saves = ("other", "this", "this2", "")
    try:
        for turn, key in enumerate(("other", "this", "this", "other")):
            save = str(tmp / saves[turn]) if saves[turn] else ""
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--other",
                 str(a.other), "--worker", str(trees[key]), "--save", save,
                 "--runs", str(a.runs)], cwd=trees[key],
                capture_output=True, text=True)
            if res.returncode != 0:
                print(f"turn {turn} ({key}) failed:\n{res.stdout}\n"
                      f"{res.stderr}", file=sys.stderr)
                return 1
            turns[key].append(json.loads(
                res.stdout.strip().splitlines()[-1]))

        def load(name, part):
            return np.load(tmp / f"{name}.{part}.npy", mmap_mode="r")

        frames_equal = bool(np.array_equal(load("other", "frame"),
                                           load("this", "frame")))
        d_hist = rel_l2(load("this", "dhist"), load("other", "dhist"), True)
        floor = rel_l2(load("this2", "dhist"), load("this", "dhist"), True)
        d_lut = rel_l2(load("this", "dlut"), load("other", "dlut"), False)
    finally:
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()
    ok = frames_equal and d_hist <= 2.0 ** -8 and d_lut <= 1e-5
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "turns": ["other", "this", "this",
                                             "other"],
                      "other": turns["other"], "this": turns["this"],
                      "frames_bitwise": frames_equal,
                      "d_hist_rel_l2": d_hist, "d_hist_floor": floor,
                      "d_lut_rel_l2": d_lut, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
