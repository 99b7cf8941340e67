#!/usr/bin/env python3
"""Hold the f32 main path of this checkout against another checkout's, on
one NVIDIA GPU: the bits of K1-K5's f32 outputs and K4's time.

    python3 tools/ab_f32_main_path.py --other DIR

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Both trees build their kernels (concurrently), then one worker
process per turn imports one tree's ``vrdd_tpu_torch`` and runs, on the
headline fixture (``blob_histogram_volume(512, 16, bf16)`` -> 1024^2, made
on the card from its fixed formula): K1 on the decoded mean, K2 for mean,
var and entropy, and K3, K4 and K5 of the in-kernel mean fwd+bwd
(``wrt=("hist", "lut")``), each at precision 'f32' on the fetch path its
wrapper picks. The first turn of each tree saves the outputs; every turn
times K4 (median of 10, CUDA events). Turns: other, this, this, other.

Pass: every image, checkpoint row and LUT cotangent bitwise equal; K5's
plane cotangent (f32 atomics in another order from run to run) within
1e-6 relative L2. Prints one JSON line with the K4 times and the checks;
exits non-zero on a mismatch or without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def worker(tree: Path, save: str, runs: int) -> None:
    sys.path.insert(0, str(tree))
    import torch

    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
    from vrdd_tpu_torch.kernels import slice_kernel as sk
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    assert Path(sk.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    n, B, W = 512, 16, 1024
    tf = default_transfer_function()
    origin = torch.tensor([0.0, 0.0, 4.0])
    hist = blob_histogram_volume(n, B, device=dev, dtype=torch.bfloat16)
    rows, _ = sk.decode_weight_rows("mean", B, family="unit")
    rows_t = torch.as_tensor(rows, device=dev)
    cfg = sv.render_config(hist.shape, origin, stat="linear", width=W,
                           height=W)
    args = (cfg, hist, rows_t, torch.as_tensor(tf, device=dev),
            torch.tensor(0.05, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    out = {}
    if save:
        mean_vol = sk.decode_with_rows(hist, rows, "linear")
        out["k1"] = sk.pallas_slice_render(mean_vol, origin, tf, width=W,
                                           height=W, n_planes=n)
        del mean_vol
        for stat in ("mean", "var", "entropy"):
            r, mode = sk.decode_weight_rows(stat, B, family="unit")
            out[f"k2_{stat}"] = sk.pallas_hist_render(
                hist, r, origin, tf, transfer_scale=10.0 if stat == "var"
                else 1.0, width=W, height=W, stat=mode)
        out["k3"] = sv.sweep_fwd(*args)
        out["k4_img"], out["k4_tck"] = sv.sweep_fwd_ckpt(*args)
        g = (2.0 / out["k4_img"].numel()) * (out["k4_img"] - 0.25)
        out["k5_d"], out["k5_small"], _, _ = sv.sweep_bwd(
            *args, g, out["k4_tck"], True, True, False)
        torch.cuda.synchronize()
        torch.save({k: v.cpu() for k, v in out.items()}, save)
        del out

    def k4():
        return sv.sweep_fwd_ckpt(*args)

    k4()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        k4()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    print(json.dumps({"k4_ms": times[len(times) // 2]}))


def build(tree: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         "from vrdd_tpu_torch.kernels import _build; _build.build()",
         str(tree)], cwd=tree, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        worker(a.worker, a.save, a.runs)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_f32_main_path: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": a.other.resolve(), "this": HERE}
    procs = {k: build(t) for k, t in trees.items()}
    for k, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(f"build of {k} failed:\n{log}", file=sys.stderr)
            return 1
    tmp = Path(tempfile.mkdtemp(prefix="ab_f32_"))
    k4 = {"other": [], "this": []}
    for turn, key in enumerate(("other", "this", "this", "other")):
        save = "" if turn in (2, 3) else str(tmp / f"{key}.pt")
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--other",
             str(a.other), "--worker", str(trees[key]), "--save", save,
             "--runs", str(a.runs)], cwd=trees[key], capture_output=True,
            text=True)
        if res.returncode != 0:
            print(f"turn {turn} ({key}) failed:\n{res.stdout}\n{res.stderr}",
                  file=sys.stderr)
            return 1
        k4[key].append(json.loads(res.stdout.strip().splitlines()[-1])[
            "k4_ms"])
    a_out = torch.load(tmp / "other.pt")
    b_out = torch.load(tmp / "this.pt")
    checks, ok = {}, True
    for name in a_out:
        x, y = a_out[name], b_out[name]
        if name == "k5_d":
            err = float((x.double() - y.double()).norm() / y.double().norm())
            checks[name] = f"rel L2 {err:.3e}"
            ok &= err <= 1e-6
        else:
            same = bool(torch.equal(x, y))
            checks[name] = "bitwise" if same else "DIFFERS"
            ok &= same
    for f in tmp.iterdir():
        f.unlink()
    tmp.rmdir()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "k4_ms_other": k4["other"],
                      "k4_ms_this": k4["this"], "checks": checks,
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
