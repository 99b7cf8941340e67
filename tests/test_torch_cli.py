"""The port's CLI against the JAX package's on the CPU: ``render-hist`` on
the same histogram file (JAX takes its materialized-decode branch; the port
its plain torch version), ``render`` for queries 0-9 on the seeded
synthetic families, ``encode`` byte for byte, and ``fit-voxels``."""

import itertools

import numpy as np
import pytest
import torch

from vrdd_tpu import cli as jcli
from vrdd_tpu.io.synthetic import random_histogram_volume
from vrdd_tpu_torch import cli as tcli
from vrdd_tpu_torch.io import formats

B = 16
CASES = list(itertools.product(
    [(16, 24, 24), (16, 16, 16)], ["mean", "var", "entropy"],
    ["bfloat16", "float32"],
))


def _hist_file(tmp_path, dims, seed=0):
    hist = random_histogram_volume(tuple(dims), n_bins=B, seed=seed)
    path = tmp_path / "hist.bin"
    formats.write_raw_histograms(str(path), hist.reshape(-1, B))
    return path


def _args(path, dims, stat, dtype, out):
    # var decodes to ~0.06 on the unit family: window it onto the ramp
    tscl = "10" if stat == "var" else "1"
    return [
        "render-hist", "--hist-file", str(path), "--dims", *map(str, dims),
        "--bins", str(B), "--dtype", dtype, "--width", "128", "--height",
        "128", "--stat", stat, "--tf-scale", tscl, "-o", str(out),
    ]


@pytest.mark.parametrize("dims,stat,dtype", CASES,
                         ids=[f"{'x'.join(map(str, d))}-{s}-{t}"
                              for d, s, t in CASES])
def test_render_hist_matches_jax(tmp_path, dims, stat, dtype):
    path = _hist_file(tmp_path, dims)
    ref_out, got_out = tmp_path / "jax.ppm", tmp_path / "torch.ppm"
    assert jcli.main(_args(path, dims, stat, dtype, ref_out)) == 0
    assert tcli.main(_args(path, dims, stat, dtype, got_out)
                     + ["--device", "cpu"]) == 0
    ref = formats.read_ppm(str(ref_out)).astype(np.int32)
    got = formats.read_ppm(str(got_out)).astype(np.int32)
    assert got.shape == ref.shape == (128, 128, 3)
    assert ref.max() > 0, "vacuous comparison: image is black"
    level = np.abs(got - ref).max(axis=-1)
    # the uint8 truncation of rgba_to_uint8 can flip at a level boundary:
    # at most 1 level, on at most 0.5% of pixels
    assert level.max() <= 1, level.max()
    assert np.mean(level > 0) <= 5e-3, np.mean(level > 0)


def test_render_hist_rotated_raises(tmp_path):
    """Rotated render-hist views render now (the distributed shear-warp
    sweep on the card, the materialized decode here); asking the card for
    one without a GPU still raises, with no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda renders on it")
    path = _hist_file(tmp_path, (4, 4, 4))
    argv = _args(path, (4, 4, 4), "mean", "float32", tmp_path / "o.ppm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv + ["--rot-x", "20"])
    assert not (tmp_path / "o.ppm").exists()


@pytest.mark.parametrize("stat", ["mean", "entropy"])
def test_render_hist_rotated_matches_jax(tmp_path, stat, capsys):
    """``render-hist --rot-x 30 --rot-y 20 --device cpu`` against JAX's CLI
    on the same file (both take the materialized decode and the plain
    shear-warp): within one uint8 level on all but 0.1% of pixels, and the
    path line names the branch."""
    dims = (16, 24, 24)
    path = _hist_file(tmp_path, dims)
    ref_out, got_out = tmp_path / "jax.ppm", tmp_path / "torch.ppm"
    rot = ["--rot-x", "30", "--rot-y", "20"]
    assert jcli.main(_args(path, dims, stat, "float32", ref_out) + rot) == 0
    capsys.readouterr()
    assert tcli.main(_args(path, dims, stat, "float32", got_out) + rot
                     + ["--device", "cpu"]) == 0
    assert "rotated materialized decode" in capsys.readouterr().out
    ref = formats.read_ppm(str(ref_out)).astype(np.int32)
    got = formats.read_ppm(str(got_out)).astype(np.int32)
    assert got.shape == ref.shape == (128, 128, 3)
    assert ref.max() > 0, "vacuous comparison: image is black"
    level = np.abs(got - ref).max(axis=-1)
    assert level.max() <= 1, level.max()
    assert np.mean(level > 0) <= 1e-3, np.mean(level > 0)


def test_render_hist_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda renders on it")
    path = _hist_file(tmp_path, (4, 4, 4))
    argv = _args(path, (4, 4, 4), "mean", "float32", tmp_path / "o.ppm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)  # --device defaults to cuda: no CPU fallback
    assert not (tmp_path / "o.ppm").exists()


# ---- render: RenderPipeline through the CLI --------------------------------

def _render_args(out, *extra):
    return ["render", "--width", "32", "--height", "32", "-o", str(out),
            *extra]


@pytest.mark.parametrize("renderer", ["scan", "slice"])
def test_render_matches_jax(tmp_path, renderer):
    """``render`` on the seeded synthetic volume, port (CPU) vs JAX."""
    ref_out, got_out = tmp_path / "jax.ppm", tmp_path / "torch.ppm"
    args = ["--renderer", renderer, "--density", "0.5"]
    assert jcli.main(_render_args(ref_out, *args)) == 0
    assert tcli.main(_render_args(got_out, *args, "--device", "cpu")) == 0
    ref = formats.read_ppm(str(ref_out)).astype(np.int32)
    got = formats.read_ppm(str(got_out)).astype(np.int32)
    assert got.shape == ref.shape == (32, 32, 3)
    assert ref.max() > 0, "vacuous comparison: image is black"
    level = np.abs(got - ref).max(axis=-1)
    # the uint8 truncation flips a level on a few pixels; a sample at the
    # opacity cutoff may flip on one (0.1% of the 32^2 pixels)
    assert np.mean(level > 1) <= 1e-3 and np.mean(level > 0) <= 1e-2, (
        np.mean(level > 1), np.mean(level > 0))


def test_render_file_mode_passes_and_fails(tmp_path, capsys):
    """``--file``: warm-up, timed renders and the MTexels/s line; exit 0
    against the render's own PPM, 1 against a perturbed one."""
    fixture = tmp_path / "fixture.ppm"
    assert tcli.main(_render_args(fixture, "--device", "cpu", "--renderer",
                                  "pallas", "--query", "3")) == 0
    common = ("--device", "cpu", "--renderer", "pallas", "--query", "3",
              "--iters", "2")
    rc = tcli.main(_render_args(tmp_path / "a.ppm", "--file", str(fixture),
                                *common))
    out = capsys.readouterr().out
    assert rc == 0 and "MTexels/s" in out and "PASS" in out
    img = formats.read_ppm(str(fixture))
    formats.write_ppm(str(tmp_path / "bad.ppm"),
                      np.concatenate([255 - img, img[..., :1]], axis=-1))
    rc = tcli.main(_render_args(tmp_path / "b.ppm", "--file",
                                str(tmp_path / "bad.ppm"), *common))
    assert rc == 1 and "FAIL" in capsys.readouterr().out
    assert tcli.main(_render_args(tmp_path / "c.ppm", "--file", "none",
                                  *common)) == 0


def test_render_volume_file(tmp_path):
    """``--volume <file>`` reads a raw block-histogram blob (X Y Z blocks)."""
    from vrdd_tpu_torch.core.image import rgba_to_uint8
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig)

    hist = random_histogram_volume((4, 6, 5), n_bins=32, seed=3)
    path = tmp_path / "hist.bin"
    formats.write_raw_histograms(str(path), hist.reshape(-1, 32))
    out = tmp_path / "o.ppm"
    assert tcli.main(_render_args(
        out, "--volume", str(path), "--blocks", "5", "6", "4", "--query",
        "7", "--renderer", "auto", "--device", "cpu")) == 0
    p = RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(hist)))
    cfg = RenderConfig(camera=CameraConfig(width=32, height=32),
                       query_method=QueryMethod.INTERP_MEAN)
    ref = rgba_to_uint8(p.render(None, cfg, "slice")).numpy()[..., :3]
    np.testing.assert_array_equal(formats.read_ppm(str(out)), ref)


#: every query of the synthetic pipeline (raw, fractal, flexible blocks),
#: with the flags that put its values on the LUT: the variances are wide,
#: the flexible mean and variance in raw bin-domain units unless
#: --flex-normalize maps them
QUERY_CASES = [(q, ("--tf-scale", "0.25") if q in (2, 5) else ())
               for q in range(1, 9)] + [
    (9, ("--flex-normalize",)), (0, ("--flex-normalize",)),
    (9, ("--tf-scale", "0.004")), (8, ("--flex-block", "3")),
    (9, ("--flex-block", "5", "--flex-normalize")),
]


def _same_image(ref_out, got_out, flips=1e-3):
    ref = formats.read_ppm(str(ref_out)).astype(np.int32)
    got = formats.read_ppm(str(got_out)).astype(np.int32)
    assert got.shape == ref.shape == (32, 32, 3)
    assert ref.max() > 0, "vacuous comparison: image is black"
    level = np.abs(got - ref).max(axis=-1)
    # the uint8 truncation flips a level on a few pixels; a sample at the
    # opacity cutoff may flip on one (0.1% of the 32^2 pixels)
    assert np.mean(level > 1) <= flips and np.mean(level > 0) <= 1e-2, (
        np.mean(level > 1), np.mean(level > 0))


@pytest.mark.parametrize("query,extra", QUERY_CASES,
                         ids=[f"q{q}{''.join(e)}" for q, e in QUERY_CASES])
def test_render_queries_match_jax(tmp_path, query, extra):
    """``render --query 0-9`` through 'auto' (the plain sweep on the CPU,
    JAX's 'slice' off the TPU) on the seeded synthetic families, with
    ``--flex-block`` and ``--flex-normalize``, port vs JAX."""
    ref_out, got_out = tmp_path / "jax.ppm", tmp_path / "torch.ppm"
    args = ["--renderer", "auto", "--density", "0.5", "--blocks", "10", "10",
            "5", "--query", str(query), *extra]
    assert jcli.main(_render_args(ref_out, *args)) == 0
    assert tcli.main(_render_args(got_out, *args, "--device", "cpu")) == 0
    _same_image(ref_out, got_out)


@pytest.mark.parametrize("query", [4, 9])
def test_render_family_scan_matches_jax(tmp_path, query):
    """The ray marcher on a fractal and a flexible-block query."""
    ref_out, got_out = tmp_path / "jax.ppm", tmp_path / "torch.ppm"
    args = ["--renderer", "scan", "--density", "0.5", "--blocks", "10", "10",
            "5", "--query", str(query), "--flex-normalize"]
    assert jcli.main(_render_args(ref_out, *args)) == 0
    assert tcli.main(_render_args(got_out, *args, "--device", "cpu")) == 0
    _same_image(ref_out, got_out)


@pytest.mark.parametrize("extra", [(), ("--dims", "24", "16", "8", "--block",
                                        "4", "4", "2", "--bins", "16",
                                        "--seed", "3")])
def test_encode_is_jax_byte_for_byte(tmp_path, capsys, extra):
    ref, got = tmp_path / "jax.bin", tmp_path / "torch.bin"
    assert jcli.main(["encode", "-o", str(ref), *extra]) == 0
    assert tcli.main(["encode", "-o", str(got), "--device", "cpu",
                      *extra]) == 0
    assert "encoded" in capsys.readouterr().out
    assert got.read_bytes() == ref.read_bytes() and got.stat().st_size > 0


def test_encode_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["encode", "-o", str(tmp_path / "h.bin")])


def test_render_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda renders on it")
    out = tmp_path / "o.ppm"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_render_args(out))  # --device defaults to cuda
    assert not out.exists()


@pytest.mark.parametrize("renderer", ["auto", "shearwarp"])
def test_render_rotated_matches_jax(tmp_path, renderer):
    """A rotated ``render`` goes through the shear-warp sweep ('auto'
    resolves to it; the plain sweep on the CPU), port vs JAX."""
    ref_out, got_out = tmp_path / "jax.ppm", tmp_path / "torch.ppm"
    args = ["--renderer", renderer, "--density", "0.5", "--rot-x", "20",
            "--rot-y", "-30"]
    assert jcli.main(_render_args(ref_out, *args)) == 0
    assert tcli.main(_render_args(got_out, *args, "--device", "cpu")) == 0
    ref = formats.read_ppm(str(ref_out)).astype(np.int32)
    got = formats.read_ppm(str(got_out)).astype(np.int32)
    assert ref.max() > 0, "vacuous comparison: image is black"
    level = np.abs(got - ref).max(axis=-1)
    assert level.max() <= 1 and np.mean(level > 0) <= 1e-2, (
        level.max(), np.mean(level > 0))


@pytest.mark.parametrize("streamed", [False, True])
def test_fit_voxels_writes_checkpoint(tmp_path, capsys, streamed):
    """``fit-voxels --device cpu`` at a small size: two Adam steps through
    the plain sweeps (the seeded streamed decode with ``--streamed``), the
    checkpoint holds JAX's keys, the loss is finite."""
    from vrdd_tpu_torch.io.checkpoint import load_checkpoint

    ckpt = tmp_path / "fit.npz"
    argv = ["fit-voxels", "--device", "cpu", "--size", "8", "--image", "16",
            "--iters", "2", "--checkpoint", str(ckpt)]
    assert tcli.main(argv + (["--streamed"] if streamed else [])) == 0
    out = capsys.readouterr().out
    assert "renderer: slice" in out and ("streamed" in out) == streamed
    import re

    losses = [float(v) for v in re.findall(r"step \d+: loss (\S+)", out)]
    assert len(losses) == 2 and losses[1] < losses[0], losses
    state = load_checkpoint(str(ckpt))
    assert set(state) == {"mu", "sigma", "loss"}
    assert state["mu"].shape == state["sigma"].shape == (8, 8, 8)
    assert float(state["loss"]) == np.float32(losses[1])
    # sigma left JAX's start of 0.1 (mu starts at 0, the LUT's flat end)
    assert np.abs(state["sigma"] - np.float32(0.1)).max() > 0


def test_fit_voxels_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda fits on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["fit-voxels", "--size", "8", "--image", "16", "--iters",
                   "1", "--checkpoint", str(tmp_path / "f.npz")])
    assert not (tmp_path / "f.npz").exists()
