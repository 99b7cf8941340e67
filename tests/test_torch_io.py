"""Port parity of the host pieces: formats, synthetic data, state
conversion, transfer functions, image conversion, configuration — and the
port's independence from JAX."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vrdd_tpu.core import image as jimage
from vrdd_tpu.core import transfer as jtransfer
from vrdd_tpu.io import formats as jformats
from vrdd_tpu.io import synthetic as jsynthetic
from vrdd_tpu.utils import config as jconfig
from vrdd_tpu_torch.convert import state_from_jax, tensor_from_jax
from vrdd_tpu_torch.core import image as timage
from vrdd_tpu_torch.core import transfer as ttransfer
from vrdd_tpu_torch.io import formats as tformats
from vrdd_tpu_torch.io import synthetic as tsynthetic
from vrdd_tpu_torch.utils import config as tconfig


def _write_hist(tmp_path, dims=(5, 6, 7), B=8, seed=0):
    hist = jsynthetic.random_histogram_volume(dims, n_bins=B, seed=seed)
    path = str(tmp_path / "hist.bin")
    tformats.write_raw_histograms(path, hist.reshape(-1, B))
    return path, hist


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bf16"])
def test_read_histograms_bins_major_same_bits(tmp_path, dtype):
    path, _ = _write_hist(tmp_path)
    ref = jformats.read_histograms_bins_major(path, (5, 6, 7), 8, dtype=dtype)
    got = tformats.read_histograms_bins_major(path, (5, 6, 7), 8, dtype=dtype)
    assert tuple(got.shape) == ref.shape == (5, 8, 6, 7)
    if dtype == "float32":
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    else:  # round-to-nearest-even on both sides: identical bit patterns
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))


def test_raw_histograms_round_trip_and_truncation(tmp_path):
    path, hist = _write_hist(tmp_path)
    got = tformats.read_raw_histograms(path, 5 * 6 * 7, 8)
    np.testing.assert_array_equal(got, hist.reshape(-1, 8))
    with pytest.raises(tformats.FormatError):
        tformats.read_raw_histograms(path, 5 * 6 * 7 + 1, 8)
    with pytest.raises(tformats.FormatError):
        tformats.read_histograms_bins_major(path, (5, 6, 7), 8, dtype="int8")


def test_ppm_round_trip_and_compare(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(9, 13, 4), dtype=np.uint8)
    path = str(tmp_path / "a.ppm")
    tformats.write_ppm(path, torch.from_numpy(img))
    back = tformats.read_ppm(path)
    np.testing.assert_array_equal(back, img[..., :3])
    np.testing.assert_array_equal(back, jformats.read_ppm(path))
    other = back.astype(np.int32)
    other[:3] += 9
    other = np.clip(other, 0, 255).astype(np.uint8)
    for eps, thr in [(5.0, 0.30), (5.0, 0.1), (20.0, 0.0)]:
        assert tformats.compare_ppm(other, back, eps, thr) == \
            jformats.compare_ppm(other, back, eps, thr)
    with pytest.raises(tformats.FormatError):
        tformats.compare_ppm(back[:2], back)
    bad = tmp_path / "bad.ppm"
    bad.write_bytes(b"P5\n1 1\n255\n\x00")
    with pytest.raises(tformats.FormatError):
        tformats.read_ppm(str(bad))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_state_from_jax_round_trips(dtype):
    rng = np.random.default_rng(6)
    h = np.asarray(jnp.asarray(rng.random((4, 3, 5, 6), np.float32)).astype(dtype))
    rows = rng.random((4, 3)).astype(np.float32)
    st = state_from_jax({"hist_bm": h, "rows": rows,
                         "tf_lut": jtransfer.default_transfer_function()}, "cpu")
    assert set(st) == {"hist_bm", "rows", "tf_lut"}
    if dtype is np.float32:
        assert st["hist_bm"].dtype == torch.float32
        np.testing.assert_array_equal(st["hist_bm"].numpy(), h)
    else:
        assert st["hist_bm"].dtype == torch.bfloat16
        back = st["hist_bm"].view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(back.view(np.int16), h.view(np.int16))
        # same values as the f32 widening of either side
        np.testing.assert_array_equal(st["hist_bm"].float().numpy(),
                                      h.astype(np.float32))
    np.testing.assert_array_equal(st["rows"].numpy(), rows)
    # a JAX array itself converts too
    t = tensor_from_jax(jnp.asarray(rows), "cpu")
    np.testing.assert_array_equal(t.numpy(), rows)


def test_port_imports_no_jax():
    """Every module of the port imports with jax, ml_dtypes and vrdd_tpu
    absent from sys.modules (the card's machine has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vrdd_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vrdd_tpu_torch.__path__, "
        "'vrdd_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'vrdd_tpu'))\n"
        "assert len(mods) >= 14, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 14


@pytest.mark.parametrize("name,kwargs", [
    ("random_histogram_volume", dict(shape=(3, 4, 5), n_bins=6, seed=2)),
    ("gaussian_blob_volume", dict(shape=(6, 7, 8), n_blobs=3, seed=2)),
])
def test_seeded_generators_match_jax(name, kwargs):
    got = getattr(tsynthetic, name)(**kwargs)
    ref = getattr(jsynthetic, name)(**kwargs)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_blob_histogram_volume_matches_bench_fixture():
    from bench import hist512_volume

    ref = np.asarray(hist512_volume(8, 16)).astype(np.float32)
    got = tsynthetic.blob_histogram_volume(8, 16, device="cpu")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (8, 16, 8, 8)
    # both softmaxes are f32 before the bf16 cast; their last-ulp
    # differences may move a value by one bf16 step (at most 2^-7 relative)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-30)
    f32 = tsynthetic.blob_histogram_volume(8, 16, device="cpu",
                                           dtype=torch.float32)
    np.testing.assert_allclose(f32.sum(1).numpy(), 1.0, rtol=1e-5)


def test_transfer_functions_match_jax():
    np.testing.assert_array_equal(ttransfer.default_transfer_function(),
                                  jtransfer.default_transfer_function())
    for n in (2, 16):
        np.testing.assert_array_equal(ttransfer.grayscale_ramp(n),
                                      jtransfer.grayscale_ramp(n))


def test_image_conversion_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(-0.3, 1.3, size=(7, 9, 4)).astype(np.float32)
    img[0, 0] = [0.999999, 1.0 / 255.0, 254.99 / 255.0, 0.5]  # truncation
    got = timage.rgba_to_uint8(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jimage.rgba_to_uint8(img)))
    np.testing.assert_array_equal(
        timage.pack_abgr(torch.from_numpy(img)).to(torch.int64).numpy(),
        np.asarray(jimage.pack_abgr(img)).astype(np.int64),
    )


def test_config_matches_jax():
    assert tconfig.MarchConfig().__dict__ == jconfig.MarchConfig().__dict__
    assert tconfig.CameraConfig().__dict__ == jconfig.CameraConfig().__dict__
    assert (tconfig.TransferFunctionConfig().__dict__
            == jconfig.TransferFunctionConfig().__dict__)
    for name in ("N_BINS", "FLEX_N_BINS", "MAX_HISTOGRAM", "MEAN_NORM",
                 "VARIANCE_NORM", "FLEX_MAX_HISTOGRAM", "INTERP_MEAN_SCALE"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert [int(q) for q in tconfig.QueryMethod] == \
        [int(q) for q in jconfig.QueryMethod]
    for q in (1, 2, 3, 4, 5, 6, 8, 9, 0):
        assert tconfig.query_channel(q) == jconfig.query_channel(q)


def test_profiling_trace_and_annotate(tmp_path):
    """``utils/profiling.py``: a torch.profiler trace of the block, written
    as a Chrome trace that holds the annotated region; the compilation
    cache has no torch counterpart and names the kernels' build directory."""
    from vrdd_tpu_torch.kernels._build import BUILD_DIR
    from vrdd_tpu_torch.utils.profiling import (
        annotate, device_trace, enable_compilation_cache)

    with device_trace(str(tmp_path / "trace")) as prof:
        with annotate("vrdd_region"):
            torch.ones(8).cumsum(0)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "vrdd_region" in text
    assert any(e.key == "vrdd_region" for e in prof.key_averages())
    assert enable_compilation_cache() == BUILD_DIR
