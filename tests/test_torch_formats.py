"""The reference's binary formats in the port (``vrdd_tpu_torch/io/formats.py``)
against ``vrdd_tpu/io/formats.py``: every writer's file is byte for byte
JAX's for the same arrays, every reader reads JAX's files to JAX's arrays
(and the port's files back), and malformed files raise ``FormatError`` as
in JAX."""

import struct

import numpy as np
import pytest

from vrdd_tpu.io import formats as jf
from vrdd_tpu.io import synthetic as jsyn
from vrdd_tpu_torch.io import formats as tf


@pytest.fixture(scope="module")
def data():
    """Codebook, template, span and simple-histogram arrays of the seeded
    flexible-block dataset (the reference's file contents)."""
    ds = jsyn.synthetic_flexible_dataset(dims=(5, 4, 3), seed=1)
    n = len(ds["fractal_codebook"])
    return dict(
        ds=ds,
        span_ids=np.arange(n, dtype=np.int32) * 3 + 1,
        limits=np.random.default_rng(2).random((len(ds["templates"]), 6)),
    )


def _both(tmp_path, name, writer_args, write):
    """Write with each package; returns the two paths (same bytes)."""
    paths = []
    for pkg in (jf, tf):
        p = tmp_path / f"{pkg.__name__.split('.')[0]}_{name}"
        getattr(pkg, write)(str(p), *writer_args)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    return paths


def _equal(got, ref):
    for g, r in zip(got, ref):
        assert np.asarray(g).dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("max_errors", [0, 4])
def test_codebook_round_trip_and_cross_read(tmp_path, data, max_errors):
    ds = data["ds"]
    args = (ds["fractal_codebook"], ds["fractal_error_bins"],
            ds["fractal_error_values"], data["span_ids"], 3)
    jp, tp = _both(tmp_path, "codebook.bin", args, "write_codebook")
    for p in (jp, tp):
        got = tf.read_codebook(str(p), 64, max_errors)
        _equal(got, jf.read_codebook(str(p), 64, max_errors))
    cb, eb, ev, ids = got
    np.testing.assert_array_equal(cb, ds["fractal_codebook"])
    np.testing.assert_array_equal(ids, data["span_ids"])
    ne = cb[:, 3]
    e = ds["fractal_error_bins"].shape[1]
    mask = np.arange(e)[None, :] < ne[:, None]
    np.testing.assert_array_equal(eb[:, :e] * mask,
                                  ds["fractal_error_bins"] * mask)
    np.testing.assert_array_equal(ev[:, :e] * mask,
                                  ds["fractal_error_values"] * mask)


def test_codebook_rejects_what_jax_rejects(tmp_path):
    cb = np.array([[0, 1, 0, 2]], dtype=np.int32)
    for bins, match in (([3, 3], "duplicate"), ([1, 70], "out of"),
                        ([-1, 2], "out of")):
        p = tmp_path / "bad.bin"
        jf.write_codebook(str(p), cb, np.array([bins], np.int32),
                          np.array([[0.1, 0.2]], np.float32), [0])
        for pkg in (tf, jf):
            with pytest.raises(pkg.FormatError, match=match):
                pkg.read_codebook(str(p), 64)
    p = tmp_path / "many.bin"
    jf.write_codebook(str(p), np.array([[0, 0, 0, 0]], np.int32),
                      np.zeros((1, 1), np.int32), np.zeros((1, 1), np.float32),
                      [0])
    raw = bytearray(p.read_bytes())
    raw[-4:] = struct.pack("<i", 99)  # nErrors past n_bins
    p.write_bytes(bytes(raw))
    with pytest.raises(tf.FormatError, match="nErrors"):
        tf.read_codebook(str(p), 64)
    p.write_bytes(struct.pack("<ii", 1, 2))  # promises 2 entries, holds none
    with pytest.raises(tf.FormatError, match="truncated"):
        tf.read_codebook(str(p), 64)


def test_templates_round_trip_and_cross_read(tmp_path, data):
    t = data["ds"]["templates"]
    for extra in ((), (data["limits"],)):
        jp, tp = _both(tmp_path, f"t{len(extra)}.bin", (t, *extra),
                       "write_templates")
        for p in (jp, tp):
            got = tf.read_templates(str(p), 64)
            np.testing.assert_array_equal(got, jf.read_templates(str(p), 64))
            np.testing.assert_array_equal(got, t)
    bad = tmp_path / "bad_t.bin"
    jf.write_templates(str(bad), np.full((1, 4), 1.5))
    with pytest.raises(tf.FormatError, match="out of"):
        tf.read_templates(str(bad), 4)


def test_span_list_round_trip_and_cross_read(tmp_path, data):
    spans = data["ds"]["fractal_spans"]
    low, high = spans[:, :3], spans[:, 3:]
    jp, tp = _both(tmp_path, "spans.bin", (low, high), "write_span_list")
    for p in (jp, tp):
        got = tf.read_span_list(str(p))
        _equal(got, jf.read_span_list(str(p)))
        np.testing.assert_array_equal(got[0], low)
        np.testing.assert_array_equal(got[1], high)
    bad = tmp_path / "bad_s.bin"
    jf.write_span_list(str(bad), high[:2], low[:2] - 1)
    with pytest.raises(tf.FormatError, match="low > high"):
        tf.read_span_list(str(bad))


def test_simple_histograms_round_trip_and_cross_read(tmp_path, data):
    ds = data["ds"]
    s = ds["simple_spans"]
    # the reader's sum-to-one check is on the float64 file values
    freqs = ds["simple_freqs"].astype(np.float64)
    args = (s[:, :3], s[:, 3:], ds["simple_bin_ids"], freqs,
            ds["simple_counts"])
    names = ("c.bin", "b.bin", "f.bin")
    paths = {}
    for pkg in (jf, tf):
        ps = [str(tmp_path / f"{pkg.__name__.split('.')[0]}_{n}")
              for n in names]
        pkg.write_simple_histograms(*ps, *args)
        paths[pkg] = ps
    for a, b in zip(paths[jf], paths[tf]):
        assert open(a, "rb").read() == open(b, "rb").read()
    for ps in paths.values():
        got = tf.read_simple_histograms(*ps, 64)
        _equal(got, jf.read_simple_histograms(*ps, 64))
        np.testing.assert_array_equal(got[4], ds["simple_counts"])
        np.testing.assert_array_equal(got[0], s[:, :3])


def test_simple_histograms_reject_what_jax_rejects(tmp_path):
    low = np.zeros((1, 3), np.int32)
    for ids, fr, match in (([0, 1], [0.5, 0.4], "total"),
                           ([0, 1], [1.5, -0.5], "out of range")):
        ps = [str(tmp_path / n) for n in ("c", "b", "f")]
        jf.write_simple_histograms(*ps, low, low, np.array([ids]),
                                   np.array([fr]), np.array([2]))
        for pkg in (tf, jf):
            with pytest.raises(pkg.FormatError, match=match):
                pkg.read_simple_histograms(*ps, 8)


def test_raw_blob_and_ppm_cross_read(tmp_path):
    h = np.random.default_rng(3).random((12, 8)).astype(np.float32)
    jp, tp = _both(tmp_path, "raw.bin", (h,), "write_raw_histograms")
    np.testing.assert_array_equal(tf.read_raw_histograms(str(jp), 12, 8), h)
    img = np.random.default_rng(4).integers(0, 256, (5, 7, 4), dtype=np.uint8)
    jp, tp = _both(tmp_path, "img.ppm", (img,), "write_ppm")
    np.testing.assert_array_equal(tf.read_ppm(str(jp)), img[..., :3])
