"""The port's native C++ loader (vrdd_tpu_torch/io/native.py over its own
csrc/vrdd_io.cpp) against the port's Python readers and the JAX package's
(vrdd_tpu.io.formats), on the files tests/test_io_formats.py writes, with
the validation errors. The library is built with g++ into a temporary
directory, never into the package."""

import numpy as np
import pytest
import torch

from vrdd_tpu.io import formats as jformats
from vrdd_tpu_torch.io import formats, native


@pytest.fixture(scope="module")
def nat(tmp_path_factory):
    """The native module, building into a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("native"))
        if not native.available():
            pytest.fail("g++ is present here: the native loader must build")
        yield native


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_builds_once_into_its_directory(nat):
    libs = list(nat.BUILD_DIR.glob("libvrdd_io-*.so"))
    assert len(libs) == 1
    assert nat.build(nat.BUILD_DIR) == libs[0]  # cached: not rebuilt


def test_unavailable_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    with pytest.raises(RuntimeError, match="not available"):
        native.read_templates(str(tmp_path / "t.bin"), 2)


def _codebook_file(path, rng):
    n, nb, E = 25, 64, 6
    cb = np.stack([rng.integers(0, 400, n), rng.integers(0, nb, n),
                   rng.integers(0, 2, n), rng.integers(0, E + 1, n)],
                  -1).astype(np.int32)
    ebins = np.stack([rng.permutation(nb)[:E] for _ in range(n)]).astype(
        np.int32)
    evals = rng.uniform(-1, 1, (n, E)).astype(np.float32)
    sids = rng.integers(0, 1000, n).astype(np.int32)
    for i in range(n):
        ebins[i, cb[i, 3]:] = 0
        evals[i, cb[i, 3]:] = 0
    jformats.write_codebook(path, cb, ebins, evals, sids)
    return (path, nb, E)


def _templates_file(path, rng):
    jformats.write_templates(path, (rng.random((10, 64)) * 0.9).astype(
        np.float32))
    return (path, 64)


def _span_file(path, rng):
    low = rng.integers(0, 30, (15, 3)).astype(np.int32)
    jformats.write_span_list(path, low, low + rng.integers(0, 30, (15, 3)))
    return (path,)


def _raw_file(path, rng):
    jformats.write_raw_histograms(path, rng.random((40, 32)).astype(
        np.float32))
    return (path, 40, 32)


READERS = {
    "read_codebook": _codebook_file,
    "read_templates": _templates_file,
    "read_span_list": _span_file,
    "read_raw_histograms": _raw_file,
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_reader_matches_python_readers(nat, tmp_path, rng, reader):
    args = READERS[reader](str(tmp_path / "f.bin"), rng)
    got = getattr(nat, reader)(*args)
    port = getattr(formats, reader)(*args)
    ref = getattr(jformats, reader)(*args)
    if isinstance(got, tuple):
        _assert_same(got, port)
        _assert_same(got, ref)
    else:
        np.testing.assert_array_equal(got, port)
        np.testing.assert_array_equal(got, ref)


def test_simple_histograms_match(nat, tmp_path, rng):
    nb = 64
    counts = rng.integers(1, 5, 12).astype(np.int32)
    bin_ids = np.zeros((12, nb), dtype=np.int32)
    freqs = np.zeros((12, nb), dtype=np.float32)
    for i in range(12):
        fr = rng.random(counts[i])
        bin_ids[i, :counts[i]] = rng.choice(nb, counts[i], replace=False)
        freqs[i, :counts[i]] = fr / fr.sum()
    lo = rng.integers(0, 60, (12, 3)).astype(np.int32)
    paths = [str(tmp_path / f) for f in ("sc.bin", "si.bin", "sf.bin")]
    jformats.write_simple_histograms(*paths, lo, lo + 1, bin_ids, freqs,
                                     counts)
    got = nat.read_simple_histograms(*paths, nb)
    _assert_same(got, formats.read_simple_histograms(*paths, nb))
    _assert_same(got, jformats.read_simple_histograms(*paths, nb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bins_major_load_matches(nat, tmp_path, dtype):
    """The transposing load is byte for byte the Python reader's (which
    rounds with torch) and the JAX package's (ml_dtypes)."""
    rng = np.random.default_rng(3)
    nz, ny, nx, B = 3, 4, 5, 8
    flat = rng.random((nz * ny * nx, B)).astype(np.float32)
    path = str(tmp_path / "hist.bin")
    flat.tofile(path)
    got = nat.read_histograms_bins_major(path, (nz, ny, nx), B, dtype=dtype)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (nz, B, ny, nx)
    assert torch.equal(got, formats.read_histograms_bins_major(
        path, (nz, ny, nx), B, dtype=dtype))
    ref = jformats.read_histograms_bins_major(path, (nz, ny, nx), B,
                                              dtype=dtype)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    view = torch.uint16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(got.view(view).numpy().view(bits),
                                  np.asarray(ref).view(bits))
    with pytest.raises(formats.FormatError, match="dtype"):
        nat.read_histograms_bins_major(path, (nz, ny, nx), B, dtype="int8")


def test_bins_major_rounds_specials_as_torch(nat, tmp_path):
    """bf16 rounding of infinities, ties, denormals and the largest finite
    values is torch's, bit for bit, over enough layers to split across
    threads; every NaN stays a NaN (torch's NaN bits differ by CPU path),
    the all-ones one included, which a bare round-to-nearest-even carries
    into -0."""
    nan_bits = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001], np.uint32)
    specials = np.array([*nan_bits.view(np.float32), np.inf, -np.inf, 0.0, -0.0,
                         np.finfo(np.float32).max, 1.00390625, 1.01171875,
                         -1.00390625, 3e-41], np.float32)
    nz, ny, nx, B = 9, 3, 7, 4
    rng = np.random.default_rng(5)
    flat = rng.standard_normal(nz * ny * nx * B).astype(np.float32)
    flat[rng.choice(flat.size, 4 * specials.size, replace=False)] = np.tile(
        specials, 4)
    path = str(tmp_path / "specials.bin")
    flat.tofile(path)
    got = nat.read_histograms_bins_major(path, (nz, ny, nx), B)
    ref = formats.read_histograms_bins_major(path, (nz, ny, nx), B)
    nan = torch.isnan(ref)
    assert int(nan.sum()) == 4 * nan_bits.size
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int16)[~nan],
                       ref.view(torch.int16)[~nan])


def _bad_templates(path):
    jformats.write_templates(path, np.array([[0.5, 1.5]], np.float32))
    return lambda m: m.read_templates(path, 2)


def _dup_codebook(path):
    jformats.write_codebook(
        path, np.asarray([[3, 5, 0, 2]], np.int32),
        np.asarray([[7, 7]], np.int32), np.asarray([[0.1, -0.1]], np.float32),
        np.asarray([0], np.int32))
    return lambda m: m.read_codebook(path, 32, 2)


def _truncated_raw(path):
    np.zeros(10, np.float32).tofile(path)
    return lambda m: m.read_raw_histograms(path, 4, 8)


def _truncated_bins_major(path):
    np.zeros(5 * 2 * 3 * 4 - 7, np.float32).tofile(path)
    return lambda m: m.read_histograms_bins_major(path, (5, 2, 3), 4)


def _missing_file(path):
    return lambda m: m.read_span_list(path + ".missing")


BAD = {"templates out of range": _bad_templates,
       "duplicate codebook bins": _dup_codebook,
       "truncated raw blob": _truncated_raw,
       "truncated bins-major blob": _truncated_bins_major,
       "missing file": _missing_file}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_errors(nat, tmp_path, case):
    """Malformed files raise FormatError from the native reader, as from
    the JAX package's native reader."""
    read = BAD[case](str(tmp_path / "bad.bin"))
    with pytest.raises(formats.FormatError):
        read(nat)
    if case != "missing file":  # the Python reader raises OSError there
        with pytest.raises(formats.FormatError):
            read(formats)


def test_ppm_matches_python(nat, tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(17, 23, 4), dtype=np.uint8)
    p_native, p_python = str(tmp_path / "n.ppm"), str(tmp_path / "p.ppm")
    nat.write_ppm(p_native, img)
    formats.write_ppm(p_python, img)
    assert open(p_native, "rb").read() == open(p_python, "rb").read()
    np.testing.assert_array_equal(nat.read_ppm(p_native),
                                  formats.read_ppm(p_python))
    ok, frac = nat.compare_ppm(img[..., :3], p_python)
    assert ok and frac == 0.0
    noisy = img[..., :3].astype(np.int32)
    noisy[::3, ::2] += 37
    noisy = np.clip(noisy, 0, 255).astype(np.uint8)
    assert nat.compare_ppm(noisy, p_python) == formats.compare_ppm(
        noisy, formats.read_ppm(p_python))
