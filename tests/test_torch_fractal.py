"""Port parity of the fractal family on the CPU: ``ops/sparse.py``,
``ops/fractal.py``, ``FractalHistogramVolume``, the seeded generators of
``io/synthetic.py`` and ``convert.fractal_state_from_jax`` against
``vrdd_tpu`` on the same numpy inputs.

Tolerances: the generators and the sparse densify are bitwise JAX's; the
decode is within 1e-6 abs of JAX's and of the generator's per-voxel loop
oracle (float32 sums in another order); the stats within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.io import synthetic as jsyn
from vrdd_tpu.models.volumes import FractalHistogramVolume as JFractal
from vrdd_tpu.ops.fractal import fractal_decode as j_decode
from vrdd_tpu.ops.fractal import fractal_decode_batch as j_decode_batch
from vrdd_tpu.ops.sparse import densify_sparse_histograms as j_densify
from vrdd_tpu_torch.convert import fractal_state_from_jax
from vrdd_tpu_torch.io import synthetic as tsyn
from vrdd_tpu_torch.models.volumes import (
    FractalHistogramVolume,
    compute_stats_volume,
)
from vrdd_tpu_torch.ops.fractal import fractal_decode, fractal_decode_batch
from vrdd_tpu_torch.ops.histogram import fractal_block_stats
from vrdd_tpu_torch.ops.sparse import densify_sparse_histograms

SHAPE = (3, 4, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def volume():
    """(port arrays, JAX arrays) of synthetic_fractal_volume, seed 3."""
    return (tsyn.synthetic_fractal_volume(SHAPE, seed=3),
            jsyn.synthetic_fractal_volume(SHAPE, seed=3))


def _rows(arrays):
    t, cb, eb, ev, expected = arrays
    cb = cb.reshape(-1, 4)
    return (t[cb[:, 0]], cb[:, 1], cb[:, 2], eb.reshape(len(cb), -1),
            ev.reshape(len(cb), -1), cb[:, 3], expected.reshape(len(cb), -1))


def test_synthetic_fractal_volume_is_jax_bitwise(volume):
    for got, ref in zip(*volume):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_decode_batch_matches_jax_and_oracle(volume):
    tmpl, shift, flip, eb, ev, ne, expected = _rows(volume[0])
    got = fractal_decode_batch(torch.from_numpy(tmpl), torch.from_numpy(shift),
                               torch.from_numpy(flip), torch.from_numpy(eb),
                               torch.from_numpy(ev), torch.from_numpy(ne))
    ref = np.asarray(j_decode_batch(*(jnp.asarray(a) for a in
                                      (tmpl, shift, flip, eb, ev, ne))))
    assert got.dtype == torch.float32 and tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-6)
    assert (ne > 0).any() and (flip == 1).any()  # not vacuous


@pytest.mark.parametrize("errors,renormalize", [(False, True), (True, False),
                                                (False, False)])
def test_decode_batch_options_match_jax(volume, errors, renormalize):
    tmpl, shift, flip, eb, ev, ne, _ = _rows(volume[0])
    extra = (eb, ev, ne) if errors else (None, None, None)
    got = fractal_decode_batch(
        *(None if a is None else torch.from_numpy(a)
          for a in (tmpl, shift, flip, *extra)), renormalize=renormalize)
    ref = j_decode_batch(
        *(None if a is None else jnp.asarray(a)
          for a in (tmpl, shift, flip, *extra)), renormalize=renormalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_decode_one_matches_jax(volume):
    tmpl, shift, flip, eb, ev, ne, expected = _rows(volume[0])
    i = int(np.argmax(ne))  # a row with errors
    got = fractal_decode(torch.from_numpy(tmpl[i]), int(shift[i]),
                         int(flip[i]), torch.from_numpy(eb[i]),
                         torch.from_numpy(ev[i]), int(ne[i]))
    ref = j_decode(jnp.asarray(tmpl[i]), jnp.asarray(shift[i]),
                   jnp.asarray(flip[i]), jnp.asarray(eb[i]),
                   jnp.asarray(ev[i]), jnp.asarray(ne[i]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), expected[i], atol=1e-6)


def test_repeated_and_out_of_range_error_bins_match_jax():
    """Two values for one bin land in its correction together before the
    clamp (JAX's one-hot contraction sums them); a bin id outside [0, n)
    adds nothing; padding past n_errors adds nothing."""
    rng = np.random.default_rng(0)
    tmpl = rng.random((4, 8)).astype(np.float32)
    eb = np.array([[2, 2, 5, 7], [1, 1, 1, 0], [9, -1, 3, 3],
                   [0, 0, 0, 0]], dtype=np.int32)
    ev = np.array([[-0.3, 0.1, 0.2, 0.05], [-2.0, 1.5, 0.4, 0.1],
                   [0.5, 0.5, -0.2, 0.3], [0.7, 0.7, 0.7, 0.7]],
                  dtype=np.float32)
    ne = np.array([4, 3, 4, 0], dtype=np.int32)
    shift = np.array([1, 0, 7, 3])
    flip = np.array([0, 1, 1, 0])
    args = (tmpl, shift, flip, eb, ev, ne)
    got = fractal_decode_batch(*(torch.from_numpy(a) for a in args))
    ref = np.asarray(j_decode_batch(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)


def test_densify_sparse_matches_jax_exactly():
    rng = np.random.default_rng(1)
    h, e, n_bins = 50, 6, 16
    ids = np.stack([rng.permutation(n_bins)[:e] for _ in range(h)]).astype(
        np.int32)
    freqs = rng.random((h, e)).astype(np.float32)
    counts = rng.integers(0, e + 1, size=h).astype(np.int32)
    got = densify_sparse_histograms(torch.from_numpy(ids),
                                    torch.from_numpy(freqs),
                                    torch.from_numpy(counts), n_bins)
    ref = np.asarray(j_densify(ids, freqs, counts, n_bins))
    assert got.dtype == torch.float32 and got.shape == (h, n_bins)
    np.testing.assert_array_equal(got.numpy(), ref)
    # numpy inputs work too
    np.testing.assert_array_equal(
        densify_sparse_histograms(ids, freqs, counts, n_bins).numpy(), ref)


def test_fractal_volume_matches_jax(volume):
    t, cb, eb, ev, expected = volume[0]
    jvol = JFractal(*(jnp.asarray(a) for a in (cb, eb, ev, t)))
    tvol = fractal_state_from_jax(jvol, "cpu")
    assert isinstance(tvol, FractalHistogramVolume)
    for k in ("codebook", "error_bins", "error_values", "templates"):
        np.testing.assert_array_equal(getattr(tvol, k).numpy(),
                                      np.asarray(getattr(jvol, k)))
    dec = tvol.decode()
    np.testing.assert_allclose(dec.numpy(), np.asarray(jvol.decode()),
                               atol=1e-6)
    np.testing.assert_allclose(dec.numpy(), expected, atol=1e-6)
    stats = compute_stats_volume(tvol).numpy()
    ref = np.asarray(jvol.stats_volume())
    np.testing.assert_allclose(stats, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    # the z-chunked stats are the whole decode's stats, bit for bit
    np.testing.assert_array_equal(stats, fractal_block_stats(dec).numpy())


def test_fractal_volume_chunks(volume, monkeypatch):
    """One z-layer per chunk gives the same decode and stats as one chunk."""
    t, cb, eb, ev, _ = volume[0]
    tvol = FractalHistogramVolume(*(torch.from_numpy(a)
                                    for a in (cb, eb, ev, t)))
    whole = (tvol.decode(), tvol.stats_volume())
    monkeypatch.setattr(FractalHistogramVolume, "_layer_step", lambda self: 1)
    for a, b in zip((tvol.decode(), tvol.stats_volume()), whole):
        assert torch.equal(a, b)


def test_fractal_volume_on_device_layout():
    """The card's full-size generator, here on the CPU: the layout and
    ranges of synthetic_fractal_volume, distinct error bins, the same
    arrays from the same seed."""
    out = tsyn.fractal_volume_on_device((5, 6, 7), seed=4, device="cpu")
    again = tsyn.fractal_volume_on_device((5, 6, 7), seed=4, device="cpu")
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    t, cb, eb, ev = out
    assert t.shape == (16, 32) and cb.shape == (5, 6, 7, 4)
    assert eb.shape == ev.shape == (5, 6, 7, 8)
    assert cb.dtype == eb.dtype == torch.int32
    np.testing.assert_allclose(t.sum(-1).numpy(), 1.0, rtol=1e-6)
    tid, shift, flip, ne = cb.reshape(-1, 4).T
    assert tid.max() < 16 and shift.max() < 32 and flip.max() <= 1
    assert ne.max() <= 8 and ne.min() >= 0
    for row_b, row_v, n in zip(eb.reshape(-1, 8), ev.reshape(-1, 8), ne):
        n = int(n)
        assert len(set(row_b[:n].tolist())) == n
        assert (row_v[:n].abs() <= 0.05).all() and (row_v[n:] == 0).all()
    dec = FractalHistogramVolume(cb, eb, ev, t).decode()
    np.testing.assert_allclose(dec.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_block_histograms_from_scalar_is_jax_bitwise():
    vol = jsyn.gaussian_blob_volume((16, 8, 12), seed=5)
    kw = dict(block_shape=(4, 2, 3), n_bins=16,
              vmax=float(vol.max()) + 1e-6)
    ref = jsyn.block_histograms_from_scalar(vol, **kw)
    got = tsyn.block_histograms_from_scalar(vol, **kw)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # a tensor (the encode CLI's, on any device) gives a tensor, same bits
    np.testing.assert_array_equal(
        tsyn.block_histograms_from_scalar(torch.from_numpy(vol), **kw).numpy(),
        ref)


def test_synthetic_flexible_dataset_is_jax_bitwise():
    got = tsyn.synthetic_flexible_dataset(dims=(6, 5, 4), seed=2)
    ref = jsyn.synthetic_flexible_dataset(dims=(6, 5, 4), seed=2)
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k == "volume_dim":
            assert tuple(got[k]) == tuple(ref[k])
            continue
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
