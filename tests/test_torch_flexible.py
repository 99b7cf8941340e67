"""Port parity of the flexible blocks on the CPU: ``ops/integral.py``,
``FlexibleBlockVolume`` (``from_raw``, ``from_codebooks``, ``normalized``,
``stat_ranges``), ``flex_sample_fn`` and ``convert.flexible_state_from_jax``
against ``vrdd_tpu`` on the same numpy inputs.

Tolerances: the integral histogram, the block query and the Fenwick helpers
are exact (int32 counts, against JAX's float32 values, which are exact
integers at these sizes; integer index arrays); the stats grids
within 1e-5 (relative to each channel's range) of JAX's; the codebook path
against the raw path as tests/test_flexible.py holds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.io.synthetic import synthetic_flexible_dataset
from vrdd_tpu.models.flexible import FlexibleBlockVolume as JFlex
from vrdd_tpu.models.renderer import flex_sample_fn as j_flex_sample_fn
from vrdd_tpu.ops import integral as ji
from vrdd_tpu_torch.convert import flexible_state_from_jax
from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume
from vrdd_tpu_torch.models.renderer import flex_sample_fn
from vrdd_tpu_torch.ops import integral as ti

DIMS = (7, 11, 13)  # (x, y, z): blocks of 3 leave partial blocks on each axis
CODEBOOK_KEYS = ("fractal_spans", "fractal_codebook", "fractal_error_bins",
                 "fractal_error_values", "templates", "simple_spans",
                 "simple_bin_ids", "simple_freqs", "simple_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset():
    return synthetic_flexible_dataset(dims=DIMS, seed=4)


def _close(got, ref, tol=1e-5):
    """Per channel: within ``tol`` of the channel's range."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.maximum(np.abs(ref).reshape(-1, ref.shape[-1]).max(0), 1e-30)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


def test_integral_histogram_is_jax_exactly():
    rng = np.random.default_rng(0)
    raw = rng.uniform(-20.0, 280.0, size=(5, 6, 7)).astype(np.float32)
    for vmin, vmax, nb in ((0.0, 255.0, 64), (10.0, 200.0, 16)):
        oh = ti.onehot_bin_volume(torch.from_numpy(raw), nb, vmin, vmax)
        np.testing.assert_array_equal(
            oh.numpy(), np.asarray(ji.onehot_bin_volume(jnp.asarray(raw), nb,
                                                        vmin, vmax)))
        sat = ti.integral_histogram(raw, nb, vmin, vmax)
        ref = np.asarray(ji.integral_histogram(jnp.asarray(raw), nb, vmin,
                                               vmax))
        assert sat.dtype == torch.int32 and tuple(sat.shape) == ref.shape
        np.testing.assert_array_equal(sat.numpy(), ref)
        low = rng.integers(0, 4, size=(30, 3))
        high = np.minimum(low + rng.integers(0, 4, size=(30, 3)), [4, 5, 6])
        got = ti.query_block_histogram(sat, low, high)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ji.query_block_histogram(
                jnp.asarray(ref), jnp.asarray(low), jnp.asarray(high))))


def test_block_query_equals_direct_count():
    """Every 2 x 3 x 2 block's counts against a direct count (exact)."""
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(6, 9, 8)).astype(np.float32)
    sat = ti.integral_histogram(raw, 16, 0.0, 256.0)
    zz, yy, xx = np.meshgrid(np.arange(3) * 2, np.arange(3) * 3,
                             np.arange(4) * 2, indexing="ij")
    low = np.stack([zz, yy, xx], -1).reshape(-1, 3)
    got = ti.query_block_histogram(sat, low, low + [1, 2, 1]).numpy()
    bins = np.clip((raw / 256.0 * 16).astype(np.int64), 0, 15)
    for (z, y, x), g in zip(low, got):
        direct = np.bincount(bins[z:z + 2, y:y + 3, x:x + 2].ravel(),
                             minlength=16)
        np.testing.assert_array_equal(g, direct)


def test_counts_past_2_to_the_24_are_exact():
    """One bin holding 257^3 = 16,974,593 voxels, odd and above 2^24, so no
    float32 holds it: the table counts it exactly, and blocks of 2 (their
    prefix boxes past 2^24 at the far corner, the last block a single
    voxel) count every voxel exactly, by both queries."""
    n = 257
    sat = ti.integral_histogram(torch.zeros((n, n, n)), 1, 0.0, 1.0)
    assert int(sat[-1, -1, -1, 0]) == n ** 3 == 16_974_593
    edges = [ti.block_edges(n, 2) for _ in range(3)]
    got = ti.query_blocks(sat, edges)[..., 0]
    side = torch.tensor([2.0] * 128 + [1.0])
    want = side[:, None, None] * side[None, :, None] * side[None, None, :]
    assert torch.equal(got, want)
    corner = ti.query_block_histogram(sat, [[n - 1] * 3], [[n - 1] * 3])
    assert float(corner[0, 0]) == 1.0


def test_fenwick_helpers_are_jax_exactly():
    for x in (0, 1, 5, 13, 64):
        assert ti.fenwick_spans(x) == ji.fenwick_spans(x)
    for corner in ((5, 3, 2), (0, 4, 4), (13, 11, 7)):
        np.testing.assert_array_equal(ti.prefix_box_decomposition(corner),
                                      ji.prefix_box_decomposition(corner))
    span = np.array([2, 3, 1, 5, 7, 4])
    assert ti.block_corner_prefixes(span) == ji.block_corner_prefixes(span)
    np.testing.assert_array_equal(ti.divide_blocks(DIMS, 3),
                                  ji.divide_blocks(DIMS, 3))
    spans = ti.all_fenwick_triples(DIMS)
    np.testing.assert_array_equal(spans, ji.all_fenwick_triples(DIMS))
    np.testing.assert_array_equal(ti.span_sizes(spans), ji.span_sizes(spans))
    vals = np.arange(0, 40)
    np.testing.assert_array_equal(ti.fenwick_high_table(vals, 6),
                                  ji.fenwick_high_table(vals, 6))
    with pytest.raises(ValueError, match="n_levels"):
        ti.fenwick_high_table(vals, 2)
    np.testing.assert_array_equal(ti.build_span_lookup(spans, DIMS),
                                  ji.build_span_lookup(spans, DIMS))
    blocks = ti.divide_blocks(DIMS, 3)
    for got, ref in zip(ti.block_prefix_entries(blocks, DIMS),
                        ji.block_prefix_entries(blocks, DIMS)):
        np.testing.assert_array_equal(got, ref)
    assert ti.build_span_index(spans[:50]) == ji.build_span_index(spans[:50])


@pytest.mark.parametrize("block", [3, 4])
def test_from_raw_matches_jax(dataset, block):
    raw = dataset["raw"]
    got = FlexibleBlockVolume.from_raw(torch.from_numpy(raw),
                                       block_size=block, vmax=256.0)
    ref = JFlex.from_raw(raw, block_size=block, vmax=256.0)
    assert got.n_blocks == tuple(ref.n_blocks)
    assert got.volume_dim == ref.volume_dim == DIMS
    _close(got.stats_grid.numpy(), ref.stats_grid)
    assert set(got.timings) == set(ref.timings)
    # the construction runs on the volume's device
    assert got.stats_grid.device == torch.device("cpu")


def test_from_codebooks_matches_jax_and_raw(dataset):
    kw = {k: dataset[k] for k in CODEBOOK_KEYS}
    got = FlexibleBlockVolume.from_codebooks(volume_dim=DIMS, block_size=3,
                                             device="cpu", **kw)
    ref = JFlex.from_codebooks(volume_dim=DIMS, block_size=3, **kw)
    _close(got.stats_grid.numpy(), ref.stats_grid)
    assert set(got.timings) == set(ref.timings)
    via_raw = FlexibleBlockVolume.from_raw(torch.from_numpy(dataset["raw"]),
                                           block_size=3, vmax=256.0)
    np.testing.assert_allclose(got.stats_grid.numpy(),
                               via_raw.stats_grid.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_constructors_default_to_the_card(dataset):
    """A numpy volume and the codebooks go to the card unless the caller
    asks for the CPU (a CPU tensor, ``device="cpu"``)."""
    kw = {k: dataset[k] for k in CODEBOOK_KEYS}
    calls = (
        lambda: FlexibleBlockVolume.from_raw(dataset["raw"], block_size=3,
                                             vmax=256.0),
        lambda: FlexibleBlockVolume.from_codebooks(volume_dim=DIMS,
                                                   block_size=3, **kw),
    )
    for call in calls:
        if torch.cuda.is_available():
            assert call().stats_grid.is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_from_codebooks_missing_span_raises(dataset):
    kw = {k: dataset[k] for k in CODEBOOK_KEYS}
    n = len(kw["fractal_spans"])
    keep = np.arange(n) != n // 2
    for k in ("fractal_spans", "fractal_codebook", "fractal_error_bins",
              "fractal_error_values"):
        kw[k] = kw[k][keep]
    with pytest.raises(KeyError, match="missing from codebooks"):
        FlexibleBlockVolume.from_codebooks(volume_dim=DIMS, block_size=3,
                                           device="cpu", **kw)


def test_normalized_and_stat_ranges_match_jax(dataset):
    ref = JFlex.from_raw(dataset["raw"], block_size=3, vmax=256.0)
    got = flexible_state_from_jax(ref, "cpu")
    assert isinstance(got, FlexibleBlockVolume)
    np.testing.assert_array_equal(got.stats_grid.numpy(),
                                  np.asarray(ref.stats_grid))
    assert got.block_size == 3 and got.volume_dim == DIMS
    np.testing.assert_array_equal(got.stat_ranges(), ref.stat_ranges())
    norm, jnorm = got.normalized(), ref.normalized()
    np.testing.assert_allclose(norm.stats_grid.numpy(),
                               np.asarray(jnorm.stats_grid), rtol=1e-6,
                               atol=1e-7)
    r = norm.stat_ranges()
    np.testing.assert_allclose(r[:2], [[0.0, 1.0], [0.0, 1.0]], atol=1e-6)
    np.testing.assert_array_equal(r[2], got.stat_ranges()[2])  # entropy kept
    # a constant channel maps to 0
    flat = FlexibleBlockVolume(torch.ones((2, 2, 2, 3)), 2, (4, 4, 4))
    assert float(flat.normalized().stats_grid[..., :2].abs().max()) == 0.0


@pytest.mark.parametrize("channel", [0, 1, 2])
def test_flex_sample_fn_matches_jax(dataset, channel):
    grid = JFlex.from_raw(dataset["raw"], block_size=3, vmax=256.0).stats_grid
    p01 = np.random.default_rng(channel).uniform(-0.1, 1.1, size=(500, 3)
                                                 ).astype(np.float32)
    got = flex_sample_fn(torch.from_numpy(np.array(grid)), channel)(
        torch.from_numpy(p01))
    ref = np.asarray(j_flex_sample_fn(grid, channel)(jnp.asarray(p01)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
