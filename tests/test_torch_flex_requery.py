"""The flexible-block explorer's re-query on the CPU: the resident integral
histogram (``IntegralVolume``) answers every block size as the plain
reference (``benchmark/reference/flex.py``, a ``bincount`` of the raw
field, no integral histogram) does, its block boundaries are
``divide_blocks``' rows, and a pipeline handed a new grid
(``RenderPipeline.set_flexible``) renders as a fresh one and keeps ESS
state for the current grid only.

Tolerances: counts exact (integers); stats within float32 rounding of the
reference's (the same float32 formula, summed in its own order); renders
bitwise."""

import numpy as np
import pytest
import torch

from benchmark.reference import flex as ref
from vrdd_tpu_torch.kernels import _build
from vrdd_tpu_torch.kernels import flex_blocks as fb
from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume, IntegralVolume
from vrdd_tpu_torch.models.pipeline import RenderPipeline
from vrdd_tpu_torch.models.volumes import RawHistogramVolume
from vrdd_tpu_torch.ops import integral as ti
from vrdd_tpu_torch.utils import profiling
from vrdd_tpu_torch.utils.config import (
    CameraConfig, QueryMethod, RenderConfig, TransferFunctionConfig)

SHAPE = (11, 13, 17)  # (z, y, x): no block size from 2 to 7 divides all three
BINS = 64
W = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def field():
    """A rough field in [0, 1]: every bin of 64 is reached."""
    g = torch.Generator().manual_seed(5)
    return torch.rand(SHAPE, generator=g)


@pytest.fixture(scope="module")
def integral(field):
    return IntegralVolume.from_raw(field, BINS, 0.0, 1.0)


def _grid_edges(dims_zyx, block):
    return [ti.block_edges(n, block) for n in dims_zyx]


@pytest.mark.parametrize("block", range(1, 8))
def test_blocks_match_the_plain_reference(field, integral, block):
    """Counts exactly, the stats grid to float32 rounding, at every block
    size from 1 to 7 (partial blocks on every axis from 2 on)."""
    want_counts = ref.block_counts(field, block, BINS, 0.0, 1.0)
    got_counts = ti.query_blocks(integral.sat, _grid_edges(SHAPE, block))
    assert got_counts.dtype == torch.float32
    assert torch.equal(got_counts.to(torch.int64), want_counts)
    vol = integral.blocks(block)
    assert vol.block_size == block and vol.volume_dim == SHAPE[::-1]
    assert vol.n_blocks == tuple(want_counts.shape[:3])
    want = ref.block_stats(want_counts, torch.float32)
    scale = want.abs().reshape(-1, 3).amax(0)
    np.testing.assert_allclose((vol.stats_grid / scale).numpy(),
                               (want / scale).numpy(), rtol=0, atol=2e-7)
    norm = vol.normalized().stats_grid
    np.testing.assert_allclose(norm.numpy(), ref.min_max(want).numpy(),
                               rtol=0, atol=1e-6)


def test_flex_blocks_binding(integral):
    """The kernel's source is built, and its ctypes binding has one type
    per parameter of the C entry; its wrapper refuses a table off the card
    (the card tests hold it to the CPU's re-query)."""
    import ctypes
    import re

    src = _build.CSRC / "flex_blocks.cu"
    assert src in _build.SOURCES
    m = re.search(r"\bvrdd_flex_blocks\(([^)]*)\)", src.read_text())
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = _build.FLEX_BLOCKS_ARGTYPES
    assert len(params) == len(types) == 13, params
    for decl, t in zip(params, types):
        if "*" in decl:
            assert t is ctypes.c_void_p, decl
        elif decl.startswith("long long"):
            assert t is ctypes.c_longlong, decl
        elif decl.startswith("float"):
            assert t is ctypes.c_float, decl
        else:
            assert decl.startswith("int ") and t is ctypes.c_int, decl
    with pytest.raises(ValueError, match="card"):
        fb.block_stats(integral.sat, _grid_edges(SHAPE, 3))


def test_from_raw_is_one_requery(field, integral):
    """``FlexibleBlockVolume.from_raw`` is the integral histogram and one
    re-query: the same grid, with its stage timings."""
    got = FlexibleBlockVolume.from_raw(field, 3, BINS, 0.0, 1.0)
    assert torch.equal(got.stats_grid, integral.blocks(3).stats_grid)
    assert set(got.timings) == {"divide_blocks", "integral_histogram",
                                "query_blocks", "compute_block_stats"}
    assert integral.blocks(3).timings is None


@pytest.mark.parametrize("dims", [(7, 11, 13), (16, 16, 16), (5, 9, 4)])
@pytest.mark.parametrize("block", [1, 2, 3, 4, 5, 16])
def test_device_corners_are_divide_blocks(dims, block):
    """The boundaries ``block_edges`` makes, broadcast over the three axes
    in ``divide_blocks``' order (x fastest), are its rows, row for row
    (1-indexed inclusive)."""
    nx, ny, nz = dims
    ez, ey, ex = (ti.block_edges(n, block).numpy() for n in (nz, ny, nx))
    rows = [(xl + 1, yl + 1, zl + 1, xh, yh, zh)
            for zl, zh in zip(ez[:-1], ez[1:])
            for yl, yh in zip(ey[:-1], ey[1:])
            for xl, xh in zip(ex[:-1], ex[1:])]
    np.testing.assert_array_equal(np.asarray(rows, np.int32),
                                  ti.divide_blocks(dims, block))


def test_requery_counts_its_work(integral):
    """One re-query counts itself, its blocks and the distinct corner rows
    of the integral histogram it reads, in the tracer."""
    profiling.enable()
    try:
        integral.blocks(4)
    finally:
        profiling.disable()
    spans, counters = profiling.drain()
    names = [s.name for s in spans]
    assert names == ["flex.requery", "flex.corners", "flex.query",
                     "flex.stats"]
    nb = [-(-n // 4) for n in SHAPE]
    assert counters["flex.requeries"] == 1
    assert counters["flex.blocks"] == int(np.prod(nb))
    assert counters["flex.corner_rows"] == int(np.prod([n + 1 for n in nb]))


def _cfg(query):
    return RenderConfig(camera=CameraConfig(width=W, height=W), density=0.5,
                        query_method=QueryMethod(query),
                        tf=TransferFunctionConfig(offset=0.02, scale=1.1))


@pytest.mark.parametrize("renderer", ["slice", "pallas"])
def test_set_flexible_renders_as_a_fresh_pipeline(integral, renderer):
    """After any swaps, a pipeline renders queries 8/9/0 bitwise as a
    fresh pipeline built on the same grid ('pallas' is K1's plain version
    with ESS here)."""
    pipe = RenderPipeline(flexible=integral.blocks(2).normalized())
    for block in (5, 3, 6):
        for q in (8, 9, 0):
            pipe.render(None, _cfg(q), renderer)
        pipe.set_flexible(integral.blocks(block).normalized())
    fresh = RenderPipeline(flexible=integral.blocks(6).normalized())
    for q in (8, 9, 0):
        got = pipe.render(None, _cfg(q), renderer, as_uint8=True)
        want = fresh.render(None, _cfg(q), renderer, as_uint8=True)
        assert torch.equal(got, want)
        assert int(want[..., 3].max()) > 0, "vacuous: empty frame"


def test_ess_cache_stays_bounded_over_swaps(integral):
    """20 swaps leave ESS entries for the current grid's channels only; the
    raw channel's entry and its stats volume survive every swap."""
    rng = np.random.default_rng(3)
    hist = torch.from_numpy(rng.dirichlet(np.ones(32), size=(4, 6, 6))
                            .astype(np.float32))
    pipe = RenderPipeline(raw=RawHistogramVolume(hist),
                          flexible=integral.blocks(2).normalized())
    pipe.render(None, _cfg(1), "pallas")
    raw_vol = pipe._stats_channel(QueryMethod.RAW_MEAN)
    raw_keys = set(pipe._ess_cache)
    for k in range(20):
        for q in (8, 9, 0):
            pipe.render(None, _cfg(q), "pallas")
        assert len(pipe._ess_cache) == 1 + 3
        pipe.set_flexible(integral.blocks(2 + k % 6).normalized())
        assert set(pipe._ess_cache) == raw_keys
        assert pipe._flex_padded is None
    assert pipe._stats_channel(QueryMethod.RAW_MEAN) is raw_vol
    current = {id(pipe._stats_channel(QueryMethod(q))) for q in (8, 9, 0)}
    pipe.render(None, _cfg(9), "pallas")
    flex_entries = [e for k, e in pipe._ess_cache.items() if k not in raw_keys]
    assert [id(e[0]) for e in flex_entries] == [
        id(pipe._stats_channel(QueryMethod.FLEX_MEAN))]
    assert id(flex_entries[0][0]) in current
