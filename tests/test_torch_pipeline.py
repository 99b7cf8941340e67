"""Port parity: vrdd_tpu_torch.models.{volumes,renderer,pipeline} against
vrdd_tpu.models on the same volumes, on the CPU, plus the golden fixtures
of tests/test_golden.py (raw queries and query 9) rendered by the port.

Queries 1/2/3/7: JAX's ``pallas`` renderer runs under the Pallas TPU
interpreter, as tests/test_golden.py runs it. Queries 4/5/6 (fractal) and
8/9/0 (flexible blocks): JAX's ``scan``, ``slice`` and ``shearwarp``
renderers, no interpreter; the port's ``pallas`` and ``auto`` (its plain
version on the CPU, with empty-space skipping on, the default) are held
against JAX's ``slice``. Images must match within 1e-4 absolute on all but
0.1% of pixels (cutoff flips)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.io.synthetic import (
    random_histogram_volume,
    synthetic_flexible_dataset,
    synthetic_fractal_volume,
)
from vrdd_tpu.models.flexible import FlexibleBlockVolume as JFlex
from vrdd_tpu.models.pipeline import RenderPipeline as JPipeline
from vrdd_tpu.models.volumes import FractalHistogramVolume as JFractal
from vrdd_tpu.models.volumes import RawHistogramVolume as JRaw
from vrdd_tpu.utils.config import CameraConfig as JCamera
from vrdd_tpu.utils.config import RenderConfig as JRenderConfig
from vrdd_tpu.utils.config import TransferFunctionConfig as JTF
from vrdd_tpu_torch.convert import (
    flexible_state_from_jax,
    fractal_state_from_jax,
    pipeline_state_from_jax,
)
from vrdd_tpu_torch.core.geometry import (
    default_benchmark_inv_view,
    inv_view_from_rotation_translation,
)
from vrdd_tpu_torch.core.image import rgba_to_uint8
from vrdd_tpu_torch.io import formats
from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume
from vrdd_tpu_torch.models.pipeline import RenderPipeline
from vrdd_tpu_torch.models.volumes import (
    RawHistogramVolume,
    ScalarVolume,
    compute_stats_volume,
)
from vrdd_tpu_torch.ops.histogram import (
    flex_block_stats,
    fractal_block_stats,
    normalize_histogram,
    raw_block_stats,
)
from vrdd_tpu_torch.utils.config import (
    CameraConfig,
    QueryMethod,
    RenderConfig,
    TransferFunctionConfig,
)

GOLDEN = pathlib.Path(__file__).parent / "golden"
W = H = 32
QUERIES = [1, 2, 3, 7]
RENDERERS = ["scan", "slice", "pallas", "auto"]
ROT = inv_view_from_rotation_translation(30.0, 0.0, (0.0, 0.0, -4.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: TF scales that put each query's values on the LUT's ramp: the raw and
#: fractal variance is wide; the flexible mean and variance are in raw
#: bin-domain units (volumeRender_kernel.cu:1091)
TF_SCALE = {2: 0.25, 5: 0.25, 9: 1.0 / 255.0, 0: 1.0 / 2000.0}


def _cfg(query, jax=False, width=W, density=0.5):
    scale = TF_SCALE.get(query, 1.0)
    if jax:
        return JRenderConfig(camera=JCamera(width=width, height=width),
                             density=density, query_method=query,
                             tf=JTF(scale=scale))
    return RenderConfig(camera=CameraConfig(width=width, height=width),
                        density=density, query_method=QueryMethod(query),
                        tf=TransferFunctionConfig(scale=scale))


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline, state) on the same raw histograms."""
    hist = random_histogram_volume((6, 10, 10), n_bins=32, seed=7)
    jp = JPipeline(raw=JRaw(jnp.asarray(hist)))
    state = pipeline_state_from_jax(jp, "cpu")
    tp = RenderPipeline(raw=RawHistogramVolume(state["histograms"]),
                        tf_lut=state["tf_lut"])
    return jp, tp, state


@pytest.fixture(scope="module")
def jax_images(pipelines):
    """JAX renders, memoized per (query, resolved renderer)."""
    jp = pipelines[0]
    cache = {}

    def get(query, renderer):
        cfg = _cfg(query, jax=True)
        renderer = jp.resolve_renderer(renderer, default_benchmark_inv_view(),
                                       cfg)
        if (query, renderer) not in cache:
            if renderer == "pallas":
                with pltpu.force_tpu_interpret_mode():
                    img = np.asarray(jp.render(None, cfg, renderer))
            else:
                img = np.asarray(jp.render(None, cfg, renderer))
            cache[query, renderer] = img
        return cache[query, renderer]

    return get


def test_stats_volume_matches_jax(pipelines):
    _, tp, state = pipelines
    ref = state["raw_stats"].numpy()
    np.testing.assert_allclose(tp.raw_stats.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    hist = state["histograms"]
    np.testing.assert_array_equal(
        compute_stats_volume(RawHistogramVolume(hist)).numpy(),
        raw_block_stats(hist).numpy())
    assert "basic_data_processing/raw" in tp.timings


def test_histogram_ops_match_jax():
    from vrdd_tpu.ops import histogram as jh

    rng = np.random.default_rng(3)
    h = rng.gamma(0.5, size=(5, 7, 32)).astype(np.float32)
    h[0, 0] = 0.0  # an empty histogram: entropy 0, no NaN
    h64 = rng.gamma(0.5, size=(4, 64)).astype(np.float32) * 3.0 - 0.5
    for tf_, jf, x in ((raw_block_stats, jh.raw_block_stats, h),
                       (fractal_block_stats, jh.fractal_block_stats, h),
                       (flex_block_stats, jh.flex_block_stats, h64)):
        got, ref = tf_(torch.from_numpy(x)).numpy(), np.asarray(jf(
            jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
    got = raw_block_stats(torch.from_numpy(h), channels=(2, 0))
    np.testing.assert_array_equal(got.numpy(), raw_block_stats(
        torch.from_numpy(h)).numpy()[..., [2, 0]])
    for g, r in zip(normalize_histogram(torch.from_numpy(h64)),
                    jh.normalize_histogram(jnp.asarray(h64))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    vol = rng.random((3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        ScalarVolume(torch.from_numpy(vol)).stats_volume().numpy()[..., 0],
        vol)


def test_interp_mean_volume_matches_jax(pipelines):
    from vrdd_tpu.models.renderer import interp_mean_volume as j_imv

    jp, tp, _ = pipelines
    got = tp._stats_channel(QueryMethod.INTERP_MEAN).numpy()
    ref = np.asarray(j_imv(jp.raw.histograms))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("query", QUERIES)
def test_render_matches_jax(pipelines, jax_images, query, renderer):
    _, tp, _ = pipelines
    got = tp.render(None, _cfg(query), renderer).numpy()
    ref = jax_images(query, renderer)
    assert got.shape == ref.shape == (H, W, 4)
    assert ref[..., 3].max() > 0.01, "vacuous: empty render"
    bad = (np.abs(got - ref) > 1e-4).any(-1)
    assert bad.mean() <= 1e-3, (bad.mean(), np.abs(got - ref).max())


def test_render_packs_uint8(pipelines):
    _, tp, _ = pipelines
    f = tp.render(None, _cfg(1), "slice")
    u8 = tp.render(None, _cfg(1), "slice", as_uint8=True)
    rgb = tp.render(None, _cfg(1), "slice", as_uint8=True, channels=3)
    assert u8.dtype == torch.uint8 and tuple(rgb.shape) == (H, W, 3)
    assert torch.equal(u8, rgba_to_uint8(f)) and torch.equal(rgb, u8[..., :3])
    with pytest.raises(ValueError, match="channels"):
        tp.render(None, _cfg(1), "slice", channels=3)


#: the raw-histogram fixtures of tests/test_golden.py
GOLDEN_CASES = [("scan_q1", 1, "scan"), ("scan_q3", 3, "scan"),
                ("scan_q7", 7, "scan"), ("slice_q1", 1, "slice"),
                ("pallas_q1", 1, "pallas")]


@pytest.fixture(scope="module")
def golden_pipeline():
    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    return RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(hist)))


@pytest.mark.parametrize("name,query,renderer", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_fixture(golden_pipeline, name, query, renderer):
    cfg = RenderConfig(camera=CameraConfig(width=128, height=128),
                       density=0.5, query_method=QueryMethod(query))
    img = golden_pipeline.render(None, cfg, renderer, as_uint8=True).numpy()
    ref = formats.read_ppm(str(GOLDEN / f"{name}_128.ppm"))
    ok, outliers = formats.compare_ppm(img[..., :3], ref)
    assert ok, f"{name}: {outliers:.1%} pixels beyond epsilon"


def test_resolve_renderer(pipelines):
    _, tp, _ = pipelines
    iv = default_benchmark_inv_view()
    for q in (1, 2, 3, 7):
        assert tp.resolve_renderer("auto", iv, _cfg(q)) == "slice"  # CPU
        for r in ("scan", "slice", "pallas"):
            assert tp.resolve_renderer(r, iv, _cfg(q)) == r
    point = RenderConfig(query_method=QueryMethod.RAW_MEAN,
                         filter_linear=False)
    assert tp.resolve_renderer("auto", ROT, point) == "scan"
    # rotated views ride the shear-warp sweep (tests/test_torch_shearwarp.py
    # holds its frames against JAX's)
    for q in (1, 2, 3, 7):
        assert tp.resolve_renderer("auto", ROT, _cfg(q)) == "shearwarp"
    img = tp.render(ROT, _cfg(1), "shearwarp")
    assert tuple(img.shape) == (H, W, 4) and torch.isfinite(img).all()


def test_ess_stats_cache_contract(pipelines):
    """A hit needs the SAME tensor object: a new volume is a miss, even when
    a stale entry sits under its id() (as after the old tensor was freed and
    its id reused)."""
    _, tp, _ = pipelines
    cfg = _cfg(1)
    vol = tp._stats_channel(QueryMethod.RAW_MEAN)
    assert tp._stats_channel(QueryMethod.RAW_MEAN) is vol  # memoized
    s1 = tp._ess_stats(vol, cfg)
    assert tp._ess_stats(vol, cfg) is s1
    other = vol.clone()
    s2 = tp._ess_stats(other, cfg)
    assert s2 is not s1
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    stale = (torch.zeros(1), torch.zeros(1))
    key = (id(other), 64, 0.5, 1.0, cfg.march.box_min, cfg.march.box_max)
    tp._ess_cache[key] = (vol, stale)  # id(other) -> another tensor's entry
    s3 = tp._ess_stats(other, cfg)
    assert s3 is not stale and tuple(s3[0].shape) == (64, 8, 8)


@pytest.fixture(scope="module")
def families():
    """(JAX pipeline, port pipeline) holding a fractal volume (6 x 10 x 10
    blocks) and a flexible-block volume (blocks of 3 over a 7 x 11 x 13 raw
    volume: an unaligned 5 x 4 x 3 (z, y, x) grid, zero-padded to 6 x 5 x 4), carried over with
    convert.py."""
    t, cb, eb, ev, _ = synthetic_fractal_volume((6, 10, 10), seed=8)
    ds = synthetic_flexible_dataset(dims=(7, 11, 13), seed=6)
    jfrac = JFractal(*(jnp.asarray(a) for a in (cb, eb, ev, t)))
    jflex = JFlex.from_raw(ds["raw"], block_size=3, vmax=256.0)
    jp = JPipeline(fractal=jfrac, flexible=jflex)
    tp = RenderPipeline(fractal=fractal_state_from_jax(jfrac, "cpu"),
                        flexible=flexible_state_from_jax(jflex, "cpu"))
    return jp, tp


FAMILY_QUERIES = [4, 5, 6, 8, 9, 0]


@pytest.fixture(scope="module")
def family_images(families):
    jp = families[0]
    cache = {}

    def get(query, renderer):
        if (query, renderer) not in cache:
            iv = ROT if renderer == "shearwarp" else None
            cache[query, renderer] = np.asarray(
                jp.render(iv, _cfg(query, jax=True), renderer))
        return cache[query, renderer]

    return get


def test_fractal_stats_match_jax(families):
    jp, tp = families
    ref = np.asarray(jp.fractal_stats)
    np.testing.assert_allclose(tp.fractal_stats.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    assert "basic_data_processing/fractal" in tp.timings
    assert tp.raw_stats is None and tp.raw is None


@pytest.mark.parametrize("renderer", ["scan", "slice", "shearwarp", "pallas",
                                      "auto"])
@pytest.mark.parametrize("query", FAMILY_QUERIES)
def test_family_render_matches_jax(families, family_images, query, renderer):
    _, tp = families
    iv = ROT if renderer == "shearwarp" else None
    got = tp.render(iv, _cfg(query), renderer).numpy()
    ref = family_images(query, renderer if renderer in (
        "scan", "slice", "shearwarp") else "slice")
    assert got.shape == ref.shape == (H, W, 4)
    assert ref[..., 3].max() > 0.01, "vacuous: empty render"
    bad = (np.abs(got - ref) > 1e-4).any(-1)
    assert bad.mean() <= 1e-3, (bad.mean(), np.abs(got - ref).max())


def test_flex_channel_scale_and_ess_key(families):
    """The object-order flex channel is the zero-padded grid with JAX's
    filter-grid scales; its ESS plane stats are keyed and computed with the
    z scale (a different z scale is a different entry)."""
    jp, tp = families
    q = QueryMethod.FLEX_MEAN
    vol = tp._stats_channel(q)
    assert tp._stats_channel(q) is vol
    np.testing.assert_array_equal(vol.numpy(),
                                  np.asarray(jp._stats_channel(q)))
    assert tuple(vol.shape) == (6, 5, 4)
    assert tp._flex_axis_scale(q) == jp._flex_axis_scale(q) == (
        3 / 4, 4 / 5, 5 / 6)
    assert tp._flex_axis_scale(QueryMethod.RAW_MEAN) == (1.0, 1.0, 1.0)
    stats = tp._ess_stats(vol, _cfg(9))
    keys = [k for k in tp._ess_cache if k[0] == id(vol)]
    assert [k[3] for k in keys] == [5 / 6]
    from vrdd_tpu_torch.kernels.slice_kernel import precompute_ess_stats

    unscaled = precompute_ess_stats(vol, n_planes=64, dz_sign=-1)
    assert not all(torch.equal(a, b) for a, b in zip(stats, unscaled))


def test_family_resolve_renderer_and_missing_volumes(families, pipelines):
    _, tp = families
    iv = default_benchmark_inv_view()
    for q in FAMILY_QUERIES:
        assert tp.resolve_renderer("auto", iv, _cfg(q)) == "slice"  # CPU
        assert tp.resolve_renderer("auto", ROT, _cfg(q)) == "shearwarp"
    point = RenderConfig(query_method=QueryMethod.FLEX_MEAN,
                         filter_linear=False)
    assert tp.resolve_renderer("auto", ROT, point) == "scan"
    # flex queries always filter linearly: point filtering changes nothing
    np.testing.assert_array_equal(
        tp.render(None, point, "slice").numpy(),
        tp.render(None, RenderConfig(query_method=QueryMethod.FLEX_MEAN),
                  "slice").numpy())
    raw_only = pipelines[1]
    assert raw_only.resolve_renderer("auto", iv, _cfg(9)) == "scan"
    for q, what in ((4, "fractal"), (9, "flexible"), (0, "flexible")):
        with pytest.raises(ValueError, match=what):
            raw_only.render(None, _cfg(q), "scan")
        with pytest.raises(ValueError, match=what):
            raw_only.render(None, _cfg(q), "slice")
    with pytest.raises(ValueError, match="raw"):
        tp.render(None, _cfg(1), "scan")
    with pytest.raises(ValueError, match="query 7"):
        tp.render(None, _cfg(7), "slice")


def test_flexible_pipeline_timings(families):
    _, tp = families
    flex = FlexibleBlockVolume.from_raw(torch.from_numpy(
        synthetic_flexible_dataset(dims=(7, 11, 13), seed=6)["raw"]),
        block_size=3, vmax=256.0)
    p = RenderPipeline(flexible=flex)
    assert {k.split("/")[0] for k in p.timings} == {"data_processing"}
    assert "data_processing/integral_histogram" in p.timings
    np.testing.assert_allclose(flex.stats_grid.numpy(),
                               tp.flexible.stats_grid.numpy(), rtol=1e-5,
                               atol=1e-5)


#: the query-9 fixtures of tests/test_golden.py; the port's 'pallas' is
#: its plain version here
GOLDEN_Q9 = [("scan_q9", "scan"), ("pallas_q9", "pallas"),
             ("shearwarp_q9", "shearwarp")]


@pytest.fixture(scope="module")
def golden_q9_pipeline():
    """tests/test_golden.py's pipeline, built by the port."""
    from vrdd_tpu_torch.io.synthetic import synthetic_flexible_dataset as tds

    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    ds = tds(dims=(8, 8, 8), seed=9)
    return RenderPipeline(
        raw=RawHistogramVolume(torch.from_numpy(hist)),
        flexible=FlexibleBlockVolume.from_raw(torch.from_numpy(ds["raw"]),
                                              block_size=3, vmax=256.0))


@pytest.mark.parametrize("name,renderer", GOLDEN_Q9,
                         ids=[c[0] for c in GOLDEN_Q9])
def test_golden_q9_fixture(golden_q9_pipeline, name, renderer):
    cfg = RenderConfig(camera=CameraConfig(width=128, height=128),
                       density=0.5, query_method=QueryMethod.FLEX_MEAN,
                       tf=TransferFunctionConfig(scale=1.0 / 255.0))
    iv = (inv_view_from_rotation_translation(15.0, 10.0, (0.0, 0.0, -4.0))
          if renderer == "shearwarp" else None)
    img = golden_q9_pipeline.render(iv, cfg, renderer, as_uint8=True).numpy()
    assert img[..., :3].max() > 0, "vacuous: black render"
    ref = formats.read_ppm(str(GOLDEN / f"{name}_128.ppm"))
    ok, outliers = formats.compare_ppm(img[..., :3], ref)
    assert ok, f"{name}: {outliers:.1%} pixels beyond epsilon"
