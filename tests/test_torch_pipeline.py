"""Port parity: vrdd_tpu_torch.models.{volumes,renderer,pipeline} against
vrdd_tpu.models on the same histograms, on the CPU, plus the raw golden
fixtures of tests/test_golden.py rendered by the port.

JAX's ``pallas`` renderer runs under the Pallas TPU interpreter, as
tests/test_golden.py runs it; the port's ``pallas`` renderer takes its
plain version on the CPU, with empty-space skipping on (the default).
Images must match within 1e-4 absolute on all but 0.1% of pixels (cutoff
flips)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.io.synthetic import random_histogram_volume
from vrdd_tpu.models.pipeline import RenderPipeline as JPipeline
from vrdd_tpu.models.volumes import RawHistogramVolume as JRaw
from vrdd_tpu.utils.config import CameraConfig as JCamera
from vrdd_tpu.utils.config import RenderConfig as JRenderConfig
from vrdd_tpu.utils.config import TransferFunctionConfig as JTF
from vrdd_tpu_torch.convert import pipeline_state_from_jax
from vrdd_tpu_torch.core.geometry import (
    default_benchmark_inv_view,
    inv_view_from_rotation_translation,
)
from vrdd_tpu_torch.core.image import rgba_to_uint8
from vrdd_tpu_torch.io import formats
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


def _cfg(query, jax=False, width=W, density=0.5):
    scale = 0.25 if query == 2 else 1.0
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


@pytest.mark.parametrize("query", [0, 4, 5, 6, 8, 9])
def test_unported_queries_raise(pipelines, query):
    _, tp, _ = pipelines
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        tp.render(None, _cfg(query), "scan")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        tp.resolve_renderer("auto", default_benchmark_inv_view(), _cfg(query))


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="fractal"):
        RenderPipeline(fractal=object())
    with pytest.raises(NotImplementedError, match="flexible"):
        RenderPipeline(flexible=object())
