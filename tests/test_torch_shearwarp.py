"""Port parity of the shear-warp renderer (vrdd_tpu_torch.march.shearwarp)
and of RenderPipeline's rotated views against vrdd_tpu on the same numpy
inputs, on the CPU.

The 'xla' backend is the plain torch sweep on host m-grids, as in JAX; the
'pallas' backend runs the fused sweep's wrappers, which take their plain
K3/K4/K5 versions on the CPU, on the m-grid rounded up to 128 as JAX rounds
it. The CUDA kernels are held against those on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.io.synthetic import random_histogram_volume
from vrdd_tpu.march import shearwarp as jsw
from vrdd_tpu.models.pipeline import RenderPipeline as JPipeline
from vrdd_tpu.models.volumes import RawHistogramVolume as JRaw
from vrdd_tpu.utils.config import CameraConfig as JCamera
from vrdd_tpu.utils.config import RenderConfig as JRenderConfig
from vrdd_tpu_torch.convert import pipeline_state_from_jax
from vrdd_tpu_torch.core.geometry import (
    default_benchmark_inv_view,
    inv_view_from_rotation_translation,
)
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels import slice_vjp as tv
from vrdd_tpu_torch.march import shearwarp as tsw
from vrdd_tpu_torch.models.pipeline import RenderPipeline
from vrdd_tpu_torch.models.volumes import RawHistogramVolume
from vrdd_tpu_torch.utils.config import (
    CameraConfig,
    QueryMethod,
    RenderConfig,
)

TF = default_transfer_function()
#: (rot_x, rot_y): z-principal (d_z < 0 and > 0), y- and x-principal
VIEWS = [(25.0, 0.0), (20.0, -35.0), (0.0, 180.0), (180.0, 30.0),
         (60.0, 0.0), (0.0, 60.0), (0.0, -70.0), (-70.0, 10.0)]


def _iv(view):
    return inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: the suite runs several test processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vol():
    return gaussian_blob_volume((16, 16, 16), seed=3)


def test_geometry_exact():
    """The host geometry is JAX's, exactly: the principal axis, the
    permutation, d_z's sign, the per-pixel slopes, the corner bounds, for
    all three principal axes and both signs of d_z."""
    seen = set()
    for view in VIEWS:
        iv = _iv(view)
        for W, H in ((32, 32), (48, 20)):
            a, b = jsw.shearwarp_geometry(iv, W, H), tsw.shearwarp_geometry(
                iv, W, H)
            assert a[:2] == b[:2] and a[3:] == b[3:]
            np.testing.assert_array_equal(a[2], b[2])
            assert (jsw._principal_axis_geometry(iv, W, H)
                    == tsw._principal_axis_geometry(iv, W, H))
            assert jsw.slope_corner_bounds(iv, W, H) == tsw.slope_corner_bounds(
                iv, W, H)
            assert (jsw.shearwarp_applicable(iv, W, H)
                    == tsw.shearwarp_applicable(iv, W, H))
            seen.add((a[0], a[3]))
    assert {axis for axis, _ in seen} == {0, 1, 2}
    assert {sign for _, sign in seen} == {-1, 1}
    # a wide field of view across the diagonal: d_z changes sign
    diag = _iv((0.0, 45.0))
    assert not tsw.shearwarp_applicable(diag, focal=0.2)
    assert not jsw.shearwarp_applicable(diag, focal=0.2)


@pytest.mark.parametrize("view", VIEWS[:4])
def test_mgrid_from_corners_matches_jax(view):
    """The 'pallas' m-grid (origin and spacing) from the host corners, in
    float32, against JAX's on-device reduction over the full (H, W) slope
    grid (shearwarp.py:247-265), within 1e-6; and the device-built warp maps
    and warp against JAX's traced warp."""
    iv = _iv(view)
    W, H, wi, hi = 40, 24, 128, 128
    _, (px, py, pz), _, _, bounds = tsw.slope_corner_bounds(iv, W, H)
    rot = jnp.asarray(iv[:, :3])
    u = ((jnp.arange(W, dtype=jnp.float32) / W) * 2.0 - 1.0)[None, :]
    v = ((jnp.arange(H, dtype=jnp.float32) / H) * 2.0 - 1.0)[:, None]

    def d_world(i):
        return u * rot[i, 0] + v * rot[i, 1] - 2.0 * rot[i, 2]

    ref = []
    for m, n in ((d_world(px) / d_world(pz), wi), (d_world(py) / d_world(pz),
                                                  hi)):
        lo, hi_ = jnp.min(m), jnp.max(m)
        pad = jnp.maximum(jnp.float32(1e-6), (hi_ - lo) / n)
        ref += [float(lo - pad), float((hi_ - lo + 2.0 * pad) / (n - 1))]
    got = [*tsw.mgrid_params(bounds[0], bounds[1], wi),
           *tsw.mgrid_params(bounds[2], bounds[3], hi)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    img = np.random.default_rng(0).random((hi, wi, 4)).astype(np.float32)
    warped = tsw._warp_from_rotation_traced(
        torch.from_numpy(img), iv[:, :3], got, W, H, 2.0, (px, py, pz))
    jref = jsw._warp_from_rotation_traced(jnp.asarray(img), rot,
                                          jnp.asarray(got, jnp.float32), W, H,
                                          2.0, (px, py, pz))
    np.testing.assert_allclose(warped.numpy(), np.asarray(jref), atol=1e-5)


def test_host_warp_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.random((12, 10, 4)).astype(np.float32)
    ix = rng.uniform(-1.5, 10.5, (7, 9)).astype(np.float32)
    iy = rng.uniform(-1.5, 12.5, (7, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tsw._bilinear_warp_2d(torch.from_numpy(img), ix, iy).numpy(),
        np.asarray(jsw._bilinear_warp_2d(jnp.asarray(img), ix, iy)),
        atol=1e-6)


@pytest.mark.parametrize("view", [VIEWS[1], VIEWS[2], VIEWS[4], VIEWS[5]])
def test_xla_backend_matches_jax(vol, view):
    """backend 'xla' (and 'auto', which is 'xla' off the card) against JAX's
    'xla' backend at 16^3 -> 32^2: 1e-5."""
    iv = _iv(view)
    ref = np.asarray(jsw.shearwarp_render_image(
        jnp.asarray(vol), iv, 32, 32, jnp.asarray(TF), 0.5, n_planes=32,
        backend="xla"))
    got = tsw.shearwarp_render_image(torch.from_numpy(vol), iv, 32, 32, TF,
                                     0.5, n_planes=32, backend="xla")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert ref[..., 3].max() > 0.05, "vacuous: empty render"
    auto = tsw.shearwarp_render_image(torch.from_numpy(vol), iv, 32, 32, TF,
                                      0.5, n_planes=32, backend="auto")
    assert torch.equal(auto, got)
    u8 = tsw.shearwarp_render_image(torch.from_numpy(vol), iv, 32, 32, TF,
                                    0.5, n_planes=32, backend="xla",
                                    pack_u8=3)
    assert u8.dtype == torch.uint8 and tuple(u8.shape) == (32, 32, 3)


@pytest.fixture(scope="module")
def vol32():
    return gaussian_blob_volume((32, 32, 32), seed=3)


def test_pallas_backend_matches_jax_xla(vol32):
    """backend 'pallas' (plain K3 on the CPU, the m-grid rounded up to 128)
    against JAX's 'xla' under JAX's own tolerances
    (tests/test_shearwarp.py:100-118): 99% of values within 2e-2, all
    within 0.15 (the two m-grids differ, so the warps filter differently);
    the m-grid's 128 rounding keeps JAX's sampling."""
    iv = _iv((20.0, -35.0))
    ref = np.asarray(jsw.shearwarp_render_image(
        jnp.asarray(vol32), iv, 64, 64, jnp.asarray(TF), n_planes=64,
        backend="xla"))
    launches = tv.sweep_fwd.launches
    with torch.no_grad():
        got = tsw.shearwarp_render_image(torch.from_numpy(vol32), iv, 64, 64,
                                         TF, n_planes=64,
                                         backend="pallas").numpy()
    assert tv.sweep_fwd.launches == launches  # the CPU takes the plain K3
    diff = np.abs(got - ref)
    assert np.quantile(diff, 0.99) < 2e-2, np.quantile(diff, 0.99)
    assert diff.max() < 0.15, diff.max()


def test_d_volume_matches_jax(vol):
    """d_volume through shear-warp against JAX: backend 'xla' within 1e-4
    relative L2; backend 'pallas' (plain K4/K5, the warp's scatter) against
    JAX's 'xla' at 64^2, where oversample 2 gives an m-grid of 128 and both
    backends sweep the same grid (tests/test_shearwarp.py:121-143), also
    within 1e-4."""
    iv = _iv((15.0, 30.0))

    def jloss(v):
        img = jsw.shearwarp_render_image(v, iv, 64, 64, jnp.asarray(TF),
                                         density=0.3, n_planes=32,
                                         backend="xla")
        return jnp.mean(img ** 2)

    ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(vol)))
    for backend in ("xla", "pallas"):
        v = torch.tensor(vol, requires_grad=True)
        img = tsw.shearwarp_render_image(v, iv, 64, 64, TF, density=0.3,
                                         n_planes=32, backend=backend,
                                         wrt=("volume",))
        (g,) = torch.autograd.grad(torch.mean(img ** 2), [v])
        rel = float(np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref))
        assert rel < 1e-4, (backend, rel)


def test_shearwarp_rejects():
    vol = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="inapplicable"):
        tsw.shearwarp_render_image(vol, _iv((0.0, 45.0)), 8, 8, TF,
                                   focal=0.2)
    with pytest.raises(ValueError, match="backend"):
        tsw.shearwarp_render_image(vol, _iv((20.0, 0.0)), 8, 8, TF,
                                   backend="tpu")


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same raw histograms."""
    hist = random_histogram_volume((6, 10, 10), n_bins=32, seed=7)
    jp = JPipeline(raw=JRaw(jnp.asarray(hist)))
    state = pipeline_state_from_jax(jp, "cpu")
    tp = RenderPipeline(raw=RawHistogramVolume(state["histograms"]),
                        tf_lut=state["tf_lut"])
    return jp, tp


@pytest.mark.parametrize("query,view", [(1, (25.0, 40.0)), (7, (20.0, 30.0)),
                                        (1, (0.0, 70.0))])
def test_pipeline_rotated_matches_jax(pipelines, query, view):
    """RenderPipeline's rotated views: 'auto' resolves to 'shearwarp' (the
    plain sweep on the CPU) and the frame matches JAX's
    ``render(renderer='shearwarp')`` (tests/test_pipeline.py:184-205
    cases), 1e-5."""
    jp, tp = pipelines
    iv = _iv(view)
    cfg = RenderConfig(camera=CameraConfig(width=24, height=24), density=0.5,
                       query_method=QueryMethod(query))
    jcfg = JRenderConfig(camera=JCamera(width=24, height=24), density=0.5,
                         query_method=query)
    assert tp.resolve_renderer("auto", iv, cfg) == "shearwarp"
    assert jp.resolve_renderer("auto", iv, jcfg) == "shearwarp"
    ref = np.asarray(jp.render(iv, jcfg, renderer="shearwarp"))
    got = tp.render(iv, cfg, "auto")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert ref[..., 3].max() > 0.01, "vacuous: empty render"
    assert torch.equal(tp.render(iv, cfg, "shearwarp", as_uint8=True),
                       tsw.rgba_to_uint8(got))
    # the unrotated benchmark view still goes object-order unwarped
    assert tp.resolve_renderer("auto", default_benchmark_inv_view(),
                               cfg) == "slice"
