"""Port parity: vrdd_tpu_torch.core.{geometry,sampling,transfer} against
vrdd_tpu.core on the same numpy inputs, on the CPU. Tolerance 1e-6
absolute (float32 rounding of the same expressions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core import geometry as jg
from vrdd_tpu.core import sampling as js
from vrdd_tpu.core import transfer as jt
from vrdd_tpu_torch.core import geometry as tg
from vrdd_tpu_torch.core import sampling as ts
from vrdd_tpu_torch.core import transfer as tt

ATOL = 1e-6
VIEWS = {
    "benchmark": jg.default_benchmark_inv_view(),
    "rotated": jg.inv_view_from_rotation_translation(30.0, -45.0,
                                                     (0.2, -0.1, -3.5)),
    "inside": jg.inv_view_from_rotation_translation(10.0, 20.0,
                                                    (0.1, 0.2, -0.3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("rx,ry,t", [(0.0, 0.0, (0, 0, -4.0)),
                                     (30.0, -45.0, (0.2, -0.1, -3.5)),
                                     (-80.0, 170.0, (1.0, 2.0, 3.0))])
def test_inv_view_matches_jax(rx, ry, t):
    got = tg.inv_view_from_rotation_translation(rx, ry, t)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jg.inv_view_from_rotation_translation(rx, ry, t))
    np.testing.assert_array_equal(tg.default_benchmark_inv_view(),
                                  jg.default_benchmark_inv_view())


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_camera_rays_match_jax(view):
    iv = VIEWS[view]
    o_ref, d_ref = jg.camera_rays(jnp.asarray(iv), 17, 13)
    o, d = tg.camera_rays(iv, 17, 13)
    assert tuple(d.shape) == (13, 17, 3)
    _close(o, o_ref)
    _close(d, d_ref)


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("box", [((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                                 ((-0.5, -0.8, -0.3), (0.7, 0.4, 0.9))])
def test_intersect_box_matches_jax(view, box):
    """Camera rays of each view (incl. a camera inside the box, whose tnear
    is negative) against a default and a shifted box."""
    o, d = jg.camera_rays(jnp.asarray(VIEWS[view]), 16, 12)
    d = np.asarray(d).reshape(-1, 3)
    o = np.broadcast_to(np.asarray(o), d.shape)
    ref = jg.intersect_box(jnp.asarray(o), jnp.asarray(d), *box)
    got = tg.intersect_box(_t(o), _t(d), *box)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if view == "inside":
        assert bool(got[2].all()) and float(got[0].max()) < 0.0


def test_linear_1d_texel_centers_and_clamp():
    lut = np.arange(8, dtype=np.float32)
    u = (np.arange(8, dtype=np.float32) + 0.5) / 8.0
    _close(ts.sample_linear_1d(_t(lut), _t(u)), np.arange(8))
    lut2 = np.array([0.0, 1.0], np.float32)
    u2 = np.array([0.5, 0.0, 1.0, -1.0, 2.0], np.float32)
    _close(ts.sample_linear_1d(_t(lut2), _t(u2)), [0.5, 0.0, 1.0, 0.0, 1.0])


@pytest.mark.parametrize("channels", [False, True])
def test_trilinear_and_nearest_match_jax(channels):
    """Random coordinates, including outside [0, 1] (edge clamps), texel
    centres and halfway points."""
    rng = np.random.default_rng(0)
    shape = (4, 5, 6, 3) if channels else (4, 5, 6)
    vol = rng.random(shape).astype(np.float32)
    p01 = rng.uniform(-0.2, 1.2, (64, 3)).astype(np.float32)
    centres = np.array([[(4 + 0.5) / 6, (3 + 0.5) / 5, (2 + 0.5) / 4],
                        [(4 + 1.0) / 6, (3 + 0.5) / 5, (2 + 0.5) / 4]],
                       np.float32)
    p01 = np.concatenate([p01, centres])
    for jf, tf_ in ((js.sample_trilinear_3d, ts.sample_trilinear_3d),
                    (js.sample_nearest_3d, ts.sample_nearest_3d)):
        _close(tf_(_t(vol), _t(p01)), jf(jnp.asarray(vol), jnp.asarray(p01)))
    got = ts.sample_trilinear_3d(_t(vol), _t(centres))
    v = vol[..., 0] if channels else vol
    got = got[..., 0] if channels else got
    _close(got, [v[2, 3, 4], (v[2, 3, 4] + v[2, 3, 5]) / 2])


def test_trilinear_edge_clamp_and_nearest_floor():
    vol = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    _close(ts.sample_trilinear_3d(_t(vol), _t([[0, 0, 0], [1, 1, 1]])),
           [0.0, 7.0])
    vol3 = np.arange(27, dtype=np.float32).reshape(3, 3, 3)
    _close(ts.sample_nearest_3d(_t(vol3), _t([[0.34, 0.0, 0.99],
                                              [0.99, 0.34, 0.0]])),
           [2 * 9 + 0 * 3 + 1, 0 * 9 + 1 * 3 + 2])


def test_unnormalized_matches_normalized_and_jax():
    rng = np.random.default_rng(1)
    vol = rng.random((4, 4, 4)).astype(np.float32)
    p01 = rng.random((16, 3)).astype(np.float32)
    a = ts.sample_trilinear_3d(_t(vol), _t(p01))
    b = ts.sample_trilinear_3d_unnormalized(_t(vol), _t(p01 * 4.0))
    _close(a, b)
    _close(b, js.sample_trilinear_3d_unnormalized(jnp.asarray(vol),
                                                  jnp.asarray(p01 * 4.0)))


def test_trilinear_gradient_flows_to_volume():
    vol = torch.ones((3, 3, 3), requires_grad=True)
    ts.sample_trilinear_3d(vol, _t([[0.5, 0.5, 0.5]])).sum().backward()
    assert abs(float(vol.grad.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("offset,scale", [(0.0, 1.0), (0.05, 1.3),
                                          (0.2, -2.0)])
def test_apply_transfer_function_matches_jax(offset, scale):
    rng = np.random.default_rng(2)
    lut = jt.default_transfer_function()
    s = rng.uniform(-0.2, 1.2, (50,)).astype(np.float32)
    got = tt.apply_transfer_function(_t(lut), _t(s), offset, scale)
    assert tuple(got.shape) == (50, 4)
    _close(got, jt.apply_transfer_function(jnp.asarray(lut), jnp.asarray(s),
                                           offset, scale))
