"""Port parity: vrdd_tpu_torch.march.scan (the ray marcher) against
vrdd_tpu.march.scan on the same numpy inputs, on the CPU (the cases of
tests/test_march_parity.py, at 32^2).

Images must match within 1e-4 absolute on all but 0.1% of pixels (a
sample at the 0.95 opacity cutoff may flip between the two float
orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core.geometry import (
    default_benchmark_inv_view,
    inv_view_from_rotation_translation,
)
from vrdd_tpu.core.transfer import default_transfer_function, grayscale_ramp
from vrdd_tpu.io.synthetic import gaussian_blob_volume, random_histogram_volume
from vrdd_tpu.march import scan as jscan
from vrdd_tpu.models import renderer as jrend
from vrdd_tpu.ops.histogram import raw_block_stats
from vrdd_tpu.utils.config import MarchConfig as JMarch
from vrdd_tpu_torch.march import scan as tscan
from vrdd_tpu_torch.models import renderer as trend
from vrdd_tpu_torch.ops.histogram import raw_block_stats as t_raw_block_stats
from vrdd_tpu_torch.utils.config import MarchConfig

W = H = 32
ROT = inv_view_from_rotation_translation(30.0, -45.0, (0.2, -0.1, -3.5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_images_close(got, ref, tol=1e-4, budget=1e-3):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    bad = (np.abs(got - ref) > tol).any(axis=-1)
    assert bad.mean() <= budget, (bad.mean(), np.abs(got - ref).max())


def _both(vol, inv_view, tf, march=MarchConfig(), channel=None, **params):
    """(port image, JAX image) of a scalar volume, or of ``channel`` of a
    (Z, Y, X, 3) stats volume."""
    kw = dict(density=0.05, brightness=1.0, transfer_offset=0.0,
              transfer_scale=1.0)
    kw.update(params)
    if channel is None:
        jfn = jrend.scalar_sample_fn(jnp.asarray(vol))
        tfn = trend.scalar_sample_fn(torch.from_numpy(vol))
    else:
        jfn = jrend.stats_sample_fn(jnp.asarray(vol), channel)
        tfn = trend.stats_sample_fn(torch.from_numpy(vol), channel)
    jm = JMarch(**{f: getattr(march, f) for f in
                   ("max_steps", "tstep", "opacity_threshold", "box_min",
                    "box_max")})
    ref = jscan.render_image(jfn, jnp.asarray(inv_view), W, H,
                             jnp.asarray(tf), march=jm, **kw)
    got = tscan.render_image(tfn, inv_view, W, H, torch.from_numpy(tf),
                             march=march, **kw)
    return got, ref


def test_scalar_volume_benchmark_view():
    vol = gaussian_blob_volume((16, 16, 16), seed=0)
    got, ref = _both(vol, default_benchmark_inv_view(), grayscale_ramp(16))
    assert_images_close(got, ref)
    assert float(got[..., 3].max()) > 0.05, "vacuous: empty render"


def test_scalar_volume_rotated_view_rainbow_tf():
    vol = gaussian_blob_volume((16, 16, 16), seed=1)
    got, ref = _both(vol, ROT, default_transfer_function(), density=0.08,
                     brightness=1.2, transfer_offset=0.05,
                     transfer_scale=1.3)
    assert_images_close(got, ref)
    assert float(got[..., 3].max()) > 0.05


@pytest.mark.parametrize("view", ["benchmark", "rotated"])
@pytest.mark.parametrize("channel", [0, 1, 2])
def test_stats_channel_of_raw_volume(view, channel):
    hist = random_histogram_volume((6, 10, 10), n_bins=32, seed=3)
    stats = t_raw_block_stats(torch.from_numpy(hist)).numpy()
    np.testing.assert_allclose(
        stats, np.asarray(raw_block_stats(jnp.asarray(hist))), rtol=1e-6,
        atol=1e-6)
    iv = default_benchmark_inv_view() if view == "benchmark" else ROT
    got, ref = _both(stats, iv, default_transfer_function(), channel=channel,
                     transfer_scale=0.25 if channel == 1 else 1.0)
    assert_images_close(got, ref)


def test_early_termination_at_density_half():
    vol = np.full((8, 8, 8), 0.9, np.float32)
    got, ref = _both(vol, default_benchmark_inv_view(), grayscale_ramp(4),
                     density=0.5)
    assert_images_close(got, ref)
    assert float(got[..., 3].max()) > 0.95, "no ray reached the cutoff"


def test_non_default_box():
    vol = gaussian_blob_volume((12, 12, 12), seed=2)
    march = MarchConfig(box_min=(-0.6, -0.9, -0.4), box_max=(0.8, 0.5, 0.7))
    got, ref = _both(vol, ROT, default_transfer_function(), march=march,
                     density=0.2)
    assert_images_close(got, ref)
    assert float(got[..., 3].max()) > 0.05


def test_brightness_not_applied_to_missed_rays():
    vol = np.ones((4, 4, 4), np.float32)
    iv = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 10.0]], np.float32)
    got, ref = _both(vol, iv, grayscale_ramp(4), brightness=5.0)
    assert_images_close(got, ref)
    assert float(got[..., 3].min()) == 0.0, "some rays must miss"


def test_interp_mean_sample_fn_matches_jax():
    """Query 7's in-march decode through both marchers."""
    hist = random_histogram_volume((6, 10, 10), n_bins=32, seed=4)
    iv = default_benchmark_inv_view()
    tf = default_transfer_function()
    ref = jscan.render_image(jrend.interp_mean_sample_fn(jnp.asarray(hist)),
                             jnp.asarray(iv), W, H, jnp.asarray(tf))
    got = tscan.render_image(trend.interp_mean_sample_fn(
        torch.from_numpy(hist)), iv, W, H, torch.from_numpy(tf))
    assert_images_close(got, ref)
    np.testing.assert_allclose(
        trend.interp_mean_volume(torch.from_numpy(hist)).numpy(),
        np.asarray(jrend.interp_mean_volume(jnp.asarray(hist))), rtol=1e-6)


@pytest.mark.parametrize("chunk", [10, 25, 7])
def test_remat_chunk_is_bitwise_no_remat(chunk):
    """``remat_chunk`` (each chunk of steps under torch.utils.checkpoint;
    7 does not divide the 100 steps, so it runs the plain loop, as JAX's
    does) gives the image and the volume and LUT gradients of the march
    without it, bit for bit."""
    vol = torch.from_numpy(gaussian_blob_volume((8, 8, 8), seed=2))
    march = MarchConfig(max_steps=100, tstep=0.02)
    out = []
    for remat in (0, chunk):
        v = vol.clone().requires_grad_()
        lut = torch.tensor(grayscale_ramp(9), requires_grad=True)
        img = tscan.render_image(trend.scalar_sample_fn(v), ROT, 16, 16, lut,
                                 density=0.5, march=march, remat_chunk=remat)
        gv, gl = torch.autograd.grad(torch.mean((img - 0.25) ** 2), [v, lut])
        out.append((img.detach(), gv, gl))
    assert float(out[0][2].abs().max()) > 0  # not vacuous
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_remat_chunk_matches_jax():
    """The checkpointed march against JAX's nested-scan remat."""
    vol = gaussian_blob_volume((8, 8, 8), seed=2)
    got, ref = _both(vol, ROT, grayscale_ramp(9),
                     march=MarchConfig(max_steps=100, tstep=0.02))
    jm = JMarch(max_steps=100, tstep=0.02)
    ref_r = jscan.render_image(jrend.scalar_sample_fn(jnp.asarray(vol)),
                               jnp.asarray(ROT), W, H,
                               jnp.asarray(grayscale_ramp(9)), march=jm,
                               remat_chunk=25)
    got_r = tscan.render_image(trend.scalar_sample_fn(torch.from_numpy(vol)),
                               ROT, W, H, torch.from_numpy(grayscale_ramp(9)),
                               march=MarchConfig(max_steps=100, tstep=0.02),
                               remat_chunk=25)
    assert torch.equal(got_r, got)
    assert_images_close(got_r, ref_r)
    assert_images_close(got, ref)
