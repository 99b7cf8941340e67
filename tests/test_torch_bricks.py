"""Port parity of the scan marcher on bricks
(``vrdd_tpu_torch/parallel/bricks.py distributed_render_image``) against
``vrdd_tpu.parallel.bricks`` and JAX's single-device marcher, on the same
stats volumes, with the same ``(bricks, rays)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core.geometry import (
    default_benchmark_inv_view,
    inv_view_from_rotation_translation,
)
from vrdd_tpu.core.transfer import default_transfer_function, grayscale_ramp
from vrdd_tpu.io.synthetic import gaussian_blob_volume
from vrdd_tpu.march.scan import render_image as j_render_image
from vrdd_tpu.models.renderer import stats_sample_fn
from vrdd_tpu.parallel import bricks as jbricks
from vrdd_tpu.parallel import mesh as jmesh
from vrdd_tpu.utils.config import MarchConfig as JMarch
from vrdd_tpu_torch.parallel import bricks as tbricks
from vrdd_tpu_torch.parallel.mesh import make_mesh
from vrdd_tpu_torch.utils.config import MarchConfig

TF = default_transfer_function()
#: a coarser step than the default keeps the 500-step loops short; both
#: sides march the same t grid
STEPS = dict(max_steps=120, tstep=0.03)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(n=16, seed=0):
    vol = gaussian_blob_volume((n, n, n), seed=seed)
    return np.stack([vol, vol * 0.5, 1.0 - vol], axis=-1).astype(np.float32)


def _single(stats, iv, W, tf, ch, march, density=0.05):
    return np.asarray(j_render_image(
        stats_sample_fn(jnp.asarray(stats), ch), jnp.asarray(iv), W, W,
        jnp.asarray(tf), jnp.float32(density), jnp.float32(1.0),
        jnp.float32(0.0), jnp.float32(1.0), march))


def _port(stats, iv, W, tf, ch, march, bricks, rays, density=0.05):
    mesh = make_mesh(bricks, rays, devices=["cpu"])
    return tbricks.distributed_render_image(
        tbricks.shard_stats_volume(stats, mesh), iv, tf, density,
        width=W, height=W, channel=ch, march=march, mesh=mesh).numpy()


@pytest.fixture(scope="module")
def jax_bricks():
    """JAX's distributed render on bricks=2 x rays=4, channels 0 and 2."""
    stats = _stats(16)
    m = jmesh.make_mesh(2, 4)
    return stats, {ch: np.asarray(jbricks.distributed_render_image(
        jbricks.shard_stats_volume(jnp.asarray(stats), m),
        jnp.asarray(default_benchmark_inv_view()), jnp.asarray(TF),
        jnp.float32(0.05), jnp.float32(1.0), jnp.float32(0.0),
        jnp.float32(1.0), width=32, height=32, channel=ch,
        march=JMarch(**STEPS), mesh=m)) for ch in (0, 2)}


@pytest.mark.parametrize("bricks,rays", [(1, 1), (2, 4), (4, 2)])
def test_distributed_matches_jax(jax_bricks, bricks, rays):
    """Benchmark camera, channels 0 and 2, against JAX's distributed
    render."""
    stats, refs = jax_bricks
    for ch, ref in refs.items():
        got = _port(stats, default_benchmark_inv_view(), 32, TF, ch,
                    MarchConfig(**STEPS), bricks, rays)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_distributed_rotated_view_rays_cross_bricks():
    """An oblique view: rays cross several slabs in both z directions."""
    stats = _stats(16, seed=3)
    iv = inv_view_from_rotation_translation(50.0, 30.0, (0.1, 0.0, -3.0))
    want = _single(stats, iv, 32, TF, 0, JMarch(**STEPS))
    got = _port(stats, iv, 32, TF, 0, MarchConfig(**STEPS), 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_distributed_early_termination_exact():
    """The two-pass cutoff makes saturating rays exact across bricks."""
    stats = np.full((8, 8, 8, 3), 0.9, np.float32)
    iv = default_benchmark_inv_view()
    want = _single(stats, iv, 16, grayscale_ramp(4), 0, JMarch(**STEPS),
                   density=0.9)
    assert (want[..., 3] > 0.95).any()
    got = _port(stats, iv, 16, grayscale_ramp(4), 0, MarchConfig(**STEPS),
                2, 4, density=0.9)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_distributed_render_gradients():
    """LUT and stats cotangents through the halo, the gather and pass 2,
    against JAX's single-device autodiff of the marcher."""
    stats = _stats(8, seed=5)
    iv = default_benchmark_inv_view()
    jm = JMarch(max_steps=60, tstep=0.05)

    def jloss(s, lut):
        img = j_render_image(stats_sample_fn(s, 0), jnp.asarray(iv), 16, 16,
                             lut, jnp.float32(0.3), jnp.float32(1.0),
                             jnp.float32(0.0), jnp.float32(1.0), jm)
        return jnp.sum(img ** 2)

    gs, gl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(stats),
                                             jnp.asarray(TF))
    st = torch.tensor(stats, requires_grad=True)
    lt = torch.tensor(TF, requires_grad=True)
    img = tbricks.distributed_render_image(
        st, iv, lt, 0.3, width=16, height=16, channel=0,
        march=MarchConfig(max_steps=60, tstep=0.05),
        mesh=make_mesh(2, 2, devices=["cpu"]))
    (img ** 2).sum().backward()
    for got, ref in ((st.grad, gs), (lt.grad, gl)):
        ref = np.asarray(ref, np.float64)
        err = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
        assert err < 1e-3, err
