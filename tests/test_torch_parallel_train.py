"""Port parity of the distributed fitting steps
(``vrdd_tpu_torch/parallel/train.py``): one step of each factory against
JAX's step on the same inputs and mesh, the loss and the updated parameters
(``torch.optim.Adam`` against ``optax.adam``, both lr 1e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core.geometry import default_benchmark_inv_view
from vrdd_tpu.core.transfer import default_transfer_function, grayscale_ramp
from vrdd_tpu.io.synthetic import gaussian_blob_volume
from vrdd_tpu.parallel import bricks as jbricks
from vrdd_tpu.parallel import mesh as jmesh
from vrdd_tpu.parallel import sweep as jsweep
from vrdd_tpu.parallel import train as jtrain
from vrdd_tpu.utils.config import MarchConfig as JMarch
from vrdd_tpu_torch.parallel import train as ttrain
from vrdd_tpu_torch.parallel.mesh import make_mesh
from vrdd_tpu_torch.utils.config import MarchConfig

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("learn_volume", [False, True])
def test_sweep_fit_step_matches_jax(learn_volume):
    """make_sweep_fit_step on bricks=2 x rays=4: the loss, the updated LUT
    (and volume) after one Adam step, on both of the port's backends."""
    vol = gaussian_blob_volume((16, 16, 16), seed=1)
    m = jmesh.make_mesh(2, 4)
    target = np.asarray(jsweep.distributed_sweep_render(
        jnp.asarray(vol), jnp.asarray(O), jnp.asarray(TF), width=32,
        height=32, mesh=m, n_planes=32))
    init, step = jtrain.make_sweep_fit_step(m, 32, 32, n_planes=32,
                                            learn_volume=learn_volume)
    params, st = init(jnp.asarray(grayscale_ramp(9)),
                      volume=jnp.asarray(vol))
    params, st, loss = step(params, st, jnp.asarray(vol), jnp.asarray(O),
                            jnp.asarray(target))
    mesh = make_mesh(2, 4, devices=["cpu"])
    for backend in ("xla", "pallas"):
        init_t, step_t = ttrain.make_sweep_fit_step(
            mesh, 32, 32, n_planes=32, learn_volume=learn_volume,
            backend=backend)
        p, opt = init_t(grayscale_ramp(9), volume=vol)
        p, opt, loss_t = step_t(p, opt, torch.from_numpy(vol), O,
                                ttrain.shard_target_image(target, mesh))
        assert abs(float(loss_t) - float(loss)) <= 1e-6 * float(loss)
        _close(p["tf_lut"], params["tf_lut"], 1e-6)
        if learn_volume:
            _close(p["volume"], params["volume"], 1e-6)


def test_tf_fit_step_matches_jax():
    """make_tf_fit_step (the scan marcher on bricks) on bricks=2 x rays=4:
    the loss and the updated LUT after one Adam step."""
    vol = gaussian_blob_volume((8, 8, 8), seed=5)
    stats = np.stack([vol, vol * 0.5, 1.0 - vol], -1).astype(np.float32)
    iv = default_benchmark_inv_view()
    m = jmesh.make_mesh(2, 4)
    steps = dict(max_steps=60, tstep=0.05)
    target = np.asarray(jbricks.distributed_render_image(
        jnp.asarray(stats), jnp.asarray(iv), jnp.asarray(TF),
        jnp.float32(0.05), jnp.float32(1.0), jnp.float32(0.0),
        jnp.float32(1.0), width=16, height=16, channel=0,
        march=JMarch(**steps), mesh=m))
    init, step = jtrain.make_tf_fit_step(m, 16, 16, march=JMarch(**steps))
    params, st = init(jnp.asarray(grayscale_ramp(9)))
    params, st, loss = step(params, st, jnp.asarray(stats), jnp.asarray(iv),
                            jnp.asarray(target))
    init_t, step_t = ttrain.make_tf_fit_step(
        make_mesh(2, 4, devices=["cpu"]), 16, 16,
        march=MarchConfig(**steps))
    p, opt = init_t(grayscale_ramp(9))
    args = (torch.from_numpy(stats), iv, torch.from_numpy(target))
    p, opt, loss_t = step_t(p, opt, *args)
    assert abs(float(loss_t) - float(loss)) <= 1e-6 * float(loss)
    _close(p["tf_lut"], params["tf_lut"], 1e-6)
    # the next step starts from the updated LUT and the optimizer's state
    _, _, loss_2 = step_t(p, opt, *args)
    assert float(loss_2) < float(loss_t)
