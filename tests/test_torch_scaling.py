"""The scaling harness (``vrdd_tpu_torch/parallel/scaling.py``) and the
mesh (``parallel/mesh.py``) in one process: JAX's mesh factorization, the
one-shard timing and its report, and the mesh's contract. The two-process
timing runs in tests/test_torch_multihost.py's Gloo workers."""

import pytest
import torch

from vrdd_tpu.parallel.scaling import _factor_mesh as j_factor_mesh
from vrdd_tpu_torch.parallel.mesh import make_mesh
from vrdd_tpu_torch.parallel.scaling import _factor_mesh, measure_scaling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
def test_factor_mesh_matches_jax(n):
    assert _factor_mesh(n) == j_factor_mesh(n)


def test_measure_scaling_single_device_reports_armed():
    out = measure_scaling(["cpu"], size=16, image=64, iters=1)
    assert out["scaling_n_devices"] == 1
    assert out["scaling_device"] == "cpu"
    assert out["scaling_shape"] == "16^3 -> 64^2"
    assert out["scaling_t1_ms"] > 0 and out["scaling_fwdbwd_t1_ms"] > 0
    assert out["scaling_efficiency"] is None
    assert out["scaling_fwdbwd_efficiency"] is None
    assert "ready" in out["scaling_note"]


def test_make_mesh_contract():
    mesh = make_mesh(4, 2, devices=["cpu"])
    assert (mesh.bricks, mesh.rays) == (4, 2)
    assert mesh.world == 1 and mesh.local_bricks == (0, 1, 2, 3)
    assert make_mesh(2, devices=["cpu"] * 2).rays == 1
    assert make_mesh(2, 1, devices=["cpu"]) == make_mesh(2, 1,
                                                         devices=["cpu"])
    with pytest.raises(ValueError, match="one device"):
        make_mesh(1, 2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(0, 1, devices=["cpu"])
    if not torch.cuda.is_available():  # the default is the card
        with pytest.raises((AssertionError, RuntimeError)):
            make_mesh(1, 1)
