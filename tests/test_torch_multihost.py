"""The distributed renderers across real processes, joined by a Gloo process
group on the CPU (``vrdd_tpu_torch/parallel/multihost.py``), against the
same mesh held by one process; the mesh's placement against JAX's.

Three worlds:

- 2 processes, bricks=4 x rays=2: each holds two bricks and both ray
  strips (the brick group is the world);
- 2 processes, bricks=1 x rays=2, JAX's ``global_mesh()`` default: each
  holds one ray strip of the one brick (the ray group is the world);
- 4 processes, bricks=2 x rays=2, one shard a process: both groups have
  two processes.

The halo exchange (a send/recv across a process boundary, and its
adjoint), the sort-last gather and its all-reduce transpose, the pass-2
psum and the seed cotangent into a brick of another process, the gradient
sums over the ray group and the world, the strips' gather before the
rotated warp and in ``gather_image``, and the fit step's loss over the ray
group are all in the loop. The worker is this file itself, run as a script
by the tests (``python tests/test_torch_multihost.py ADDRESS WORLD RANK OUT
BRICKS RAYS``); it imports no JAX."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

MARCH = dict(max_steps=50, tstep=0.05)
O = np.array([0.0, 0.0, 4.0], np.float32)
ROT = (30.0, 20.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread (its workers pin
    themselves too): the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume

    vol = gaussian_blob_volume((8, 8, 8), seed=11)
    stats = np.stack([vol, vol * 0.5, 1.0 - vol], axis=-1).astype(np.float32)
    rng = np.random.default_rng(2)
    h = rng.random((8, 4, 8, 8)).astype(np.float32) + 0.2
    h /= h.sum(axis=1, keepdims=True)
    return stats, gaussian_blob_volume((8, 16, 16), seed=7), h


def distributed_case(mesh, gather):
    """Every distributed path on ``mesh``; ``gather(t)`` joins a tensor of
    this process's bricks along axis 0 into the whole volume's."""
    from vrdd_tpu_torch.core.geometry import (
        default_benchmark_inv_view, inv_view_from_rotation_translation)
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.parallel import bricks, multihost, sweep, train
    from vrdd_tpu_torch.utils.config import MarchConfig

    stats, vol, h = _inputs()
    tf = default_transfer_function()
    march = MarchConfig(**MARCH)
    out = {"scan": multihost.gather_image(bricks.distributed_render_image(
        multihost.make_global(stats, mesh, multihost.stats_volume_spec()),
        default_benchmark_inv_view(), tf, 0.1, width=16, height=16,
        march=march, mesh=mesh), mesh)}
    # n_planes = 2 nz: the pre-blend reads the other rank's ghost layer
    for backend in ("xla", "pallas"):
        v = sweep.shard_scalar_volume(vol, mesh).requires_grad_(True)
        lut = torch.tensor(tf, requires_grad=True)
        img = sweep.distributed_sweep_render(
            v, O, lut, 0.3, width=16, height=16, march=march, mesh=mesh,
            n_planes=16, backend=backend,
            plane_chunk=4 if backend == "pallas" else 8)
        loss = train.image_mean((img - 0.25) ** 2, mesh)
        loss.backward()
        out.update({f"{backend}_img": multihost.gather_image(img, mesh),
                    f"{backend}_loss": loss.detach().numpy(),
                    f"{backend}_g_vol": gather(v.grad).numpy(),
                    f"{backend}_g_lut": lut.grad.numpy()})
    # a saturating histogram render: pass 2 seeds a brick of either rank
    # from the other's prefix, and the seed cotangent flows back across
    hist = sweep.shard_hist_volume(h, mesh).requires_grad_(True)
    lut = torch.tensor(tf, requires_grad=True)
    img = sweep.distributed_hist_render(
        hist, (np.arange(4, dtype=np.float32) + 0.5) / 4, O, lut, 0.5,
        width=24, height=20, mesh=mesh, wrt=("hist", "lut"))
    # the whole image's sum, as one process forms it
    (train.image_mean(img ** 2, mesh) * (24 * 20 * 4)).backward()
    out.update({"hist_img": multihost.gather_image(img, mesh),
                "hist_g": gather(hist.grad).numpy(),
                "hist_g_lut": lut.grad.numpy()})
    # a rotated frame: the m-grid's strips gathered before the warp, the
    # whole volume's gradient summed over the world
    v = torch.tensor(vol, requires_grad=True)
    lut = torch.tensor(tf, requires_grad=True)
    img = sweep.distributed_shearwarp_render(
        v, inv_view_from_rotation_translation(*ROT, (0.0, 0.0, -4.0)), 16,
        16, lut, 0.3, march=march, mesh=mesh, n_planes=16, backend="xla")
    torch.mean((img - 0.25) ** 2).backward()
    out.update({"rot_img": img.detach().numpy(),
                "rot_g_vol": v.grad.numpy(), "rot_g_lut": lut.grad.numpy()})
    # one step of each fit, volume and LUT learned
    target = np.full((16, 16, 4), 0.25, np.float32)
    init_fn, step_fn = train.make_sweep_fit_step(
        mesh, 16, 16, march, learn_volume=True, n_planes=16,
        backend="pallas")
    vs = sweep.shard_scalar_volume(vol, mesh)
    params, opt = init_fn(tf, volume=vs)
    params, opt, loss = step_fn(params, opt, vs, O,
                                train.shard_target_image(target, mesh))
    out.update({"fit_loss": loss.numpy(),
                "fit_g_lut": params["tf_lut"].grad.numpy(),
                "fit_g_vol": gather(params["volume"].grad).numpy(),
                "fit_lut": params["tf_lut"].detach().numpy()})
    init_fn, step_fn = train.make_tf_fit_step(mesh, 16, 16, march=march,
                                              learn_volume=True)
    st = multihost.make_global(stats, mesh, multihost.stats_volume_spec())
    params, opt = init_fn(tf, st)
    params, opt, loss = step_fn(params, opt, st, default_benchmark_inv_view(),
                                train.shard_target_image(target, mesh))
    out.update({"tf_fit_loss": loss.numpy(),
                "tf_fit_g_lut": params["tf_lut"].grad.numpy(),
                "tf_fit_g_stats": gather(params["stats"].grad).numpy()})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RUNS = {}


def _run_world(world, bricks, rays, tmp_path_factory):
    """Every rank's results of a ``world``-process run (cached per
    layout)."""
    key = (world, bricks, rays)
    if key in _RUNS:
        return _RUNS[key]
    tmp = tmp_path_factory.mktemp(f"world{world}_{bricks}x{rays}")
    addr = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), addr, str(world), str(r),
         str(tmp / f"rank{r}.npz"), str(bricks), str(rays)],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    _RUNS[key] = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    return _RUNS[key]


def _check_world(world, bricks, rays, tmp_path_factory):
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.parallel.scaling import _factor_mesh

    ranks = _run_world(world, bricks, rays, tmp_path_factory)
    want = distributed_case(make_mesh(bricks, rays, devices=["cpu"]),
                            lambda t: t)
    assert float(want["hist_img"][..., 3].max()) > 0.95  # pass 2 runs
    b, r = _factor_mesh(world)
    for rank, got in enumerate(ranks):
        assert set(got) == set(want) | {"scaling_efficiency",
                                        "scaling_mesh"}, rank
        for key, ref in want.items():
            np.testing.assert_allclose(got[key], ref, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank}: {key}")
        assert float(got["scaling_efficiency"]) > 0
        assert str(got["scaling_mesh"]) == f"bricks={b} x rays={r}"


def test_two_process_gloo_matches_one_process(tmp_path_factory):
    """bricks=4 x rays=2 on 2 processes: the processes split the bricks."""
    _check_world(2, 4, 2, tmp_path_factory)


@pytest.mark.parametrize("world,bricks,rays", [(2, 1, 2), (4, 2, 2)],
                         ids=["2proc-1x2", "4proc-2x2"])
def test_gloo_world_splits_rays_matches_one_process(world, bricks, rays,
                                                     tmp_path_factory):
    """The processes split the ray strips (JAX's rays-on-hosts), alone and
    with the bricks."""
    _check_world(world, bricks, rays, tmp_path_factory)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_gloo_rays_world_matches_jax(tmp_path_factory):
    """The gathered 2-process bricks=1 x rays=2 sweep image and LUT
    gradient against JAX's ``distributed_sweep_render`` on its CPU mesh
    ``make_mesh(1, 2)`` (tests/test_torch_dist_sweep.py's tolerances)."""
    import jax
    import jax.numpy as jnp

    from vrdd_tpu.core.transfer import default_transfer_function
    from vrdd_tpu.parallel import mesh as jmesh
    from vrdd_tpu.parallel import sweep as jsweep
    from vrdd_tpu.utils.config import MarchConfig as JMarchConfig

    ranks = _run_world(2, 1, 2, tmp_path_factory)
    _, vol, _ = _inputs()
    m = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])

    def loss(lut):
        img = jsweep.distributed_sweep_render(
            jsweep.shard_scalar_volume(jnp.asarray(vol), m), jnp.asarray(O),
            lut, jnp.float32(0.3), width=16, height=16,
            march=JMarchConfig(**MARCH), mesh=m, n_planes=16, backend="xla")
        return jnp.mean((img - 0.25) ** 2), img

    (_, img), g_lut = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(default_transfer_function()))
    for got in ranks:
        for backend in ("xla", "pallas"):
            np.testing.assert_allclose(got[f"{backend}_img"], np.asarray(img),
                                       atol=2e-5, rtol=0, err_msg=backend)
            assert _rel_l2(got[f"{backend}_g_lut"], g_lut) < 1e-3, backend


def _rect(cells):
    bs = sorted({b for b, _ in cells})
    rs = sorted({r for _, r in cells})
    return {(b, r) for b in bs for r in rs} == set(cells), bs, rs


@pytest.mark.parametrize("bricks,rays", [
    (b, r) for b in range(1, 9) for r in range(1, 9) if b * r <= 8])
def test_placement_matches_jax_device_reshape(bricks, rays):
    """Process ``p`` of ``world`` holds the shards where JAX's
    ``np.asarray(devices).reshape(bricks, rays)`` puts its devices, with
    ``bricks * rays / world`` consecutive devices a process; a layout that
    gives a process a ragged run (or does not split evenly) raises."""
    import jax

    from vrdd_tpu.parallel import mesh as jmesh
    from vrdd_tpu_torch.parallel.mesh import placement, process_groups

    n = bricks * rays
    grid = np.vectorize(lambda d: d.id)(
        jmesh.make_mesh(bricks, rays, devices=jax.devices()[:n]).devices)
    for world in range(1, 5):
        if n % world:
            with pytest.raises(ValueError):
                placement(bricks, rays, world, 0)
            continue
        owner = (grid - grid.min()) // (n // world)
        runs = [list(zip(*np.nonzero(owner == p))) for p in range(world)]
        if not all(_rect(c)[0] for c in runs):
            for p in range(world):
                with pytest.raises(ValueError, match="ragged"):
                    placement(bricks, rays, world, p)
            continue
        for p, cells in enumerate(runs):
            _, bs, rs = _rect(cells)
            b, r = placement(bricks, rays, world, p)
            assert (list(b), list(r)) == (bs, rs), (world, p)
        brick_groups, ray_groups = process_groups(bricks, rays, world)
        for g in brick_groups:  # same strips, bricks ascending, all bricks
            places = [placement(bricks, rays, world, p) for p in g]
            assert len({(r.start, r.stop) for _, r in places}) == 1
            assert [i for b, _ in places for i in b] == list(range(bricks))
        for g in ray_groups:  # same bricks, strips ascending, all strips
            places = [placement(bricks, rays, world, p) for p in g]
            assert len({(b.start, b.stop) for b, _ in places}) == 1
            assert [i for _, r in places for i in r] == list(range(rays))


def _worker(addr, world, rank, out, bricks, rays):
    import torch.distributed as dist

    from vrdd_tpu_torch.parallel import multihost
    from vrdd_tpu_torch.parallel.mesh import placement
    from vrdd_tpu_torch.parallel.scaling import measure_scaling

    torch.set_num_threads(1)
    multihost.initialize(addr, world, rank, backend="gloo")
    mesh = multihost.global_mesh(bricks=bricks, rays=rays, device="cpu")
    if (bricks, rays) == (1, world):  # JAX's default: rays = world // bricks
        assert multihost.global_mesh(device="cpu").local_rays == (
            mesh.local_rays)
        try:  # a ragged layout is refused before any group is made
            multihost.global_mesh(3, 2, device="cpu")
            raise AssertionError("bricks=3 x rays=2 on 2 processes placed")
        except ValueError as e:
            assert "ragged" in str(e)
    assert (mesh.local_bricks, mesh.local_rays) == placement(
        bricks, rays, world, rank)
    # an image's rows, JAX's P(RAY_AXIS): this process's strips
    from vrdd_tpu_torch.parallel import train

    img = np.arange(16 * 16 * 4, dtype=np.float32).reshape(16, 16, 4)
    rows = img[mesh.local_rays.start * 16 // rays:
               mesh.local_rays.stop * 16 // rays]
    assert np.array_equal(multihost.make_global(
        img, mesh, multihost.image_spec()).numpy(), rows)
    assert np.array_equal(train.shard_target_image(img, mesh).numpy(), rows)
    firsts = [p for p in range(world)
              if placement(bricks, rays, world, p)[1].start == 0]

    def gather(t):
        """The whole volume's tensor from each brick run's first holder;
        every holder of a run must agree (the ray group's sum)."""
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        for p in range(world):
            first = firsts[placement(bricks, rays, world, p)[0].start
                           * len(firsts) // bricks]
            assert torch.equal(parts[p], parts[first]), (p, first)
        return torch.cat([parts[p] for p in firsts])

    res = distributed_case(mesh, gather)
    scaling = measure_scaling(["cpu"], size=8, image=16, iters=1)
    np.savez(out, scaling_efficiency=scaling["scaling_efficiency"],
             scaling_mesh=scaling["scaling_mesh"], **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            int(sys.argv[5]), int(sys.argv[6]))
