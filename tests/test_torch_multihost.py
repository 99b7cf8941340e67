"""The distributed renderers across real processes, joined by a Gloo process
group on the CPU (``vrdd_tpu_torch/parallel/multihost.py``), against the
same mesh held by one process; the mesh's placement against JAX's.

Five worlds:

- 2 processes, bricks=4 x rays=2: each holds two bricks and both ray
  strips (each strip's group is the world);
- 2 processes, bricks=1 x rays=2, JAX's ``global_mesh()`` default: each
  holds one ray strip of the one brick (the slab group is the world);
- 4 processes, bricks=2 x rays=2, one shard a process: every group has
  two processes;
- 3 processes, bricks=2 x rays=3 (ragged): rank 1 holds (0, 2) and (1, 0),
  two bricks of different strips, its strips {0, 2} not contiguous;
- 2 processes, bricks=3 x rays=2 (ragged): rank 0 holds bricks 0 and 1 of
  strip 0 and brick 0 of strip 1, so strip 0's group gathers two bricks
  from it and one from rank 1.

The halo exchange (a send/recv across a process boundary, and its
adjoint), the sort-last gather and its all-reduce transpose, the pass-2
psum and the seed cotangent into a brick of another process, the gradient
sums over the slab groups and the world, the strips' gather before the
rotated warp and in ``gather_image``, and the fit step's loss over the
slab groups are all in the loop. The worker is this file itself, run as a
script by the tests (``python tests/test_torch_multihost.py ADDRESS WORLD
RANK OUT BRICKS RAYS``); it imports no JAX."""

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


def _sizes(bricks, rays):
    """``(nz, H, H_hist)``: the volumes' z-extent and the images' heights,
    8, 16 and 20, or 12 where the bricks and 24 where the strips are three
    (they must divide)."""
    return (12 if bricks % 3 == 0 else 8,
            24 if rays % 3 == 0 else 16, 24 if rays % 3 == 0 else 20)


def _inputs(nz=8):
    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume

    vol = gaussian_blob_volume((nz, 8, 8), seed=11)
    stats = np.stack([vol, vol * 0.5, 1.0 - vol], axis=-1).astype(np.float32)
    rng = np.random.default_rng(2)
    h = rng.random((nz, 4, 8, 8)).astype(np.float32) + 0.2
    h /= h.sum(axis=1, keepdims=True)
    return stats, gaussian_blob_volume((nz, 16, 16), seed=7), h


def distributed_case(mesh, gather):
    """Every distributed path on ``mesh``; ``gather(t)`` joins a tensor of
    this process's bricks along axis 0 into the whole volume's."""
    from vrdd_tpu_torch.core.geometry import (
        default_benchmark_inv_view, inv_view_from_rotation_translation)
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.parallel import bricks, multihost, sweep, train
    from vrdd_tpu_torch.utils.config import MarchConfig

    nz, hgt, hgt_hist = _sizes(mesh.bricks, mesh.rays)
    stats, vol, h = _inputs(nz)
    tf = default_transfer_function()
    march = MarchConfig(**MARCH)
    out = {"scan": multihost.gather_image(bricks.distributed_render_image(
        multihost.make_global(stats, mesh, multihost.stats_volume_spec()),
        default_benchmark_inv_view(), tf, 0.1, width=16, height=hgt,
        march=march, mesh=mesh), mesh)}
    # n_planes = 2 nz: the pre-blend reads the other rank's ghost layer
    for backend in ("xla", "pallas"):
        v = sweep.shard_scalar_volume(vol, mesh).requires_grad_(True)
        lut = torch.tensor(tf, requires_grad=True)
        img = sweep.distributed_sweep_render(
            v, O, lut, 0.3, width=16, height=hgt, march=march, mesh=mesh,
            n_planes=2 * nz, backend=backend,
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
        width=24, height=hgt_hist, mesh=mesh, wrt=("hist", "lut"))
    # the whole image's sum, as one process forms it
    (train.image_mean(img ** 2, mesh) * (24 * hgt_hist * 4)).backward()
    out.update({"hist_img": multihost.gather_image(img, mesh),
                "hist_g": gather(hist.grad).numpy(),
                "hist_g_lut": lut.grad.numpy()})
    # a rotated frame: the m-grid's strips gathered before the warp, the
    # whole volume's gradient summed over the world
    v = torch.tensor(vol, requires_grad=True)
    lut = torch.tensor(tf, requires_grad=True)
    img = sweep.distributed_shearwarp_render(
        v, inv_view_from_rotation_translation(*ROT, (0.0, 0.0, -4.0)), 16,
        16, lut, 0.3, march=march, mesh=mesh, n_planes=2 * nz,
        backend="xla")
    torch.mean((img - 0.25) ** 2).backward()
    out.update({"rot_img": img.detach().numpy(),
                "rot_g_vol": v.grad.numpy(), "rot_g_lut": lut.grad.numpy()})
    # one step of each fit, volume and LUT learned
    target = np.full((hgt, 16, 4), 0.25, np.float32)
    init_fn, step_fn = train.make_sweep_fit_step(
        mesh, 16, hgt, march, learn_volume=True, n_planes=2 * nz,
        backend="pallas")
    vs = sweep.shard_scalar_volume(vol, mesh)
    params, opt = init_fn(tf, volume=vs)
    params, opt, loss = step_fn(params, opt, vs, O,
                                train.shard_target_image(target, mesh))
    out.update({"fit_loss": loss.numpy(),
                "fit_g_lut": params["tf_lut"].grad.numpy(),
                "fit_g_vol": gather(params["volume"].grad).numpy(),
                "fit_lut": params["tf_lut"].detach().numpy()})
    init_fn, step_fn = train.make_tf_fit_step(mesh, 16, hgt, march=march,
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


@pytest.mark.parametrize("world,bricks,rays", [(3, 2, 3), (2, 3, 2)],
                         ids=["3proc-2x3", "2proc-3x2"])
def test_gloo_ragged_world_matches_one_process(world, bricks, rays,
                                               tmp_path_factory):
    """Ragged runs of shards (JAX places them): a process holds bricks of
    different strips (2 x 3 on 3), or unequal counts of a strip's bricks
    (3 x 2 on 2)."""
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


def test_gloo_ragged_world_matches_jax(tmp_path_factory):
    """The gathered 3-process bricks=2 x rays=3 sweep images and LUT
    gradient against JAX's ``distributed_sweep_render`` on its CPU mesh
    ``make_mesh(2, 3)`` of six devices (the tolerances above)."""
    import jax
    import jax.numpy as jnp

    from vrdd_tpu.core.transfer import default_transfer_function
    from vrdd_tpu.parallel import mesh as jmesh
    from vrdd_tpu.parallel import sweep as jsweep
    from vrdd_tpu.utils.config import MarchConfig as JMarchConfig

    ranks = _run_world(3, 2, 3, tmp_path_factory)
    nz, hgt, _ = _sizes(2, 3)
    _, vol, _ = _inputs(nz)
    m = jmesh.make_mesh(2, 3, devices=jax.devices()[:6])

    def loss(lut):
        img = jsweep.distributed_sweep_render(
            jsweep.shard_scalar_volume(jnp.asarray(vol), m), jnp.asarray(O),
            lut, jnp.float32(0.3), width=16, height=hgt,
            march=JMarchConfig(**MARCH), mesh=m, n_planes=2 * nz,
            backend="xla")
        return jnp.mean((img - 0.25) ** 2), img

    (_, img), g_lut = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(default_transfer_function()))
    for got in ranks:
        for backend in ("xla", "pallas"):
            np.testing.assert_allclose(got[f"{backend}_img"], np.asarray(img),
                                       atol=2e-5, rtol=0, err_msg=backend)
            assert _rel_l2(got[f"{backend}_g_lut"], g_lut) < 1e-3, backend


class _Device:
    """A stand-in for a JAX device where the mesh has more shards than
    the CPU has virtual devices: ``make_mesh`` only reshapes the list."""

    def __init__(self, i):
        self.id = i


def _rect(cells):
    bs = sorted({b for b, _ in cells})
    rs = sorted({r for _, r in cells})
    return {(b, r) for b in bs for r in rs} == set(cells), bs, rs


@pytest.mark.parametrize("bricks,rays", [
    (b, r) for b in range(1, 13) for r in range(1, 13) if b * r <= 12])
def test_placement_matches_jax_device_reshape(bricks, rays):
    """Process ``p`` of ``world`` holds the shards where JAX's
    ``np.asarray(devices).reshape(bricks, rays)`` puts its devices, with
    ``bricks * rays / world`` consecutive devices a process, ragged runs
    included; the strip and slab groups are the holders of each strip and
    brick (in a rectangular layout, the processes holding the same strips
    and the same bricks); a layout that does not split evenly raises."""
    import jax

    from vrdd_tpu.parallel import mesh as jmesh
    from vrdd_tpu_torch.parallel.mesh import (
        halo_sources, holders, placement)

    n = bricks * rays
    devices = jax.devices()
    devices = (devices[:n] if n <= len(devices)
               else [_Device(i) for i in range(n)])
    grid = np.vectorize(lambda d: d.id)(
        jmesh.make_mesh(bricks, rays, devices=devices).devices)
    for world in range(1, 5):
        if n % world:
            for p in range(world):
                with pytest.raises(ValueError, match="do not split"):
                    placement(bricks, rays, world, p)
            continue
        owner = (grid - grid.min()) // (n // world)
        runs = [list(zip(*np.nonzero(owner == p))) for p in range(world)]
        for p, cells in enumerate(runs):
            assert placement(bricks, rays, world, p) == tuple(
                (int(b), int(r)) for b, r in cells), (world, p)
        strips, slabs = holders(bricks, rays, world)
        for r in range(rays):  # bricks ascending over the group, all bricks
            assert strips[r] == tuple(sorted(set(owner[:, r].tolist())))
            assert [b for p in strips[r] for b, s in runs[p] if s == r] == (
                list(range(bricks)))
        for b in range(bricks):  # strips ascending over the group
            assert slabs[b] == tuple(sorted(set(owner[b].tolist())))
            assert [r for p in slabs[b] for d, r in runs[p] if d == b] == (
                list(range(rays)))
        for p, (lo, hi) in enumerate(halo_sources(bricks, rays, world)):
            b0, b1 = runs[p][0][0], runs[p][-1][0]
            assert (lo is None) == (b0 == 0) and (hi is None) == (
                b1 == bricks - 1)
            assert lo is None or any(d == b0 - 1 for d, _ in runs[lo])
            assert hi is None or any(d == b1 + 1 for d, _ in runs[hi])
        if all(_rect(c)[0] for c in runs):
            # the old brick and ray groups: same strips, same bricks
            for g in strips:
                assert len({tuple(_rect(runs[p])[2]) for p in g}) == 1
            for g in slabs:
                assert len({tuple(_rect(runs[p])[1]) for p in g}) == 1


def _worker(addr, world, rank, out, bricks, rays):
    import torch.distributed as dist

    from vrdd_tpu_torch.parallel import multihost
    from vrdd_tpu_torch.parallel.mesh import holders, placement
    from vrdd_tpu_torch.parallel.scaling import measure_scaling

    torch.set_num_threads(1)
    multihost.initialize(addr, world, rank, backend="gloo")
    mesh = multihost.global_mesh(bricks=bricks, rays=rays, device="cpu")
    if (bricks, rays) == (1, world):  # JAX's default: rays = world // bricks
        assert multihost.global_mesh(device="cpu").local_rays == (
            mesh.local_rays)
        # a ragged layout is placed: rank 0 holds bricks 0 and 1 of strip 0
        ragged = multihost.global_mesh(3, 2, device="cpu")
        assert ragged.shards == placement(3, 2, world, rank)
        assert ragged.strip_group(0) is not None
    shards = placement(bricks, rays, world, rank)
    assert mesh.shards == shards
    assert mesh.local_bricks == tuple(range(shards[0][0], shards[-1][0] + 1))
    assert mesh.local_rays == tuple(sorted({r for _, r in shards}))
    # an image's rows, JAX's P(RAY_AXIS): this process's strips in order
    from vrdd_tpu_torch.parallel import train

    hgt = _sizes(bricks, rays)[1]
    img = np.arange(hgt * 16 * 4, dtype=np.float32).reshape(hgt, 16, 4)
    per = hgt // rays
    rows = np.concatenate([img[r * per:(r + 1) * per]
                           for r in mesh.local_rays])
    assert np.array_equal(multihost.make_global(
        img, mesh, multihost.image_spec()).numpy(), rows)
    assert np.array_equal(train.shard_target_image(img, mesh).numpy(), rows)
    assert np.array_equal(multihost.gather_image(torch.from_numpy(rows),
                                                 mesh), img)
    slabs = holders(bricks, rays, world)[1]

    def gather(t):
        """The whole volume's tensor from the first holder of each slab;
        every holder of a slab must agree (its slab group's sum)."""
        runs = [None] * world
        dist.all_gather_object(runs, t.detach().numpy())
        zl = t.shape[0] // len(mesh.local_bricks)
        whole = []
        for b in range(bricks):
            copies = [runs[p][(b - placement(bricks, rays, world, p)[0][0])
                              * zl:][:zl] for p in slabs[b]]
            for p, c in zip(slabs[b], copies):
                assert np.array_equal(c, copies[0]), (b, p)
            whole.append(copies[0])
        return torch.from_numpy(np.concatenate(whole))

    res = distributed_case(mesh, gather)
    scaling = measure_scaling(["cpu"], size=8, image=16, iters=1)
    np.savez(out, scaling_efficiency=scaling["scaling_efficiency"],
             scaling_mesh=scaling["scaling_mesh"], **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            int(sys.argv[5]), int(sys.argv[6]))
