"""The distributed renderers across real processes: two ranks joined by a
Gloo process group on the CPU (``vrdd_tpu_torch/parallel/multihost.py``),
each holding two of the four bricks of a bricks=4 x rays=2 mesh, against
the same mesh held by one process.

The halo exchange (a send/recv across the rank boundary, and its adjoint),
the sort-last gather and its all-reduce transpose, the pass-2 psum and the
seed cotangent into a brick of the other rank, and the LUT gradient's
all-reduce are all in the loop. The worker is this file itself, run as a
script by the test (``python tests/test_torch_multihost.py ADDRESS WORLD
RANK OUT``); it imports no JAX."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

MARCH = dict(max_steps=50, tstep=0.05)
O = np.array([0.0, 0.0, 4.0], np.float32)


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
    from vrdd_tpu_torch.core.geometry import default_benchmark_inv_view
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.parallel import bricks, multihost, sweep
    from vrdd_tpu_torch.utils.config import MarchConfig

    stats, vol, h = _inputs()
    tf = default_transfer_function()
    march = MarchConfig(**MARCH)
    out = {"scan": multihost.gather_image(bricks.distributed_render_image(
        multihost.make_global(stats, mesh, multihost.stats_volume_spec()),
        default_benchmark_inv_view(), tf, 0.1, width=16, height=16,
        march=march, mesh=mesh))}
    # n_planes = 2 nz: the pre-blend reads the other rank's ghost layer
    for backend in ("xla", "pallas"):
        v = sweep.shard_scalar_volume(vol, mesh).requires_grad_(True)
        lut = torch.tensor(tf, requires_grad=True)
        img = sweep.distributed_sweep_render(
            v, O, lut, 0.3, width=16, height=16, march=march, mesh=mesh,
            n_planes=16, backend=backend,
            plane_chunk=4 if backend == "pallas" else 8)
        loss = torch.mean((img - 0.25) ** 2)
        loss.backward()
        out.update({f"{backend}_img": multihost.gather_image(img),
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
    (img ** 2).sum().backward()
    out.update({"hist_img": multihost.gather_image(img),
                "hist_g": gather(hist.grad).numpy(),
                "hist_g_lut": lut.grad.numpy()})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_one_process(tmp_path):
    addr = f"127.0.0.1:{_free_port()}"
    out = str(tmp_path / "result.npz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), addr, "2", str(r), out],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
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
    got = np.load(out)

    from vrdd_tpu_torch.parallel.mesh import make_mesh

    want = distributed_case(make_mesh(4, 2, devices=["cpu"]), lambda t: t)
    assert set(got.files) == set(want) | {"scaling_efficiency"}
    assert float(want["hist_img"][..., 3].max()) > 0.95  # pass 2 runs
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert float(got["scaling_efficiency"]) > 0


def _worker(addr, world, rank, out):
    import torch.distributed as dist

    from vrdd_tpu_torch.parallel import multihost
    from vrdd_tpu_torch.parallel.scaling import measure_scaling

    torch.set_num_threads(1)
    multihost.initialize(addr, world, rank, backend="gloo")
    mesh = multihost.global_mesh(bricks=4, rays=2)
    assert mesh.local_bricks == range(2 * rank, 2 * rank + 2)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    res = distributed_case(mesh, gather)
    scaling = measure_scaling(["cpu"], size=8, image=16, iters=1)
    if rank == 0:
        np.savez(out, scaling_efficiency=scaling["scaling_efficiency"], **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
