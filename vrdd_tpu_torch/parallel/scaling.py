"""Linear-scaling harness: rays/s on one device against N (counterpart of
``vrdd_tpu/parallel/scaling.py``).

``measure_scaling`` renders the same ``size^3 -> image^2`` problem through
the distributed sweep, forward and a full training step (volume and LUT
learned, ``make_sweep_fit_step``), on a one-shard mesh and, when the
process is one of N > 1 in a process group (``parallel/multihost.py``), on
the mesh over all N, and reports the strong-scaling efficiency ``t_1 / (N *
t_N)``. One process (one card, or the CPU) times only the one-shard mesh and
reports no efficiency.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _factor_mesh(n: int) -> tuple:
    """(bricks, rays) for n devices: prefer splitting both axes, bricks <=
    rays (JAX's factorization)."""
    best = (1, n)
    b = 1
    while b * b <= n:
        if n % b == 0:
            best = (b, n // b)
        b += 1
    return best


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(
    devices: Optional[Sequence] = None,
    *,
    size: int = 0,
    image: int = 0,
    n_planes: int = 0,
    iters: int = 2,
    backend: str = "auto",
) -> dict:
    """Strong-scaling efficiency of the distributed sweep.

    ``devices``: this process's device (a sequence of one; None: the
    current CUDA device). N is the process group's world size (1 without
    one). Defaults: the headline shape on the card (512^3 -> 1024^2), a
    small one on the CPU. The N-process mesh is JAX's for N devices
    (:func:`_factor_mesh`), one shard a process: both axes split over the
    processes, the problem rounded up as JAX rounds it."""
    from vrdd_tpu_torch.core.transfer import default_transfer_function
    from vrdd_tpu_torch.parallel import multihost
    from vrdd_tpu_torch.parallel.mesh import make_mesh
    from vrdd_tpu_torch.parallel.sweep import (
        distributed_sweep_render, shard_scalar_volume)
    from vrdd_tpu_torch.parallel.train import (
        make_sweep_fit_step, shard_target_image)

    mesh1 = make_mesh(1, 1, devices=devices)
    device = mesh1.device
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    on_card = device.type == "cuda"
    if size <= 0:
        size = 512 if on_card else 32
    if image <= 0:
        image = 1024 if on_card else 128
    if backend == "auto":
        backend = "pallas" if on_card else "xla"
    bricks, rays = _factor_mesh(n_dev)
    # round the problem up to the mesh's divisibility contract as JAX does
    # (on the kernels: 8 rows a strip at least, images a multiple of 128)
    size += -size % bricks
    row_mult = rays * (8 if backend == "pallas" else 1)
    image += -image % max(row_mult, 128 if backend == "pallas" else 1)
    if n_planes <= 0:
        n_planes = size
    n_planes += -n_planes % bricks

    rng = np.random.default_rng(0)
    vol_host = rng.random((size, size, size), dtype=np.float32)
    tf = default_transfer_function()
    origin = np.asarray([0.0, 0.0, 4.0], dtype=np.float32)

    def timed(mesh):
        vs = shard_scalar_volume(vol_host, mesh)

        def fwd():
            return distributed_sweep_render(
                vs, origin, tf, width=image, height=image, mesh=mesh,
                n_planes=n_planes, backend=backend)

        with torch.no_grad():
            fwd()  # warm: the kernels' build and first launch
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fwd()
            float(out.sum())
        return (time.perf_counter() - t0) / iters

    def timed_step(mesh):
        vs = shard_scalar_volume(vol_host, mesh)
        init_fn, step_fn = make_sweep_fit_step(
            mesh, image, image, learn_volume=True, n_planes=n_planes,
            backend=backend)
        params, opt_state = init_fn(tf, volume=vs)
        target = shard_target_image(
            np.full((image, image, 4), 0.25, np.float32), mesh)
        params, opt_state, loss = step_fn(params, opt_state, vs, origin,
                                          target)  # warm
        float(loss)
        t0 = time.perf_counter()
        for _ in range(iters):
            params, opt_state, loss = step_fn(params, opt_state, vs, origin,
                                              target)
        float(loss)
        return (time.perf_counter() - t0) / iters

    t1 = timed(mesh1)
    t1_fb = timed_step(mesh1)
    out = {
        "scaling_n_devices": n_dev,
        "scaling_device": (torch.cuda.get_device_name(device) if on_card
                           else "cpu"),
        "scaling_shape": f"{size}^3 -> {image}^2",
        "scaling_t1_ms": t1 * 1e3,
        "scaling_rays_per_s_1dev": image * image / t1,
        "scaling_fwdbwd_t1_ms": t1_fb * 1e3,
    }
    if n_dev == 1:
        out["scaling_efficiency"] = None
        out["scaling_fwdbwd_efficiency"] = None
        out["scaling_note"] = (
            "1 device; harness ready (forward and training step) - run one "
            "process per device in a process group to measure scaling")
        return out
    mesh_n = multihost.global_mesh(bricks, rays, device=device)
    tn = timed(mesh_n)
    tn_fb = timed_step(mesh_n)
    out.update(
        scaling_mesh=f"bricks={bricks} x rays={rays}",
        scaling_tN_ms=tn * 1e3,
        scaling_rays_per_s_Ndev=image * image / tn,
        scaling_efficiency=t1 / (n_dev * tn),
        scaling_fwdbwd_tN_ms=tn_fb * 1e3,
        scaling_fwdbwd_efficiency=t1_fb / (n_dev * tn_fb),
    )
    return out
