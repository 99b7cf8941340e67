"""Multi-process support (counterpart of ``vrdd_tpu/parallel/multihost.py``).

Each process joins one ``torch.distributed`` process group (NCCL on the
card, Gloo on the CPU); the ``(bricks, rays)`` mesh then spans the processes
and the SAME renderers of ``parallel/sweep.py`` and ``parallel/bricks.py``
run unchanged: each process holds a contiguous run of bricks and every ray
strip, and the bricks' collectives (``parallel/mesh.py``) cross the process
boundaries. Nothing here reads a cluster from the environment: the caller
names the address, the world size and the rank (or sets torch's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` and passes None).

Tested with a real 2-process Gloo run in ``tests/test_torch_multihost.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vrdd_tpu_torch.parallel.mesh import BRICK_AXIS, RAY_AXIS, Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent). ``coordinator_address`` is
    ``host:port`` (None: torch's environment variables); ``backend``
    defaults to NCCL when a GPU is present, else Gloo. On the card each
    process takes the GPU of its rank modulo the count."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{coordinator_address}" if coordinator_address
                     else "env://"),
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
    )
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_mesh(bricks: int = 1, rays: Optional[int] = None) -> Mesh:
    """The ``(bricks, rays)`` mesh over every process of the group: each
    holds ``bricks / world`` bricks, on its GPU under NCCL, else the CPU."""
    world = dist.get_world_size()
    rays = 1 if rays is None else rays
    if bricks % world:
        raise ValueError(f"bricks={bricks} must divide over {world} processes")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(int(bricks), int(rays), device, dist.group.WORLD)


def make_global(x, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This process's part of an array every process passes whole: its run
    of bricks along the axis ``spec`` names ``bricks``, every ray strip
    (processes hold all of them), on the mesh's device."""
    x = torch.as_tensor(np.asarray(x))
    for axis, name in enumerate(spec):
        if name == BRICK_AXIS:
            per = x.shape[axis] // mesh.bricks
            b = mesh.local_bricks
            x = x.narrow(axis, b.start * per, len(b) * per)
    return x.contiguous().to(mesh.device)


def stats_volume_spec() -> tuple:
    return (BRICK_AXIS, None, None, None)


def image_spec() -> tuple:
    return (RAY_AXIS, None, None)


def gather_image(img: torch.Tensor) -> np.ndarray:
    """The full ``(H, W, 4)`` image on the host of every process (each one
    already holds every ray strip)."""
    return img.detach().cpu().numpy()
