"""Multi-process support (counterpart of ``vrdd_tpu/parallel/multihost.py``).

Each process joins one ``torch.distributed`` process group (NCCL with one
card a process, or Gloo); the ``(bricks, rays)`` mesh then spans the
processes as JAX's spans their devices (``parallel/mesh.py placement``:
rays-on-hosts by default, each process rendering its image rows; any
layout whose shards split evenly over the processes, ragged runs included)
and the SAME renderers of ``parallel/sweep.py`` and ``parallel/bricks.py``
run unchanged: each returns this process's rows, a strip's collectives
cross the processes of its strip group, a slab's gradient sums over its
slab group, and :func:`gather_image` joins the rows.
Nothing here reads a cluster from the environment: the caller names the
address, the world size and the rank (or sets torch's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` and passes None).

Tested with real 2-, 3- and 4-process Gloo runs in
``tests/test_torch_multihost.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vrdd_tpu_torch.parallel.mesh import (
    BRICK_AXIS, RAY_AXIS, Mesh, _gather_strips, holders, local_rows,
    placement)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent). ``coordinator_address`` is
    ``host:port`` (None: torch's environment variables); ``backend``
    defaults to NCCL when a GPU is present, else Gloo. With a GPU present
    each process takes the GPU of its rank modulo the count, whatever the
    backend."""
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
    if torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _subgroups(families, rank):
    """Create every group of more than one process, once per set of ranks
    (the call is collective: every rank makes them all, in one order), and
    return, per family, this rank's group of each entry (None: a group of
    one, or one this rank is not in)."""
    made = {}
    for ranks in (m for family in families for m in family):
        if len(ranks) > 1 and ranks not in made:
            made[ranks] = dist.new_group(list(ranks))
    return tuple(tuple(made.get(m) if rank in m else None for m in family)
                 for family in families)


def global_mesh(bricks: int = 1, rays: Optional[int] = None,
                device=None) -> Mesh:
    """The ``(bricks, rays)`` mesh over every process of the group, placed
    as JAX places devices (``rays`` None: ``world // bricks``, JAX's
    default). Every process must call it, with the same arguments: it
    creates the strip and slab groups. ``device`` None is this process's
    GPU, whatever the backend; pass ``"cpu"`` for the CPU."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if rays is None:
        rays = world // bricks
    placement(bricks, rays, world, rank)  # a layout that does not split
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    strip_groups, slab_groups = _subgroups(holders(bricks, rays, world), rank)
    return Mesh(int(bricks), int(rays), torch.device(device),
                dist.group.WORLD, strip_groups, slab_groups)


def make_global(x, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This process's part of an array every process passes whole: its run
    of bricks along the axis ``spec`` names ``bricks``, its ray strips (in
    ascending order) along the axis it names ``rays``, on the mesh's
    device."""
    x = torch.as_tensor(np.asarray(x))
    for axis, name in enumerate(spec):
        if name == BRICK_AXIS:
            run = mesh.local_bricks
            per = x.shape[axis] // mesh.bricks
            x = x.narrow(axis, run[0] * per, len(run) * per)
        elif name == RAY_AXIS:
            x = local_rows(x, mesh, axis)
    return x.contiguous().to(mesh.device)


def stats_volume_spec() -> tuple:
    return (BRICK_AXIS, None, None, None)


def image_spec() -> tuple:
    return (RAY_AXIS, None, None)


def gather_image(img: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The full ``(H, W, 4)`` image on the host of every process, from this
    process's rows ``img`` of a render on ``mesh`` (every strip in its place:
    all-gathers over its slab groups)."""
    return _gather_strips(img.detach(), mesh).cpu().numpy()
