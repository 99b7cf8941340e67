"""Device mesh and its collectives (counterpart of
``vrdd_tpu/parallel/mesh.py``).

JAX names a 2-D logical mesh ``("bricks", "rays")`` and runs one SPMD
function per device under ``shard_map``:

- ``bricks``: the volume's Z axis is sharded into slabs;
- ``rays``: the image rows are sharded into strips.

Here a :class:`Mesh` is the same ``(bricks, rays)`` grid of SHARDS, held by
one or more processes. Each process holds a contiguous run of bricks and
every ray strip, on its one device, and runs its shards in turn (a world of
one holds them all: the counterpart of JAX's virtual device mesh, and the
way one card runs the sort-last sweep). More processes join through a
``torch.distributed`` process group (:mod:`.multihost`; NCCL on the card,
Gloo on the CPU), and the bricks' collectives cross them:

- :func:`all_gather` and :func:`psum` over ``bricks``;
- :func:`halo_exchange`, JAX's ``ppermute`` of edge layers: a local slice
  between bricks of one process, a send/recv to the neighbour process;
- :func:`replicate` for inputs every shard reads (LUT, render parameters):
  its backward is the gradient all-reduce over the mesh;
- :func:`replicated_output` for the image every process holds whole.

They are ``torch.autograd.Function``s with ``shard_map``'s transpose rules:
an output replicated over ``bricks`` hands each process ``1 / world`` of its
cotangent, and the collectives' backward sums, so each process's gradient
of its local leaves is the gradient of the one loss. In a world of one they
are plain tensor ops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

BRICK_AXIS = "bricks"
RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``bricks`` x ``rays`` shards on ``device``; ``group`` the process
    group the bricks span (None: a world of one)."""

    bricks: int
    rays: int
    device: torch.device
    group: Optional[object] = None

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_bricks(self) -> range:
        """The bricks this process holds, a contiguous run."""
        per = self.bricks // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def make_mesh(
    bricks: int = 1,
    rays: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ``(bricks, rays)`` mesh of shards in this process, all on one
    device: ``devices`` names it (a sequence of one device, or of one device
    repeated per shard); None is the current CUDA device. ``rays`` defaults
    to 1."""
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devs = {torch.device(d) for d in devices}
    if len(devs) != 1:
        raise ValueError(
            f"one process runs its shards on one device, got {sorted(map(str, devs))}; "
            "span devices with processes (parallel/multihost.py)"
        )
    rays = 1 if rays is None else rays
    if bricks < 1 or rays < 1:
        raise ValueError(f"bricks={bricks}, rays={rays}: both must be >= 1")
    return Mesh(int(bricks), int(rays), devs.pop())


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group):
        ctx.group = group
        ctx.n = local.shape[0]
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        # all-reduce of the gathered cotangent, then this rank's slice: the
        # gather's transpose without a reduce-scatter (Gloo has none)
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


class _AllReduce(torch.autograd.Function):
    """psum: sums forward, sums the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Replicate(torch.autograd.Function):
    """Identity forward; the gradient all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReplicatedOutput(torch.autograd.Function):
    """Identity forward; ``1 / world`` of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Stack this process's per-brick ``parts`` (in brick order) with every
    other process's: ``(bricks, ...)``."""
    local = torch.stack(list(parts))
    if mesh.group is None:
        return local
    return _AllGather.apply(local, mesh.group)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the processes of ``x`` (the caller sums its own bricks)."""
    return x if mesh.group is None else _AllReduce.apply(x, mesh.group)


def replicate(x, mesh: Mesh):
    """``x`` for every shard to read: a Python number as it is (no upload,
    no read-back at each launch), anything else as a float32 tensor on the
    mesh's device whose gradient is summed over the processes."""
    if isinstance(x, (int, float)):
        return x
    x = torch.as_tensor(x, dtype=torch.float32, device=mesh.device)
    if mesh.group is None or not x.requires_grad:
        return x
    return _Replicate.apply(x, mesh.group)


def replicated_output(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mark ``x`` as held whole by every process (see the module
    docstring)."""
    return x if mesh.group is None else _ReplicatedOutput.apply(x, mesh.world)


def _swap_edges(send_lo, send_hi, recv_lo, recv_hi, group):
    """Send ``send_lo`` to the previous process and ``send_hi`` to the
    next, receiving ``recv_lo`` from the previous and ``recv_hi`` from the
    next (the ends of the chain skip their missing side)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    ops = []
    for peer, send, recv in ((rank - 1, send_lo, recv_lo),
                             (rank + 1, send_hi, recv_hi)):
        if 0 <= peer < world:
            peer = dist.get_global_rank(group, peer)
            ops += [dist.P2POp(dist.isend, send.contiguous(), peer, group),
                    dist.P2POp(dist.irecv, recv, peer, group)]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()


class _Halo(torch.autograd.Function):
    """One ghost z-layer on each side of a process's run of bricks, from
    the neighbour processes (edge layers replicated at the volume's ends);
    the backward returns each ghost's cotangent to its owner's edge."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.group = group
        lo, hi = local[:1].clone(), local[-1:].clone()
        _swap_edges(local[:1], local[-1:], lo, hi, group)
        return torch.cat([lo, local, hi])

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        d = g[1:-1].clone()
        # a replicated edge layer's ghost cotangent stays here
        if rank == 0:
            d[:1] += g[:1]
        if rank == world - 1:
            d[-1:] += g[-1:]
        from_lo = torch.zeros_like(g[:1])
        from_hi = torch.zeros_like(g[:1])
        _swap_edges(g[:1], g[-1:], from_lo, from_hi, group)
        if rank > 0:
            d[:1] += from_lo
        if rank < world - 1:
            d[-1:] += from_hi
        return d, None


def halo_exchange(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's run of bricks with one ghost z-layer on each side:
    the neighbour process's edge layer, or this run's own edge layer at the
    volume's ends (clamp-to-edge addressing). Brick ``d``'s haloed slab is
    then a slice of the result."""
    if mesh.group is None:
        return torch.cat([local[:1], local, local[-1:]])
    return _Halo.apply(local, mesh.group)
