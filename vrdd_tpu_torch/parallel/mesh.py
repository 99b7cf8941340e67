"""Device mesh and its collectives (counterpart of
``vrdd_tpu/parallel/mesh.py``).

JAX names a 2-D logical mesh ``("bricks", "rays")`` and runs one SPMD
function per device under ``shard_map``:

- ``bricks``: the volume's Z axis is sharded into slabs;
- ``rays``: the image rows are sharded into strips.

JAX reshapes the device list into that grid in device order, and each
process's devices are consecutive; on a pod the rays axis spans the hosts
("rays-on-hosts") and the bricks axis a host's chips. Here a :class:`Mesh`
is the same ``(bricks, rays)`` grid of SHARDS, placed over processes the
same way (:func:`placement`): the shards, in row-major ``(brick, ray)``
order, split into ``world`` equal contiguous runs, one per process. A run is
either whole brick rows (every ray strip of a run of bricks) or a run of
ray strips of one brick; with one shard a process it is JAX's placement. A
process runs its shards in turn on its one device (a world of one holds
them all: the counterpart of JAX's virtual device mesh, and the way one
card runs the sort-last sweep). More processes join through a
``torch.distributed`` process group (:mod:`.multihost`), and two subgroups
of it carry the collectives (:func:`process_groups`):

- the BRICK group: the processes that hold the same ray strips, in brick
  order; :func:`all_gather`, :func:`psum` and :func:`halo_exchange` (JAX's
  ``ppermute`` of edge layers: a local slice between bricks of one
  process, a send/recv to the neighbour process) run over it;
- the RAY group: the processes that hold the same bricks, in strip order;
  :func:`gather_rays` joins their strips into the image, :func:`grad_sum`
  sums a bricks-sharded leaf's gradient over it, and :func:`image_mean`
  forms a mean over the whole image from this process's rows.

:func:`replicate` marks inputs every shard reads (LUT, render parameters):
their gradient is summed over the whole world. A group of one process is
None, and its collectives are plain tensor ops.

The collectives are ``torch.autograd.Function``s with ``shard_map``'s
transpose rules: a value held by ``k`` processes hands each ``1 / k`` of
its cotangent (:func:`replicated_output`: a strip held by the brick group),
and the collectives' backward sums, so each process's gradient of its local
leaves is the gradient of the one loss.

On a Gloo group whose tensors live on the card, every collective moves
them through pinned host memory and back (Gloo carries CUDA tensors for few
of its operations); NCCL takes them where they are. The transport follows
the group's backend and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

BRICK_AXIS = "bricks"
RAY_AXIS = "rays"


def placement(bricks: int, rays: int, world: int, rank: int):
    """``(bricks, rays)`` the process ``rank`` of ``world`` holds, as two
    ranges: the ``rank``-th of ``world`` equal contiguous runs of the shards
    in row-major ``(brick, ray)`` order (JAX's device reshape with
    consecutive devices per process). A run must be whole brick rows or
    part of one row; anything else raises ``ValueError``."""
    if bricks < 1 or rays < 1:
        raise ValueError(f"bricks={bricks}, rays={rays}: both must be >= 1")
    n = bricks * rays
    if world < 1 or n % world:
        raise ValueError(f"bricks={bricks} x rays={rays}: {n} shards do not "
                         f"split over {world} processes")
    per = n // world
    first = rank * per
    if per % rays == 0:  # whole brick rows
        return range(first // rays, (first + per) // rays), range(rays)
    if rays % per == 0:  # a run of ray strips of one brick row
        r0 = first % rays
        return range(first // rays, first // rays + 1), range(r0, r0 + per)
    raise ValueError(
        f"bricks={bricks} x rays={rays} over {world} processes: a process's "
        f"run of {per} shards is neither whole brick rows nor part of one "
        "(ragged layouts are not covered)")


def process_groups(bricks: int, rays: int, world: int):
    """``(brick_groups, ray_groups)``: lists of rank lists, ascending. A
    brick group's processes hold the same ray strips (ascending rank is
    ascending brick), a ray group's the same bricks."""
    by_rays, by_bricks = {}, {}
    for p in range(world):
        b, r = placement(bricks, rays, world, p)
        by_rays.setdefault((r.start, r.stop), []).append(p)
        by_bricks.setdefault((b.start, b.stop), []).append(p)
    return list(by_rays.values()), list(by_bricks.values())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``bricks`` x ``rays`` shards on ``device``; ``group`` the process
    group of the whole world, ``brick_group`` / ``ray_group`` this
    process's subgroups (None: a world, or a group, of one)."""

    bricks: int
    rays: int
    device: torch.device
    group: Optional[object] = None
    brick_group: Optional[object] = None
    ray_group: Optional[object] = None

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_bricks(self) -> range:
        """The bricks this process holds, a contiguous run."""
        return placement(self.bricks, self.rays, self.world, self.rank)[0]

    @property
    def local_rays(self) -> range:
        """The ray strips this process holds, a contiguous run."""
        return placement(self.bricks, self.rays, self.world, self.rank)[1]

    @property
    def brick_procs(self) -> int:
        """The processes of this process's brick group."""
        return self.bricks // len(self.local_bricks)

    @property
    def ray_procs(self) -> int:
        """The processes of this process's ray group."""
        return self.rays // len(self.local_rays)


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


# ---- transport -------------------------------------------------------------

def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum the contiguous ``t`` over ``group``, in place."""
    if _via_host(t, group):
        h = _pinned(t)
        dist.all_reduce(h, group=group)
        return t.copy_(h)
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every member of ``group``, concatenated along axis 0 in
    group-rank order."""
    src = _pinned(t) if _via_host(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def _swap_edges(send_lo, send_hi, recv_lo, recv_hi, group):
    """Send ``send_lo`` to the previous member of ``group`` and ``send_hi``
    to the next, receiving ``recv_lo`` from the previous and ``recv_hi``
    from the next (the ends of the chain skip their missing side)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    staged = _via_host(recv_lo, group)
    ops, back = [], []
    for peer, send, recv in ((rank - 1, send_lo, recv_lo),
                             (rank + 1, send_hi, recv_hi)):
        if 0 <= peer < world:
            peer = dist.get_global_rank(group, peer)
            send = _pinned(send) if staged else send.contiguous()
            if staged:
                back.append((recv, torch.empty(recv.shape, dtype=recv.dtype,
                                               pin_memory=True)))
                recv = back[-1][1]
            ops += [dist.P2POp(dist.isend, send, peer, group),
                    dist.P2POp(dist.irecv, recv, peer, group)]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    for dst, src in back:
        dst.copy_(src)


# ---- the collectives --------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group):
        ctx.group = group
        ctx.n = local.shape[0]
        return _all_gather(local, group)

    @staticmethod
    def backward(ctx, g):
        # all-reduce of the gathered cotangent, then this rank's slice: the
        # gather's transpose without a reduce-scatter (Gloo has none)
        g = _all_reduce(g.contiguous().clone(), ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


class _AllReduce(torch.autograd.Function):
    """psum: sums forward, sums the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _Total(torch.autograd.Function):
    """The sum of one term a member, held by every member: each member's
    cotangent goes to its own term."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    """Identity forward; the gradient all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReplicatedOutput(torch.autograd.Function):
    """Identity forward; ``1 / holders`` of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, holders):
        ctx.holders = holders
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.holders, None


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Stack this process's per-brick ``parts`` (in brick order) with those
    of the rest of its brick group: ``(bricks, ...)``."""
    local = torch.stack(list(parts))
    if mesh.brick_group is None:
        return local
    return _AllGather.apply(local, mesh.brick_group)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the brick group of ``x`` (the caller sums its own
    bricks)."""
    return x if mesh.brick_group is None else _AllReduce.apply(
        x, mesh.brick_group)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its gradient summed over ``group`` (a leaf every member holds
    whole; None: ``x`` itself)."""
    if group is None or not x.requires_grad:
        return x
    return _Replicate.apply(x, group)


def replicate(x, mesh: Mesh):
    """``x`` for every shard to read: a Python number as it is (no upload,
    no read-back at each launch), anything else as a float32 tensor on the
    mesh's device whose gradient is summed over the world."""
    if isinstance(x, (int, float)):
        return x
    x = torch.as_tensor(x, dtype=torch.float32, device=mesh.device)
    return grad_sum(x, mesh.group)


def replicated_output(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mark ``x``, this process's ray strips, as held by every process of
    its brick group (see the module docstring)."""
    if mesh.brick_group is None:
        return x
    return _ReplicatedOutput.apply(x, mesh.brick_procs)


def gather_rays(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole image from this process's rows ``x``: the strips of its
    ray group in ray order, held by each of its processes (the backward:
    an all-reduce over the group, this process's rows, ``1 / |group|`` of
    them)."""
    if mesh.ray_group is None:
        return x
    return _ReplicatedOutput.apply(_AllGather.apply(x, mesh.ray_group),
                                   mesh.ray_procs)


def image_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """JAX's ``jnp.mean`` over the whole image from ``x``, this process's
    rows of it: each process's mean weighted by its share of the rows, then
    summed over the ray group (each process's cotangent to its own
    term)."""
    m = torch.mean(x)
    if mesh.ray_group is None:
        return m
    return _Total.apply(m * (len(mesh.local_rays) / mesh.rays),
                        mesh.ray_group)


class _Halo(torch.autograd.Function):
    """One ghost z-layer on each side of a process's run of bricks, from
    the neighbour processes of its brick group (edge layers replicated at
    the volume's ends); the backward returns each ghost's cotangent to its
    owner's edge."""

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
    the neighbour's edge layer in the brick group, or this run's own edge
    layer at the volume's ends (clamp-to-edge addressing). Brick ``d``'s
    haloed slab is then a slice of the result."""
    if mesh.brick_group is None:
        return torch.cat([local[:1], local, local[-1:]])
    return _Halo.apply(local, mesh.brick_group)
