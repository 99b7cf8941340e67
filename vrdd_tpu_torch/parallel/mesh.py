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
order, split into ``world`` equal contiguous runs, one per process, which
is JAX's owner grid for every layout. A run may be ragged: at ``bricks=2 x
rays=3`` on 3 processes, process 1 holds ``(0, 2)`` and ``(1, 0)``, two
bricks of different strips. A process runs its shards in turn on its one
device (a world of one holds them all: the counterpart of JAX's virtual
device mesh, and the way one card runs the sort-last sweep). More
processes join through a ``torch.distributed`` process group
(:mod:`.multihost`), and two families of its subgroups carry the
collectives (:func:`holders`):

- the STRIP group of strip ``r``: the processes holding a shard of it, in
  brick order; :func:`all_gather` and :func:`psum` run over it;
- the SLAB group of brick ``b``: the processes holding a shard of it (each
  a copy of its slab), in strip order; :func:`slab_sum` sums a
  bricks-sharded leaf's gradient over it slab by slab (:func:`strip_slabs`
  does so for the histogram path in one process's order of bf16 adds),
  and its members' strips of brick ``b`` are the whole image once, which
  :func:`gather_rays` and :func:`image_mean` join.

:func:`halo_exchange` (JAX's ``ppermute`` of edge layers) takes the ghost
layers of a process's run of slabs from a holder of each neighbouring slab.
:func:`replicate` marks inputs every shard reads (LUT, render parameters):
their gradient is summed over the whole world. A group of one process is
None, and its collectives are plain tensor ops. In a rectangular layout the
strip group is the set of processes holding the same strips and the slab
group the set holding the same bricks.

Every process walks its strips in ascending order and, within a strip, its
bricks in ascending order; the backward walks them back. That is one total
order over every collective, so collectives on different groups cannot
wait on each other in a cycle.

The collectives are ``torch.autograd.Function``s with ``shard_map``'s
transpose rules: a value held by ``k`` processes hands each ``1 / k`` of
its cotangent (:func:`replicated_output`: a strip held by its strip group),
and the collectives' backward sums, so each process's gradient of its local
leaves is the gradient of the one loss.

On a Gloo group whose tensors live on the card, every collective moves
them through pinned host memory and back (Gloo carries CUDA tensors for few
of its operations); NCCL takes them where they are. The transport follows
the group's backend and nothing else.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

BRICK_AXIS = "bricks"
RAY_AXIS = "rays"


@functools.lru_cache(maxsize=256)
def placement(bricks: int, rays: int, world: int, rank: int) -> tuple:
    """The ``(brick, ray)`` shards the process ``rank`` of ``world`` holds,
    in row-major order: the ``rank``-th of ``world`` equal contiguous runs
    of the shards in row-major order (JAX's device reshape with consecutive
    devices per process). Raises ``ValueError`` where ``world`` does not
    divide ``bricks * rays``."""
    if bricks < 1 or rays < 1:
        raise ValueError(f"bricks={bricks}, rays={rays}: both must be >= 1")
    n = bricks * rays
    if world < 1 or n % world:
        raise ValueError(f"bricks={bricks} x rays={rays}: {n} shards do not "
                         f"split over {world} processes")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    per = n // world
    return tuple(divmod(i, rays) for i in range(rank * per, (rank + 1) * per))


@functools.lru_cache(maxsize=64)
def holders(bricks: int, rays: int, world: int) -> tuple:
    """``(strips, slabs)``: ``strips[r]`` the ranks holding a shard of ray
    strip ``r`` (its strip group), ``slabs[b]`` those holding a shard of
    brick ``b`` (its slab group), ascending. Ascending rank is ascending
    brick in a strip group and ascending strip in a slab group."""
    strips = [[] for _ in range(rays)]
    slabs = [[] for _ in range(bricks)]
    for p in range(world):
        for b, r in placement(bricks, rays, world, p):
            for members in (strips[r], slabs[b]):
                if not members or members[-1] != p:
                    members.append(p)
    return tuple(map(tuple, strips)), tuple(map(tuple, slabs))


def _count(bricks, rays, world, rank, brick=None, ray=None) -> int:
    """How many of ``rank``'s shards lie in ``brick`` and / or ``ray``."""
    return sum((brick is None or b == brick) and (ray is None or r == ray)
               for b, r in placement(bricks, rays, world, rank))


@functools.lru_cache(maxsize=64)
def halo_sources(bricks: int, rays: int, world: int) -> tuple:
    """Per rank ``(lo, hi)``: the rank whose slab below (above) the rank's
    run of slabs gives it its lower (upper) ghost layer, None at the
    volume's ends. The source is the holder of the neighbouring slab's
    shard in the first strip the rank holds of its edge brick, so in a
    rectangular layout it is the neighbour of the rank's strip group."""
    n = bricks * rays
    per = n // world
    out = []
    for p in range(world):
        run = placement(bricks, rays, world, p)
        b0, b1 = run[0][0], run[-1][0]
        r0 = min(r for b, r in run if b == b0)
        r1 = min(r for b, r in run if b == b1)
        out.append(((((b0 - 1) * rays + r0) // per) if b0 > 0 else None,
                    (((b1 + 1) * rays + r1) // per) if b1 < bricks - 1
                    else None))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``bricks`` x ``rays`` shards on ``device``; ``group`` the process
    group of the whole world; ``strip_groups[r]`` / ``slab_groups[b]`` this
    process's group of strip ``r`` / brick ``b`` (None: a strip or brick it
    does not hold, or holds alone; both empty in a world of one)."""

    bricks: int
    rays: int
    device: torch.device
    group: Optional[object] = None
    strip_groups: tuple = ()
    slab_groups: tuple = ()

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def shards(self) -> tuple:
        """This process's ``(brick, ray)`` shards, row-major."""
        return placement(self.bricks, self.rays, self.world, self.rank)

    def bricks_of(self, r: int) -> tuple:
        """This process's bricks of strip ``r``, ascending."""
        return tuple(b for b, s in self.shards if s == r)

    def rays_of(self, b: int) -> tuple:
        """This process's strips of brick ``b``, ascending."""
        return tuple(r for d, r in self.shards if d == b)

    @property
    def local_bricks(self) -> tuple:
        """The slabs this process holds (a shard of each): a contiguous
        run."""
        s = self.shards
        return tuple(range(s[0][0], s[-1][0] + 1))

    @property
    def local_rays(self) -> tuple:
        """The ray strips this process holds, ascending (not contiguous in a
        ragged run)."""
        return tuple(sorted({r for _, r in self.shards}))

    def strip_group(self, r: int):
        return self.strip_groups[r] if self.strip_groups else None

    def slab_group(self, b: int):
        return self.slab_groups[b] if self.slab_groups else None

    def strip_holders(self, r: int) -> tuple:
        return holders(self.bricks, self.rays, self.world)[0][r]

    def slab_holders(self, b: int) -> tuple:
        return holders(self.bricks, self.rays, self.world)[1][b]


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


def local_rows(x, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """This process's ray strips of ``x`` (the whole image's rows along
    ``axis``), in ascending order."""
    per = x.shape[axis] // mesh.rays
    return torch.cat([x.narrow(axis, r * per, per) for r in mesh.local_rays],
                     axis)


def _rows_of(x: torch.Tensor, mesh: Mesh, strips) -> torch.Tensor:
    """The rows of ``strips`` (ascending) in ``x``, this process's rows."""
    mine = mesh.local_rays
    if tuple(strips) == mine:
        return x
    hl = x.shape[0] // len(mine)
    return torch.cat([x[mine.index(r) * hl:(mine.index(r) + 1) * hl]
                      for r in strips])


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


def _all_gather(t: torch.Tensor, group, counts=None) -> torch.Tensor:
    """``t`` of every member of ``group``, concatenated along axis 0 in
    group-rank order; ``counts``, where the members' leading extents
    differ, lists them (each pads to the largest: Gloo gathers equal
    sizes)."""
    if counts is not None and t.shape[0] < max(counts):
        t = torch.cat([t, t.new_zeros((max(counts) - t.shape[0],)
                                      + t.shape[1:])])
    src = _pinned(t) if _via_host(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    if counts is not None:
        parts = [p[:c] for p, c in zip(parts, counts)]
    return torch.cat(parts).to(t.device)


def _exchange(sends, recvs, group) -> None:
    """Point-to-point over ``group``: each of ``sends`` and ``recvs`` is
    ``(tensor, global rank, tag)``; all are posted at once, then waited
    for, so no order among them can deadlock."""
    staged = any(_via_host(t, group) for t, _, _ in sends + recvs)
    ops, back = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _pinned(t) if staged
                              else t.contiguous(), peer, group, tag))
    for t, peer, tag in recvs:
        buf = t
        if staged:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            back.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    for dst, src in back:
        dst.copy_(src)


# ---- the collectives --------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group, counts):
        ctx.group = group
        r = dist.get_rank(group)
        ctx.span = (sum(counts[:r]), counts[r])
        return _all_gather(local, group,
                           counts if len(set(counts)) > 1 else None)

    @staticmethod
    def backward(ctx, g):
        # all-reduce of the gathered cotangent, then this rank's slice: the
        # gather's transpose without a reduce-scatter (Gloo has none)
        g = _all_reduce(g.contiguous().clone(), ctx.group)
        start, n = ctx.span
        return g[start:start + n], None, None


class _AllReduce(torch.autograd.Function):
    """psum: sums forward, sums the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _Replicate(torch.autograd.Function):
    """Identity forward; the gradient all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _SlabSum(torch.autograd.Function):
    """Identity forward; backward, each slab's part of the gradient summed
    over its group, slab by slab in ascending order."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for part, group in zip(g.split(g.shape[0] // len(ctx.groups)),
                               ctx.groups):
            if group is not None:
                _all_reduce(part, group)
        return g, None


def _per_strip(g: torch.Tensor, divisors) -> torch.Tensor:
    """``g``, rows of equal strips, each strip divided by its divisor (one
    number: all of them)."""
    if not isinstance(divisors, tuple):
        return g / divisors
    d = torch.tensor(divisors, dtype=g.dtype, device=g.device)
    return (g.contiguous().reshape(len(divisors), -1) / d[:, None]
            ).reshape(g.shape)


def _one_or_all(values):
    """One number where ``values`` are all equal, else them as a tuple."""
    values = tuple(values)
    return values[0] if len(set(values)) == 1 else values


class _ReplicatedOutput(torch.autograd.Function):
    """Identity forward; ``1 / holders`` of the cotangent backward (a
    strip's rows by its own count)."""

    @staticmethod
    def forward(ctx, x, holders):
        ctx.holders = holders
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _per_strip(g, ctx.holders), None


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh,
               r: int) -> torch.Tensor:
    """Stack this process's per-brick ``parts`` of strip ``r`` (its bricks
    of the strip, ascending) with those of the rest of the strip's group:
    ``(bricks, ...)``."""
    local = torch.stack(list(parts))
    group = mesh.strip_group(r)
    if group is None:
        return local
    counts = [_count(mesh.bricks, mesh.rays, mesh.world, q, ray=r)
              for q in mesh.strip_holders(r)]
    return _AllGather.apply(local, group, counts)


def psum(x: torch.Tensor, mesh: Mesh, r: int) -> torch.Tensor:
    """Sum of ``x`` over strip ``r``'s group (the caller sums its own
    bricks of the strip)."""
    group = mesh.strip_group(r)
    return x if group is None else _AllReduce.apply(x, group)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its gradient summed over ``group`` (a leaf every member holds
    whole; None: ``x`` itself)."""
    if group is None or not x.requires_grad:
        return x
    return _Replicate.apply(x, group)


def slab_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, this process's run of slabs along axis 0, its gradient summed
    over each slab's group (each holder of a slab has the part of its
    gradient that its strips give)."""
    groups = tuple(mesh.slab_group(b) for b in mesh.local_bricks)
    if not x.requires_grad or all(g is None for g in groups):
        return x
    return _SlabSum.apply(x, groups)


def _chained(mesh: Mesh, d: int) -> bool:
    """Must slab ``d``'s cotangents fold across its holders strip by strip
    (:class:`_Fold`)? Not where its group's all-reduce adds in that order
    already: two holders, the lower one holding one strip of the slab."""
    h = mesh.slab_holders(d)
    return len(h) > 2 or (len(h) == 2 and _count(
        mesh.bricks, mesh.rays, mesh.world, h[0], brick=d) > 1)


def _recv(like: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
    """A new tensor shaped as ``like``, received from global rank ``src``."""
    if _via_host(like, group):
        h = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        dist.recv(h, src, group=group, tag=tag)
        return h.to(like.device)
    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.recv(buf, src, group=group, tag=tag)
    return buf


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` on every member of ``group``, in
    place."""
    if _via_host(t, group):
        h = _pinned(t)
        dist.broadcast(h, src, group=group)
        return t.copy_(h)
    dist.broadcast(t, src, group=group)
    return t


class _Fold:
    """The cotangent of a run of slabs, summed strip by strip in the order
    one process sums it (bf16 adds do not associate): each slab's strips
    from the highest down (the backward's order), each strip's passes
    already summed. Across a slab's holders the fold continues: the holder
    of the higher strips sends its partial sum to the next one down, which
    adds its own strips to it, and the holder of the lowest strips sends
    the whole to the rest (:func:`_chained`; else the group's all-reduce
    adds in that order). The adds after the first are in place on the
    strip's cotangent: the strips' sweeps return fresh tensors."""

    def __init__(self, mesh: Mesh, sum_groups: bool):
        self.mesh, self.sum_groups = mesh, sum_groups
        self.acc, self.sends = {}, []

    def add(self, d: int, r: int, g) -> None:
        """Strip ``r``'s cotangent ``g`` of slab ``d``."""
        if g is None:
            return
        mesh = self.mesh
        group = mesh.slab_group(d)
        members = mesh.slab_holders(d)
        i = members.index(mesh.rank)
        chained = self.sum_groups and group is not None and _chained(mesh, d)
        if d in self.acc:
            self.acc[d].add_(g)
        elif chained and i + 1 < len(members):
            # the fold of the strips above this process's
            self.acc[d] = _recv(g, members[i + 1], group, d).add_(g)
        else:
            self.acc[d] = g.contiguous()
        if chained and i > 0 and r == mesh.rays_of(d)[0]:
            t = self.acc[d]
            src = _pinned(t) if _via_host(t, group) else t
            self.sends.append((dist.isend(src, members[i - 1], group=group,
                                          tag=d), src))

    def finish(self):
        """The run's cotangent, each slab's summed over its group (where
        ``sum_groups``), slab by slab in ascending order; None when no
        strip gave one."""
        for work, _ in self.sends:
            work.wait()
        self.sends = []
        if not self.acc:
            return None
        mesh, parts = self.mesh, []
        for d in mesh.local_bricks:
            t = self.acc.pop(d)
            group = mesh.slab_group(d) if self.sum_groups else None
            if group is not None and _chained(mesh, d):
                _broadcast(t, mesh.slab_holders(d)[0], group)
            elif group is not None:
                _all_reduce(t, group)
            parts.append(t)
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class _FoldSink(torch.autograd.Function):
    """Identity forward; backward, the :class:`_Fold`'s sum (the strips'
    views pass nothing on themselves)."""

    @staticmethod
    def forward(ctx, run, fold):
        ctx.fold = fold
        ctx.set_materialize_grads(False)
        return run.view_as(run)

    @staticmethod
    def backward(ctx, g):
        out = ctx.fold.finish()
        if g is not None:
            out = g if out is None else out + g
        return out, None


class _StripSlab(torch.autograd.Function):
    """Strip ``r``'s view of slab ``d`` (rows ``start:start + n`` of the
    run); backward, the strip's cotangent of it into the :class:`_Fold`."""

    @staticmethod
    def forward(ctx, run, fold, d, r, start, n):
        ctx.fold, ctx.d, ctx.r = fold, d, r
        ctx.set_materialize_grads(False)
        return run[start:start + n].view_as(run[start:start + n])

    @staticmethod
    def backward(ctx, g):
        ctx.fold.add(ctx.d, ctx.r, g)
        return None, None, None, None, None, None


def strip_slabs(run: torch.Tensor, mesh: Mesh, sum_groups: bool = True):
    """``views(r)``: strip ``r``'s views ``{brick: slab}`` of this process's
    run of slabs. Under autograd the run's cotangent sums each strip's
    (its passes first) in one process's order, over each slab's group too
    where ``sum_groups`` (a run every holder of a slab holds a copy of;
    False: a run cut from a volume whose gradient sums elsewhere)."""
    zl = run.shape[0] // len(mesh.local_bricks)
    first = mesh.local_bricks[0]
    if not run.requires_grad:
        return lambda r: {d: run[(d - first) * zl:(d - first + 1) * zl]
                          for d in mesh.bricks_of(r)}
    fold = _Fold(mesh, sum_groups)
    run = _FoldSink.apply(run, fold)
    return lambda r: {d: _StripSlab.apply(run, fold, d, r, (d - first) * zl,
                                          zl) for d in mesh.bricks_of(r)}


def replicate(x, mesh: Mesh):
    """``x`` for every shard to read: a Python number as it is (no upload,
    no read-back at each launch), anything else as a float32 tensor on the
    mesh's device whose gradient is summed over the world."""
    if isinstance(x, (int, float)):
        return x
    x = torch.as_tensor(x, dtype=torch.float32, device=mesh.device)
    return grad_sum(x, mesh.group)


def replicated_output(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mark ``x``, this process's rows (its strips in ascending order, equal
    rows each), as held by every process of each strip's group (see the
    module docstring)."""
    ks = [len(mesh.strip_holders(r)) for r in mesh.local_rays]
    if max(ks) == 1:
        return x
    return _ReplicatedOutput.apply(x, _one_or_all(ks))


def _whole(mesh: Mesh) -> bool:
    """Does this process hold the whole image, alone in each slab's group
    (then every process holds every strip)?"""
    return all(mesh.slab_group(b) is None for b in mesh.local_bricks)


def _gather_strips(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole image from this process's rows ``x``: for each slab it
    holds, ascending, the strips of that brick gathered over the slab's
    group (every member joins each of its groups' gathers); the first
    slab's copy."""
    hl = x.shape[0] // len(mesh.local_rays)
    out = None
    for b in mesh.local_bricks:
        part = _rows_of(x, mesh, mesh.rays_of(b))
        group = mesh.slab_group(b)
        if group is not None:
            counts = [hl * _count(mesh.bricks, mesh.rays, mesh.world, q,
                                  brick=b) for q in mesh.slab_holders(b)]
            part = _all_gather(part, group, counts
                               if len(set(counts)) > 1 else None)
        if out is None:
            out = part
    return out


class _GatherRays(torch.autograd.Function):
    """:func:`_gather_strips`; the backward is the gather's transpose (the
    first slab's group takes this process's cotangent) with the whole
    image held by every process: strip ``r``'s cotangent divided by
    ``world / |strip r's group|``, which with :func:`replicated_output`'s
    ``1 / |group|`` hands each holder ``1 / world``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_strips(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = _per_strip(g, _one_or_all(
            mesh.world / len(mesh.strip_holders(r))
            for r in range(mesh.rays)))
        hl = g.shape[0] // mesh.rays
        parts = {r: [] for r in mesh.local_rays}
        for i, b in enumerate(mesh.local_bricks):
            group = mesh.slab_group(b)
            if group is not None:
                whole = _all_reduce(g.contiguous().clone() if i == 0
                                    else torch.zeros_like(g), group)
            elif i == 0:
                whole = g
            else:
                continue
            for r in mesh.rays_of(b):
                parts[r].append(whole[r * hl:(r + 1) * hl])
        rows = []
        for r in mesh.local_rays:
            acc = parts[r][0] if parts[r] else torch.zeros_like(g[:hl])
            for p in parts[r][1:]:
                acc = acc + p
            rows.append(acc)
        return torch.cat(rows), None


def gather_rays(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole image from this process's rows ``x``, held by every
    process (see :class:`_GatherRays`)."""
    return x if _whole(mesh) else _GatherRays.apply(x, mesh)


class _ImageMean(torch.autograd.Function):
    """JAX's ``jnp.mean`` over the whole image from this process's rows:
    for each slab it holds, its strips of that brick weighted by their
    share of the rows, summed over the slab's group (its members' strips
    of the brick are the image once); the first slab's sum. Backward, each
    of this process's rows takes the whole image's mean derivative, the
    cotangent over the whole image's size as one process divides it."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.shape = x.shape
        ctx.n = math.prod(x.shape) // len(mesh.local_rays) * mesh.rays
        out = None
        for b in mesh.local_bricks:
            strips = mesh.rays_of(b)
            t = torch.mean(_rows_of(x, mesh, strips)) * (len(strips)
                                                         / mesh.rays)
            group = mesh.slab_group(b)
            if group is not None:
                t = _all_reduce(t.contiguous().clone(), group)
            if out is None:
                out = t
        return out

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape) / ctx.n, None


def image_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """JAX's ``jnp.mean`` over the whole image from ``x``, this process's
    rows of it (see :class:`_ImageMean`)."""
    return torch.mean(x) if _whole(mesh) else _ImageMean.apply(x, mesh)


def _halo_plan(mesh: Mesh, zl: int):
    """``(lo, hi, serve)``: the ranks that send this process its lower and
    upper ghost layer (None: the volume's end) and what it sends, as
    ``(layer of its run, rank, tag)`` (tag 0: the rank's lower ghost, the
    last layer of the slab below its run; 1: its upper ghost)."""
    srcs = halo_sources(mesh.bricks, mesh.rays, mesh.world)
    me, first = mesh.rank, mesh.local_bricks[0]
    serve = []
    for p, (lo, hi) in enumerate(srcs):
        run = placement(mesh.bricks, mesh.rays, mesh.world, p)
        if lo == me:
            serve.append(((run[0][0] - 1 - first) * zl + zl - 1, p, 0))
        if hi == me:
            serve.append(((run[-1][0] + 1 - first) * zl, p, 1))
    return srcs[me] + (serve,)


class _Halo(torch.autograd.Function):
    """One ghost z-layer on each side of a process's run of slabs, each
    from the process :func:`halo_sources` names (the run's own edge layer
    at the volume's ends); the backward returns each ghost's cotangent to
    the process it came from."""

    @staticmethod
    def forward(ctx, local, mesh, plan):
        lo_src, hi_src, serve = plan
        ctx.plan, ctx.group = plan, mesh.group
        lo, hi = local[:1].clone(), local[-1:].clone()
        recvs = [(buf, src, tag) for buf, src, tag in
                 ((lo, lo_src, 0), (hi, hi_src, 1)) if src is not None]
        _exchange([(local[i:i + 1], p, tag) for i, p, tag in serve], recvs,
                  mesh.group)
        return torch.cat([lo, local, hi])

    @staticmethod
    def backward(ctx, g):
        lo_src, hi_src, serve = ctx.plan
        d = g[1:-1].clone()
        # a replicated edge layer's ghost cotangent stays here
        if lo_src is None:
            d[:1] += g[:1]
        if hi_src is None:
            d[-1:] += g[-1:]
        back = [torch.zeros_like(g[:1]) for _ in serve]
        sends = [(t, src, tag) for t, src, tag in
                 ((g[:1], lo_src, 0), (g[-1:], hi_src, 1)) if src is not None]
        _exchange(sends, [(t, p, tag) for t, (_, p, tag) in zip(back, serve)],
                  ctx.group)
        for (i, _, _), t in sorted(zip(serve, back),
                                   key=lambda e: (e[0][0], e[0][1])):
            d[i:i + 1] += t
        return d, None, None


def halo_exchange(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's run of slabs with one ghost z-layer on each side: the
    neighbouring slab's edge layer from a holder of it, or this run's own
    edge layer at the volume's ends (clamp-to-edge addressing). Brick
    ``d``'s haloed slab is then a slice of the result."""
    plan = _halo_plan(mesh, local.shape[0] // len(mesh.local_bricks))
    if plan == (None, None, []):
        return torch.cat([local[:1], local, local[-1:]])
    return _Halo.apply(local, mesh, plan)
