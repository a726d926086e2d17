"""The device mesh as torch.distributed process groups.

The port's counterpart of the reference's mesh axes: the
``("pod", "data", "model")`` meshes of ``launch/mesh.py`` and the manual
``shard_map`` axes of ``core/grad_compress.py``,
``train/step.py::build_train_step_compressed_dp`` and
``kernels/ops.py``'s sharded wrappers.

A mesh of ``sizes`` over ``axes`` (an ordered subset of
``("pod", "data", "model")``, outermost first; the data-parallel
training meshes are a suffix of ``DP_AXES``, ``("pod", "data")`` or
``("data",)``, the serving meshes ``("data", "model")``) is
``prod(sizes)`` ranks, one process each.  Rank ``r`` sits at the coordinates of ``r`` in
row-major order, ``r = pod * |data| + data`` (``r = data * |model| + model`` on a
serving mesh).  For each axis the ranks
that differ only in that coordinate form one subgroup (``new_group``
over their sorted ranks), so a rank's index inside its "pod" group is
its pod coordinate and inside its "data" group its data coordinate.  A
reduce-scatter over "pod" and then over "data" therefore leaves rank
``r`` with flat shard ``r`` of ``L / n`` elements, the shard that device
(p, d) owns after the reference's hierarchical ``psum_scatter`` (which
reshapes ``(k, -1)`` per axis), and all-gathers in the reverse order
rebuild the whole in rank order.

Backend, chosen from the device (``backend_for``), never by trying one:

* NCCL where every rank has a CUDA card of its own;
* gloo on the CPU, and where ranks share a card (NCCL does not run two
  ranks of one communicator on one device).

Gloo on CUDA tensors is "staged": ``to_wire`` copies a tensor into
pinned host memory, the collectives run on the host, and ``from_wire``
copies the result back to the card.  The exchange stages its f32
buffer once before the reduce-scatters and the code and scale bytes
once before the all-gathers; the converter still runs on the card.
Ranks that share one card move their bytes through host memory and
loopback TCP, so a run of them gives no wire speed.

Each wire method runs in a ``torch.profiler.record_function`` span
("dp.to_wire", "dp.reduce_scatter", "dp.all_gather", "dp.from_wire",
"dp.mean"), which ``tests/profile_dp_exchange.py`` reads; the sharded
serving collectives (``sum_over``, ``gather_over``, ``host_gather``)
run in "tp.*" spans ("tp.sum", "tp.gather", "tp.host"), staging
included, and the FSDP weight gather of training and prefill in
"fsdp.gather" / "fsdp.reduce_scatter"; outside a profiler a span costs
a few microseconds.

The collectives inside a differentiated forward are
``torch.autograd.Function``s over those methods (``RowSum``,
``ModelCopy``, ``Gather``), so that autograd sees them and every rank
issues the same collectives in the same order, backward included:

* ``RowSum``    sum forward, identity backward (a row-parallel
                projection's partials; the vocab-sharded embedding);
* ``ModelCopy`` identity forward, sum backward (the input of
                column-parallel projections: each rank's gradient of it
                covers only its columns);
* ``Gather``    all-gather forward; backward the rank's own chunk where
                what follows the gather is the same on every rank (the
                logits), or the sum over the ranks' chunks
                (reduce-scatter) where each rank uses the whole
                differently (k/v read by the rank's q heads; the FSDP
                weight gather, each data rank on its own rows).

Rendezvous goes through a ``FileStore`` at a path the caller names (a
fresh temporary directory per run), never through a fixed port, so
concurrent runs cannot collide.  ``spawn`` starts the rank processes,
and one failed rank stops them all.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.dist.sharding import DP_AXES, MESH_AXES

# torch renamed the tensor-in, tensor-out collectives (the old names warn
# where the new ones exist); take whichever this torch has
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def mesh_axes(sizes: Sequence[int]) -> Tuple[str, ...]:
    """The DP axes of a mesh of ``sizes``: the innermost ``len(sizes)`` of
    ``DP_AXES`` (one size: ``("data",)``)."""
    if not 1 <= len(sizes) <= len(DP_AXES):
        raise ValueError(f"a DP mesh has 1 or {len(DP_AXES)} axes "
                         f"{DP_AXES}, got sizes {tuple(sizes)}")
    return DP_AXES[len(DP_AXES) - len(sizes):]


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % cards)`` on CUDA (ranks past
    the card count share cards), else the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def backend_for(device: torch.device, world: int, cards: int) -> str:
    """NCCL when every one of ``world`` ranks has a CUDA card of its own
    (``cards`` of them), else gloo (the CPU, or ranks sharing a card)."""
    if torch.device(device).type == "cuda" and world <= cards:
        return "nccl"
    return "gloo"


def check_axes(axes: Sequence[str], sizes: Sequence[int]) -> Tuple[str, ...]:
    """``axes`` as a tuple, checked: an ordered subset of ``MESH_AXES``
    with one size each."""
    axes = tuple(axes)
    order = [MESH_AXES.index(a) for a in axes if a in MESH_AXES]
    if len(order) != len(axes) or order != sorted(set(order)) \
            or len(axes) != len(sizes):
        raise ValueError(f"mesh axes {axes} of sizes {tuple(sizes)}: "
                         f"an ordered subset of {MESH_AXES}, one size "
                         f"each")
    return axes


@dataclasses.dataclass
class DPGroups:
    """One rank's view of the mesh: its coordinates, the subgroup of each
    axis it belongs to, the backend and whether gloo stages CUDA tensors
    through host memory."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Any]

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
        return self.sizes[self.axes.index(axis)] if axis in self.axes else 1

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a jax mesh's ``shape``."""
        return dict(zip(self.axes, self.sizes))

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (row-major ranks)."""
        if axis not in self.axes:
            return 0
        i = self.axes.index(axis)
        return self.rank // math.prod(self.sizes[i + 1:]) % self.sizes[i]

    def index(self, entry) -> int:
        """This rank's chunk index along a spec entry: an axis, or a tuple
        of axes (row-major over them)."""
        axes = entry if isinstance(entry, tuple) else (entry,)
        i = 0
        for a in axes:
            i = i * self.size(a) + self.coord(a)
        return i

    # -- the sharded serving collectives ("tp.*") --------------------------
    def _over(self, axes, fn, x):
        """``fn(wire tensor, group)`` over each of ``axes`` (sizes > 1) in
        turn, on the wire; returns the result on this rank's device."""
        axes = [a for a in ((axes,) if isinstance(axes, str) else axes)
                if self.size(a) > 1]
        if not axes:
            return x
        w = self.to_wire(x.contiguous())
        for a in axes:
            w = fn(w, a)
        return self.from_wire(w)

    def _gather_stack(self, w: torch.Tensor, axis: str) -> torch.Tensor:
        """The ``axis`` ranks' ``w`` (at least 1-D) stacked on a new
        leading dim (the collective fills it as one concatenation along
        dim 0, the layout every backend takes)."""
        k = self.size(axis)
        out = torch.empty((k * w.shape[0],) + tuple(w.shape[1:]),
                          dtype=w.dtype, device=w.device)
        _all_gather(out, w.contiguous(), group=self.groups[axis])
        return out.reshape((k,) + tuple(w.shape))

    def sum_over(self, x: torch.Tensor, axes,
                 span: str = "tp.sum") -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axes`` (an axis or a tuple),
        in x's dtype, staged through host memory under gloo on CUDA."""
        def one(w, a):
            w = w.clone() if w is x else w
            dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.groups[a])
            return w
        with record_function(span):
            return self._over(axes, one, x)

    def gather_over(self, x: torch.Tensor, axes, dim: int,
                    span: str = "tp.gather") -> torch.Tensor:
        """The ranks' ``x`` along ``axes`` concatenated on ``dim`` in their
        coordinate order (row-major over a tuple of axes)."""
        dim = dim % x.dim()

        def one(w, a):
            out = self._gather_stack(w, a)
            return torch.cat(list(out.unbind(0)), dim=dim)

        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        with record_function(span):
            # the innermost axis first: chunks of an outer coordinate
            # then hold its inner ones in order
            return self._over(tuple(reversed(axes)), one, x)

    def _live(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if self.size(a) > 1)

    def chunk_of(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim`` split over ``axes``
        (row-major over them): the inverse of ``gather_over``."""
        axes = self._live(axes)
        if not axes:
            return x
        parts = math.prod(self.size(a) for a in axes)
        n = x.shape[dim] // parts
        return x.narrow(dim, self.index(axes) * n, n)

    def scatter_sum_over(self, x: torch.Tensor, axes, dim: int,
                         span: str = "tp.reduce_scatter") -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of ``x`` over
        ``axes`` (a reduce-scatter per axis, outermost first, so the
        chunk is ``chunk_of``'s), in x's dtype."""
        axes = self._live(axes)
        if not axes:
            return x
        dim = dim % x.dim()
        with record_function(span):
            w = self.to_wire(x.movedim(dim, 0).contiguous())
            for a in axes:
                out = torch.empty((w.shape[0] // self.size(a),)
                                  + tuple(w.shape[1:]), dtype=w.dtype,
                                  device=w.device)
                _reduce_scatter(out, w, op=dist.ReduceOp.SUM,
                                group=self.groups[a])
                w = out
            return self.from_wire(w).movedim(0, dim).contiguous()

    def host_gather(self, a, axes):
        """A host (numpy) array of every rank of ``axes`` (an axis or a
        tuple), stacked on a new leading dim in coordinate order (gloo runs
        it on the host; NCCL takes device tensors, so it goes through the
        card there)."""
        import numpy as np
        axes = tuple(x for x in ((axes,) if isinstance(axes, str) else axes)
                     if self.size(x) > 1)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.backend == "nccl":
            t = t.to(self.device)
        with record_function("tp.host"):
            for ax in reversed(axes):       # innermost first
                t = self._gather_stack(t, ax)
        n = math.prod(self.size(x) for x in axes)
        return t.cpu().numpy().reshape((n,) + np.shape(a))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh's axes, as a jax mesh's ``axis_names``."""
        return self.axes

    def batch_rows(self, batch: int, axes=None) -> slice:
        """This rank's rows of a global batch of ``batch``: the
        reference's ``P(axes)`` split of dim 0 (every axis of the mesh by
        default), coordinates in row-major order."""
        axes = self.axes if axes is None else tuple(axes)
        n = math.prod(self.size(a) for a in axes)
        if batch % n:
            raise ValueError(f"a global batch of {batch} does not split "
                             f"over {n} ranks")
        b, i = batch // n, self.index(axes) if axes else 0
        return slice(i * b, (i + 1) * b)

    # -- collectives over host or device tensors ("the wire") ------------
    def to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where this backend's collectives take it: a pinned host
        copy when staged, else ``x`` itself."""
        if not self.staged:
            return x
        with record_function("dp.to_wire"):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
        return h

    def from_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A collective's result back on this rank's device."""
        if not self.staged:
            return x
        with record_function("dp.from_wire"):
            return x.to(self.device)

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` (1-D, on the wire) over ``axis``; returns this
        rank's chunk (chunk ``index(axis)`` of ``size(axis)``)."""
        k = self.size(axis)
        out = torch.empty(x.numel() // k, dtype=x.dtype, device=x.device)
        with record_function("dp.reduce_scatter"):
            _reduce_scatter(out, x, op=dist.ReduceOp.SUM,
                            group=self.groups[axis])
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ``size(axis)`` chunks of ``axis``'s ranks, concatenated in
        their coordinate order."""
        out = torch.empty(x.numel() * self.size(axis), dtype=x.dtype,
                          device=x.device)
        with record_function("dp.all_gather"):
            _all_gather(out, x.contiguous(), group=self.groups[axis])
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean of ``x`` over every rank (the reference's ``pmean`` over
        the DP axes); the sum runs on the wire.  A world of one returns
        ``x``."""
        if self.world == 1:
            return x
        w = self.to_wire(x.detach().clone())
        with record_function("dp.mean"):
            dist.all_reduce(w, op=dist.ReduceOp.SUM)
        return self.from_wire(w) / self.world

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (``x`` at a world of one)."""
        if self.world == 1:
            return x
        w = self.to_wire(x.detach().clone())
        dist.broadcast(w, src=src)
        return self.from_wire(w)



# =============================================================================
# collectives that carry gradients
# =============================================================================
class RowSum(torch.autograd.Function):
    """Sum over ``axes`` forward, identity backward: the partial products
    of a row-parallel projection (every rank's output is the whole, and
    its gradient reaches each partial unchanged)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.sum_over(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class ModelCopy(torch.autograd.Function):
    """Identity forward, sum over ``axes`` backward: the input of
    column-parallel projections, whose gradient on each rank covers only
    the rank's columns."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum_over(g, ctx.axes), None, None


class Gather(torch.autograd.Function):
    """All-gather over ``axes`` on ``dim`` forward.  Backward: with
    ``partial`` the sum of the ranks' gradients of their chunk
    (reduce-scatter; each rank uses the whole in its own way), else the
    rank's own chunk of the gradient (what follows is the same on every
    rank).  ``spans`` names the forward's and the backward's profiler
    spans."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, partial, spans):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.partial, ctx.span = partial, spans[1]
        return mesh.gather_over(x, axes, dim, span=spans[0])

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = ctx.mesh.scatter_sum_over(g, ctx.axes, ctx.dim,
                                          span=ctx.span)
        else:
            g = ctx.mesh.chunk_of(g, ctx.axes, ctx.dim).contiguous()
        return g, None, None, None, None, None


def init_dp(rank: int, sizes: Sequence[int], device,
            store_path: str, axes: Optional[Sequence[str]] = None
            ) -> DPGroups:
    """Join the process group of ``prod(sizes)`` ranks as ``rank`` through
    a FileStore at ``store_path`` (every rank names the same, fresh path)
    and build the axis subgroups.  ``axes`` names the mesh's axes
    (default the DP axes of ``mesh_axes(sizes)``; a serving mesh passes
    ``("data", "model")``).  ``device`` is this rank's device
    (``rank_device``); the backend follows from it (``backend_for``).
    Every rank must call this, in any order."""
    sizes = tuple(int(s) for s in sizes)
    axes = mesh_axes(sizes) if axes is None else check_axes(axes, sizes)
    world = math.prod(sizes)
    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = backend_for(device, world, cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    groups: Dict[str, Any] = {}
    for i, axis in enumerate(axes):
        if sizes[i] == 1:
            groups[axis] = None
            continue
        others = [range(s) if j != i else (0,) for j, s in enumerate(sizes)]
        for base in itertools.product(*others):
            members = []
            for c in range(sizes[i]):
                coord = list(base)
                coord[i] = c
                members.append(sum(x * math.prod(sizes[j + 1:])
                                   for j, x in enumerate(coord)))
            # every rank creates every group, in the same order
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return DPGroups(axes, sizes, rank, device, backend, groups)


def world_one(axes: Sequence[str], device) -> DPGroups:
    """A mesh of one rank over ``axes`` (every size 1): it joins no
    process group, and every collective over it is the identity."""
    axes = check_axes(axes, (1,) * len(tuple(axes)))
    return DPGroups(axes, (1,) * len(axes), 0, torch.device(device),
                    "gloo", {a: None for a in axes})


def close_dp() -> None:
    """Leave the process group (after the last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


class RankFailed(RuntimeError):
    """A rank process raised or died; the message holds its traceback."""


def spawn(fn: Callable, world: int, args: Tuple = (),
          timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the "spawn"
    start method: nothing of this process's CUDA or thread state is
    inherited) and wait for all of them.  The first rank that raises or
    dies stops the others, and ``RankFailed`` carries its traceback; past
    ``timeout`` seconds every rank is killed and ``TimeoutError`` raised,
    so a hung collective cannot hang the caller.  ``fn`` must be a
    module-level function (the children import it)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             daemon=True, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.2):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise RankFailed(str(e)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
