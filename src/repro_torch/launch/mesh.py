"""Device meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

A :class:`Mesh` names its axes (``data``/``model``, ``stage`` for the
pipeline), knows each axis's size, this rank's coordinate on each, and
the process group of each axis, from
``torch.distributed.device_mesh.init_device_mesh``: one process per
rank, NCCL on cards and gloo on the CPU.  A mesh of one rank needs no
process group at all, and :func:`emulated_mesh` gives the coordinates of
any rank of a layout without processes (sharding policy).
:func:`emulate_layout` runs a function as every rank of a layout in one
process, one rank at a time, its meshes' gathers exchanging the ranks'
blocks in memory: a layout's shards run one after another on one card
through the same code the ranks of a job run.

The collectives of one axis group (:meth:`Mesh.all_gather`,
:meth:`Mesh.reduce_scatter`, :meth:`Mesh.all_reduce` with ``op`` ``sum``
or ``max``) serve the FSDP and tensor-parallel numeric step: in a
process group they call ``torch.distributed`` on the axis's group (NCCL
on cards, gloo on the CPU); a mesh with an exchange hook (its
``layout``: the emulated layout, or a harness's own transport) hands
them to the hook, which the emulated layout serves in memory, summing
in rank order.
"""
from __future__ import annotations

import itertools
import math
import os
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.shardctx import flat_index

#: Shapes of the reference's production meshes (one pod: 16 x 16 chips;
#: two pods add a ``pod`` axis).
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


class Mesh:
    """Axis names, sizes and this rank's coordinates, plus the process
    group of each axis (``None`` for an emulated or one-rank mesh) and
    an exchange hook, ``layout``: the emulated layout whose rank it is,
    or any object with the same three methods (``exchange(mesh, t,
    axis)``: the axis group's ``t`` in rank order; ``reduce(mesh, t,
    axis, op)``; ``reduce_scatter(mesh, t, axis, dim)``), which then
    carries every collective of the mesh."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 coords: Optional[Sequence[int]] = None, device_mesh=None,
                 layout=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                             f"{tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = {a: int(n) for a, n in zip(axes, shape)}
        coords = tuple(coords) if coords is not None else (0,) * len(axes)
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(axes, coords)}
        self.device_mesh = device_mesh
        self.layout = layout

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        """This rank's flat index, row-major over the axes."""
        return flat_index(self.shape, self.coords, self.axis_names)

    def group(self, axis: str):
        """The process group of ``axis`` (ranks that differ only there)."""
        if self.device_mesh is None:
            raise ValueError(f"mesh axis {axis!r} has no process group (an "
                             "emulated or one-rank mesh)")
        return self.device_mesh.get_group(axis)

    def gather_blocks(self, q: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """``q`` of every rank of ``axis``'s group (the ranks that differ
        from this one only there), in their order along ``axis``: an
        ``all_gather_into_tensor`` on the axis's process group, or the
        exchange of an emulated layout.  Moves bits only."""
        if self.layout is not None:
            return self.layout.exchange(self, q, axis)
        qc = q.contiguous().reshape(1, -1)
        out = qc.new_empty((self.shape[axis], qc.shape[1]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, qc, group=self.group(axis))
        return [t.view(q.shape) for t in out.unbind(0)]

    # ------------------------------------------- collectives of one axis

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """The axis group's ``t`` concatenated along ``dim`` in their
        order along ``axis`` (bits moved, nothing added)."""
        if self.shape[axis] == 1:
            return t
        return torch.cat(self.gather_blocks(t, axis), dim=dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of the axis group's
        ``t`` (``dim`` divides into one chunk a rank).  Real groups sum
        in the backend's order, an emulated layout in rank order."""
        n = self.shape[axis]
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {n} ranks of {axis!r}")
        if self.layout is not None:
            return self.layout.reduce_scatter(self, t, axis, dim)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((t.shape[dim] // n, *src.shape[1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, src, group=self.group(axis))
        return out.movedim(0, dim)

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``) or the max (``"max"``) of the axis
        group's ``t``, a new tensor.  Real groups sum in the backend's
        order, an emulated layout in rank order; a max is exact in any
        order."""
        if op not in ("sum", "max"):
            raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
        if self.shape[axis] == 1:
            return t
        if self.layout is not None:
            return self.layout.reduce(self, t, axis, op)
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group(axis))
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


class _Layout:
    """Every rank of a layout in one process: a thread each, one running
    at a time.  A rank runs until its next exchange, posts its block and
    hands over to the next rank in flat order (waking that rank alone);
    after the last rank has posted, the first reads the round's blocks
    and goes on.  The ranks' launches thus reach the card one after
    another on one stream, and the launch counts see one rank at a
    time."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.meshes = [Mesh(shape, axes, c, layout=self)
                       for c in itertools.product(*(range(n) for n in shape))]
        self.go = [threading.Event() for _ in self.meshes]
        self.rounds = [0] * len(self.meshes)
        self.posts: Dict[int, list] = {}
        self.done: set = set()
        self.failed = False

    def _hand_over(self, rank: int) -> None:
        n = len(self.meshes)
        for step in range(1, n + 1):
            if (rank + step) % n not in self.done:
                self.go[(rank + step) % n].set()
                return

    def _wait(self, rank: int) -> None:
        self.go[rank].wait()
        self.go[rank].clear()
        if self.failed:
            raise RuntimeError("another rank of the emulated layout failed")

    def _fail(self) -> None:
        self.failed = True
        for ev in self.go:
            ev.set()

    def exchange(self, mesh: Mesh, q: torch.Tensor,
                 axis: str) -> List[torch.Tensor]:
        rank, n = mesh.rank, len(self.meshes)
        if self.done:
            raise RuntimeError("the emulated ranks exchange unevenly: a "
                               "rank ended before this exchange")
        rnd = self.rounds[rank]
        self.rounds[rank] += 1
        posts = self.posts.setdefault(rnd, [None] * n + [0])
        posts[rank] = q
        self._hand_over(rank)
        self._wait(rank)
        group = [posts[flat_index(mesh.shape, {**mesh.coords, axis: i},
                                  mesh.axis_names)]
                 for i in range(mesh.shape[axis])]
        posts[n] += 1
        if posts[n] == n:
            del self.posts[rnd]
        return group

    def reduce(self, mesh: Mesh, t: torch.Tensor, axis: str,
               op: str) -> torch.Tensor:
        blocks = self.exchange(mesh, t, axis)
        acc = blocks[0]
        for b in blocks[1:]:
            acc = acc + b if op == "sum" else torch.maximum(acc, b)
        return acc

    def reduce_scatter(self, mesh: Mesh, t: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        loc = t.shape[dim] // mesh.shape[axis]
        at = mesh.coords[axis] * loc
        blocks = self.exchange(mesh, t, axis)
        acc = blocks[0].narrow(dim, at, loc)
        for b in blocks[1:]:
            acc = acc + b.narrow(dim, at, loc)
        return acc

    def run(self, fn: Callable[[Mesh], object]) -> list:
        results: list = [None] * len(self.meshes)
        errors: list = []

        def body(mesh: Mesh) -> None:
            try:
                self._wait(mesh.rank)
                results[mesh.rank] = fn(mesh)
            except BaseException as e:          # noqa: BLE001 - re-raised
                errors.append(e)
                self._fail()
                return
            self.done.add(mesh.rank)
            self._hand_over(mesh.rank)

        threads = [threading.Thread(target=body, args=(m,))
                   for m in self.meshes]
        for t in threads:
            t.start()
        self.go[0].set()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


def emulate_layout(shape: Sequence[int], axes: Sequence[str],
                   fn: Callable[[Mesh], object]) -> list:
    """``fn(mesh)`` as every rank of the layout ``shape`` over ``axes``,
    in one process: each call gets its rank's mesh, whose gathers
    (:meth:`Mesh.gather_blocks`, so ``core.shardctx``'s ordered combine)
    exchange the ranks' blocks in memory.  The ranks run one at a time
    (see :class:`_Layout`).  Returns the results in flat rank order."""
    return _Layout(shape, axes).run(fn)


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Start this process's group: NCCL for ``device="cuda"``, gloo for
    ``"cpu"``.  Without ``init_method`` it reads torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and does
    nothing when there is none.  On a card each rank takes
    ``cuda:LOCAL_RANK``.  Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if init_method is None and "RANK" not in os.environ:
        return False
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(backend, **kw)
    return True


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over this job's ranks, row-major (major axis
    first).  ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``.
    A one-rank mesh outside a process group runs without one."""
    device = device or "cuda"
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a {n}-rank mesh needs torch.distributed "
                             "(torchrun, or launch.mesh.init_distributed)")
        return Mesh(shape, axes)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} has {n} ranks; the job has "
                         f"{world}")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, coords=dm.get_coordinate(), device_mesh=dm)


def emulated_mesh(shape: Sequence[int], axes: Sequence[str],
                  coords: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh as the rank at ``coords`` sees it, without processes."""
    return Mesh(shape, axes, coords=coords)


def layout_coords(mesh: Mesh):
    """Every rank's coordinates of ``mesh``'s layout, row-major."""
    return list(itertools.product(*(range(mesh.shape[a])
                                    for a in mesh.axis_names)))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None) -> Mesh:
    """The reference's production layout: 16 x 16 = 256 ranks per pod,
    two pods with ``multi_pod``.  Refused on a job with fewer ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) > world:
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; this job has {world}")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(n_data: int = 2, n_model: int = 2,
                    device: Optional[str] = None) -> Mesh:
    """A small (data, model) mesh for tests (gloo ranks: ``device="cpu"``)."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes (``pod`` folds into DP when present).
    ``REPRO_FLAT_DP=1`` makes every axis data-parallel."""
    names = tuple(mesh.axis_names)
    if os.environ.get("REPRO_FLAT_DP"):
        return names
    return tuple(a for a in ("pod", "data") if a in names)
