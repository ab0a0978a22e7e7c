"""Process-wide sharding context and the ordered combine of the sharded
analog step (port of ``repro.core.shardctx``).

The sharded analog step runs one process per rank (``torch.distributed``:
NCCL on cards, gloo on the CPU).  Each rank holds its own whole-tile
blocks of every crossbar container; activations and tapes stay
replicated.  The determinism contract is the reference's:

The sharded step produces *bit-identical* conductances, loss and rail
fraction to the single-device step.  Every floating-point reduction
therefore either runs over unsharded dims only (the within-tile analog
integration, the token contraction of the write, all loss and metric
math over replicated activations), or gathers its operands into
single-device order before reducing: the shard-local read
(``kernels.xbar_vmm.manual_collective_read``) gathers the per-tile ADC
partials with :func:`combine_partials_exact` and sums them over the full
tile axis in single-device order.  The only cross-rank traffic on the
analog path is an arithmetic-free ``all_gather`` in pinned order; no
partial sum is ever ``all_reduce``'d.

:func:`combine_blocks` is the combine as a pure function over the list of
per-shard blocks; :func:`combine_partials_exact` joins with it whatever
the mesh's gather returns: the blocks of the ranks of a job, or of the
ranks of a layout emulated in one process (``launch.mesh.emulate_layout``,
which runs a layout's shards one after another on one card).

The numeric (FSDP and tensor-parallel) step lives on another contract:
its float sums meet in ``all_reduce`` / ``reduce_scatter`` and agree with
one device within float32 rounding.  Its differentiable collectives are
here (:func:`gather`, :func:`copy_to`, :func:`reduce_from`,
:func:`reduce_sum`, :func:`scatter_reduce`, :func:`split_to`: each a pair of a forward and a backward
collective over a tuple of mesh axes, Megatron's f / g
operators and FSDP's gather), and so is the slot of the step's
:class:`~repro_torch.launch.sharding.NumericParallel`
(:func:`numeric_context`), which the models consult to gather a layer's
blocks and to split their compute over ``model``.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager as _contextmanager
from typing import Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

_CTX: dict = {"mesh": None, "dp": None, "tp": None}
#: The numeric step's context, one a thread: the ranks of a layout
#: emulated in one process (``launch.mesh.emulate_layout``) are threads.
_NUMERIC = threading.local()

#: The ordered gathers this process took part in, and the bytes it
#: received from other ranks through them (only
#: :func:`combine_partials_exact` adds to these two); ``"numeric"``: by
#: mesh axis, the bytes it receives through the numeric step's
#: collectives (:func:`_collective`: the differentiable ones, forward and
#: backward, and the MoE's count exchanges) as a ring moves them, a
#: gather its ``n - 1`` other blocks, a reduce-scatter ``(n - 1) / n`` of
#: its operand and an all-reduce twice that.
GATHERED = {"gathers": 0, "bytes": 0, "numeric": {}}


def set_shard_context(mesh, dp_axes, tp_axis: str = "model") -> None:
    """Install the active mesh (``launch.mesh.Mesh``).  ``dp_axes`` may be
    ``None`` for layouts that keep the batch replicated (the sharded
    analog step)."""
    _CTX.update(mesh=mesh, dp=dp_axes, tp=tp_axis)


def clear_shard_context() -> None:
    _CTX.update(mesh=None, dp=None, tp=None)


def get_shard_context() -> Tuple[Optional[object], Optional[object], object]:
    return _CTX["mesh"], _CTX["dp"], _CTX["tp"]


def current_mesh():
    return _CTX["mesh"]


@_contextmanager
def suspended_shard_context():
    """Clear the mesh context for the duration of a block."""
    prev = get_shard_context()
    clear_shard_context()
    try:
        yield
    finally:
        set_shard_context(*prev)


@dataclasses.dataclass(frozen=True)
class ShardMeta:
    """How one analog container is tiled over a mesh, and where this rank
    sits in it.

    Stored under the ``"tp_meta"`` key of a container by the sharded step
    (``train.analog_lm.AnalogTrainStep``).  A per-layer view of a stacked
    container keeps the same meta: every field is resolved against the
    *trailing* dims of the ``g`` view that reaches the read.  ``shape`` is
    the global ``g`` shape, ``row``/``col`` name the mesh axes sharding
    dims ``-2``/``-1``, ``lead`` (aligned right) the axes sharding the
    remaining lead dims (the MoE expert dim); ``axis_sizes`` and
    ``coords`` give each mesh axis's size and this rank's coordinate on
    it.  ``exact`` False (``AnalogTrainStep(exact=False)``) lets the read
    sum its reduction tiles on each rank and ``all_reduce`` the ranks'
    sums (``kernels.xbar_vmm.manual_collective_read``).
    """

    shape: Tuple[int, ...]
    row: Tuple[str, ...] = ()
    col: Tuple[str, ...] = ()
    lead: Tuple[Tuple[str, ...], ...] = ()
    axis_sizes: Tuple[Tuple[str, int], ...] = ()
    coords: Tuple[Tuple[str, int], ...] = ()
    exact: bool = True

    @property
    def sharded(self) -> bool:
        return bool(self.row or self.col or any(self.lead))

    def view(self, ndim: int) -> Tuple[int, ...]:
        """Global shape of a (possibly layer-sliced) ``ndim``-dim view."""
        return self.shape[len(self.shape) - ndim:]

    def lead_names(self, n_lead: int) -> Tuple[Tuple[str, ...], ...]:
        """Mesh axes of the trailing ``n_lead`` lead dims of the view."""
        pad = n_lead - len(self.lead)
        if pad > 0:
            return ((),) * pad + self.lead
        return self.lead[len(self.lead) - n_lead:]


def flat_index(sizes: dict, coords: dict, names: Sequence[str]) -> int:
    """Row-major flat shard coordinate along ``names``, major axis first:
    the at-rest layout of a dim sharded over several axes."""
    idx = 0
    for a in names:
        idx = idx * int(sizes[a]) + int(coords[a])
    return idx


def shard_index(meta: ShardMeta, names: Sequence[str]) -> int:
    """This rank's flat shard coordinate along ``names`` (row-major over
    its mesh coordinates, as the reference's ``shard_index``)."""
    return flat_index(dict(meta.axis_sizes), dict(meta.coords), names)


def combine_blocks(blocks: Sequence[Tensor], axis: int) -> Tensor:
    """The ordered combine as a pure function: ``blocks[i]`` is the block
    of flat shard coordinate ``i`` (:func:`flat_index`); they concatenate
    along ``axis`` in that order, which is the at-rest order of the dim.
    Arithmetic-free."""
    return torch.cat(list(blocks), dim=axis)


def combine_partials_exact(q: Tensor, names: Sequence[str], axis: int,
                           mesh=None) -> Tensor:
    """Reassemble a dim sharded over ``names`` into pinned global order on
    the ranks of ``mesh`` (default: the installed one).

    Gathers minor mesh axis first, each axis's blocks in its order
    (``mesh.gather_blocks``: ``all_gather_into_tensor`` on that axis's
    process group, or the exchange of an emulated layout), joined by
    :func:`combine_blocks`, so shard blocks concatenate in the at-rest
    order.  The caller's reduction then runs over the full axis in
    single-device order; the collective itself moves bits and adds
    nothing.  Identity when ``names`` is empty.
    """
    if not names:
        return q
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("combine_partials_exact needs a mesh: pass one or "
                         "install it with set_shard_context")
    for a in reversed(tuple(names)):
        n = mesh.shape[a]
        if n > 1:
            GATHERED["gathers"] += 1
            GATHERED["bytes"] += (n - 1) * q.numel() * q.element_size()
            q = combine_blocks(mesh.gather_blocks(q, a), axis)
    return q


# --------------------------------------------------------------------------
# The numeric step's differentiable collectives
# --------------------------------------------------------------------------

def _count(axis: str, nbytes: float) -> None:
    by = GATHERED["numeric"]
    by[axis] = by.get(axis, 0) + int(nbytes)


def _collective(x: Tensor, mesh, axes: Sequence[str], dim: int,
                kind: str) -> Tensor:
    """One collective over ``axes`` in turn: ``gather`` (minor axis first,
    so the blocks land in row-major order), ``reduce_scatter`` and
    ``slice`` (major axis first, their inverse), ``all_reduce`` (sum),
    ``id``."""
    if kind == "id":
        return x
    if kind == "gather":
        for a in reversed(tuple(axes)):
            _count(a, (mesh.shape[a] - 1) * x.numel() * x.element_size())
            x = mesh.all_gather(x, a, dim)
        return x
    for a in axes:
        n = mesh.shape[a]
        ring = {"all_reduce": 2.0, "reduce_scatter": 1.0}.get(kind, 0.0)
        _count(a, ring * (n - 1) / n * x.numel() * x.element_size())
        if kind == "all_reduce":
            x = mesh.all_reduce(x, a)
        elif kind == "reduce_scatter":
            x = mesh.reduce_scatter(x.contiguous(), a, dim)
        elif kind == "slice":
            loc = x.shape[dim] // n
            x = x.narrow(dim, mesh.coords[a] * loc, loc)
        else:
            raise ValueError(f"unknown collective {kind!r}")
    return x


class _Collective(torch.autograd.Function):
    """A forward collective and its adjoint's backward one."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, fwd, bwd):
        ctx.args = (mesh, axes, dim, bwd)
        out = _collective(x, mesh, axes, dim, fwd)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, bwd = ctx.args
        out = _collective(g.contiguous(), mesh, axes, dim, bwd)
        return out, None, None, None, None, None


def _live(mesh, axes) -> Tuple[str, ...]:
    return tuple(a for a in (axes or ()) if mesh.shape.get(a, 1) > 1)


def _apply(x, mesh, axes, dim, fwd, bwd):
    axes = _live(mesh, axes) if mesh is not None else ()
    if not axes:
        return x
    return _Collective.apply(x, mesh, axes, dim, fwd, bwd)


def gather(x: Tensor, mesh, axes, dim: int, grad: str = "reduce_scatter"
           ) -> Tensor:
    """``x``'s blocks over ``axes`` concatenated along ``dim``.  Backward
    ``grad``: ``reduce_scatter`` (FSDP: each rank's gradient is partial)
    or ``slice`` (the ranks compute the same gradient: compute replicated
    over ``axes``)."""
    return _apply(x, mesh, axes, dim, "gather", grad)


def copy_to(x: Tensor, mesh, axes) -> Tensor:
    """Identity forward, gradient summed over ``axes`` (Megatron's f: the
    input of a column-parallel read)."""
    return _apply(x, mesh, axes, 0, "id", "all_reduce")


def reduce_from(x: Tensor, mesh, axes) -> Tensor:
    """Summed over ``axes`` forward, identity backward (Megatron's g: the
    output of a row-parallel read)."""
    return _apply(x, mesh, axes, 0, "all_reduce", "id")


def reduce_sum(x: Tensor, mesh, axes) -> Tensor:
    """Summed over ``axes`` forward and backward: the ranks' terms of one
    global sum that every rank then uses alike (the MoE aux loss's means
    over the data ranks' tokens).  Each rank's term gets the sum of the
    ranks' gradients, so that the data-parallel mean of the step's
    gradients is the global sum's."""
    return _apply(x, mesh, axes, 0, "all_reduce", "all_reduce")


def scatter_reduce(x: Tensor, mesh, axes, dim: int) -> Tensor:
    """Summed over ``axes`` and this rank's chunk along ``dim`` kept;
    backward gathers (sequence parallelism after a row-parallel read)."""
    return _apply(x, mesh, axes, dim, "reduce_scatter", "gather")


def split_to(x: Tensor, mesh, axes, dim: int) -> Tensor:
    """This rank's chunk along ``dim`` of an ``x`` the ranks of ``axes``
    hold alike; backward gathers the chunks' gradients (sequence
    parallelism after a read whose whole output every rank holds)."""
    return _apply(x, mesh, axes, dim, "slice", "gather")


@_contextmanager
def numeric_parallel(ctx):
    """Install the numeric step's
    :class:`~repro_torch.launch.sharding.NumericParallel` for a block."""
    prev = numeric_context()
    _NUMERIC.ctx = ctx
    try:
        yield ctx
    finally:
        _NUMERIC.ctx = prev


def numeric_context():
    """This thread's installed numeric-parallel context, or None."""
    return getattr(_NUMERIC, "ctx", None)
