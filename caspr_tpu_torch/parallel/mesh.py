"""Data and point parallelism over torch.distributed (counterpart of
caspr_tpu/parallel/mesh.py).

The JAX package shards the batch over the ``dp`` axes of a ``(dp,)``,
``(dcn, dp)``, ``(dp, sp)`` or ``(dcn, dp, sp)`` device mesh, and the point
axis over ``sp``, and lets GSPMD run the one-device program over the global
batch, so every reduction is global by construction.  The port runs
PyTorch's way, one process (rank) per device: a rank holds only its rows
of each global batch and, with ``sp``, only its range of each cloud's
points; nothing is global unless the code says so.  Each reduction the
model makes over rows or points is made global explicitly, through one of
the helpers below and the process groups of the mesh (``Mesh``): the
batch group (the dp axes flattened: the ranks that hold the other rows of
the same points), the point group (the sp axis: the other points of the
same rows) and the whole group (every rank).  The kinds they count:

  - the dopri5 error norms and Hairer's initial step (``ops/odeint.py``,
    "norm"), so that every rank takes the one-process run's steps;
  - the VJP of the replicated parameters at each evaluation of the
    adjoint's augmented dynamics ("adjoint_vjp"), and with sp that of the
    CNF's context, a sum over points ("adjoint_ctx"; "discrete_ctx" under
    autograd through the solver);
  - the MovingBatchNorm's batch statistics ("mbn");
  - the latent ODE's request times, the union of every row's ("times");
  - the encoder's input, whose clouds sp gathers whole ("points");
  - the gradient, summed over ranks in one flat buffer before the
    optimizer's step ("grad"), and the logged scalars ("metrics");
  - the evaluations' per-row results ("eval") and sequence ids ("ids");
  - ``replicate``'s broadcast of the parameters from rank 0 ("replicate").

Random draws (the Hutchinson noise, the decoder's base samples) are made
at the global batch's shape from a generator every rank seeds alike, and a
rank keeps its rows and its points: each rank holds the one-process run's
numbers.  The rule for sums over ranks: a value sharded over sp enters
every sum from every rank; a value replicated over sp enters once, from
the point group's rank 0 (``count_once``).

The helpers count their calls and bytes by kind in ``collectives``, as
``ops.kernels`` counts launches.  Bytes are what one rank hands to the
collective: the buffer of an all-reduce or broadcast, the local part of an
all-gather, the pickled object of an object gather.
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
DCN_AXIS = "dcn"
SP_AXIS = "sp"
# the point axis of a (B, T, N, ...) batch, cut over sp
POINT_AXIS = 2

# calls and bytes of each kind of collective since the last
# reset_collectives(): {kind: {"calls": n, "bytes": b}}
collectives: dict = {}


def reset_collectives():
    collectives.clear()


def _count(kind: str, nbytes: int):
    entry = collectives.setdefault(kind, {"calls": 0, "bytes": 0})
    entry["calls"] += 1
    entry["bytes"] += int(nbytes)


def _nbytes(tensor) -> int:
    return tensor.numel() * tensor.element_size()


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where the caller names one with its
    index or the CPU, else the card of index LOCAL_RANK (torchrun's,
    default 0).  Raises where CUDA is asked for and there is no such card;
    makes a CUDA device current."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} has no card: {torch.cuda.device_count()} "
                               "visible; start one process per card")
        device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def init_distributed(backend=None, device=None) -> torch.device:
    """Join this run's process group and return this rank's device
    (``rank_device(device)``).

    The rendezvous is torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT); a process started without it is a group of
    one, as the JAX package's mesh of one device is.  The backend is "nccl"
    for a CUDA device and "gloo" for the CPU unless the caller passes one.
    A group the caller has formed already (``dist.init_process_group``) is
    kept; a ``backend`` that differs from its backend raises."""
    dev = rank_device(device)
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


class Mesh:
    """The ranks of the process group laid out on named axes, with the
    process groups the model reduces over.

    ``mesh`` is the tensor of global ranks, of shape ``(dp,)``, ``(dcn,
    dp)``, ``(dp, sp)`` or ``(dcn, dp, sp)``; ``mesh_dim_names`` its axes.
    ``batch``: this rank's group over the dp axes flattened (the ranks that
    hold the other rows of the same points; one such group per sp index).
    ``point``: its group over sp (the ranks that hold the other points of
    the same rows), None without sp.  The whole group is every rank."""

    def __init__(self, ranks: torch.Tensor, names, batch, point):
        self.mesh, self.mesh_dim_names = ranks, tuple(names)
        self.batch, self.point = batch, point

    @property
    def ndim(self) -> int:
        return self.mesh.ndim


def _subgroup(rank_lists, timeout):
    """This rank's group among ``rank_lists`` (every rank makes every
    group, in the same order)."""
    return dist.new_subgroups_by_enumeration(rank_lists, timeout=timeout)[0]


def make_mesh(num_slices=None, *, sp_size: int = 1, timeout: float | None = None) -> Mesh:
    """The ``(dp,)`` mesh over every rank of the process group, ``(dcn,
    dp)`` with one row per node when there is more than one, and with
    ``sp_size > 1`` an inner ``sp`` axis: ``(dp, sp)`` or ``(dcn, dp,
    sp)``.  ``sp`` is innermost, so that the ranks of a point group are
    consecutive and share a node.

    ``num_slices`` (nodes) defaults to WORLD_SIZE // LOCAL_WORLD_SIZE from
    torchrun's environment (1 without it); pass it to shape a mesh
    explicitly.  A per-node rank count that ``sp_size`` does not divide
    raises ValueError, as the JAX package's make_mesh does.  ``timeout``
    (seconds): the deadline of each collective of the sp groups (default:
    the backend's)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world = dist.get_world_size()
    if num_slices is None:
        num_slices = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if num_slices < 1 or world % num_slices:
        raise ValueError(f"{world} ranks do not divide into {num_slices} slices")
    if sp_size < 1 or (world // num_slices) % sp_size:
        raise ValueError(f"per-node rank count {world // num_slices} is not divisible by "
                         f"sp_size={sp_size}")
    names = ((DCN_AXIS,) if num_slices > 1 else ()) + (DP_AXIS,) + (
        (SP_AXIS,) if sp_size > 1 else ())
    shape = ((num_slices,) if num_slices > 1 else ()) + (world // num_slices // sp_size,) + (
        (sp_size,) if sp_size > 1 else ())
    ranks = torch.arange(world).reshape(shape)
    if sp_size == 1:
        return Mesh(ranks, names, dist.group.WORLD, None)
    layout = ranks.reshape(-1, sp_size)  # a row per point group, a column per batch group
    timeout = None if timeout is None else datetime.timedelta(seconds=timeout)
    batch = _subgroup(layout.T.tolist(), timeout)
    return Mesh(ranks, names, batch, _subgroup(layout.tolist(), timeout))


def describe(mesh: Mesh) -> str:
    """'<n> devices, axes (<names>) (<shape>)', as the JAX package logs a mesh."""
    return (f"{mesh.mesh.numel()} devices, axes {tuple(mesh.mesh_dim_names)} "
            f"{tuple(mesh.mesh.shape)}")


def _check_spans(mesh: Mesh):
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the process group")


def batch_group(mesh: Mesh):
    """The process group of every data-parallel axis of ``mesh`` flattened:
    the group over which the batch is sharded (every rank without sp)."""
    _check_spans(mesh)
    return mesh.batch


def point_group(mesh: Mesh):
    """The process group of the ``sp`` axis: the group over which the
    points are sharded; None without sp."""
    return mesh.point


class Groups(NamedTuple):
    """The process groups a sharded model call reduces over: ``batch``
    (rows), ``point`` (points; None without sp) and ``whole`` (both)."""

    batch: object
    point: object
    whole: object


def mesh_groups(mesh: Mesh | None) -> Groups | None:
    """The groups of ``mesh`` for the model's ``groups=``; None without a mesh."""
    if mesh is None:
        return None
    return Groups(batch_group(mesh), point_group(mesh), dist.group.WORLD)


def group_rank_size(group):
    """(this rank's index in ``group``, the group's size); (0, 1) for None."""
    return (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))


def is_lead(group) -> bool:
    """Whether this rank writes the run's shared files: rank 0 of the
    group, or any process without one."""
    return group is None or dist.get_rank(group) == 0


def all_reduce_sum(tensor, group, kind: str):
    """Sum ``tensor`` over the ranks of ``group`` in place; returns it."""
    _count(kind, _nbytes(tensor))
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_reduce_sum_leaves(leaves, group, kind: str) -> list:
    """Each tensor of ``leaves`` (one dtype and device) summed over the
    ranks of ``group``, through one all-reduce of one flat buffer; returns
    views of the buffer in their shapes."""
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in leaves]), group, kind)
    out, at = [], 0
    for t in leaves:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def all_gather_cat(tensor, group, kind: str, dim: int = 0):
    """Every rank's ``tensor`` (equal shapes) concatenated along ``dim`` in
    rank order: along 0 the global batch's rows from each rank's, along a
    point axis each cloud's points from each rank's range."""
    tensor = tensor.contiguous()
    _count(kind, _nbytes(tensor))
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(tensor, group, kind: str):
    """``tensor`` from the group's rank 0 to every rank, in place; returns it."""
    _count(kind, _nbytes(tensor))
    dist.broadcast(tensor, src=dist.get_global_rank(group, 0), group=group)
    return tensor


def all_gather_objects(obj, group, kind: str) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    _count(kind, len(pickle.dumps(obj)))
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class _CountOnce(torch.autograd.Function):
    """The identity; its gradient passes on the lead rank and is zero elsewhere."""

    @staticmethod
    def forward(ctx, x, lead):
        ctx.lead = lead
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.lead else torch.zeros_like(grad)), None


def count_once(tree, group):
    """``tree``, tensors (a tensor, or a dict / list / tuple of them) every
    rank of ``group`` holds alike, whose gradient enters a sum over the
    ranks from the group's rank 0 alone: the identity, whose backward
    passes the cotangent on rank 0 and zero elsewhere.  With ``group``
    None, ``tree``."""
    if group is None:
        return tree
    lead = is_lead(group)
    return _map(lambda x: _CountOnce.apply(x, lead), tree)


class _SumGrad(torch.autograd.Function):
    """The identity; its gradient is summed over a group."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group, ctx.kind), None, None


def sum_grad(x, group, kind: str):
    """``x``, whose cotangent each rank of ``group`` holds a part of (a sum
    over its points), made the whole on every rank: the identity, whose
    backward sums the cotangent over ``group``.  With ``group`` None, ``x``."""
    return x if group is None else _SumGrad.apply(x, group, kind)


def global_draw(draw, shape, groups):
    """This rank's part of ``draw(global shape)``: of a (rows, points, ...)
    draw at R_dp x the rows and sp x the points, the batch-group rank's
    rows and the point-group rank's points."""
    b_rank, b_size = group_rank_size(groups.batch)
    p_rank, p_size = group_rank_size(groups.point)
    rows, n = shape[0], shape[1]
    full = draw((b_size * rows, p_size * n, *shape[2:]))
    return full[b_rank * rows:(b_rank + 1) * rows, p_rank * n:(p_rank + 1) * n].contiguous()


def replicate(mesh: Mesh, tree):
    """Broadcast every tensor leaf of ``tree`` from rank 0 to every rank in
    place (one flat buffer per dtype and device); returns ``tree``."""
    from ..ops.odeint import flatten_tree  # ops.odeint imports this module

    _check_spans(mesh)
    by_kind = {}
    for leaf in flatten_tree(tree)[0]:
        by_kind.setdefault((leaf.dtype, leaf.device), []).append(leaf)
    with torch.no_grad():
        for leaves in by_kind.values():
            flat = broadcast(torch.cat([t.reshape(-1) for t in leaves]), dist.group.WORLD,
                             "replicate")
            at = 0
            for t in leaves:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
    return tree


def _rows(x, rank: int, size: int, microbatches: int):
    if getattr(x, "ndim", 0) == 0:
        return x
    if x.shape[0] % (size * microbatches):
        raise ValueError(f"batch {x.shape[0]} not divisible by {microbatches} microbatches x "
                         f"{size} ranks")
    mb = x.shape[0] // microbatches
    part = mb // size
    if microbatches == 1:
        return x[rank * part:(rank + 1) * part]
    pieces = [x[i + rank * part:i + (rank + 1) * part] for i in range(0, x.shape[0], mb)]
    return torch.cat(pieces) if isinstance(x, torch.Tensor) else np.concatenate(pieces)


def _points(x, rank: int, size: int):
    """Range ``rank`` of ``size`` equal ranges of ``x`` along ``POINT_AXIS``;
    leaves without that axis as they are."""
    if size == 1 or getattr(x, "ndim", 0) <= POINT_AXIS:
        return x
    n = x.shape[POINT_AXIS]
    if n % size:
        raise ValueError(f"{n} points not divisible by {size} sp ranks")
    index = (slice(None),) * POINT_AXIS + (slice(rank * n // size, (rank + 1) * n // size),)
    return x[index]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, microbatches: int = 1):
    """This rank's rows of a batch every rank holds: each array leaf (numpy
    or tensor) cut along its leading axis into equal parts in the order of
    the batch group's ranks; 0-d leaves as they are.  With ``microbatches``
    the leading axis is that many contiguous microbatches, and the rank
    takes its part of each in turn (as ``SequenceLoader(microbatches=)``
    does).  The ranks of a point group hold the same rows."""
    rank, size = group_rank_size(batch_group(mesh))
    return _map(lambda x: _rows(x, rank, size, microbatches), tree)


def shard_points(mesh: Mesh, tree):
    """This rank's points of rows it holds whole: each leaf with more than
    ``POINT_AXIS`` axes, a (B, T, N, ...) batch, cut along N into equal
    ranges in sp-rank order; the others as they are (also without sp)."""
    rank, size = group_rank_size(point_group(mesh))
    return _map(lambda x: _points(x, rank, size), tree)


def shard_batch_points(mesh: Mesh, tree, microbatches: int = 1):
    """``shard_batch``, then ``shard_points``: the batch axis over the dp
    axes and the point axis over sp.  Leaves with ``ndim <= POINT_AXIS``
    (such as (B, T) timestamps) are cut by rows only; 0-d leaves are left
    as they are."""
    return shard_points(mesh, shard_batch(mesh, tree, microbatches))


def global_batch_points(mesh: Mesh, tree, device=None):
    """Put this rank's part of a sharded loader's batch (every leaf an
    array whose leading axis is the rank's rows, ``SequenceLoader(
    num_shards=, shard_index=)`` over the batch group) on this rank's
    device, ``rank_device(device)``: its card unless the caller names the
    CPU, whatever backend the mesh runs (gloo also carries CUDA tensors).
    The rows are placed as they are and cut to the rank's point range
    (``shard_points``): together the ranks hold the global batch."""
    device = rank_device(device)
    return _map(lambda x: torch.as_tensor(x, device=device), shard_points(mesh, tree))
