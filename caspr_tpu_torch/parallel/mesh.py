"""Data parallelism over torch.distributed (counterpart of
caspr_tpu/parallel/mesh.py).

The JAX package shards the batch over a ``(dp,)`` or ``(dcn, dp)`` device
mesh and lets GSPMD run the one-device program over the global batch, so
every reduction over the batch is global by construction.  The port runs
PyTorch's way, one process (rank) per device, and a rank holds only its
rows of each global batch; nothing is global unless the code says so.  The
reductions the model makes over the batch are made global explicitly, each
through one of the helpers below:

  - the dopri5 error norms and Hairer's initial step (``ops/odeint.py``,
    kind "norm"), so that every rank takes the one-process run's steps;
  - the VJP of the replicated parameters at each evaluation of the
    adjoint's augmented dynamics ("adjoint_vjp");
  - the MovingBatchNorm's batch statistics ("mbn");
  - the latent ODE's request times, the union of every row's ("times");
  - the gradient, summed over ranks in one flat buffer before the
    optimizer's step ("grad"), and the logged scalars ("metrics");
  - the evaluations' per-row results ("eval") and sequence ids ("ids");
  - ``replicate``'s broadcast of the parameters from rank 0 ("replicate").

Random draws over the batch (the Hutchinson noise, the decoder's base
samples) are made at the global batch's shape from a generator every rank
seeds alike, and a rank keeps its rows: each rank holds the one-process
run's numbers.

The helpers count their calls and bytes by kind in ``collectives``, as
``ops.kernels`` counts launches.  Bytes are what one rank hands to the
collective: the buffer of an all-reduce or broadcast, the local part of an
all-gather, the pickled object of an object gather.

``sp`` (point parallelism) is not ported: ``make_mesh(sp_size > 1)``
raises (ROADMAP Queue 1 item 10.8).  ``dcn`` is: the 2-D mesh over several
nodes reduces over its flattened group, where NCCL picks the topology.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DP_AXIS = "dp"
DCN_AXIS = "dcn"
SP_AXIS = "sp"
SP_NOT_PORTED = (
    "point parallelism (--sp-size > 1) is not ported: FPS, the ball query and three-NN need "
    "each whole cloud, the MovingBatchNorm's statistics rows are point ranges that an sp split "
    "cuts, and it needs an all-gather ahead of the encoder and a point-sharded CNF reduced over "
    "the (dp, sp) group (ROADMAP Queue 1 item 10.8)")

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


def make_mesh(num_slices=None, *, sp_size: int = 1) -> DeviceMesh:
    """The ``(dp,)`` mesh over every rank of the process group, or ``(dcn,
    dp)`` with one row per node when there is more than one.

    ``num_slices`` (nodes) defaults to WORLD_SIZE // LOCAL_WORLD_SIZE from
    torchrun's environment (1 without it); pass it to shape a mesh
    explicitly.  ``sp_size > 1`` raises NotImplementedError.  The mesh's
    device type is "cuda" on nccl and "cpu" on gloo (which also takes CUDA
    tensors); its only use here is its process group."""
    if sp_size > 1:
        raise NotImplementedError(SP_NOT_PORTED)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world = dist.get_world_size()
    if num_slices is None:
        num_slices = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if num_slices < 1 or world % num_slices:
        raise ValueError(f"{world} ranks do not divide into {num_slices} slices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world)
    if num_slices == 1:
        return DeviceMesh(device_type, ranks, mesh_dim_names=(DP_AXIS,))
    return DeviceMesh(device_type, ranks.reshape(num_slices, -1),
                      mesh_dim_names=(DCN_AXIS, DP_AXIS))


def describe(mesh: DeviceMesh) -> str:
    """'<n> devices, axes (<names>) (<shape>)', as the JAX package logs a mesh."""
    return (f"{mesh.mesh.numel()} devices, axes {tuple(mesh.mesh_dim_names)} "
            f"{tuple(mesh.mesh.shape)}")


def batch_group(mesh: DeviceMesh):
    """The process group of every data-parallel axis of ``mesh`` flattened:
    the group over which the batch is sharded."""
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the process group")
    return mesh.get_group(0) if mesh.ndim == 1 else dist.group.WORLD


def group_rank_size(group):
    """(this rank's index in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


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


def all_gather_rows(tensor, group, kind: str):
    """Every rank's ``tensor`` (equal shapes) concatenated along dim 0 in
    rank order: the global batch's rows from each rank's."""
    tensor = tensor.contiguous()
    _count(kind, _nbytes(tensor))
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor, group=group)
    return torch.cat(parts)


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


def replicate(mesh: DeviceMesh, tree):
    """Broadcast every tensor leaf of ``tree`` from rank 0 in place (one
    flat buffer per dtype and device); returns ``tree``."""
    from ..ops.odeint import flatten_tree  # ops.odeint imports this module

    group = batch_group(mesh)
    by_kind = {}
    for leaf in flatten_tree(tree)[0]:
        by_kind.setdefault((leaf.dtype, leaf.device), []).append(leaf)
    with torch.no_grad():
        for leaves in by_kind.values():
            flat = broadcast(torch.cat([t.reshape(-1) for t in leaves]), group, "replicate")
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


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, tree, microbatches: int = 1):
    """This rank's rows of a batch every rank holds: each array leaf (numpy
    or tensor) cut along its leading axis into equal parts in rank order;
    0-d leaves as they are.  With ``microbatches`` the leading axis is that
    many contiguous microbatches, and the rank takes its part of each in
    turn (as ``SequenceLoader(microbatches=)`` does)."""
    rank, size = group_rank_size(batch_group(mesh))
    return _map(lambda x: _rows(x, rank, size, microbatches), tree)


def shard_batch_points(mesh: DeviceMesh, tree):
    """``shard_batch``: the batch axis over the ranks.  The point axis
    would go over ``sp``, which is not ported, so it stays whole."""
    return shard_batch(mesh, tree)


def global_batch_points(mesh: DeviceMesh, tree, device=None):
    """Put this rank's rows of a sharded loader's batch (every leaf an
    array whose leading axis is the rank's rows) on this rank's device,
    ``rank_device(device)``: its card unless the caller names the CPU,
    whatever backend the mesh runs (gloo also carries CUDA tensors).
    Together the ranks hold the global batch."""
    del mesh  # the rows are this rank's already
    device = rank_device(device)
    return _map(lambda x: torch.as_tensor(x, device=device), tree)
