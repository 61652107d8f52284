"""The data mesh of the port: one process a card, ``torch.distributed`` for
the collectives.

Counterpart of ``waveunet_tpu/parallel/mesh.py``. A JAX ``Mesh`` is a set
of devices inside one SPMD program; here it is the world of an initialised
process group, and each rank owns one device (``cuda:<local rank>``, or the
CPU for the gloo tests). A rank plays the part of one mesh device:

  * parameters and optimiser state are replicated: ``put_replicated``
    broadcasts them from rank 0;
  * batches (training) and windows (inference) are sharded on the leading
    axis over the ranks in rank order: ``put_batch_sharded`` takes this
    rank's rows;
  * gradients, losses and gathered outputs cross ranks through
    ``all_reduce`` and ``broadcast`` only. A gather is an ``all_reduce``
    SUM into a zeroed buffer in which each rank filled its own slot, on the
    buffer's integer bit pattern, so it is exact (signed zeros and NaN
    payloads included) and the gloo backend needs nothing it lacks on
    CUDA tensors.

Several cards in one process are refused: run one process per card (the
CLI's pod options, or ``torchrun``). Without an initialised process group
``make_mesh`` gives a world of one. The JAX package's ``replicated`` and
``batch_sharded`` return ``NamedSharding`` objects, which have no PyTorch
counterpart: the placement they describe is what ``put_replicated`` and
``put_batch_sharded`` do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from waveunet_tpu_torch.device import resolve_device


def _dist():
    import torch.distributed as dist
    return dist


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A 1-D (or reshaped) data mesh over the ranks of a process group.

    ``size`` ranks, this process's ``rank``, its ``device``, the process
    ``group`` (None: the default group, or no group in a world of one) and
    ``axis_names`` with their ``shape``; every axis shards the leading
    dimension, in rank order."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device: torch.device, rank: int, group=None):
        self.shape = shape
        self.axis_names = axis_names
        self.device = device
        self.rank = rank
        self.size = int(np.prod(shape))
        self.group = group

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend ("nccl" or "gloo"); None in a world
        of one without a group."""
        dist = _dist()
        if dist.is_available() and dist.is_initialized():
            return dist.get_backend(self.group)
        return None

    @property
    def collective_device(self) -> torch.device:
        """Where this mesh's collectives run: the rank's card under NCCL,
        the CPU otherwise (gloo's own tensors)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data",),
              devices=None) -> Mesh:
    """The mesh over every rank of the default process group (a world of
    one without a group). ``shape=(-1,)`` or None uses all of them, a -1
    takes what the other axes leave, and a shape that does not multiply to
    the world size raises the JAX package's ``ValueError``. ``devices`` is
    this rank's one device (default: the current card); several raise,
    since the port runs one process a card."""
    if devices is None:
        devices = [None]
    devices = list(devices)
    if len(devices) != 1:
        raise ValueError(
            f"{len(devices)} devices in one process: the port runs one "
            f"process per card (launch the ranks with the CLI's "
            f"coordinator=/num_processes=/process_id= options or torchrun)")
    dev = devices[0]
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    device = resolve_device(dev)
    rank, n = world()
    if shape is None or tuple(shape) == (-1,):
        shape = (n,)
    shape = tuple(int(s) if s != -1 else n // int(np.prod(
        [x for x in shape if x != -1]) or 1) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {axis_names} do not name the "
                         f"{len(shape)} axes of mesh shape {shape}")
    return Mesh(shape, tuple(axis_names), device, rank)


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` itself, or None; anything else raises ``TypeError`` (a JAX
    mesh, a device list)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a waveunet_tpu_torch.parallel.mesh.Mesh "
            f"(make_mesh()), got {type(mesh).__name__}")
    return mesh


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def put_replicated(tree, mesh: Mesh):
    """Every tensor (or array) of ``tree`` copied to ``mesh.device``,
    holding rank 0's values on every rank."""
    tree = _map(tree, lambda x: torch.as_tensor(x).to(mesh.device,
                                                      copy=True))
    broadcast_tree_(tree, mesh)
    return tree


def put_batch_sharded(x, mesh: Mesh):
    """This rank's rows of the leading axis of ``x`` (a tensor, an array or
    a dict of them) on ``mesh.device``; an axis that does not divide over
    the ranks raises."""
    def put(v):
        v = torch.as_tensor(v)
        if v.shape[0] % mesh.size:
            raise ValueError(f"leading axis {v.shape[0]} not divisible by "
                             f"{mesh.size} mesh devices")
        per = v.shape[0] // mesh.size
        return v[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)
    return _map(x, put)


# -- collectives ------------------------------------------------------------

_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.int32: torch.int32, torch.int64: torch.int64}


def _on_collective(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dev = mesh.collective_device
    return t if t.device == dev else t.to(dev)


def all_reduce_(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` (``op``: "sum", "max" or "min") over
    the mesh; the identity in a world of one without a group."""
    if mesh.backend is None:
        return t
    dist = _dist()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    c = _on_collective(t, mesh)
    dist.all_reduce(c, op=ops[op], group=mesh.group)
    if c is not t:
        t.copy_(c)
    return t


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks whose backward is the SUM of the ranks' incoming
    gradients: the gradient of a sum every rank reads."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, differentiable: the backward
    all-reduces the incoming gradient (SUM), so each rank's share of a
    statistic taken over the whole sharded batch gets the gradient of every
    rank's use of it. ``t`` itself, with no collective, in a world of one
    (or without a mesh)."""
    if mesh is None or mesh.size == 1:
        return t
    return _AllReduceSum.apply(t, mesh)


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """In place: rank ``src``'s values of ``t`` on every rank."""
    if mesh.backend is None:
        return t
    c = _on_collective(t, mesh)
    _dist().broadcast(c, src, group=mesh.group)
    if c is not t:
        t.copy_(c)
    return t


def broadcast_tree_(tree, mesh: Mesh) -> None:
    """In place: rank 0's values of every tensor of ``tree`` (nested dicts,
    tuples and lists of tensors) on every rank."""
    if isinstance(tree, (dict, tuple, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            broadcast_tree_(v, mesh)
    else:
        with torch.no_grad():
            broadcast_(tree, mesh)


def merge_disjoint_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In place, bit for bit: every element from the one rank that wrote it
    (the others hold zeros there). An ``all_reduce`` SUM of the integer bit
    pattern, so nothing is rounded and -0.0 and NaN stay as written."""
    if t.dtype in _INT_VIEW:
        all_reduce_(t.view(_INT_VIEW[t.dtype]), mesh)
        return t
    wide = t.to(torch.int32)  # int16, int8, bool: exact in int32
    all_reduce_(wide, mesh)
    t.copy_(wide)
    return t


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal-shaped ``local`` tensors concatenated on the leading
    axis in rank order, on every rank, bit for bit."""
    n = local.shape[0]
    out = local.new_zeros((mesh.size * n,) + tuple(local.shape[1:]))
    out[mesh.rank * n:(mesh.rank + 1) * n] = local
    return merge_disjoint_(out, mesh)


def barrier(mesh: Mesh) -> None:
    """Every rank reaches this point before any goes on (a one-element
    ``all_reduce``, so NCCL needs no device guess)."""
    t = torch.zeros(1, device=mesh.collective_device)
    all_reduce_(t, mesh)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def host_mesh() -> Optional[Mesh]:
    """A mesh over the default process group on the device its collectives
    use (the current card under NCCL, the CPU under gloo), or None in a
    world of one: what the pod helpers, which get no mesh, reduce over."""
    rank, n = world()
    if n == 1:
        return None
    dev = (torch.device("cuda", torch.cuda.current_device())
           if _dist().get_backend() == "nccl" else torch.device("cpu"))
    return Mesh((n,), ("data",), dev, rank)
