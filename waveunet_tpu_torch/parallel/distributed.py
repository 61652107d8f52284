"""Multi-process (pod) bring-up and rank-sharded data feeding.

Counterpart of ``waveunet_tpu/parallel/distributed.py``. The JAX package
brings up ``jax.distributed`` and lets XLA move tensors; here every rank is
one process on one card, the process group is ``torch.distributed`` (NCCL
on the card, gloo on the CPU), and a rank plays the part of a JAX host:

  * ``initialize``: the process group from the CLI's pod options or from
    ``torchrun``'s environment, with an explicit timeout, each rank on its
    own card;
  * ``local_batch_slice``, ``make_pod_pipeline``, ``make_pod_bank``,
    ``make_pod_eval_bank``: this rank's rows of the global batch, from its
    own disjoint song subset;
  * ``make_sharded_bank``: the ``ShardedBank`` over the mesh;
  * ``pod_weighted_mean``: a validation mean over ranks whose shards differ
    in size (even empty), exact in float64 and equal on every rank;
  * ``global_batch_from_local``: this rank's batch on its device. No global
    array exists in this idiom: the train step takes this rank's rows and
    all-reduces the gradients.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.data.pipeline import BatchPipeline
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.parallel.mesh import (Mesh, gather_rows, host_mesh,
                                              world)

# How long a collective, and the rendezvous, may wait for the other ranks
# before the process fails instead of hanging.
DEFAULT_TIMEOUT_S = 600.0


def local_rank(process_id: int) -> int:
    """This process's card: torchrun's ``LOCAL_RANK``, else ``process_id``
    modulo the cards on the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: DeviceLike = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Initialise the default process group when running several processes;
    returns this process's rank.

    With ``coordinator_address`` (``host:port``) the group rendezvouses
    over ``tcp://`` with ``num_processes`` ranks, this one being
    ``process_id``. With no arguments it reads torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``; a single process
    (no such environment) is a no-op. ``device`` "cpu" takes gloo, the
    card (default) NCCL, and the card's process takes ``cuda:<local
    rank>`` as its current device; ``backend`` overrides the choice (gloo
    on the card: two ranks sharing one card). Already initialised: the
    rank, nothing else."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None:
        if num_processes is not None and num_processes > 1:
            raise ValueError(
                f"num_processes={num_processes} needs coordinator=<host:port>"
                f" (the rank-0 process's address), or launch with torchrun")
        if int(env.get("WORLD_SIZE", "1")) <= 1:
            return 0
        init_method = "env://"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    else:
        if num_processes is None:
            raise ValueError("coordinator= needs num_processes=")
        if process_id is None:
            if "RANK" not in env:
                raise ValueError("coordinator= needs process_id=")
            process_id = int(env["RANK"])
        addr = coordinator_address
        init_method = addr if addr.startswith("tcp://") else f"tcp://{addr}"
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"0..{num_processes - 1}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank(process_id))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _per_rank(global_batch: int) -> int:
    _, n = world()
    if global_batch % n:
        raise ValueError(f"batch_size {global_batch} must divide evenly "
                         f"across {n} hosts")
    return global_batch // n


def local_batch_slice(global_batch: int) -> slice:
    """Rows of the global batch this rank feeds (an even split)."""
    rank, _ = world()
    per = _per_rank(global_batch)
    return slice(rank * per, (rank + 1) * per)


def make_pod_pipeline(cfg: Config, partition: str, input_len: int,
                      output_len: int, seed: int = 0) -> BatchPipeline:
    """This rank's host pipeline: its disjoint song subset, its rows of the
    global batch."""
    rank, n = world()
    return BatchPipeline(cfg, partition, input_len, output_len,
                         batch_size=_per_rank(cfg.batch_size),
                         host_id=rank, num_hosts=n, seed=seed)


def make_pod_bank(cfg: Config, partition: str, input_len: int,
                  output_len: int, batch_size: Optional[int] = None,
                  device: DeviceLike = None):
    """This rank's device bank: its disjoint song subset on its own card,
    sampling its rows of the global batch."""
    from waveunet_tpu_torch.data.device_cache import DeviceBank

    rank, n = world()
    return DeviceBank(cfg, partition, input_len, output_len,
                      batch_size=_per_rank(batch_size or cfg.batch_size),
                      max_bytes=cfg.device_data_max_bytes,
                      host_id=rank, num_hosts=n, device=device)


def make_sharded_bank(cfg: Config, partition: str, input_len: int,
                      output_len: int, mesh: Mesh,
                      batch_size: Optional[int] = None):
    """The training partition sharded over the mesh's ranks (see
    ``data.device_cache.ShardedBank``). Collective: call on every rank."""
    from waveunet_tpu_torch.data.device_cache import ShardedBank

    return ShardedBank(cfg, partition, input_len, output_len, mesh,
                       batch_size=batch_size or cfg.batch_size,
                       max_bytes=cfg.device_data_max_bytes)


def make_pod_eval_bank(cfg: Config, partition: str, input_len: int,
                       output_len: int, batch_size: Optional[int] = None,
                       device: DeviceLike = None):
    """This rank's evaluation bank: its disjoint song subset, swept at its
    share of the global batch (a global-batch sweep would put the world
    size times the training step's activations on each card); combine the
    ranks' ``loss_sums`` with ``pod_weighted_mean``."""
    from waveunet_tpu_torch.data.device_cache import EvalBank

    rank, n = world()
    return EvalBank(cfg, partition, input_len, output_len,
                    batch_size=_per_rank(batch_size or cfg.batch_size),
                    max_bytes=cfg.device_data_max_bytes,
                    host_id=rank, num_hosts=n, device=device)


def replicated_local_view(tree):
    """``tree`` itself: every rank holds whole tensors (the JAX package's
    local view of a global replicated array)."""
    return tree


def pod_weighted_mean(local_sum: float, local_count: int,
                      mesh: Optional[Mesh] = None) -> float:
    """The mean of per-batch losses over every rank's (sum, count), equal on
    every rank. Each rank's float64 pair is gathered exactly (its bit
    pattern) and the rows are summed in rank order on the host, as the JAX
    package does, so the mean is what float64 gives and an early-stop
    decision cannot differ between ranks. With no batch anywhere it warns
    and returns inf."""
    mesh = mesh if mesh is not None else host_mesh()
    row = torch.tensor([[float(local_sum), float(local_count)]],
                       dtype=torch.float64)
    if mesh is not None:
        row = gather_rows(row.to(mesh.collective_device), mesh)
    arr = row.cpu().numpy()
    total, count = arr[:, 0].sum(), arr[:, 1].sum()
    if count == 0:
        print("WARNING: evaluation produced no batches; returning inf")
        return float("inf")
    return float(total / count)


def global_batch_from_local(mesh: Mesh, local_batch: Dict) -> Dict:
    """This rank's batch as tensors on ``mesh.device`` (numpy uploaded,
    device tensors moved only if elsewhere): what a mesh train step takes."""
    return {k: torch.as_tensor(v).to(mesh.device)
            for k, v in local_batch.items()}
