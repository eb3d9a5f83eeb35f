"""Several processes: torch.distributed plumbing and per-process work shards.

Counterpart of tpujpeg/parallel/distributed.py.  Decoding is data
parallel: each process parses, decodes and keeps its share of the file
list on its own device(s); the only traffic between processes is the
final metrics reduction.  The process group uses the gloo backend: that
traffic is a few host floats, gloo runs without a card, and it lets two
processes share one card, where NCCL refuses two ranks on one GPU.

Typical use (the same script in every process):

    from tpujpeg_torch.parallel import distributed as dist
    dist.initialize(coordinator_address="host:port", num_processes=n,
                    process_id=rank)        # or a launcher's environment
    mine = dist.shard_list(all_paths)       # this process's files
    dec = BatchDecoder(device=...)          # this process's card
    ... decode(mine) ...
    totals = dist.allreduce_metrics({"images": len(mine), "bytes": n})

Initialization keeps the JAX package's three cases: a process group that
exists already (a launcher's, or an earlier call's) is used as it is; a
configured coordinator (keyword arguments, or a launcher's or cluster's
environment variables) that cannot be reached raises, never a quiet
standalone run in which every process would decode the whole list;
nothing configured runs standalone.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# torchrun's variables, and the cluster variables the JAX package reads
_COORDINATOR_ENV_VARS = (
    "MASTER_ADDR",
    "TORCHELASTIC_RUN_ID",
    "COORDINATOR_ADDRESS",
    "SLURM_JOB_ID",
    "OMPI_MCA_orte_hnp_uri",
)

# jax.distributed.initialize's keyword arguments that the port takes
_KWARGS = ("coordinator_address", "num_processes", "process_id",
           "local_device_ids", "initialization_timeout")


def coordinator_configured(**kwargs) -> bool:
    """True when an explicit or environment coordinator config exists."""
    if kwargs.get("coordinator_address"):
        return True
    return any(os.environ.get(v) for v in _COORDINATOR_ENV_VARS)


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(**kwargs) -> None:
    """torch.distributed.init_process_group with explicit failure semantics.

    Takes jax.distributed.initialize's keyword names:
    coordinator_address "host:port" (tcp:// rendezvous; else
    COORDINATOR_ADDRESS, else torch's env:// from MASTER_ADDR and
    MASTER_PORT), num_processes and process_id (else WORLD_SIZE and RANK,
    or SLURM's and Open MPI's), initialization_timeout in seconds (300 by
    default), local_device_ids (the port's decoders take their device
    explicitly, so it is accepted and not read).

    - a process group exists already: nothing to do;
    - a coordinator is configured: join it, and raise on failure;
    - nothing configured: run standalone (one process)."""
    unknown = set(kwargs) - set(_KWARGS)
    if unknown:
        raise TypeError(f"initialize: unknown arguments {sorted(unknown)}")
    if dist.is_initialized():
        return
    if not coordinator_configured(**kwargs):
        return  # standalone by construction, not by accident
    addr = kwargs.get("coordinator_address") \
        or os.environ.get("COORDINATOR_ADDRESS")
    world = kwargs.get("num_processes")
    if world is None:
        world = _env_int("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
    rank = kwargs.get("process_id")
    if rank is None:
        rank = _env_int("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
    timeout = datetime.timedelta(
        seconds=kwargs.get("initialization_timeout") or 300)
    # raises on an unreachable coordinator, a missing rank or world size
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}" if addr else "env://",
        world_size=-1 if world is None else world,
        rank=-1 if rank is None else rank, timeout=timeout)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) standalone."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_list(items: list, index: int | None = None,
               count: int | None = None):
    """Deterministic round-robin shard of a work list for this process.

    Round-robin (not contiguous) so size-sorted datasets spread evenly."""
    idx, cnt = process_info()
    return items[(idx if index is None else index)::(
        cnt if count is None else count)]


def allreduce_metrics(metrics: dict[str, float]) -> dict[str, float]:
    """Sum scalar metrics across processes.

    An all_gather of float64, then a sum in rank order, as the JAX
    package's process_allgather(...).sum(axis=0): the float sums are the
    same, which a ring all-reduce's order would not promise."""
    world = process_info()[1]
    if world == 1:
        return dict(metrics)
    keys = sorted(metrics)
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float64)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    total = np.stack([p.numpy() for p in parts]).sum(axis=0)
    return {k: float(v) for k, v in zip(keys, total)}


def barrier() -> None:
    """Cross-process sync point (nothing to do standalone)."""
    if process_info()[1] > 1:
        dist.barrier()
