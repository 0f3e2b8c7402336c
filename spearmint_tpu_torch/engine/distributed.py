"""Process-group bootstrap and the helpers the choosers route by.

JAX counterpart: ``spearmint_tpu/engine/distributed.py``.  There every
host runs the same jitted program over one global device mesh; here every
rank is one process, joined by ``torch.distributed``.  The contract is the
same: every rank runs the same suggestion on the same inputs and the same
seed, the collectives keep their numbers equal bit for bit, so every rank
computes the identical suggested point and no leader broadcast is needed.
The experiment store stays on the shared filesystem, written by the
coordinator only (the choosers check ``is_coordinator``).

Multi-GPU wiring (one GPU per rank, NCCL), under ``torchrun``::

    from spearmint_tpu_torch.engine import distributed, obs_shard
    distributed.initialize(backend="nccl")   # env:// as torchrun sets it
    mesh = obs_shard.make_obs_mesh()          # every rank of the group
    step = obs_shard.sharded_suggest_obs(mesh, config)

Ranks that share one card, or run on the CPU, pass ``backend="gloo"``.
The backend is always the caller's choice.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# A rank that diverges (a collective the others never make) fails after
# this long instead of hanging.
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = "nccl",
               timeout: datetime.timedelta = TIMEOUT) -> None:
    """``torch.distributed.init_process_group`` for the port.

    With every argument left as None it is env-driven (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as ``torchrun`` sets
    them), as the JAX function is.  ``coordinator_address`` is an init
    method (``tcp://host:port`` or ``file:///path``).  With NCCL each rank
    takes the GPU ``LOCAL_RANK`` names (``torchrun`` sets it)."""
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend, init_method=coordinator_address or "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=timeout)


def world_size() -> int:
    """Ranks of the default group; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Rank 0 of the default group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
