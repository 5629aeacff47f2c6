"""Joining a multi-process run, and the group that sharded code reduces over.

Port of ``ydorbslam_tpu/parallel/multihost.py`` in PyTorch's idiom: where
a JAX process drives its host's chips inside one SPMD program, a PyTorch
rank drives one device.  Every rank runs the whole system, replicated,
on the same frames; only the pieces the JAX package shards split their
work (``parallel/ba_sharded.py``, ``parallel/retrieval_sharded.py``):
each rank takes its contiguous block ``[r * n_local, (r + 1) * n_local)``
of the sharded axis, ``all_reduce`` stands where JAX calls
``jax.lax.psum``, and ``all_gather`` where JAX gathers or returns a
sharded output that a replicated caller reads whole.  The collectives
use their list forms, so one code path runs on NCCL, on gloo with CPU
tensors and on gloo with CUDA tensors.

Environment contract (one variable set => all three required):
  YDORBSLAM_COORDINATOR   host:port of rank 0
  YDORBSLAM_NUM_PROCESSES world size (one rank per GPU)
  YDORBSLAM_PROCESS_ID    this rank
``YDORBSLAM_AUTO_DISTRIBUTED=1`` instead takes the ``env://`` contract
that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``).  The explicit variables win.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class ShardGroup(NamedTuple):
    """The ranks a sharded axis is split over (the JAX package's 1-D
    ``Mesh``): the process group, this rank in it, its size and the
    axis's name."""

    group: Any
    rank: int
    size: int
    axis_name: str


def distributed_env() -> Optional[dict]:
    """The explicit coordinator spec from the environment, or None.
    Raises KeyError when the coordinator is set without the other two."""
    coord = os.environ.get("YDORBSLAM_COORDINATOR")
    if not coord:
        return None
    return dict(
        coordinator_address=coord,
        num_processes=int(os.environ["YDORBSLAM_NUM_PROCESSES"]),
        process_id=int(os.environ["YDORBSLAM_PROCESS_ID"]),
    )


def environment_error() -> Optional[str]:
    """What is missing from a multi-process environment that asks to
    join, or None when it is complete or asks nothing."""
    if os.environ.get("YDORBSLAM_COORDINATOR"):
        missing = [k for k in ("YDORBSLAM_NUM_PROCESSES", "YDORBSLAM_PROCESS_ID")
                   if not os.environ.get(k)]
        if missing:
            return f"YDORBSLAM_COORDINATOR is set without {', '.join(missing)}"
    elif os.environ.get("YDORBSLAM_AUTO_DISTRIBUTED") == "1":
        missing = [k for k in TORCHRUN_VARS if not os.environ.get(k)]
        if missing:
            return (f"YDORBSLAM_AUTO_DISTRIBUTED=1 needs torchrun's environment; "
                    f"{', '.join(missing)} not set")
    return None


def initialize_distributed(device="cuda") -> bool:
    """Join the multi-process run if the environment asks for one.

    Returns True when this process is in a process group (after this
    call, ``device_mesh`` sees the world), False with no environment,
    where it touches nothing.  Safe to call more than once.  The backend
    is NCCL for a CUDA ``device`` and gloo for the CPU; on CUDA the rank
    takes its local GPU (``LOCAL_RANK``, else its rank modulo the visible
    cards) before the group is made."""
    if dist.is_initialized():
        return True
    spec = distributed_env()
    auto = os.environ.get("YDORBSLAM_AUTO_DISTRIBUTED") == "1"
    if spec is None and not auto:
        return False
    if spec is not None:
        rank, world = spec["process_id"], spec["num_processes"]
        kwargs = dict(init_method=f"tcp://{spec['coordinator_address']}",
                      world_size=world, rank=rank)
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        kwargs = dict(init_method="env://")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo", **kwargs)
    return True


def device_mesh(axis_name: str, length_divisor: Optional[int] = None) -> Optional[ShardGroup]:
    """The whole world as a ``ShardGroup`` over axis ``axis_name``, or
    None: with no process group or one rank (the JAX package returns
    None for one device), and when ``length_divisor`` is given and the
    world size does not divide it (the JAX package's multi-process rule:
    only the full world keeps every rank in the collective).  The JAX
    package's single-process trimming to a divisor has no counterpart:
    a PyTorch process drives one device."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if world <= 1 or (length_divisor is not None and length_divisor % world):
        return None
    return ShardGroup(dist.group.WORLD, dist.get_rank(), world, axis_name)


def process_info() -> dict:
    """Which slice of the world this process drives (one device a rank)."""
    init = dist.is_initialized()
    world = dist.get_world_size() if init else 1
    return dict(
        process_index=dist.get_rank() if init else 0,
        process_count=world,
        local_devices=1,
        global_devices=world,
    )


def is_writer() -> bool:
    """Whether this process writes a run's files: rank 0, or the only
    process.  Every rank tracks the same frames to the same result."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_rows(x: torch.Tensor, g: ShardGroup) -> torch.Tensor:
    """This rank's contiguous block of the rows of ``x``."""
    n = x.shape[0]
    if n % g.size:
        raise ValueError(f"{n} rows do not split over {g.size} ranks")
    k = n // g.size
    return x[g.rank * k:(g.rank + 1) * k]


def all_reduce(t: torch.Tensor, g: Optional[ShardGroup]) -> torch.Tensor:
    """``t`` summed over the group's ranks (``jax.lax.psum``); ``t``
    itself when ``g`` is None."""
    if g is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=g.group)
    return t


def all_gather_rows(t: torch.Tensor, g: ShardGroup) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(g.size)]
    dist.all_gather(parts, t, group=g.group)
    return torch.cat(parts, 0)


def broadcast_flag(flag: bool, g: ShardGroup, device) -> bool:
    """Rank 0's ``flag`` on every rank: a host decision all ranks act on."""
    t = torch.full((1,), int(bool(flag)), dtype=torch.int32, device=device)
    dist.broadcast(t, src=dist.get_global_rank(g.group, 0), group=g.group)
    return bool(t.item())
