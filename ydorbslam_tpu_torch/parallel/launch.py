"""Spawn ranks on one host, each in a process group of its own world.

``spawn_ranks(fn, world, workdir)`` starts ``world`` processes with the
``spawn`` method; rank ``r`` joins the group through a file store in
``workdir`` (no port needed), calls ``fn(group, device, *args)`` with its
``ShardGroup`` and writes what ``fn`` returns (a dict of tensors) to
``workdir/rank{r}.pt``, which the parent reads back in rank order.  A
child that raises fails the call with its traceback; a world that does
not finish within ``timeout`` seconds is killed and fails it too.

``fn`` is pickled by its import path, and each child imports its module
afresh: keep rank bodies in modules that import only the port.  As with
any ``spawn`` start, each child also imports the parent's main script,
so a script that calls this keeps its work under
``if __name__ == "__main__":``.  On a ``cuda`` device rank ``r`` takes
card ``r`` modulo the visible cards, so two ranks on a one-card machine
share it (gloo; NCCL refuses two ranks on one card).
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from .multihost import ShardGroup


def _rank_main(rank, fn, world, workdir, backend, device, args, axis_name):
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "store"),
                            rank=rank, world_size=world)
    try:
        out = fn(ShardGroup(dist.group.WORLD, rank, world, axis_name), device, *args)
        torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in out.items()},
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, workdir: str, backend: str = "gloo", device: str = "cpu",
                args: tuple = (), axis_name: str = "pts", timeout: float = 600.0) -> list:
    """Run ``fn(group, device, *args)`` on ``world`` spawned ranks and
    return their results in rank order (see the module docstring)."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    for name in ["store"] + [f"rank{r}.pt" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    ctx = mp.start_processes(_rank_main, args=(fn, world, workdir, backend, device, args,
                                               axis_name),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(world)]
