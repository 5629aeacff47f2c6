"""Scatters with JAX's ``.at[...]`` semantics, deterministic on every device.

``x.at[idx].set(v, mode="drop")`` in the JAX package does two things
that ``torch.index_put_`` does not:

* an out-of-range index is dropped (torch raises on the CPU and hits a
  device-side assert on CUDA, which kills the context);
* among duplicate indices the update with the highest position wins:
  XLA on the CPU applies the updates in order.  ``index_put_`` leaves
  that order undefined, and on CUDA it is arbitrary.

``scatter_set`` keeps the last update per target (the highest position,
found with one ``scatter_reduce("amax")``) and routes every other update
and every out-of-range one to a spare row that is sliced off, so each
real row is written exactly once and no host synchronisation is needed.
Negative indices count from the end, as in JAX.  The reductions
(``scatter_add``, ``scatter_min``, ``scatter_max``) are order-free for
the integer and boolean tensors the map uses and drop out-of-range
updates the same way.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Index = Union[torch.Tensor, int, Sequence[Union[torch.Tensor, int]]]


def _flat_index(shape: torch.Size, index, device) -> Tuple[torch.Tensor, torch.Tensor, int, Tuple[int, ...]]:
    """Row-major flat index into the leading ``len(index)`` dims, with a
    validity mask.  Returns (flat (n,), ok (n,), n_rows, index shape)."""
    if not isinstance(index, (tuple, list)):
        index = (index,)
    idx = [
        i.to(device=device, dtype=torch.int64) if isinstance(i, torch.Tensor)
        else torch.full((), i, dtype=torch.int64, device=device)
        for i in index
    ]
    idx = torch.broadcast_tensors(*idx)
    ishape = tuple(idx[0].shape)
    flat = torch.zeros(ishape, dtype=torch.int64, device=device)
    ok = torch.ones(ishape, dtype=torch.bool, device=device)
    rows = 1
    for d, i in zip(shape[: len(idx)], idx):
        i = torch.where(i < 0, i + d, i)
        ok = ok & (i >= 0) & (i < d)
        flat = flat * d + torch.clamp(i, 0, max(d - 1, 0))
        rows *= d
    return flat.reshape(-1), ok.reshape(-1), rows, ishape


def _updates(dst: torch.Tensor, values, ishape, k: int, n: int) -> torch.Tensor:
    rest = tuple(dst.shape[k:])
    if isinstance(values, torch.Tensor):
        v = values.to(device=dst.device, dtype=dst.dtype)
    else:  # a Python scalar: a fill, not a host-to-device copy
        v = torch.full((), values, dtype=dst.dtype, device=dst.device)
    return v.expand(ishape + rest).reshape((n,) + rest)


def scatter_set(dst: torch.Tensor, index: Index, values) -> torch.Tensor:
    """``dst.at[index].set(values, mode="drop")`` with the last update
    winning among duplicates.  ``index`` is one index tensor or a tuple
    of broadcastable index tensors for the leading dims; ``values``
    broadcasts to the index shape plus the remaining dims of ``dst``.
    Returns a new tensor."""
    k = 1 if not isinstance(index, (tuple, list)) else len(index)
    flat, ok, rows, ishape = _flat_index(dst.shape, index, dst.device)
    n = flat.numel()
    upd = _updates(dst, values, ishape, k, n)
    pos = torch.arange(n, dtype=torch.int64, device=dst.device)
    tgt = torch.where(ok, flat, rows)
    last = torch.full((rows + 1,), -1, dtype=torch.int64, device=dst.device)
    last = last.scatter_reduce(0, tgt, pos, reduce="amax")
    win = ok & (last[tgt] == pos)
    out = torch.cat(
        [dst.reshape((rows,) + tuple(dst.shape[k:])),
         dst.new_zeros((1,) + tuple(dst.shape[k:]))]
    )
    out.index_copy_(0, torch.where(win, flat, rows), upd)
    return out[:rows].reshape(dst.shape)


def _scatter_reduce(dst: torch.Tensor, index: Index, values, reduce: str) -> torch.Tensor:
    k = 1 if not isinstance(index, (tuple, list)) else len(index)
    flat, ok, rows, ishape = _flat_index(dst.shape, index, dst.device)
    n = flat.numel()
    rest = tuple(dst.shape[k:])
    work = dst.to(torch.int32) if dst.dtype == torch.bool else dst
    upd = _updates(work, values, ishape, k, n)
    out = torch.cat([work.reshape((rows,) + rest), work.new_zeros((1,) + rest)])
    tgt = torch.where(ok, flat, rows)
    if reduce == "sum":
        out.index_add_(0, tgt, upd)
    else:
        tgt = tgt.reshape((n,) + (1,) * len(rest)).expand((n,) + rest)
        out = out.scatter_reduce(0, tgt, upd, reduce=reduce)
    return out[:rows].reshape(dst.shape).to(dst.dtype)


def scatter_add(dst: torch.Tensor, index: Index, values) -> torch.Tensor:
    """``dst.at[index].add(values, mode="drop")``."""
    return _scatter_reduce(dst, index, values, "sum")


def scatter_min(dst: torch.Tensor, index: Index, values) -> torch.Tensor:
    """``dst.at[index].min(values, mode="drop")``."""
    return _scatter_reduce(dst, index, values, "amin")


def scatter_max(dst: torch.Tensor, index: Index, values) -> torch.Tensor:
    """``dst.at[index].max(values, mode="drop")`` (bool: logical or)."""
    return _scatter_reduce(dst, index, values, "amax")
