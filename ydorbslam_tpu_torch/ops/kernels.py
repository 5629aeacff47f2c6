"""Wrappers of the hand-written CUDA kernels (K1-K4) with launch counts.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream of the
tensor's device and raises if ``cudaGetLastError()`` is not 0.  The
kernels are built and loaded at the first launch (``_build.py``), never
at import.

``launch_counts()`` reports how many times each kernel was launched
since ``reset_launch_counts()``; a wrapper adds one exactly where it
launches.  The plain versions (``ops.fast``, ``ops.hamming``,
``optim.lm_kernel``) never touch the counts.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from .. import _build

_LAUNCHES: Dict[str, int] = {
    "fast_score_nms": 0, "proj_best2": 0, "pair_best2": 0, "lm_obs": 0,
}


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return _build.load()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
        s is not None and d != s for d, s in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


# K1: the number of levels one launch takes (the size of the kernel's
# level table, csrc/fast_nms.cu).
MAX_LEVELS = 16


def fast_score_nms_levels_cuda(levels: Sequence[torch.Tensor], border: int):
    """K1 on the card, all levels in one launch: a sequence of contiguous
    (H_l, W_l) float32 tensors on one CUDA device -> a tuple of (H_l, W_l)
    suppressed FAST scores, each bit-identical to
    ``nms_and_border(fast_score_map(level), border)``.  The outputs are
    contiguous views of one allocation."""
    levels = tuple(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_score_nms: 1 to {MAX_LEVELS} levels per launch, "
                         f"got {len(levels)}")
    dev = getattr(levels[0], "device", None)
    for i, t in enumerate(levels):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"fast_score_nms: level {i} is not a tensor")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"fast_score_nms: level {i} must be 2-D float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fast_score_nms: level {i} is not contiguous")
        if t.device != dev:
            raise ValueError(f"fast_score_nms: levels on different devices ({dev}, {t.device})")
    if dev.type != "cuda":
        raise ValueError(f"fast_score_nms: expected CUDA tensors, got {dev}")
    offsets = [0]
    for t in levels:
        offsets.append(offsets[-1] + t.numel())
    if offsets[-1] >= 2**31 or border < 0:
        raise ValueError(f"fast_score_nms: unsupported size {offsets[-1]} px / border {border}")
    out = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    # as_strided: a fraction of the host time of split + view.
    outs = tuple(out.as_strided(t.shape, (t.shape[1], 1), o) for t, o in zip(levels, offsets))
    table = [v for t, o in zip(levels, outs) if t.numel()
             for v in (t.data_ptr(), o.data_ptr(), *t.shape)]
    if not table:
        return outs
    err = _lib().ydorb_fast_score_nms(
        (ctypes.c_longlong * len(table))(*table), len(table) // 4, int(border), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    _LAUNCHES["fast_score_nms"] += 1
    _raise_on(err, "fast_score_nms")
    return outs


def fast_score_nms_cuda(image: torch.Tensor, border: int) -> torch.Tensor:
    """K1 on the card for one (H, W) float32 image: the one-level call of
    ``fast_score_nms_levels_cuda``."""
    return fast_score_nms_levels_cuda((image,), border)[0]


# The host's work per call is a large part of the kernels' wall time, so
# every wrapper checks its inputs in one pass and passes the device index
# and the raw current stream to C, which sets the device itself
# (csrc/device_guard.cuh), instead of entering a device context and
# building a stream object.


def _check_best2(kernel: str, desc_a: torch.Tensor, attr_a: torch.Tensor,
                 desc_b: torch.Tensor, attr_b: torch.Tensor,
                 a_shape: Tuple, b_shape: Tuple) -> None:
    """The inputs of K2 or K3: int32 descriptors and float32 attributes of
    ``a_shape`` and ``b_shape``, contiguous, on one CUDA device, and
    desc_a, attr_a and desc_b at 16-byte boundaries (each 32-byte row is
    copied as two 16-byte pieces)."""
    dev = desc_a.device
    for t, name, dtype, shape in ((desc_a, "desc_a", torch.int32, a_shape),
                                  (attr_a, "attr_a", torch.float32, a_shape),
                                  (desc_b, "desc_b", torch.int32, b_shape),
                                  (attr_b, "attr_b", torch.float32, b_shape)):
        if t.dtype != dtype or t.shape != shape or t.device != dev or not t.is_contiguous():
            _check(t, f"{kernel} {name}", dtype, shape)  # names what is wrong
            raise ValueError(f"{kernel}: inputs on different devices")
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: expected CUDA tensors, got {dev}")
    if desc_a.data_ptr() % 16 or attr_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError(f"{kernel}: descriptors and a-side attributes must start at a "
                         "16-byte boundary")


def proj_best2_cuda(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    check_ur: bool = False,
):
    """K2 on the card; same contract and results as
    ``ops.hamming.proj_best2_plain``."""
    M, N = desc_a.shape[0], desc_b.shape[0]
    _check_best2("proj_best2", desc_a, attr_a, desc_b, attr_b, (M, 8), (N, 8))
    if M >= 2**28 or N >= 2**28:
        raise ValueError(f"proj_best2: unsupported shape M={M}, N={N}")
    dev = desc_a.device
    out = torch.empty((6, M), dtype=torch.int32, device=dev)
    rows = out.unbind(0)
    if M == 0:
        return rows[:3], rows[3:]
    err = _lib().ydorb_proj_best2(
        desc_a.data_ptr(), attr_a.data_ptr(), desc_b.data_ptr(), attr_b.data_ptr(),
        M, N, int(bool(check_ur)), out.data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    _LAUNCHES["proj_best2"] += 1
    _raise_on(err, "proj_best2")
    return rows[:3], rows[3:]


def pair_best2_cuda(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    mode: str = "proj",
):
    """K3 on the card; same contract and results as
    ``ops.hamming.pair_best2_plain``: (idx, best, second), each (B, M)
    int32."""
    from .hamming import PAIR_MODES

    if mode not in PAIR_MODES:
        raise ValueError(f"pair_best2: mode must be one of {PAIR_MODES}, got {mode!r}")
    B, M, N = desc_a.shape[0], desc_a.shape[1], desc_b.shape[1]
    _check_best2("pair_best2", desc_a, attr_a, desc_b, attr_b, (B, M, 8), (B, N, 8))
    if B >= 65536 or M >= 2**28 or N >= 2**28:
        raise ValueError(f"pair_best2: unsupported shape B={B}, M={M}, N={N}")
    dev = desc_a.device
    out = torch.empty((3, B, M), dtype=torch.int32, device=dev)
    if B * M == 0:
        return out.unbind(0)
    err = _lib().ydorb_pair_best2(
        desc_a.data_ptr(), attr_a.data_ptr(), desc_b.data_ptr(), attr_b.data_ptr(),
        B, M, N, 1 if mode == "epi" else 0, out.data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    _LAUNCHES["pair_best2"] += 1
    _raise_on(err, "pair_best2")
    return out.unbind(0)


def lm_obs_cuda(inp: torch.Tensor):
    """K4 on the card; same contract as ``optim.lm_kernel.lm_obs_plain``:
    (32, O, P) float32 -> ((64, O, P), (16, P)), within rtol 2e-4,
    atol 2e-3."""
    from ..optim.lm_kernel import NIN, NOUT_P, NOUT_Q

    _check(inp, "lm_obs inp", torch.float32, (NIN, None, None))
    _, O, P = inp.shape
    if O * P * NOUT_Q >= 2**62:
        raise ValueError(f"lm_obs: unsupported shape O={O}, P={P}")
    dev = inp.device
    outq = torch.empty((NOUT_Q, O, P), dtype=torch.float32, device=dev)
    outp = torch.empty((NOUT_P, P), dtype=torch.float32, device=dev)
    if O * P == 0:
        return outq, outp.zero_()
    err = _lib().ydorb_lm_obs(
        inp.data_ptr(), O, P, outq.data_ptr(), outp.data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    _LAUNCHES["lm_obs"] += 1
    _raise_on(err, "lm_obs")
    return outq, outp
