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

import functools
from typing import Dict, Tuple

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
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
        s is not None and d != s for d, s in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


def fast_score_nms_cuda(image: torch.Tensor, border: int) -> torch.Tensor:
    """K1 on the card: (H, W) float32 -> (H, W) float32 suppressed FAST
    scores, bit-identical to ``nms_and_border(fast_score_map(image))``."""
    _check(image, "fast_score_nms", torch.float32, (None, None))
    H, W = image.shape
    if H * W >= 2**31 or border < 0:
        raise ValueError(f"fast_score_nms: unsupported shape {H}x{W} / border {border}")
    out = torch.empty_like(image)
    if H * W == 0:
        return out
    lib = _lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.ydorb_fast_score_nms(
            image.data_ptr(), out.data_ptr(), H, W, int(border), stream
        )
        _LAUNCHES["fast_score_nms"] += 1
    _raise_on(err, "fast_score_nms")
    return out


def proj_best2_cuda(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    check_ur: bool = False,
):
    """K2 on the card; same contract and results as
    ``ops.hamming.proj_best2_plain``."""
    M, N = desc_a.shape[0], desc_b.shape[0]
    _check(desc_a, "proj_best2 desc_a", torch.int32, (M, 8))
    _check(attr_a, "proj_best2 attr_a", torch.float32, (M, 8))
    _check(desc_b, "proj_best2 desc_b", torch.int32, (N, 8))
    _check(attr_b, "proj_best2 attr_b", torch.float32, (N, 8))
    dev = desc_a.device
    if any(t.device != dev for t in (attr_a, desc_b, attr_b)):
        raise ValueError("proj_best2: inputs on different devices")
    if M >= 2**28 or N >= 2**28:
        raise ValueError(f"proj_best2: unsupported shape M={M}, N={N}")
    out = torch.empty((6, M), dtype=torch.int32, device=dev)
    if M == 0:
        return (out[0], out[1], out[2]), (out[3], out[4], out[5])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ydorb_proj_best2(
            desc_a.data_ptr(), attr_a.data_ptr(), desc_b.data_ptr(),
            attr_b.data_ptr(), M, N, int(bool(check_ur)), out.data_ptr(), stream,
        )
        _LAUNCHES["proj_best2"] += 1
    _raise_on(err, "proj_best2")
    return (out[0], out[1], out[2]), (out[3], out[4], out[5])


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
    _check(desc_a, "pair_best2 desc_a", torch.int32, (B, M, 8))
    _check(attr_a, "pair_best2 attr_a", torch.float32, (B, M, 8))
    _check(desc_b, "pair_best2 desc_b", torch.int32, (B, N, 8))
    _check(attr_b, "pair_best2 attr_b", torch.float32, (B, N, 8))
    dev = desc_a.device
    if any(t.device != dev for t in (attr_a, desc_b, attr_b)):
        raise ValueError("pair_best2: inputs on different devices")
    if B >= 65536 or M >= 2**28 or N >= 2**28:
        raise ValueError(f"pair_best2: unsupported shape B={B}, M={M}, N={N}")
    out = torch.empty((3, B, M), dtype=torch.int32, device=dev)
    if B * M == 0:
        return out[0], out[1], out[2]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ydorb_pair_best2(
            desc_a.data_ptr(), attr_a.data_ptr(), desc_b.data_ptr(),
            attr_b.data_ptr(), B, M, N, 1 if mode == "epi" else 0,
            out.data_ptr(), stream,
        )
        _LAUNCHES["pair_best2"] += 1
    _raise_on(err, "pair_best2")
    return out[0], out[1], out[2]


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
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ydorb_lm_obs(
            inp.data_ptr(), O, P, outq.data_ptr(), outp.data_ptr(), stream
        )
        _LAUNCHES["lm_obs"] += 1
    _raise_on(err, "lm_obs")
    return outq, outp
