# Frozen copy of ydorbslam_tpu_torch/ops/hamming.py, taken when the benchmark was
# written, for the benchmark's plain reference; imports nothing of the port.
# Changed: the CUDA dispatch removed: the plain versions run on every device.
"""Packed-descriptor Hamming distances, the match primitives (best and
second, the ratio test, the rotation histogram), and the gated
best/second searches K2 and K3 with their dispatchers.

Port of ``ydorbslam_tpu/ops/hamming.py`` plus the contracts of
``ydorbslam_tpu/ops/pallas_kernels.py::proj_best2_pallas`` (K2) and
``pair_best2_pallas`` (K3).

PyTorch has no popcount operator.  The dense plain distances
(``distance_matrix``, behind K2's and K3's plain versions) XOR the int32
words one at a time and count bits with the SWAR sequence in int32
(``popcount32_i32``), exact for every 32-bit pattern.  On the CPU, where
every parity check and test runs these searches, they go in blocks of
rows of about 2^18 pairs, so that the sequence's temporaries stay in
cache: 4-10x faster than whole-matrix passes at the KITTI-00 shapes on
an 8-core x86 CPU.

``proj_best2`` is K2: for every a-row, the best and second-best gated
Hamming distance and the best column, for a narrow and a wide radius,
from one pass.  A CUDA tensor launches the CUDA kernel
(``csrc/proj_best2.cu``); a CPU tensor takes ``proj_best2_plain``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .select import stable_topk

INVALID_DIST = 10_000  # sentinel > any Hamming distance (max 256)
_CPU_BLOCK = 1 << 18  # pairs per block of a dense distance on the CPU

# a_attr lanes: [u, v, ur_pred, rad_narrow, rad_wide, oct_lo, oct_hi, valid]
A_U, A_V, A_UR, A_RN, A_RW, A_OLO, A_OHI, A_VALID = range(8)
# b_attr lanes: [u, v, right_u, octave, valid, 0, 0, 0]
B_U, B_V, B_UR, B_OCT, B_VALID = range(5)
# K3 "proj" b-lane 5: 1/scale_factor^(2*octave), the fuse chi2 weight.
B_ISF2 = 5
# K3 "epi" a-lanes: epipolar line (a, b, c), 3.84*(a^2+b^2), octave, valid;
# b-lane 2 carries sigma^2(octave_b) in that mode.
E_LA, E_LB, E_LC, E_THR, E_OCT, E_VALID = range(6)
B_SIG2 = B_UR
PAIR_MODES = ("proj", "epi")

Best2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each 32-bit word (int32 or int64 input) -> int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance between (..., 8) int32-word
    descriptors -> (...) int32."""
    return torch.sum(popcount32(torch.bitwise_xor(a, b)), dim=-1).to(torch.int32)


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., M, 8) x (..., N, 8) int32 words -> (..., M, N) int32 Hamming
    distances (the leading dims broadcast), one word at a time.  On the
    CPU in blocks of rows of about ``_CPU_BLOCK`` pairs, elsewhere in one
    block."""
    M, N = desc_a.shape[-2], desc_b.shape[-2]
    lead = torch.broadcast_shapes(desc_a.shape[:-2], desc_b.shape[:-2])
    out = torch.empty(lead + (M, N), dtype=torch.int32, device=desc_a.device)
    rows = M
    if desc_a.device.type == "cpu":
        rows = max(1, _CPU_BLOCK // max(1, N * math.prod(lead)))
    b = desc_b[..., None, :, :]
    for r in range(0, M, rows):
        a = desc_a[..., r : r + rows, None, :]
        d = out[..., r : r + rows, :]
        d.zero_()
        for w in range(desc_a.shape[-1]):
            d += popcount32_i32(torch.bitwise_xor(a[..., w], b[..., w]))
    return out


def masked_distance_matrix(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    pair_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``distance_matrix`` with invalid rows, columns and pairs set to
    INVALID_DIST."""
    d = distance_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    return torch.where(mask, d, INVALID_DIST)


def best_and_second(d: torch.Tensor) -> Best2:
    """Per-row best and second-best of an (M, N) distance matrix, N >= 2:
    (best_idx (M,) int32, best (M,), second (M,)).  The lowest column
    wins a tie and a tied duplicate of the best is the second, as
    ``jax.lax.top_k`` orders them."""
    vals, idx = stable_topk(-d, 2)
    return idx[:, 0].to(torch.int32), -vals[:, 0], -vals[:, 1]


def ratio_test_matches(
    d: torch.Tensor, max_dist: int, ratio: float | None = None, mutual: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matches from an (M, N) distance matrix: (match_idx (M,) int32, -1
    for no match; best_dist (M,)).  A match needs best <= ``max_dist``;
    ``ratio`` also needs best < ratio * second, and ``mutual`` that the
    row is its column's best (the first minimum of the column)."""
    bi, b1, b2 = best_and_second(d)
    ok = b1 <= max_dist
    if ratio is not None:
        ok = ok & (b1.to(torch.float32) < ratio * b2.to(torch.float32))
    if mutual:
        col_best = torch.argmin(d, dim=0)  # (N,)
        ok = ok & (col_best[bi.to(torch.int64)] == torch.arange(d.shape[0], device=d.device))
    return torch.where(ok, bi, -1), b1


def proj_gates(
    attr_a: torch.Tensor, attr_b: torch.Tensor, check_ur: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, N) bool gates of K2 for the narrow and the wide radius: both
    valid, octave_b in [oct_lo, oct_hi], |du| <= r and |dv| <= r, and
    with ``check_ur`` also |dur| <= r unless right_u_b < 0."""
    a = attr_a.T[:, :, None]  # a[lane] is (M, 1)
    b = attr_b.T[:, None, :]  # b[lane] is (1, N)
    du = torch.abs(b[B_U] - a[A_U])
    dv = torch.abs(b[B_V] - a[A_V])
    base = (
        (a[A_VALID] > 0.5) & (b[B_VALID] > 0.5)
        & (b[B_OCT] >= a[A_OLO]) & (b[B_OCT] <= a[A_OHI])
    )
    out = []
    for r in (a[A_RN], a[A_RW]):
        win = base & (du <= r) & (dv <= r)
        if check_ur:
            dur = torch.abs(b[B_UR] - a[A_UR])
            win = win & ((b[B_UR] < 0) | (dur <= r))
        out.append(win)
    return out[0], out[1]


def proj_best2_plain(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    check_ur: bool = False,
) -> Tuple[Best2, Best2]:
    """Plain K2 over the gates of ``proj_gates``.  Returns
    ((idx_n, best_n, second_n), (idx_w, best_w, second_w)), each (M,)
    int32.  The lowest column wins a tie, a tied duplicate of the best
    counts as second, the sentinels are 10000 and idx is -1 where no
    column passes (the TPU kernel's rule)."""
    d = distance_matrix(desc_a, desc_b)
    out = []
    for win in proj_gates(attr_a, attr_b, check_ur):
        dg = torch.where(win, d, INVALID_DIST)
        best, idx = torch.min(dg, dim=1)
        rest = dg.scatter(1, idx[:, None], INVALID_DIST)
        second = torch.amin(rest, dim=1)
        idx = torch.where(best < INVALID_DIST, idx, -1)
        out.append((idx.to(torch.int32), best, second))
    return out[0], out[1]


def proj_best2(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    check_ur: bool = False,
) -> Tuple[Best2, Best2]:
    """K2's contract: ``proj_best2_plain`` on any device."""
    return proj_best2_plain(desc_a, attr_a, desc_b, attr_b, check_ur)


def popcount32_i32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word, in int32 (no widening, so a
    (B, M, N) distance stays at 4 bytes per pair).  The shifts are
    arithmetic, and every mask clears the sign-extended bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def pair_gates(attr_a: torch.Tensor, attr_b: torch.Tensor, mode: str) -> torch.Tensor:
    """(B, M, N) bool gate of K3 from the (B, M, 8) and (B, N, 8)
    attribute packs.  The arithmetic is the TPU kernel's
    (pallas_kernels._pair_best2_kernel) in its order, one rounding per
    operation, so the CUDA kernel reproduces it bit for bit."""
    if mode not in PAIR_MODES:
        raise ValueError(f"pair_best2: mode must be one of {PAIR_MODES}, got {mode!r}")
    a = attr_a.permute(2, 0, 1)[:, :, :, None]  # a[lane] is (B, M, 1)
    b = attr_b.permute(2, 0, 1)[:, :, None, :]  # b[lane] is (B, 1, N)
    if mode == "proj":
        du = b[B_U] - a[A_U]
        dv = b[B_V] - a[A_V]
        dur = b[B_UR] - a[A_UR]
        mono2 = du * du + dv * dv
        chi2_ok = torch.where(
            b[B_UR] >= 0.0,
            (mono2 + dur * dur) * b[B_ISF2] <= 7.81,
            mono2 * b[B_ISF2] <= 5.99,
        )
        rad = a[A_RN]
        return (
            (a[A_VALID] > 0.5) & (b[B_VALID] > 0.5)
            & (b[B_OCT] >= a[A_OLO]) & (b[B_OCT] <= a[A_OHI])
            & (torch.abs(du) <= rad) & (torch.abs(dv) <= rad)
            & chi2_ok
        )
    num = a[E_LA] * b[B_U] + a[E_LB] * b[B_V] + a[E_LC]
    return (
        (a[E_VALID] > 0.5) & (b[B_VALID] > 0.5)
        & (torch.abs(b[B_OCT] - a[E_OCT]) <= 1.0)
        & (num * num < a[E_THR] * b[B_SIG2])
    )


def pair_best2_plain(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    mode: str = "proj",
) -> Best2:
    """Plain K3: the dense (B, M, N) masked distance and a stable
    two-smallest per a-row.  desc (B, M|N, 8) int32, attr (B, M|N, 8)
    float32 (lanes above).  Returns (idx, best, second), each (B, M)
    int32, with K2's tie rule and sentinels (10000, idx -1)."""
    gate = pair_gates(attr_a, attr_b, mode)
    dg = torch.where(gate, distance_matrix(desc_a, desc_b), INVALID_DIST)
    best, idx = torch.min(dg, dim=2)
    second = torch.amin(dg.scatter(2, idx[..., None], INVALID_DIST), dim=2)
    idx = torch.where(best < INVALID_DIST, idx, -1)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


def pair_best2(
    desc_a: torch.Tensor, attr_a: torch.Tensor,
    desc_b: torch.Tensor, attr_b: torch.Tensor,
    mode: str = "proj",
) -> Best2:
    """K3's contract: ``pair_best2_plain`` on any device."""
    return pair_best2_plain(desc_a, attr_a, desc_b, attr_b, mode)


def rotation_histogram_mask(
    angle_a: torch.Tensor,
    angle_b_matched: torch.Tensor,
    matched: torch.Tensor,
    n_bins: int = 30,
    keep_top: int = 3,
) -> torch.Tensor:
    """Rotation-consistency filter: keep matches whose angle difference
    falls in the ``keep_top`` most popular of ``n_bins`` bins, dropping
    bins below 10% of the best (the reference's computeThreeMaxima).
    Ties between bins go to the lower bin, as ``jax.lax.top_k``."""
    dev = angle_a.device
    two_pi = torch.full((), 2.0 * torch.pi, dtype=torch.float32, device=dev)
    diff = torch.remainder(angle_a - angle_b_matched, two_pi)  # [0, 2pi)
    bins = torch.clamp((diff * n_bins / two_pi).to(torch.int32), 0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int32, device=dev).index_add_(
        0, bins, matched.to(torch.int32)
    )
    top_counts, top_bins = stable_topk(counts, keep_top)
    keep = top_counts.to(torch.float32) > 0.1 * top_counts[0].to(torch.float32)
    keep[0] = top_counts[0] > 0
    in_top = torch.any((bins[:, None] == top_bins[None, :]) & keep[None, :], dim=-1)
    return matched & in_top


def filter_matches_by_rotation(
    match_idx: torch.Tensor,
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    n_bins: int = 30,
    keep_top: int = 3,
) -> torch.Tensor:
    """``rotation_histogram_mask`` applied to an (M,) match-index vector:
    the matches outside the kept bins become -1."""
    matched = match_idx >= 0
    ang_b = angle_b[torch.clamp(match_idx.to(torch.int64), 0, angle_b.shape[0] - 1)]
    keep = rotation_histogram_mask(angle_a, ang_b, matched, n_bins, keep_top)
    return torch.where(keep, match_idx, -1)
