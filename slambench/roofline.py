"""The least time an H100 could take for each kernel call of the port.

The peaks are ``chip_smoke.py``'s (``HBM_BYTES_S``, ``LANE_OPS_S``,
``POPC_S``: NVIDIA's data sheet for the H100 SXM at 700 W and the
compute capability 9.0 popcount rate), frozen here.  The counts are the
work that any implementation of the same semantics has to do on the
call's inputs, not the work the present kernels do: each input byte read
once, each output byte written once, and operations only where the
semantics need them.  A kernel's roofline share is the sum of these
least times over the sum of its measured times, so it cannot pass 100 %
unless the count is too high or the time misses part of the work.

- K1 (``fast_score_nms``): every level pixel read once as float32 and
  its suppressed score written once.  Any FAST-9 score forms the 16
  differences of a scored pixel and any 3x3 suppression compares an
  output with its 8 neighbours: ``K1_OPS_SCORED`` and ``K1_OPS_WINDOW``.
  The bytes bind.
- K2 (``proj_best2``) and K3 (``pair_best2``): the inputs and outputs
  once; a distance (8 XOR, 8 popcounts, 7 adds) only for the pairs inside
  the gate, and one compare per gated (pair, radius) to keep the best
  two.  The gate of a pair outside it is not charged, so a kernel that
  bins the points and skips such pairs still stays under its bound.
- K4 (``lm_obs``): bytes alone, as its operations are far from binding:
  every observation's ok flag read and its 60 output rows written (the
  dense output has them whether or not it is active); the other 26 input
  rows of an active observation; 13 output rows per point.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
LANE_OPS_S = 33.5e12  # fp32/int32 lane operations outside the tensor cores
POPC_S = 16 * 132 * 1.98e9  # __popc: 16 per SM per clock, 132 SMs, 1.98 GHz

K1_OPS_SCORED = 16
K1_OPS_WINDOW = 8
DIST_OPS = 15  # per 256-bit distance: 8 XOR and 7 adds, beside its 8 popcounts
DIST_POPC = 8
UPDATE_OPS = 1  # per gated (pair, radius): one compare against the current second
K4_IN_ROWS_ACTIVE = 26  # input rows an active observation needs beside its ok flag
K4_OUT_ROWS_OBS = 60  # 36 Hcc + 6 bc + 18 coupling rows
K4_OUT_ROWS_PT = 13  # 9 Hpp + 3 bp + 1 cost

KERNELS = {
    "K1": "fast_nms_levels_kernel",
    "K2": "proj_best2_kernel",
    "K3": "pair_best2_kernel",
    "K4": "lm_obs_kernel",
}


def least_seconds(nbytes: float, lane_ops: float = 0.0, popc: float = 0.0):
    """(seconds, what binds): the larger of the bytes over the bandwidth
    and the operations over their peak rate."""
    t = {"bytes": nbytes / HBM_BYTES_S,
         "operations": max(lane_ops / LANE_OPS_S, popc / POPC_S)}
    by = max(t, key=t.get)
    return t[by], by


def k1(shapes, border: int):
    """One K1 launch over levels of (H, W) ``shapes``."""
    px = scored = window = 0
    for H, W in shapes:
        px += H * W
        if H > 2 * border and W > 2 * border:
            window += (H - 2 * border) * (W - 2 * border)
            scored += (H - 2 * border + 2) * (W - 2 * border + 2)
    return least_seconds(px * 8, scored * K1_OPS_SCORED + window * K1_OPS_WINDOW)


def k2(in_bytes: int, out_bytes: int, gated: int, radius_hits: int):
    """One K2 launch: ``gated`` pairs inside either radius, ``radius_hits``
    gated (pair, radius) combinations."""
    return least_seconds(in_bytes + out_bytes, gated * DIST_OPS + radius_hits * UPDATE_OPS,
                         gated * DIST_POPC)


def k3(in_bytes: int, out_bytes: int, gated: int):
    """One K3 launch with ``gated`` pairs inside the gate."""
    return least_seconds(in_bytes + out_bytes, gated * (DIST_OPS + UPDATE_OPS), gated * DIST_POPC)


def k4(Q: int, active: int, P: int):
    """One K4 launch over Q = O * P observation slots, ``active`` of them on."""
    return least_seconds(4 * (Q * (1 + K4_OUT_ROWS_OBS) + active * K4_IN_ROWS_ACTIVE
                              + P * K4_OUT_ROWS_PT))


def share(ctx, kid: str):
    """Percent of the least time of kernel ``kid``'s launches in the traced
    window over their time on the card, or None where none ran."""
    name = KERNELS[kid]
    times = [d for n, _, d in getattr(ctx, "events", ()) if name in n]
    least = ctx.least.get(kid, []) if hasattr(ctx, "least") else []
    if not times or not least:
        return None
    if len(times) != len(least):
        import sys
        print(f"{kid}: {len(times)} launches traced, {len(least)} recorded", file=sys.stderr)
    return 100.0 * sum(least) / (sum(times) / 1e9)
