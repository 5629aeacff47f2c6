"""Problem generators and CUDA timers shared by the checks of the kernels.

``proj_problem`` and ``pair_problem`` make seeded K2 and K3 inputs as
numpy arrays (random, tie-heavy, none or exactly one column passing),
which ``tests/test_torch_best2_merge.py`` feeds to the plain versions on
the CPU and ``chip_smoke.py`` and ``tools/time_kernels.py`` to the
kernels on the card; ``lm_obs_problem`` makes a seeded K4 input for the
last two.  ``wall_ms`` and ``device_ms`` time a call on the card with
and without the host's dispatch.

This module imports only numpy and torch, nothing else of the package,
so ``tools/time_kernels.py`` can load it by path beside another
checkout's package.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def proj_problem(rng, M, N, kind="random"):
    """A K2 problem as numpy arrays: desc_a (M, 8) int32, attr_a (M, 8)
    float32, desc_b (N, 8) int32, attr_b (N, 8) float32, with the lanes
    of ``ops/hamming.py``.  ``kind``:
      "random": a-rows projected near a b keypoint (6 px noise), radii
                4-10 / 8-20 px, octave ranges, 90 % valid, 70 % right-x;
      "ties":   descriptors from a pool of 4 and a 300 px / open window,
                so most gated columns tie;
      "none":   no pair passes (every b octave is above every range);
      "one":    one b column is valid and every gate is open, so each
                valid a-row has exactly one candidate."""
    if kind == "random":
        uv_b = rng.uniform([8, 8], [632, 472], (N, 2))
        tgt = rng.integers(0, N, M)
        uv_a = uv_b[tgt] + rng.normal(0, 6, (M, 2))
        desc_b = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        desc_a = desc_b[tgt] ^ (rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
                                & rng.integers(0, 2**32, (M, 8), dtype=np.uint32))
        ra = rng.uniform(4, 10, M)
        aa = np.stack([uv_a[:, 0], uv_a[:, 1], uv_a[:, 0] - rng.uniform(1, 30, M), ra,
                       2 * ra, rng.integers(-1, 3, M), rng.integers(4, 9, M),
                       rng.random(M) < 0.9], -1)
        ab = np.stack([uv_b[:, 0], uv_b[:, 1],
                       np.where(rng.random(N) < 0.7, uv_b[:, 0] - rng.uniform(1, 30, N), -1),
                       rng.integers(0, 8, N), rng.random(N) < 0.9,
                       np.zeros(N), np.zeros(N), np.zeros(N)], -1)
    else:
        pool = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
        desc_a, desc_b = pool[rng.integers(0, 4, M)], pool[rng.integers(0, 4, N)]
        uv_a, uv_b = rng.uniform(0, 640, (M, 2)), rng.uniform(0, 640, (N, 2))
        za, zb = np.zeros(M), np.zeros(N)
        b_oct = rng.integers(0, 8, N) if kind != "none" else np.full(N, 8)
        b_valid = rng.random(N) < 0.9
        if kind == "one":
            b_valid = np.zeros(N, bool)
            b_valid[rng.integers(0, N)] = True
        aa = np.stack([uv_a[:, 0], uv_a[:, 1], uv_a[:, 0] - 10,
                       za + (300 if kind == "ties" else 1e4), za + 1e4, za, za + 7,
                       rng.random(M) < 0.9], -1)
        ab = np.stack([uv_b[:, 0], uv_b[:, 1],
                       np.where(rng.random(N) < 0.5, uv_b[:, 0] - 10, -1), b_oct, b_valid,
                       zb, zb, zb], -1)
    return desc_a.view(np.int32), aa.astype(np.float32), desc_b.view(np.int32), \
        ab.astype(np.float32)


def pair_problem(rng, B, M, N, mode, kind="random"):
    """A K3 problem as numpy arrays (desc_a, attr_a (B, M, 8), desc_b,
    attr_b (B, N, 8)) with the lanes of ``ops/hamming.py``.  ``kind`` as
    in ``proj_problem``: "random" has near-duplicate descriptors and
    gates that pass and fail; "ties" draws descriptors from a pool of 4
    behind wide gates; "none" fails every octave gate; "one" leaves one
    valid b column per pair behind open gates."""
    if kind == "random":
        da = rng.integers(0, 2**32, (B, M, 8), dtype=np.uint64).astype(np.uint32)
        noise = np.bitwise_and.reduce(
            rng.integers(0, 2**32, (3, B, N, 8), dtype=np.uint64).astype(np.uint32), axis=0)
        db = np.take_along_axis(da, rng.integers(0, M, (B, N, 1)), 1) ^ noise
        z, zb = np.zeros((B, M)), np.zeros((B, N))
        ub, vb = rng.uniform(0, 640, (B, N)), rng.uniform(0, 480, (B, N))
        if mode == "proj":
            # Projections near a b keypoint, with a right-x consistent with
            # its disparity, so the window and chi2 gates pass and fail.
            src = rng.integers(0, N, (B, M))
            disp = rng.uniform(1, 30, (B, N))
            ua = np.take_along_axis(ub, src, 1) + rng.normal(0, 1.5, (B, M))
            va = np.take_along_axis(vb, src, 1) + rng.normal(0, 1.5, (B, M))
            ura = ua - np.take_along_axis(disp, src, 1) + rng.normal(0, 1.0, (B, M))
            boct = rng.integers(0, 5, (B, N))
            lo = np.take_along_axis(boct, src, 1) - rng.integers(0, 2, (B, M))
            aa = np.stack([ua, va, ura, rng.uniform(3, 12, (B, M)), z, lo, lo + 1,
                           rng.random((B, M)) < 0.9], -1)
            ab = np.stack([ub, vb, np.where(rng.random((B, N)) < 0.7, ub - disp, -1), boct,
                           rng.random((B, N)) < 0.9, 1.0 / 1.44 ** boct, zb, zb], -1)
        else:
            la, lb = rng.normal(0, 1, (B, M)), rng.normal(0, 1, (B, M))
            boct = rng.integers(0, 5, (B, N))
            aa = np.stack([la, lb, rng.normal(0, 300, (B, M)),
                           3.84 * np.maximum(la * la + lb * lb, 1e-18),
                           rng.integers(0, 5, (B, M)), rng.random((B, M)) < 0.9, z, z], -1)
            ab = np.stack([ub, vb, 1.44 ** boct * 100.0, boct, rng.random((B, N)) < 0.9,
                           zb, zb, zb], -1)
        return da.view(np.int32), aa.astype(np.float32), db.view(np.int32), \
            ab.astype(np.float32)
    pool = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
    da, db = pool[rng.integers(0, 4, (B, M))], pool[rng.integers(0, 4, (B, N))]
    z, zb = np.zeros((B, M)), np.zeros((B, N))
    a_valid = rng.random((B, M)) < 0.9
    b_valid = rng.random((B, N)) < 0.9
    if kind == "one":
        b_valid = np.zeros((B, N), bool)
        b_valid[np.arange(B), rng.integers(0, N, B)] = True
    b_oct = rng.integers(1, 4, (B, N)) if kind != "none" else np.full((B, N), 9)
    ub, vb = rng.uniform(0, 640, (B, N)), rng.uniform(0, 480, (B, N))
    if mode == "proj":
        ua, va = rng.uniform(0, 640, (B, M)), rng.uniform(0, 480, (B, M))
        aa = np.stack([ua, va, ua - 10, z + (300 if kind == "ties" else 1e4), z, z, z + 7,
                       a_valid], -1)
        ab = np.stack([ub, vb, np.where(rng.random((B, N)) < 0.5, ub - 10, -1), b_oct, b_valid,
                       zb + 1e-9, zb, zb], -1)
    else:
        # The line (0, 0, c) puts every b keypoint at distance |c| from it:
        # c ~ N(0, 1) against a unit band passes ~68 % of the rows ("ties"),
        # c = 0 passes all.
        lc = rng.normal(0, 1, (B, M)) if kind == "ties" else z
        aa = np.stack([z, z, lc, z + 1, z + 2, a_valid, z, z], -1)
        ab = np.stack([ub, vb, zb + 1, b_oct, b_valid, zb, zb, zb], -1)
    return da.view(np.int32), aa.astype(np.float32), db.view(np.int32), \
        ab.astype(np.float32)


def lm_obs_problem(rng, O, P, C=96):
    """A K4 input as a (32, O, P) float32 numpy array with the rows I_* of
    ``optim/lm_kernel.py``: O observations of each of P points from C
    random poses (rotations of up to ~0.17 rad, translations of ~0.1),
    points 3-9 m ahead, observed pixels anywhere in a 640x480 image (so
    many residuals are large and Huber is active), right-x from a 50
    px*m baseline, 8 scale levels, 70 % stereo, 80 % valid, Huber on,
    the fr1-desk-like camera of ``bench.make_system``."""
    w = rng.normal(0, 0.1, (C, 3))
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = np.zeros((C, 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    k = (k - k.transpose(0, 2, 1)) / th
    rot = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k  # Rodrigues
    cam = rng.integers(0, C, (O, P))
    inp = np.zeros((32, O, P), np.float32)
    inp[0:9] = rot[cam].reshape(O, P, 9).transpose(2, 0, 1)
    inp[9:12] = rng.normal(0, 0.1, (C, 3))[cam].transpose(2, 0, 1)
    inp[12] = rng.uniform(-3, 3, P)
    inp[13] = rng.uniform(-2, 2, P)
    inp[14] = rng.uniform(3, 9, P)
    inp[15] = rng.uniform(0, 640, (O, P))
    inp[16] = rng.uniform(0, 480, (O, P))
    inp[17] = inp[15] - 50.0 / inp[14]
    inp[18] = 1.0 / 1.44 ** rng.integers(0, 8, (O, P))
    inp[19] = rng.random((O, P)) < 0.7
    inp[20] = rng.random((O, P)) < 0.8
    inp[21] = 1.0
    inp[22:27] = np.array([500.0, 500.0, 320.0, 240.0, 50.0])[:, None, None]
    return inp


def on_device(dev, arrays):
    """The numpy arrays of a problem as tensors on ``dev``."""
    return tuple(torch.as_tensor(x).to(dev) for x in arrays)


def wall_ms(fn, calls=20, reps=11, warm=3):
    """ms per call of fn(): CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs.  For
    launches this small the host's dispatch rate is part of the time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, calls=20, reps=11, warm=3):
    """Device ms per call of fn(): a spin kernel holds the stream while
    the host enqueues ``calls`` calls between two events, so the events
    time the calls back to back on the card; the median of ``reps``
    runs.  The spin lasts 1.5x the host's enqueue time at 2 GHz."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(1.5 * enqueue * 2e9) + 100_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]
