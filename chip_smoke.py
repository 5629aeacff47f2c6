#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX.  Phases, each printing its line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles ``ydorbslam_tpu_torch/csrc/*.cu`` for sm_90a;
  3. K1 (FAST-9 + NMS) against its plain PyTorch version on the 8
     pyramid levels of ``bench.make_frames()`` frame 0 and on a random
     480x640 image: bit-identical, with ms per call (CUDA events around
     runs of back-to-back calls);
  4. K2 (gated Hamming best/second) against its plain version on the
     real frame 0 -> 1 search (both ``check_ur`` values) and on random
     problems: identical idx, best and second, with ms per call;
  5. the main path: ``SlamSystem(..., enable_mapping=False, device="cuda")``
     tracks all 120 frames; 0 lost frames, ATE < 0.02 m, every K1 and
     K2 launch counted; frames/s after 20 warm-up frames;
  6. per-layer times (extraction, motion search, pose LM) inside a
     tracking run of frames 0-59;
  7. parity: the first 20 frames again on the CPU (plain versions);
     the same lost pattern and camera centres within 1e-3 m.

It prints one JSON line with every kernel's name, route, source, the
TPU kernel it replaces, launches in phase 5, max abs error and times,
then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without the last line.
"""
import json
import os
import subprocess
import sys
import time
import traceback

N_WARM = 20


def _median_ms(fn, calls=20, reps=11, warm=3):
    """ms per call of fn(): CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs.  For
    launches this small the host's dispatch rate is part of the time."""
    import torch

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


def _centres(poses):
    import numpy as np

    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def _config():
    from ydorbslam_tpu_torch.config import (
        CameraConfig, DepthConfig, OrbConfig, SlamConfig, TrackingConfig,
    )

    # The configuration of bench.make_system: TUM fr1-desk-like RGB-D
    # sensor, 1000 ORB features, 8 levels at 1.2.
    return SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(
            fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640, height=480,
        ),
        orb=OrbConfig(n_features=1000),
        depth=DepthConfig(depth_map_factor=5000.0),
    )


def _run(frames, device):
    """Track ``frames`` with the port on ``device``: (system, per-frame
    seconds, poses, lost flags)."""
    import torch

    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    system = SlamSystem(
        _config(), Sensor.RGBD, enable_mapping=False, enable_loop_closing=False,
        device=device,
    )
    secs = []
    for t, gray, depth in frames:
        t0 = time.perf_counter()
        system.track_rgbd(t, gray, depth)
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    _, poses, lost = system.tracker.trajectory()
    return system, secs, poses, lost


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np

    import bench
    from ydorbslam_tpu_torch import _build
    from ydorbslam_tpu_torch.io import ate_rmse
    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.ops.extractor import DETECT_BORDER
    from ydorbslam_tpu_torch.ops.fast import fast_score_map, nms_and_border
    from ydorbslam_tpu_torch.ops.hamming import proj_best2_plain
    from ydorbslam_tpu_torch.ops.pyramid import build_pyramid
    from ydorbslam_tpu_torch.slam import matchers

    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    info = _build.build()
    print(f"phase 2 build: {info['seconds']:.1f} s -> {info['path']}", flush=True)
    print(info["log"].strip(), flush=True)

    frames = bench.make_frames()
    from synthetic import oscillating_trajectory  # bench put tests/ on sys.path

    gt_centres = _centres(oscillating_trajectory(len(frames)))
    report = {}

    # 3. K1 against plain
    levels = build_pyramid(torch.as_tensor(frames[0][1]).to(dev).float())
    rand = torch.as_tensor(
        np.random.default_rng(0).uniform(0, 255, (480, 640)).astype(np.float32)
    ).to(dev)
    err = 0.0
    for img in (*levels, rand):
        k = kernels.fast_score_nms_cuda(img, DETECT_BORDER)
        p = nms_and_border(fast_score_map(img), DETECT_BORDER)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"K1 differs from plain at shape {tuple(img.shape)}")
        err = max(err, float((k - p).abs().max()))
    k1_ms = _median_ms(lambda: [kernels.fast_score_nms_cuda(l, DETECT_BORDER) for l in levels])
    k1_plain = _median_ms(
        lambda: [nms_and_border(fast_score_map(l), DETECT_BORDER) for l in levels]
    )
    report["fast_score_nms"] = dict(max_abs_err=err, ms=k1_ms, plain_ms=k1_plain)
    print(f"phase 3 K1: bit-identical on 8 levels {[tuple(l.shape) for l in levels]} "
          f"and random 480x640; per frame (8 levels) kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain:.4f} ms", flush=True)

    # 4. K2 against plain: the real frame 0 -> 1 motion search, then random.
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    sysk = SlamSystem(_config(), Sensor.RGBD, enable_mapping=False,
                      enable_loop_closing=False, device=dev)
    tr = sysk.tracker
    tr.track_rgbd(*frames[0])
    curr = tr._extract(frames[1][1])
    from ydorbslam_tpu_torch.ops.stereo import fill_depth_from_rgbd

    d1 = torch.as_tensor(frames[1][2]).to(dev).float() / torch.tensor(5000.0, device=dev)
    curr = fill_depth_from_rgbd(curr, d1, tr.cam)
    attr_a = matchers._motion_attr(
        tr.cam, curr, tr.last_feats, tr.last_lms, tr.last_lms_valid,
        tr.velocity @ tr.T_cw, tr.T_cw, 7.0, 14.0, 8, 1.2,
    )
    attr_b = matchers._pack_cur_attr(curr)
    real = (tr.last_feats.desc, attr_a, curr.desc, attr_b)
    rng = np.random.default_rng(1)
    problems = [("real", real)]
    for M, N in ((1024, 1024), (1000, 777)):
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
        problems.append((f"random {M}x{N}", tuple(
            torch.as_tensor(x).to(dev) for x in (
                desc_a.view(np.int32), aa.astype(np.float32),
                desc_b.view(np.int32), ab.astype(np.float32)))))
    err = 0.0
    for label, prob in problems:
        for check_ur in (True, False):
            k = kernels.proj_best2_cuda(*prob, check_ur=check_ur)
            p = proj_best2_plain(*prob, check_ur=check_ur)
            torch.cuda.synchronize()
            for kk, pp in zip((*k[0], *k[1]), (*p[0], *p[1])):
                if not torch.equal(kk.to(torch.int64), pp.to(torch.int64)):
                    raise AssertionError(f"K2 differs from plain on {label}, check_ur={check_ur}")
                err = max(err, float((kk.to(torch.int64) - pp.to(torch.int64)).abs().max()))
    n_pass = int((k[1][0] >= 0).sum())
    k2_ms = _median_ms(lambda: kernels.proj_best2_cuda(*real, check_ur=True))
    k2_plain = _median_ms(lambda: proj_best2_plain(*real, check_ur=True))
    report["proj_best2"] = dict(max_abs_err=err, ms=k2_ms, plain_ms=k2_plain)
    print(f"phase 4 K2: identical on real {tuple(real[0].shape)}x{tuple(real[2].shape)} "
          f"and {[l for l, _ in problems[1:]]}, both check_ur; real search kernel "
          f"{k2_ms:.4f} ms, plain {k2_plain:.4f} ms (rows with a candidate in the "
          f"last random problem: {n_pass})", flush=True)

    # 5. main path
    kernels.reset_launch_counts()
    system, secs, poses, lost = _run(frames, "cuda")
    launches = kernels.launch_counts()
    n_lost = sum(lost)
    ate = ate_rmse(_centres(poses), gt_centres)
    steady = secs[N_WARM:]
    fps = len(steady) / sum(steady)
    med_ms = float(np.median(steady)) * 1e3
    print(f"phase 5 main path: {len(frames)} frames, lost {n_lost}, ATE {ate:.6f} m, "
          f"last-frame inliers {system.tracked_map_points()}, launches {launches}, "
          f"{fps:.3f} frames/s, median {med_ms:.3f} ms/frame after {N_WARM} warm-up "
          f"frames | {smi}", flush=True)
    if not all(np.isfinite(p).all() and p.shape == (4, 4) for p in poses):
        raise AssertionError("non-finite or malformed pose")
    if n_lost != 0 or not ate < 0.02:
        raise AssertionError(f"main path: lost {n_lost}, ATE {ate}")
    if launches["fast_score_nms"] != 8 * len(frames) or launches["proj_best2"] < len(frames) - 1:
        raise AssertionError(f"main path did not go through the kernels: {launches}")
    for k in report:
        report[k]["launches"] = launches[k]

    # 6. per-layer times, inside a real tracking run of frames 0-59: the
    # tracker's three compute steps are wrapped with synchronized timers.
    from ydorbslam_tpu_torch.slam import tracking

    layers = {"extract_orb": [], "match_motion_model_two": [], "optimize_pose": []}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            layers[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    originals = {k: getattr(tracking, k) for k in layers}
    try:
        for k, fn in originals.items():
            setattr(tracking, k, timed(fn, k))
        _run(frames[:60], "cuda")
    finally:
        for k, fn in originals.items():
            setattr(tracking, k, fn)
    print("phase 6 layers over frames 0-59 (median ms per call, calls): "
          + ", ".join(f"{k} {float(np.median(v)):.3f} ({len(v)})" for k, v in layers.items()),
          flush=True)

    # 7. parity against the CPU
    _, _, poses_cpu, lost_cpu = _run(frames[:N_WARM], "cpu")
    diff = float(np.abs(_centres(poses_cpu) - _centres(poses[:N_WARM])).max())
    print(f"phase 7 CPU parity: first {N_WARM} frames, lost pattern "
          f"{'identical' if lost_cpu == lost[:N_WARM] else 'DIFFERENT'}, "
          f"max camera-centre difference {diff:.3e} m", flush=True)
    if lost_cpu != lost[:N_WARM] or not diff < 1e-3:
        raise AssertionError("CPU and CUDA runs disagree")

    rows = []
    for k, src, rep in (
        ("fast_score_nms", "ydorbslam_tpu_torch/csrc/fast_nms.cu",
         "ydorbslam_tpu/ops/pallas_kernels.py:125"),
        ("proj_best2", "ydorbslam_tpu_torch/csrc/proj_best2.cu",
         "ydorbslam_tpu/ops/pallas_kernels.py:293"),
    ):
        r = report[k]
        rows.append(dict(name=k, route="cuda", source=src, replaces=rep,
                         launches=r["launches"], max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
