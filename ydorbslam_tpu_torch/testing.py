"""Problem generators and CUDA timers shared by the checks of the kernels.

``proj_problem`` and ``pair_problem`` make seeded K2 and K3 inputs as
numpy arrays (random, tie-heavy, none or exactly one column passing),
which ``tests/test_torch_best2_merge.py`` feeds to the plain versions on
the CPU and ``chip_smoke.py`` and ``tools/time_kernels.py`` to the
kernels on the card; ``lm_obs_problem`` makes a seeded K4 input for the
last two, and ``pose_graph_problem`` a seeded essential graph with
duplicate edges and high degrees.  ``wall_ms`` and ``device_ms`` time a call on the card with
and without the host's dispatch.  ``make_stereo_frames`` renders the
stereo workload: a rectified pair sequence at the KITTI-00 camera.
``write_tum_sequence`` writes RGB-D frames to disk as a TUM sequence
directory with its settings file (``TUM_RGBD_SETTINGS``), and
``write_kitti_sequence`` stereo pairs as a KITTI odometry sequence
directory at the KITTI-00 camera.  ``free_port`` finds a local port
for a one-host process group.  ``sharded_rank_checks`` and
``sharded_chunk_rank`` are rank bodies for ``parallel.launch.spawn_ranks``
(the tests' worlds of 2 and 4 CPU ranks; ``chip_smoke.py`` phase 21's
ranks on the card), and ``assert_replicated`` checks that every rank of a
group holds the same bits.

At import this module needs only numpy and torch, nothing else of the
package, so ``tools/time_kernels.py`` can load it by path beside another
checkout's package and call its generators and timers.
``write_tum_sequence`` imports PIL and the package's ``io.trajectory``
when called, so it is called through the package; ``write_kitti_sequence``
imports PIL when called.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

# ORB-SLAM2's Examples/Stereo/KITTI00-02.yaml: the rectified KITTI 00-02
# camera (1241x376, fx = fy = 718.856, bf = 386.1448, i.e. a 0.537 m
# baseline), ThDepth 35, 10 fps, 2000 features on 8 levels at 1.2, FAST
# thresholds 20 and 7, no distortion.
KITTI00 = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
               width=1241, height=376, fps=10.0, th_depth=35.0, n_features=2000,
               n_levels=8, scale_factor=1.2, ini_th_fast=20, min_th_fast=7)
# Landmarks of the stereo workload, chosen once: 1000 textured dots of
# 13x13 px, so that frame 0 of the left camera extracts 1992 keypoints of
# the 2048 slots and 1332 of them get a stereo depth, and the map keeps
# making keyframes under the bounded "xyz" motion (the JAX package on a
# CPU: 25 over 60 frames).  With the RGB-D workload's 3x3 dots (3000 of
# them for 1800 keypoints) the descriptors of different dots hardly
# differ, a quarter to a half of the stereo matches take another dot of
# the row, and the near points they make hold the second frame's pose
# at zero motion (JAX: TUM ATE 0.173 m over 60 frames); 350 dots of 17
# px track well but make one keyframe in 60 frames.
STEREO_LANDMARKS = 1000
STEREO_DOT = 13  # px side of a rendered landmark
# The settings file of the TUM RGB-D workload: the camera that
# bench.make_frames() renders with (fx = fy = 500, principal point at the
# centre of 640x480, no distortion, bf 50, i.e. a 0.1 m baseline) and the
# rest of ORB-SLAM2's Examples/RGB-D/TUM1.yaml: RGB channel order, 30 fps,
# ThDepth 40, DepthMapFactor 5000, 1000 features on 8 levels at 1.2,
# FAST thresholds 20 and 7.  Capacities and min_init_depth_points are not
# settings-file keys, so a run keeps load_config's defaults.
TUM_RGBD_SETTINGS = {
    "Camera.fx": 500.0, "Camera.fy": 500.0, "Camera.cx": 320.0, "Camera.cy": 240.0,
    "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
    "Camera.k3": 0.0, "Camera.width": 640, "Camera.height": 480, "Camera.fps": 30.0,
    "Camera.bf": 50.0, "Camera.RGB": 1, "ThDepth": 40.0, "DepthMapFactor": 5000.0,
    "ORBextractor.nFeatures": 1000, "ORBextractor.scaleFactor": 1.2,
    "ORBextractor.nLevels": 8, "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7,
}


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


def _rodrigues(w):
    """(n, 3) rotation vectors -> (n, 3, 3) rotation matrices, float64."""
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = np.zeros((w.shape[0], 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    k = (k - k.transpose(0, 2, 1)) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def lm_obs_problem(rng, O, P, C=96):
    """A K4 input as a (32, O, P) float32 numpy array with the rows I_* of
    ``optim/lm_kernel.py``: O observations of each of P points from C
    random poses (rotations of up to ~0.17 rad, translations of ~0.1),
    points 3-9 m ahead, observed pixels anywhere in a 640x480 image (so
    many residuals are large and Huber is active), right-x from a 50
    px*m baseline, 8 scale levels, 70 % stereo, 80 % valid, Huber on,
    the fr1-desk-like camera of ``bench.make_system``."""
    rot = _rodrigues(rng.normal(0, 0.1, (C, 3)))
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


def pose_graph_problem(rng, V, n_offsets, n_extra, n_dup):
    """An essential graph as numpy arrays with the fields of
    ``optim.pose_graph.PoseGraphProblem``: V keyframes on a 5 m circle,
    looking about inward, whose estimates drift by up to ~0.2 m and
    ~0.06 rad; an edge from every keyframe to each of the next
    ``n_offsets`` around the circle (every vertex has degree
    2 * n_offsets), ``n_extra`` edges between random pairs and ``n_dup``
    repeats of earlier edges (half of them reversed), each measured from
    the true poses with ~2 mm and ~1 mrad of noise; vertex 0 fixed, unit
    weights, all valid.  Returns (problem dict, true poses (V, 4, 4))."""
    ang = 2 * np.pi * np.arange(V) / V
    w_true = np.stack([0.1 * np.sin(3 * ang), -ang, 0.1 * np.cos(2 * ang)], -1)
    c_true = np.stack([5 * np.cos(ang), 0.3 * np.sin(2 * ang), 5 * np.sin(ang)], -1)
    T_true = np.tile(np.eye(4), (V, 1, 1))
    T_true[:, :3, :3] = _rodrigues(w_true)
    T_true[:, :3, 3] = -np.einsum("vij,vj->vi", T_true[:, :3, :3], c_true)
    drift = np.linspace(0.0, 1.0, V)[:, None]
    T_est = np.tile(np.eye(4), (V, 1, 1))
    T_est[:, :3, :3] = _rodrigues(drift * np.array([0.02, 0.05, -0.03])
                                  + rng.normal(0, 1e-3, (V, 3))) @ T_true[:, :3, :3]
    T_est[:, :3, 3] = T_true[:, :3, 3] + drift * np.array([0.1, -0.05, 0.15]) \
        + rng.normal(0, 2e-3, (V, 3))
    T_est[0] = T_true[0]
    ei = np.concatenate([np.arange(V)] * n_offsets)
    ej = np.concatenate([(np.arange(V) + o) % V for o in range(1, n_offsets + 1)])
    extra_i = rng.integers(0, V, n_extra)
    extra_j = (extra_i + rng.integers(1, V, n_extra)) % V
    ei, ej = np.concatenate([ei, extra_i]), np.concatenate([ej, extra_j])
    dup = rng.integers(0, ei.shape[0], n_dup)
    rev = np.arange(n_dup) % 2 == 1
    ei, ej = (np.concatenate([ei, np.where(rev, ej[dup], ei[dup])]),
              np.concatenate([ej, np.where(rev, ei[dup], ej[dup])]))
    E = ei.shape[0]
    noise = np.tile(np.eye(4), (E, 1, 1))
    noise[:, :3, :3] = _rodrigues(rng.normal(0, 1e-3, (E, 3)))
    noise[:, :3, 3] = rng.normal(0, 2e-3, (E, 3))
    meas = noise @ T_true[ei] @ np.linalg.inv(T_true[ej])
    prob = dict(S_iw=T_est.astype(np.float32), fixed=np.arange(V) == 0,
                vertex_valid=np.ones(V, bool), edge_i=ei.astype(np.int32),
                edge_j=ej.astype(np.int32), edge_meas=meas.astype(np.float32),
                edge_valid=np.ones(E, bool), edge_weight=np.ones(E, np.float32))
    return prob, T_true


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now (the kernel's
    pick for a socket bound to port 0), for a one-host process group."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def kitti00_config(m):
    """The KITTI-00 ``SlamConfig`` of the stereo workload, built from the
    config module ``m`` of either package (so this module imports neither):
    ``KITTI00``'s camera and extractor, ThDepth 35, the reference's
    ``min_init_depth_points`` of 500 and 160 keyframe slots, every other
    capacity at its default."""
    c = KITTI00
    return m.SlamConfig(
        camera=m.CameraConfig(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], bf=c["bf"],
                              width=c["width"], height=c["height"], fps=c["fps"]),
        orb=m.OrbConfig(n_features=c["n_features"], n_levels=c["n_levels"],
                        scale_factor=c["scale_factor"], ini_th_fast=c["ini_th_fast"],
                        min_th_fast=c["min_th_fast"]),
        depth=m.DepthConfig(th_depth=c["th_depth"]),
        tracking=m.TrackingConfig(min_init_depth_points=500),
        capacity=m.CapacityConfig(max_keyframes=160),
    )


def make_stereo_frames(n_frames=60, seed=0):
    """The stereo workload: ``n_frames`` rectified (timestamp, left,
    right) uint8 pairs at the KITTI-00 camera (``KITTI00``) of the
    ``STEREO_LANDMARKS`` textured dots (``STEREO_DOT`` px) of
    ``tests/synthetic.py``, seen along its "xyz" hand-held oscillation
    (``SyntheticRgbdSequence`` with ``trajectory="xyz"``), and the
    ground-truth T_cw of each frame.  The right camera sits bf/fx to the
    right of the left one along camera x, as in
    ``tests/test_stereo_system.py``.  numpy only; ``tests/`` goes on
    ``sys.path`` as ``bench.make_frames`` puts it there."""
    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from synthetic import SyntheticRgbdSequence, project_np, render_dots

    c = KITTI00
    seq = SyntheticRgbdSequence(
        np.random.default_rng(seed), n_frames=n_frames, n_landmarks=STEREO_LANDMARKS,
        width=c["width"], height=c["height"], fx=c["fx"], fy=c["fy"], cx=c["cx"],
        cy=c["cy"], trajectory="xyz",
    )
    baseline = c["bf"] / c["fx"]
    frames = []
    for i, T in enumerate(seq.poses):
        T_r = T.copy()
        T_r[0, 3] -= baseline  # x_cam_right = x_cam_left - b
        pair = []
        for pose in (T, T_r):
            uv, z = project_np(seq.K, pose, seq.landmarks)
            pair.append(render_dots(uv, z, seq.width, seq.height, dot=STEREO_DOT).astype(np.uint8))
        frames.append((i / c["fps"], pair[0], pair[1]))
    return frames, seq.poses


def write_settings(path, settings) -> None:
    """Write ``settings`` (key -> value) as an OpenCV-style settings file
    that ``config.load_config`` reads."""
    with open(path, "w") as f:
        f.write("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in settings.items()))


def write_tum_sequence(root, frames, poses, yaml_settings):
    """Write RGB-D ``frames`` ((timestamp, uint8 gray, uint16 depth), as
    ``bench.make_frames()`` makes them) and their ground-truth T_cw
    ``poses`` under ``root`` as a TUM RGB-D sequence directory:
    ``rgb/<t>.png`` (8-bit gray), ``depth/<t>.png`` (16-bit, the depth
    encoding kept as given), ``assoc.txt``, ``groundtruth.txt``
    (camera-to-world, ``t tx ty tz qx qy qz qw``) and ``settings.yaml``
    of ``yaml_settings`` (``write_settings``; the workload's is
    ``TUM_RGBD_SETTINGS``).  Returns the paths of the settings file, the
    association file and the ground truth.  ``io.TumRgbdDataset`` reads
    the images back bit for bit."""
    from PIL import Image

    from .io.trajectory import write_tum_trajectory

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    assoc = []
    for t, gray, depth in frames:
        ts = f"{t:.6f}"
        Image.fromarray(np.ascontiguousarray(gray, dtype=np.uint8)).save(
            os.path.join(root, "rgb", f"{ts}.png"))
        Image.fromarray(np.ascontiguousarray(depth, dtype=np.uint16)).save(
            os.path.join(root, "depth", f"{ts}.png"))
        assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n")
    paths = [os.path.join(root, n) for n in ("settings.yaml", "assoc.txt", "groundtruth.txt")]
    write_settings(paths[0], yaml_settings)
    with open(paths[1], "w") as f:
        f.writelines(assoc)
    write_tum_trajectory(paths[2], [t for t, _, _ in frames], poses)
    return tuple(paths)


def write_kitti_sequence(root, frames, poses):
    """Write rectified stereo ``frames`` ((timestamp, uint8 left, uint8
    right), as ``make_stereo_frames`` makes them) and their ground-truth
    T_cw ``poses`` under ``root`` as a KITTI odometry sequence directory:
    ``image_0/NNNNNN.png`` and ``image_1/NNNNNN.png`` (8-bit gray),
    ``times.txt``, ``calib.txt`` with the P0 and P1 rows of the KITTI-00
    camera (``KITTI00``; P1's fourth entry is -bf) and ``poses.txt``
    (camera-to-world, the 3x4 rows of KITTI's ground truth).  Both
    packages' ``KittiStereoDataset`` read the images back bit for bit and
    their ``kitti_intrinsics`` read ``KITTI00``'s fx, fy, cx, cy and bf.
    Returns the path of ``poses.txt``."""
    from PIL import Image

    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, (_, left, right) in enumerate(frames):
        for sub, img in (("image_0", left), ("image_1", right)):
            Image.fromarray(np.ascontiguousarray(img, dtype=np.uint8)).save(
                os.path.join(root, sub, f"{i:06d}.png"))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.writelines(f"{t:.6e}\n" for t, _, _ in frames)
    c = KITTI00
    P0 = np.array([[c["fx"], 0.0, c["cx"], 0.0], [0.0, c["fy"], c["cy"], 0.0],
                   [0.0, 0.0, 1.0, 0.0]])
    P1 = P0.copy()
    P1[0, 3] = -c["bf"]
    with open(os.path.join(root, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(f"{name}: " + " ".join(f"{x:.12e}" for x in P.reshape(-1)) + "\n")
    path = os.path.join(root, "poses.txt")
    np.savetxt(path, np.stack([np.linalg.inv(T)[:3, :].reshape(-1) for T in poses]),
               fmt="%.12e")
    return path


# ----------------------------------------------------------------------
# Rank bodies of spawned worlds (``parallel.launch.spawn_ranks``)
# ----------------------------------------------------------------------

def assert_replicated(g, **tensors) -> None:
    """Raise unless every rank of ``g`` holds the same bits in each tensor."""
    import torch.distributed as dist

    for name, t in tensors.items():
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(g.size)]
        dist.all_gather(parts, t, group=g.group)
        if not all(torch.equal(parts[0], x) for x in parts[1:]):
            raise AssertionError(f"{name} differs between the ranks")


def sharded_rank_checks(g, device, inp) -> dict:
    """One rank's run of every sharded piece on ``inp`` (numpy inputs made
    by the test): the pose step (1 and 5 steps), the BA step, two LM
    chunks, the bundle adjustment with and without an abort after its
    first chunk, the sharded top-k and scores, sharded detection, and a
    ``SlamSystem`` (``inp["cfg"]``) whose closer detects on a map and
    whose armed global BA ticks to its merge.  Checks that every rank
    holds the same poses and damping; returns the results."""
    from .convert import (ba_problem_from_numpy, camera_from_numpy, map_state_from_numpy,
                          retrieval_index_from_numpy)
    from .parallel import ba_sharded as bs
    from .parallel import retrieval_sharded as rs
    from .slam import loop_impl
    from .slam.system import Sensor, SlamSystem

    def t(x):
        return torch.as_tensor(x).to(device)

    cam = camera_from_numpy(inp["cam"], device)
    out = {}
    T0, pts, obs, s2, valid = (t(inp["pose"][k]) for k in ("T", "pts", "obs", "s2", "valid"))
    out["pose1"] = T = bs.sharded_pose_step(g, cam, T0, pts, obs, s2, valid)
    for _ in range(4):
        T = bs.sharded_pose_step(g, cam, T, pts, obs, s2, valid)
    out["pose5"] = T
    prob = ba_problem_from_numpy(inp["ba"], device)
    out["step_T"], out["step_p"] = bs.sharded_ba_step(g, cam, prob, 1e-4)
    T, p, lam = prob.T_cw, prob.p_w, torch.full((), 1e-4, device=device)
    for i in range(2):
        T, p, lam = bs._sharded_lm_chunk(g, cam, prob, T, p, lam, 5, True)
        out.update({f"chunk{i}_T": T, f"chunk{i}_p": p, f"chunk{i}_lam": lam})
    orig_chunk = bs._sharded_lm_chunk
    for name, abort in (("ba", None), ("ba_abort", lambda: True)):
        chunks = []

        def counted(*args):
            chunks.append(1)
            return orig_chunk(*args)

        bs._sharded_lm_chunk = counted
        try:
            out[f"{name}_T"], out[f"{name}_p"], out[f"{name}_out"] = bs.sharded_bundle_adjust(
                g, cam, prob, 10, 5, should_abort=abort)
        finally:
            bs._sharded_lm_chunk = orig_chunk
        out[f"{name}_chunks"] = len(chunks)
    idx = retrieval_index_from_numpy(inp["idx"], device)
    out["topk_ids"], out["topk_scores"] = rs.sharded_topk_scores(g, idx, t(inp["q"]), k=4)
    out["all_common"], out["all_scores"] = rs.score_all_sharded(g, idx, t(inp["q"]))
    kg = g._replace(axis_name="kf")
    for name, d in inp["detect"].items():
        m = map_state_from_numpy(d["map"], device)
        C = d["C"]
        res = loop_impl._detect(
            m, retrieval_index_from_numpy(d["idx"], device), d["kf"],
            torch.zeros((C, m.K), dtype=torch.bool, device=device),
            torch.full((C,), -1, dtype=torch.int32, device=device), C, d["th"],
            min_frame_gap=d["gap"], group=kg)
        out.update({f"detect_{name}_{i}": x for i, x in enumerate(res)})

    chunked = sharded_chunk_rank(g, device, dict(cam=inp["cam"], prob=inp["ba"], lam=1e-4,
                                                 chunks=2, rtol=0.0, atol=0.0))
    out.update({f"chunkrank_{k}": v for k, v in chunked.items() if k != "ms"})

    system = SlamSystem(inp["cfg"], Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                        device=device)
    sysd = inp["system"]
    system.map = map_state_from_numpy(sysd["map"], device)
    system.retrieval = retrieval_index_from_numpy(sysd["idx"], device)
    system.n_keyframes = int(sysd["map"]["kf_valid"].sum())
    impl = system.loop_closer._impl
    impl._dispatch_detect(sysd["kf"])
    out["sys_packed"] = impl._pending[2]
    impl._pending = None
    impl._start_global_ba(system.map, int(sysd["map"]["mp_valid"].sum()))
    out["sys_sharded"] = [impl._kf_group is not None, impl._gba["group"] is not None,
                          impl.used_sharded_detect]
    while impl._gba is not None:
        impl.tick()
    out["sys_kf_pose"], out["sys_mp_pos"] = system.map.kf_pose, system.map.mp_pos
    assert_replicated(g, **{k: v for k, v in out.items() if k.endswith(("_T", "_lam", "pose1",
                                                                         "pose5", "kf_pose"))})
    return out


def sharded_chunk_rank(g, device, inp) -> dict:
    """One rank's point-sharded LM on the global BA in ``inp`` (numpy; a
    problem captured from the loop closer, started at its T, p and
    ``lam``): one LM iteration (``step_T``, ``step_p``), then
    ``inp["chunks"]`` chunks of 5, each timed to its end on the device.
    Returns the results, the rank's K4 launches per chunk and, on a card,
    its first K4 input held against the plain version (``max_abs_err``,
    within ``inp["rtol"]``, ``inp["atol"]``).  Checks that every rank
    holds the same T and damping."""
    from .convert import ba_problem_from_numpy, camera_from_numpy
    from .ops import kernels
    from .optim import lm_kernel, schur
    from .parallel.ba_sharded import _sharded_lm_chunk

    cam = camera_from_numpy(inp["cam"], device)
    prob = ba_problem_from_numpy(inp["prob"], device)
    T, p = prob.T_cw, prob.p_w
    lam = torch.as_tensor(inp["lam"], dtype=torch.float32).to(device)
    cuda = torch.device(device).type == "cuda"
    seen = []
    orig = schur.lm_obs

    def keep(x):
        if not seen:
            seen.append(x.clone())
        return orig(x)

    out = {"launches": [], "ms": []}
    schur.lm_obs = keep
    try:
        out["step_T"], out["step_p"], _ = _sharded_lm_chunk(g, cam, prob, T, p, lam, 1, True)
        for i in range(inp["chunks"]):
            if cuda:
                torch.cuda.synchronize()
            before = kernels.launch_counts()["lm_obs"]
            t0 = time.perf_counter()
            T, p, lam = _sharded_lm_chunk(g, cam, prob, T, p, lam, 5, True)
            if cuda:
                torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append(kernels.launch_counts()["lm_obs"] - before)
    finally:
        schur.lm_obs = orig
    out.update(T=T, p=p, lam=lam, k4_shape=list(seen[0].shape), max_abs_err=None)
    if cuda:
        kq, kp = kernels.lm_obs_cuda(seen[0])
        pq, pp = lm_kernel.lm_obs_plain(seen[0])
        torch.cuda.synchronize()
        err = 0.0
        for a, b in ((kq, pq), (kp, pp)):
            if ((a - b).abs() > inp["atol"] + inp["rtol"] * b.abs()).any():
                raise AssertionError(f"rank {g.rank}: K4 differs from plain on its shard")
            err = max(err, float((a - b).abs().max()))
        out["max_abs_err"] = err
    assert_replicated(g, T=T, lam=lam, p=p, step_T=out["step_T"])
    return out
