#!/usr/bin/env python3
"""How far the pipelined path's outcome after its first keyframe burst
depends on float rounding, in either package, on a CPU.

    python3 tools/pipelined_divergence.py --package port [--threads N] [--frames 120]
    python3 tools/pipelined_divergence.py --package jax [--frames 120]
    python3 tools/pipelined_divergence.py --package jax --perturb 30
    python3 tools/pipelined_divergence.py --package jax --seed 1
    python3 tools/pipelined_divergence.py --package jax --nudge 0
    XLA_FLAGS=--xla_cpu_multi_thread_eigen=false python3 tools/pipelined_divergence.py --package jax

Runs one package's pipelined RGB-D path in bench.py's configuration and
call sequence (``chip_smoke._config()``, ``enable_pipelined(lag=16)``,
20 frames, ``flush_pipeline``, then frames 20 to ``--frames``-1,
``flush_pipeline``) on the frames of ``bench.make_frames()`` on the CPU.
The drain after frame 38 inserts the keyframes of frames 26-38 and runs
one deferred local BA; the step of frame 39 is the first on that map.

Perturbations of the run, one at a time:

* ``--threads``: the port's torch threads (its float sums run in
  another order with another count); ``XLA_FLAGS`` for the JAX package;
* ``--perturb F``: frame F's depth one sensor unit (0.2 mm) deeper at
  one pixel, the one with depth nearest the image centre;
* ``--seed S``: ``bench.make_frames``' sequence drawn from
  ``default_rng(S)`` (bench.py draws it from ``default_rng(0)``);
* ``--nudge S``: in the input of the run's first deferred local BA (the
  burst's), one coordinate of one valid map point, drawn from
  ``default_rng(S)``, one ulp larger.

It prints one JSON line: the package and perturbation, the frame trace
(mode, ok, inliers, need_kf, inserted per frame), the lost frames,
keyframes inserted, local BAs, the TUM-file ATE against the ground truth
(rows matched to frames by time, as ``tools/jax_pipelined_reference.py``
does), and for each deferred BA the keyframes' and points' median and
largest moves.  The port's run imports nothing of JAX; the JAX run uses
none of the port's SLAM code.  About 4 minutes for 41 frames and 8-12
for 120, in either package.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402


def _centres(T):
    return np.einsum("kji,kj->ki", T[:, :3, :3], -T[:, :3, 3])


def make_frames(n_frames: int, seed: int):
    """``bench.make_frames`` with the sequence drawn from ``default_rng(seed)``."""
    import bench
    from synthetic import SyntheticRgbdSequence

    if seed == 0:
        return bench.make_frames(n_frames)
    seq = SyntheticRgbdSequence(np.random.default_rng(seed), n_frames=n_frames,
                                n_landmarks=1500, trajectory="xyz")
    out = []
    for i in range(n_frames):
        t, g, d = seq.frame(i)
        out.append((t, g.astype(np.uint8), (d * bench.DEPTH_FACTOR).astype(np.uint16)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "jax"), required=True)
    ap.add_argument("--threads", type=int, default=0, help="torch threads (port)")
    ap.add_argument("--frames", type=int, default=41)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--perturb", type=int, default=-1,
                    help="frame whose depth nearest the centre is one unit deeper")
    ap.add_argument("--nudge", type=int, default=-1,
                    help="seed of the one-ulp nudge of the first deferred BA's input")
    args = ap.parse_args()
    os.chdir(ROOT)
    from synthetic import oscillating_trajectory

    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory

    frames = make_frames(args.frames, args.seed)
    if args.perturb >= 0:
        t, g, d = frames[args.perturb]
        d = d.copy()
        v, u = np.nonzero(d)
        k = np.argmin((v - 240) ** 2 + (u - 320) ** 2)
        d[v[k], u[k]] += 1
        frames[args.perturb] = (t, g, d)
    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ydorbslam_tpu.config import (
            CameraConfig, CapacityConfig, DepthConfig, OrbConfig, SlamConfig, TrackingConfig,
        )
        from ydorbslam_tpu.slam import system as smod

        cfg = SlamConfig(
            tracking=TrackingConfig(min_init_depth_points=100),
            camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640,
                                height=480),
            orb=OrbConfig(n_features=1000), depth=DepthConfig(depth_map_factor=5000.0),
            capacity=CapacityConfig(max_keyframes=160, max_map_points=16384),
        )
        from ydorbslam_tpu.slam import mapping as mapping_mod

        system = smod.SlamSystem(cfg, smod.Sensor.RGBD, enable_loop_closing=False)

        def host(m):
            return {k: np.array(getattr(m, k)) for k in ("kf_pose", "kf_valid", "mp_pos",
                                                         "mp_valid")}

        def nudged(m, j, c):
            pos = np.array(m.mp_pos)
            pos[j, c] = np.nextafter(pos[j, c], np.float32(np.inf))
            return m._replace(mp_pos=jax.numpy.asarray(pos))
    else:
        import torch

        import chip_smoke
        from ydorbslam_tpu_torch.slam import system as smod

        if args.threads:
            torch.set_num_threads(args.threads)
        system = smod.SlamSystem(chip_smoke._config(), smod.Sensor.RGBD, enable_mapping=True,
                                 enable_loop_closing=False, device="cpu")
        mapping_mod = smod

        def host(m):
            return {k: getattr(m, k).numpy().copy() for k in ("kf_pose", "kf_valid", "mp_pos",
                                                              "mp_valid")}

        def nudged(m, j, c):
            pos = m.mp_pos.clone()
            pos[j, c] = torch.nextafter(pos[j, c], torch.tensor(np.inf))
            return m._replace(mp_pos=pos)
    system.enable_pipelined(lag=16)
    system.frame_trace = []
    bas = []
    Sys = smod.SlamSystem
    orig = Sys._run_deferred_ba

    def deferred_ba(self):
        before = host(self.map)
        orig(self)
        after = host(self.map)
        v = after["kf_valid"] & before["kf_valid"]
        kf = np.linalg.norm(_centres(after["kf_pose"]) - _centres(before["kf_pose"]), axis=-1)[v]
        both = after["mp_valid"] & before["mp_valid"]
        mp = np.linalg.norm(after["mp_pos"] - before["mp_pos"], axis=-1)[both]
        bas.append(dict(frame_id=self.frame_id, kf_median=float(np.median(kf)),
                        kf_max=float(kf.max()), mp_median=float(np.median(mp)),
                        mp_max=float(mp.max())))

    Sys._run_deferred_ba = deferred_ba
    orig_finish = mapping_mod.mapping_finish
    nudge = []

    def finish(m, *a, **kw):
        if args.nudge >= 0 and not nudge:
            rng = np.random.default_rng(args.nudge)
            ids = np.nonzero(host(m)["mp_valid"])[0]
            j, c = int(ids[rng.integers(len(ids))]), int(rng.integers(3))
            nudge.append(dict(frame_id=system.frame_id, point=j, coord=c))
            m = nudged(m, j, c)
        return orig_finish(m, *a, **kw)

    mapping_mod.mapping_finish = finish
    t0 = time.perf_counter()
    for f in frames[:20]:
        system.track_rgbd_pipelined(*f)
    system.flush_pipeline()
    for f in frames[20:]:
        system.track_rgbd_pipelined(*f)
    system.flush_pipeline()
    secs = time.perf_counter() - t0
    stats = system.run_stats()
    gt = oscillating_trajectory(len(frames))
    gt_centres = np.stack([-p[:3, :3].T @ p[:3, 3] for p in gt])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos, _ = read_tum_trajectory(path)
    frame_of = {t: i for i, (t, _, _) in enumerate(frames)}
    rows = [frame_of[min(frame_of, key=lambda x: abs(x - t))] for t in ts]
    print(json.dumps(dict(
        package=args.package, threads=args.threads or None,
        xla_flags=os.environ.get("XLA_FLAGS") if args.package == "jax" else None,
        seed=args.seed, perturb=args.perturb if args.perturb >= 0 else None,
        nudge=nudge[0] if nudge else None,
        frames=len(frames), seconds=round(secs, 1),
        lost_frames=[i for i, r in enumerate(system.records) if r.lost],
        keyframes_inserted=stats["keyframes_inserted"], local_ba_runs=stats["local_ba_runs"],
        ate_tum=float(ate_rmse(pos, gt_centres[rows])),
        trace=[[int(m), int(ok), int(n), int(need), int(ins)]
               for _, m, ok, n, need, ins in system.frame_trace],
        deferred_bas=bas,
    )))


if __name__ == "__main__":
    main()
