#!/usr/bin/env python3
"""How far ``chip_smoke.py`` phase 13's revisit depends on the order of the
pose solves' float32 sums, with K5 and with the plain pose LM.

    python3 tools/revisit_orderings.py [--modes k5 plain] [--perms id 1 2 3]
        [--jobs 7] [--diag] [--out DIR] [--device cuda] [--frames N]

Each job tracks ``bench.make_revisit_frames()`` (140 frames, RGB-D, mapping
and loop closing on, ``chip_smoke._config()``, as phase 13 does) in its own
process, with every ``optimize_pose`` call of ``slam.tracking``,
``slam.system`` and ``slam.pipeline`` replaced by one mode:

* ``k5``: ``optim.pose.optimize_pose`` (K5 on a CUDA tensor);
* ``plain``: ``optim.pose.optimize_pose_plain``, the eager version.

``--perms``: ``id`` solves the observations as given; an integer S solves
them in the order of ``numpy.random.default_rng(S).permutation(N)`` and
puts the inlier mask back in the given order, so the solve is the same
but its sums are taken in another order.  ``--jobs`` processes run at a
time (one card holds several; each takes about 1.6 GiB).  ``--diag``
re-solves every pose of frames 95-125 with the plain version (on the
run's device, float32) and in float64 (CPU) on the same inputs, without
touching the run, and records inlier counts, flips and camera-centre gaps.

Prints one line per job (tracked frames, lost frames, loop events), then
per mode the tracked counts, their median and how many fall under phase
13's gate (``chip_smoke.JAX_CPU_TRACKED_REVISIT - 2``), with a
Mann-Whitney U test of the two modes where scipy is there, and the card's
name and power limit.  Each job's result is a JSON file under ``--out``.
On the CPU ``--device cpu --frames 4`` runs the code paths in a few
minutes (``k5`` then takes the plain version).
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG_FRAMES = (95, 125)


def _one(a):
    """One job in this process; writes its JSON file."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import bench
    import chip_smoke
    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.optim import pose
    from ydorbslam_tpu_torch.slam import pipeline, system as sysmod, tracking
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    torch.set_num_threads(1)
    frames = bench.make_revisit_frames()
    if a.frames:
        frames = frames[: a.frames]
    base = pose.optimize_pose if a.mode == "k5" else pose.optimize_pose_plain
    state = {"frame": -1}
    solves = []

    def f64(t):
        return t.double().cpu() if t.is_floating_point() else t.cpu()

    def centre(T):
        T = T.double().cpu()
        return -T[:3, :3].T @ T[:3, 3]

    def wrap(site):
        def solve(cam, T, obs, *args, **kw):
            n = obs.valid.shape[0]
            if a.perm == "id":
                out = base(cam, T, obs, *args, **kw)
            else:
                perm = np.random.default_rng(int(a.perm)).permutation(n)
                idx = torch.from_numpy(perm).to(T.device)
                inv = torch.empty_like(idx)
                inv[idx] = torch.arange(n, device=T.device)
                T2, inl, n_in = base(cam, T, pose.PoseObservations(*(t[idx] for t in obs)),
                                     *args, **kw)
                out = (T2, inl[inv], n_in)
            if a.diag and DIAG_FRAMES[0] <= state["frame"] <= DIAG_FRAMES[1]:
                p = pose.optimize_pose_plain(cam, T, obs, *args, **kw)
                cam64 = cam._replace(**{f: f64(getattr(cam, f)) for f in cam._fields[:10]})
                obs64 = pose.PoseObservations(*(f64(t) for t in obs))
                d = pose.optimize_pose_plain(cam64, f64(T), obs64, *args, **kw)
                ck, cp, cd = centre(out[0]), centre(p[0]), centre(d[0])
                solves.append(dict(
                    frame=state["frame"], site=site, valid=int(obs.valid.sum()),
                    n_run=int(out[2]), n_plain=int(p[2]), n_f64=int(d[2]),
                    flips_run_plain=int((out[1] != p[1]).sum()),
                    flips_run_f64=int((out[1].cpu() != d[1]).sum()),
                    flips_plain_f64=int((p[1].cpu() != d[1]).sum()),
                    gap_run_f64=float(torch.linalg.norm(ck - cd)),
                    gap_plain_f64=float(torch.linalg.norm(cp - cd))))
            return out
        return solve

    for m in (tracking, sysmod, pipeline):
        m.optimize_pose = wrap(m.__name__.rsplit(".", 1)[-1])
    system = SlamSystem(chip_smoke._config(), Sensor.RGBD, enable_mapping=True,
                        enable_loop_closing=True, device=a.device)
    oks, t0 = [], time.perf_counter()
    for i, (t, g, d) in enumerate(frames):
        state["frame"] = i
        oks.append(bool(system.track_rgbd(t, g, d)))
    system.shutdown()
    st = system.run_stats()
    res = dict(mode=a.mode, perm=a.perm, tracked=sum(oks),
               lost=[i for i, ok in enumerate(oks) if not ok],
               keyframes=st["keyframes_inserted"], loop_events=st["loop_events"],
               seconds=time.perf_counter() - t0, launches=kernels.launch_counts(),
               solves=solves)
    with open(a.json, "w") as f:
        json.dump(res, f)


def _summary(results, gate):
    lines, by_mode = [], {}
    for r in results:
        by_mode.setdefault(r["mode"], []).append(r["tracked"])
    for mode, tracked in by_mode.items():
        s = sorted(tracked)
        med = (s[(len(s) - 1) // 2] + s[len(s) // 2]) / 2
        lines.append(f"{mode}: tracked {tracked}, median {med}, under the gate ({gate}) "
                     f"{sum(t < gate for t in tracked)} of {len(tracked)}")
    if len(by_mode) == 2:
        try:
            from scipy.stats import mannwhitneyu
        except ImportError:
            lines.append("Mann-Whitney U: scipy not installed")
        else:
            a, b = by_mode.values()
            lines.append(f"Mann-Whitney U of {' vs '.join(by_mode)}: "
                         f"p = {mannwhitneyu(a, b).pvalue:.4f}")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="+", choices=["k5", "plain"], default=["k5", "plain"])
    ap.add_argument("--perms", nargs="+", default=["id"])
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "revisit_orderings"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=0, help="only the first N frames")
    ap.add_argument("--mode", help=argparse.SUPPRESS)
    ap.add_argument("--perm", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.json:
        return _one(a)
    for p in a.perms:
        if p != "id" and not p.isdigit():
            ap.error(f"--perms: 'id' or a whole number, not {p!r}")
    os.makedirs(a.out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def run(job):
        mode, perm = job
        out = os.path.join(a.out, f"{mode}_{perm}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--mode", mode, "--perm", perm,
               "--json", out, "--device", a.device, "--frames", str(a.frames),
               *(["--diag"] if a.diag else [])]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        if proc.returncode:
            print(f"{mode} perm {perm}: exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
            return None
        with open(out) as f:
            r = json.load(f)
        print(f"{mode} perm {perm}: tracked {r['tracked']} lost {r['lost']} keyframes "
              f"{r['keyframes']} loop events {r['loop_events']} {r['seconds']:.1f} s", flush=True)
        return r

    jobs = [(m, p) for p in a.perms for m in a.modes]
    with ThreadPoolExecutor(max(1, a.jobs)) as pool:
        results = [r for r in pool.map(run, jobs) if r is not None]
    sys.path.insert(0, ROOT)
    import chip_smoke

    for line in _summary(results, chip_smoke.JAX_CPU_TRACKED_REVISIT - 2):
        print(line)
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())
    return 0 if len(results) == len(jobs) else 1


if __name__ == "__main__":
    sys.exit(main())
