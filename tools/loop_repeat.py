#!/usr/bin/env python3
"""Does loop closing on the card give the same result twice?

    python3 tools/loop_repeat.py [--root DIR]

Run on a CUDA machine.  Imports ``ydorbslam_tpu_torch`` from DIR (by
default this checkout; e.g. the parent commit, unpacked with ``git
archive`` into a git-ignored directory), and this checkout's
``bench.py``, ``chip_smoke.py`` (the configuration, the stress graph's
size) and ``testing.py`` (the stress graph), loaded by path.

First it runs the essential graph's former assembly (six float32
``index_add_`` calls, kept here as a copy and used nowhere else) and the
package's ``optimize_pose_graph`` twice each on ``chip_smoke.py``'s seeded
stress graph (``testing.pose_graph_problem``), and prints whether each
pair of runs is bit-equal.

Then it tracks ``bench.make_revisit_frames()`` (``chip_smoke.py`` phase
13's workload and configuration) through two fresh ``SlamSystem``s with
mapping and loop closing on, one after the other in this process, and
shuts each down.  For each run it prints the loop verifications, the
frame after which the first loop closed, the loops closed, the tracked
frames, the TUM-file ATE and a digest of every tracked pose and every
keyframe pose, all as exact bits; then whether the two runs agree and,
if not, the first frame whose tracked pose differs.  If they differ, a
third run goes under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and prints each operation PyTorch reports as
nondeterministic, with the line that called it.  The card's name and
power limit end the output.
"""
import argparse
import hashlib
import importlib.util
import os
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    """A module of this checkout, loaded by path (not from DIR)."""
    spec = importlib.util.spec_from_file_location(
        "_loop_repeat_" + os.path.basename(name)[:-3], os.path.join(HERE, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_optimize_pose_graph(prob, iters=20, fix_scale=False):
    """The essential graph as the port assembled it before: the normal
    equations summed with float32 ``index_add_``, which on CUDA adds with
    atomics in an order that changes from run to run."""
    import torch

    from ydorbslam_tpu_torch.geometry.sim3 import sim3_exp
    from ydorbslam_tpu_torch.optim.pose_graph import _edge_jacobians

    V = prob.S_iw.shape[0]
    dev = prob.S_iw.device
    ic = torch.clamp(prob.edge_i.to(torch.int64), 0, V - 1)
    jc = torch.clamp(prob.edge_j.to(torch.int64), 0, V - 1)
    w = (prob.edge_valid.to(torch.float32) * prob.edge_weight)[:, None, None]
    free = prob.vertex_valid & ~prob.fixed
    fm = free.to(torch.float32)
    ar = torch.arange(V, device=dev)
    eye7 = torch.eye(7, device=dev)
    S_all = prob.S_iw
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians(prob.edge_meas, S_all[ic], S_all[jc], fix_scale)
        Hij = w * torch.einsum("eci,ecj->eij", Ji, Jj)
        H_off = torch.zeros((V * V, 7, 7), device=dev)
        H_off.index_add_(0, ic * V + jc, Hij)
        H_off.index_add_(0, jc * V + ic, Hij.transpose(-1, -2))
        H_diag = torch.zeros((V, 7, 7), device=dev)
        H_diag.index_add_(0, ic, w * torch.einsum("eci,ecj->eij", Ji, Ji))
        H_diag.index_add_(0, jc, w * torch.einsum("eci,ecj->eij", Jj, Jj))
        b = torch.zeros((V, 7), device=dev)
        b.index_add_(0, ic, w[:, :, 0] * torch.einsum("eci,ec->ei", Ji, r))
        b.index_add_(0, jc, w[:, :, 0] * torch.einsum("eci,ec->ei", Jj, r))
        H = H_off.reshape(V, V, 7, 7)
        H[ar, ar] += H_diag
        H = H * fm[:, None, None, None] * fm[None, :, None, None]
        H[ar, ar] += torch.where(free, 1e-6, 1.0)[:, None, None] * eye7
        b = b * fm[:, None]
        Hd = H.permute(0, 2, 1, 3).reshape(V * 7, V * 7)
        dx = -torch.linalg.solve_ex(Hd, b.reshape(-1))[0].reshape(V, 7)
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], dim=-1)
        S_new = sim3_exp(dx) @ S_all
        S_all = torch.where(free[:, None, None], S_new, S_all)
    return S_all


def _revisit(frames, seq, smoke):
    """One fresh loop-closing run on the card at ``smoke._config()``: its
    counts, ATE and the bits of its poses."""
    import numpy as np
    import torch

    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu_torch.slam import loop_impl
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    system = SlamSystem(smoke._config(), Sensor.RGBD, enable_mapping=True,
                        enable_loop_closing=True, device="cuda")
    n_verify = [0]
    verify = loop_impl._verify_pack

    def counted(*args, **kwargs):
        n_verify[0] += 1
        return verify(*args, **kwargs)

    loop_impl._verify_pack = counted
    poses, oks, loop_frame = [], [], None
    t0 = time.perf_counter()
    try:
        for i, (t, gray, depth) in enumerate(frames):
            oks.append(bool(system.track_rgbd(t, gray, depth)))
            poses.append(system.tracker.T_cw.cpu().numpy().tobytes())
            if loop_frame is None and system.loop_closer.n_loops_closed:
                loop_frame = i
        system.shutdown()
        torch.cuda.synchronize()
    finally:
        loop_impl._verify_pack = verify
    secs = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos_tum, _ = read_tum_trajectory(path)
    gt = smoke._centres([seq.pose(i) for i in range(len(frames))])
    ate = ate_rmse(pos_tum, gt[[int(round(t * 30.0)) for t in ts]])
    kf = system.map.kf_pose.cpu().numpy()[system.map.kf_valid.cpu().numpy()]
    return dict(verifications=n_verify[0], loop_frame=loop_frame, tracked=sum(oks),
                loops=system.loop_closer.n_loops_closed, ate=float(ate),
                poses=hashlib.sha256(b"".join(poses)).hexdigest()[:16],
                keyframes=hashlib.sha256(np.ascontiguousarray(kf).tobytes()).hexdigest()[:16],
                per_frame=poses, seconds=secs)


def _show(label, r):
    print(f"{label}: verifications {r['verifications']}, first loop after frame "
          f"{r['loop_frame']}, loops {r['loops']}, tracked {r['tracked']}, ATE {r['ate']!r} m "
          f"({r['ate'].hex()}), tracked poses {r['poses']}, keyframe poses {r['keyframes']}, "
          f"{r['seconds']:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package runs")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tools/loop_repeat.py runs on a GPU")
    os.chdir(HERE)  # bench.py reads tests/ from here
    sys.path.insert(0, os.path.abspath(args.root))  # its ydorbslam_tpu_torch first
    bench, smoke = _load("bench.py"), _load("chip_smoke.py")
    pose_graph_problem = _load(os.path.join("ydorbslam_tpu_torch", "testing.py")).pose_graph_problem
    from ydorbslam_tpu_torch import _build
    from ydorbslam_tpu_torch.optim.pose_graph import PoseGraphProblem, optimize_pose_graph

    print(f"package: {os.path.dirname(os.path.dirname(_build.__file__))}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build()
    frames = bench.make_revisit_frames()
    from synthetic import OrbitDriftSequence  # bench put tests/ on sys.path

    seq = OrbitDriftSequence(np.random.default_rng(7), n_frames=smoke.N_CIRCUIT,
                             n_landmarks=1500, drift_rate=0.008)
    sd, _ = pose_graph_problem(np.random.default_rng(0), **smoke.STRESS_GRAPH)
    stress = PoseGraphProblem(**{k: torch.as_tensor(v).cuda() for k, v in sd.items()})
    for label, fn in (("former index_add_ assembly", _old_optimize_pose_graph),
                      ("the package's optimize_pose_graph", optimize_pose_graph)):
        a, b = (fn(stress, iters=20, fix_scale=True) for _ in range(2))
        torch.cuda.synchronize()
        print(f"stress graph ({stress.edge_i.shape[0]} edges, {stress.S_iw.shape[0]} keyframes), "
              f"{label}: two card runs {'bit-equal' if torch.equal(a, b) else 'DIFFERENT'}, "
              f"max difference {float((a - b).abs().max()):.3e}", flush=True)
    runs = [_revisit(frames, seq, smoke) for _ in range(2)]
    for k, r in enumerate(runs):
        _show(f"run {k + 1}", r)
    keys = ("verifications", "loop_frame", "tracked", "loops", "ate", "poses", "keyframes")
    same = all(runs[0][k] == runs[1][k] for k in keys)
    first = next((i for i, (a, b) in enumerate(zip(runs[0]["per_frame"], runs[1]["per_frame"]))
                  if a != b), None)
    print(f"the two runs are {'IDENTICAL' if same else 'DIFFERENT'}"
          + ("" if first is None else f"; tracked poses first differ at frame {first}"),
          flush=True)
    if not same:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                r3 = _revisit(frames, seq, smoke)
            finally:
                torch.use_deterministic_algorithms(False)
        _show("run 3, deterministic algorithms (warn only)", r3)
        sites = {}
        for w in seen:
            if "deterministic" in str(w.message):
                key = (f"{os.path.relpath(w.filename)}:{w.lineno}", str(w.message).split(".")[0])
                sites[key] = sites.get(key, 0) + 1
        print("nondeterministic operations reported: " + ("; ".join(
            f"{site} {msg} (x{n})" for (site, msg), n in sorted(sites.items())) or "none"),
            flush=True)

    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
