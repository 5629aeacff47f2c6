#!/usr/bin/env python3
"""Evidence for the port's open faults F1 and F2 (ROADMAP Queue 3), on a CPU.

    JAX_PLATFORMS=cpu python3 tools/kf_decision_trace.py --pkg jax  --out jax.json
    JAX_PLATFORMS=cpu python3 tools/kf_decision_trace.py --pkg port --out port.json [--reloc]
    python3 tools/kf_decision_trace.py --pkg port --device cuda --out card.json
    python3 tools/kf_decision_trace.py --compare jax.json port.json

F1: either package (``--pkg``; the port on ``--device``) tracks ``bench.make_frames()`` (120
frames, mapping on, loop closing off, the capacities of
``chip_smoke._config()``) and writes, for every keyframe decision, the
frame, the keyframe count, the reference keyframe, ``ref_tracked``,
``n_in``, the tracked and untracked close counts and the decision.
``--compare`` prints the first frame whose inputs differ by more than a
count of 1 in any field, and the first whose decision differs.

F2 (``--reloc``, with ``--pkg port``): after the 120 frames the port
sees a blank frame (lost), then frame 40 again 200 s later, as
``chip_smoke.py`` phase 12 does.  The port's ``_relocalize`` runs on it,
and the JAX package's ``_relocalize`` runs on the same map, retrieval
index and frame features carried across to numpy.  For each it writes
the candidates, the pose LM inlier counts in call order, whether the
widening search ran, and the accepted keyframe.
"""
import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

FIELDS = ("n_keyframes", "ref_kf", "ref_tracked", "n_in", "tracked_close", "untracked_close")


def _jax_cfg():
    from ydorbslam_tpu.config import (
        CameraConfig, CapacityConfig, DepthConfig, OrbConfig, SlamConfig, TrackingConfig,
    )

    return SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640, height=480),
        orb=OrbConfig(n_features=1000), depth=DepthConfig(depth_map_factor=5000.0),
        capacity=CapacityConfig(max_keyframes=160, max_map_points=16384),
    )


def _trace(system, mod, frames):
    """Track ``frames``, recording the inputs of each keyframe decision."""
    rows = []
    orig = system._need_new_keyframe
    count = mod._count_ref_tracked
    params = mod.kf_decision_params

    def wrapped(feats, n_in):
        row = dict(frame=system.frame_id, n_keyframes=system.n_keyframes, ref_kf=int(system.ref_kf),
                   n_in=int(n_in))
        if system.n_keyframes > 0:
            min_obs, _ = params(system.n_keyframes, system.cfg.tracking.kf_ref_ratio)
            row["ref_tracked"] = int(count(system.map, system.ref_kf, min_obs))
            depth = np.asarray(feats.depth.cpu() if hasattr(feats.depth, "cpu") else feats.depth)
            mpid = system._frame_mpid
            mpid = np.asarray(mpid.cpu() if hasattr(mpid, "cpu") else mpid)
            close = (depth > 0) & (depth <= system.depth_threshold)
            row["tracked_close"] = int((close & (mpid >= 0)).sum())
            row["untracked_close"] = int((close & (mpid < 0)).sum())
        row["decision"] = bool(orig(feats, n_in))
        rows.append(row)
        return row["decision"]

    system._need_new_keyframe = wrapped
    for t, g, d in frames:
        system.track_rgbd(t, g, d)
    system._need_new_keyframe = orig
    return rows


def _reloc_outcome(system, mod, tracker, t, feats, cand_mod=None):
    """Run ``system._relocalize`` once, recording its candidates, LM
    inliers and widening calls (``cand_mod``: the module whose
    ``detect_candidates`` it calls, ``mod`` by default)."""
    out = dict(lm_inliers=[], widened=0)
    names = ("optimize_pose", "match_local_points", "detect_candidates")
    mods = (mod, mod, cand_mod or mod)
    saved = {n: getattr(m, n) for n, m in zip(names, mods)}

    def lm(*a, **k):
        res = saved["optimize_pose"](*a, **k)
        out["lm_inliers"].append(int(res[2]))
        return res

    def widen(*a, **k):
        out["widened"] += 1
        return saved["match_local_points"](*a, **k)

    def cands(*a, **k):
        res = saved["detect_candidates"](*a, **k)
        out["candidates"] = [int(i) for i in np.asarray(res[0].cpu() if hasattr(res[0], "cpu")
                                                        else res[0]) if i >= 0]
        return res

    for n, m, f in zip(names, mods, (lm, widen, cands)):
        setattr(m, n, f)
    try:
        ok = system._relocalize(tracker, t, feats)
    finally:
        for n, m in zip(names, mods):
            setattr(m, n, saved[n])
    out.update(ok=bool(ok), accepted=int(system.ref_kf) if ok else -1)
    return out


def run_jax(frames):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ydorbslam_tpu.slam import system as mod

    system = mod.SlamSystem(_jax_cfg(), mod.Sensor.RGBD, enable_mapping=True,
                            enable_loop_closing=False)
    return dict(rows=_trace(system, mod, frames))


def run_port(frames, reloc, out_path, device="cpu"):
    from chip_smoke import _config  # the same settings as _jax_cfg, without JAX
    from ydorbslam_tpu_torch.slam import system as mod

    system = mod.SlamSystem(_config(), mod.Sensor.RGBD, enable_mapping=True,
                            enable_loop_closing=False, device=device)
    out = dict(rows=_trace(system, mod, frames))
    if not reloc:
        return out
    with open(out_path, "w") as f:  # the trace is kept if the relocalization fails
        json.dump(out, f)
    h, w = frames[0][1].shape
    system.track_rgbd(frames[-1][0] + 1.0 / 30.0, np.zeros((h, w), np.uint8),
                      np.zeros((h, w), np.uint16))
    captured = {}
    hook = system.tracker.reloc_hook

    def capture(tracker, t, feats):
        from ydorbslam_tpu_torch.convert import map_state_to_numpy, retrieval_index_to_numpy

        captured.update(map=map_state_to_numpy(system.map),
                        index=retrieval_index_to_numpy(system.retrieval),
                        feats={k: v.numpy().view(np.uint32) if k == "desc" else v.numpy()
                               for k, v in feats._asdict().items()},
                        n_kf=system.n_keyframes, t=t, gen=system._reloc_gen.get_state())
        return _reloc_outcome(system, mod, tracker, t, feats)["ok"]

    system.tracker.reloc_hook = capture
    t, g, d = frames[40]
    system.track_rgbd(t + 200.0, g, d)
    system.tracker.reloc_hook = hook
    # The port's relocalization again, recorded, from the captured state.
    port = mod.SlamSystem(system.cfg, mod.Sensor.RGBD, enable_mapping=True,
                          enable_loop_closing=False, device="cpu")
    from ydorbslam_tpu_torch.convert import (
        features_from_numpy, map_state_from_numpy, retrieval_index_from_numpy,
    )

    port.map = map_state_from_numpy(captured["map"])
    port.retrieval = retrieval_index_from_numpy(captured["index"])
    port.n_keyframes = captured["n_kf"]
    port._reloc_gen.set_state(captured["gen"])
    out["port_reloc"] = _reloc_outcome(port, mod, port.tracker, captured["t"],
                                       features_from_numpy(captured["feats"]))
    out["port_reloc"]["map_keyframes"] = int(captured["map"]["kf_valid"].sum())
    out["port_reloc"]["map_points"] = int(captured["map"]["mp_valid"].sum())
    out["jax_reloc"] = _jax_reloc(captured)
    return out


def _jax_reloc(captured):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from ydorbslam_tpu.ops.extractor import FrameFeatures
    from ydorbslam_tpu.slam import retrieval
    from ydorbslam_tpu.slam import system as mod
    from ydorbslam_tpu.slam.map_state import MapState
    from ydorbslam_tpu.slam.retrieval import RetrievalIndex

    system = mod.SlamSystem(_jax_cfg(), mod.Sensor.RGBD, enable_mapping=True,
                            enable_loop_closing=False)
    system.map = MapState(**{k: jnp.asarray(v) for k, v in captured["map"].items()})
    system.retrieval = RetrievalIndex(**{k: jnp.asarray(v) for k, v in captured["index"].items()})
    system.n_keyframes = captured["n_kf"]
    feats = FrameFeatures(**{k: jnp.asarray(v) for k, v in captured["feats"].items()})
    return _reloc_outcome(system, mod, system.tracker, captured["t"], feats, retrieval)


def compare(path_a, path_b):
    a, b = (json.load(open(p)) for p in (path_a, path_b))
    ra = {r["frame"]: r for r in a["rows"]}
    rb = {r["frame"]: r for r in b["rows"]}
    first_input = first_decision = None
    for f in sorted(set(ra) & set(rb)):
        x, y = ra[f], rb[f]
        diff = {k: (x.get(k), y.get(k)) for k in FIELDS
                if x.get(k) is not None and y.get(k) is not None and abs(x[k] - y[k]) > 1}
        if diff and first_input is None:
            first_input = (f, diff)
        if x["decision"] != y["decision"] and first_decision is None:
            first_decision = (f, x, y)
    print(json.dumps(dict(frames_compared=len(set(ra) & set(rb)),
                          first_input_difference=first_input,
                          first_decision_difference=first_decision,
                          keyframes=(sum(r["decision"] for r in a["rows"]),
                                     sum(r["decision"] for r in b["rows"]))), default=str))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", choices=("jax", "port"))
    ap.add_argument("--out")
    ap.add_argument("--reloc", action="store_true")
    ap.add_argument("--device", default="cpu", help="the port's device (--pkg port)")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    import bench

    frames = bench.make_frames()
    out = (run_jax(frames) if args.pkg == "jax"
           else run_port(frames, args.reloc, args.out, args.device))
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))


if __name__ == "__main__":
    main()
