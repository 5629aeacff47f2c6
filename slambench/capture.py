"""What decides ``correct``: samples of the timed path's own outputs,
taken while the window runs, and the plain reference's answers to the
same questions, worked out once the window has closed.

The timed path is wrapped at run time from this file (the program is not
edited).  A sample drawn from the seed is kept of each of:

- ORB extraction (K1, orientation, descriptors) of whole frames: the
  reference extracts the benchmark's own image again;
- stereo matching of whole frames: the reference extracts both images
  again and matches them;
- the K2 searches (motion model, local map, widening) and the K3 searches
  (triangulation, fusion): the reference runs the plain search on the
  inputs the program handed the kernel;
- pose optimisation: the reference solves the same problem in float64
  from the program's observations and initial pose;
- the first step of each local BA (K4, the camera reduction and the
  Schur complement, the camera solve, the points' back-substitution):
  the reference assembles the reduced camera system of the same step in
  float64 from the problem the program built, and the program's system,
  as it hands it to the camera solve, is judged against it; the
  program's camera step is judged by its residual in that system, and
  its point step by the residual of the points' rows of the float64
  step equations at the program's camera step; and the state the BA
  returns must have moved wherever that first step lowers the float64
  cost.

The last three follow the program step by step from its own state (the
map, the matches); the start (extraction, from the raw images) is
checked on its own.  Of the whole run, the harness compares the frames
lost (none may be) and reports the trajectory's error against the
generator's ground truth beside the checks.  Nothing here imports the
program: the hooks find its modules through ``modules``, which the
harness passes in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import ba as ref_ba
from .reference import extractor as ref_extractor
from .reference import hamming as ref_hamming
from .reference import pose as ref_pose
from .reference import se3 as ref_se3
from .reference import stereo as ref_stereo
from .reference.camera import CameraIntrinsics

# Sampling: the window frames whose extraction and stereo match are
# kept (drawn among the first FRAME_SPAN of the window, which every run
# reaches), and per call the share kept after the window's first call,
# which is always kept, and the most kept per run.
FRAME_SPAN = 16
FRAMES_KEPT = 3
CALLS = {"pose": (0.1, 12), "k2": (0.05, 6), "k3": (0.3, 4), "ba": (0.5, 3)}
FEAT_FIELDS = ("uv", "octave", "desc", "valid")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x)) if hasattr(x, "_fields") else tuple(
            _clone(v) for v in x)
    return x


class Capture:
    """Installs the sampling hooks on the program's modules and keeps
    what they took.  ``frame`` is the index of the frame being tracked
    (set by the harness); hooks keep nothing while ``active`` is false."""

    def __init__(self, seed: int, window_start: int):
        self.rng = np.random.default_rng([seed % 2**63, 1])
        self.frames = set(int(window_start + j) for j in
                          self.rng.choice(FRAME_SPAN, FRAMES_KEPT, replace=False))
        self.frame = -1
        self.active = False
        self.kept = {k: [] for k in ("extract", "stereo", "pose", "k2", "k3", "ba")}
        self._extract_side = {}
        self._ba_open = None
        self._undo = []

    def _take(self, kind: str) -> bool:
        if not self.active:
            return False
        p, cap = CALLS[kind]
        kept = len(self.kept[kind])
        return kept < cap and (kept == 0 or self.rng.random() < p)

    def _patch(self, mod, name, make):
        orig = getattr(mod, name)
        setattr(mod, name, make(orig))
        self._undo.append((mod, name, orig))

    def uninstall(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()

    def install(self, modules):
        """``modules``: the program's modules by their name in the package
        (``slam.tracking``, ``slam.pipeline``, ``slam.system``,
        ``slam.matchers``, ``slam.triangulate``, ``optim.schur``)."""
        cap = self

        def extract(orig, with_pyr):
            def f(image, *a, **kw):
                out = orig(image, *a, **kw)
                if cap.active and cap.frame in cap.frames:
                    side = cap._extract_side.get(cap.frame, 0)
                    cap._extract_side[cap.frame] = side + 1
                    feats = out[0] if with_pyr else out
                    cap.kept["extract"].append(dict(
                        frame=cap.frame, side=side,
                        feats={k: _clone(getattr(feats, k)) for k in FEAT_FIELDS}))
                return out
            return f

        def stereo(orig):
            def f(fl, fr, pl, pr, cam, *a, **kw):
                out = orig(fl, fr, pl, pr, cam, *a, **kw)
                if cap.active and cap.frame in cap.frames:
                    cap.kept["stereo"].append(dict(
                        frame=cap.frame, wrap_level0=bool(kw.get("wrap_level0", False)),
                        right_u=_clone(out.right_u), depth=_clone(out.depth)))
                return out
            return f

        def pose(orig):
            def f(cam, T_init, obs, *a, **kw):
                take = cap._take("pose")
                if take:
                    args = (_clone(T_init), _clone(obs), a, dict(kw))
                out = orig(cam, T_init, obs, *a, **kw)
                if take:
                    cap.kept["pose"].append(dict(args=args, T=_clone(out[0]),
                                                 inlier=_clone(out[1])))
                return out
            return f

        def k2(orig):
            def f(desc_a, attr_a, desc_b, attr_b, check_ur=False):
                take = cap._take("k2")
                out = orig(desc_a, attr_a, desc_b, attr_b, check_ur)
                if take:
                    cap.kept["k2"].append(dict(
                        args=_clone((desc_a, attr_a, desc_b, attr_b)), check_ur=check_ur,
                        out=_clone(tuple(out[0]) + tuple(out[1]))))
                return out
            return f

        def k3(orig):
            def f(desc_a, attr_a, desc_b, attr_b, mode="proj"):
                take = cap._take("k3")
                out = orig(desc_a, attr_a, desc_b, attr_b, mode)
                if take:
                    cap.kept["k3"].append(dict(
                        args=_clone((desc_a, attr_a, desc_b, attr_b)), mode=mode,
                        out=_clone(tuple(out))))
                return out
            return f

        def lm_solve(orig):
            def f(cam, prob, iters, use_huber, active, lam0=1e-4, group=None):
                rec = None
                if cap._take("ba"):
                    rec = dict(prob=_clone(tuple(prob)), use_huber=bool(use_huber),
                               active=_clone(active), lam=float(lam0))
                    cap._ba_open = rec
                try:
                    out = orig(cam, prob, iters, use_huber, active, lam0, group)
                finally:
                    cap._ba_open = None
                if rec is not None:
                    rec["out"] = _clone((out[0], out[1]))
                    cap.kept["ba"].append(rec)
                return out
            return f

        # Of the first step only: the system the camera solve is handed
        # and the camera step it returns, then the point step.
        def camera_step(orig):
            def f(prob, Hcc, S_off, bs, lam, solve):
                out = orig(prob, Hcc, S_off, bs, lam, solve)
                rec = cap._ba_open
                if rec is not None and "system" not in rec:
                    rec["system"] = _clone((Hcc, S_off, bs, lam))
                    rec["dxc"] = _clone(out[0])
                return out
            return f

        def sanitize(orig):
            def f(d):
                out = orig(d)
                rec = cap._ba_open
                if (rec is not None and "dxc" in rec and "dxp" not in rec
                        and out.shape[-1] == 3):
                    rec["dxp"] = _clone(out)
                return out
            return f

        tr, pl, sy = modules["slam.tracking"], modules["slam.pipeline"], modules["slam.system"]
        for mod in (tr, pl):
            self._patch(mod, "extract_orb", lambda o: extract(o, False))
            self._patch(mod, "_extract_orb_pyramid", lambda o: extract(o, True))
            self._patch(mod, "stereo_match", stereo)
        for mod in (tr, pl, sy):
            self._patch(mod, "optimize_pose", pose)
        self._patch(modules["slam.matchers"], "proj_best2", k2)
        self._patch(modules["slam.triangulate"], "pair_best2", k3)
        self._patch(modules["optim.schur"], "lm_solve", lm_solve)
        self._patch(modules["optim.schur"], "_camera_step", camera_step)
        self._patch(modules["optim.schur"], "_sanitize", sanitize)


# ----------------------------------------------------------------------
# the reference's answers and the numbers compared
# ----------------------------------------------------------------------
def _camera(cfg: dict, device, dtype) -> CameraIntrinsics:
    c = cfg["camera"]
    return CameraIntrinsics.create(
        c["fx"], c["fy"], c["cx"], c["cy"], c.get("k1", 0.0), c.get("k2", 0.0),
        c.get("p1", 0.0), c.get("p2", 0.0), c.get("k3", 0.0), c["bf"], c["width"], c["height"],
        device=device, dtype=dtype)


def _extract_kw(cfg: dict, capacity: int) -> dict:
    o, c = cfg["orb"], cfg["camera"]
    return dict(
        n_features=o["n_features"], capacity=capacity, n_levels=o["n_levels"],
        scale_factor=o["scale_factor"], th_high=o["ini_th_fast"], th_low=o["min_th_fast"],
        has_distortion=any(abs(c.get(k, 0.0)) > 0 for k in ("k1", "k2", "p1", "p2", "k3")),
        subpixel=o.get("subpixel", True))


def _feats_differ(prog: dict, ref) -> torch.Tensor:
    """(N,) bool: keypoint slots where the program's features differ from
    the reference's (validity; or, for a valid slot, octave, descriptor,
    or position by more than 1e-3 px)."""
    valid = ref.valid
    bad = prog["valid"] != valid
    same = ((prog["octave"] == ref.octave)
            & (prog["desc"] == ref.desc).all(-1)
            & ((prog["uv"] - ref.uv).abs().amax(-1) <= 1e-3))
    return bad | (valid & ~same)


def _centre(T: torch.Tensor) -> torch.Tensor:
    T = T.to(torch.float64)
    return -T[:3, :3].T @ T[:3, 3]


def compare(kept: dict, stream, cfg: dict, capacity: int, device, diag=None) -> dict:
    """The sampled numbers: worst over the samples of each kind, or None
    where the run kept none of that kind.  ``diag``, a dict, receives
    readings that are not compared: ``pose_gap_worst_m``, the widest
    pose gap among the solves whose inlier set equals float64's, and
    ``ba_point_error_zero_step``, what ``ba_point_error`` would read with
    the points' step left at zero (the least over the samples)."""
    diag = {} if diag is None else diag
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    cam32 = _camera(cfg, device, torch.float32)
    kw = _extract_kw(cfg, capacity)
    ref_feats = {}

    def ref_extract(frame, side):
        key = (frame, side)
        if key not in ref_feats:
            img = torch.from_numpy(np.ascontiguousarray(stream.frame(frame)[1 + side])).to(device)
            ref_feats[key] = ref_extractor._extract_orb_pyramid(img, cam32, **kw)
        return ref_feats[key]

    with torch.no_grad():
        if kept["extract"]:
            bad = tot = 0
            for rec in kept["extract"]:
                ref, _ = ref_extract(rec["frame"], rec["side"])
                d = _feats_differ(rec["feats"], ref)
                bad += int(d.sum())
                tot += int((ref.valid | rec["feats"]["valid"]).sum())
            out["extract_mismatch"] = bad / max(tot, 1)
        if kept["stereo"]:
            bad = tot = 0
            o = cfg["orb"]
            for rec in kept["stereo"]:
                fl, pl = ref_extract(rec["frame"], 0)
                fr, pr = ref_extract(rec["frame"], 1)
                ref = ref_stereo.stereo_match(fl, fr, pl, pr, cam32, o["n_levels"],
                                              o["scale_factor"], wrap_level0=rec["wrap_level0"])
                d = ((rec["right_u"] - ref.right_u).abs() > 1e-3) | (
                    (rec["depth"] - ref.depth).abs() > 1e-4)
                bad += int((d & fl.valid).sum())
                tot += int(fl.valid.sum())
            out["stereo_mismatch"] = bad / max(tot, 1)
        if kept["k2"]:
            bad = 0
            for rec in kept["k2"]:
                narrow, wide = ref_hamming.proj_best2_plain(*rec["args"], rec["check_ur"])
                bad += sum(int((a != b).sum()) for a, b in zip(rec["out"], (*narrow, *wide)))
            out["k2_mismatch"] = bad
        if kept["k3"]:
            out["k3_mismatch"] = sum(
                sum(int((a != b).sum()) for a, b in zip(
                    rec["out"], ref_hamming.pair_best2_plain(*rec["args"], rec["mode"])))
                for rec in kept["k3"])
        if kept["pose"]:
            cam64 = _camera(cfg, device, torch.float64)
            min_inliers = cfg["tracking"].get("min_matches_motion", 10)
            gaps, stable = [], []
            for rec in kept["pose"]:
                T0, obs, a, kwargs = rec["args"]
                obs64 = ref_pose.PoseObservations(
                    obs.p_w.double(), obs.obs_uvr.double(), obs.inv_sigma2.double(),
                    obs.has_stereo, obs.valid)
                T_ref, inlier_ref, n_ref = ref_pose.optimize_pose(cam64, T0.double(), obs64, *a,
                                                                  **kwargs)
                if int(n_ref) >= min_inliers:
                    g = float(torch.linalg.norm(_centre(rec["T"]) - _centre(T_ref)))
                    gaps.append(g)
                    # A solve whose inlier set differs from float64's flipped
                    # an observation at the chi2 threshold: its gap is that
                    # flip's, not the solver's.
                    if torch.equal(rec["inlier"], inlier_ref):
                        stable.append(g)
            if gaps:
                out["pose_gap_m"] = float(np.median(gaps))
            if stable:
                # Not compared: its tail reaches within 6x of the control.
                diag["pose_gap_worst_m"] = max(stable)
        if kept["ba"]:
            cam64 = _camera(cfg, device, torch.float64)
            sys_gap, step_err, point_err, unmoved = [], [], [], 0
            for rec in kept["ba"]:
                if "dxp" not in rec:
                    continue
                (T, fixed, cvalid, p, pvalid, ocam, ouvr, ois2, ostereo, ovalid) = rec["prob"]
                lam = rec["lam"]
                T64, p64 = T.double(), p.double()
                obs = (ocam, ouvr.double(), ois2.double(), ostereo, ovalid, pvalid, rec["active"])
                Hcc_r, S_off_r, bs_r, bs_abs = ref_ba.reduced_system(
                    cam64, T64, p64, *obs, rec["use_huber"], lam)
                free = cvalid & ~fixed
                fm = free.double()[:, None]
                M, b = ref_ba.camera_system(Hcc_r, S_off_r, bs_r, lam, free)
                M = 0.5 * (M + M.T)
                # bs is a gradient, which cancels near a minimum: its error
                # is judged against the sum of its terms' sizes.
                b_scale = torch.linalg.norm(bs_abs * fm)
                Hcc, S_off, bs, lam_p = rec["system"]
                Mp, bp = ref_ba.camera_system(Hcc.double(), S_off.double(), bs.double(),
                                              float(lam_p), free)
                sys_gap.append(max(float(torch.linalg.norm(Mp - M) / torch.linalg.norm(M)),
                                   float(torch.linalg.norm(bp - b) / b_scale)))
                # The camera solve: the program's step in its own system
                # (dx = -x for M x = b; a step left at zero reads 1).
                dxc, dxp = rec["dxc"].double(), rec["dxp"].double()
                step_err.append(float(torch.linalg.norm(Mp @ (-dxc.reshape(-1)) - bp)
                                      / torch.linalg.norm(bp)))
                # The back-substitution: the points' rows of the float64
                # step equations at the program's camera step.
                ne = ref_ba.normal_equations(cam64, T64, p64, *obs, rec["use_huber"])
                camc = torch.clamp(ocam.to(torch.int64), 0, T.shape[0] - 1)
                rn, sn = ref_ba.point_residual(ne, lam, pvalid, camc, dxc, dxp)
                point_err.append(float(rn / sn))
                rz, sz = ref_ba.point_residual(ne, lam, pvalid, camc, dxc, torch.zeros_like(dxp))
                diag["ba_point_error_zero_step"] = min(
                    float(rz / sz), diag.get("ba_point_error_zero_step", math.inf))
                # The state returned: a first step that lowers the float64
                # cost clearly is accepted, so the state has to move.
                T1 = torch.where(free[:, None, None], ref_se3.se3_exp(dxc) @ T64, T64)
                p1 = torch.where(pvalid[:, None], p64 + dxp, p64)
                c0 = float(ref_ba.cost(cam64, T64, p64, *obs, rec["use_huber"]))
                c1 = float(ref_ba.cost(cam64, T1, p1, *obs, rec["use_huber"]))
                T_out, p_out = rec["out"]
                if c1 < c0 * (1.0 - 1e-3) and torch.equal(T_out, T) and torch.equal(p_out, p):
                    unmoved += 1
            if sys_gap:
                out["ba_system_gap"] = max(sys_gap)
                out["ba_step_error"] = max(step_err)
                out["ba_point_error"] = max(point_err)
                out["ba_unmoved"] = unmoved
    return out


def trajectory_numbers(traj_path: str, stream, lost: int) -> dict:
    """ATE of every frame the program tracked against the generator's
    ground truth, after the rigid alignment of the two (the TUM
    benchmark's ATE), and the frames it lost.  Reported beside the
    checks and not compared: the trajectory of a SLAM run spreads from
    seed to seed by more than the precision control moves it."""
    est, gt = [], []
    with open(traj_path) as f:
        for line in f:
            v = line.split()
            if len(v) != 8:
                continue
            k = int(round(float(v[0]) * stream.fps))
            T = stream.pose(k)
            est.append([float(x) for x in v[1:4]])
            gt.append(-T[:3, :3].T @ T[:3, 3])
    est, gt = np.asarray(est), np.asarray(gt)
    out = {"lost_frames": lost}
    if len(est) >= 3:
        me, mg = est.mean(0), gt.mean(0)
        U, _, Vt = np.linalg.svd((gt - mg).T @ (est - me))
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        R = U @ D @ Vt
        res = gt - (est - me) @ R.T - mg
        out["ate_rmse_m"] = float(np.sqrt(np.mean(np.sum(res * res, axis=1))))
    return out
