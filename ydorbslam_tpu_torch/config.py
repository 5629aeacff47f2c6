"""Typed configuration with OpenCV-FileStorage-YAML ingestion.

The reference reads its settings through ``cv::FileStorage``
(src/system.cpp:30, src/tracking.cpp:14-67, src/viewer.cpp:32-35).  For
dataset compatibility we ingest the exact same key set from the same
YAML files (TUM1.yaml etc.), but hold everything in a frozen dataclass
so the rest of the framework is explicit about which knob it reads.

Every behavioral constant of the reference pipeline (SURVEY.md §3 cheat
sheet) is centralized here so parity can be audited in one place.

A copy of ``ydorbslam_tpu/config.py`` (numpy-only), except that
``camera_intrinsics`` builds the torch intrinsics on a given device.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class CameraConfig:
    """Keys: Camera.fx/fy/cx/cy, LeftCamera.k1..k3/p1/p2, Camera.bf,
    Camera.fps, Camera.width/height (src/tracking.cpp:15-46)."""

    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    # Right-camera distortion (stereo); the reference reads RightCamera.*
    # but only ever undistorts left keypoints, right images are assumed
    # rectified (src/tracking.cpp:26-39).
    r_k1: float = 0.0
    r_k2: float = 0.0
    r_p1: float = 0.0
    r_p2: float = 0.0
    r_k3: float = 0.0
    bf: float = 40.0
    fps: float = 30.0
    width: int = 640
    height: int = 480
    # Camera.RGB channel-order flag (tracking.cpp:73).  True = decoded
    # channels are labeled correctly (PIL/PNG case — our loader's
    # input); False = files carry OpenCV-BGR-swapped channels, so the
    # grayscale luma weights swap (io/tum.load_image_gray).
    is_rgb: bool = True


@dataclass(frozen=True)
class OrbConfig:
    """Keys: ORBextractor.* (src/tracking.cpp:48-54).

    ``n_features`` is rounded up to a multiple of 128 internally —
    fixed-capacity keypoint arrays are the core JAX-ification decision
    (lane-aligned for the VPU).
    """

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Sub-pixel corner refinement (ops/fast.fast_subpixel_offsets) — a
    # deliberate accuracy improvement over the reference's integer FAST
    # corners.  Default on; turn off to restore reference keypoint
    # cadence on robustness-sensitive workloads (docs/ACCURACY.md: on
    # warped_tum x6 the sharper matching changes the keyframe-decision
    # interplay).
    subpixel: bool = True


@dataclass(frozen=True)
class DepthConfig:
    """Keys: ThDepth, DepthMapFactor (src/tracking.cpp:56-67)."""

    th_depth: float = 40.0  # close/far point threshold in baseline units
    depth_map_factor: float = 5000.0  # TUM depth PNG scale


@dataclass(frozen=True)
class MatcherConfig:
    """Reference src/orbMatcher.cpp:7-9 and per-call ratio arguments
    (SURVEY.md §3 cheat sheet)."""

    th_high: int = 100
    th_low: int = 50
    histo_bins: int = 30
    ratio_ref_kf: float = 0.7
    ratio_reloc: float = 0.75
    ratio_local_map: float = 0.8
    ratio_triangulation: float = 0.6
    # (The reference also constructs matchers with nn-ratio 0.9 for the
    # motion-model search and 0.8 for fusion, but those two searches
    # never apply the ratio — see PARITY.md; no knob is kept for them.)


@dataclass(frozen=True)
class TrackingConfig:
    """Keyframe decision + tracking-success gates
    (src/tracking.cpp:402,486,543,630-636,740-796)."""

    min_matches_motion: int = 10
    min_matches_local_map: int = 30
    min_matches_after_reloc: int = 50
    # Stereo/depth map initialization requires > 500 keypoints
    # (tracking.cpp:337).
    min_init_depth_points: int = 500
    local_window_max_kf: int = 80
    kf_ref_ratio: float = 0.75
    kf_close_tracked_max: int = 100
    kf_close_untracked_min: int = 70
    min_close_seed_points: int = 100
    reloc_min_bow_matches: int = 15
    reloc_min_inliers: int = 50
    # Pipelined-mode adaptive drain: shrink the decision batch while a
    # drain reports a lost frame or an inlier collapse below half its
    # per-window peak (bounds keyframe-decision latency on
    # shrinking-overlap workloads; see SlamSystem._drain_batch).
    # DEFAULT OFF: on the warped x6 exploration benchmark the short-lag
    # bursts fire on ordinary view-change inlier dips and nearly double
    # the keyframe rate (33 vs 17), churning local-BA geometry — ATE
    # 0.22 m vs 0.11 m with the gate off; and on its target workload
    # (constant-rate orbit) the sync path remains the robust choice.
    stress_lag: bool = False


@dataclass(frozen=True)
class MappingConfig:
    """Local-mapping culling + triangulation gates
    (src/localMapping.cpp:90-108, :371-405)."""

    cull_found_ratio: float = 0.25
    cull_min_obs: int = 3
    kf_cull_redundancy: float = 0.9
    triangulation_neighbors: int = 10  # stereo: 10, per localMapping.cpp:114


@dataclass(frozen=True)
class LoopConfig:
    """Loop-closing gates (src/loopClosing.cpp:43,90,130-132,171,214)."""

    min_kfs_between_loops: int = 10
    covisibility_consistency_th: int = 3
    # Temporal wrong-pair guard (deviation, documented in PARITY.md):
    # the reference excludes loop candidates only through covisibility
    # connectivity (keyFrameDatabase.cpp:26-105), which a LOST stretch
    # defeats — two temporally adjacent keyframes separated by a
    # tracking loss are covisibility-disconnected and can close a
    # catastrophic false "loop" (observed r4: frame 120 -> 109,
    # ACCURACY.md).  Candidates whose source frame id is within this
    # many frames of the query are rejected at the database gate.
    min_frame_gap: int = 30
    min_bow_matches: int = 20
    min_sim3_inliers: int = 20
    min_total_matches: int = 40
    ransac_min_inliers: int = 20
    # Hypothesis budget of the vmapped Sim3 RANSAC — the batched
    # equivalent of the reference's maxIterations=300
    # (loopClosing.cpp:132; adaptive early termination from the 0.99
    # probability is meaningless for a fixed batch, see PARITY.md).
    ransac_max_iters: int = 256
    # Retrieval codebook (DBoW3 replacement): multi-bank LSH hashing
    # into n_banks * 2**bank_bits visual words (slam/retrieval.py).
    retrieval_banks: int = 4
    retrieval_bank_bits: int = 12


@dataclass(frozen=True)
class OptimConfig:
    """g2o-replacement LM settings (src/optimizer.cpp, SURVEY.md §3)."""

    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    pose_episodes: int = 4
    pose_iters_per_episode: int = 10
    local_ba_iters_1: int = 5
    local_ba_iters_2: int = 10
    global_ba_iters: int = 10
    essential_graph_iters: int = 20
    essential_min_covis_weight: int = 100
    sim3_iters: int = 5


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed array capacities — the static-shape budget of the whole
    system.  The reference's dynamic shared_ptr graphs become
    capacity-bounded SoA arrays with validity masks (SURVEY.md §7)."""

    max_keypoints: int = 1024  # padded n_features, multiple of 128
    max_keyframes: int = 512
    max_map_points: int = 65536
    max_obs_per_point: int = 32
    local_ba_window_kf: int = 64  # optimized covisibility window
    local_ba_fixed_kf: int = 32  # fixed observer cameras
    local_ba_max_points: int = 4096
    local_ba_obs: int = 16  # obs slots per point inside local BA (0 = all)
    global_ba_max_points: int = 32768  # global-BA point budget (logged when hit)
    global_ba_obs: int = 16  # obs slots per point inside global BA
    tracking_points: int = 8192  # local tracking map cap
    reloc_candidates: int = 8
    loop_candidates: int = 8
    ransac_batch: int = 256  # vmapped RANSAC hypotheses per round
    # Loop-closure searchAndFuse windows (loopClosing.cpp:311,339-352):
    # the loop-side point set and the corrected-group keyframe targets
    # are capacity-capped like every other window in the system
    # (strongest-covisibility first; overflow never silent — the
    # correction logs when the group exceeds the cap).
    loop_fuse_points: int = 4096
    loop_fuse_group: int = 16


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)

    @property
    def n_keypoints(self) -> int:
        """n_features rounded up to a lane-aligned capacity."""
        n = self.orb.n_features
        return max(128, -(-n // 128) * 128)


def _parse_opencv_yaml(text: str) -> dict:
    """Parse an OpenCV FileStorage YAML into a flat {key: value} dict.

    cv::FileStorage files start with a ``%YAML:1.0`` directive that
    PyYAML rejects, and use flat dotted keys (``Camera.fx: 517.3``).
    We parse the flat scalar keys directly — that covers the reference's
    whole key set (src/tracking.cpp:15-67)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].rstrip()
        m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip().strip('"')
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def load_config(yaml_path: str, base: Optional[SlamConfig] = None) -> SlamConfig:
    """Build a SlamConfig from a reference-format YAML file.

    Reads the exact key set the reference reads (src/tracking.cpp:15-67),
    leaving unlisted knobs at their defaults.
    """
    with open(yaml_path) as f:
        kv = _parse_opencv_yaml(f.read())
    cfg = base or SlamConfig()

    def get(k, default):
        v = kv.get(k, default)
        if isinstance(v, str) and not isinstance(default, (str, type(None))):
            raise ValueError(
                f"{yaml_path}: key '{k}' has non-numeric value '{v}'"
            )
        return v

    cam = cfg.camera
    camera = dataclasses.replace(
        cam,
        fx=float(get("Camera.fx", cam.fx)),
        fy=float(get("Camera.fy", cam.fy)),
        cx=float(get("Camera.cx", cam.cx)),
        cy=float(get("Camera.cy", cam.cy)),
        k1=float(get("LeftCamera.k1", get("Camera.k1", cam.k1))),
        k2=float(get("LeftCamera.k2", get("Camera.k2", cam.k2))),
        p1=float(get("LeftCamera.p1", get("Camera.p1", cam.p1))),
        p2=float(get("LeftCamera.p2", get("Camera.p2", cam.p2))),
        k3=float(get("LeftCamera.k3", get("Camera.k3", cam.k3))),
        r_k1=float(get("RightCamera.k1", cam.r_k1)),
        r_k2=float(get("RightCamera.k2", cam.r_k2)),
        r_p1=float(get("RightCamera.p1", cam.r_p1)),
        r_p2=float(get("RightCamera.p2", cam.r_p2)),
        r_k3=float(get("RightCamera.k3", cam.r_k3)),
        bf=float(get("Camera.bf", cam.bf)),
        fps=float(get("Camera.fps", cam.fps) or 30.0),
        width=int(get("Camera.width", cam.width)),
        height=int(get("Camera.height", cam.height)),
        is_rgb=bool(get("Camera.RGB", int(cam.is_rgb))),
    )
    orb = dataclasses.replace(
        cfg.orb,
        n_features=int(get("ORBextractor.nFeatures", cfg.orb.n_features)),
        scale_factor=float(get("ORBextractor.scaleFactor", cfg.orb.scale_factor)),
        n_levels=int(get("ORBextractor.nLevels", cfg.orb.n_levels)),
        ini_th_fast=int(get("ORBextractor.iniThFAST", cfg.orb.ini_th_fast)),
        min_th_fast=int(get("ORBextractor.minThFAST", cfg.orb.min_th_fast)),
    )
    depth = dataclasses.replace(
        cfg.depth,
        th_depth=float(get("ThDepth", cfg.depth.th_depth)),
        depth_map_factor=float(get("DepthMapFactor", cfg.depth.depth_map_factor)),
    )
    return dataclasses.replace(cfg, camera=camera, orb=orb, depth=depth)


def camera_intrinsics(cfg: SlamConfig, device):
    """Materialize the torch-side CameraIntrinsics on ``device``."""
    from .geometry.camera import CameraIntrinsics

    c = cfg.camera
    return CameraIntrinsics.create(
        c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2, c.k3, c.bf,
        c.width, c.height, device=device,
    )
