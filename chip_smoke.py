#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX.  Phases, each printing its line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles ``ydorbslam_tpu_torch/csrc/*.cu`` for sm_90a,
     one process per source, all started together;
  3. K1 (FAST-9 + NMS, all levels of a frame in one launch) against its
     plain PyTorch version: one launch on the 8 pyramid levels of
     ``bench.make_frames()`` frame 0, one on a random 480x640 image, one
     on ragged levels (1x1, 7x33, 33x7, 20x90: H < 2 x border), one on
     all 13 at once, and the ragged levels with frame 0's smallest at
     borders 0, 1 and 3: bit-identical, with device and wall ms per
     frame (8 levels) and the bound;
  4. K2 (gated Hamming best/second) against its plain version on the
     real frame 0 -> 1 search and on problems from ``proj_problem``
     (``ydorbslam_tpu_torch/testing.py``):
     random ones (the local-map search's 8192 x 1024 included), a
     tie-heavy one, one where no pair passes, one where exactly one
     column passes, and ragged shapes (M, N in 1, 31, 33, 777, and an N
     of three and a bit 512-column tiles), each with both ``check_ur``
     values: identical idx, best and second for both radii, with ms per
     call;
  5. the mapping-off path: ``SlamSystem(..., enable_mapping=False,
     device="cuda")`` tracks the first 60 frames; 0 lost frames,
     ATE < 0.02 m, K1 launched exactly once per frame, K2 counted;
  6. per-layer times (extraction, motion search, pose LM) inside a
     mapping-off tracking run of frames 0-39;
  7. parity: the first 20 frames again on the CPU (plain versions) with
     mapping off; the same lost pattern and camera centres within 1e-3 m;
  8. the main path: ``SlamSystem(..., enable_mapping=True,
     enable_loop_closing=False, device="cuda")`` tracks all 120 frames.
     It writes ``save_trajectory_tum`` to a temporary file and reads it
     back for the ATE.  Gates: 0 lost, ATE < 0.02 m and within 1.5x of the
     JAX package's CPU figure, more than 2 keyframes, K1 launched exactly
     once per frame, K2 at least twice per frame after the first, K3 3x
     and K4 17x per local BA.  It prints frames/s and the median ms/frame after 20
     warm-up frames, the keyframes inserted and culled, the live map
     points and the synchronised ms per ``mapping_step``.  The last K2
     input of each search (motion, local map), the last K3 input of each
     mode and the last K4 input are kept for phases 9 and 10;
  9. K2 and K3 on the real inputs of phase 8, and K3 on problems from
     ``pair_problem`` (random at B=20, M=N=1024 and ragged M=1000,
     N=777; tie-heavy, none and exactly one passing; ragged M, N in 1,
     31, 33, 777 and an N of three and a bit tiles), both modes:
     identical idx, best and second.  On the real inputs it prints the
     gated pairs (the basis of the bound) and ms per call of the kernel
     and of the plain version;
 10. K4 (BA observation pass) against its plain version on a real local-BA
     input captured in phase 8, on a random (32, 16, 4096) one from
     ``lm_obs_problem`` and on ragged ones (O in 1, 5, 17 by P in 1, 31,
     4097), both Huber settings: within rtol 2e-4, atol 2e-3, with the
     errors and ms per call; two launches on the real input give the same
     bits.  Then K5 (the pose-only LM in one launch) on phase 8's last
     pose solve (N = 1024) against its plain version: inlier sets equal
     or apart at the threshold only (at most 3), camera centres within
     1.5e-5 m where they agree, two launches bit-equal, one launch a
     call, with device and wall ms of both;
 11. parity with mapping on: the first 30 frames again on the CPU (the
     third keyframe and its local BA come at frame 26); the same lost
     pattern and keyframe insertions, and camera centres at track time
     within 1e-3 m;
 12. recovery on phase 8's card system (21 keyframes): a blank frame
     (uint8 gray and uint16 depth of zeros) must be lost, then frames
     40-59, 200 s later, must relocalize at the first of them and track
     the rest within 0.02 m of ground truth.  Each ``_relocalize`` call is
     timed between synchronisations, split into retrieval, appearance
     match (K2), RANSAC, pose LM and the widening search (K2), with its
     K2 launches.  The accepted relocalization runs again on a CPU
     ``SlamSystem`` from copies of the same map, index, frame features
     and generator state: the same candidates and accepted keyframe,
     inliers within 2, pose within 1e-4 m and 1e-4 rad.  Then
     ``activate_localization_mode()`` and frames 60-105: 0 lost, no
     keyframe or map point added, no K3 or K4 launch, no visual
     odometry, within 0.02 m of ground truth; it prints the median
     ms/frame and frames/s.  With 3 % of ``mp_valid`` kept (a seeded
     mask) frames 106-115 must track (>= 9) by visual odometry, and with
     the mask removed frames 116-119 drop the flag.  Last it prints what
     a (256, 4, 4) ``eigh``, a (256, 12, 12) and a (256, 3, 3) ``svd``, a
     retrieval ``add_keyframe`` and ``remove_keyframes`` cost per call
     (the last two also in device time from torch.profiler).
     Each path's launch counts are set to 0 just before it.
 13. loop closing on the card: a fresh ``SlamSystem(..., enable_mapping=True,
     enable_loop_closing=True, device="cuda")`` tracks
     ``bench.make_revisit_frames()`` (a 100-frame drifted orbit and a
     40-frame tail, 640x480, 1000 features, the capacities of phase 8)
     and then ``shutdown()``.  Gates: a loop closes after the revisit
     begins, with more than one cross-loop edge; the global BA finishes
     and merges; the best camera-centre error after the closure is under
     half the worst before it; the TUM-file ATE within 1.5x of the JAX
     package's CPU figure on the same workload, and the tracked frames at
     least its count less 2; the loop path's K2 launches are 2 per
     verified candidate and ``loop_fuse_group`` per correction, its K4
     launches 6 per global-BA chunk, 2 chunks per global BA; the host
     waits on the card (CUDA's sync debug mode) no more than ``SYNC_MAX``
     allows per call of each step (one read per poll, verification and
     correction, and a verification's two ``eigh`` checks).  It prints
     synchronised ms for detection per keyframe, verification,
     correction, the essential graph (assembly and solve), each global-BA
     chunk and the merge, the peak ``max_memory_allocated`` during global
     BA, and frames/s.  The accepted loop event runs again on a CPU
     ``SlamSystem`` from copies of the map, index, pending detection and
     generator state taken just before it: the same candidates and gate
     counts, S_12 within 1e-4 m and 1e-4 rad, corrected keyframe poses
     within 1e-3 m (global BA left out on the CPU).  The essential
     graph of that event (its ``PoseGraphProblem``, kept as the run made
     it) runs twice more on the card, bit-equal, and once on the CPU from
     copies, keyframe centres within 1e-3 m; a seeded stress graph
     (``testing.pose_graph_problem``: 160 keyframes, 2,000 edges with
     duplicate pairs, degrees of 20 and more) runs twice on the card,
     bit-equal and closer to its true poses; it prints the edge counts
     and the ms of each run.  Then K2 on the
     captured verification (1024 x 1024), guided (8192 x 1024) and fusion
     (4096 x 1024) inputs, identical to plain, and K4 on the captured
     global-BA input (32, 16, 16384) within rtol 2e-4, atol 2e-3, each
     with device ms and its bound.
 14. the stereo path on the card: ``SlamSystem(kitti00_config,
     Sensor.STEREO, enable_mapping=True, enable_loop_closing=False,
     device="cuda")`` tracks ``testing.make_stereo_frames(60)`` (rectified
     1241x376 pairs at the KITTI-00 camera, 2048 keypoint slots).  Gates:
     0 lost; the TUM-file ATE under 0.08 m and within 1.5x of the JAX
     package's CPU figure (``tools/jax_stereo_reference.py``); more than 2
     keyframes; K1 launched exactly twice per frame, K2 at least twice
     per frame after the first, K3 3x and K4 17x per local BA;
     ``stereo_match`` waits on the card 0 times on every frame (CUDA's
     sync debug mode); frame 0's ``stereo_match`` on the card against the
     port on the CPU on the same inputs (the same ok mask on >= 99 % of
     the keypoints, right_u within 1e-3 px where both are ok); the first
     10 frames again on a CPU ``SlamSystem`` (the same lost pattern and
     keyframes, camera centres within 1e-3 m); K1 on both images' last
     levels, K2 and K3 on their last inputs of the run identical to plain,
     K4 within rtol 2e-4, atol 2e-3, K5 on the last pose solve (N = 2048)
     as in phase 10, each with device ms and its bound.
     It prints frames/s and the median ms/frame after 10 warm-up frames,
     the synchronised ms of ``stereo_match`` and of the second
     extraction, keypoints and stereo depths per frame, keyframes and
     live points.

 15. the TUM runner at its default configuration: ``bench.make_frames()``
     is written to a temporary TUM directory (``testing.write_tum_sequence``:
     8-bit gray and 16-bit depth PNGs, assoc.txt, groundtruth.txt and a
     settings file of the rendering camera with TUM1.yaml's ORB and depth
     settings), and ``run_tum_rgbd.main`` runs on it in this process with
     ``--groundtruth``, ``--viz`` and ``--viewer-dir`` every 30 frames, at
     ``load_config``'s capacities (512 keyframe and 65,536 map-point
     slots, 32 observations per point) with loop closing on.  Gates: 0
     lost; the TUM-file ATE under 0.02 m and within 1.5x of the JAX
     package's own runner on the same directory on a CPU
     (``tools/jax_tum_reference.py``); keyframes inserted within
     ``TUM_KF_BAND`` of JAX's; the loops closed equal to JAX's; K1 launched
     exactly once per frame, K2 at least twice per frame after the first,
     K3 3x and K4 17x per local BA; the viewer's frame and map PNGs of
     frames 0, 30, 60 and 90 open, and ``maybe_draw`` waits on the card 0
     times on every frame it does not draw (CUDA's sync debug mode).  It
     prints frames/s and the median ms/frame after 20 warm-up frames, the
     synchronised ms per ``mapping_step`` at these capacities, the ms of
     each drawn frame and the peak memory.  Then a card system tracks
     frames 0-59, is saved with ``serialize.save_system``, loaded on the
     card and goes on with frames 60-119: the same keyframe and record
     counts after the load, the host's slot mask rebuilt, every map array
     bit-equal between the saved system, the card load and a CPU load of
     the same file, 0 lost, the ATE below max(2x the runner's, 0.03 m),
     every camera centre within 1e-3 m of the runner's run; it prints the
     file's size, the save and load ms and that largest difference.  Last,
     ``update_calibration`` with a settings file of fx 501 on a card
     system loaded from the same file: the new camera on the card in the
     system and the tracker, ``tracker.cfg`` unchanged, the next frame
     tracked.
 16. the exported helpers that have no kernel (geometry, Hamming, blur,
     empty features, ``remove_keyframe``): one card call each on seeded
     inputs against the port's own CPU result, integer and bool outputs
     identical, floats at the tolerances of ``tests/test_torch_api.py``
     (1e-5; ``se3_log`` near pi 1e-4; ``gaussian_blur`` 1e-3 absolute).
 17. the pipelined RGB-D path at bench.py's configuration and call
     sequence: ``chip_smoke._config()``, ``enable_pipelined(lag=16)``,
     ``precompile()``, then ``bench.make_frames()`` as ``bench.run``
     feeds them (20 warm-up frames, ``flush_pipeline``, the other 100,
     ``shutdown``), loop closing off.  Gates, against the JAX package's
     run on a CPU (``tools/jax_pipelined_reference.py``): frames 0-38
     (before the first drain that inserts a burst of keyframes) tracked,
     asking for and inserting keyframes as in JAX's trace, inliers within
     2; from frame 39 on, where the reference's outcome is a spread (see
     ``JAX_CPU_PIPE_LOST_MAX``), lost frames no more than JAX's most and
     the TUM-file ATE within 1.5x of JAX's largest under one-ulp nudges of
     the burst BA's input, every run of lost frames recovered by the
     relocalization of its drain (at most ``PIPE_LAG`` frames), the last
     frame tracked, keyframes within ``TUM_KF_BAND`` of JAX's; the burst's
     drain (its ``mapping_prep`` calls and deferred BA, captured on the
     card in the repeat run) again on the CPU from the card's inputs, call
     by call, at the bounds of ``BURST_GRAPH``'s comment;
     K1 exactly once and K2 exactly 3 times per frame (plus what a
     relocalization launches), K3 3x per ``mapping_prep`` and K4 17x per
     deferred local BA; a second run of frames 0-59 in the same call gives
     the same per-frame outcomes (the packed info rows) and insertions bit
     for bit, and in it the host waits on the card (CUDA's sync debug
     mode) 0 times in every frame's dispatch and no more than
     ``PIPE_SYNC_MAX`` in each part of a drain, each wait's call site
     printed; the first 30 frames again on a CPU ``SlamSystem``: the same
     lost frames and insertions, track-time camera centres within 1e-3 m.
     It prints frames/s as bench.py computes it (the dispatches of frames
     20-119 plus the final flush), the median dispatch and drain ms, each
     deferred BA's synchronised ms, the drains' ``drain.*`` spans per frame and the
     precompile seconds.
 18. the TUM runner with ``--pipelined`` (lag 16) on phase 15's directory
     at ``load_config``'s capacities with loop closing on, the launch
     counts set to 0 after its ``precompile()``.  Gates: 0 lost; the ATE
     under 0.02 m and within 1.5x of the JAX package's own runner with
     ``--pipelined`` on a CPU; keyframes within ``TUM_KF_BAND`` of JAX's;
     the loops closed equal to JAX's; K1 once and K2 at least 3 times per
     frame, K3 3x per ``mapping_prep``, K4 17x per deferred BA.
 19. the pipelined stereo path at the KITTI-00 configuration:
     ``SlamSystem(kitti00_config, Sensor.STEREO, enable_mapping=True,
     enable_loop_closing=False, device="cuda")``, ``enable_pipelined(lag=16)``,
     ``precompile()``, the uint8 pairs of ``testing.make_stereo_frames(60)``
     through ``track_stereo_pipelined``, ``shutdown()``.  Gates, against the
     JAX package's run on a CPU (``tools/jax_pipelined_stereo_reference.py``):
     0 lost; the TUM-file ATE under 0.08 m and within 1.5x of JAX's;
     keyframes within ``TUM_KF_BAND`` of JAX's; frames 0-37 (through the
     first drain that inserts more than one keyframe) tracked, asking for
     and inserting keyframes as in JAX's trace, inliers within 2; that
     drain's ``mapping_prep`` calls and deferred BA again on the CPU from
     the card's inputs, call by call, at the bounds of ``BURST_GRAPH``'s
     comment; K1 exactly twice and K2 exactly 3 times per frame (plus what
     a relocalization launches), K3 3x per ``mapping_prep``, K4 17x per
     deferred BA; a second run of frames 0-29 in the same call under CUDA's
     sync debug mode: 0 waits in every dispatch, each part of a drain within
     ``PIPE_SYNC_MAX``, the same packed info rows and insertions bit for
     bit; frame 0's pipelined ``stereo_match`` (with the level-0 wrap of a
     uint8 pair) against the port on the CPU from the same inputs (the ok
     mask on >= 99 % of the keypoints, right_u within 1e-3 px), with the
     count of octave-0 keypoints whose SAD costs the wrap changes; the
     first 10 frames pipelined on a CPU ``SlamSystem``: the same lost frames
     and insertions, track-time camera centres within 1e-3 m; K1 on both
     images' last levels and K2 on its last inputs identical to plain.  It
     prints frames/s over the dispatches of frames 10-59 and the final
     shutdown, the median dispatch and drain ms, each deferred BA's
     synchronised ms, the ``drain.*`` spans and the precompile seconds.
 20. the KITTI runner with ``--pipelined --lag 16 --poses`` in this process
     on ``testing.write_kitti_sequence`` of the same 60 pairs, at its own
     configuration (``SlamConfig()`` with ``calib.txt``'s camera, 1000
     features, 512 keyframe and 65,536 map-point slots, loop closing on), the
     launch counts set to 0 after its ``precompile()``.  Gates, against the
     JAX package's own runner with ``--pipelined`` on the same directory on
     a CPU: lost frames no more than JAX's; the ATE (at full precision, with
     the runners' pairing of the i-th written pose with the i-th
     ground-truth pose) within 1.5x of JAX's; the loops closed equal to
     JAX's; K1 exactly twice and K2 at least 3 times per frame, K3 3x per
     ``mapping_prep``, K4 at least 17x per deferred BA.
 21. the sharded paths (``parallel/``) on phase 13's first global BA as
     ``_start_global_ba`` armed it (C = 161, P = 16,384, O = 16) and its
     final map: (a) a world of one NCCL rank in this process, two
     point-sharded LM chunks (``_sharded_lm_chunk``) bit-equal to two
     ``_lm_chunk`` calls, K4 6x per chunk and nothing else launched, the
     keyframe-sharded detection on the last keyframe identical to
     ``_detect`` and ``score_all_sharded`` bit-equal to ``score_all``, with
     the synchronised ms of each chunk in both forms; (b) the TUM runner in
     a child process under the ``YDORBSLAM_*`` trio for a world of one
     (NCCL) on a 10-frame TUM directory: its ``distributed:`` line with
     ``process_count`` 1, 0 lost; (c) two gloo ranks spawned on the card
     (``parallel.launch.spawn_ranks``, ``testing.sharded_chunk_rank``): the
     same two chunks within 2e-4 (T) and 2e-3 (p) of (a)'s dense ones, both
     ranks' T and damping bit-equal, K4 6x per chunk per rank on
     (32, 16, 8192), rank 0's first K4 input held to plain within rtol
     2e-4, atol 2e-3 (a refusal of CUDA tensors by gloo is printed instead);
     (d) the same over NCCL with one rank per card when the machine has two
     cards or more, else a line saying it was not run.

Each phase from 12 on prints the seconds since the start when it ends.
Every path that tracks frames on the card (phases 5, 8, 12-15, 17-20)
also counts ``optimize_pose``'s calls (``_pose_calls``) and requires one
K5 launch per call and at least two calls a frame after the first (one
with mapping off, phase 5; after the relocalization in phase 12; in its
VO fallback, on the frames after the map is restored); the loop path of
phase 13 launches none.

Times per call are printed two ways (``ydorbslam_tpu_torch/testing.py``).
"wall" (``wall_ms``) is CUDA events around 20 back-to-back calls, so the
host's dispatch of each call is part of it.  "device" (``device_ms``)
holds the stream with a spin kernel (``torch.cuda._sleep``) while the
host enqueues the calls between the two events, so the events time the
card's own work back to back.

It prints one JSON line with every kernel's name, route, source, the
TPU kernel it replaces, launches in the main path (phase 8), in the
loop path of phase 13 (``loop_launches``), in the stereo path of
phase 14 (``stereo_launches``), in the TUM runner's run of phase 15
(``tum_launches``), in the pipelined path of phase 17
(``pipe_launches``), in the pipelined runner of phase 18
(``tum_pipe_launches``), in the pipelined stereo path of phase 19
(``stereo_pipe_launches``), in the pipelined KITTI runner of phase 20
(``kitti_pipe_launches``) and in phase 21's sharded chunks
(``parallel_launches``), max abs
error, device ms per call on the main path's input (K1: per frame of 8
levels, one launch) and that of the plain version, the bound on that
input (the larger of its bytes over 3.35 TB/s and its operations over
the H100's peak rate for them, see ``_bound``) and what binds it, and
the time of one PyTorch call computing the same function (null: there
is none); then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without the last line.  A gate that fails in
phases 1-12 stops the script; from phase 13 on, a failed phase prints
``phase N FAILED`` and the phases after it still run (phase 21 on phase
13's global BA, which phase 13 hands on even where its revisit gate
fails), and the script fails at the end, naming each failed phase.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

N_WARM = 20
N_OFF = 60  # frames of the mapping-off path
# The JAX package's ATE on the same 120 frames, synchronous RGB-D with
# mapping on and loop closing off, run on a CPU (PERF.md §5); the CUDA
# run must stay within 1.5x of it.
JAX_CPU_ATE_MAPPING = 0.001814043883989798
N_PAR_MAP = 30  # CPU parity frames with mapping on: keyframe 3 and its local BA at frame 26
K4_RTOL, K4_ATOL = 2e-4, 2e-3
N_JOIN = 10  # frames the TUM runner tracks in phase 21's world of one
# Phase 21 (c): the robust cost of two sharded global-BA chunks against the
# dense chunks', relative.  On phase 13's problem a mere reorder of the dense
# chunks' float32 sums (the points permuted) moves that cost by up to 2.2e-4,
# the poses by up to 2.2e-3 and a weakly held point by 0.8 m (PERF.md §6), so
# the two chunks' T and p are printed beside that spread, and one LM
# iteration carries the JAX package's 2e-4 (T) / 2e-3 (p).
COST_RTOL = 1e-3

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_S = 3.35e12
LANE_OPS_S = 33.5e12  # fp32/int32 lane operations outside the tensor cores (67 TFLOP/s counts an FMA as 2)
POPC_S = 16 * 132 * 1.98e9  # __popc: 16 per SM per clock (compute capability 9.0), 132 SMs, 1.98 GHz
# Lane operations per unit of work, counted from the kernels' formulas:
# subtractions, absolute values, multiplies, adds, min/max, compares and
# selects; the logic that combines predicates is not counted.
# K1, as csrc/fast_nms.cu computes it: per scored pixel (the border
# window grown by the NMS ring) 16 differences, two cyclic 9-arc
# max-min of 57 (arc9) and 2 to combine; per output in the window 5 max
# (the separable 3x3 over a thread's 6 rows), 1 compare and 1 select.
K1_SCORE_OPS = 132
K1_NMS_OPS = 7
K1_OPS_PX_TREE = 205  # the earlier count, per pixel of every level: the plain version's 79-op trees
K1_RAGGED = ((1, 1), (7, 33), (33, 7), (20, 90))
K2_GATE_OPS = {False: 11, True: 16}  # per pair, by check_ur
K3_GATE_OPS = {"proj": 18, "epi": 11}  # per pair, by mode
DIST_OPS = 15  # per popcounted pair: 8 XOR and 7 adds, beside its 8 __popc
UPDATE_OPS = 5  # per gated (pair, radius): compare, min, 3 selects
K4_OPS_OBS = 725  # per observation: projection, residuals, Huber weight, Jacobians, 72 weighted 3-term row sums, 13 accumulations
K4_ROWS_READ = 27  # input rows of the 32 that the observation pass reads
# K5, per valid observation: a normal-equation pass (projection, residuals,
# chi2, Jacobian rows scaled by the root weights, 21 + 6 three-term
# accumulations) and a classification pass; 31 bytes read once.
K5_OPS_PASS, K5_OPS_CLASSIFY, K5_BYTES_OBS = 160, 35, 31
# K5 against plain and float64 (_k5_check): the benchmark's limit on the
# camera-centre gap (slambench/limits, pose_gap_m); an inlier that flips sits
# at the threshold, its raw chi2 at the float64 pose within K5_FLIP_CHI2 of
# delta^2; with flips, the gap to float64 within K5_FLIP_GAP_M a flip (one
# threshold observation dropped moved float64's centre by up to 6.8e-4 m on
# testing.pose_problem at N = 1024 and 2048, seeds 0-5).
POSE_GAP_M, K5_FLIP_CHI2, K5_FLIP_GAP_M = 1.5e-5, 0.05, 1e-3
# Phase 12: the frames of each recovery path, replayed T_SHIFT s later.
KIDNAP_REPLAY = range(40, 60)
LOC_FRAMES = range(60, 106)
VO_FRAMES = range(106, 116)
BACK_FRAMES = range(116, 120)
T_SHIFT = 200.0
VO_KEEP = 0.03  # share of the map points kept for the VO fallback
GT_TOL = 0.02  # m, camera centres against ground truth
RELOC_TOL_M, RELOC_TOL_RAD = 1e-4, 1e-4  # card against CPU relocalization
# Phase 13: the JAX package's figures on bench.make_revisit_frames(),
# synchronous RGB-D with mapping and loop closing on, on a CPU
# (tools/jax_revisit_reference.py): the TUM-file ATE and tracked frames.
JAX_CPU_ATE_REVISIT = 0.3651492535120875
JAX_CPU_TRACKED_REVISIT = 138
N_CIRCUIT = 100  # frames of the orbit before the revisit
LOOP_TOL_M, LOOP_TOL_RAD, LOOP_KF_TOL_M = 1e-4, 1e-4, 1e-3  # card against CPU loop event
# The stress graph of phase 13's reproducibility gate (testing.pose_graph_problem):
# 160 keyframes, each linked to the next 10 (degree 20), 200 random edges
# and 200 repeats of earlier ones: 2,000 edges.
STRESS_GRAPH = dict(V=160, n_offsets=10, n_extra=200, n_dup=200)
# The host's waits on the card allowed per call of each loop-closing step,
# as CUDA's sync debug mode counts them: the poll reads the pending
# detection once; a verification reads its pack once and waits on the
# error checks of its RANSAC's two batched eigh; a correction reads its
# bundle once.
SYNC_MAX = {"poll": 1, "detect": 0, "verify": 3, "correct": 1, "chunk": 0, "merge": 0}
SYNC_WARNING = "called a synchronizing CUDA operation"
# Phase 14: the stereo workload (testing.make_stereo_frames) and the JAX
# package's TUM-file ATE on it, synchronous stereo with mapping on and
# loop closing off, on a CPU (tools/jax_stereo_reference.py).
N_STEREO = 60
N_STEREO_WARM = 10
N_PAR_STEREO = 10  # CPU parity frames
JAX_CPU_ATE_STEREO = 0.016306350048612923
STEREO_ATE_MAX = 0.08  # the bound of tests/test_stereo_system.py
STEREO_OK_SHARE, STEREO_UR_TOL = 0.99, 1e-3  # card against CPU on frame 0's stereo_match
# Phase 15: the TUM runner at load_config's defaults (512 keyframe and
# 65,536 map-point slots, 32 observations per point, loop closing on) on
# bench.make_frames() written as a TUM directory, and the JAX package's
# figures from its own runner on the same directory on a CPU
# (tools/jax_tum_reference.py): the ATE, keyframes inserted, loops closed.
JAX_CPU_ATE_TUM = 0.0018624403744987028
JAX_CPU_KF_TUM = 19
JAX_CPU_LOOPS_TUM = 0
TUM_KF_BAND = 4  # keyframes inserted within JAX's count +- this: float sums move decisions (F1)
TUM_EVERY = 30  # the viewer's cadence
N_TUM_SAVE = 60  # frames tracked before the checkpoint
RESUME_ATE_MIN = 0.03  # m: tests/test_serialize_viz.py's resume bound, max(2x, this)
RESUME_CENTRE_MAX = 1e-3  # m: resumed camera centres against the uninterrupted run's
TUM_CALIB_FX = 501.0  # fx of the settings file of the re-calibration
# Phase 17: the pipelined path at bench.py's configuration and call
# sequence (bench.make_system: enable_pipelined(lag=16), precompile();
# bench.run: 20 warm-up frames, flush_pipeline, the other 100, shutdown)
# over bench.make_frames(), and the JAX package's figures on the same run
# on a CPU (tools/jax_pipelined_reference.py, part "bench").
PIPE_LAG = 16
JAX_CPU_ATE_PIPE = 0.006090578712869592
JAX_CPU_LOST_PIPE = 0
JAX_CPU_KF_PIPE = 31
# JAX's frame trace of that run through frame 38, the last frame whose step
# runs on the map of the drains before the first burst (the drain after
# frame 38 inserts 7 keyframes, frames 26-38, and runs a deferred BA):
# inliers per frame, the frames that asked for a keyframe, the frames
# inserted; all 39 tracked.
N_PIPE_SAME = 39
JAX_CPU_PIPE_INLIERS = (
    934, 426, 386, 361, 383, 367, 380, 362, 376, 367, 365, 371, 356, 356, 368, 393, 390, 411,
    424, 423, 387, 373, 387, 360, 352, 353, 328, 319, 330, 310, 305, 322, 330, 313, 321, 317,
    316, 343, 341)
JAX_CPU_PIPE_NEED = (0, 3) + tuple(range(26, 39))
JAX_CPU_PIPE_INSERTED = (0, 3, 26, 28, 30, 32, 34, 36, 38)
# From frame 39 on the reference's own outcome is a spread, not a figure:
# the burst's deferred BA is chaotic in the JAX package (one ulp more in one
# coordinate of one map point of its input moves JAX's keyframe poses by
# centimetres and its points by a median of decimetres,
# tests/test_torch_pipeline_burst.py), and how far it flings the points
# decides frame 39's local-map inliers (JAX 45, or 387 with one depth unit
# more at one pixel of frame 10) and whether frames fall below the gate of
# 30 until the next drain relocalizes.  JAX's run with that one-ulp nudge
# of the burst BA's input, six seeds, and with other frames perturbed
# (tools/pipelined_divergence.py): the most frames lost and the largest
# TUM-file ATE among them and the unperturbed run.  Nudge seeds 0-5:
# frame 39 at 150 / 32 / 20 / 195 / 385 / 379 inliers, 0 / 0 / 26 / 0 / 0 / 0
# frames lost, ATE 0.0026 / 0.0143 / 0.0645 / 0.0022 / 0.0022 / 0.0021 m;
# one depth unit more at one pixel of frame 5 or 10: 0 lost, 0.0070 / 0.0021 m.
JAX_CPU_PIPE_LOST_MAX = 26
JAX_CPU_PIPE_ATE_MAX = 0.06452236424765251
N_PIPE_REPEAT = 60  # frames of the repeat run: the burst, its relocalization and snapshot read
N_PAR_PIPE = 30  # CPU parity frames
PIPE_TOL_M = 1e-3  # m, card against CPU track-time camera centres
# The burst's drain replayed on the CPU from the card's inputs, call by call
# (the first deferred BA of the repeat run and the mapping_prep calls of its
# drain): the keyframe graph and the point counters exact, the bindings at
# tests/test_torch_mapping_system's 99.5 %, the map points' median within
# 1e-3 m and every point within PIPE_PREP_MAX_M (the low-parallax
# triangulations of keyframes two frames apart differ by up to 2 cm between
# the JAX package and the port, tests/test_torch_pipeline_burst.py); the
# deferred BA's floats within 1.5x of what the card itself gives from
# N_BURST_NUDGE one-ulp nudges of the same input (pose entries, points'
# median and 90th percentile).
BURST_GRAPH = ("kf_valid", "kf_frame_id", "parent", "covis", "mp_first_kf", "mp_found",
               "mp_visible")
BURST_BINDINGS = ("kf_mp", "mp_obs_kf", "mp_valid")
PIPE_PREP_MAX_M = 0.05
N_BURST_NUDGE = 6
# The host's waits on the card allowed per call, as CUDA's sync debug mode
# counts them (a counted call inside another keeps its own count): a
# frame's dispatch (the device step) none; a drain's own body the read of
# the ring's packed outcomes; reading a deferred BA's snapshot one; a
# keyframe insertion none; the deferred BA none; a tracking-set refresh
# one (the nearest keyframe's index); a relocalization reads where the JAX
# package's does (candidates, match counts, RANSAC verdicts, inliers): 10,
# as measured on an H100.
PIPE_SYNC_MAX = {"dispatch": 0, "drain": 1, "snapshot": 1, "insert": 0, "ba": 0, "refresh": 1,
                 "reloc": 10}
# Phase 18: the TUM runner with --pipelined (lag 16) on phase 15's
# directory, at load_config's capacities with loop closing on, and the JAX
# package's own runner with --pipelined on the same directory on a CPU
# (tools/jax_pipelined_reference.py, part "tum").
JAX_CPU_ATE_TUM_PIPE = 0.002095937215097471
JAX_CPU_KF_TUM_PIPE = 33
JAX_CPU_LOOPS_TUM_PIPE = 0
# Phase 19: the pipelined stereo path at the KITTI-00 configuration
# (SlamSystem(kitti00_config, Sensor.STEREO, loop closing off),
# enable_pipelined(lag=16), precompile(), the uint8 pairs of
# testing.make_stereo_frames(60), shutdown()), and the JAX package's
# figures on the same run on a CPU (tools/jax_pipelined_stereo_reference.py).
JAX_CPU_ATE_STEREO_PIPE = 0.004481868516834001
JAX_CPU_LOST_STEREO_PIPE = 0
JAX_CPU_KF_STEREO_PIPE = 19
# JAX's frame trace of that run through frame 37: the drain after frame 37
# is the first to insert more than one keyframe (7: frames 24-36, every
# second) and runs the first deferred BA; every frame to that point steps on
# the map of the earlier drains.  Inliers per frame, the frames that asked
# for a keyframe, the frames inserted; all 38 tracked.
N_STEREO_PIPE_SAME = 38
JAX_CPU_STEREO_PIPE_INLIERS = (
    1319, 728, 635, 646, 608, 598, 583, 601, 577, 564, 586, 598, 575, 622, 586, 625, 580, 604,
    608, 597, 581, 551, 540, 533, 486, 499, 464, 430, 434, 439, 435, 421, 434, 446, 469, 457,
    450, 462)
JAX_CPU_STEREO_PIPE_NEED = (0,) + tuple(range(24, 38))
JAX_CPU_STEREO_PIPE_INSERTED = (0, 24, 26, 28, 30, 32, 34, 36)
N_STEREO_PIPE_REPEAT = 30  # frames of the repeat run under CUDA's sync debug mode
N_PAR_STEREO_PIPE = 10  # CPU parity frames
# Phase 20: the KITTI runner with --pipelined (lag 16) on
# testing.write_kitti_sequence of the same 60 pairs, at its own configuration
# (SlamConfig() with calib.txt's camera, loop closing on), and the JAX
# package's own runner with --pipelined on the same directory on a CPU
# (tools/jax_pipelined_stereo_reference.py --runner): lost frames, the ATE at
# full precision with the runners' pairing (io.trajectory.ate_against_kitti_poses),
# loops closed.
JAX_CPU_LOST_KITTI_PIPE = 0
JAX_CPU_ATE_KITTI_PIPE = 0.002247088034332431
JAX_CPU_KF_KITTI_PIPE = 17
JAX_CPU_LOOPS_KITTI_PIPE = 0


class GateFailed(AssertionError):
    """A gate of a phase failed after the phase had made what later phases
    run on (``result``): the script goes on and fails at its end."""

    def __init__(self, msg, result):
        super().__init__(msg)
        self.result = result


def _bound(nbytes, lane_ops, popc=0.0):
    """The least ms an H100 could take for work that moves ``nbytes`` and
    does ``lane_ops`` lane operations and ``popc`` popcounts, and what
    binds it ("bytes" or "operations")."""
    t = {"bytes": nbytes / HBM_BYTES_S,
         "operations": max(lane_ops / LANE_OPS_S, popc / POPC_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


@contextlib.contextmanager
def _pose_calls(count=None):
    """Counts ``optimize_pose``'s calls through the modules that make them
    (the tracker, the facade's relocalization, the pipelined step) while
    the block runs, in ``count["calls"]`` (a new dict, or the caller's,
    which may set it back to 0 where it resets the launch counts), and
    keeps a copy of the last call's inputs in ``count["last"]``: on the
    card each call must be one K5 launch."""
    from ydorbslam_tpu_torch.slam import pipeline, system, tracking

    count = {} if count is None else count
    count.update(calls=0, last=None)
    saved = [(mod, mod.optimize_pose) for mod in (tracking, system, pipeline)]

    def counted(fn):
        def f(cam, T_init, obs, *args, **kwargs):
            count["calls"] += 1
            count["last"] = (cam, T_init.clone(), type(obs)(*(t.clone() for t in obs)), args,
                             kwargs)
            return fn(cam, T_init, obs, *args, **kwargs)
        return f

    try:
        for mod, fn in saved:
            mod.optimize_pose = counted(fn)
        yield count
    finally:
        for mod, fn in saved:
            mod.optimize_pose = fn


def _gate_pose_lm(label, launches, count, least):
    """K5's launch gate: one ``pose_lm`` launch per ``optimize_pose`` call,
    and at least ``least`` calls."""
    if launches["pose_lm"] != count["calls"] or count["calls"] < least:
        raise AssertionError(f"{label}: {launches['pose_lm']} pose_lm launches for "
                             f"{count['calls']} optimize_pose calls, at least {least} expected")


def _k1_work(levels, border):
    """Scored pixels, window outputs and pixels of one K1 launch over
    ``levels``, and its bound (ms, what binds): every pixel read and
    written once, the operations of ``K1_SCORE_OPS`` and ``K1_NMS_OPS``."""
    scored = window = px = 0
    for lv in levels:
        H, W = lv.shape
        px += H * W
        if H > 2 * border and W > 2 * border:
            window += (H - 2 * border) * (W - 2 * border)
            scored += ((min(H - border, H - 1) - max(border - 1, 0) + 1)
                       * (min(W - border, W - 1) - max(border - 1, 0) + 1))
    return scored, window, px, *_bound(px * 8, scored * K1_SCORE_OPS + window * K1_NMS_OPS)


def _centres(poses):
    import numpy as np

    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def _config():
    from ydorbslam_tpu_torch.config import (
        CameraConfig, CapacityConfig, DepthConfig, OrbConfig, SlamConfig, TrackingConfig,
    )

    # The configuration of bench.make_system: TUM fr1-desk-like RGB-D
    # sensor, 1000 ORB features, 8 levels at 1.2, 160 keyframe and 16384
    # map-point slots, every other capacity at its default.
    return SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(
            fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640, height=480,
        ),
        orb=OrbConfig(n_features=1000),
        depth=DepthConfig(depth_map_factor=5000.0),
        capacity=CapacityConfig(max_keyframes=160, max_map_points=16384),
    )


def _run(frames, device, mapping):
    """Track ``frames`` with the port on ``device``: (system, per-frame
    seconds, track-time poses, lost flags, keyframes after each frame)."""
    import torch

    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    system = SlamSystem(
        _config(), Sensor.RGBD, enable_mapping=mapping, enable_loop_closing=False,
        device=device,
    )
    secs, kfs = [], []
    for t, gray, depth in frames:
        t0 = time.perf_counter()
        system.track_rgbd(t, gray, depth)
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        kfs.append(system.n_keyframes)
    _, poses, lost = system.tracker.trajectory()
    return system, secs, poses, lost, kfs


def _same_k2(prob, check_ur, label):
    """K2 against the plain version on one problem: idx, best and second
    of both radii identical, or raise."""
    import torch

    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.ops.hamming import proj_best2_plain

    p = proj_best2_plain(*prob, check_ur=check_ur)
    k = kernels.proj_best2_cuda(*prob, check_ur=check_ur)
    torch.cuda.synchronize()
    if not all(torch.equal(kk, pp) for kk, pp in zip((*k[0], *k[1]), (*p[0], *p[1]))):
        raise AssertionError(f"K2 differs from plain on {label}, check_ur={check_ur}")


def _k5_check(label, call):
    """K5 against the plain version and a float64 solve on one captured
    ``optimize_pose`` input: each inlier set equal to the kernel's or apart
    only at the threshold (at most 3 flips, each with its raw chi2 at the
    float64 pose within ``K5_FLIP_CHI2`` of delta^2, ``n_in`` apart by no
    more), the camera centre within the benchmark's 1.5e-5 m of plain's
    where the sets agree, of float64's too unless plain is further from it
    (then within twice plain's gap), and within ``K5_FLIP_GAP_M`` a flip of
    float64's where they do not; two launches bit for bit, one
    launch a call; then device and wall ms of both.  Returns the report's
    fields and a line to print."""
    import torch

    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.optim.pose import (
        CHI2_MONO, CHI2_STEREO, _chi2, _flat_project, _weights, optimize_pose_plain,
    )
    from ydorbslam_tpu_torch.testing import device_ms, wall_ms

    cam, T0, obs, args, kwargs = call
    before = kernels.launch_counts()["pose_lm"]
    k = kernels.pose_lm_cuda(cam, T0, obs, *args, **kwargs)
    k2 = kernels.pose_lm_cuda(cam, T0, obs, *args, **kwargs)
    p = optimize_pose_plain(cam, T0, obs, *args, **kwargs)
    torch.cuda.synchronize()
    if kernels.launch_counts()["pose_lm"] != before + 2:
        raise AssertionError(f"K5 on {label}: not one launch a call")
    if not all(torch.equal(a, b) for a, b in zip(k, k2)):
        raise AssertionError(f"K5 on {label}: two launches differ")
    f64 = lambda t: t.double().cpu() if t.is_floating_point() else t.cpu()  # noqa: E731
    cam64 = cam._replace(**{f: f64(getattr(cam, f)) for f in cam._fields[:10]})
    obs64 = type(obs)(*(f64(t) for t in obs))
    d = optimize_pose_plain(cam64, f64(T0), obs64, *args, **kwargs)
    r = _flat_project(cam64, d[0], obs64)[-1]
    chi2 = _chi2(r, *_weights(obs64, torch.ones_like(obs64.valid)))
    delta2 = torch.where(obs64.has_stereo, CHI2_STEREO, CHI2_MONO).double()
    kin = k[1].cpu()
    c = _centres([k[0].double().cpu().numpy(), p[0].double().cpu().numpy(), d[0].numpy()])
    faults = []
    for name, other, n_other, centre in (("plain", p[1].cpu(), int(p[2]), c[1]),
                                         ("float64", d[1], int(d[2]), c[2])):
        idx = torch.nonzero(kin != other)[:, 0]
        gap = float(((c[0] - centre) ** 2).sum() ** 0.5)
        far = idx[(chi2[idx] - delta2[idx]).abs() > K5_FLIP_CHI2].tolist()
        limit = K5_FLIP_GAP_M * len(idx) if len(idx) else POSE_GAP_M
        if name == "float64" and not len(idx):
            # An ill-posed solve leaves float32 short of float64 whatever the
            # order of its sums: the plain version's own gap, twice, bounds it.
            limit = max(limit, 2 * float(((c[1] - centre) ** 2).sum() ** 0.5))
        if len(idx) > 3 or far or abs(int(k[2]) - n_other) > len(idx) or \
                (not gap < limit and (name == "float64" or not len(idx))):
            faults.append(f"against {name}: {len(idx)} inliers differ ({far} away from the "
                          f"threshold), n_in {int(k[2])} / {n_other}, camera-centre gap "
                          f"{gap:.3e} m (limit {limit:.1e})")
        if name == "plain":
            flips, gap_p = len(idx), gap
        else:
            flips_d, gap_d = len(idx), gap
    if faults:
        raise AssertionError(f"K5 on {label}: " + "; ".join(faults))
    n, valid = obs.valid.shape[0], int(obs.valid.sum())
    E = kwargs.get("episodes", args[0] if args else 4)
    I = kwargs.get("iters_per_episode", args[1] if len(args) > 1 else 10)
    bound, by = _bound(n * K5_BYTES_OBS, valid * (E * (I + 1) * K5_OPS_PASS
                                                   + E * K5_OPS_CLASSIFY))
    ms = device_ms(lambda: kernels.pose_lm_cuda(cam, T0, obs, *args, **kwargs))
    wall = wall_ms(lambda: kernels.pose_lm_cuda(cam, T0, obs, *args, **kwargs))
    plain = device_ms(lambda: optimize_pose_plain(cam, T0, obs, *args, **kwargs),
                      calls=2, reps=3, warm=1)
    plain_wall = wall_ms(lambda: optimize_pose_plain(cam, T0, obs, *args, **kwargs),
                         calls=2, reps=3, warm=1)
    line = (f"K5 on {label} (N={n}, {valid} valid, {E} x {I}): n_in {int(k[2])} / plain "
            f"{int(p[2])} / float64 {int(d[2])}, {flips} / {flips_d} inliers apart, camera-centre "
            f"gap {gap_p:.3e} / {gap_d:.3e} m; two launches "
            f"bitwise equal; ms per call kernel / plain: device {ms:.4f} / {plain:.3f}, wall "
            f"{wall:.4f} / {plain_wall:.3f}; bound {bound:.5f} ms ({by}; the {E * (I + 2)} "
            f"dependent passes set the time)")
    return dict(max_abs_err=gap_p, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by), line


def _same_k3(prob, mode, label):
    """K3 against the plain version on one problem."""
    import torch

    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.ops.hamming import pair_best2_plain

    p = pair_best2_plain(*prob, mode=mode)
    k = kernels.pair_best2_cuda(*prob, mode=mode)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        raise AssertionError(f"K3 differs from plain on {label}")


def _k2_work(prob, check_ur):
    """Pairs and gated pairs of one K2 call, and its bound (ms, what
    binds): the gate for every pair, the distance for the pairs that pass
    either radius, the update for each radius that passes."""
    from ydorbslam_tpu_torch.ops.hamming import proj_gates

    M, N = prob[0].shape[0], prob[2].shape[0]
    gn, gw = proj_gates(prob[1], prob[3], check_ur)
    gated = int((gn | gw).sum())
    ops = (M * N * K2_GATE_OPS[bool(check_ur)] + gated * DIST_OPS
           + (int(gn.sum()) + int(gw.sum())) * UPDATE_OPS)
    return M * N, gated, *_bound((M + N) * 64 + 6 * M * 4, ops, gated * 8)


def _k3_work(prob, mode):
    """As ``_k2_work`` for one K3 call."""
    from ydorbslam_tpu_torch.ops.hamming import pair_gates

    B, M, N = prob[0].shape[0], prob[0].shape[1], prob[2].shape[1]
    gated = int(pair_gates(prob[1], prob[3], mode).sum())
    ops = B * M * N * K3_GATE_OPS[mode] + gated * (DIST_OPS + UPDATE_OPS)
    return B * M * N, gated, *_bound(B * (M + N) * 64 + 3 * B * M * 4, ops, gated * 8)


def _profiled_ms(fn, calls=10):
    """Device ms per call of fn(): the kernels' own times summed by
    torch.profiler over ``calls`` calls.  For calls whose host dispatch
    outlasts their device work, where ``device_ms``'s spin cannot cover
    the enqueue and the card idles between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3 / calls


def _rot_angle(Ra, Rb):
    """Angle in radians of the rotation between two rotation matrices,
    atan2 of its sine (half the norm of the skew part) and cosine: well
    conditioned near zero, where arccos of the trace is not."""
    import numpy as np

    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(M) - 1.0)))


def _phase12(system, frames, gt_poses, smi):
    """Phase 12 on the main path's card system (its map, index and
    tracker after phase 8): kidnap and relocalization, the same
    relocalization on the CPU, localization-only mode, the VO fallback,
    and the cost of the linear algebra and of the index update.  Camera
    centres are held against the ground truth in the map's frame (frame
    0's camera, where tracking starts).  Each path's launch counts start
    at 0 just before it and are read just after; any gate that fails
    raises."""
    import numpy as np
    import torch

    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.ops.extractor import FrameFeatures
    from ydorbslam_tpu_torch.slam import retrieval, system as system_mod
    from ydorbslam_tpu_torch.slam.map_state import MapState
    from ydorbslam_tpu_torch.slam.mapping import SNAP_CULL_CAP
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
    from ydorbslam_tpu_torch.slam.tracking import TrackingState
    from ydorbslam_tpu_torch.testing import wall_ms

    dev = system.device
    h, w = frames[0][1].shape
    T0 = gt_poses[0]
    gt_map = _centres(gt_poses) @ T0[:3, :3].T + T0[:3, 3]
    calls = []  # one dict per _relocalize call on the card
    timing = {"on": False}
    last_ids = []

    parts = {"bow_histogram": "retrieval", "detect_candidates": "retrieval",
             "match_dense": "match", "ransac_pose_3d3d": "ransac", "ransac_pnp": "ransac",
             "optimize_pose": "lm", "match_local_points": "widen"}
    saved = {name: getattr(system_mod, name) for name in parts}

    def part(name):
        """system.py's ``name``, timed between synchronisations while a card
        relocalization runs; detect_candidates also keeps its candidates."""
        fn, key = saved[name], parts[name]

        def wrapper(*args, **kwargs):
            if not timing["on"]:
                out = fn(*args, **kwargs)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                calls[-1][key] = calls[-1].get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            if name == "detect_candidates":
                last_ids[:] = [int(i) for i in out[0].cpu().numpy() if i >= 0]
            return out
        return wrapper

    reloc = system.tracker.reloc_hook
    inputs = []

    def hook(tracker, timestamp, feats):
        """The card's _relocalize, synchronised and timed, with a CPU copy
        of everything it reads kept for the CPU comparison."""
        inputs.append(dict(
            t=timestamp, feats=FrameFeatures(*(x.cpu() for x in feats)),
            map=MapState(*(x.cpu() for x in system.map)),
            retrieval=retrieval.RetrievalIndex(*(x.cpu() for x in system.retrieval)),
            gen=system._reloc_gen.get_state(), n_kf=system.n_keyframes,
        ))
        k2 = kernels.launch_counts()["proj_best2"]
        calls.append({})
        torch.cuda.synchronize()
        timing["on"] = True
        t0 = time.perf_counter()
        try:
            ok = reloc(tracker, timestamp, feats)
            torch.cuda.synchronize()
        finally:
            timing["on"] = False
        calls[-1].update(
            total=(time.perf_counter() - t0) * 1e3, ok=ok, cands=list(last_ids),
            k2=kernels.launch_counts()["proj_best2"] - k2, accepted=system.ref_kf if ok else -1,
            n_in=tracker.n_inliers, T=tracker.T_cw.cpu().numpy(),
        )
        return ok

    def centre_err(i):
        return float(np.linalg.norm(_centres([system.tracker.T_cw.cpu().numpy()])[0]
                                    - gt_map[i]))

    try:
        for name in parts:
            setattr(system_mod, name, part(name))
        system.tracker.reloc_hook = hook

        # Kidnap: a blank frame, then frames 40-59 again, 200 s later.
        n_kf = system.n_keyframes
        kernels.reset_launch_counts()
        with _pose_calls() as kid_pose:
            ok_blank = system.track_rgbd(frames[-1][0] + 1.0 / 30.0,
                                         np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint16))
            state_blank = system.tracking_state()
            ok_rep, err_rep = [], []
            for i in KIDNAP_REPLAY:
                t, gray, depth = frames[i]
                ok_rep.append(system.track_rgbd(t + T_SHIFT, gray, depth))
                err_rep.append(centre_err(i))
        kid_launches = kernels.launch_counts()

        # The accepted relocalization again on the CPU, from the same map,
        # index, frame features and generator state.
        j = next((k for k, c in enumerate(calls) if c["ok"]), None)
        if j is not None:
            inp = inputs[j]
            cpu = SlamSystem(_config(), Sensor.RGBD, enable_mapping=True,
                             enable_loop_closing=False, device="cpu")
            cpu.map, cpu.retrieval, cpu.n_keyframes = inp["map"], inp["retrieval"], inp["n_kf"]
            cpu._reloc_gen.set_state(inp["gen"])
            ok_cpu = cpu._relocalize(cpu.tracker, inp["t"], inp["feats"])
            cpu_cands = list(last_ids)
    finally:
        for name, fn in saved.items():
            setattr(system_mod, name, fn)
        system.tracker.reloc_hook = reloc

    first = next((k for k, ok in enumerate(ok_rep) if ok), None)
    split = " | ".join(
        f"call {k}: {c['total']:.3f} ms (retrieval {c.get('retrieval', 0.0):.3f}, match "
        f"{c.get('match', 0.0):.3f}, RANSAC {c.get('ransac', 0.0):.3f}, LM {c.get('lm', 0.0):.3f}, "
        f"widening {c.get('widen', 0.0):.3f}), K2 launches {c['k2']}, candidates {c['cands']}, "
        f"accepted {c['accepted']}, inliers {c['n_in']}" for k, c in enumerate(calls))
    tracked = [e for ok, e in zip(ok_rep, err_rep) if ok]
    print(f"phase 12 kidnap: blank frame {'lost' if not ok_blank else 'TRACKED'}, state "
          f"{state_blank.name} with {n_kf} keyframes; replayed frames "
          f"{KIDNAP_REPLAY[0]}-{KIDNAP_REPLAY[-1]} (+{T_SHIFT:.0f} s): relocalized at frame "
          f"{KIDNAP_REPLAY[first] if first is not None else None}, tracked {sum(ok_rep)} of "
          f"{len(ok_rep)}, max centre error {max(tracked, default=float('nan')):.6f} m; reloc "
          f"attempts {system.stats.reloc_attempts} successes {system.stats.reloc_successes}; "
          f"launches {kid_launches}; synchronised _relocalize: {split} | {smi}", flush=True)
    if ok_blank or state_blank != TrackingState.LOST or system.n_keyframes < n_kf:
        raise AssertionError("kidnap: the blank frame was not lost, or the system reset")
    if system.stats.reloc_successes < 1 or first is None or j is None:
        raise AssertionError("kidnap: no replayed frame relocalized")
    if first != 0:
        raise AssertionError(f"kidnap: relocalized only at frame {KIDNAP_REPLAY[first]}, "
                             f"not at the first replayed frame {KIDNAP_REPLAY[0]}")
    if not all(ok_rep[first:]) or not max(tracked) < GT_TOL:
        raise AssertionError(f"kidnap: replay tracked {ok_rep}, centre errors {err_rep}")
    if kid_launches["fast_score_nms"] != 1 + len(KIDNAP_REPLAY) or calls[j]["k2"] < 1:
        raise AssertionError(f"kidnap: launches {kid_launches}, K2 in relocalization "
                             f"{calls[j]['k2']}")
    # At least the relocalization's solve, then two a frame after it.
    _gate_pose_lm("kidnap", kid_launches, kid_pose, 1 + 2 * (len(KIDNAP_REPLAY) - 1))

    card = calls[j]
    d_c = float(np.linalg.norm(_centres([card["T"]])[0]
                               - _centres([cpu.tracker.T_cw.numpy()])[0]))
    d_r = _rot_angle(card["T"][:3, :3], cpu.tracker.T_cw.numpy()[:3, :3])
    print(f"phase 12 card against CPU on relocalization call {j}: candidates card "
          f"{card['cands']} CPU {cpu_cands}; accepted card {card['accepted']} CPU "
          f"{cpu.ref_kf if ok_cpu else -1}; inliers card {card['n_in']} CPU "
          f"{cpu.tracker.n_inliers}; camera-centre difference {d_c:.3e} m, rotation "
          f"difference {d_r:.3e} rad", flush=True)
    if card["cands"] != cpu_cands or not ok_cpu or cpu.ref_kf != card["accepted"] or \
            abs(cpu.tracker.n_inliers - card["n_in"]) > 2 or not d_c < RELOC_TOL_M or \
            not d_r < RELOC_TOL_RAD:
        raise AssertionError("card and CPU relocalizations disagree")

    # Localization-only mode, going on from the replay: frames 60-105.
    before = system.run_stats()
    system.activate_localization_mode()
    kernels.reset_launch_counts()
    ok_loc, err_loc, vo_loc, secs = [], [], [], []
    with _pose_calls() as loc_pose:
        for i in LOC_FRAMES:
            t, gray, depth = frames[i]
            t0 = time.perf_counter()
            ok_loc.append(system.track_rgbd(t + T_SHIFT, gray, depth))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            err_loc.append(centre_err(i))
            vo_loc.append(system.visual_odometry)
    loc_launches = kernels.launch_counts()
    after = system.run_stats()
    fixed = ("keyframes_inserted", "map_points_live")
    print(f"phase 12 localization mode: frames {LOC_FRAMES[0]}-{LOC_FRAMES[-1]}, lost "
          f"{ok_loc.count(False)}, {', '.join(f'{k} {before[k]} -> {after[k]}' for k in fixed)}, "
          f"visual odometry on {sum(vo_loc)} frames, max centre error {max(err_loc):.6f} m, "
          f"launches {loc_launches}, {len(secs) / sum(secs):.3f} frames/s, median "
          f"{float(np.median(secs)) * 1e3:.3f} ms/frame | {smi}", flush=True)
    if not all(ok_loc) or any(before[k] != after[k] for k in fixed) or any(vo_loc) or \
            not max(err_loc) < GT_TOL:
        raise AssertionError("localization mode: lost frames, a map change, VO or a pose error")
    if loc_launches["pair_best2"] or loc_launches["lm_obs"] or \
            loc_launches["fast_score_nms"] != len(LOC_FRAMES) or \
            loc_launches["proj_best2"] < len(LOC_FRAMES):
        raise AssertionError(f"localization mode launches {loc_launches}")
    _gate_pose_lm("localization mode", loc_launches, loc_pose, 2 * len(LOC_FRAMES))

    # The VO fallback: 3 % of the map points kept, then the map restored.
    n_kf = system.n_keyframes
    saved_valid = system.map.mp_valid
    keep = torch.from_numpy(np.random.default_rng(12).random(system.map.M) < VO_KEEP).to(dev)
    system.map = system.map._replace(mp_valid=saved_valid & keep)
    kernels.reset_launch_counts()
    with _pose_calls() as vo_pose:
        ok_vo = [system.track_rgbd(frames[i][0] + T_SHIFT, *frames[i][1:]) for i in VO_FRAMES]
        vo_on = system.visual_odometry
        err_vo = centre_err(VO_FRAMES[-1])
        system.map = system.map._replace(mp_valid=saved_valid)
        ok_back = [system.track_rgbd(frames[i][0] + T_SHIFT, *frames[i][1:])
                   for i in BACK_FRAMES]
        vo_back = system.visual_odometry
    vo_launches = kernels.launch_counts()
    system.deactivate_localization_mode()
    print(f"phase 12 VO fallback: {VO_KEEP:.0%} of the map points kept, frames "
          f"{VO_FRAMES[0]}-{VO_FRAMES[-1]} tracked {sum(ok_vo)} of {len(ok_vo)}, visual odometry "
          f"{vo_on}, centre error at frame {VO_FRAMES[-1]} {err_vo:.6f} m; map restored, frames "
          f"{BACK_FRAMES[0]}-{BACK_FRAMES[-1]} tracked {sum(ok_back)} of {len(ok_back)}, visual "
          f"odometry {vo_back}; keyframes {n_kf} -> {system.n_keyframes}; launches "
          f"{vo_launches}", flush=True)
    if sum(ok_vo) < len(VO_FRAMES) - 1 or not vo_on or vo_back or system.n_keyframes != n_kf:
        raise AssertionError("VO fallback: too few frames tracked or the flag did not move")
    if vo_launches["pair_best2"] or vo_launches["lm_obs"] or not vo_launches["proj_best2"] or \
            vo_launches["fast_score_nms"] != len(VO_FRAMES) + len(BACK_FRAMES):
        raise AssertionError(f"VO fallback launches {vo_launches}")
    _gate_pose_lm("VO fallback", vo_launches, vo_pose, 2 * len(BACK_FRAMES))

    # What a relocalization's linear algebra and a keyframe's index update cost.
    g = torch.Generator().manual_seed(5)
    sym = torch.randn((256, 4, 4), generator=g)
    sym = (sym + sym.transpose(-1, -2)).to(dev)
    a12 = torch.randn((256, 12, 12), generator=g).to(dev)
    a3 = torch.randn((256, 3, 3), generator=g).to(dev)
    m, idx, kw = system.map, system.retrieval, system._bank_kw
    none = torch.full((SNAP_CULL_CAP,), -1, dtype=torch.int64, device=dev)
    add = lambda: retrieval.add_keyframe(idx, 0, m.kf_desc[0], m.kf_kp_valid[0], **kw)  # noqa: E731
    rm = lambda: retrieval.remove_keyframes(idx, none)  # noqa: E731
    print(f"phase 12 costs: eigh (256, 4, 4) wall {wall_ms(lambda: torch.linalg.eigh(sym)):.4f} "
          f"ms; svd (256, 12, 12) wall {wall_ms(lambda: torch.linalg.svd(a12)):.4f} ms; svd "
          f"(256, 3, 3) wall {wall_ms(lambda: torch.linalg.svd(a3)):.4f} ms; retrieval index "
          f"{(idx.hist.numel() + idx.presence.numel()) * 4 / 1e6:.1f} MB at K={m.K}; add_keyframe "
          f"wall {wall_ms(add):.4f} ms, device {_profiled_ms(add):.4f} ms; remove_keyframes wall "
          f"{wall_ms(rm):.4f} ms, device {_profiled_ms(rm):.4f} ms | {smi}", flush=True)


def _phase13(smi, report):
    """Phase 13: loop closing on the card over the revisit workload, the
    accepted loop event again on the CPU, and K2/K4 on the loop path's
    captured inputs.  Fills ``report[k]["loop_launches"]``; any gate that
    fails raises (the revisit's tracked frames and ATE at the phase's end,
    as ``GateFailed`` with the result).  Returns what phase 21 runs on: the first global BA as
    ``_start_global_ba`` armed it (``prob``, ``T``, ``p``, ``lam``), the
    camera and configuration, the final map and retrieval index, and the
    last keyframe's id."""
    import numpy as np
    import torch

    import bench
    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu_torch.ops import hamming, kernels
    from ydorbslam_tpu_torch.optim import lm_kernel, schur
    from ydorbslam_tpu_torch.slam import loop_impl, matchers
    from ydorbslam_tpu_torch.slam.map_state import MapState
    from ydorbslam_tpu_torch.slam.retrieval import RetrievalIndex
    from ydorbslam_tpu_torch.optim.pose_graph import PoseGraphProblem
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
    from ydorbslam_tpu_torch.testing import device_ms

    frames = bench.make_revisit_frames()
    from synthetic import OrbitDriftSequence  # bench put tests/ on sys.path

    seq = OrbitDriftSequence(np.random.default_rng(7), n_frames=N_CIRCUIT, n_landmarks=1500,
                             drift_rate=0.008)
    system = SlamSystem(_config(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                        device="cuda")
    impl = system.loop_closer._impl
    Impl = type(impl)
    ms = {k: [] for k in ("detect", "verify", "correct", "essential", "pose_graph", "chunk",
                          "merge")}
    state = {"where": None}
    captured, verified, chunk_mem, loop_launch = {}, [], [], {}
    accepted = {}
    syncs = {k: [] for k in SYNC_MAX}
    sync_sites = {k: {} for k in SYNC_MAX}  # step -> "file:line" of the waiting call -> count

    def quiet_sync():
        """The timers' own synchronisation, left out of the sync counts."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(mode)

    def synced(fn, key):
        """Count the host's waits on the card inside ``fn``: CUDA's sync
        debug mode warns at each (a read of a tensor, an upload from
        pageable memory, a library's check of its error codes).  A counted
        call inside another keeps its own count."""
        def wrapper(*args, **kwargs):
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                    waits = [w for w in seen if SYNC_WARNING in str(w.message)]
                    syncs[key].append(len(waits))
                    for w in waits:
                        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
                        sync_sites[key][site] = sync_sites[key].get(site, 0) + 1
        return wrapper

    def sync_timed(fn, key, where=None):
        def wrapper(*args, **kwargs):
            quiet_sync()
            prev = state["where"]
            if where is not None:
                state["where"] = where
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                quiet_sync()
            finally:
                state["where"] = prev
            ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def keep_k2(desc_a, attr_a, desc_b, attr_b, check_ur=False):
        # The last verification's searches; the first correction's first
        # fusion search (into the query keyframe).
        key = ("k2", desc_a.shape[0])
        if state["where"] == "verify" or (state["where"] == "correct" and key not in captured):
            captured[key] = tuple(t.clone() for t in (desc_a, attr_a, desc_b, attr_b))
        return hamming.proj_best2(desc_a, attr_a, desc_b, attr_b, check_ur)

    def keep_k4(inp):
        if state["where"] == "chunk":
            captured["k4"] = inp.clone()
        return lm_kernel.lm_obs(inp)

    def chunk(*args, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = timed_chunk(*args, **kwargs)
        chunk_mem.append((base, torch.cuda.max_memory_allocated()))
        return out

    def verify(*args, **kwargs):
        out = timed_verify(*args, **kwargs)
        verified.append((args[1], args[2], out[0].clone()))
        return out

    def counted(fn):
        def wrapper(*args, **kwargs):
            before = kernels.launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                after = kernels.launch_counts()
                for k in after:
                    loop_launch[k] = loop_launch.get(k, 0) + after[k] - before[k]
        return wrapper

    def poll(self):
        """Keep a copy of what the poll reads (on the card) before it runs;
        the copy of the poll that closes a loop is kept for the CPU replay."""
        snap = None
        if self._pending is not None:
            sysm = self.system
            snap = dict(map=MapState(*(x.clone() for x in sysm.map)),
                        retrieval=RetrievalIndex(*(x.clone() for x in sysm.retrieval)),
                        pending=self._pending, gen=self.generator.get_state(),
                        n_kf=sysm.n_keyframes, host_valid=sysm._host_kf_valid.copy(),
                        host_fid=sysm._host_kf_frame_id.copy(), n_verified=len(verified))
        closed = counted_poll(self) if snap is not None else orig_poll(self)
        if closed and snap is not None and not accepted:
            # The K2 inputs captured so far are the accepted candidate's
            # verification searches and its correction's first fusion search.
            accepted.update(snap, kf_pose=self.system.map.kf_pose.clone(),
                            kf_valid=self.system.map.kf_valid.clone(),
                            verified=verified[snap["n_verified"]:],
                            k2={k[1]: v for k, v in captured.items() if k[0] == "k2"})
        return closed

    def keep_gba(self, m, n_valid):
        """The first global BA as it was armed, kept for phase 21."""
        out = orig_start(self, m, n_valid)
        if "gba" not in captured:
            g = self._gba
            captured["gba"] = dict(prob=schur.BAProblem(*(x.clone() for x in g["prob"])),
                                   T=g["T"].clone(), p=g["p"].clone(), lam=g["lam"].clone())
        return out

    def keep_graph(prob, **kwargs):
        """The first essential graph (the accepted loop event's) is kept
        for the reproducibility gate."""
        if "graph" not in captured:
            captured["graph"] = (PoseGraphProblem(*(x.clone() for x in prob)), kwargs)
        return timed_graph(prob, **kwargs)

    timed_graph = sync_timed(loop_impl.optimize_pose_graph, "pose_graph")
    timed_chunk = sync_timed(loop_impl._lm_chunk, "chunk", "chunk")
    timed_verify = sync_timed(loop_impl._verify_pack, "verify", "verify")
    orig_poll = Impl._poll_pending
    orig_start = Impl._start_global_ba
    counted_poll = synced(orig_poll, "poll")
    patches = [
        (matchers, "proj_best2", keep_k2), (schur, "lm_obs", keep_k4),
        (loop_impl, "_detect", synced(sync_timed(loop_impl._detect, "detect"), "detect")),
        (loop_impl, "_verify_pack", verify),
        (loop_impl, "_correct_on_device",
         sync_timed(loop_impl._correct_on_device, "correct", "correct")),
        (loop_impl, "optimize_pose_graph", keep_graph),
        (loop_impl, "_lm_chunk", synced(chunk, "chunk")),
        (loop_impl, "_merge_gba", synced(sync_timed(loop_impl._merge_gba, "merge"), "merge")),
        (Impl, "_essential_graph", sync_timed(Impl._essential_graph, "essential")),
        (Impl, "_compute_sim3", synced(Impl._compute_sim3, "verify")),
        (Impl, "_correct", synced(Impl._correct, "correct")),
        (Impl, "_poll_pending", poll), (Impl, "_start_global_ba", keep_gba),
        (Impl, "process", counted(Impl.process)), (Impl, "flush", counted(Impl.flush)),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    errs, oks, secs, loop_frame = [], [], [], None
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        kernels.reset_launch_counts()
        with _pose_calls() as pose_calls:
            for i, (t, gray, depth) in enumerate(frames):
                t0 = time.perf_counter()
                oks.append(bool(system.track_rgbd(t, gray, depth)))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                T = system.tracker.T_cw.cpu().numpy().astype(np.float64)
                errs.append(float(np.linalg.norm(-T[:3, :3].T @ T[:3, 3]
                                                 - seq.gt_center_est_frame(i))))
                if loop_frame is None and system.loop_closer.n_loops_closed:
                    loop_frame = i
            t0 = time.perf_counter()
            system.shutdown()
            torch.cuda.synchronize()
            shutdown_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    stats = system.run_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos_tum, _ = read_tum_trajectory(path)
    gt = _centres([seq.pose(i) for i in range(len(frames))])
    ate = ate_rmse(pos_tum, gt[[int(round(t * 30.0)) for t in ts]])
    tracked = sum(oks)
    steady = secs[N_WARM:]
    pre = max(errs[N_CIRCUIT - 8:loop_frame + 1]) if loop_frame is not None else float("nan")
    post = min(errs[loop_frame + 1:], default=float("nan")) if loop_frame is not None else float("nan")
    n_verify, n_corr, n_chunks = len(ms["verify"]), len(ms["correct"]), len(ms["chunk"])
    peak = max((p for _, p in chunk_mem), default=0)
    base = max((b for b, _ in chunk_mem), default=0)

    def med(v):
        return f"{float(np.median(v)):.3f}" if v else "nan"

    assembly = [e - p for e, p in zip(ms["essential"], ms["pose_graph"])]
    print(f"phase 13 loop closing on: {len(frames)} frames of bench.make_revisit_frames(), tracked "
          f"{tracked} (lost {len(frames) - tracked}), keyframes inserted "
          f"{stats['keyframes_inserted']} live {stats['keyframes_live']}, map points "
          f"{stats['map_points_live']}; loops closed {stats['loops_closed']} (events "
          f"{stats['loop_events']}, first after frame {loop_frame}), cross-loop edges "
          f"{stats['loop_conn_edges']}, candidate sets {stats['loop_candidates']}, verify fails "
          f"{ {k: v for k, v in stats['loop_verify_fails'].items() if k != 'bow_diag'} }, global "
          f"BA runs {stats['global_ba_runs']}; camera-centre error worst before the closure "
          f"{pre:.6f} m, best after {post:.6f} m; TUM rows {len(ts)}, ATE {ate:.6f} m (JAX on a "
          f"CPU {JAX_CPU_ATE_REVISIT:.6f}, tracked {JAX_CPU_TRACKED_REVISIT}); "
          f"{len(steady) / sum(steady):.3f} frames/s, median {float(np.median(steady)) * 1e3:.3f} "
          f"ms/frame after {N_WARM} warm-up frames; shutdown {shutdown_ms:.3f} ms | {smi}",
          flush=True)
    print(f"phase 13 synchronised ms (median, min-max, calls): detection "
          f"{med(ms['detect'])} ({min(ms['detect'], default=0):.3f}-"
          f"{max(ms['detect'], default=0):.3f}, {len(ms['detect'])}); verification "
          f"{med(ms['verify'])} ({min(ms['verify'], default=0):.3f}-"
          f"{max(ms['verify'], default=0):.3f}, {n_verify}); correction {ms['correct']}; "
          f"essential graph {ms['essential']} (assembly {assembly}, solve {ms['pose_graph']}); "
          f"global-BA chunks {ms['chunk']}; merge {ms['merge']}; peak max_memory_allocated in "
          f"global BA {peak / 2**20:.1f} MiB (allocated before a chunk {base / 2**20:.1f} MiB); "
          f"K4 input {tuple(captured['k4'].shape) if 'k4' in captured else None}; launches of "
          f"the run {launches}, of the loop path {loop_launch} | {smi}", flush=True)
    print("phase 13 host waits on the card per call (CUDA sync debug mode; min-max, calls, "
          "allowed): " + "; ".join(
              f"{k} {min(v, default=0)}-{max(v, default=0)} ({len(v)}, <= {SYNC_MAX[k]}; "
              f"at {sync_sites[k]})" for k, v in syncs.items()) + f" | {smi}", flush=True)
    over = {k: max(v) for k, v in syncs.items() if v and max(v) > SYNC_MAX[k]}
    if over or not syncs["verify"] or not syncs["correct"]:
        raise AssertionError(f"loop closing: host waits on the card over their budget {over}")
    if stats["loops_closed"] < 1 or loop_frame is None or loop_frame < N_CIRCUIT:
        raise AssertionError(f"loop closing: no loop after the revisit (first after frame "
                             f"{loop_frame})")
    if not stats["loop_conn_edges"] or stats["loop_conn_edges"][0] <= 1:
        raise AssertionError(f"loop closing: cross-loop edges {stats['loop_conn_edges']}")
    if stats["global_ba_runs"] < 1 or impl._gba is not None or not ms["merge"] or \
            n_chunks != 2 * stats["global_ba_runs"]:
        raise AssertionError(f"global BA: {stats['global_ba_runs']} runs, {n_chunks} chunks, "
                             f"{len(ms['merge'])} merges, in flight {impl._gba is not None}")
    if not post < 0.5 * pre:
        raise AssertionError(f"loop closing: best error after {post} not under half of {pre}")
    # The revisit's accuracy gate is raised at the phase's end, after its
    # other gates and with phase 21's inputs (GateFailed).
    revisit_fault = None
    if not ate <= 1.5 * JAX_CPU_ATE_REVISIT or tracked < JAX_CPU_TRACKED_REVISIT - 2:
        revisit_fault = f"loop closing: ATE {ate}, tracked {tracked}"
    fuse = system.cfg.capacity.loop_fuse_group
    if loop_launch.get("proj_best2", 0) != 2 * n_verify + fuse * n_corr or \
            loop_launch.get("lm_obs", 0) != 6 * n_chunks or loop_launch.get("pair_best2", 0) or \
            loop_launch.get("fast_score_nms", 0) or loop_launch.get("pose_lm", 0):
        raise AssertionError(f"loop path launches {loop_launch}: {n_verify} verifications, "
                             f"{n_corr} corrections, {n_chunks} chunks")
    _gate_pose_lm("loop closing run", launches, pose_calls, 2 * (tracked - 1))

    # The accepted loop event again on the CPU.
    cpu = SlamSystem(_config(), Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                     device="cpu")
    cpu.map = MapState(*(x.cpu() for x in accepted["map"]))
    cpu.retrieval = RetrievalIndex(*(x.cpu() for x in accepted["retrieval"]))
    cpu.n_keyframes = accepted["n_kf"]
    cpu._host_kf_valid, cpu._host_kf_frame_id = accepted["host_valid"], accepted["host_fid"]
    cimpl = cpu.loop_closer._impl
    kf_id, fid, packed = accepted["pending"]
    cimpl._pending = (kf_id, fid, packed.cpu())
    cimpl.generator.set_state(accepted["gen"])
    cpu_verified = []
    orig_vp = loop_impl._verify_pack

    def cpu_verify(*args, **kwargs):
        out = orig_vp(*args, **kwargs)
        cpu_verified.append((args[1], args[2], out[0].clone()))
        return out

    loop_impl._verify_pack = cpu_verify
    try:
        t0 = time.perf_counter()
        closed_cpu = cimpl._poll_pending()
        cpu_s = time.perf_counter() - t0
    finally:
        loop_impl._verify_pack = orig_vp
    cimpl._gba = None  # global BA is left out on the CPU
    card_v = [(a, b, v.cpu().numpy()) for a, b, v in accepted["verified"]]
    cpu_v = [(a, b, v.numpy()) for a, b, v in cpu_verified]
    same_gates = [a[:2] == b[:2] and np.array_equal(a[2][:6], b[2][:6]) for a, b in zip(card_v, cpu_v)]
    S_card = card_v[-1][2][6:].reshape(4, 4).astype(np.float64)
    S_cpu = cpu_v[-1][2][6:].reshape(4, 4).astype(np.float64)
    d_t = float(np.linalg.norm(S_card[:3, 3] - S_cpu[:3, 3]))
    d_r = _rot_angle(S_card[:3, :3], S_cpu[:3, :3])
    kv = accepted["kf_valid"].cpu().numpy()
    c_card = _centres(accepted["kf_pose"].cpu().numpy()[kv])
    c_cpu = _centres(cpu.map.kf_pose.numpy()[kv])
    d_kf = float(np.abs(c_card - c_cpu).max())
    print(f"phase 13 card against CPU on the accepted loop event (keyframe {kf_id}): verified "
          f"card {[(a, b) for a, b, _ in card_v]} CPU {[(a, b) for a, b, _ in cpu_v]}, gate counts "
          f"card {[v[:6].tolist() for _, _, v in card_v]} CPU {[v[:6].tolist() for _, _, v in cpu_v]}"
          f"; S_12 {d_t:.3e} m, {d_r:.3e} rad apart; corrected keyframe centres max "
          f"{d_kf:.3e} m apart ({int(kv.sum())} keyframes); CPU poll {cpu_s:.1f} s", flush=True)
    if not closed_cpu or len(card_v) != len(cpu_v) or not all(same_gates) or \
            not d_t < LOOP_TOL_M or not d_r < LOOP_TOL_RAD or not d_kf < LOOP_KF_TOL_M:
        raise AssertionError("card and CPU loop events disagree")
    _graph_gate(captured["graph"], smi)

    # K2 on the accepted loop event's inputs, K4 on global BA's last input.
    lines = []
    for label, M in (("verification", 1024), ("guided", 8192), ("fusion", 4096)):
        prob = accepted["k2"].get(M)
        if prob is None:
            raise AssertionError(f"no {label} K2 input captured ({sorted(accepted['k2'])})")
        _same_k2(prob, False, f"loop {label}")
        pairs, gated, bms, bby = _k2_work(prob, False)
        dev_ms = device_ms(lambda: kernels.proj_best2_cuda(*prob, check_ur=False))
        plain = device_ms(lambda: hamming.proj_best2_plain(*prob, check_ur=False), calls=5, reps=5)
        lines.append(f"K2 {label} {prob[0].shape[0]}x{prob[2].shape[0]}: identical; {gated} of "
                     f"{pairs} pairs gated; device {dev_ms:.4f} ms; plain device {plain:.4f} ms; "
                     f"bound {bms:.5f} ms ({bby})")
    inp = captured["k4"]
    kq, kp = kernels.lm_obs_cuda(inp)
    pq, pp = lm_kernel.lm_obs_plain(inp)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in ((kq, pq), (kp, pp)):
        if a.shape != b.shape or not torch.isfinite(b).all():
            raise AssertionError("K4 plain version malformed or not finite on the global-BA input")
        if ((a - b).abs() > K4_ATOL + K4_RTOL * b.abs()).any():
            raise AssertionError("K4 differs from plain on the global-BA input")
        err = max(err, float((a - b).abs().max()))
    _, O4, P4 = inp.shape
    k4_bound, k4_by = _bound(((K4_ROWS_READ + lm_kernel.NOUT_Q) * O4 * P4
                              + lm_kernel.NOUT_P * P4) * 4, O4 * P4 * K4_OPS_OBS)
    k4_dev = device_ms(lambda: kernels.lm_obs_cuda(inp))
    k4_plain = device_ms(lambda: lm_kernel.lm_obs_plain(inp), calls=5, reps=5)
    lines.append(f"K4 global BA {tuple(inp.shape)}: within rtol {K4_RTOL}, atol {K4_ATOL}, max abs "
                 f"error {err:.3e}; device {k4_dev:.4f} ms; plain device {k4_plain:.4f} ms; bound "
                 f"{k4_bound:.5f} ms ({k4_by})")
    print("phase 13 kernels on the loop path's inputs: " + " | ".join(lines) + f" | {smi}",
          flush=True)
    for k in report:
        report[k]["loop_launches"] = loop_launch.get(k, 0)
    m = system.map
    last_kf = int(torch.argmax(torch.where(m.kf_valid, m.kf_frame_id, -1)))
    loop = dict(gba=captured["gba"], cam=system.cam, cfg=system.cfg, map=m,
                retrieval=system.retrieval, kf=last_kf)
    if revisit_fault is not None:
        raise GateFailed(revisit_fault, loop)
    return loop


def _graph_gate(graph, smi):
    """F4: the accepted loop event's essential graph twice on the card
    (bit-equal) and once on the CPU from copies (keyframe centres within
    ``LOOP_KF_TOL_M``), then the seeded stress graph twice on the card
    (bit-equal, and closer to its true poses than it started)."""
    import numpy as np
    import torch

    from ydorbslam_tpu_torch.geometry.sim3 import sim3_to_se3
    from ydorbslam_tpu_torch.optim.pose_graph import PoseGraphProblem, optimize_pose_graph
    from ydorbslam_tpu_torch.testing import pose_graph_problem

    def timed(prob, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S = optimize_pose_graph(prob, **kwargs)
        torch.cuda.synchronize()
        return S, (time.perf_counter() - t0) * 1e3

    def centres(S, keep):
        return _centres(sim3_to_se3(S).cpu().numpy().astype(np.float64)[keep])

    prob, kwargs = graph
    (S1, ms1), (S2, ms2) = timed(prob, **kwargs), timed(prob, **kwargs)
    S_cpu = optimize_pose_graph(PoseGraphProblem(*(x.cpu() for x in prob)), **kwargs)
    keep = prob.vertex_valid.cpu().numpy()
    d_cpu = float(np.abs(centres(S1, keep) - centres(S_cpu, keep)).max())
    loop_equal = torch.equal(S1, S2)

    sd, T_true = pose_graph_problem(np.random.default_rng(0), **STRESS_GRAPH)
    stress = PoseGraphProblem(**{k: torch.as_tensor(v).cuda() for k, v in sd.items()})
    (T1, sms1), (T2, sms2) = timed(stress, **kwargs), timed(stress, **kwargs)
    every = np.ones(STRESS_GRAPH["V"], bool)
    err0 = float(np.abs(_centres(sd["S_iw"].astype(np.float64)) - _centres(T_true)).max())
    err1 = float(np.abs(centres(T1, every) - _centres(T_true)).max())
    stress_equal = torch.equal(T1, T2)
    print(f"phase 13 essential graph reproducibility (F4): loop event {prob.edge_i.shape[0]} "
          f"edges, {int(keep.sum())} keyframes, two card runs "
          f"{'bit-equal' if loop_equal else 'DIFFERENT'} ({ms1:.3f} / {ms2:.3f} ms), CPU run "
          f"centres max {d_cpu:.3e} m apart; stress graph {stress.edge_i.shape[0]} edges, "
          f"{STRESS_GRAPH['V']} keyframes, two card runs "
          f"{'bit-equal' if stress_equal else 'DIFFERENT'} ({sms1:.3f} / {sms2:.3f} ms), centre "
          f"error against the truth {err0:.4f} -> {err1:.4f} m | {smi}", flush=True)
    if not loop_equal or not stress_equal or not d_cpu < LOOP_KF_TOL_M or \
            not torch.isfinite(T1).all() or not err1 < 0.5 * err0:
        raise AssertionError("essential graph: not reproducible on the card, or off the CPU")


def _phase14(smi, report):
    """Phase 14: the stereo path on the card at the KITTI-00 configuration
    over ``testing.make_stereo_frames(60)``, frame 0's stereo match and
    the first frames again on the CPU, and K1-K4 on the stereo path's
    captured inputs.  Fills ``report[k]["stereo_launches"]``; any gate
    that fails raises."""
    import numpy as np
    import torch

    from ydorbslam_tpu_torch import config as pconfig
    from ydorbslam_tpu_torch.config import camera_intrinsics
    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu_torch.ops import extractor, hamming, kernels
    from ydorbslam_tpu_torch.ops.extractor import DETECT_BORDER
    from ydorbslam_tpu_torch.ops.fast import fast_score_map, nms_and_border
    from ydorbslam_tpu_torch.ops.stereo import stereo_match
    from ydorbslam_tpu_torch.optim import lm_kernel, schur
    from ydorbslam_tpu_torch.slam import matchers, tracking, triangulate
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
    from ydorbslam_tpu_torch.testing import device_ms, kitti00_config, make_stereo_frames

    frames, gt_poses = make_stereo_frames(N_STEREO)
    cfg = kitti00_config(pconfig)
    gt = _centres(gt_poses)
    captured = {"k1": []}
    ms = {"stereo_match": [], "extract_right": []}
    waits, sites, per_frame = [], {}, []
    calls = {"extract": 0}

    def quiet_sync():
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

    def keep_k1(levels, border):
        captured["k1"] = (captured["k1"] + [tuple(levels)])[-2:]  # the last pair's images
        return orig["k1"](levels, border)

    def keep_k2(desc_a, attr_a, desc_b, attr_b, check_ur=False):
        captured[("proj_best2", bool(check_ur), desc_a.shape[0])] = tuple(
            t.clone() for t in (desc_a, attr_a, desc_b, attr_b))
        return hamming.proj_best2(desc_a, attr_a, desc_b, attr_b, check_ur)

    def keep_pairs(desc_a, attr_a, desc_b, attr_b, mode="proj"):
        captured[mode] = (desc_a, attr_a, desc_b, attr_b)
        return hamming.pair_best2(desc_a, attr_a, desc_b, attr_b, mode)

    def keep_obs(inp):
        captured["lm_obs"] = inp
        return lm_kernel.lm_obs(inp)

    def extract(*args, **kwargs):
        """The right image's extraction (every second call), synchronised."""
        calls["extract"] += 1
        if calls["extract"] % 2:
            return orig["extract"](*args, **kwargs)
        quiet_sync()
        t0 = time.perf_counter()
        out = orig["extract"](*args, **kwargs)
        quiet_sync()
        ms["extract_right"].append((time.perf_counter() - t0) * 1e3)
        return out

    def match(fl, fr, pl, pr, *args):
        """stereo_match, synchronised, with the host's waits on the card
        inside it counted by CUDA's sync debug mode."""
        quiet_sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = orig["match"](fl, fr, pl, pr, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        quiet_sync()
        ms["stereo_match"].append((time.perf_counter() - t0) * 1e3)
        found = [w for w in seen if SYNC_WARNING in str(w.message)]
        waits.append(len(found))
        for w in found:
            site = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
        per_frame.append((fl.valid.sum(), (out.valid & (out.depth > 0)).sum()))
        if "frame0" not in captured:
            captured["frame0"] = (fl, fr, pl, pr, out)
        return out

    orig = {"k1": extractor.fast_score_nms_levels, "extract": tracking._extract_orb_pyramid,
            "match": tracking.stereo_match}
    patches = [(extractor, "fast_score_nms_levels", keep_k1), (matchers, "proj_best2", keep_k2),
               (triangulate, "pair_best2", keep_pairs), (schur, "lm_obs", keep_obs),
               (tracking, "_extract_orb_pyramid", extract), (tracking, "stereo_match", match)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    system = SlamSystem(cfg, Sensor.STEREO, enable_mapping=True, enable_loop_closing=False,
                        device="cuda")
    secs, kfs = [], []
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        kernels.reset_launch_counts()
        with _pose_calls() as pose_calls:
            for t, left, right in frames:
                t0 = time.perf_counter()
                system.track_stereo(t, left, right)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                kfs.append(system.n_keyframes)
        launches = kernels.launch_counts()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    _, poses, lost = system.tracker.trajectory()
    stats = system.run_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos_tum, _ = read_tum_trajectory(path)
    ate = ate_rmse(pos_tum, gt[[int(round(t * cfg.camera.fps)) for t in ts]])
    n_lost, n_ba = sum(lost), stats["local_ba_runs"]
    steady = secs[N_STEREO_WARM:]
    kp = [int(a) for a, _ in per_frame]
    dep = [int(b) for _, b in per_frame]

    def spread(v):
        return f"{float(np.median(v)):.3f} ({min(v):.3f}-{max(v):.3f}, {len(v)} calls)"

    print(f"phase 14 stereo path (KITTI-00 configuration, {cfg.camera.width}x"
          f"{cfg.camera.height}, {cfg.n_keypoints} keypoint slots, mapping on): {len(frames)} "
          f"frames, lost {n_lost}, TUM rows {len(ts)}, ATE {ate:.6f} m (JAX on a CPU: "
          f"{JAX_CPU_ATE_STEREO}), keyframes inserted {stats['keyframes_inserted']} culled "
          f"{stats['keyframes_culled']} live {stats['keyframes_live']}, local BA runs {n_ba}, "
          f"live map points {stats['map_points_live']}, launches {launches}, "
          f"{len(steady) / sum(steady):.3f} frames/s, median "
          f"{float(np.median(steady)) * 1e3:.3f} ms/frame after {N_STEREO_WARM} warm-up frames; "
          f"synchronised ms: stereo_match {spread(ms['stereo_match'])}, second extraction "
          f"{spread(ms['extract_right'])}; keypoints per frame {min(kp)}-{max(kp)} (median "
          f"{int(np.median(kp))}), stereo depths per frame {min(dep)}-{max(dep)} (median "
          f"{int(np.median(dep))}, frame 0 {dep[0]}); host waits in stereo_match per frame "
          f"{min(waits)}-{max(waits)} (at {sites}) | {smi}", flush=True)
    if not all(np.isfinite(p).all() and p.shape == (4, 4) for p in poses):
        raise AssertionError("stereo path: non-finite or malformed pose")
    if n_lost != 0 or len(ts) != len(frames) or not np.isfinite(pos_tum).all():
        raise AssertionError(f"stereo path: lost {n_lost}, {len(ts)} TUM rows")
    if not ate < STEREO_ATE_MAX or not ate <= 1.5 * JAX_CPU_ATE_STEREO:
        raise AssertionError(f"stereo path: ATE {ate} (JAX on a CPU {JAX_CPU_ATE_STEREO})")
    if stats["keyframes_inserted"] <= 2 or n_ba < 1:
        raise AssertionError(f"stereo path: {stats['keyframes_inserted']} keyframes, {n_ba} BAs")
    expect = dict(fast_score_nms=2 * len(frames), pair_best2=3 * n_ba, lm_obs=17 * n_ba)
    if any(launches[k] != v for k, v in expect.items()) or \
            launches["proj_best2"] < 2 * (len(frames) - 1):
        raise AssertionError(f"stereo path launches {launches}, expected {expect} and "
                             f">= {2 * (len(frames) - 1)} proj_best2")
    _gate_pose_lm("stereo path", launches, pose_calls, 2 * (len(frames) - 1))
    if max(waits) != 0 or len(waits) != len(frames):
        raise AssertionError(f"stereo_match waited on the card: {waits} at {sites}")

    # Frame 0's pair: stereo_match on the card against the port on the CPU.
    fl, fr, pl, pr, out = captured["frame0"]
    ref = stereo_match(*(f._replace(**{k: v.cpu() for k, v in f._asdict().items()})
                         for f in (fl, fr)),
                       [x.cpu() for x in pl], [x.cpu() for x in pr],
                       camera_intrinsics(cfg, "cpu"), cfg.orb.n_levels, cfg.orb.scale_factor)
    valid = ref.valid.numpy()
    ok_card, ok_cpu = out.depth.cpu().numpy() > 0, ref.depth.numpy() > 0
    share = float(np.mean(ok_card[valid] == ok_cpu[valid]))
    both = ok_card & ok_cpu
    ur_err = float(np.abs(out.right_u.cpu().numpy()[both] - ref.right_u.numpy()[both]).max())

    # The first frames again on the CPU.
    cpu = SlamSystem(cfg, Sensor.STEREO, enable_mapping=True, enable_loop_closing=False,
                     device="cpu")
    t0 = time.perf_counter()
    cpu_kfs = []
    for f in frames[:N_PAR_STEREO]:
        cpu.track_stereo(*f)
        cpu_kfs.append(cpu.n_keyframes)
    cpu_s = time.perf_counter() - t0
    _, cpu_poses, cpu_lost = cpu.tracker.trajectory()
    diff = float(np.abs(_centres(cpu_poses) - _centres(poses[:N_PAR_STEREO])).max())
    print(f"phase 14 card against CPU: frame 0's stereo_match ok mask agrees on {share:.4%} of "
          f"{int(valid.sum())} keypoints ({int(ok_card.sum())} ok on the card, "
          f"{int(ok_cpu.sum())} on the CPU), right_u max {ur_err:.3e} px apart where both are "
          f"ok; first {N_PAR_STEREO} frames: lost pattern "
          f"{'identical' if cpu_lost == lost[:N_PAR_STEREO] else 'DIFFERENT'}, keyframes after "
          f"each frame {'identical' if cpu_kfs == kfs[:N_PAR_STEREO] else 'DIFFERENT'} "
          f"({cpu_kfs}), max camera-centre difference {diff:.3e} m; CPU {cpu_s:.1f} s", flush=True)
    if not share >= STEREO_OK_SHARE or not ur_err <= STEREO_UR_TOL:
        raise AssertionError(f"stereo_match card and CPU disagree: {share}, {ur_err} px")
    if cpu_lost != lost[:N_PAR_STEREO] or cpu_kfs != kfs[:N_PAR_STEREO] or not diff < 1e-3:
        raise AssertionError("CPU and CUDA stereo runs disagree")

    # K1-K4 on the stereo path's captured inputs.
    lines = []
    err1 = 0.0
    for side, lvls in zip(("left", "right"), captured["k1"]):
        outs = kernels.fast_score_nms_levels_cuda(lvls, DETECT_BORDER)
        for img, k in zip(lvls, outs):
            if not torch.equal(k, nms_and_border(fast_score_map(img), DETECT_BORDER)):
                raise AssertionError(f"K1 differs from plain on the {side} image at "
                                     f"{tuple(img.shape)}")
        _, _, px, bms, bby = _k1_work(lvls, DETECT_BORDER)
        dev = device_ms(lambda: kernels.fast_score_nms_levels_cuda(lvls, DETECT_BORDER))
        plain = device_ms(lambda: [nms_and_border(fast_score_map(x), DETECT_BORDER)
                                   for x in lvls], calls=5, reps=5)
        lines.append(f"K1 {side} image ({px} px, 8 levels, one launch): identical; device "
                     f"{dev:.4f} ms; plain device {plain:.4f} ms; bound {bms:.5f} ms ({bby})")
    for label, ur in (("motion", True), ("local map", False)):
        prob = captured[max(k for k in captured if k[0] == "proj_best2" and k[1] == ur)]
        _same_k2(prob, ur, f"stereo {label} search")
        pairs, gated, bms, bby = _k2_work(prob, ur)
        dev = device_ms(lambda: kernels.proj_best2_cuda(*prob, check_ur=ur))
        plain = device_ms(lambda: hamming.proj_best2_plain(*prob, check_ur=ur), calls=5, reps=5)
        lines.append(f"K2 {label} {prob[0].shape[0]}x{prob[2].shape[0]}: identical; {gated} of "
                     f"{pairs} pairs gated; device {dev:.4f} ms; plain device {plain:.4f} ms; "
                     f"bound {bms:.5f} ms ({bby})")
    for mode in ("epi", "proj"):
        prob = captured[mode]
        _same_k3(prob, mode, f"stereo {mode}")
        pairs, gated, bms, bby = _k3_work(prob, mode)
        dev = device_ms(lambda: kernels.pair_best2_cuda(*prob, mode=mode))
        plain = device_ms(lambda: hamming.pair_best2_plain(*prob, mode=mode), calls=5, reps=5)
        lines.append(f"K3 {mode} {tuple(prob[0].shape[:2])}x{prob[2].shape[1]}: identical; "
                     f"{gated} of {pairs} pairs gated; device {dev:.4f} ms; plain device "
                     f"{plain:.4f} ms; bound {bms:.5f} ms ({bby})")
    inp = captured["lm_obs"]
    kq, kp4 = kernels.lm_obs_cuda(inp)
    pq, pp4 = lm_kernel.lm_obs_plain(inp)
    torch.cuda.synchronize()
    err4 = 0.0
    for a, b in ((kq, pq), (kp4, pp4)):
        if a.shape != b.shape or not torch.isfinite(b).all():
            raise AssertionError("K4 plain version malformed or not finite on the stereo input")
        if ((a - b).abs() > K4_ATOL + K4_RTOL * b.abs()).any():
            raise AssertionError("K4 differs from plain on the stereo local-BA input")
        err4 = max(err4, float((a - b).abs().max()))
    _, O4, P4 = inp.shape
    bms, bby = _bound(((K4_ROWS_READ + lm_kernel.NOUT_Q) * O4 * P4 + lm_kernel.NOUT_P * P4) * 4,
                      O4 * P4 * K4_OPS_OBS)
    dev = device_ms(lambda: kernels.lm_obs_cuda(inp))
    plain = device_ms(lambda: lm_kernel.lm_obs_plain(inp), calls=5, reps=5)
    lines.append(f"K4 local BA {tuple(inp.shape)}: within rtol {K4_RTOL}, atol {K4_ATOL}, max "
                 f"abs error {err4:.3e}; device {dev:.4f} ms; plain device {plain:.4f} ms; bound "
                 f"{bms:.5f} ms ({bby})")
    k5, line = _k5_check("the stereo path's last pose solve", pose_calls["last"])
    report.setdefault("pose_lm", {}).update(stereo=k5)
    lines.append(line)
    print("phase 14 kernels on the stereo path's inputs: " + " | ".join(lines) + f" | {smi}",
          flush=True)
    for k in report:
        report[k]["stereo_launches"] = launches.get(k, 0)


def _phase15(smi, report):
    """Phase 15: the TUM runner at its default configuration on the card,
    with the viewer; a checkpoint saved on the card, resumed on the card
    and loaded on the CPU; ``update_calibration`` on the card.  Fills
    ``report[k]["tum_launches"]``; any gate that fails raises."""
    import contextlib
    import io

    import numpy as np
    import torch
    from PIL import Image

    import bench
    from ydorbslam_tpu_torch.apps import run_tum_rgbd
    from ydorbslam_tpu_torch.config import load_config
    from ydorbslam_tpu_torch.convert import map_state_to_numpy
    from ydorbslam_tpu_torch.io import TumRgbdDataset, read_tum_trajectory
    from ydorbslam_tpu_torch.io.trajectory import ate_against_groundtruth
    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.slam import serialize, system as system_mod
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
    from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_settings, write_tum_sequence
    from ydorbslam_tpu_torch.viz.headless import PeriodicViewer

    frames = bench.make_frames()
    from synthetic import oscillating_trajectory  # bench put tests/ on sys.path

    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "seq")
    yaml, assoc, gt = write_tum_sequence(root, frames, oscillating_trajectory(len(frames)),
                                         TUM_RGBD_SETTINGS)
    out = {k: os.path.join(tmp.name, f) for k, f in (
        ("traj", "CameraTrajectory.txt"), ("kf", "KeyFrameTrajectory.txt"),
        ("viz", "map.png"), ("viewer", "viewer"), ("ckpt", "checkpoint.npz"),
        ("resumed", "resumed.txt"), ("calib", "calib.yaml"))}

    # The runner, as a user calls it, with every frame and mapping_step
    # timed to its end on the card and the viewer's undrawn frames run
    # under CUDA's sync debug mode.
    secs, step_ms, draw_ms, waits, sites = [], [], [], [], {}
    orig = {"track": SlamSystem.track_rgbd, "draw": PeriodicViewer.maybe_draw,
            "step": system_mod.mapping_step}

    def track(self, *args):
        t0 = time.perf_counter()
        ok = orig["track"](self, *args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return ok

    def step(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig["step"](*args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    def draw(self, system, frame_id, gray=None):
        if frame_id % self.every == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drawn = orig["draw"](self, system, frame_id, gray)
            draw_ms.append((time.perf_counter() - t0) * 1e3)
            return drawn
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                drawn = orig["draw"](self, system, frame_id, gray)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        found = [w for w in seen if SYNC_WARNING in str(w.message)]
        waits.append(len(found))
        for w in found:
            site = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
        return drawn

    args = [yaml, root, assoc, "--groundtruth", gt, "--out-trajectory", out["traj"],
            "--out-kf-trajectory", out["kf"], "--viz", out["viz"],
            "--viewer-dir", out["viewer"], "--viewer-every", str(TUM_EVERY)]
    text = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    try:
        SlamSystem.track_rgbd = track
        PeriodicViewer.maybe_draw = draw
        system_mod.mapping_step = step
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(text), _pose_calls() as pose_calls:
            system = run_tum_rgbd.main(args)
        launches = kernels.launch_counts()
    finally:
        SlamSystem.track_rgbd = orig["track"]
        PeriodicViewer.maybe_draw = orig["draw"]
        system_mod.mapping_step = orig["step"]
    run_s = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated() / 2**20
    cfg = system.cfg
    stats = system.run_stats()
    ate, _ = ate_against_groundtruth(out["traj"], gt)
    t_run_traj, p_run, _ = read_tum_trajectory(out["traj"])
    steady = secs[N_WARM:]
    n_ba = stats["local_ba_runs"]
    drawn = [i for i in range(0, len(frames), TUM_EVERY)]
    expect_files = sorted([f"frame_{i:06d}.png" for i in drawn]
                          + [f"map_{i:06d}.png" for i in drawn])
    files = sorted(os.listdir(out["viewer"]))
    for f in files + [out["viz"]]:
        with Image.open(os.path.join(out["viewer"], f)) as img:
            img.load()
    print("phase 15 runner output: " + " | ".join(
        line.strip() for line in text.getvalue().splitlines() if line.strip()), flush=True)
    print(f"phase 15 TUM runner (python -m ydorbslam_tpu_torch.apps.run_tum_rgbd, capacities "
          f"K={cfg.capacity.max_keyframes} M={cfg.capacity.max_map_points} "
          f"O={cfg.capacity.max_obs_per_point}, min_init_depth_points "
          f"{cfg.tracking.min_init_depth_points}, loop closing "
          f"{'on' if system.loop_closer is not None else 'OFF'}): {stats['frames_total']} frames, "
          f"lost {stats['frames_lost']}, ATE {ate:.6f} m (JAX on a CPU: {JAX_CPU_ATE_TUM}), "
          f"keyframes inserted {stats['keyframes_inserted']} (JAX {JAX_CPU_KF_TUM}) culled "
          f"{stats['keyframes_culled']} live {stats['keyframes_live']}, local BA runs {n_ba}, "
          f"live map points {stats['map_points_live']}, loops closed {stats['loops_closed']} "
          f"(JAX {JAX_CPU_LOOPS_TUM}), global BA {stats['global_ba_runs']}, launches {launches}, "
          f"{len(steady) / sum(steady):.3f} frames/s, median "
          f"{float(np.median(steady)) * 1e3:.3f} ms/frame after {N_WARM} warm-up frames, "
          f"mapping_step median {float(np.median(step_ms)) if step_ms else float('nan'):.3f} ms "
          f"(min {min(step_ms, default=float('nan')):.3f}, max "
          f"{max(step_ms, default=float('nan')):.3f}, {len(step_ms)} calls), peak memory "
          f"{peak:.1f} MiB, run {run_s:.1f} s; viewer: {files}, drawn frames "
          f"{[round(v, 3) for v in draw_ms]} ms, host waits on undrawn frames "
          f"{min(waits, default=-1)}-{max(waits, default=-1)} over {len(waits)} calls (at {sites}) "
          f"| {smi}", flush=True)
    if stats["frames_total"] != len(frames) or stats["frames_lost"] != 0 or \
            len(t_run_traj) != len(frames) or not np.isfinite(p_run).all():
        raise AssertionError(f"TUM runner: {stats['frames_lost']} lost of {stats['frames_total']}")
    if cfg.capacity.max_keyframes != 512 or cfg.capacity.max_map_points != 65536 or \
            system.loop_closer is None:
        raise AssertionError("TUM runner: not at its default configuration")
    if not ate < 0.02 or not ate <= 1.5 * JAX_CPU_ATE_TUM:
        raise AssertionError(f"TUM runner: ATE {ate} (JAX on a CPU {JAX_CPU_ATE_TUM})")
    if abs(stats["keyframes_inserted"] - JAX_CPU_KF_TUM) > TUM_KF_BAND:
        raise AssertionError(f"TUM runner: {stats['keyframes_inserted']} keyframes, JAX "
                             f"{JAX_CPU_KF_TUM} +- {TUM_KF_BAND}")
    if stats["loops_closed"] != JAX_CPU_LOOPS_TUM or n_ba != len(step_ms) or n_ba < 1:
        raise AssertionError(f"TUM runner: {stats['loops_closed']} loops, {n_ba} BAs")
    expect = dict(fast_score_nms=len(frames), pair_best2=3 * n_ba, lm_obs=17 * n_ba)
    if any(launches[k] != v for k, v in expect.items()) or \
            launches["proj_best2"] < 2 * (len(frames) - 1):
        raise AssertionError(f"TUM runner launches {launches}, expected {expect} and "
                             f">= {2 * (len(frames) - 1)} proj_best2")
    _gate_pose_lm("TUM runner", launches, pose_calls, 2 * (len(frames) - 1))
    if files != expect_files or len(draw_ms) != len(drawn) or \
            len(waits) != len(frames) - len(drawn) or max(waits) != 0:
        raise AssertionError(f"viewer: files {files}, drawn {len(draw_ms)}, waits {waits}")
    for k in report:
        report[k]["tum_launches"] = launches.get(k, 0)
    del system

    # A checkpoint on the card: frames 0-59, save, load on the card, go on
    # with frames 60-119; the same file loaded on the CPU.
    cfg = load_config(yaml)
    ds = TumRgbdDataset(root, assoc, cfg.depth.depth_map_factor, is_rgb=cfg.camera.is_rgb)
    card = SlamSystem(cfg, Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                      device="cuda")
    for i in range(N_TUM_SAVE):
        card.track_rgbd(*ds[i])
        if i == 0:
            f0 = card.tracker.last_feats
            kp0 = (int(f0.valid.sum()), int((f0.valid & (f0.depth > 0)).sum()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serialize.save_system(card, out["ckpt"])
    save_ms = (time.perf_counter() - t0) * 1e3
    saved = dict(n_keyframes=card.n_keyframes, records=len(card.records),
                 map=map_state_to_numpy(card.map))
    del card
    t0 = time.perf_counter()
    resumed = serialize.load_system(out["ckpt"], cfg, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    on_cpu = serialize.load_system(out["ckpt"], cfg, device="cpu")
    cpu_load_ms = (time.perf_counter() - t0) * 1e3
    loaded = map_state_to_numpy(resumed.map)
    same = [k for k, v in loaded.items()
            if v.dtype == saved["map"][k].dtype and np.array_equal(v, saved["map"][k])
            and np.array_equal(map_state_to_numpy(on_cpu.map)[k], v)]
    counts = (resumed.n_keyframes, len(resumed.records))
    host_ok = np.array_equal(resumed._host_kf_valid, loaded["kf_valid"])
    oks = [bool(resumed.track_rgbd(*ds[i])) for i in range(N_TUM_SAVE, len(ds))]
    resumed.shutdown()
    resumed.save_trajectory_tum(out["resumed"])
    ate_res, _ = ate_against_groundtruth(out["resumed"], gt)
    t_res, p_res, _ = read_tum_trajectory(out["resumed"])
    diff = float(np.abs(p_res - p_run).max()) if np.array_equal(t_res, t_run_traj) else float("inf")
    print(f"phase 15 checkpoint on the card: frame 0 has {kp0[0]} keypoints, {kp0[1]} with a "
          f"depth; frames 0-{N_TUM_SAVE - 1} saved "
          f"({os.path.getsize(out['ckpt'])} bytes, save {save_ms:.1f} ms, load on the card "
          f"{load_ms:.1f} ms, on the CPU {cpu_load_ms:.1f} ms), keyframes / records after load "
          f"{counts} (saved {(saved['n_keyframes'], saved['records'])}), map arrays bit-equal "
          f"(saved, loaded on the card, loaded on the CPU) {len(same)} of {len(loaded)}, host slot "
          f"mask {'rebuilt' if host_ok else 'WRONG'}; frames {N_TUM_SAVE}-{len(ds) - 1} resumed: "
          f"lost {oks.count(False)}, ATE {ate_res:.6f} m (uninterrupted {ate:.6f}), max "
          f"camera-centre difference from the uninterrupted run {diff:.3e} m | {smi}", flush=True)
    if counts != (saved["n_keyframes"], saved["records"]) or not host_ok or \
            len(same) != len(loaded):
        raise AssertionError(f"checkpoint: {counts}, bit-equal {same}")
    if not all(oks) or not ate_res < max(2.0 * ate, RESUME_ATE_MIN) or \
            not diff < RESUME_CENTRE_MAX:
        raise AssertionError(f"resumed run: lost {oks.count(False)}, ATE {ate_res}, "
                             f"camera-centre difference {diff} m")

    # update_calibration on the card: a settings file whose fx differs.
    write_settings(out["calib"], dict(TUM_RGBD_SETTINGS, **{"Camera.fx": TUM_CALIB_FX}))
    calib = serialize.load_system(out["ckpt"], cfg, device="cuda")
    tracker_cfg = calib.tracker.cfg
    calib.update_calibration(out["calib"])
    cam = calib.cam
    ok = bool(calib.track_rgbd(*ds[N_TUM_SAVE]))
    print(f"phase 15 update_calibration on the card: fx {cfg.camera.fx} -> {float(cam.fx)} "
          f"(system.cam on {cam.fx.device}, tracker.cam the same: {calib.tracker.cam is cam}), "
          f"tracker.cfg unchanged: {calib.tracker.cfg is tracker_cfg}, next frame "
          f"{'tracked' if ok else 'LOST'} with {calib.tracked_map_points()} inliers", flush=True)
    if float(cam.fx) != TUM_CALIB_FX or cam.fx.device.type != "cuda" or \
            calib.tracker.cam is not cam or calib.tracker.cfg is not tracker_cfg or not ok:
        raise AssertionError("update_calibration on the card")
    tmp.cleanup()


def _map_diff(a, b):
    """How far two host maps (``map_state_to_numpy``) of one call lie
    apart: the keyframe-graph and counter fields that differ, the least
    share of equal bindings, and (largest keyframe-pose entry difference,
    median, 90th percentile and largest map-point difference in m)."""
    import numpy as np

    graph = [k for k in BURST_GRAPH if not np.array_equal(a[k], b[k])]
    bind = min(float((a[k] == b[k]).mean()) for k in BURST_BINDINGS)
    kv = a["kf_valid"] & b["kf_valid"]
    both = a["mp_valid"] & b["mp_valid"]
    d = np.linalg.norm(a["mp_pos"] - b["mp_pos"], axis=-1)[both]
    return graph, bind, np.array([np.abs(a["kf_pose"] - b["kf_pose"])[kv].max(), np.median(d),
                                  np.quantile(d, 0.9), d.max()])


def _nudged(m, seed):
    """Host map ``m`` with one coordinate of one valid map point, drawn from
    ``default_rng(seed)``, one ulp larger."""
    import numpy as np

    m = {k: v.copy() for k, v in m.items()}
    rng = np.random.default_rng(seed)
    ids = np.nonzero(m["mp_valid"])[0]
    j, c = ids[rng.integers(len(ids))], rng.integers(3)
    m["mp_pos"][j, c] = np.nextafter(m["mp_pos"][j, c], np.float32(np.inf))
    return m


class _PipeProbe:
    """The instruments that phases 17 and 19 put around the pipelined
    facade while a ``with`` block runs (all restored at its end):

    * with ``count`` on, the host's waits on the card inside each part of
      the path (``PIPE_SYNC_MAX``'s keys; ``track_attr`` is the dispatch),
      as CUDA's sync debug mode counts them, and their call sites; the
      waits of a dispatch that drained go to ``drained_waits``;
    * every drained frame's packed outcome (``infos``), the calls of
      ``mapping_prep`` and ``mapping_finish``, the K2 launches inside
      relocalizations;
    * with ``capture`` on, the first deferred BA that follows more than
      one ``mapping_prep`` in its drain, and those calls, each with its
      host map before and after (``burst``, the drain's frames in
      ``burst_frames``), for ``_replay_drain``;
    * otherwise each deferred BA's synchronised ms (``ba_ms``)."""

    def __init__(self, track_attr):
        from ydorbslam_tpu_torch.ops import kernels
        from ydorbslam_tpu_torch.slam import system as system_mod

        self.kernels, self.system_mod = kernels, system_mod
        self.Sys = system_mod.SlamSystem
        self.parts = (("dispatch", track_attr), ("drain", "_drain_batch"),
                      ("snapshot", "_consume_snapshot"), ("insert", "_insert_keyframe"),
                      ("ba", "_run_deferred_ba"), ("refresh", "_refresh_trkset"),
                      ("reloc", "_pipelined_relocalize"))
        self.waits = {k: [] for k in PIPE_SYNC_MAX}
        self.sites = {k: {} for k in PIPE_SYNC_MAX}
        self.drained_waits = []
        self.burst = self.burst_frames = None
        self.drain_calls, self.drain_frames = [], []
        self.reset()

    def reset(self, count=False, capture=False):
        """Start a run: set what is counted and captured, clear the per-run
        records and the launch counts."""
        self.count, self.capture = count, capture
        self.infos, self.ba_ms = [], []
        self.calls = {"prep": 0, "finish": 0, "reloc_k2": 0}
        self.kernels.reset_launch_counts()

    def __enter__(self):
        Sys, mod = self.Sys, self.system_mod
        self.saved = [(Sys, a, getattr(Sys, a)) for _, a in self.parts] + [
            (Sys, "_drain_one", Sys._drain_one), (mod, "mapping_prep", mod.mapping_prep),
            (mod, "mapping_finish", mod.mapping_finish)]
        for key, a in self.parts:
            setattr(Sys, a, self._counted(getattr(Sys, a), key))
        Sys._pipelined_relocalize = self._reloc(Sys._pipelined_relocalize)
        Sys._drain_one = self._drain_one(Sys._drain_one)
        mod.mapping_prep = self._prep(mod.mapping_prep)
        mod.mapping_finish = self._finish(mod.mapping_finish)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)

    @staticmethod
    def _quiet(fn):
        """``fn()`` with the sync debug mode off: the probe's own reads and
        synchronisations are not waits of the path."""
        import torch

        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def _host_map(self, m):
        import torch

        from ydorbslam_tpu_torch.convert import map_state_to_numpy

        return self._quiet(lambda: m.cpu().numpy() if isinstance(m, torch.Tensor)
                           else map_state_to_numpy(m))

    def _counted(self, fn, key):
        import torch

        def wrapper(system, *args, **kwargs):
            if key == "drain":
                self.drain_calls = []
                self.drain_frames = [fid for _, fid in system._pending]
            if not self.count:
                return fn(system, *args, **kwargs)
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(system, *args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                    found = [w for w in seen if SYNC_WARNING in str(w.message)]
                    if key == "dispatch" and not system._pending:
                        self.drained_waits.append(len(found))
                    else:
                        self.waits[key].append(len(found))
                    for w in found:
                        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
                        self.sites[key][site] = self.sites[key].get(site, 0) + 1
        return wrapper

    def _reloc(self, fn):
        """A relocalization, with the K2 launches it makes (its appearance
        matches and widening searches, beside the 3 per frame)."""
        def wrapper(system, timestamp, slot):
            before = self.kernels.launch_counts()["proj_best2"]
            try:
                return fn(system, timestamp, slot)
            finally:
                self.calls["reloc_k2"] += self.kernels.launch_counts()["proj_best2"] - before
        return wrapper

    def _drain_one(self, fn):
        def wrapper(system, timestamp, info, allow_reloc=True):
            self.infos.append((info.mode, info.ok, info.n_inliers, info.need_kf,
                               info.ring_slot, info.T_cw.tobytes()))
            return fn(system, timestamp, info, allow_reloc)
        return wrapper

    def _prep(self, fn):
        def wrapper(*args, **kwargs):
            self.calls["prep"] += 1
            if not self.capture:
                return fn(*args, **kwargs)
            before = self._host_map(args[0])
            out = fn(*args, **kwargs)
            self.drain_calls.append(dict(kind="prep", map=before, args=args[1:], kw=kwargs,
                                         out=self._host_map(out)))
            return out
        return wrapper

    def _finish(self, fn):
        import torch

        def wrapper(*args, **kwargs):
            self.calls["finish"] += 1
            if self.capture and len(self.drain_calls) > 1:
                before = self._host_map(args[0])
                out = fn(*args, **kwargs)
                self.burst = self.drain_calls + [dict(
                    kind="finish", map=before, args=args[1:], kw=kwargs,
                    out=self._host_map(out[0]), snap=self._host_map(out[1]))]
                self.burst_frames = (self.drain_frames[0], self.drain_frames[-1])
                self.capture = False
                return out
            if self.count:
                return fn(*args, **kwargs)
            self._quiet(torch.cuda.synchronize)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._quiet(torch.cuda.synchronize)
            self.ba_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper


def _replay_drain(calls, cpu):
    """One drain's ``mapping_prep`` calls and deferred BA, captured on the
    card (``calls``: each call's host map before and after, its arguments
    and, for the BA, its snapshot), again on the CPU system ``cpu``'s
    camera from the card's inputs, call by call; the BA also on the card
    from ``N_BURST_NUDGE`` one-ulp nudges of its input.  Returns the rows
    (keyframe, graph fields that differ, least share of equal bindings,
    ``_map_diff``'s distances) of the preps, whether every prep is within
    the bounds of ``BURST_GRAPH``'s comment, the BA's (graph, bindings,
    distances, snapshot rows equal, the card's own spread) or None, and
    the seconds."""
    import numpy as np

    from ydorbslam_tpu_torch.convert import map_state_from_numpy, map_state_to_numpy
    from ydorbslam_tpu_torch.slam import mapping as mapping_mod

    rows, prep_ok, ba = [], True, None
    t0 = time.perf_counter()
    for c in calls or []:
        src = map_state_from_numpy(c["map"])
        if c["kind"] == "prep":
            kf_id, kf_count, _ = c["args"]
            out = map_state_to_numpy(mapping_mod.mapping_prep(src, kf_id, kf_count, cpu.cam,
                                                              **c["kw"]))
            graph, bind, d = _map_diff(out, c["out"])
            prep_ok &= not graph and bind > 0.995 and d[1] < 1e-3 and d[3] < PIPE_PREP_MAX_M
            rows.append((kf_id, graph, bind, d))
            continue
        kf_id, cam, tab, thr = c["args"]
        m, snap = mapping_mod.mapping_finish(src, kf_id, cpu.cam, cpu.inv_sigma2_tab, thr.cpu(),
                                             **c["kw"])
        graph, bind, d = _map_diff(map_state_to_numpy(m), c["out"])
        K = len(c["out"]["kf_valid"])
        same_snap = np.array_equal(snap[:4 * K].numpy(), c["snap"][:4 * K])
        spread = np.zeros(4)
        for seed in range(N_BURST_NUDGE):
            nudged = map_state_from_numpy(_nudged(c["map"], seed), device=thr.device)
            out = mapping_mod.mapping_finish(nudged, kf_id, cam, tab, thr, **c["kw"])[0]
            spread = np.maximum(spread, _map_diff(map_state_to_numpy(out), c["out"])[2])
        ba = (graph, bind, d, same_snap, spread)
    return rows, prep_ok, ba, time.perf_counter() - t0


def _drain_ms(spans, n_frames):
    """The drains' parts (the ``drain.*`` spans of a ``trace`` recording):
    total ms per frame by name."""
    from ydorbslam_tpu_torch.trace import durations

    return {k: sum(v) / 1e6 / n_frames for k, v in durations(spans).items()
            if k.startswith("drain.")}


def _bench_run(system, frames, n_warm=N_WARM):
    """bench.run's call sequence: ``n_warm`` frames, ``flush_pipeline``,
    then, recorded by ``trace``, the other frames each timed to the end of
    its dispatch and ``shutdown`` timed.  Returns (dispatch seconds of the
    timed frames, whether each drained, shutdown seconds, the recording's
    spans)."""
    from ydorbslam_tpu_torch import trace

    for f in frames[:n_warm]:
        system.track_rgbd_pipelined(*f)
    system.flush_pipeline()
    secs, drained = [], []
    trace.enable()
    try:
        for f in frames[n_warm:]:
            t0 = time.perf_counter()
            system.track_rgbd_pipelined(*f)
            secs.append(time.perf_counter() - t0)
            drained.append(not system._pending)
        t0 = time.perf_counter()
        system.shutdown()
        shutdown_s = time.perf_counter() - t0
    finally:
        spans, _ = trace.take()
    return secs, drained, shutdown_s, spans


def _phase17(smi, report):
    """Phase 17: the pipelined RGB-D path at bench.py's configuration on
    the card, a repeat of frames 0-59 in the same call, the first 30
    frames again on the CPU.  Fills ``report[k]["pipe_launches"]``; any
    gate that fails raises."""
    import numpy as np

    import bench
    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    frames = bench.make_frames()
    from synthetic import oscillating_trajectory  # bench put tests/ on sys.path

    gt = _centres(oscillating_trajectory(len(frames)))
    Sys = SlamSystem

    def make(device):
        system = SlamSystem(_config(), Sensor.RGBD, enable_mapping=True,
                            enable_loop_closing=False, device=device)
        system.enable_pipelined(lag=PIPE_LAG)
        system.frame_trace = []
        return system

    def run(system, frames, count=False):
        # The repeat run counts the waits and captures the burst (the run's
        # first deferred BA, after frame 38) with its drain's mapping_prep calls.
        probe.reset(count=count, capture=count)
        with _pose_calls() as pose:
            out = _bench_run(system, frames)
        probe.calls["pose"] = pose["calls"]
        return out, kernels.launch_counts(), list(probe.infos), dict(probe.calls)

    with _PipeProbe("track_rgbd_pipelined") as probe:
        # A: the gated run, timed as bench.py times it.
        system = make("cuda")
        t0 = time.perf_counter()
        system.precompile()
        pre_s = time.perf_counter() - t0
        (secs, drained, flush_s, spans), launches, infos, calls = run(system, frames)
        perf = _drain_ms(spans, len(secs))
        stats = system.run_stats()
        trace = [t[1:] for t in system.frame_trace]
        last_tracked = not system.records[-1].lost
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "CameraTrajectory.txt")
            system.save_trajectory_tum(path)
            ts, pos_tum, _ = read_tum_trajectory(path)
        frame_of = {t: i for i, (t, _, _) in enumerate(frames)}
        rows = [frame_of[min(frame_of, key=lambda x: abs(x - t))] for t in ts]
        ate = ate_rmse(pos_tum, gt[rows])
        ba_ms = list(probe.ba_ms)
        del system

        # B: frames 0-59 again in this call, the host's waits counted.
        system = make("cuda")
        system.precompile()
        _, _, infos_b, _ = run(system, frames[:N_PIPE_REPEAT], count=True)
        trace_b = [t[1:] for t in system.frame_trace]
        burst = probe.burst
        del system
    waits, sites, drained_waits = probe.waits, probe.sites, probe.drained_waits

    # The CPU: the first 30 frames in bench.run's sequence.
    cpu = make("cpu")
    cpu_infos = []
    orig_one = Sys._drain_one
    try:
        Sys._drain_one = lambda self, t, info, allow_reloc=True: (
            cpu_infos.append(info), orig_one(self, t, info, allow_reloc))[1]
        _bench_run(cpu, frames[:N_PAR_PIPE])
    finally:
        Sys._drain_one = orig_one
    cpu_trace = [t[1:] for t in cpu.frame_trace]
    card_T = [np.frombuffer(i[5]).reshape(4, 4) for i in infos[:N_PAR_PIPE]]

    # The burst's drain again on the CPU from the card's inputs, call by
    # call; the deferred BA also on the card from one-ulp nudges of its input.
    burst_rows, prep_ok, ba, t_replay = _replay_drain(burst, cpu)
    ba_graph, ba_bind, ba_d, ba_snap, spread = ba or ([], 0.0, None, False, None)
    cpu_diff = float(np.abs(_centres([i.T_cw for i in cpu_infos]) - _centres(card_T)).max())
    same_cpu = [(t[1], t[4]) for t in cpu_trace] == [(t[1], t[4]) for t in trace[:N_PAR_PIPE]]

    n = len(frames)
    lost = stats["frames_lost"]
    steady = secs
    fps = len(steady) / (sum(steady) + flush_s)
    disp = [s for s, d in zip(steady, drained) if not d]
    drains = [s for s, d in zip(steady, drained) if d]
    same_b = infos_b == infos[:N_PIPE_REPEAT] and trace_b == trace[:N_PIPE_REPEAT]
    n_prep, n_fin = calls["prep"], calls["finish"]
    print(f"phase 17 pipelined path (bench.py's configuration: lag {PIPE_LAG}, precompile, "
          f"{N_WARM} warm-up frames, flush, {n - N_WARM} frames, shutdown): {n} frames, lost "
          f"{lost} (JAX on a CPU {JAX_CPU_LOST_PIPE}, at most {JAX_CPU_PIPE_LOST_MAX} perturbed), "
          f"TUM rows {len(ts)}, ATE {ate:.6f} m (JAX on a CPU {JAX_CPU_ATE_PIPE}, at most "
          f"{JAX_CPU_PIPE_ATE_MAX} perturbed), keyframes inserted "
          f"{stats['keyframes_inserted']} (JAX {JAX_CPU_KF_PIPE}) culled "
          f"{stats['keyframes_culled']} live {stats['keyframes_live']}, mapping_prep {n_prep}, "
          f"deferred local BAs {n_fin} "
          f"(stats {stats['local_ba_runs']}), live map points {stats['map_points_live']}, "
          f"launches {launches}; {fps:.3f} frames/s as bench.py computes it (dispatches of "
          f"frames {N_WARM}-{n - 1} plus the final flush {flush_s * 1e3:.1f} ms), median "
          f"dispatch {float(np.median(disp)) * 1e3:.3f} ms ({len(disp)} not draining), median "
          f"drain {float(np.median(drains)) * 1e3 if drains else float('nan'):.3f} ms "
          f"({len(drains)} drains), deferred BA {[round(v, 3) for v in ba_ms]} ms "
          f"(synchronised), drain spans per frame ms "
          f"{({k: round(v, 3) for k, v in sorted(perf.items())})}, precompile {pre_s:.2f} s "
          f"| {smi}", flush=True)
    print(f"phase 17 frame trace of the run: lost {[i for i, t in enumerate(trace) if not t[1]]} "
          f"({stats['reloc_successes']} relocalizations, {calls['reloc_k2']} K2 launches in "
          f"them), inserted {[i for i, t in enumerate(trace) if t[4]]}, inliers "
          f"{[t[2] for t in trace]}; frames 0-{N_PIPE_SAME - 1} against JAX's trace: inliers "
          f"apart by at most "
          f"{max(abs(t[2] - j) for t, j in zip(trace, JAX_CPU_PIPE_INLIERS))}", flush=True)
    print(f"phase 17 host waits on the card (CUDA sync debug mode, repeat run of frames 0-"
          f"{N_PIPE_REPEAT - 1}; max per call, calls): "
          + ", ".join(f"{k} {max(v, default=0)} ({len(v)})" for k, v in waits.items())
          + f", dispatches that drained (their own) {max(drained_waits, default=0)} "
          f"({len(drained_waits)}); sites {sites}", flush=True)
    print("phase 17 burst drain (the first deferred BA's, frame 38's) on the CPU from the card's "
          "inputs, call by call: mapping_prep on keyframe k: graph fields that differ, least "
          "share of equal bindings, points' median / largest difference (m): "
          + "; ".join(f"k {k}: {g or 'none'}, {b:.5f}, {d[1]:.3e} / {d[3]:.3e}"
                      for k, g, b, d in burst_rows)
          + (f"; deferred BA: graph {ba_graph or 'none'}, bindings {ba_bind:.5f}, snapshot rows "
             f"{'equal' if ba_snap else 'DIFFERENT'}, pose entry / points' median / 90th "
             f"percentile / largest difference {[float(f'{v:.4g}') for v in ba_d]} against the "
             f"card's own spread under {N_BURST_NUDGE} one-ulp nudges of its input "
             f"{[float(f'{v:.4g}') for v in spread]}" if burst else " (NO burst captured)")
          + f"; replay {t_replay:.1f} s", flush=True)
    print(f"phase 17 repeat of frames 0-{N_PIPE_REPEAT - 1} in this call: per-frame outcomes "
          f"{'bit-equal' if same_b else 'DIFFERENT'} ({len(infos_b)} rows); CPU parity over "
          f"frames 0-{N_PAR_PIPE - 1}: lost and insertions "
          f"{'identical' if same_cpu else 'DIFFERENT'} (CPU {cpu_trace}), max track-time "
          f"camera-centre difference {cpu_diff:.3e} m", flush=True)
    if stats["frames_total"] != n or len(ts) + lost != n or not np.isfinite(pos_tum).all():
        raise AssertionError(f"pipelined path: {stats['frames_total']} records, {len(ts)} rows")
    head = trace[:N_PIPE_SAME]
    if [t[1] for t in head] != [True] * N_PIPE_SAME or \
            [i for i, t in enumerate(head) if t[3]] != list(JAX_CPU_PIPE_NEED) or \
            [i for i, t in enumerate(head) if t[4]] != list(JAX_CPU_PIPE_INSERTED) or \
            max(abs(t[2] - j) for t, j in zip(head, JAX_CPU_PIPE_INLIERS)) > 2:
        raise AssertionError(f"pipelined path: frames 0-{N_PIPE_SAME - 1} differ from JAX's trace")
    lost_frames = [i for i, t in enumerate(trace) if not t[1]]
    runs = [r for r in np.split(np.asarray(lost_frames), np.where(np.diff(lost_frames) > 1)[0] + 1)
            if len(r)]
    if lost > JAX_CPU_PIPE_LOST_MAX or any(len(r) > PIPE_LAG for r in runs) or \
            stats["reloc_successes"] < len(runs) or not last_tracked:
        raise AssertionError(f"pipelined path: lost frames {lost_frames} (JAX at most "
                             f"{JAX_CPU_PIPE_LOST_MAX}; {stats['reloc_successes']} "
                             f"relocalizations)")
    if not ate <= 1.5 * JAX_CPU_PIPE_ATE_MAX:
        raise AssertionError(f"pipelined path: ATE {ate} (JAX {JAX_CPU_ATE_PIPE}, at most "
                             f"{JAX_CPU_PIPE_ATE_MAX} under one-ulp nudges)")
    if not burst or [c["kind"] for c in burst] != ["prep"] * (len(burst) - 1) + ["finish"] or \
            len(burst) < 3 or not prep_ok:
        raise AssertionError(f"pipelined path: the burst's mapping_prep on the card and the CPU "
                             f"disagree, or no burst ({burst_rows})")
    if ba_graph or not ba_bind > 0.995 or not ba_snap or not (ba_d[:3] <= 1.5 * spread[:3]).all():
        raise AssertionError(f"pipelined path: the burst's deferred BA on the card and the CPU "
                             f"disagree beyond the card's own spread ({ba_d} vs {spread})")
    if abs(stats["keyframes_inserted"] - JAX_CPU_KF_PIPE) > TUM_KF_BAND:
        raise AssertionError(f"pipelined path: {stats['keyframes_inserted']} keyframes, JAX "
                             f"{JAX_CPU_KF_PIPE} +- {TUM_KF_BAND}")
    expect = dict(fast_score_nms=n, proj_best2=3 * n + calls["reloc_k2"], pair_best2=3 * n_prep,
                  lm_obs=17 * n_fin, pose_lm=calls["pose"])
    if launches != expect or n_fin != stats["local_ba_runs"] or n_fin < 1 or n_prep < 1 or \
            calls["pose"] < 2 * (n - 1):
        raise AssertionError(f"pipelined path launches {launches}, expected {expect}")
    over = {k: max(v) for k, v in waits.items() if v and max(v) > PIPE_SYNC_MAX[k]}
    if over or not waits["dispatch"] or max(drained_waits, default=0) > PIPE_SYNC_MAX["dispatch"]:
        raise AssertionError(f"pipelined path host waits over {PIPE_SYNC_MAX}: {over}, "
                             f"drained dispatches {drained_waits}, sites {sites}")
    if not same_b:
        raise AssertionError(f"pipelined path: the repeat of frames 0-{N_PIPE_REPEAT - 1} differs")
    if not same_cpu or not cpu_diff < PIPE_TOL_M:
        raise AssertionError(f"pipelined path: card and CPU disagree ({cpu_diff} m)")
    for k in report:
        report[k]["pipe_launches"] = launches.get(k, 0)


def _phase18(smi, report):
    """Phase 18: the TUM runner with ``--pipelined`` at its defaults on phase
    15's directory.  Fills ``report[k]["tum_pipe_launches"]``; any gate
    that fails raises."""
    import contextlib
    import io

    import numpy as np

    import bench
    from ydorbslam_tpu_torch.apps import run_tum_rgbd
    from ydorbslam_tpu_torch.io.trajectory import ate_against_groundtruth
    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.slam import system as system_mod
    from ydorbslam_tpu_torch.slam.system import SlamSystem
    from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_tum_sequence

    frames = bench.make_frames()
    from synthetic import oscillating_trajectory  # bench put tests/ on sys.path

    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "seq")
    yaml, assoc, gt = write_tum_sequence(root, frames, oscillating_trajectory(len(frames)),
                                         TUM_RGBD_SETTINGS)
    out = {k: os.path.join(tmp.name, f) for k, f in (
        ("traj", "CameraTrajectory.txt"), ("kf", "KeyFrameTrajectory.txt"))}
    secs, calls, pre = [], {"prep": 0, "finish": 0}, {}
    orig = {"track": SlamSystem.track_rgbd_pipelined, "pre": SlamSystem.precompile,
            "shutdown": SlamSystem.shutdown, "prep": system_mod.mapping_prep,
            "finish": system_mod.mapping_finish}

    def track(self, *args):
        t0 = time.perf_counter()
        orig["track"](self, *args)
        secs.append(time.perf_counter() - t0)

    def precompile(self):
        t0 = time.perf_counter()
        orig["pre"](self)
        pre["s"] = time.perf_counter() - t0
        kernels.reset_launch_counts()  # the run's counts start after it
        calls.update(prep=0, finish=0, calls=0)

    def shutdown(self):
        t0 = time.perf_counter()
        orig["shutdown"](self)
        pre["flush"] = time.perf_counter() - t0

    def prep(*args, **kwargs):
        calls["prep"] += 1
        return orig["prep"](*args, **kwargs)

    def finish(*args, **kwargs):
        calls["finish"] += 1
        return orig["finish"](*args, **kwargs)

    args = [yaml, root, assoc, "--groundtruth", gt, "--pipelined", "--out-trajectory",
            out["traj"], "--out-kf-trajectory", out["kf"]]
    text = io.StringIO()
    t_run = time.perf_counter()
    try:
        SlamSystem.track_rgbd_pipelined, SlamSystem.precompile = track, precompile
        SlamSystem.shutdown = shutdown
        system_mod.mapping_prep, system_mod.mapping_finish = prep, finish
        with contextlib.redirect_stdout(text), _pose_calls(calls):
            system = run_tum_rgbd.main(args)
        launches = kernels.launch_counts()
    finally:
        SlamSystem.track_rgbd_pipelined, SlamSystem.precompile = orig["track"], orig["pre"]
        SlamSystem.shutdown = orig["shutdown"]
        system_mod.mapping_prep, system_mod.mapping_finish = orig["prep"], orig["finish"]
    run_s = time.perf_counter() - t_run
    cfg = system.cfg
    stats = system.run_stats()
    ate, _ = ate_against_groundtruth(out["traj"], gt)
    steady = secs[N_WARM:]
    fps = len(steady) / (sum(steady) + pre["flush"])
    print("phase 18 runner output: " + " | ".join(
        line.strip() for line in text.getvalue().splitlines() if line.strip()), flush=True)
    print(f"phase 18 TUM runner --pipelined (lag {system._pipe_lag}, capacities "
          f"K={cfg.capacity.max_keyframes} M={cfg.capacity.max_map_points}, loop closing "
          f"{'on' if system.loop_closer is not None else 'OFF'}): {stats['frames_total']} "
          f"frames, lost {stats['frames_lost']}, ATE {ate:.6f} m (JAX's runner --pipelined on a "
          f"CPU: {JAX_CPU_ATE_TUM_PIPE}), keyframes inserted {stats['keyframes_inserted']} (JAX "
          f"{JAX_CPU_KF_TUM_PIPE}) culled {stats['keyframes_culled']} live "
          f"{stats['keyframes_live']}, mapping_prep {calls['prep']}, deferred local BAs "
          f"{calls['finish']}, loops closed {stats['loops_closed']} (JAX "
          f"{JAX_CPU_LOOPS_TUM_PIPE}), launches {launches}, {fps:.3f} frames/s over frames "
          f"{N_WARM}-{len(secs) - 1} (dispatches plus the final flush "
          f"{pre['flush'] * 1e3:.1f} ms), median dispatch "
          f"{float(np.median(steady)) * 1e3:.3f} ms, precompile {pre['s']:.2f} s, run "
          f"{run_s:.1f} s | {smi}", flush=True)
    if stats["frames_total"] != len(frames) or stats["frames_lost"] != 0 or ate is None:
        raise AssertionError(f"TUM runner --pipelined: {stats['frames_lost']} lost")
    if cfg.capacity.max_keyframes != 512 or system.loop_closer is None or \
            system._pipe_lag != PIPE_LAG:
        raise AssertionError("TUM runner --pipelined: not at its default configuration")
    if not ate < 0.02 or not ate <= 1.5 * JAX_CPU_ATE_TUM_PIPE:
        raise AssertionError(f"TUM runner --pipelined: ATE {ate} (JAX {JAX_CPU_ATE_TUM_PIPE})")
    if abs(stats["keyframes_inserted"] - JAX_CPU_KF_TUM_PIPE) > TUM_KF_BAND or \
            stats["loops_closed"] != JAX_CPU_LOOPS_TUM_PIPE:
        raise AssertionError(f"TUM runner --pipelined: {stats['keyframes_inserted']} "
                             f"keyframes, {stats['loops_closed']} loops")
    expect = dict(fast_score_nms=len(frames), pair_best2=3 * calls["prep"],
                  lm_obs=17 * calls["finish"])
    if any(launches[k] != v for k, v in expect.items()) or \
            launches["proj_best2"] < 3 * len(frames) or calls["finish"] < 1:
        raise AssertionError(f"TUM runner --pipelined launches {launches}, expected {expect} "
                             f"and >= {3 * len(frames)} proj_best2")
    _gate_pose_lm("TUM runner --pipelined", launches, calls, 2 * (len(frames) - 1))
    for k in report:
        report[k]["tum_pipe_launches"] = launches.get(k, 0)
    tmp.cleanup()


def _phase19(smi, report):
    """Phase 19: the pipelined stereo path at the KITTI-00 configuration on
    the card, a repeat of frames 0-29 in the same call under CUDA's sync
    debug mode, the first drain that inserts more than one keyframe again
    on the CPU call by call, frame 0's pipelined ``stereo_match`` and the
    first 10 frames again on the CPU, K1 and K2 on the path's last inputs.
    Fills ``report[k]["stereo_pipe_launches"]``; any gate that fails
    raises."""
    import numpy as np
    import torch

    from ydorbslam_tpu_torch import trace as recorder
    from ydorbslam_tpu_torch import config as pconfig
    from ydorbslam_tpu_torch.config import camera_intrinsics
    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu_torch.ops import extractor, kernels
    from ydorbslam_tpu_torch.ops import stereo as stereo_mod
    from ydorbslam_tpu_torch.ops.extractor import DETECT_BORDER
    from ydorbslam_tpu_torch.ops.fast import fast_score_map, nms_and_border
    from ydorbslam_tpu_torch.slam import matchers
    from ydorbslam_tpu_torch.slam import pipeline as pipeline_mod
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
    from ydorbslam_tpu_torch.testing import device_ms, kitti00_config, make_stereo_frames

    frames, gt_poses = make_stereo_frames(N_STEREO)
    cfg = kitti00_config(pconfig)
    gt = _centres(gt_poses)
    Sys = SlamSystem
    orig = {"k1": extractor.fast_score_nms_levels, "k2": matchers.proj_best2,
            "match": pipeline_mod.stereo_match}
    kept = {"k1": [], "k2": {}, "frame0": None, "arm": False}

    def keep_k1(levels, border):
        kept["k1"] = (kept["k1"] + [tuple(levels)])[-2:]  # the last pair's images
        return orig["k1"](levels, border)

    def keep_k2(desc_a, attr_a, desc_b, attr_b, check_ur=False):
        kept["k2"][(bool(check_ur), desc_a.shape[0])] = tuple(
            t.clone() for t in (desc_a, attr_a, desc_b, attr_b))
        return orig["k2"](desc_a, attr_a, desc_b, attr_b, check_ur)

    def match(fl, fr, pl, pr, *args, **kwargs):
        out = orig["match"](fl, fr, pl, pr, *args, **kwargs)
        if kept["arm"]:  # frame 0's, after precompile's scratch step
            kept["frame0"] = (fl, fr, pl, pr, out)
            kept["arm"] = False
        return out

    def make(device):
        system = SlamSystem(cfg, Sensor.STEREO, enable_mapping=True, enable_loop_closing=False,
                            device=device)
        system.enable_pipelined(lag=PIPE_LAG)
        system.frame_trace = []
        return system

    def run(system, frames, count=False, capture=False):
        """The frames through ``track_stereo_pipelined``, each timed to the
        end of its dispatch, then ``shutdown`` timed, all recorded by
        ``ydorbslam_tpu_torch.trace``."""
        probe.reset(count=count, capture=capture)
        secs, drained = [], []
        recorder.enable()
        try:
            with _pose_calls() as pose:
                for f in frames:
                    t0 = time.perf_counter()
                    system.track_stereo_pipelined(*f)
                    secs.append(time.perf_counter() - t0)
                    drained.append(not system._pending)
                t0 = time.perf_counter()
                system.shutdown()
                shut_s = time.perf_counter() - t0
            probe.calls["pose"] = pose["calls"]
        finally:
            spans, _ = recorder.take()
        return (secs, drained, shut_s, spans), kernels.launch_counts()

    patches = [(extractor, "fast_score_nms_levels", keep_k1), (matchers, "proj_best2", keep_k2),
               (pipeline_mod, "stereo_match", match)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        with _PipeProbe("track_stereo_pipelined") as probe:
            # A: the gated run; the first multi-keyframe drain captured.
            system = make("cuda")
            t0 = time.perf_counter()
            system.precompile()
            pre_s = time.perf_counter() - t0
            kept["arm"] = True
            (secs, drained, shut_s, spans), launches = run(system, frames, capture=True)
            infos, calls = list(probe.infos), dict(probe.calls)
            perf = _drain_ms(spans, len(secs))
            stats = system.run_stats()
            trace = [t[1:] for t in system.frame_trace]
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "CameraTrajectory.txt")
                system.save_trajectory_tum(path)
                ts, pos_tum, _ = read_tum_trajectory(path)
            ate = ate_rmse(pos_tum, gt[[int(round(t * cfg.camera.fps)) for t in ts]])
            ba_ms = list(probe.ba_ms)
            del system

            # B: frames 0-29 again in this call, the host's waits counted.
            system = make("cuda")
            system.precompile()
            run(system, frames[:N_STEREO_PIPE_REPEAT], count=True)
            infos_b = list(probe.infos)
            trace_b = [t[1:] for t in system.frame_trace]
            del system
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    waits, sites, drained_waits = probe.waits, probe.sites, probe.drained_waits
    burst, burst_frames, frame0 = probe.burst, probe.burst_frames, kept["frame0"]
    k1_last, k2_last = kept["k1"], kept["k2"]

    # The first frames on the CPU, pipelined.
    cpu = make("cpu")
    cpu_infos = []
    orig_one = Sys._drain_one
    try:
        Sys._drain_one = lambda self, t, info, allow_reloc=True: (
            cpu_infos.append(info), orig_one(self, t, info, allow_reloc))[1]
        t0 = time.perf_counter()
        for f in frames[:N_PAR_STEREO_PIPE]:
            cpu.track_stereo_pipelined(*f)
        cpu.shutdown()
        cpu_s = time.perf_counter() - t0
    finally:
        Sys._drain_one = orig_one
    cpu_trace = [t[1:] for t in cpu.frame_trace]
    card_T = [np.frombuffer(i[5]).reshape(4, 4) for i in infos[:N_PAR_STEREO_PIPE]]
    cpu_diff = float(np.abs(_centres([i.T_cw for i in cpu_infos]) - _centres(card_T)).max())
    same_cpu = [(t[1], t[4]) for t in cpu_trace] == \
        [(t[1], t[4]) for t in trace[:N_PAR_STEREO_PIPE]]

    # Frame 0's pipelined stereo_match on the card against the port on the
    # CPU from the same inputs; how many octave-0 keypoints' SAD costs the
    # level-0 wrap changes.
    fl, fr, pl, pr, out = frame0
    cam_cpu = camera_intrinsics(cfg, "cpu")
    sad_args = []
    orig_sad = stereo_mod.sad_costs

    def keep_sad(*args, **kwargs):
        sad_args.append(args)
        return orig_sad(*args, **kwargs)

    stereo_mod.sad_costs = keep_sad
    try:
        ref = stereo_mod.stereo_match(
            *(f._replace(**{k: v.cpu() for k, v in f._asdict().items()}) for f in (fl, fr)),
            [x.cpu() for x in pl], [x.cpu() for x in pr], cam_cpu, cfg.orb.n_levels,
            cfg.orb.scale_factor, wrap_level0=True)
    finally:
        stereo_mod.sad_costs = orig_sad
    valid = ref.valid.numpy()
    ok_card, ok_cpu = out.depth.cpu().numpy() > 0, ref.depth.numpy() > 0
    share = float(np.mean(ok_card[valid] == ok_cpu[valid]))
    both = ok_card & ok_cpu
    ur_err = float(np.abs(out.right_u.cpu().numpy()[both] - ref.right_u.numpy()[both]).max())
    octave = sad_args[0][2]
    wrapped, plain = orig_sad(*sad_args[0][:5], wrap_level0=True), orig_sad(*sad_args[0][:5])
    row0 = (octave == 0) & ref.valid
    n_wrap = int(((wrapped != plain).any(dim=1) & row0).sum())

    # The first multi-keyframe drain again on the CPU from the card's inputs.
    burst_rows, prep_ok, ba, t_replay = _replay_drain(burst, cpu)
    ba_graph, ba_bind, ba_d, ba_snap, spread = ba or ([], 0.0, None, False, None)

    # K1 on both images' last levels and K2 on the path's last inputs.
    lines = []
    for side, lvls in zip(("left", "right"), k1_last):
        outs = kernels.fast_score_nms_levels_cuda(lvls, DETECT_BORDER)
        for img, k in zip(lvls, outs):
            if not torch.equal(k, nms_and_border(fast_score_map(img), DETECT_BORDER)):
                raise AssertionError(f"K1 differs from plain on the pipelined {side} image at "
                                     f"{tuple(img.shape)}")
        dev = device_ms(lambda: kernels.fast_score_nms_levels_cuda(lvls, DETECT_BORDER))
        lines.append(f"K1 {side} image: identical; device {dev:.4f} ms")
    for label, ur in (("motion", True), ("local map", False)):
        prob = k2_last[max(k for k in k2_last if k[0] == ur)]
        _same_k2(prob, ur, f"pipelined stereo {label} search")
        dev = device_ms(lambda: kernels.proj_best2_cuda(*prob, check_ur=ur))
        lines.append(f"K2 {label} {prob[0].shape[0]}x{prob[2].shape[0]}: identical; device "
                     f"{dev:.4f} ms")

    n = len(frames)
    lost = stats["frames_lost"]
    steady = secs[N_STEREO_WARM:]
    fps = len(steady) / (sum(steady) + shut_s)
    disp = [t for t, d in zip(steady, drained[N_STEREO_WARM:]) if not d]
    drains = [t for t, d in zip(secs, drained) if d]
    same_b = infos_b == infos[:N_STEREO_PIPE_REPEAT] and trace_b == trace[:N_STEREO_PIPE_REPEAT]
    n_prep, n_fin = calls["prep"], calls["finish"]
    head = trace[:N_STEREO_PIPE_SAME]
    inl_gap = max(abs(t[2] - j) for t, j in zip(head, JAX_CPU_STEREO_PIPE_INLIERS))
    print(f"phase 19 pipelined stereo path (KITTI-00 configuration, {cfg.camera.width}x"
          f"{cfg.camera.height}, {cfg.n_keypoints} keypoint slots, lag {PIPE_LAG}, precompile, "
          f"uint8 pairs): {n} frames, lost {lost} (JAX on a CPU {JAX_CPU_LOST_STEREO_PIPE}), TUM "
          f"rows {len(ts)}, ATE {ate:.6f} m (JAX on a CPU {JAX_CPU_ATE_STEREO_PIPE}), keyframes "
          f"inserted {stats['keyframes_inserted']} (JAX {JAX_CPU_KF_STEREO_PIPE}) culled "
          f"{stats['keyframes_culled']} live {stats['keyframes_live']}, mapping_prep {n_prep}, "
          f"deferred local BAs {n_fin} (stats {stats['local_ba_runs']}), live map points "
          f"{stats['map_points_live']}, launches {launches}; {fps:.3f} frames/s as bench.py "
          f"counts it (dispatches of frames {N_STEREO_WARM}-{n - 1} plus the final shutdown "
          f"{shut_s * 1e3:.1f} ms), median dispatch {float(np.median(disp)) * 1e3:.3f} ms "
          f"({len(disp)} not draining), median drain "
          f"{float(np.median(drains)) * 1e3 if drains else float('nan'):.3f} ms ({len(drains)} "
          f"drains; the capture's host copies are in the drain of frames {burst_frames}), "
          f"deferred BA {[round(v, 3) for v in ba_ms]} ms (synchronised), drain spans per "
          f"frame ms "
          f"{({k: round(v, 3) for k, v in sorted(perf.items())})}, precompile {pre_s:.2f} s "
          f"| {smi}", flush=True)
    print(f"phase 19 frame trace: lost {[i for i, t in enumerate(trace) if not t[1]]} "
          f"({stats['reloc_successes']} relocalizations, {calls['reloc_k2']} K2 launches in "
          f"them), asked {[i for i, t in enumerate(trace) if t[3]]}, inserted "
          f"{[i for i, t in enumerate(trace) if t[4]]}, inliers {[t[2] for t in trace]}; frames "
          f"0-{N_STEREO_PIPE_SAME - 1} against JAX's trace: inliers apart by at most {inl_gap}",
          flush=True)
    print(f"phase 19 host waits on the card (CUDA sync debug mode, repeat run of frames 0-"
          f"{N_STEREO_PIPE_REPEAT - 1}; max per call, calls): "
          + ", ".join(f"{k} {max(v, default=0)} ({len(v)})" for k, v in waits.items())
          + f", dispatches that drained (their own) {max(drained_waits, default=0)} "
          f"({len(drained_waits)}); sites {sites}; per-frame outcomes "
          f"{'bit-equal' if same_b else 'DIFFERENT'} to the gated run's ({len(infos_b)} rows)",
          flush=True)
    print(f"phase 19 drain of frames {burst_frames} on the CPU from the card's inputs, call by "
          "call: mapping_prep on keyframe k: graph fields that differ, least share of equal "
          "bindings, points' median / largest difference (m): "
          + "; ".join(f"k {k}: {g or 'none'}, {b:.5f}, {d[1]:.3e} / {d[3]:.3e}"
                      for k, g, b, d in burst_rows)
          + (f"; deferred BA: graph {ba_graph or 'none'}, bindings {ba_bind:.5f}, snapshot rows "
             f"{'equal' if ba_snap else 'DIFFERENT'}, pose entry / points' median / 90th "
             f"percentile / largest difference {[float(f'{v:.4g}') for v in ba_d]} against the "
             f"card's own spread under {N_BURST_NUDGE} one-ulp nudges of its input "
             f"{[float(f'{v:.4g}') for v in spread]}" if ba else " (NO deferred BA captured)")
          + f"; replay {t_replay:.1f} s", flush=True)
    print(f"phase 19 card against CPU: frame 0's pipelined stereo_match ok mask agrees on "
          f"{share:.4%} of {int(valid.sum())} keypoints ({int(ok_card.sum())} ok on the card, "
          f"{int(ok_cpu.sum())} on the CPU), right_u max {ur_err:.3e} px apart where both are "
          f"ok; the level-0 wrap changes the SAD costs of {n_wrap} of {int(row0.sum())} octave-0 "
          f"keypoints; first {N_PAR_STEREO_PIPE} frames pipelined on the CPU: lost and "
          f"insertions {'identical' if same_cpu else 'DIFFERENT'} ({cpu_trace}), max track-time "
          f"camera-centre difference {cpu_diff:.3e} m, {cpu_s:.1f} s | "
          + " | ".join(lines) + f" | {smi}", flush=True)
    if stats["frames_total"] != n or len(ts) + lost != n or not np.isfinite(pos_tum).all():
        raise AssertionError(f"pipelined stereo: {stats['frames_total']} records, {len(ts)} rows")
    if lost != JAX_CPU_LOST_STEREO_PIPE:
        raise AssertionError(f"pipelined stereo: {lost} lost (JAX {JAX_CPU_LOST_STEREO_PIPE})")
    if not ate < STEREO_ATE_MAX or not ate <= 1.5 * JAX_CPU_ATE_STEREO_PIPE:
        raise AssertionError(f"pipelined stereo: ATE {ate} (JAX {JAX_CPU_ATE_STEREO_PIPE})")
    if abs(stats["keyframes_inserted"] - JAX_CPU_KF_STEREO_PIPE) > TUM_KF_BAND:
        raise AssertionError(f"pipelined stereo: {stats['keyframes_inserted']} keyframes, JAX "
                             f"{JAX_CPU_KF_STEREO_PIPE} +- {TUM_KF_BAND}")
    if [t[1] for t in head] != [True] * N_STEREO_PIPE_SAME or \
            [i for i, t in enumerate(head) if t[3]] != list(JAX_CPU_STEREO_PIPE_NEED) or \
            [i for i, t in enumerate(head) if t[4]] != list(JAX_CPU_STEREO_PIPE_INSERTED) or \
            inl_gap > 2:
        raise AssertionError(f"pipelined stereo: frames 0-{N_STEREO_PIPE_SAME - 1} differ from "
                             f"JAX's trace")
    if not burst or burst_frames[1] != N_STEREO_PIPE_SAME - 1 or not prep_ok or \
            [c["kind"] for c in burst] != ["prep"] * (len(burst) - 1) + ["finish"]:
        raise AssertionError(f"pipelined stereo: the drain of frames {burst_frames} on the card "
                             f"and the CPU disagree, or it was not captured ({burst_rows})")
    if ba_graph or not ba_bind > 0.995 or not ba_snap or not (ba_d[:3] <= 1.5 * spread[:3]).all():
        raise AssertionError(f"pipelined stereo: the drain's deferred BA on the card and the CPU "
                             f"disagree beyond the card's own spread ({ba_d} vs {spread})")
    expect = dict(fast_score_nms=2 * n, proj_best2=3 * n + calls["reloc_k2"],
                  pair_best2=3 * n_prep, lm_obs=17 * n_fin, pose_lm=calls["pose"])
    if launches != expect or n_fin != stats["local_ba_runs"] or n_fin < 1 or \
            calls["pose"] < 2 * (n - 1):
        raise AssertionError(f"pipelined stereo launches {launches}, expected {expect}")
    over = {k: max(v) for k, v in waits.items() if v and max(v) > PIPE_SYNC_MAX[k]}
    if over or not waits["dispatch"] or max(drained_waits, default=0) > PIPE_SYNC_MAX["dispatch"]:
        raise AssertionError(f"pipelined stereo host waits over {PIPE_SYNC_MAX}: {over}, "
                             f"drained dispatches {drained_waits}, sites {sites}")
    if not same_b:
        raise AssertionError(f"pipelined stereo: the repeat of frames 0-"
                             f"{N_STEREO_PIPE_REPEAT - 1} differs")
    if not share >= STEREO_OK_SHARE or not ur_err <= STEREO_UR_TOL:
        raise AssertionError(f"pipelined stereo_match card and CPU disagree: {share}, {ur_err} px")
    if not same_cpu or not cpu_diff < PIPE_TOL_M:
        raise AssertionError(f"pipelined stereo: card and CPU disagree ({cpu_diff} m)")
    for k in report:
        report[k]["stereo_pipe_launches"] = launches.get(k, 0)


def _phase20(smi, report):
    """Phase 20: the KITTI runner with ``--pipelined`` at its own
    configuration on ``testing.write_kitti_sequence`` of the stereo
    workload.  Fills ``report[k]["kitti_pipe_launches"]``; any gate that
    fails raises."""
    import contextlib
    import io

    import numpy as np

    from ydorbslam_tpu_torch.apps import run_kitti_stereo
    from ydorbslam_tpu_torch.io.trajectory import ate_against_kitti_poses
    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.slam import system as system_mod
    from ydorbslam_tpu_torch.slam.system import SlamSystem
    from ydorbslam_tpu_torch.testing import make_stereo_frames, write_kitti_sequence

    frames, poses = make_stereo_frames(N_STEREO)
    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "seq")
    poses_path = write_kitti_sequence(root, frames, poses)
    traj = os.path.join(tmp.name, "CameraTrajectory.txt")
    secs, calls, pre = [], {"prep": 0, "finish": 0}, {}
    orig = {"track": SlamSystem.track_stereo_pipelined, "pre": SlamSystem.precompile,
            "shutdown": SlamSystem.shutdown, "prep": system_mod.mapping_prep,
            "finish": system_mod.mapping_finish}

    def track(self, *args):
        t0 = time.perf_counter()
        orig["track"](self, *args)
        secs.append(time.perf_counter() - t0)

    def precompile(self):
        t0 = time.perf_counter()
        orig["pre"](self)
        pre["s"] = time.perf_counter() - t0
        kernels.reset_launch_counts()  # the run's counts start after it
        calls.update(prep=0, finish=0, calls=0)

    def shutdown(self):
        t0 = time.perf_counter()
        orig["shutdown"](self)
        pre["flush"] = time.perf_counter() - t0

    def prep(*args, **kwargs):
        calls["prep"] += 1
        return orig["prep"](*args, **kwargs)

    def finish(*args, **kwargs):
        calls["finish"] += 1
        return orig["finish"](*args, **kwargs)

    args = [root, "--pipelined", "--lag", str(PIPE_LAG), "--poses", poses_path,
            "--out-trajectory", traj]
    text = io.StringIO()
    t_run = time.perf_counter()
    try:
        SlamSystem.track_stereo_pipelined, SlamSystem.precompile = track, precompile
        SlamSystem.shutdown = shutdown
        system_mod.mapping_prep, system_mod.mapping_finish = prep, finish
        with contextlib.redirect_stdout(text), _pose_calls(calls):
            system = run_kitti_stereo.main(args)
        launches = kernels.launch_counts()
    finally:
        SlamSystem.track_stereo_pipelined, SlamSystem.precompile = orig["track"], orig["pre"]
        SlamSystem.shutdown = orig["shutdown"]
        system_mod.mapping_prep, system_mod.mapping_finish = orig["prep"], orig["finish"]
    run_s = time.perf_counter() - t_run
    cfg = system.cfg
    stats = system.run_stats()
    ate, pairs = ate_against_kitti_poses(traj, poses_path, len(frames))
    n = len(frames)
    steady = secs[N_STEREO_WARM:]
    fps = len(steady) / (sum(steady) + pre["flush"])
    print("phase 20 runner output: " + " | ".join(
        line.strip() for line in text.getvalue().splitlines() if line.strip()), flush=True)
    print(f"phase 20 KITTI runner --pipelined (lag {system._pipe_lag}, {cfg.camera.width}x"
          f"{cfg.camera.height}, {cfg.n_keypoints} keypoint slots, capacities "
          f"K={cfg.capacity.max_keyframes} M={cfg.capacity.max_map_points}, loop closing "
          f"{'on' if system.loop_closer is not None else 'OFF'}): {stats['frames_total']} "
          f"frames, lost {stats['frames_lost']} (JAX's runner --pipelined on a CPU "
          f"{JAX_CPU_LOST_KITTI_PIPE}), ATE {ate:.6f} m over {pairs} pairs (JAX "
          f"{JAX_CPU_ATE_KITTI_PIPE}), keyframes inserted {stats['keyframes_inserted']} (JAX "
          f"{JAX_CPU_KF_KITTI_PIPE}) culled {stats['keyframes_culled']} live "
          f"{stats['keyframes_live']}, mapping_prep {calls['prep']}, deferred local BAs "
          f"{calls['finish']}, loops closed {stats['loops_closed']} (JAX "
          f"{JAX_CPU_LOOPS_KITTI_PIPE}), launches {launches}, {fps:.3f} frames/s over frames "
          f"{N_STEREO_WARM}-{len(secs) - 1} (dispatches plus the final shutdown "
          f"{pre['flush'] * 1e3:.1f} ms), median dispatch "
          f"{float(np.median(steady)) * 1e3:.3f} ms, precompile {pre['s']:.2f} s, run "
          f"{run_s:.1f} s | {smi}", flush=True)
    tmp.cleanup()
    if stats["frames_total"] != n or ate is None or not np.isfinite(ate):
        raise AssertionError(f"KITTI runner --pipelined: {stats['frames_total']} records, ATE {ate}")
    if system.loop_closer is None or system._pipe_lag != PIPE_LAG or \
            cfg.capacity.max_keyframes != 512 or cfg.orb.n_features != 1000:
        raise AssertionError("KITTI runner --pipelined: not at its own configuration")
    if stats["frames_lost"] > JAX_CPU_LOST_KITTI_PIPE or not ate <= 1.5 * JAX_CPU_ATE_KITTI_PIPE:
        raise AssertionError(f"KITTI runner --pipelined: {stats['frames_lost']} lost, ATE {ate} "
                             f"(JAX {JAX_CPU_LOST_KITTI_PIPE}, {JAX_CPU_ATE_KITTI_PIPE})")
    if stats["loops_closed"] != JAX_CPU_LOOPS_KITTI_PIPE:
        raise AssertionError(f"KITTI runner --pipelined: {stats['loops_closed']} loops")
    if launches["fast_score_nms"] != 2 * n or launches["proj_best2"] < 3 * n or \
            launches["pair_best2"] != 3 * calls["prep"] or \
            launches["lm_obs"] < 17 * calls["finish"] or calls["finish"] < 1:
        raise AssertionError(f"KITTI runner --pipelined launches {launches}: K1 {2 * n}, K2 >= "
                             f"{3 * n}, K3 {3 * calls['prep']}, K4 >= {17 * calls['finish']}")
    _gate_pose_lm("KITTI runner --pipelined", launches, calls, 2 * (n - 1))
    for k in report:
        report[k]["kitti_pipe_launches"] = launches.get(k, 0)


def _phase16(smi):
    """Phase 16: every exported helper the port added beside the JAX
    package's API (geometry, Hamming, blur, empty features, retrieval)
    called once on the card on seeded inputs and held to the port's own
    CPU result: integers and masks identical, floats at the tolerances of
    ``tests/test_torch_api.py``."""
    import numpy as np
    import torch

    from ydorbslam_tpu_torch import geometry as geo
    from ydorbslam_tpu_torch import ops
    from ydorbslam_tpu_torch.slam import retrieval

    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    cams = {d: geo.CameraIntrinsics.create(517.3, 516.5, 318.6, 255.3, bf=40.0, width=640,
                                           height=480, device=d) for d in ("cpu", "cuda")}
    xi = rng.normal(size=(256, 6)).astype(np.float32)
    xi[:, 3:] *= np.minimum(1.0, 2.8 / np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True))
    xi[:32, 3:] *= np.float32(1e-6)  # near the identity
    axis = xi[-32:, 3:] / np.linalg.norm(xi[-32:, 3:], axis=-1, keepdims=True)
    T = geo.se3_exp(torch.from_numpy(xi))
    T_pi = geo.se3_exp(torch.from_numpy(np.concatenate(
        [xi[-32:, :3], (np.pi - 1e-4) * axis], -1).astype(np.float32)))
    pts = torch.from_numpy(rng.uniform([-2, -2, -0.5], [2, 2, 5], (256, 3)).astype(np.float32))
    uv = torch.from_numpy(np.concatenate([
        np.stack(np.meshgrid([-0.5, 0.0, 3.0, 477.0, 480.0, 637.0, 640.0],
                             [-0.5, 0.0, 3.0, 477.0, 480.0]), -1).reshape(-1, 2),
        rng.uniform(-10, 650, (256, 2))]).astype(np.float32))
    q_raw = torch.from_numpy(rng.normal(size=(256, 4)).astype(np.float32))
    image = torch.from_numpy(rng.uniform(0, 255, (480, 640)).astype(np.float32))
    desc_a = torch.from_numpy(rng.integers(0, 2**32, (1024, 8), dtype=np.uint64)
                              .astype(np.uint32).view(np.int32))
    desc_b = torch.from_numpy(rng.integers(0, 2**32, (1024, 8), dtype=np.uint64)
                              .astype(np.uint32).view(np.int32))
    d_ties = torch.from_numpy(rng.integers(0, 4, (1024, 512)).astype(np.int32))
    bins = np.where(rng.random(1024) < 0.7, rng.choice([3, 4, 17], 1024),
                    rng.integers(0, 30, 1024))
    diff = (bins + rng.uniform(0.01, 0.99, 1024)) * (2 * np.pi / 30)
    match = rng.integers(0, 1024, 1024).astype(np.int32)
    match[rng.random(1024) < 0.15] = -1
    ang_b = rng.uniform(0, 2 * np.pi, 1024)
    ang_a = np.mod(ang_b[np.maximum(match, 0)] + diff, 2 * np.pi)
    rot = tuple(torch.from_numpy(x.astype(t)) for x, t in
                ((match, np.int32), (ang_a, np.float32), (ang_b, np.float32)))
    hist = rng.random((512, 4096)).astype(np.float32) * (rng.random((512, 4096)) < 0.05)
    index = retrieval.RetrievalIndex(torch.from_numpy(hist),
                                     torch.from_numpy((hist > 0).astype(np.float32)),
                                     torch.from_numpy(rng.random(512) < 0.8))
    calls = {
        "se3_log": (1e-5, lambda d: geo.se3_log(T.to(d))),
        "se3_log near pi": (1e-4, lambda d: geo.se3_log(T_pi.to(d))),
        "vee": (0, lambda d: geo.vee(T.to(d)[:, :3, :3])),
        "so3_log": (1e-5, lambda d: geo.so3_log(T.to(d)[:, :3, :3])),
        "transform_points": (1e-5, lambda d: geo.transform_points(T.to(d)[:4], pts.to(d))),
        "rot_to_quat": (1e-5, lambda d: geo.rot_to_quat(T.to(d)[:, :3, :3])),
        "quat_to_rot": (1e-5, lambda d: geo.quat_to_rot(q_raw.to(d))),
        "project": (1e-5, lambda d: geo.project(cams[d], pts.to(d))),
        "project_stereo": (1e-5, lambda d: geo.project_stereo(cams[d], pts.to(d))),
        "in_image": (0, lambda d: geo.in_image(cams[d], uv.to(d), 3.0)),
        "CameraIntrinsics.baseline": (1e-5, lambda d: cams[d].baseline),
        "se3_to_sim3": (0, lambda d: geo.se3_to_sim3(T.to(d))),
        "sim3_log": (1e-5, lambda d: geo.sim3_log(geo.se3_to_sim3(T.to(d)))),
        "gaussian_blur": (1e-3, lambda d: ops.gaussian_blur(image.to(d))),
        "empty_features": (0, lambda d: ops.empty_features(1024, device=d)),
        "hamming_distance": (0, lambda d: ops.hamming_distance(desc_a.to(d), desc_b.to(d))),
        "best_and_second": (0, lambda d: ops.best_and_second(d_ties.to(d))),
        "ratio_test_matches": (0, lambda d: ops.ratio_test_matches(d_ties.to(d), 2, ratio=0.9)),
        "ratio_test_matches mutual": (0, lambda d: ops.ratio_test_matches(
            d_ties.to(d), 2, mutual=True)),
        "filter_matches_by_rotation": (0, lambda d: ops.filter_matches_by_rotation(
            *(x.to(d) for x in rot))),
        "remove_keyframe": (0, lambda d: retrieval.remove_keyframe(
            retrieval.RetrievalIndex(*(x.to(d) for x in index)), 7)),
    }
    errs = {}
    for name, (tol, fn) in calls.items():
        card, cpu = fn("cuda"), fn("cpu")
        card = card if isinstance(card, tuple) else (card,)
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        err = 0.0
        for a, b in zip(card, cpu):
            if not a.is_cuda or a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"phase 16 {name}: card output {a.device} {a.dtype} "
                                     f"{tuple(a.shape)}, CPU {b.dtype} {tuple(b.shape)}")
            a = a.cpu()
            if tol == 0 or not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(f"phase 16 {name}: card and CPU differ")
            else:
                if not torch.allclose(a, b, atol=tol, rtol=tol if tol < 1e-3 else 0.0):
                    raise AssertionError(f"phase 16 {name}: card and CPU differ by "
                                         f"{float((a - b).abs().max()):.3e}")
                err = max(err, float((a - b).abs().max()))
        errs[name] = err
    print(f"phase 16 exported helpers on the card against the CPU: {len(calls)} calls, integer "
          f"and bool outputs identical, float max abs differences "
          f"{ {k: float('%.3e' % v) for k, v in errs.items() if calls[k][0]} }; "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)


def _phase21(smi, report, loop):
    """Phase 21: the sharded paths (``parallel/``) on the card, on phase
    13's global BA (C = 161, P = 16,384, O = 16) and final map.  (a) A
    world of one NCCL rank in this process: two point-sharded LM chunks
    bit-equal to two ``_lm_chunk`` calls, K4 6x per chunk; sharded
    detection and scores identical to the dense ones.  (b) The TUM runner
    joins a world of one through the ``YDORBSLAM_*`` trio in a child
    process and tracks 10 frames.  (c) Two gloo ranks spawned on this
    card: the same two chunks within 2e-4 (T) and 2e-3 (p) of the dense
    ones, the ranks bit-equal, K4 6x per chunk per rank on
    (32, 16, P/2), rank 0's first K4 input held to plain.  (d) The same
    over NCCL, one rank per card, when there are two cards or more.
    Fills ``report[k]["parallel_launches"]`` (the sharded chunks of
    (a)); any gate that fails raises."""
    import re

    import numpy as np
    import torch
    import torch.distributed as dist

    import bench
    from ydorbslam_tpu_torch.ops import kernels
    from ydorbslam_tpu_torch.optim import schur
    from ydorbslam_tpu_torch.parallel.ba_sharded import _sharded_lm_chunk
    from ydorbslam_tpu_torch.parallel.launch import spawn_ranks
    from ydorbslam_tpu_torch.parallel.multihost import ShardGroup
    from ydorbslam_tpu_torch.parallel.retrieval_sharded import score_all_sharded
    from ydorbslam_tpu_torch.slam import loop_impl
    from ydorbslam_tpu_torch.slam.retrieval import bow_histogram, score_all
    from ydorbslam_tpu_torch.testing import (
        TUM_RGBD_SETTINGS, free_port, sharded_chunk_rank, write_tum_sequence,
    )

    t_start = time.perf_counter()
    gba, cam, cfg = loop["gba"], loop["cam"], loop["cfg"]
    prob = gba["prob"]
    n_chunks = 2

    def two_chunks(step):
        T, p, lam = gba["T"], gba["p"], gba["lam"]
        ms, launches = [], []
        for _ in range(n_chunks):
            torch.cuda.synchronize()
            before = kernels.launch_counts()["lm_obs"]
            t0 = time.perf_counter()
            T, p, lam = step(T, p, lam)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(kernels.launch_counts()["lm_obs"] - before)
        return T, p, lam, ms, launches

    with tempfile.TemporaryDirectory() as tmp:
        # (a) a world of one NCCL rank
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                rank=0, world_size=1)
        try:
            g = ShardGroup(dist.group.WORLD, 0, 1, "pts")
            dT, dp, dlam, dms, _ = two_chunks(
                lambda T, p, lam: schur._lm_chunk(cam, prob, T, p, lam, chunk=5))
            kernels.reset_launch_counts()
            sT, sp, slam, sms, sl = two_chunks(
                lambda T, p, lam: _sharded_lm_chunk(g, cam, prob, T, p, lam, 5, True))
            par = kernels.launch_counts()
            m, idx, kf = loop["map"], loop["retrieval"], loop["kf"]
            C = cfg.capacity.loop_candidates
            args = (m, idx, kf, torch.zeros((C, m.K), dtype=torch.bool, device=m.device),
                    torch.full((C,), -1, dtype=torch.int32, device=m.device), C,
                    cfg.loop.covisibility_consistency_th)
            kw = dict(n_banks=cfg.loop.retrieval_banks, bank_bits=cfg.loop.retrieval_bank_bits,
                      min_frame_gap=cfg.loop.min_frame_gap)
            gk = g._replace(axis_name="kf")
            dense_det = loop_impl._detect(*args, **kw)
            shard_det = loop_impl._detect(*args, **kw, group=gk)
            q = bow_histogram(m.kf_desc[kf], m.kf_kp_valid[kf], cfg.loop.retrieval_banks,
                              cfg.loop.retrieval_bank_bits)
            same_scores = all(torch.equal(a, b) for a, b in zip(score_all_sharded(gk, idx, q),
                                                                 score_all(idx, q)))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        same_chunks = torch.equal(sT, dT) and torch.equal(sp, dp) and torch.equal(slam, dlam)
        # What (c) is held to: one LM iteration, the dense chunks' cost, and
        # the dense chunks of the points in another order (the same sums
        # in another order, as the ranks' split makes them).
        T1, p1, _ = schur._lm_chunk(cam, prob, gba["T"], gba["p"], gba["lam"], chunk=1)
        perm = torch.from_numpy(np.random.default_rng(0).permutation(prob.P)).to(prob.p_w.device)
        pprob = prob._replace(**{k: getattr(prob, k)[perm] for k in (
            "p_w", "pt_valid", "obs_cam", "obs_uvr", "obs_inv_sigma2", "obs_stereo", "obs_valid")})
        qT, qp, qlam = pprob.T_cw, pprob.p_w, gba["lam"]
        for _ in range(n_chunks):
            qT, qp, qlam = schur._lm_chunk(cam, pprob, qT, qp, qlam, chunk=5)
        qp = qp[torch.argsort(perm)]
        flat = schur._flatten_obs(prob)

        def cost(T, p):
            return float(schur._flat_cost(cam, T.to(flat.E.device), p.to(flat.E.device), flat,
                                          schur._po_flat(prob.obs_valid), True))

        d_cost = cost(dT, dp)
        spread_T = float((qT - dT).abs().max())
        spread_p = float((qp - dp).abs().max())
        spread_cost = abs(cost(qT, qp) - d_cost) / d_cost
        same_det = all(torch.equal(a, b) for a, b in zip(shard_det, dense_det))
        n_cand = int((dense_det[0] >= 0).sum())
        print(f"phase 21 (a) one NCCL rank on phase 13's global BA (C={prob.C}, P={prob.P}, "
              f"O={prob.O}): {n_chunks} sharded chunks "
              f"{'bit-equal' if same_chunks else 'DIFFERENT'} to _lm_chunk (T, p, lam "
              f"{float(dlam):.3e}), K4 launches per sharded chunk {sl}, launches {par}; "
              f"synchronised ms per chunk dense {[round(x, 3) for x in dms]} sharded "
              f"{[round(x, 3) for x in sms]}; detection on the final map (keyframe {kf}, "
              f"{n_cand} candidates) {'identical' if same_det else 'DIFFERENT'}, "
              f"score_all_sharded {'bit-equal' if same_scores else 'DIFFERENT'} | {smi}",
              flush=True)
        if not same_chunks or not same_det or not same_scores or sl != [6] * n_chunks or \
                any(v for k, v in par.items() if k != "lm_obs"):
            raise AssertionError("phase 21 (a): the world of one is not the dense path")

        # (b) the TUM runner joins a world of one in a child process; (c)
        # runs while it does.
        root = os.path.join(tmp, "tum")
        frames = bench.make_frames(N_JOIN)
        from synthetic import oscillating_trajectory  # bench put tests/ on sys.path

        yaml, assoc, _ = write_tum_sequence(root, frames, oscillating_trajectory(N_JOIN),
                                            TUM_RGBD_SETTINGS)
        env = dict(os.environ, YDORBSLAM_COORDINATOR=f"127.0.0.1:{free_port()}",
                   YDORBSLAM_NUM_PROCESSES="1", YDORBSLAM_PROCESS_ID="0")
        runner = subprocess.Popen(
            [sys.executable, "-m", "ydorbslam_tpu_torch.apps.run_tum_rgbd", yaml, root, assoc,
             "--max-frames", str(N_JOIN), "--out-trajectory", os.path.join(tmp, "traj.txt"),
             "--out-kf-trajectory", os.path.join(tmp, "kf.txt")],
            env=env, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            inp = dict(cam=tuple(float(x) if isinstance(x, torch.Tensor) else x for x in cam),
                       prob={k: v.cpu().numpy() for k, v in prob._asdict().items()},
                       lam=float(gba["lam"]), chunks=n_chunks, rtol=K4_RTOL, atol=K4_ATOL)
            worlds = [("(c) two gloo ranks on one card", "gloo", 2)]
            n_cards = torch.cuda.device_count()
            if n_cards >= 2:
                worlds.append((f"(d) NCCL across {n_cards} cards", "nccl", n_cards))
            for label, backend, world in worlds:
                t0 = time.perf_counter()
                try:
                    ranks = spawn_ranks(sharded_chunk_rank, world, os.path.join(tmp, backend),
                                        backend=backend, device="cuda", args=(inp,),
                                        timeout=300)
                except Exception as e:  # noqa: BLE001 (a refusal is reported, see below)
                    msg = str(e)
                    if backend == "gloo" and "gloo" in msg.lower() and any(
                            w in msg for w in ("not supported", "unsupported", "Unsupported")):
                        print(f"phase 21 {label}: gloo refused CUDA tensors: "
                              f"{msg.strip().splitlines()[-1]} | {smi}", flush=True)
                        continue
                    raise
                secs = time.perf_counter() - t0
                step_T = max(float((r["step_T"] - T1.cpu()).abs().max()) for r in ranks)
                step_p = max(float((r["step_p"] - p1.cpu()).abs().max()) for r in ranks)
                t_err = max(float((r["T"] - dT.cpu()).abs().max()) for r in ranks)
                p_err = max(float((r["p"] - dp.cpu()).abs().max()) for r in ranks)
                cost_err = abs(cost(ranks[0]["T"], ranks[0]["p"]) - d_cost) / d_cost
                same = all(torch.equal(r["T"], ranks[0]["T"]) and
                           torch.equal(r["lam"], ranks[0]["lam"]) and
                           torch.equal(r["p"], ranks[0]["p"]) for r in ranks)
                print(f"phase 21 {label}: {world} ranks; one LM iteration: T within "
                      f"{step_T:.3e}, p within {step_p:.3e} of the dense one; {n_chunks} chunks: "
                      f"T within {t_err:.3e}, p within {p_err:.3e}, cost within {cost_err:.3e} "
                      f"(relative, of {d_cost:.6g}) of the dense chunks, where the dense chunks "
                      f"of the points permuted (seed 0) are {spread_T:.3e}, {spread_p:.3e} and "
                      f"{spread_cost:.3e} from them; ranks "
                      f"{'bit-equal' if same else 'DIFFERENT'} in T, p and lam; K4 launches per "
                      f"chunk per rank {[r['launches'] for r in ranks]} on "
                      f"{ranks[0]['k4_shape']}; K4 on rank 0's shard against plain max abs error "
                      f"{ranks[0]['max_abs_err']:.3e}; synchronised ms per chunk per rank "
                      f"{[[round(x, 3) for x in r['ms']] for r in ranks]}; {secs:.1f} s with the "
                      f"spawn | {smi}", flush=True)
                if not step_T < 2e-4 or not step_p < 2e-3 or not cost_err < COST_RTOL or \
                        not same or \
                        any(r["launches"] != [6] * n_chunks for r in ranks) or \
                        ranks[0]["k4_shape"] != [32, prob.O, prob.P // world] or \
                        ranks[0]["max_abs_err"] is None:
                    raise AssertionError(f"phase 21 {label}: the sharded chunks disagree")
            if n_cards < 2:
                print(f"phase 21 (d) NCCL across cards: not run, this machine has {n_cards} "
                      f"card | {smi}", flush=True)
            out, _ = runner.communicate(timeout=300)
        finally:
            if runner.poll() is None:
                runner.kill()
                runner.communicate()
    dist_line = next((l for l in out.splitlines() if l.startswith("distributed:")), None)
    stats = re.search(r"frames\s+(\d+)\s+\(lost (\d+)", out)
    print(f"phase 21 (b) the TUM runner under the YDORBSLAM_* trio, world of one: exit "
          f"{runner.returncode}, {dist_line!r}, frames and lost "
          f"{stats.groups() if stats else None} | {smi}", flush=True)
    if runner.returncode != 0 or dist_line is None or "'process_count': 1" not in dist_line or \
            not stats or stats.groups() != (str(N_JOIN), "0"):
        raise AssertionError(f"phase 21 (b): the runner's join failed:\n{out[-3000:]}")
    for k in report:
        report[k]["parallel_launches"] = par.get(k, 0)
    print(f"phase 21 took {time.perf_counter() - t_start:.1f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np

    import bench
    from ydorbslam_tpu_torch import _build
    from ydorbslam_tpu_torch.io import ate_rmse, read_tum_trajectory
    from ydorbslam_tpu_torch.ops import hamming, kernels
    from ydorbslam_tpu_torch.ops.extractor import DETECT_BORDER
    from ydorbslam_tpu_torch.ops.fast import fast_score_map, nms_and_border
    from ydorbslam_tpu_torch.ops.hamming import pair_best2_plain, proj_best2_plain
    from ydorbslam_tpu_torch.ops.pyramid import build_pyramid
    from ydorbslam_tpu_torch.optim import lm_kernel, schur
    from ydorbslam_tpu_torch.slam import matchers, system as system_mod, triangulate
    from ydorbslam_tpu_torch.testing import (
        device_ms, lm_obs_problem, on_device, pair_problem, proj_problem, wall_ms,
    )

    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | numpy {np.__version__} | {os.cpu_count()} CPUs, torch "
          f"{torch.get_num_threads()} threads", flush=True)

    # 2. build
    info = _build.build()
    print(f"phase 2 build: {info['seconds']:.1f} s -> {info['path']}", flush=True)
    print(info["log"].strip(), flush=True)

    frames = bench.make_frames()
    from synthetic import oscillating_trajectory  # bench put tests/ on sys.path

    gt_poses = oscillating_trajectory(len(frames))
    gt_centres = _centres(gt_poses)
    report = {}

    # 3. K1 against plain: each set of levels in one launch, bit for bit.
    levels = build_pyramid(torch.as_tensor(frames[0][1]).to(dev).float())
    rng3 = np.random.default_rng(0)
    rand = torch.as_tensor(rng3.uniform(0, 255, (480, 640)).astype(np.float32)).to(dev)
    ragged = tuple(torch.as_tensor(rng3.uniform(0, 255, s).astype(np.float32)).to(dev)
                   for s in K1_RAGGED)
    err = 0.0
    for label, lvls, border in (
        ("frame 0's 8 levels", levels, DETECT_BORDER), ("random 480x640", (rand,), DETECT_BORDER),
        ("ragged", ragged, DETECT_BORDER), ("all 13", (*levels, rand, *ragged), DETECT_BORDER),
        *((f"ragged, border {b}", (*ragged, levels[-1]), b) for b in (0, 1, 3)),
    ):
        before = kernels.launch_counts()["fast_score_nms"]
        outs = kernels.fast_score_nms_levels_cuda(lvls, border)
        if kernels.launch_counts()["fast_score_nms"] != before + 1:
            raise AssertionError(f"K1 on {label}: not one launch")
        for img, k in zip(lvls, outs):
            p = nms_and_border(fast_score_map(img), border)
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(f"K1 differs from plain on {label} at shape {tuple(img.shape)}")
            err = max(err, float((k - p).abs().max()))
    if not torch.equal(kernels.fast_score_nms_cuda(rand, DETECT_BORDER),
                       nms_and_border(fast_score_map(rand), DETECT_BORDER)):
        raise AssertionError("K1's one-level call differs from plain")
    k1_call = lambda: kernels.fast_score_nms_levels_cuda(levels, DETECT_BORDER)  # noqa: E731
    k1_plain_call = lambda: [nms_and_border(fast_score_map(l), DETECT_BORDER)  # noqa: E731
                             for l in levels]
    k1_ms = wall_ms(k1_call)
    k1_plain = wall_ms(k1_plain_call)
    k1_dev = device_ms(k1_call)
    k1_plain_dev = device_ms(k1_plain_call)
    scored, window, px, k1_bound, k1_by = _k1_work(levels, DETECT_BORDER)
    tree_bound, tree_by = _bound(px * 8, px * K1_OPS_PX_TREE)
    report["fast_score_nms"] = dict(max_abs_err=err, ms=k1_dev, plain_ms=k1_plain_dev,
                                    bound_ms=k1_bound, bound_by=k1_by)
    print(f"phase 3 K1: bit-identical, one launch each, on frame 0's 8 levels "
          f"{[tuple(l.shape) for l in levels]}, random 480x640, ragged {list(K1_RAGGED)}, all "
          f"13 at once, and ragged + {tuple(levels[-1].shape)} at borders 0, 1, 3; per frame "
          f"(8 levels, {px} px, {scored} scored, {window} in the window, one launch): kernel "
          f"wall {k1_ms:.4f} ms, device {k1_dev:.4f} ms; plain wall {k1_plain:.4f} ms, device "
          f"{k1_plain_dev:.4f} ms; bound {k1_bound:.5f} ms ({k1_by}); the earlier count "
          f"({K1_OPS_PX_TREE} ops per pixel) {tree_bound:.5f} ms ({tree_by}) | {smi}", flush=True)

    # 4. K2 against plain: the real frame 0 -> 1 motion search, then random.
    from ydorbslam_tpu_torch.ops.stereo import fill_depth_from_rgbd
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    sysk = SlamSystem(_config(), Sensor.RGBD, enable_mapping=False,
                      enable_loop_closing=False, device=dev)
    tr = sysk.tracker
    tr.track_rgbd(*frames[0])
    curr = tr._extract(frames[1][1])
    d1 = torch.as_tensor(frames[1][2]).to(dev).float() / torch.tensor(5000.0, device=dev)
    curr = fill_depth_from_rgbd(curr, d1, tr.cam)
    attr_a = matchers._motion_attr(
        tr.cam, curr, tr.last_feats, tr.last_lms, tr.last_lms_valid,
        tr.velocity @ tr.T_cw, tr.T_cw, 7.0, 14.0, 8, 1.2,
    )
    attr_b = matchers._pack_cur_attr(curr)
    real = (tr.last_feats.desc, attr_a, curr.desc, attr_b)
    rng = np.random.default_rng(1)
    problems = [("real frame 0->1", real)]
    for kind, M, N in (("random", 1024, 1024), ("random", 1000, 777), ("random", 8192, 1024),
                       ("ties", 1024, 1024), ("none", 1024, 1024), ("one", 1024, 1024),
                       ("random", 1, 777), ("random", 31, 33), ("random", 33, 31),
                       ("random", 777, 1), ("ties", 100, 1537)):
        problems.append((f"{kind} {M}x{N}", on_device(dev, proj_problem(rng, M, N, kind))))
    for label, prob in problems:
        for check_ur in (True, False):
            _same_k2(prob, check_ur, label)
    big = problems[3][1]
    k2_ms = wall_ms(lambda: kernels.proj_best2_cuda(*real, check_ur=True))
    k2_plain = wall_ms(lambda: proj_best2_plain(*real, check_ur=True))
    k2_big_ms = wall_ms(lambda: kernels.proj_best2_cuda(*big, check_ur=False))
    k2_big_plain = wall_ms(lambda: proj_best2_plain(*big, check_ur=False))
    k2_dev = device_ms(lambda: kernels.proj_best2_cuda(*real, check_ur=True))
    k2_big_dev = device_ms(lambda: kernels.proj_best2_cuda(*big, check_ur=False))
    print(f"phase 4 K2: identical on {[l for l, _ in problems]} "
          f"{tuple(real[0].shape)}x{tuple(real[2].shape)}, both check_ur; real search "
          f"kernel wall {k2_ms:.4f} ms, device {k2_dev:.4f} ms, plain wall {k2_plain:.4f} ms; "
          f"random 8192x1024 (local-map shape) kernel wall {k2_big_ms:.4f} ms, device "
          f"{k2_big_dev:.4f} ms, plain wall {k2_big_plain:.4f} ms", flush=True)

    # 5. the mapping-off path
    kernels.reset_launch_counts()
    with _pose_calls() as pose_off:
        system, secs, poses, lost, _ = _run(frames[:N_OFF], "cuda", mapping=False)
    launches = kernels.launch_counts()
    n_lost = sum(lost)
    ate = ate_rmse(_centres(poses), gt_centres[:N_OFF])
    steady = secs[N_WARM:]
    print(f"phase 5 mapping-off path: {N_OFF} frames, lost {n_lost}, ATE {ate:.6f} m, "
          f"last-frame inliers {system.tracked_map_points()}, launches {launches}, "
          f"{len(steady) / sum(steady):.3f} frames/s, median "
          f"{float(np.median(steady)) * 1e3:.3f} ms/frame after {N_WARM} warm-up frames "
          f"| {smi}", flush=True)
    if not all(np.isfinite(p).all() and p.shape == (4, 4) for p in poses):
        raise AssertionError("non-finite or malformed pose")
    if n_lost != 0 or not ate < 0.02:
        raise AssertionError(f"mapping-off path: lost {n_lost}, ATE {ate}")
    if launches["fast_score_nms"] != N_OFF or launches["proj_best2"] < N_OFF - 1:
        raise AssertionError(f"mapping-off path did not go through the kernels: {launches}")
    # Mapping off: the frame's solve against the last frame's landmarks only.
    _gate_pose_lm("mapping-off path", launches, pose_off, N_OFF - 1)
    off_poses, off_lost = poses, lost

    # 6. per-layer times, inside a real tracking run of frames 0-39: the
    # tracker's three compute steps are wrapped with synchronized timers.
    from ydorbslam_tpu_torch.slam import tracking

    layers = {"extract_orb": [], "match_motion_model_two": [], "optimize_pose": []}

    def timed(fn, key, store):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            store[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    originals = {k: getattr(tracking, k) for k in layers}
    try:
        for k, fn in originals.items():
            setattr(tracking, k, timed(fn, k, layers))
        _run(frames[:40], "cuda", mapping=False)
    finally:
        for k, fn in originals.items():
            setattr(tracking, k, fn)
    print("phase 6 layers over frames 0-39, mapping off (median ms per call, calls): "
          + ", ".join(f"{k} {float(np.median(v)):.3f} ({len(v)})" for k, v in layers.items()),
          flush=True)

    # 7. parity against the CPU, mapping off
    _, _, poses_cpu, lost_cpu, _ = _run(frames[:N_WARM], "cpu", mapping=False)
    diff = float(np.abs(_centres(poses_cpu) - _centres(off_poses[:N_WARM])).max())
    print(f"phase 7 CPU parity, mapping off: first {N_WARM} frames, lost pattern "
          f"{'identical' if lost_cpu == off_lost[:N_WARM] else 'DIFFERENT'}, "
          f"max camera-centre difference {diff:.3e} m", flush=True)
    if lost_cpu != off_lost[:N_WARM] or not diff < 1e-3:
        raise AssertionError("CPU and CUDA runs disagree with mapping off")

    # 8. the main path: mapping on.  The K2 inputs of the run are copied,
    # the K3 and K4 inputs kept (references), for phases 9 and 10, and
    # each mapping_step is timed between synchronisations.
    captured = {}
    step_ms = []

    def keep_k2(desc_a, attr_a, desc_b, attr_b, check_ur=False):
        captured[("proj_best2", bool(check_ur), desc_a.shape[0])] = tuple(
            t.clone() for t in (desc_a, attr_a, desc_b, attr_b))
        return hamming.proj_best2(desc_a, attr_a, desc_b, attr_b, check_ur)

    def keep_pairs(desc_a, attr_a, desc_b, attr_b, mode="proj"):
        captured[mode] = (desc_a, attr_a, desc_b, attr_b)
        return hamming.pair_best2(desc_a, attr_a, desc_b, attr_b, mode)

    def keep_obs(inp):
        captured["lm_obs"] = inp
        return lm_kernel.lm_obs(inp)

    patches = [(matchers, "proj_best2", keep_k2), (triangulate, "pair_best2", keep_pairs),
               (schur, "lm_obs", keep_obs),
               (system_mod, "mapping_step",
                timed(system_mod.mapping_step, "mapping_step", {"mapping_step": step_ms}))]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        kernels.reset_launch_counts()
        with _pose_calls() as pose_main:
            system, secs, poses, lost, kfs = _run(frames, "cuda", mapping=True)
        launches = kernels.launch_counts()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    stats = system.run_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CameraTrajectory.txt")
        system.save_trajectory_tum(path)
        ts, pos_tum, _ = read_tum_trajectory(path)
    frame_of = {t: i for i, (t, _, _) in enumerate(frames)}
    rows = [frame_of[min(frame_of, key=lambda x: abs(x - t))] for t in ts]
    ate_map = ate_rmse(pos_tum, gt_centres[rows])
    n_lost = sum(lost)
    steady = secs[N_WARM:]
    fps = len(steady) / sum(steady)
    med_ms = float(np.median(steady)) * 1e3
    n_ba = stats["local_ba_runs"]
    print(f"phase 8 main path (mapping on): {len(frames)} frames, lost {n_lost}, TUM rows "
          f"{len(ts)}, ATE {ate_map:.6f} m (JAX on a CPU: {JAX_CPU_ATE_MAPPING}), keyframes "
          f"inserted {stats['keyframes_inserted']} culled {stats['keyframes_culled']} live "
          f"{stats['keyframes_live']}, local BA runs {n_ba}, live map points "
          f"{stats['map_points_live']}, mean inliers {stats['mean_inliers']:.1f}, launches "
          f"{launches}, {fps:.3f} frames/s, median {med_ms:.3f} ms/frame after {N_WARM} "
          f"warm-up frames, mapping_step median "
          f"{float(np.median(step_ms)) if step_ms else float('nan'):.3f} ms "
          f"(min {min(step_ms, default=float('nan')):.3f}, max "
          f"{max(step_ms, default=float('nan')):.3f}, {len(step_ms)} calls) | {smi}", flush=True)
    if not all(np.isfinite(p).all() and p.shape == (4, 4) for p in poses):
        raise AssertionError("non-finite or malformed pose with mapping on")
    if n_lost != 0 or len(ts) != len(frames) or not np.isfinite(pos_tum).all():
        raise AssertionError(f"main path: lost {n_lost}, {len(ts)} TUM rows")
    if not ate_map < 0.02 or not ate_map <= 1.5 * JAX_CPU_ATE_MAPPING:
        raise AssertionError(f"main path: ATE {ate_map} (JAX on a CPU {JAX_CPU_ATE_MAPPING})")
    if stats["keyframes_inserted"] <= 2 or n_ba != len(step_ms) or n_ba < 1:
        raise AssertionError(f"main path: {stats['keyframes_inserted']} keyframes, {n_ba} BAs")
    expect = dict(fast_score_nms=len(frames), pair_best2=3 * n_ba, lm_obs=17 * n_ba)
    if any(launches[k] != v for k, v in expect.items()) or \
            launches["proj_best2"] < 2 * (len(frames) - 1):
        raise AssertionError(f"main path launches {launches}, expected {expect} and "
                             f">= {2 * (len(frames) - 1)} proj_best2")
    _gate_pose_lm("main path", launches, pose_main, 2 * (len(frames) - 1))
    for k in kernels.launch_counts():
        report.setdefault(k, {})["launches"] = launches[k]

    # 9. K2 and K3 on the real inputs of phase 8 (the motion search, the
    # local-map search with the most rows, the last K3 pairs of each
    # mode), then K3 on generated problems.
    lines = []
    for label, ur in (("motion", True), ("local map", False)):
        prob = captured[max(k for k in captured if k[0] == "proj_best2" and k[1] == ur)]
        _same_k2(prob, ur, f"phase-8 {label} search")
        pairs, gated, bms, bby = _k2_work(prob, ur)
        dev_ms = device_ms(lambda: kernels.proj_best2_cuda(*prob, check_ur=ur))
        wall = wall_ms(lambda: kernels.proj_best2_cuda(*prob, check_ur=ur))
        plain = device_ms(lambda: proj_best2_plain(*prob, check_ur=ur), calls=5, reps=5)
        lines.append(f"K2 {label} {prob[0].shape[0]}x{prob[2].shape[0]} check_ur={ur}: "
                     f"{gated} of {pairs} pairs gated; device {dev_ms:.4f} ms; wall {wall:.4f} ms; "
                     f"plain device {plain:.4f} ms; bound {bms:.5f} ms ({bby})")
        if ur:
            report["proj_best2"].update(max_abs_err=0.0, ms=dev_ms, plain_ms=plain,
                                        bound_ms=bms, bound_by=bby)
    rng = np.random.default_rng(3)
    k3_cases = [(f"real {mode} B={captured[mode][0].shape[0]}", mode, captured[mode])
                for mode in ("epi", "proj")]
    for B, M, N in ((20, 1024, 1024), (20, 1000, 777)):
        for mode in ("epi", "proj"):
            k3_cases.append((f"random {mode} {B}x{M}x{N}", mode,
                             on_device(dev, pair_problem(rng, B, M, N, mode))))
    for kind, B, M, N in (("ties", 20, 1024, 1024), ("none", 4, 300, 200), ("one", 4, 300, 200),
                          ("random", 3, 1, 777), ("random", 3, 31, 33), ("random", 3, 33, 1),
                          ("random", 3, 777, 1537)):
        for mode in ("epi", "proj"):
            k3_cases.append((f"{kind} {mode} {B}x{M}x{N}", mode,
                             on_device(dev, pair_problem(rng, B, M, N, mode, kind))))
    for label, mode, prob in k3_cases:
        _same_k3(prob, mode, label)
    for mode in ("epi", "proj"):
        prob = captured[mode]
        pairs, gated, bms, bby = _k3_work(prob, mode)
        dev_ms = device_ms(lambda: kernels.pair_best2_cuda(*prob, mode=mode))
        wall = wall_ms(lambda: kernels.pair_best2_cuda(*prob, mode=mode))
        plain = device_ms(lambda: pair_best2_plain(*prob, mode=mode), calls=5, reps=5)
        plain_wall = wall_ms(lambda: pair_best2_plain(*prob, mode=mode), calls=5, reps=5)
        lines.append(f"K3 {mode} {tuple(prob[0].shape[:2])}x{prob[2].shape[1]}: {gated} of "
                     f"{pairs} pairs gated; device {dev_ms:.4f} ms; wall {wall:.4f} ms; plain "
                     f"device {plain:.4f} ms, "
                     f"wall {plain_wall:.4f} ms; bound {bms:.5f} ms ({bby})")
        if mode == "proj":
            report["pair_best2"].update(max_abs_err=0.0, ms=dev_ms, plain_ms=plain,
                                        bound_ms=bms, bound_by=bby)
    print(f"phase 9 K2 and K3 on the inputs of phase 8: identical on the real searches; K3 "
          f"identical on {[l for l, _, _ in k3_cases]} | "
          + " | ".join(lines), flush=True)

    # 10. K4 against plain: the real local-BA input, a random one at the
    # same shape, ragged ones; then two launches on the real input.
    real_inp = captured["lm_obs"]
    rnd = torch.as_tensor(lm_obs_problem(np.random.default_rng(4), 16, 4096)).to(dev)
    cases = [("real", real_inp), ("random (32, 16, 4096)", rnd)]
    rng10 = np.random.default_rng(6)
    cases += [(f"O={O} P={P}", torch.as_tensor(lm_obs_problem(rng10, O, P)).to(dev))
              for O in (1, 5, 17) for P in (1, 31, 4097)]
    errs = {}
    for label, inp in cases:
        for hub in (1.0, 0.0):
            x = inp.clone()
            x[21] = hub
            kq, kp = kernels.lm_obs_cuda(x)
            pq, pp = lm_kernel.lm_obs_plain(x)
            torch.cuda.synchronize()
            for a, b in ((kq, pq), (kp, pp)):
                if a.shape != b.shape or not torch.isfinite(b).all():
                    raise AssertionError(f"K4 plain version malformed or not finite on {label}")
                bad = (a - b).abs() > K4_ATOL + K4_RTOL * b.abs()
                if bad.any():
                    raise AssertionError(f"K4 differs from plain on {label}, huber={hub}: "
                                         f"{int(bad.sum())} entries")
                errs[label] = max(errs.get(label, 0.0), float((a - b).abs().max()))
    (q1, p1), (q2, p2) = kernels.lm_obs_cuda(real_inp), kernels.lm_obs_cuda(real_inp)
    torch.cuda.synchronize()
    if not (torch.equal(q1, q2) and torch.equal(p1, p2)):
        raise AssertionError("K4: two launches on the real input differ")
    k4_ms = wall_ms(lambda: kernels.lm_obs_cuda(real_inp))
    k4_plain = wall_ms(lambda: lm_kernel.lm_obs_plain(real_inp), calls=5, reps=5)
    k4_rnd_ms = wall_ms(lambda: kernels.lm_obs_cuda(rnd))
    k4_rnd_plain = wall_ms(lambda: lm_kernel.lm_obs_plain(rnd), calls=5, reps=5)
    k4_dev = device_ms(lambda: kernels.lm_obs_cuda(real_inp))
    k4_rnd_dev = device_ms(lambda: kernels.lm_obs_cuda(rnd))
    k4_plain_dev = device_ms(lambda: lm_kernel.lm_obs_plain(real_inp), calls=5, reps=5)
    # Bound: the rows the pass reads, every output written once.
    _, O4, P4 = real_inp.shape
    k4_bound, k4_by = _bound(((K4_ROWS_READ + lm_kernel.NOUT_Q) * O4 * P4
                              + lm_kernel.NOUT_P * P4) * 4, O4 * P4 * K4_OPS_OBS)
    report["lm_obs"].update(max_abs_err=max(errs.values()), ms=k4_dev, plain_ms=k4_plain_dev,
                            bound_ms=k4_bound, bound_by=k4_by)
    print(f"phase 10 K4: within rtol {K4_RTOL}, atol {K4_ATOL} on real "
          f"{tuple(real_inp.shape)}, random and ragged inputs, both Huber settings; max abs "
          f"error per input {({k: float('%.3e' % v) for k, v in errs.items()})}; two launches on "
          f"the real input bitwise equal; ms per call kernel / plain: real wall "
          f"{k4_ms:.4f} / {k4_plain:.4f}, device {k4_dev:.4f} / {k4_plain_dev:.4f}; random "
          f"wall {k4_rnd_ms:.4f} / {k4_rnd_plain:.4f}, device {k4_rnd_dev:.4f}; bound on the "
          f"real input {k4_bound:.5f} ms ({k4_by}) | {smi}", flush=True)
    k5, line = _k5_check("phase 8's last pose solve", pose_main["last"])
    report["pose_lm"].update(k5)
    print(f"phase 10 {line} | {smi}", flush=True)

    # 11. parity against the CPU, mapping on
    cpu_sys, _, poses_cpu, lost_cpu, kfs_cpu = _run(frames[:N_PAR_MAP], "cpu", mapping=True)
    diff = float(np.abs(_centres(poses_cpu) - _centres(poses[:N_PAR_MAP])).max())
    same_kf = kfs_cpu == kfs[:N_PAR_MAP]
    print(f"phase 11 CPU parity, mapping on: first {N_PAR_MAP} frames "
          f"({cpu_sys.stats.local_ba_runs} local BA), lost pattern "
          f"{'identical' if lost_cpu == lost[:N_PAR_MAP] else 'DIFFERENT'}, keyframes after "
          f"each frame {'identical' if same_kf else 'DIFFERENT'} ({kfs_cpu}), max "
          f"camera-centre difference at track time {diff:.3e} m", flush=True)
    if lost_cpu != lost[:N_PAR_MAP] or not same_kf or not diff < 1e-3 or \
            cpu_sys.stats.local_ba_runs < 1:
        raise AssertionError("CPU and CUDA runs disagree with mapping on")

    print(f"phases 1-11 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 12. recovery on phase 8's map: kidnap and relocalization, the same
    # relocalization on the CPU, localization-only mode, the VO fallback.
    _phase12(system, frames, gt_poses, smi)
    del system
    # 13. loop closing on the card, on the revisit workload.
    # 14. the stereo path on the card, at the KITTI-00 configuration.
    # 15. the TUM runner at its default configuration, checkpoints and
    # re-calibration on the card.
    # 16. the exported helpers on the card against the CPU.
    # 17. the pipelined path at bench.py's configuration.
    # 18. the TUM runner with --pipelined at its defaults.
    # 19. the pipelined stereo path at the KITTI-00 configuration.
    # 20. the KITTI runner with --pipelined at its own configuration.
    print(f"phase 12 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # 21. the sharded paths on the card, on phase 13's global BA and map.
    # From here a phase whose gate fails is reported and the phases after it
    # still run; the script fails at the end, naming each failed phase.
    failed = []

    def attempt(number, phase, *args):
        try:
            return phase(*args)
        except AssertionError as e:
            traceback.print_exc()
            print(f"phase {number} FAILED: {e}", flush=True)
            failed.append(number)
            return e.result if isinstance(e, GateFailed) else None
        finally:
            print(f"phase {number} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    loop = attempt(13, _phase13, smi, report)
    for number, phase in ((14, _phase14), (15, _phase15), (16, _phase16), (17, _phase17),
                          (18, _phase18), (19, _phase19), (20, _phase20)):
        attempt(number, phase, *((smi,) if number == 16 else (smi, report)))
    if loop is None:
        print("phase 21 not run: phase 13 made no global BA to run it on", flush=True)
        failed.append(21)
    else:
        attempt(21, _phase21, smi, report, loop)
    if failed:
        raise AssertionError(f"phases failed: {failed}")

    rows = []
    for k, src, rep in (
        ("fast_score_nms", "ydorbslam_tpu_torch/csrc/fast_nms.cu",
         "ydorbslam_tpu/ops/pallas_kernels.py:125"),
        ("proj_best2", "ydorbslam_tpu_torch/csrc/proj_best2.cu",
         "ydorbslam_tpu/ops/pallas_kernels.py:293"),
        ("pair_best2", "ydorbslam_tpu_torch/csrc/pair_best2.cu",
         "ydorbslam_tpu/ops/pallas_kernels.py:463"),
        ("lm_obs", "ydorbslam_tpu_torch/csrc/lm_obs.cu",
         "ydorbslam_tpu/optim/lm_kernel.py:149"),
        ("pose_lm", "ydorbslam_tpu_torch/csrc/pose_lm.cu",
         "none: ydorbslam_tpu/optim/pose.py optimize_pose is one jitted XLA program"),
    ):
        r = report[k]
        rows.append(dict(name=k, route="cuda", source=src, replaces=rep,
                         launches=r["launches"], max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=None,
                         loop_launches=r["loop_launches"],
                         stereo_launches=r["stereo_launches"],
                         tum_launches=r["tum_launches"], pipe_launches=r["pipe_launches"],
                         tum_pipe_launches=r["tum_pipe_launches"],
                         stereo_pipe_launches=r["stereo_pipe_launches"],
                         kitti_pipe_launches=r["kitti_pipe_launches"],
                         parallel_launches=r["parallel_launches"]))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
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
