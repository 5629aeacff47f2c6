"""The port's ``parallel/`` and the BA helpers it runs on, against the JAX
package on the CPU.

Single process: ``inv6x6_blocked``, ``_pcg_solve_blocks``, the residual
helpers, ``ba_cost_and_chi2`` and ``_lm_iteration`` against JAX's on
tests/test_ba.py's problem (C=6, P=128, O=8), as tests/test_parallel.py
builds it.

Spawned ranks: one world of 2 and one of 4 gloo ranks on the CPU
(``parallel.launch.spawn_ranks``, rank body
``testing.sharded_rank_checks``), each running every sharded piece on
the same numpy inputs.  The parent holds each rank's results against the
JAX package's sharded functions on a ``Mesh`` of as many virtual CPU
devices and against the port's dense forms: T within 2e-4 and p within
2e-3 (the tolerance of JAX's ``test_sharded_ba_matches_single_device``),
the sharded scores bit-equal to ``score_all``'s, detection identical to
the dense ``_detect`` and to JAX's ``make_sharded_detect``, and every
rank's results bit-equal to rank 0's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import test_loop_guard as tlg
from test_ba import CAM, make_ba_problem
from test_torch_mapstate import build_world

from ydorbslam_tpu.optim import residuals as jres
from ydorbslam_tpu.optim import schur as jschur
from ydorbslam_tpu.parallel import ba_sharded as jbs
from ydorbslam_tpu.parallel import retrieval_sharded as jrs
from ydorbslam_tpu.slam import loop_impl as jli
from ydorbslam_tpu.slam import map_state as jms
from ydorbslam_tpu.slam import retrieval as jret

from ydorbslam_tpu_torch.config import CapacityConfig, LoopConfig, SlamConfig
from ydorbslam_tpu_torch.convert import (
    ba_problem_from_numpy, camera_from_numpy, map_state_from_numpy, retrieval_index_from_numpy,
)
from ydorbslam_tpu_torch.optim import residuals as pres
from ydorbslam_tpu_torch.optim import schur as pschur
from ydorbslam_tpu_torch.parallel.launch import spawn_ranks
from ydorbslam_tpu_torch.slam import loop_impl as pli
from ydorbslam_tpu_torch.slam import retrieval as pret
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem
from ydorbslam_tpu_torch.testing import sharded_rank_checks

torch.set_num_threads(2)

CAM_NP = tuple(np.asarray(x) for x in CAM)
PCAM = camera_from_numpy(CAM_NP)
T_TOL, P_TOL = 2e-4, 2e-3


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _problem(seed=42):
    prob, _, _, _ = make_ba_problem(np.random.default_rng(seed), C=6, P=128, O=8, noise=0.1)
    return prob, ba_problem_from_numpy(_np(prob))


# ----------------------------------------------------------------------
# Single process
# ----------------------------------------------------------------------

def test_inv6x6_blocked_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(32, 6, 6)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    ref = np.asarray(jschur.inv6x6_blocked(jnp.asarray(M)))
    got = pschur.inv6x6_blocked(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(6), M.shape), atol=1e-3)


def test_pcg_solve_blocks_matches_jax():
    """A block SPD system (C=6) and a singular-free gauge: 128 PCG
    iterations within 1e-4 of JAX's and of a direct solve."""
    rng = np.random.default_rng(1)
    C = 6
    A = rng.normal(size=(6 * C, 6 * C))
    D = (A @ A.T + 6 * C * np.eye(6 * C)).astype(np.float32)
    S = D.reshape(C, 6, C, 6).transpose(0, 2, 1, 3).copy()
    b = rng.normal(size=(C, 6)).astype(np.float32)
    ref = np.asarray(jschur._pcg_solve_blocks(jnp.asarray(S), jnp.asarray(b)))
    got = pschur._pcg_solve_blocks(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got.reshape(-1), np.linalg.solve(D.astype(np.float64),
                                                                b.reshape(-1)), atol=1e-4)


def test_residual_helpers_match_jax():
    rng = np.random.default_rng(2)
    n = 64
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)],
                   -1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.05, 0.2]
    obs = rng.uniform(0, 600, (n, 3)).astype(np.float32)
    jr = jres.batched_residual_and_jacobians(CAM, jnp.asarray(T), jnp.asarray(pts), jnp.asarray(obs))
    pr = pres.batched_residual_and_jacobians(PCAM, torch.from_numpy(T), torch.from_numpy(pts),
                                             torch.from_numpy(obs))
    for a, b in zip(pr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    one = jres.residual_and_jacobians(CAM, jnp.asarray(T), jnp.asarray(pts[3]), jnp.asarray(obs[3]))
    for a, b in zip(pres.residual_and_jacobians(PCAM, torch.from_numpy(T), torch.from_numpy(pts[3]),
                                                torch.from_numpy(obs[3])), one):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    pc, uvr = pres.project_point(PCAM, torch.from_numpy(T), torch.from_numpy(pts[5]))
    jpc, juvr = jres.project_point(CAM, jnp.asarray(T), jnp.asarray(pts[5]))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jpc), rtol=1e-6)
    np.testing.assert_allclose(uvr.numpy(), np.asarray(juvr), rtol=1e-6)
    st = rng.random(n) < 0.5
    s2 = rng.uniform(0.3, 1.0, n).astype(np.float32)
    w = pres.observation_weights(torch.from_numpy(st), torch.from_numpy(s2))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jres.observation_weights(jnp.asarray(st),
                                                                                 jnp.asarray(s2))))
    chi2 = pres.chi2_per_obs(pr[0], w)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(jres.chi2_per_obs(jr[0], jnp.asarray(w.numpy()))),
                               rtol=1e-5)


@pytest.mark.parametrize("use_huber", [True, False])
def test_ba_cost_and_lm_iteration_match_jax(use_huber):
    prob, pp = _problem()
    jc, jchi2, jmask = jschur.ba_cost_and_chi2(CAM, prob.T_cw, prob.p_w, prob, prob.obs_valid,
                                               jnp.asarray(use_huber))
    pc, pchi2, pmask = pschur.ba_cost_and_chi2(PCAM, pp.T_cw, pp.p_w, pp, pp.obs_valid, use_huber)
    np.testing.assert_allclose(pc.item(), float(jc), rtol=1e-5)
    # chi2 = r^2 with r = obs - pred, |pred| ~ 600 px: one float32 ulp of
    # pred (6e-5 px) is 1e-4 of a 1 px residual, 2e-4 of its square.
    np.testing.assert_allclose(pchi2.numpy(), np.asarray(jchi2), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    jT, jp = jschur._lm_iteration(CAM, prob.T_cw, prob.p_w, prob, prob.obs_valid,
                                  jnp.float32(1e-4), jnp.asarray(use_huber))
    pT, pP = pschur._lm_iteration(PCAM, pp.T_cw, pp.p_w, pp, pp.obs_valid,
                                  torch.full((), 1e-4), use_huber)
    np.testing.assert_allclose(pT.numpy(), np.asarray(jT), atol=T_TOL)
    np.testing.assert_allclose(pP.numpy(), np.asarray(jp), atol=P_TOL)


# ----------------------------------------------------------------------
# Spawned ranks
# ----------------------------------------------------------------------

def _system_cfg():
    """The world map's capacities (test_torch_mapstate: K 8, N 256, M
    2048, O 12); a 1024-point global BA splits over 2 and 4 ranks."""
    from test_torch_mapstate import CFG

    return SlamConfig(
        camera=CFG.camera,
        capacity=CapacityConfig(max_keypoints=256, max_keyframes=8, max_map_points=2048,
                                max_obs_per_point=12, global_ba_max_points=1024,
                                global_ba_obs=8, loop_candidates=4),
        loop=LoopConfig(min_frame_gap=0, covisibility_consistency_th=1),
    )


def _jax_index(mnp):
    idx = jret.empty_index(mnp["kf_valid"].shape[0])
    for k in np.where(mnp["kf_valid"])[0]:
        idx = jret.add_keyframe(idx, int(k), jnp.asarray(mnp["kf_desc"][k]),
                                jnp.asarray(mnp["kf_kp_valid"][k]))
    return idx


@pytest.fixture(scope="module")
def inputs():
    """The numpy inputs of every check (nothing of JAX crosses to a rank)."""
    rng = np.random.default_rng(42)
    prob, _, _, _ = make_ba_problem(rng, C=6, P=128, O=8, noise=0.1)
    n = 64
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)],
                   -1).astype(np.float32)
    xi = jnp.asarray([0.05, -0.02, 0.1, 0.01, -0.02, 0.005])
    from ydorbslam_tpu.geometry import se3_exp

    T_true = se3_exp(xi)
    obs = np.asarray(jax.vmap(lambda p: jres.project_point(CAM, T_true, p)[1])(jnp.asarray(pts)))
    pose = dict(T=np.eye(4, dtype=np.float32), pts=pts, obs=obs, s2=np.ones(n, np.float32),
                valid=np.ones(n, bool), T_true=np.asarray(T_true))
    K = 16
    idx = jret.empty_index(K)
    descs = [rng.integers(0, 2**32, (128, 8), dtype=np.uint32) for _ in range(K)]
    for k in range(10):  # slots 10-15 stay empty
        idx = jret.add_keyframe(idx, k, jnp.asarray(descs[k]), jnp.ones(128, bool))
    q = np.array(jret.bow_histogram(jnp.asarray(descs[3]), jnp.ones(128, bool)))
    maps, _ = build_world(seed=1, n_kf=6)
    world = maps[-1]
    m_guard, idx_guard = tlg._scenario(np.random.default_rng(42))
    detect = dict(
        world=dict(map=world, idx=_np(_jax_index(world)), kf=5, C=4, th=1, gap=0),
        guard=dict(map=_np(m_guard), idx=_np(idx_guard), kf=1, C=4, th=1, gap=0),
    )
    return dict(cam=CAM_NP, pose=pose, ba=_np(prob), jprob=prob, idx=_np(idx), jidx=idx, q=q,
                detect=detect, cfg=_system_cfg(),
                system=dict(map=world, idx=detect["world"]["idx"], kf=5))


def _dense_system(inp):
    """The closer's detection and global BA in this process (one rank:
    the dense path)."""
    system = SlamSystem(inp["cfg"], Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                        device="cpu")
    sysd = inp["system"]
    system.map = map_state_from_numpy(sysd["map"])
    system.retrieval = retrieval_index_from_numpy(sysd["idx"])
    system.n_keyframes = int(sysd["map"]["kf_valid"].sum())
    impl = system.loop_closer._impl
    impl._dispatch_detect(sysd["kf"])
    packed = impl._pending[2]
    impl._pending = None
    impl._start_global_ba(system.map, int(sysd["map"]["mp_valid"].sum()))
    flags = [impl._kf_group is not None, impl._gba["group"] is not None]
    while impl._gba is not None:
        impl.tick()
    flags.append(impl.used_sharded_detect)
    return packed, flags, system.map


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_paths_match_jax_and_dense(inputs, world, tmp_path):
    rank_inp = {k: v for k, v in inputs.items() if k not in ("jprob", "jidx")}
    ranks = spawn_ranks(sharded_rank_checks, world, str(tmp_path), args=(rank_inp,),
                        timeout=300)
    r0 = ranks[0]
    # Every rank holds rank 0's bits (each rank also checked it in the world).
    for r in ranks[1:]:
        assert r.keys() == r0.keys()
        for k, v in r0.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(r[k], v), k
            else:
                assert r[k] == v, k

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("obs",))
    prob, pp = inputs["jprob"], ba_problem_from_numpy(inputs["ba"])

    def close(got, ref, tol, what):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, err_msg=what)

    # Pose step: JAX's sharded step on the mesh.
    ps = inputs["pose"]
    args = [jnp.asarray(ps[k]) for k in ("pts", "obs", "s2", "valid")]
    T = jnp.asarray(ps["T"])
    for i in range(5):
        T = jbs.sharded_pose_step(mesh, CAM, T, *args)
        if i == 0:
            close(r0["pose1"], T, T_TOL, "pose step")
    close(r0["pose5"], T, T_TOL, "5 pose steps")
    np.testing.assert_allclose(r0["pose5"].numpy(), ps["T_true"], atol=1e-3)

    # BA step: JAX's sharded step and the port's dense _lm_iteration.
    jT, jp = jbs.sharded_ba_step(mesh, CAM, prob, lam=1e-4)
    close(r0["step_T"], jT, T_TOL, "BA step T")
    close(r0["step_p"], jp, P_TOL, "BA step p")
    dT, dp = pschur._lm_iteration(PCAM, pp.T_cw, pp.p_w, pp, pp.obs_valid, torch.full((), 1e-4),
                                  True)
    close(r0["step_T"], dT.numpy(), T_TOL, "BA step T, dense")
    close(r0["step_p"], dp.numpy(), P_TOL, "BA step p, dense")

    # Two LM chunks: JAX's sharded chunk and the port's dense _lm_chunk.
    chunk = jbs._sharded_lm_chunk(mesh, 5, True)
    jT, jp, jlam = prob.T_cw, prob.p_w, jnp.float32(1e-4)
    dT, dp, dlam = pp.T_cw, pp.p_w, torch.full((), 1e-4)
    leaves = (prob.cam_fixed, prob.cam_valid)
    pleaves = (prob.pt_valid, prob.obs_cam, prob.obs_uvr, prob.obs_inv_sigma2, prob.obs_stereo,
               prob.obs_valid)
    for i in range(2):
        jT, jp, jlam = chunk(CAM, jT, *leaves, jp, *pleaves, jlam)
        dT, dp, dlam = pschur._lm_chunk(PCAM, pp, dT, dp, dlam, chunk=5)
        for ref, what in ((jT, "JAX"), (dT.numpy(), "dense")):
            close(r0[f"chunk{i}_T"], ref, T_TOL, f"chunk {i} T against {what}")
        for ref, what in ((jp, "JAX"), (dp.numpy(), "dense")):
            close(r0[f"chunk{i}_p"], ref, P_TOL, f"chunk {i} p against {what}")
        # Near convergence an accept or a reject turns on the last bits of
        # the summed cost (tests/test_torch_loop_solvers.py), so the damping
        # is held only between the ranks; the poses and points are held here.

    # chip_smoke.py's rank body: one iteration, then the same two chunks.
    sT, sp, _ = pschur._lm_chunk(PCAM, pp, pp.T_cw, pp.p_w, torch.full((), 1e-4), chunk=1)
    close(r0["chunkrank_step_T"], sT.numpy(), T_TOL, "one iteration T")
    close(r0["chunkrank_step_p"], sp.numpy(), P_TOL, "one iteration p")
    assert torch.equal(r0["chunkrank_T"], r0["chunk1_T"]) and \
        torch.equal(r0["chunkrank_p"], r0["chunk1_p"])
    assert r0["chunkrank_k4_shape"] == [32, 8, 128 // world] and r0["chunkrank_max_abs_err"] is None
    assert r0["chunkrank_launches"] == [0, 0]  # CPU tensors take K4's plain version

    # Bundle adjustment, whole and stopped after its first chunk.
    for name, abort in (("ba", None), ("ba_abort", lambda: True)):
        jT, jp, jout = jbs.sharded_bundle_adjust(mesh, CAM, prob, 10, 5, should_abort=abort)
        close(r0[f"{name}_T"], jT, T_TOL, f"{name} T")
        close(r0[f"{name}_p"], jp, P_TOL, f"{name} p")
        np.testing.assert_array_equal(r0[f"{name}_out"].numpy(), np.asarray(jout))
    assert (r0["ba_chunks"], r0["ba_abort_chunks"]) == (2, 1)

    # Retrieval: JAX's ids, the port's dense scores bit for bit.
    q = jnp.asarray(inputs["q"])
    jids, _ = jrs.sharded_topk_scores(mesh, inputs["jidx"], q, k=4)
    np.testing.assert_array_equal(r0["topk_ids"].numpy(), np.asarray(jids))
    assert int(r0["topk_ids"][0]) == 3
    common, scores = pret.score_all(retrieval_index_from_numpy(inputs["idx"]),
                                    torch.from_numpy(inputs["q"]))
    assert torch.equal(r0["all_common"], common) and torch.equal(r0["all_scores"], scores)
    assert torch.equal(r0["topk_scores"], scores[r0["topk_ids"]])
    jc, js = jrs.score_all_sharded(mesh, inputs["jidx"], q)
    np.testing.assert_array_equal(r0["all_common"].numpy(), np.asarray(jc))
    np.testing.assert_allclose(r0["all_scores"].numpy(), np.asarray(js), atol=1e-6)

    # Detection: the port's dense _detect and JAX's make_sharded_detect.
    for name, d in inputs["detect"].items():
        C, K = d["C"], d["map"]["kf_valid"].shape[0]
        dense = pli._detect(map_state_from_numpy(d["map"]), retrieval_index_from_numpy(d["idx"]),
                            d["kf"], torch.zeros((C, K), dtype=torch.bool),
                            torch.full((C,), -1, dtype=torch.int32), C, d["th"],
                            min_frame_gap=d["gap"])
        jdet = jli.make_sharded_detect(mesh, C, d["th"], 4, 12, d["gap"])
        ref = jdet(jms.MapState(**{k: jnp.asarray(v) for k, v in d["map"].items()}),
                   jret.RetrievalIndex(**{k: jnp.asarray(v) for k, v in d["idx"].items()}),
                   d["kf"], jnp.zeros((C, K), bool), -jnp.ones((C,), jnp.int32))
        for i, (x, rx) in enumerate(zip(dense, ref)):
            assert torch.equal(r0[f"detect_{name}_{i}"], x), (name, i)
            np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    assert int(r0["detect_guard_0"][0]) == 0  # the guard scenario's pair is a candidate

    # The closer: sharded detection and global BA on every rank, against
    # the dense closer of this one-rank process.
    packed, flags, m = _dense_system(inputs)
    assert r0["sys_sharded"] == [True, True, True] and flags == [False, False, False]
    assert torch.equal(r0["sys_packed"], packed)
    close(r0["sys_kf_pose"], m.kf_pose.numpy(), T_TOL, "closer's global BA poses")
    close(r0["sys_mp_pos"], m.mp_pos.numpy(), P_TOL, "closer's global BA points")
    moved = np.abs(m.mp_pos.numpy() - inputs["system"]["map"]["mp_pos"]).max()
    assert moved > 1e-4
