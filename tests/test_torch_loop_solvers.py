"""The loop-closing solvers of the port against the JAX package on the CPU.

* ``sim3_exp`` / ``sim3_log`` / ``sim3_to_se3`` on random tangents and on
  angles and scales near zero (the series branches): within 1e-5.
* ``ransac_sim3`` fed the JAX package's own ``jax.random.choice`` picks:
  the same inlier mask, count and ``ok``; ``S_12`` within 1e-5.
* ``optimize_sim3`` and ``optimize_pose_graph`` on the unit problems of
  tests/test_loop_components.py: the same inlier masks, poses within 1e-4;
  ``optimize_pose_graph`` also on a seeded graph of 40 keyframes with
  degrees of 10 and more and duplicate edge pairs
  (``testing.pose_graph_problem``), poses within 1e-4, and its
  fixed-order assembly against a float64 numpy assembly of the same
  Jacobians within 1e-5 of the largest entry.
* ``recompute_covis_all`` on a map carried across from JAX: identical
  integers.
* ``lm_solve`` with a tensor damping (JAX's ``lam_init=``) and
  ``_lm_chunk``: costs within 1e-4 relative,
  damping equal, poses within 5e-3 (test_torch_ba.py's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import CAM, make_ba_problem
from test_loop_components import TestPoseGraph, TestSim3Opt  # noqa: F401 (problems below mirror them)
from test_torch_mapstate import build_world, map_np, to_jax, to_port

from ydorbslam_tpu.geometry import make_S, se3_exp, so3_exp
from ydorbslam_tpu.geometry import sim3 as jsim3
from ydorbslam_tpu.optim import schur as jschur
from ydorbslam_tpu.optim.horn import ransac_sim3 as j_ransac
from ydorbslam_tpu.optim.pose_graph import PoseGraphProblem as JProblem
from ydorbslam_tpu.optim.pose_graph import edge_measurement, optimize_pose_graph as j_pgo
from ydorbslam_tpu.optim.sim3_opt import optimize_sim3 as j_sim3opt
from ydorbslam_tpu.slam import map_state as jms

from ydorbslam_tpu_torch.convert import ba_problem_from_numpy, camera_from_numpy
from ydorbslam_tpu_torch.geometry import sim3 as psim3
from ydorbslam_tpu_torch.optim import schur as pschur
from ydorbslam_tpu_torch.optim.horn import ransac_sim3 as p_ransac
from ydorbslam_tpu_torch.optim import pose_graph as ppg
from ydorbslam_tpu_torch.optim.pose_graph import PoseGraphProblem as PProblem
from ydorbslam_tpu_torch.optim.pose_graph import optimize_pose_graph as p_pgo
from ydorbslam_tpu_torch.optim.sim3_opt import optimize_sim3 as p_sim3opt
from ydorbslam_tpu_torch.slam import map_state as pms
from ydorbslam_tpu_torch.testing import pose_graph_problem

torch.set_num_threads(2)

PCAM = camera_from_numpy(tuple(CAM))


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------------
# Sim(3) algebra
# ----------------------------------------------------------------------

def _zetas(kind):
    rng = np.random.default_rng(11)
    z = rng.normal(0, 0.3, (16, 7)).astype(np.float32)
    if kind == "small_angle":
        z[:, 3:6] *= np.float32(1e-6)
    elif kind == "zero_angle":
        z[:, 3:6] = 0.0
    elif kind == "small_scale":
        z[:, 6] *= np.float32(1e-7)
    elif kind == "zero_all_but_rho":
        z[:, 3:] = 0.0
    return z


@pytest.mark.parametrize("kind", ["generic", "small_angle", "zero_angle", "small_scale",
                                  "zero_all_but_rho"])
def test_sim3_exp_log_match_jax(kind):
    z = _zetas(kind)
    S_j = np.asarray(jsim3.sim3_exp(jnp.asarray(z)))
    S_p = psim3.sim3_exp(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(S_p, S_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(psim3.sim3_log(torch.from_numpy(S_j)).numpy(),
                               np.asarray(jsim3.sim3_log(jnp.asarray(S_j))), atol=1e-5)
    np.testing.assert_allclose(psim3._sim3_W(torch.from_numpy(z[:, 3:6]), torch.from_numpy(z[:, 6])).numpy(),
                               np.asarray(jsim3._sim3_W(jnp.asarray(z[:, 3:6]), jnp.asarray(z[:, 6]))),
                               atol=1e-5)
    np.testing.assert_allclose(psim3.sim3_to_se3(torch.from_numpy(S_j)).numpy(),
                               np.asarray(jsim3.sim3_to_se3(jnp.asarray(S_j))), atol=1e-5)


# ----------------------------------------------------------------------
# RANSAC, refinement, pose graph
# ----------------------------------------------------------------------

def _ransac_problem(seed, n_invalid):
    """tests/test_loop_components.py's RANSAC problem: 80 pairs, 20 gross
    outliers, optionally some pairs marked invalid."""
    rng = np.random.default_rng(seed)
    n = 80
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                  -1).astype(np.float32)
    R = np.asarray(so3_exp(jnp.asarray([0.05, 0.1, -0.02])))
    t = np.array([0.3, -0.1, 0.4], np.float32)
    p1 = (p2 @ R.T + t + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    out_idx = rng.choice(n, 20, replace=False)
    p1[out_idx] += (rng.uniform(1, 3, (20, 3)) * rng.choice([-1, 1], (20, 3))).astype(np.float32)
    s2 = (1.2 ** (2 * rng.integers(0, 4, (2, n)))).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_invalid, replace=False)] = False
    return p1, p2, s2[0], s2[1], valid


@pytest.mark.parametrize("seed,n_invalid", [(0, 0), (1, 10), (2, 40)])
def test_ransac_sim3_with_jax_picks(seed, n_invalid):
    """Fed the picks that jax.random.choice draws inside the JAX solver,
    the port gives the same inliers and ok, and S_12 within 1e-5."""
    p1, p2, s1, s2, valid = _ransac_problem(seed, n_invalid)
    key = jax.random.PRNGKey(seed)
    B = 256
    ref = j_ransac(key, CAM, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(s1), jnp.asarray(s2),
                   jnp.asarray(valid), n_hypotheses=B, min_inliers=20)
    probs = jnp.where(jnp.asarray(valid), 1.0, 0.0)
    probs = probs / jnp.maximum(probs.sum(), 1e-6)
    picks = np.asarray(jax.random.choice(key, p1.shape[0], shape=(B, 3), replace=True, p=probs))
    got = p_ransac(PCAM, _t(p1), _t(p2), _t(s1), _t(s2), _t(valid), n_hypotheses=B,
                   min_inliers=20, picks=torch.from_numpy(picks.astype(np.int64)))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert bool(got.ok) == bool(ref.ok)
    np.testing.assert_allclose(got.S_12.numpy(), np.asarray(ref.S_12), atol=1e-5)
    if n_invalid == 0:
        assert bool(got.ok) and int(got.n_inliers) >= 50


def test_ransac_sim3_draws_from_generator():
    """Without picks the port draws from a CPU generator: the same seed
    gives the same result, and the solve still finds the inliers."""
    p1, p2, s1, s2, valid = _ransac_problem(0, 0)
    args = (PCAM, _t(p1), _t(p2), _t(s1), _t(s2), _t(valid))
    a = p_ransac(*args, generator=torch.Generator().manual_seed(3))
    b = p_ransac(*args, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.inliers, b.inliers) and torch.equal(a.S_12, b.S_12)
    assert bool(a.ok) and int(a.n_inliers) >= 50


def _sim3_problem(seed):
    """tests/test_loop_components.py's optimize_sim3 problem."""
    rng = np.random.default_rng(seed)
    n = 60
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                  -1).astype(np.float32)
    R = np.asarray(so3_exp(jnp.asarray([0.05, 0.08, -0.03])))
    t = np.array([0.2, -0.15, 0.3], np.float32)
    S_true = np.asarray(make_S(jnp.asarray(1.0), jnp.asarray(R), jnp.asarray(t)))
    p1 = (p2 @ R.T + t).astype(np.float32)

    def project(p):
        return np.stack([500.0 * p[:, 0] / p[:, 2] + 320.0, 500.0 * p[:, 1] / p[:, 2] + 240.0], -1)

    obs1 = (project(p1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    obs2 = (project(p2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    obs1[:4] += 40.0  # a few gross outliers for the chi2 cut
    S_init = (np.asarray(make_S(jnp.asarray(1.0), so3_exp(jnp.asarray([0.02, -0.01, 0.01])),
                                jnp.asarray([0.05, 0.05, -0.05]))) @ S_true).astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, (2, n)))).astype(np.float32)
    return S_init, p1, p2, obs1, obs2, inv_s2[0], inv_s2[1], np.ones(n, bool), t


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_matches_jax(seed, fix_scale):
    S_init, p1, p2, o1, o2, w1, w2, valid, t = _sim3_problem(seed)
    S_j, inl_j, n_j = j_sim3opt(CAM, *(jnp.asarray(x) for x in (S_init, p1, p2, o1, o2, w1, w2, valid)),
                                fix_scale=fix_scale)
    S_p, inl_p, n_p = p_sim3opt(PCAM, *(_t(x) for x in (S_init, p1, p2, o1, o2, w1, w2, valid)),
                                fix_scale=fix_scale)
    np.testing.assert_array_equal(inl_p.numpy(), np.asarray(inl_j))
    assert int(n_p) == int(n_j) > 50
    np.testing.assert_allclose(S_p.numpy(), np.asarray(S_j), atol=1e-4)
    np.testing.assert_allclose(S_p.numpy()[:3, 3], t, atol=0.02)


def _chain_problem(V=10, fix_first=True, extra_invalid=False):
    """tests/test_loop_components.py's pose-graph problem: a drifted chain
    of V keyframes and one exact loop edge."""
    T_true, T_drift = [np.eye(4)], [np.eye(4)]
    step = np.asarray(se3_exp(jnp.asarray([0.5, 0, 0.02, 0, 0.05, 0])))
    drift = np.asarray(se3_exp(jnp.asarray([0.01, 0.004, 0.01, 0.0, 0.006, 0.0])))
    for _ in range(1, V):
        T_true.append(step @ T_true[-1])
        T_drift.append(drift @ step @ T_drift[-1])
    ei, ej, meas = [], [], []
    for i in range(V - 1):
        ei.append(i + 1)
        ej.append(i)
        meas.append(np.asarray(edge_measurement(jnp.asarray(T_drift[i + 1]), jnp.asarray(T_drift[i]))))
    ei.append(V - 1)
    ej.append(0)
    meas.append(np.asarray(edge_measurement(jnp.asarray(T_true[V - 1]), jnp.asarray(T_true[0]))))
    E = len(ei)
    fixed = np.zeros(V, bool)
    fixed[0] = fix_first
    vvalid = np.ones(V, bool)
    evalid = np.ones(E, bool)
    if extra_invalid:
        vvalid[V // 2] = False
        evalid[1] = False
    return dict(S_iw=np.stack(T_drift).astype(np.float32), fixed=fixed, vertex_valid=vvalid,
                edge_i=np.asarray(ei, np.int32), edge_j=np.asarray(ej, np.int32),
                edge_meas=np.stack(meas).astype(np.float32), edge_valid=evalid,
                edge_weight=np.ones(E, np.float32)), T_true, T_drift


@pytest.mark.parametrize("fix_scale,extra_invalid", [(True, False), (False, False), (True, True)])
def test_optimize_pose_graph_matches_jax(fix_scale, extra_invalid):
    d, T_true, T_drift = _chain_problem(extra_invalid=extra_invalid)
    S_j = np.asarray(j_pgo(JProblem(**{k: jnp.asarray(v) for k, v in d.items()}), iters=20,
                           fix_scale=fix_scale))
    S_p = p_pgo(PProblem(**{k: torch.from_numpy(v) for k, v in d.items()}), iters=20,
                fix_scale=fix_scale).numpy()
    np.testing.assert_allclose(S_p, S_j, atol=1e-4)
    np.testing.assert_array_equal(S_p[0], d["S_iw"][0])  # fixed vertex untouched
    if extra_invalid:
        np.testing.assert_array_equal(S_p[5], d["S_iw"][5])  # invalid vertex untouched
    elif fix_scale:
        err_before = np.linalg.norm(T_drift[-1][:3, 3] - T_true[-1][:3, 3])
        assert np.linalg.norm(S_p[-1][:3, 3] - T_true[-1][:3, 3]) < 0.3 * err_before


def _dense_graph():
    """V = 40 keyframes, each linked to the next 5 around a circle
    (degree 10), 20 random edges and 40 repeats of earlier edges (half
    reversed)."""
    return pose_graph_problem(np.random.default_rng(8), 40, 5, 20, 40)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_pose_graph_high_degree_matches_jax(fix_scale):
    d, T_true = _dense_graph()
    pairs = np.stack([np.minimum(d["edge_i"], d["edge_j"]), np.maximum(d["edge_i"], d["edge_j"])])
    assert np.unique(pairs, axis=1).shape[1] < pairs.shape[1]  # duplicate pairs
    assert np.bincount(np.concatenate([d["edge_i"], d["edge_j"]])).min() >= 10
    S_j = np.asarray(j_pgo(JProblem(**{k: jnp.asarray(v) for k, v in d.items()}), iters=20,
                           fix_scale=fix_scale))
    S_p = p_pgo(PProblem(**{k: torch.from_numpy(v) for k, v in d.items()}), iters=20,
                fix_scale=fix_scale).numpy()
    np.testing.assert_allclose(S_p, S_j, atol=1e-4)
    np.testing.assert_array_equal(S_p[0], d["S_iw"][0])

    def centres(S):
        S = S.astype(np.float64)
        return -np.einsum("vji,vj->vi", S[:, :3, :3], S[:, :3, 3])

    err_before = np.abs(centres(d["S_iw"]) - centres(T_true)).max()
    assert np.abs(centres(S_p) - centres(T_true)).max() < 0.1 * err_before


def test_pose_graph_assembly_matches_float64():
    d, _ = _dense_graph()
    V = d["S_iw"].shape[0]
    ic, jc = (torch.from_numpy(d[k]).to(torch.int64) for k in ("edge_i", "edge_j"))
    w_np = np.linspace(0.5, 2.0, ic.shape[0]).astype(np.float32)
    S = torch.from_numpy(d["S_iw"])
    r, Ji, Jj = ppg._edge_jacobians(torch.from_numpy(d["edge_meas"]), S[ic], S[jc], False)
    H, b = ppg.assemble(ppg.edge_segments(ic, jc, V), Ji, Jj, r, torch.from_numpy(w_np), V)
    Ji64, Jj64, r64 = (x.numpy().astype(np.float64) for x in (Ji, Jj, r))
    w64 = w_np.astype(np.float64)[:, None, None]
    H64 = np.zeros((V, V, 7, 7))
    b64 = np.zeros((V, 7))
    i, j = ic.numpy(), jc.numpy()
    Hij = w64 * np.einsum("eci,ecj->eij", Ji64, Jj64)
    np.add.at(H64, (i, j), Hij)
    np.add.at(H64, (j, i), Hij.transpose(0, 2, 1))
    np.add.at(H64, (i, i), w64 * np.einsum("eci,ecj->eij", Ji64, Ji64))
    np.add.at(H64, (j, j), w64 * np.einsum("eci,ecj->eij", Jj64, Jj64))
    np.add.at(b64, i, w64[:, :, 0] * np.einsum("eci,ec->ei", Ji64, r64))
    np.add.at(b64, j, w64[:, :, 0] * np.einsum("eci,ec->ei", Jj64, r64))
    assert H.shape == (V, V, 7, 7) and b.shape == (V, 7)
    np.testing.assert_allclose(H.numpy(), H64, rtol=1e-5, atol=1e-5 * np.abs(H64).max())
    np.testing.assert_allclose(b.numpy(), b64, rtol=1e-5, atol=1e-5 * np.abs(b64).max())


# ----------------------------------------------------------------------
# Covisibility rebuild, chunked LM
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_maps():
    return build_world(seed=3, n_kf=6)[0]


@pytest.mark.parametrize("edit", ["as_built", "duplicate_obs", "invalid_kf_and_points"])
def test_recompute_covis_all_matches_jax(world_maps, edit):
    mnp = {k: v.copy() for k, v in world_maps[-1].items()}
    rng = np.random.default_rng(5)
    if edit == "duplicate_obs":
        obs = mnp["mp_obs_kf"]
        live = np.where(obs[:, 0] >= 0)[0][:200]
        obs[live, -1] = obs[live, 0]  # the same observer twice counts once
    elif edit == "invalid_kf_and_points":
        mnp["kf_valid"][2] = False
        mnp["mp_valid"][rng.random(mnp["mp_valid"].shape[0]) < 0.3] = False
    ref = np.asarray(jms.recompute_covis_all(to_jax(mnp)).covis)
    got = pms.recompute_covis_all(to_port(mnp)).covis.numpy()
    assert got.dtype == np.int32 and ref.max() > 0
    np.testing.assert_array_equal(got, ref)


def test_lm_chunks_match_jax(rng):
    """Two chunks of 5 robust iterations carrying the damping, as global
    BA runs them, against JAX's ``_lm_chunk``; and ``lm_solve`` with a
    damping handed in."""
    prob, _, _, _ = make_ba_problem(rng, noise=0.2, outlier_frac=0.1)
    pp = ba_problem_from_numpy({k: np.asarray(v) for k, v in prob._asdict().items()})
    T, p, lam = jschur._lm_chunk(CAM, prob, prob.T_cw, prob.p_w, jnp.float32(1e-4), chunk=5)
    pT, pP, plam = pschur._lm_chunk(PCAM, pp, pp.T_cw, pp.p_w, torch.full((), 1e-4), chunk=5)
    np.testing.assert_allclose(plam.item(), float(lam), rtol=1e-6)
    np.testing.assert_allclose(pT.numpy(), np.asarray(T), atol=5e-3)
    # The second chunk from the same state: near convergence an accept
    # or a reject turns on the last bits of the cost, so the damping it
    # ends with is not compared; the poses and points are.
    T2, p2, _ = jschur._lm_chunk(CAM, prob, T, p, lam, chunk=5)
    pT2, pP2, _ = pschur._lm_chunk(PCAM, pp, _t(T), _t(p), torch.full((), float(lam)), chunk=5)
    np.testing.assert_allclose(pT2.numpy(), np.asarray(T2), atol=5e-3)
    np.testing.assert_allclose(pP2.numpy(), np.asarray(p2), atol=5e-3)
    _, _, c_j, lam_j = jschur.lm_solve(CAM, prob, 3, True, prob.obs_valid, lam_init=jnp.float32(0.5))
    _, _, c_p, lam_p = pschur.lm_solve(PCAM, pp, 3, True, pp.obs_valid,
                                       lam0=torch.full((), 0.5))
    np.testing.assert_allclose(c_p.item(), float(c_j), rtol=1e-4)
    np.testing.assert_allclose(lam_p.item(), float(lam_j), rtol=1e-6)
