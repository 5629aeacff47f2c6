"""K4 and the port's bundle adjustment against the JAX package on the CPU.

* ``optim.lm_kernel.lm_obs_plain`` (K4's plain version) against
  ``lm_obs_pallas`` in interpret mode, on the stacked input that
  ``schur._flat_system_kernel`` builds, as tests/test_lm_kernel.py runs it.
* The port's ``_flat_system`` (K4 + the camera reduction) against JAX's
  ``_flat_system`` (XLA) and ``_flat_system_kernel`` (Pallas): rtol 2e-4,
  atol 2e-3, the tolerance tests/test_lm_kernel.py holds the two JAX
  forms to.
* ``bundle_adjust`` on tests/test_ba.py's problems: each LM phase's
  final cost within 1e-4 relative, identical outlier masks.

The raw per-observation columns of K4 are held per column to a tolerance
scaled by that column's largest magnitude (1e-6 of it), because a few
entries are differences of nearly equal products: XLA on the CPU
contracts multiply-adds into FMAs and PyTorch rounds each operation, so
such entries differ in absolute terms by a few ulps of the products.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_ba import CAM, make_ba_problem
from test_lm_kernel import _pad_problem

from ydorbslam_tpu.optim import schur as jschur
from ydorbslam_tpu.optim.lm_kernel import lm_obs_pallas

from ydorbslam_tpu_torch.convert import ba_problem_from_numpy, camera_from_numpy
from ydorbslam_tpu_torch.ops import launch_counts
from ydorbslam_tpu_torch.optim import schur as pschur
from ydorbslam_tpu_torch.optim.lm_kernel import NIN, lm_obs, lm_obs_plain

torch.set_num_threads(2)

PCAM = camera_from_numpy(tuple(CAM))


def _np(prob) -> dict:
    return {k: np.asarray(v) for k, v in prob._asdict().items()}


def _jax_inp(prob, use_huber):
    """The stacked (32, O, P) input of schur._flat_system_kernel."""
    f = jschur._flatten_obs(prob)
    af = jschur._po_flat(prob.obs_valid)
    C, P, O = prob.C, prob.P, prob.obs_cam.shape[1]
    Q = O * P
    Tf = prob.T_cw.reshape(C, 16)[f.cam_idx]
    one = jnp.ones((1, Q), jnp.float32)
    return jnp.concatenate([
        Tf[:, jnp.array([0, 1, 2, 4, 5, 6, 8, 9, 10])].T, Tf[:, jnp.array([3, 7, 11])].T,
        prob.p_w[f.p_idx].T, f.obs_u[None], f.obs_v[None], f.obs_r[None], f.inv_s2[None],
        f.stereo.astype(jnp.float32)[None], (f.base_ok & af).astype(jnp.float32)[None],
        (1.0 if use_huber else 0.0) * one,
        CAM.fx * one, CAM.fy * one, CAM.cx * one, CAM.cy * one, CAM.bf * one,
        jnp.zeros((NIN - 27, Q), jnp.float32),
    ], 0).reshape(NIN, O, P)


@pytest.mark.parametrize("use_huber", [True, False])
def test_lm_obs_plain_matches_pallas(rng, use_huber):
    prob, _, _, _ = make_ba_problem(rng, C=6, P=100, O=6, noise=0.5, perturb=0.05)
    prob = _pad_problem(prob, 512, 8)
    inp = _jax_inp(prob, use_huber)
    ref_q, ref_p = (np.asarray(x) for x in lm_obs_pallas(inp))
    before = launch_counts()["lm_obs"]
    got_q, got_p = (x.numpy() for x in lm_obs(torch.from_numpy(np.array(inp))))
    assert launch_counts()["lm_obs"] == before  # the CPU takes the plain version
    for got, ref in ((got_q, ref_q), (got_p, ref_p)):
        assert got.shape == ref.shape
        scale = np.abs(ref).reshape(ref.shape[0], -1).max(1).reshape((-1,) + (1,) * (ref.ndim - 1))
        assert np.all(np.abs(got - ref) <= 2e-3 + 2e-4 * np.abs(ref) + 1e-6 * scale)
    np.testing.assert_allclose(got_p[12].sum(), ref_p[12].sum(), rtol=1e-5)  # cost


@pytest.mark.parametrize("use_huber", [True, False])
@pytest.mark.parametrize("padded", [True, False])
def test_flat_system_matches_jax(rng, use_huber, padded):
    """The port's _flat_system against JAX's XLA body and, on the padded
    problem the Pallas kernel takes, its kernel form."""
    prob, _, _, _ = make_ba_problem(rng, C=6, P=100, O=6, noise=0.5, perturb=0.05)
    if padded:
        prob = _pad_problem(prob, 512, 8)
    f = jschur._flatten_obs(prob)
    af = jschur._po_flat(prob.obs_valid)
    refs = [jschur._flat_system(CAM, prob.T_cw, prob.p_w, prob, f, af, jnp.asarray(use_huber))]
    if padded:
        refs.append(jschur._flat_system_kernel(
            CAM, prob.T_cw, prob.p_w, prob, f, af, jnp.asarray(use_huber)))
    pp = ba_problem_from_numpy(_np(prob))
    pf = pschur._flatten_obs(pp)
    got = pschur._flat_system(PCAM, pp.T_cw, pp.p_w, pp, pf, pschur._po_flat(pp.obs_valid),
                              use_huber)
    for ref in refs:
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
        for name in ("red", "Hpp", "bp", "Bq"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                       rtol=2e-4, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("case", ["converge", "outliers", "fixed", "global"])
def test_bundle_adjust_matches_jax(rng, case):
    """tests/test_ba.py's problems.  Each LM phase started from the same
    state ends at a cost within 1e-4 relative of JAX's (the robust phase
    from the problem, the plain phase from JAX's robust result and inlier
    set), and the whole ``bundle_adjust`` gives the same outlier masks.
    Its poses agree within 5e-3: on the fixed-camera problem the plain
    phase's costs agree to 2e-5 while poses differ by 1.2e-3, a flat
    valley that float32 sums taken in another order wander along."""
    kw = dict(converge=dict(noise=0.1), outliers=dict(noise=0.2, outlier_frac=0.15),
              fixed=dict(C=5), **{"global": dict(noise=0.1)})[case]
    prob, _, _, _ = make_ba_problem(rng, **kw)
    if case == "fixed":
        fixed = np.zeros(5, bool)
        fixed[:2] = True
        prob = prob._replace(cam_fixed=jnp.asarray(fixed))
    iters1, iters2 = (0, 10) if case == "global" else (5, 10)
    pp = ba_problem_from_numpy(_np(prob))

    T1, p1, c1, _ = jschur.lm_solve(CAM, prob, iters1 or iters2, True, prob.obs_valid)
    _, _, pc1, _ = pschur.lm_solve(PCAM, pp, iters1 or iters2, True, pp.obs_valid)
    np.testing.assert_allclose(pc1.item(), float(c1), rtol=1e-4)
    if iters1:
        f = jschur._flatten_obs(prob)
        pr = jschur._flat_project(CAM, T1, p1, f)
        wu, wv, wr, mask = jschur._flat_weights(f, pr["zr"], jschur._po_flat(prob.obs_valid))
        chi2 = jschur._po_unflat(jschur._flat_chi2(pr, wu, wv, wr), prob.P, prob.O)
        inlier = jschur._po_unflat(mask, prob.P, prob.O) & (
            chi2 <= jnp.where(prob.obs_stereo, 7.815, 5.991))
        _, _, c2, _ = jschur.lm_solve(CAM, prob._replace(T_cw=T1, p_w=p1), iters2, False, inlier)
        _, _, pc2, _ = pschur.lm_solve(
            PCAM, pp._replace(T_cw=torch.from_numpy(np.array(T1)), p_w=torch.from_numpy(np.array(p1))),
            iters2, False, torch.from_numpy(np.array(inlier)))
        np.testing.assert_allclose(pc2.item(), float(c2), rtol=1e-4)

    T, p, out = jschur.bundle_adjust(CAM, prob, iters1=iters1, iters2=iters2)
    pT, pP, pout = pschur.bundle_adjust(PCAM, pp, iters1=iters1, iters2=iters2)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(out))
    if case == "outliers":
        assert pout.numpy().sum() > 5
    np.testing.assert_allclose(pT.numpy(), np.asarray(T), atol=5e-3)
    if case == "fixed":
        np.testing.assert_array_equal(pT.numpy()[:2], np.asarray(prob.T_cw)[:2])


def test_inv3x3_matches_jax(rng):
    A = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(pschur.inv3x3(torch.from_numpy(A)).numpy(),
                               np.asarray(jschur.inv3x3(jnp.asarray(A))), rtol=1e-5, atol=1e-5)


def test_cholesky_failure_gives_zero_step():
    """A reduced system that is not positive definite gives a zero camera
    step (the JAX package's NaN factor through its isfinite guard), with
    no host read of the factorisation's status."""
    S = torch.zeros((2, 2, 6, 6))
    S[0, 0] = torch.eye(6)
    S[1, 1] = -torch.eye(6)
    x = pschur._cholesky_solve_blocks(S, torch.ones((2, 6)))
    assert torch.equal(x, torch.zeros((2, 6)))
    S[1, 1] = 2 * torch.eye(6)
    x = pschur._cholesky_solve_blocks(S, torch.ones((2, 6)))
    np.testing.assert_allclose(x.numpy(), np.r_[np.ones(6), 0.5 * np.ones(6)].reshape(2, 6),
                               rtol=1e-6)


def test_ba_problem_round_trip(rng):
    prob, _, _, _ = make_ba_problem(rng, C=4, P=20, O=4)
    ref = _np(prob)
    got = ba_problem_from_numpy(ref)
    for name, v in ref.items():
        out = getattr(got, name).numpy()
        assert out.dtype == v.dtype, name
        np.testing.assert_array_equal(out, v, err_msg=name)
    np.testing.assert_array_equal(lm_obs_plain(torch.zeros((NIN, 2, 3)))[1].numpy(),
                                  np.zeros((16, 3), np.float32))
