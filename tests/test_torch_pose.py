"""Parity of the port's pose-only LM (ydorbslam_tpu_torch.optim.pose) and
SE(3) helpers with the JAX package on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydorbslam_tpu.config import CameraConfig, SlamConfig, camera_intrinsics as jax_cam
from ydorbslam_tpu.geometry import se3 as jse3
from ydorbslam_tpu.optim import pose as jpose
from ydorbslam_tpu.optim.residuals import huber_cost as jax_huber_cost
from ydorbslam_tpu.optim.residuals import huber_scale as jax_huber_scale

from ydorbslam_tpu_torch.config import camera_intrinsics as torch_cam
from ydorbslam_tpu_torch.geometry import se3 as tse3
from ydorbslam_tpu_torch.optim import pose as tpose
from ydorbslam_tpu_torch.optim.residuals import huber_cost, huber_scale

torch.set_num_threads(2)

CFG = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_se3_and_huber_match_jax(rng):
    xi = rng.normal(0, 0.3, (64, 6)).astype(np.float32)
    xi[:4] *= 1e-5  # the small-angle branch
    # Rodrigues in float32, sums in another order: 1e-6.
    np.testing.assert_allclose(
        tse3.se3_exp(_t(xi)).numpy(), np.asarray(jse3.se3_exp(jnp.asarray(xi))),
        rtol=0, atol=1e-6,
    )
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(
        tse3.inv_T(_t(T)).numpy(), np.asarray(jse3.inv_T(jnp.asarray(T))), rtol=0, atol=1e-6,
    )
    Tn = T.copy()
    Tn[:, :3, :3] += rng.normal(0, 1e-3, (64, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.orthonormalize_T(_t(Tn)).numpy(),
        np.asarray(jse3.orthonormalize_T(jnp.asarray(Tn))), rtol=0, atol=1e-6,
    )
    chi2 = rng.uniform(0, 20, 100).astype(np.float32)
    d2 = np.where(rng.random(100) < 0.5, 5.991, 7.815).astype(np.float32)
    # Elementwise float32, the same operations: within an ulp.
    np.testing.assert_allclose(huber_scale(_t(chi2), _t(d2)).numpy(),
                               np.asarray(jax_huber_scale(chi2, d2)), rtol=1e-6)
    np.testing.assert_allclose(huber_cost(_t(chi2), _t(d2)).numpy(),
                               np.asarray(jax_huber_cost(chi2, d2)), rtol=1e-6)


def _observations(rng, n=300, outliers=0.15):
    """Landmarks seen from a known pose with pixel noise, a stereo share
    and gross outliers; the LM starts from a perturbed pose."""
    T_true = np.asarray(jse3.se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.03, 0.01])))
    p_c = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)], -1)
    R, t = T_true[:3, :3], T_true[:3, 3]
    p_w = (p_c - t) @ R
    u = 500 * p_c[:, 0] / p_c[:, 2] + 320 + rng.normal(0, 0.7, n)
    v = 500 * p_c[:, 1] / p_c[:, 2] + 240 + rng.normal(0, 0.7, n)
    ur = u - 50 / p_c[:, 2]
    bad = rng.random(n) < outliers
    u[bad] += rng.choice([-1.0, 1.0], bad.sum()) * rng.uniform(10, 40, bad.sum())
    has_stereo = rng.random(n) < 0.6
    octave = rng.integers(0, 8, n)
    obs = dict(
        p_w=p_w.astype(np.float32),
        obs_uvr=np.stack([u, v, np.where(has_stereo, ur, -1)], -1).astype(np.float32),
        inv_sigma2=(1.0 / 1.44 ** octave).astype(np.float32),
        has_stereo=has_stereo,
        valid=rng.random(n) < 0.95,
    )
    T0 = np.asarray(jse3.se3_exp(jnp.asarray([0.02, 0.01, -0.03, -0.01, 0.01, 0.005]))) @ T_true
    return obs, T0.astype(np.float32), T_true, bad


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_matches_jax(seed):
    obs, T0, T_true, bad = _observations(np.random.default_rng(seed))
    T_j, in_j, n_j = jpose.optimize_pose(
        jax_cam(CFG), jnp.asarray(T0),
        jpose.PoseObservations(**{k: jnp.asarray(v) for k, v in obs.items()}),
    )
    T_p, in_p, n_p = tpose.optimize_pose(
        torch_cam(CFG, "cpu"), _t(T0),
        tpose.PoseObservations(**{k: _t(v) for k, v in obs.items()}),
    )
    # Float32 sums (J J^T, the costs) taken in another order and another
    # 6x6 Cholesky: the poses agree to 1e-4; the inlier classification
    # is identical.
    np.testing.assert_allclose(T_p.numpy(), np.asarray(T_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(in_p.numpy(), np.asarray(in_j))
    assert int(n_p) == int(n_j)
    # And the solve is a real one: near the truth, outliers rejected.
    assert np.abs(T_p.numpy() - T_true).max() < 1e-2
    assert not (in_p.numpy() & bad).any()
    assert in_p.numpy().sum() > 0.7 * len(bad)
