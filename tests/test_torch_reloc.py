"""The port's relocalization modules against the JAX package on the CPU.

``slam/retrieval.py`` (hash banks, BoW histograms, the index and its
candidate detection), ``geometry/sim3.py``, ``optim/horn.py`` and
``optim/pnp.py`` get the same numpy inputs, made from a seed, as their
JAX counterparts.  The RANSAC solvers are fed the JAX package's own
minimal sets (``jax.random.choice`` with the key the JAX solver uses),
so they are compared hypothesis for hypothesis.

Tolerances: word ids, histograms, presence rows, validity, common-word
counts, candidate ids, inlier masks and counts exact; L1 scores and
group scores within 1e-6 (sums in another order; measured 2.4e-7);
the Sim(3) helpers within 1e-5; Horn within 1e-5 on rigid sets (measured
4.1e-6: the float32 4x4 eigenvectors of 3-point sets differ between the
two eigensolvers by a few ulps) and 3e-5 on similarities of scale up to 2
(measured 1.2e-5); RANSAC poses within 1e-4 (measured 1.7e-6).
``choice_picks`` given JAX's uniforms agrees with ``jax.random.choice``
on at least 99 % of picks (measured 100 % of 3 x 3072: a pick can only
flip where the two cumsums round differently at a boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydorbslam_tpu.geometry import CameraIntrinsics as JaxCam
from ydorbslam_tpu.geometry import se3_exp as jax_se3_exp
from ydorbslam_tpu.geometry import sim3 as jsim3
from ydorbslam_tpu.optim import horn as jhorn
from ydorbslam_tpu.optim import pnp as jpnp
from ydorbslam_tpu.slam import retrieval as jret

from ydorbslam_tpu_torch.convert import retrieval_index_from_numpy, retrieval_index_to_numpy
from ydorbslam_tpu_torch.geometry import sim3 as psim3
from ydorbslam_tpu_torch.geometry.camera import CameraIntrinsics
from ydorbslam_tpu_torch.optim import horn as phorn
from ydorbslam_tpu_torch.optim import pnp as ppnp
from ydorbslam_tpu_torch.slam import retrieval as pret

torch.set_num_threads(2)

JCAM = JaxCam.create(500.0, 500.0, 320.0, 240.0, bf=50.0, width=640, height=480)
PCAM = CameraIntrinsics.create(500.0, 500.0, 320.0, 240.0, bf=50.0, width=640, height=480,
                               device="cpu")
BANKS = dict(n_banks=4, bank_bits=12)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def random_desc(rng, n):
    """(n, 8) uint32 descriptors; a tenth of the words have bit 31 set by
    construction, and one row is all ones."""
    d = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d[rng.random((n, 8)) < 0.1] |= np.uint32(1 << 31)
    d[0] = np.uint32(0xFFFFFFFF)
    return d


# ----------------------------------------------------------------------
# retrieval
# ----------------------------------------------------------------------

def test_hash_banks_are_the_jax_packages():
    np.testing.assert_array_equal(pret._hash_bit_positions(4, 12), jret._hash_bit_positions(4, 12))
    np.testing.assert_array_equal(pret._hash_bit_positions(2, 8), jret._hash_bit_positions(2, 8))


@pytest.mark.parametrize("valid_kind", ["random", "all", "none"])
def test_words_and_histogram_exact(valid_kind):
    rng = np.random.default_rng(11)
    d = random_desc(rng, 300)
    valid = {"random": rng.random(300) < 0.7, "all": np.ones(300, bool),
             "none": np.zeros(300, bool)}[valid_kind]
    np.testing.assert_array_equal(
        pret.descriptor_words(_t(d), **BANKS).numpy(),
        np.asarray(jret.descriptor_words(jnp.asarray(d), **BANKS)))
    hp = pret.bow_histogram(_t(d), _t(valid), **BANKS).numpy()
    hj = np.asarray(jret.bow_histogram(jnp.asarray(d), jnp.asarray(valid), **BANKS))
    np.testing.assert_array_equal(hp, hj)
    assert np.isfinite(hp).all()
    if valid_kind == "none":
        assert not hp.any()


def _jax_index(rng, K, n_kf, pool, n=200):
    """A JAX index of ``n_kf`` keyframes drawing descriptors from a shared
    pool (so keyframes share words), plus their inputs."""
    idx = jret.empty_index(K, **BANKS)
    kfs = []
    for k in range(n_kf):
        d = pool[rng.integers(0, len(pool), n)]
        v = rng.random(n) < 0.9
        idx = jret.add_keyframe(idx, k, jnp.asarray(d), jnp.asarray(v), **BANKS)
        kfs.append((d, v))
    return idx, kfs


def _index_np(idx):
    return {k: np.asarray(v) for k, v in idx._asdict().items()}


def test_index_add_remove_score_exact():
    rng = np.random.default_rng(12)
    pool = random_desc(rng, 600)
    jidx, _ = _jax_index(rng, 12, 6, pool)
    pidx = retrieval_index_from_numpy(_index_np(jidx))
    for k, v in retrieval_index_to_numpy(pidx).items():
        np.testing.assert_array_equal(v, _index_np(jidx)[k])
    d = pool[rng.integers(0, 600, 200)]
    v = rng.random(200) < 0.8
    jidx = jret.add_keyframe(jidx, 9, jnp.asarray(d), jnp.asarray(v), **BANKS)
    pidx = pret.add_keyframe(pidx, 9, _t(d), _t(v), **BANKS)
    rm = np.array([2, -1, 9, 2, -1, 30], np.int32)  # padding, a duplicate, out of range
    jidx = jret.remove_keyframes(jidx, jnp.asarray(rm))
    pidx = pret.remove_keyframes(pidx, _t(rm))
    jn = _index_np(jidx)
    for k, val in retrieval_index_to_numpy(pidx).items():
        np.testing.assert_array_equal(val, jn[k], err_msg=k)
    assert list(np.flatnonzero(jn["valid"])) == [0, 1, 3, 4, 5]
    q = pool[rng.integers(0, 600, 200)]
    qv = rng.random(200) < 0.9
    qh = np.asarray(jret.bow_histogram(jnp.asarray(q), jnp.asarray(qv), **BANKS))
    cj, sj = (np.asarray(a) for a in jret.score_all(jidx, jnp.asarray(qh)))
    cp, sp = (a.numpy() for a in pret.score_all(pidx, torch.from_numpy(qh)))
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_detect_candidates_matches_jax(seed):
    """A 40-keyframe index whose keyframes draw from 5 places, with
    covisibility weights from {0, 7, 15} (ties everywhere) and a few
    connected keyframes excluded."""
    rng = np.random.default_rng(100 + seed)
    K = 40
    places = [random_desc(rng, 300) for _ in range(5)]
    jidx = jret.empty_index(K, **BANKS)
    place_of = rng.integers(0, 5, K - 4)
    for k, p in enumerate(place_of):  # the last 4 slots stay empty
        d = places[p][rng.integers(0, 300, 150)]
        d = d ^ (rng.random(d.shape) < 0.01).astype(np.uint32)  # a few flipped bits
        jidx = jret.add_keyframe(jidx, k, jnp.asarray(d), jnp.asarray(rng.random(150) < 0.95),
                                 **BANKS)
    w = rng.choice(np.array([0, 0, 7, 15], np.int32), (K, K))
    covis = np.triu(w, 1) + np.triu(w, 1).T
    connected = np.zeros(K, bool)
    connected[rng.integers(0, K - 4, 3)] = True
    q = places[seed % 5][rng.integers(0, 300, 200)]
    qh = np.asarray(jret.bow_histogram(jnp.asarray(q), jnp.asarray(np.ones(200, bool)), **BANKS))
    for min_score in (-1.0, 0.05):
        ij, vj = (np.asarray(a) for a in jret.detect_candidates(
            jidx, jnp.asarray(qh), jnp.asarray(connected), jnp.asarray(covis),
            jnp.float32(min_score), max_out=8))
        ip, vp = (a.numpy() for a in pret.detect_candidates(
            retrieval_index_from_numpy(_index_np(jidx)), torch.from_numpy(qh),
            torch.from_numpy(connected), torch.from_numpy(covis), min_score, max_out=8))
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-6)
        assert (ij >= 0).sum() >= 1


def test_zero_query_has_no_candidates():
    """A blank frame's histogram (no valid keypoint) finds no candidate."""
    rng = np.random.default_rng(13)
    jidx, _ = _jax_index(rng, 8, 5, random_desc(rng, 400))
    pidx = retrieval_index_from_numpy(_index_np(jidx))
    q = pret.bow_histogram(torch.zeros((64, 8), dtype=torch.int32),
                           torch.zeros(64, dtype=torch.bool), **BANKS)
    ids, _ = pret.detect_candidates(pidx, q, torch.zeros(8, dtype=torch.bool),
                                    torch.zeros((8, 8), dtype=torch.int32), -1.0)
    assert (ids.numpy() == -1).all()


# ----------------------------------------------------------------------
# geometry/sim3.py and optim/horn.py
# ----------------------------------------------------------------------

def _rigid(rng, s=1.0):
    xi = rng.normal(0, 0.4, 6).astype(np.float32)
    T = np.asarray(jax_se3_exp(jnp.asarray(xi)))
    S = T.copy()
    S[:3, :3] *= s
    return S.astype(np.float32)


def test_sim3_helpers_match_jax():
    rng = np.random.default_rng(14)
    S = np.stack([_rigid(rng, s) for s in (1.0, 0.5, 2.5)])
    pts = rng.normal(0, 2, (3, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(psim3.inv_S(torch.from_numpy(S)).numpy(),
                               np.asarray(jsim3.inv_S(jnp.asarray(S))), atol=1e-5)
    for a, b in zip(psim3.split_S(torch.from_numpy(S)), jsim3.split_S(jnp.asarray(S))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(
        psim3.transform_points_S(torch.from_numpy(S), torch.from_numpy(pts)).numpy(),
        np.asarray(jsim3.transform_points_S(jnp.asarray(S), jnp.asarray(pts))), atol=1e-5)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_matches_jax(fix_scale):
    """A batch of 16 random rigid (or similarity) sets of 3 and 40 points,
    with 1 mm noise: the port's batched Horn against the JAX one per set."""
    rng = np.random.default_rng(15)
    for n in (3, 40):
        S = np.stack([_rigid(rng, 1.0 if fix_scale else rng.uniform(0.5, 2.0))
                      for _ in range(16)])
        p2 = rng.normal(0, 2, (16, n, 3)).astype(np.float32)
        p1 = (np.einsum("bij,bnj->bni", S[:, :3, :3], p2) + S[:, None, :3, 3]
              + rng.normal(0, 1e-3, (16, n, 3))).astype(np.float32)
        got = phorn.horn_sim3(torch.from_numpy(p1), torch.from_numpy(p2), fix_scale).numpy()
        want = np.stack([np.asarray(jhorn.horn_sim3(jnp.asarray(a), jnp.asarray(b), fix_scale))
                         for a, b in zip(p1, p2)])
        np.testing.assert_allclose(got, want, atol=1e-5 if fix_scale else 3e-5)
        np.testing.assert_allclose(got, S, atol=2e-2)


# ----------------------------------------------------------------------
# optim/pnp.py with the JAX package's picks
# ----------------------------------------------------------------------

def pose_problem(kind):
    """The outlier problem of tests/test_relocalization.py (200 points, 60
    outliers, 0.5 px noise) with depth-backprojected frame points
    (depth-sparse: only 2 points have depth)."""
    rng = np.random.default_rng(42)
    n = 200
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)],
                   -1).astype(np.float32)
    T = np.asarray(jax_se3_exp(jnp.asarray([0.2, -0.1, 0.3, 0.05, -0.02, 0.1])))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    out = rng.choice(n, 60, replace=False)
    uv[out] += (rng.uniform(30, 120, (60, 2)) * rng.choice([-1, 1], (60, 2))).astype(np.float32)
    p_cam = (pc + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    p_cam[out] += rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    has_depth = np.ones(n, bool) if kind == "outliers" else np.arange(n) < 2
    sigma2 = rng.choice(np.float32([1.0, 1.44, 2.0736]), n).astype(np.float32)
    valid = rng.random(n) < 0.95
    return dict(p_w=pts, p_cam=p_cam, uv=uv, sigma2=sigma2, has_depth=has_depth,
                valid=valid, T=T, out=out)


def jax_picks(key, mask, B, k):
    """The minimal sets the JAX solver draws from ``key``."""
    probs = jnp.asarray(mask).astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-6)
    return np.asarray(jax.random.choice(key, mask.shape[0], shape=(B, k), replace=True, p=probs))


@pytest.mark.parametrize("kind", ["outliers", "depth_sparse"])
@pytest.mark.parametrize("solver", ["3d3d", "pnp"])
def test_ransac_matches_jax_with_injected_picks(kind, solver):
    P = pose_problem(kind)
    key = jax.random.PRNGKey(3)
    B = 512
    J = {k: jnp.asarray(v) for k, v in P.items()}
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in P.items()}
    if solver == "3d3d":
        picks = jax_picks(key, P["valid"] & P["has_depth"], B, 3)
        rj = jpnp.ransac_pose_3d3d(key, JCAM, J["p_w"], J["p_cam"], J["uv"], J["sigma2"],
                                   J["has_depth"], J["valid"], n_hypotheses=B)
        rp = ppnp.ransac_pose_3d3d(PCAM, T["p_w"], T["p_cam"], T["uv"], T["sigma2"],
                                   T["has_depth"], T["valid"], picks=torch.from_numpy(picks))
    else:
        picks = jax_picks(key, P["valid"], B, ppnp.MIN_SET)
        rj = jpnp.ransac_pnp(key, JCAM, J["p_w"], J["uv"], J["sigma2"], J["valid"],
                             n_hypotheses=B)
        rp = ppnp.ransac_pnp(PCAM, T["p_w"], T["uv"], T["sigma2"], T["valid"],
                             picks=torch.from_numpy(picks))
    np.testing.assert_array_equal(rp.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rp.n_inliers) == int(rj.n_inliers)
    assert bool(rp.ok) == bool(rj.ok)
    if solver == "3d3d" and kind == "depth_sparse":
        assert not bool(rj.ok)  # two depths cannot seed a 3-point set
        return
    assert bool(rj.ok) and int(rj.n_inliers) >= 100
    np.testing.assert_allclose(rp.T_cw.numpy(), np.asarray(rj.T_cw), atol=1e-4)
    assert rp.inliers.numpy()[P["out"]].mean() < 0.05
    np.testing.assert_allclose(rp.T_cw.numpy()[:3, 3], P["T"][:3, 3], atol=0.05)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_choice_picks_matches_jax_choice(seed):
    """``choice_picks`` fed JAX's uniforms against ``jax.random.choice``:
    512 x 6 picks over 300 points of which ~60 % are eligible."""
    rng = np.random.default_rng(seed)
    mask = rng.random(300) < 0.6
    key = jax.random.PRNGKey(seed)
    want = jax_picks(key, mask, 512, 6)
    u = np.asarray(jax.random.uniform(key, (512, 6), dtype=jnp.float32))
    probs = torch.from_numpy(mask).float()
    got = ppnp.choice_picks(probs / probs.sum().clamp(min=1e-6), torch.from_numpy(u)).numpy()
    share = float((got == want).mean())
    assert share >= 0.99, share
    assert mask[got].all()


def test_choice_picks_without_eligible_points():
    picks = ppnp.choice_picks(torch.zeros(50), torch.rand(64, 3))
    assert (picks.numpy() == 0).all()
    want = jax_picks(jax.random.PRNGKey(0), np.zeros(50, bool), 64, 3)
    assert (want == 0).all()


def test_generator_draws_repeat():
    """Two solves from generators with one seed draw the same sets, and a
    draw picks only eligible points."""
    P = pose_problem("outliers")
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in P.items()}
    runs = [ppnp.ransac_pose_3d3d(PCAM, T["p_w"], T["p_cam"], T["uv"], T["sigma2"],
                                  T["has_depth"], T["valid"],
                                  generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0].T_cw, runs[1].T_cw)
    assert torch.equal(runs[0].inliers, runs[1].inliers)
    assert bool(runs[0].ok)
    picks = ppnp._draw(T["valid"], (256, 6), torch.Generator().manual_seed(1))
    assert P["valid"][picks.numpy()].all()
