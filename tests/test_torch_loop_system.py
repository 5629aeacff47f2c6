"""Loop closing through both packages' ``SlamSystem`` on the CPU.

tests/test_loop_closing.py's hand-built drifted revisit: keyframes 0-2
see place A, 3-8 place B, then two keyframes revisit place A with a
0.3 m drift in their poses.  Every keyframe goes through each package's
``_insert_keyframe`` (local mapping, then the loop closer), from the same
numpy inputs; the port's RANSAC is fed the picks that the JAX closer
draws from its ``PRNGKey(0)`` chain.  The JAX side runs its single-device
closer (dense detection and ``_lm_chunk``), the one the port mirrors.

* Both close the same loop: the same (query, matched) keyframes, loop
  count, candidate count, gate failures, loop events and cross-loop
  edges.
* The corrected revisit pose agrees within 1e-4 m, and ``shutdown()``
  finishes the global BA in both (the revisit pose again within 1e-4 m).
* The port reads the device at most twice per loop event: one packed
  verification vector per candidate and one bundle per correction, each
  through ``loop_impl._fetch``; any other host read of a tensor inside
  verification or correction raises.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_closing as tlc
from test_retrieval_recall import flip_bits

import ydorbslam_tpu.parallel.multihost as jmh
from ydorbslam_tpu.slam import loop_impl as jli
from ydorbslam_tpu.slam.system import Sensor as JSensor
from ydorbslam_tpu.slam.system import SlamSystem as JSystem

from ydorbslam_tpu_torch.convert import config_from_dict, features_from_numpy
from ydorbslam_tpu_torch.slam import loop_impl as pli
from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

torch.set_num_threads(2)


def _scenario(seed=42):
    """The numpy inputs of test_loop_closing's revisit: (place, feats
    dict, T_cw) per keyframe, place None for the drifted revisits."""
    rng = np.random.default_rng(seed)
    lms_a = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(3, 7, 200)], -1)
    lms_b = lms_a + np.array([40.0, 0.0, 0.0])
    desc_a = rng.integers(0, 2**32, (200, 8), dtype=np.uint32)
    desc_b = rng.integers(0, 2**32, (200, 8), dtype=np.uint32)

    def pose(x):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-x, 0.0, 0.0]
        return T

    def feats(lms, descs, T):
        f = tlc.fake_features(rng, lms, descs, T)
        return {k: np.array(v) for k, v in f._asdict().items()}

    steps = [("a", feats(lms_a, desc_a, pose(0.05 * i)), pose(0.05 * i)) for i in range(3)]
    steps += [("b", feats(lms_b, desc_b, pose(40.0 + 0.05 * i)), pose(40.0 + 0.05 * i))
              for i in range(6)]
    true = pose(0.1)
    drifted = true.copy()
    drifted[:3, 3] -= np.array([0.3, 0.0, 0.0], np.float32)
    steps += [(None, feats(lms_a, flip_bits(rng, desc_a, 0.08), true), drifted) for _ in range(2)]
    return steps, true


def _run_jax(steps):
    sys_ = JSystem(tlc.make_cfg(), JSensor.RGBD, enable_mapping=True, enable_loop_closing=True)
    pairs = []
    orig = jli.LoopCloserImpl._correct

    def correct(self, kf1, kf2, S_12, matched_mp):
        pairs.append((kf1, kf2))
        return orig(self, kf1, kf2, S_12, matched_mp)

    jli.LoopCloserImpl._correct = correct
    try:
        slots = _insert_all(sys_, steps, lambda f: tlc.FrameFeatures(
            **{k: jnp.asarray(v) for k, v in f.items()}), jnp.asarray,
            lambda s: np.asarray(sys_.map.kf_mp[s]))
        closed = sys_.loop_closer._impl._poll_pending()
        T_corr = np.asarray(sys_.map.kf_pose[slots[-1]])
        gba = sys_.loop_closer._impl._gba is not None
        sys_.shutdown()
    finally:
        jli.LoopCloserImpl._correct = orig
    return sys_, pairs, closed, gba, T_corr, np.asarray(sys_.map.kf_pose[slots[-1]])


def _insert_all(sys_, steps, to_feats, to_dev, kf_mp_row):
    """Insert the scenario's keyframes; a place's later keyframes bind to
    the points its first keyframe made.  Returns the revisit slots."""
    lm2mp, slots = {}, []
    for place, f, T in steps:
        matched = -np.ones(tlc.N_KP, np.int32)
        if place in lm2mp:
            matched[:200] = lm2mp[place]
        sys_._insert_keyframe(0.0, to_feats(f), to_dev(T), to_dev(matched))
        slot = sys_.ref_kf
        if place is not None:
            lm2mp[place] = kf_mp_row(slot)[:200]
        else:
            slots.append(slot)
    return slots


class _Picks:
    """The JAX closer's RANSAC draws: a PRNGKey(0) chain split once per
    verification, jax.random.choice over the eligible pairs."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)
        self.orig = pli.ransac_sim3

    def __call__(self, cam, p1, p2, s1, s2, valid, n_hypotheses=256, **kw):
        self.key, sub = jax.random.split(self.key)
        was, _ALLOW["on"] = _ALLOW["on"], True  # the test's own read of the mask
        try:
            mask = valid.numpy()
        finally:
            _ALLOW["on"] = was
        probs = jnp.where(jnp.asarray(mask), 1.0, 0.0)
        probs = probs / jnp.maximum(probs.sum(), 1e-6)
        picks = np.asarray(jax.random.choice(sub, valid.shape[0], shape=(n_hypotheses, 3),
                                             replace=True, p=probs))
        kw.update(picks=torch.from_numpy(picks.astype(np.int64)), generator=None)
        return self.orig(cam, p1, p2, s1, s2, valid, n_hypotheses=n_hypotheses, **kw)


_ALLOW = {"on": True}


@contextlib.contextmanager
def _no_host_reads():
    """Inside the scope a tensor read on the host (item, tolist, numpy,
    bool/int/float of a tensor) raises unless it goes through _fetch."""
    names = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def guard(name):
        orig = saved[name]

        def f(self, *a, **k):
            if not _ALLOW["on"]:
                raise AssertionError(f"host read Tensor.{name} outside loop_impl._fetch")
            return orig(self, *a, **k)
        return f

    for n in names:
        setattr(torch.Tensor, n, guard(n))
    _ALLOW["on"] = False
    try:
        yield
    finally:
        _ALLOW["on"] = True
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.fixture(scope="module")
def runs():
    steps, true = _scenario()
    mesh = jmh.device_mesh
    jmh.device_mesh = lambda *a, **k: None  # the single-device closer
    try:
        jax_run = _run_jax(steps)
    finally:
        jmh.device_mesh = mesh

    cfg = config_from_dict(dataclasses.asdict(tlc.make_cfg()))
    sys_ = SlamSystem(cfg, Sensor.RGBD, enable_mapping=True, enable_loop_closing=True, device="cpu")
    fetches = {"verify": 0, "correct": 0, "other": 0}
    phase = {"now": "other"}
    pairs = []
    impl_cls = pli.LoopCloserImpl
    orig = dict(fetch=pli._fetch, ransac=pli.ransac_sim3, cs=impl_cls._compute_sim3,
                co=impl_cls._correct)

    def fetch(x):
        fetches[phase["now"]] += 1
        was = _ALLOW["on"]
        _ALLOW["on"] = True
        try:
            return orig["fetch"](x)
        finally:
            _ALLOW["on"] = was

    def scoped(name, fn):
        def wrapper(self, *args):
            phase["now"] = name
            if name == "correct":
                pairs.append(tuple(args[:2]))
            try:
                with _no_host_reads():
                    return fn(self, *args)
            finally:
                phase["now"] = "other"
        return wrapper

    pli._fetch, pli.ransac_sim3 = fetch, _Picks()
    impl_cls._compute_sim3 = scoped("verify", orig["cs"])
    impl_cls._correct = scoped("correct", orig["co"])
    calls = {"verify": 0, "correct": 0}
    cs_counted = impl_cls._compute_sim3

    def count_cs(self, *a):
        calls["verify"] += 1
        return cs_counted(self, *a)

    impl_cls._compute_sim3 = count_cs
    try:
        slots = _insert_all(sys_, steps, features_from_numpy, torch.from_numpy,
                            lambda s: sys_.map.kf_mp[s].numpy())
        closed = sys_.loop_closer._impl._poll_pending()
        T_corr = sys_.map.kf_pose[slots[-1]].numpy()
        gba = sys_.loop_closer._impl._gba is not None
        sys_.shutdown()
    finally:
        pli._fetch, pli.ransac_sim3 = orig["fetch"], orig["ransac"]
        impl_cls._compute_sim3, impl_cls._correct = orig["cs"], orig["co"]
    calls["correct"] = len(pairs)
    port_run = (sys_, pairs, closed, gba, T_corr, sys_.map.kf_pose[slots[-1]].numpy())
    return jax_run, port_run, true, fetches, calls


def test_both_close_the_same_loop(runs):
    (jsys, jpairs, jclosed, _, _, _), (psys, ppairs, pclosed, _, _, _), _, _, _ = runs
    assert jclosed and pclosed
    assert ppairs == jpairs and len(jpairs) == 1
    assert psys.loop_closer.n_loops_closed == jsys.loop_closer.n_loops_closed == 1
    js, ps = jsys.run_stats(), psys.run_stats()
    for key in ("loops_closed", "loop_candidates", "global_ba_runs", "loop_conn_edges",
                "keyframes_inserted", "keyframes_live"):
        assert ps[key] == js[key], key
    assert ps["loop_verify_fails"] == js["loop_verify_fails"]
    assert len(ps["loop_events"]) == len(js["loop_events"]) == 1
    (pq, pm, pt), (jq, jm, jt) = ps["loop_events"][0], js["loop_events"][0]
    assert (pq, pm) == (jq, jm)
    np.testing.assert_allclose(pt, jt, atol=1e-5)


def test_corrected_revisit_pose_matches_jax(runs):
    (_, _, _, jgba, jT, jT_end), (_, _, _, pgba, pT, pT_end), true, _, _ = runs
    err = np.linalg.norm(pT[:3, 3] - true[:3, 3])
    assert err < 0.15, err  # the 0.3 m drift is corrected
    np.testing.assert_allclose(pT[:3, 3], jT[:3, 3], atol=1e-4)
    np.testing.assert_allclose(pT, jT, atol=1e-4)
    # shutdown() ran the global BA that the correction armed, in both.
    assert jgba and pgba
    np.testing.assert_allclose(pT_end[:3, 3], jT_end[:3, 3], atol=1e-4)


def test_shutdown_finishes_global_ba(runs):
    _, (psys, _, _, _, _, _), _, _, _ = runs
    assert psys.loop_closer._impl._gba is None
    assert psys.run_stats()["global_ba_runs"] == 1
    assert psys.loop_closer.flush() is False  # nothing left to do


def test_at_most_two_reads_per_loop_event(runs):
    """One packed read per verified candidate and one per correction,
    and no other host read of a tensor inside either."""
    *_, fetches, calls = runs
    assert calls["verify"] >= 1 and calls["correct"] == 1, calls
    assert fetches["verify"] == calls["verify"], (fetches, calls)
    assert fetches["correct"] == calls["correct"], (fetches, calls)
    assert fetches["verify"] // calls["verify"] + fetches["correct"] // calls["correct"] <= 2
