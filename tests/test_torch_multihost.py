"""The port's ``parallel/multihost.py`` in one process, on the CPU.

The environment contract and the no-op join match the JAX package's
(tests/test_multihost.py).  With no process group, and in a group of one
rank, ``device_mesh`` is None, so the loop closer takes its dense paths;
a spy sees the closer ask for its "kf" and "pts" groups, as the JAX
package's ``test_production_paths_use_device_mesh`` does.  A world of one
gloo rank joined through the ``YDORBSLAM_*`` trio runs the sharded LM
chunk and scores on a one-rank ``ShardGroup``: the bits of the dense
forms (the CPU form of ``chip_smoke.py`` phase 21 (a)).  The TUM runner
joins such a world and prints its ``distributed:`` line.  Every test that
makes a group destroys it.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from test_ba import CAM, make_ba_problem
from test_torch_tum_runner import tum  # noqa: F401  (the module's sequence fixture)

from ydorbslam_tpu.parallel import multihost as jmh
from ydorbslam_tpu.slam import retrieval as jret

from ydorbslam_tpu_torch.apps import run_tum_rgbd
from ydorbslam_tpu_torch.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from ydorbslam_tpu_torch.convert import (
    ba_problem_from_numpy, camera_from_numpy, retrieval_index_from_numpy,
)
from ydorbslam_tpu_torch.optim import schur
from ydorbslam_tpu_torch.parallel import multihost
from ydorbslam_tpu_torch.parallel.ba_sharded import _sharded_lm_chunk
from ydorbslam_tpu_torch.parallel.retrieval_sharded import score_all_sharded, sharded_topk_scores
from ydorbslam_tpu_torch.slam.retrieval import score_all
from ydorbslam_tpu_torch.testing import free_port

torch.set_num_threads(2)

ENV = ("YDORBSLAM_COORDINATOR", "YDORBSLAM_NUM_PROCESSES", "YDORBSLAM_PROCESS_ID",
       "YDORBSLAM_AUTO_DISTRIBUTED", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
       "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    return monkeypatch


@pytest.fixture
def world_of_one(clean_env):
    """The trio for a world of one rank on a free local port; the group
    the test makes is destroyed at its end."""
    clean_env.setenv("YDORBSLAM_COORDINATOR", f"127.0.0.1:{free_port()}")
    clean_env.setenv("YDORBSLAM_NUM_PROCESSES", "1")
    clean_env.setenv("YDORBSLAM_PROCESS_ID", "0")
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_is_noop_single_process(clean_env):
    assert multihost.initialize_distributed("cpu") is False
    assert multihost.initialize_distributed("cpu") is False  # idempotent
    assert not dist.is_initialized()
    info = multihost.process_info()
    assert info == dict(process_index=0, process_count=1, local_devices=1, global_devices=1)
    assert multihost.is_writer() and multihost.environment_error() is None
    assert multihost.device_mesh("kf") is None
    assert multihost.device_mesh("pts", length_divisor=1024) is None


def test_distributed_env_contract(clean_env):
    """The JAX package's contract, key for key."""
    clean_env.setenv("YDORBSLAM_COORDINATOR", "10.0.0.1:8476")
    clean_env.setenv("YDORBSLAM_NUM_PROCESSES", "4")
    clean_env.setenv("YDORBSLAM_PROCESS_ID", "2")
    spec = multihost.distributed_env()
    assert spec == jmh.distributed_env() == dict(
        coordinator_address="10.0.0.1:8476", num_processes=4, process_id=2)
    assert multihost.environment_error() is None
    clean_env.delenv("YDORBSLAM_PROCESS_ID")
    assert "YDORBSLAM_PROCESS_ID" in multihost.environment_error()
    clean_env.delenv("YDORBSLAM_COORDINATOR")
    assert multihost.distributed_env() is None and multihost.environment_error() is None
    clean_env.setenv("YDORBSLAM_AUTO_DISTRIBUTED", "1")
    assert "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT" in multihost.environment_error()
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "29500")):
        clean_env.setenv(k, v)
    assert multihost.environment_error() is None


def test_world_of_one_takes_the_dense_bits(world_of_one):
    """Joined through the trio: gloo on the CPU, one rank, no sharded
    group for the closer; on a one-rank ShardGroup the sharded chunk is
    bit-equal to ``_lm_chunk`` and the sharded scores to ``score_all``."""
    assert multihost.initialize_distributed("cpu") is True
    assert multihost.initialize_distributed("cpu") is True  # idempotent
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert multihost.process_info()["process_count"] == 1 and multihost.is_writer()
    assert multihost.device_mesh("kf", length_divisor=8) is None
    g = multihost.ShardGroup(dist.group.WORLD, 0, 1, "pts")

    prob, _, _, _ = make_ba_problem(np.random.default_rng(42), C=6, P=128, O=8, noise=0.1)
    pp = ba_problem_from_numpy({k: np.asarray(v) for k, v in prob._asdict().items()})
    cam = camera_from_numpy(tuple(np.asarray(x) for x in CAM))
    T, p, lam = pp.T_cw, pp.p_w, torch.full((), 1e-4)
    dT, dp, dlam = T, p, lam
    for _ in range(2):
        T, p, lam = _sharded_lm_chunk(g, cam, pp, T, p, lam, 5, True)
        dT, dp, dlam = schur._lm_chunk(cam, pp, dT, dp, dlam, chunk=5)
        assert torch.equal(T, dT) and torch.equal(p, dp) and torch.equal(lam, dlam)

    rng = np.random.default_rng(0)
    idx = jret.empty_index(16)
    descs = [rng.integers(0, 2**32, (128, 8), dtype=np.uint32) for _ in range(10)]
    for k, d in enumerate(descs):
        idx = jret.add_keyframe(idx, k, jnp.asarray(d), jnp.ones(128, bool))
    q = torch.from_numpy(np.array(jret.bow_histogram(jnp.asarray(descs[3]), jnp.ones(128, bool))))
    pidx = retrieval_index_from_numpy({k: np.asarray(v) for k, v in idx._asdict().items()})
    common, score = score_all(pidx, q)
    gk = g._replace(axis_name="kf")
    sc, ss = score_all_sharded(gk, pidx, q)
    assert torch.equal(sc, common) and torch.equal(ss, score)
    ids, vals = sharded_topk_scores(gk, pidx, q, k=4)
    assert int(ids[0]) == 3 and torch.equal(vals, score[ids])


def test_production_paths_use_device_mesh(clean_env):
    """The closer asks ``multihost.device_mesh`` for its keyframe group
    when it is built and for its point group when a global BA is armed
    (seen by a spy, not by source text); at one rank both are None, and
    the armed BA runs to its merge through the dense chunks."""
    from ydorbslam_tpu_torch.slam.loop_impl import LoopCloserImpl
    from ydorbslam_tpu_torch.slam.system import Sensor, SlamSystem

    calls = []
    orig = multihost.device_mesh

    def spy(axis_name, length_divisor=None):
        calls.append((axis_name, length_divisor))
        return orig(axis_name, length_divisor=length_divisor)

    clean_env.setattr(multihost, "device_mesh", spy)
    cfg = SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640,
                            height=480),
        orb=OrbConfig(n_features=128),
        capacity=CapacityConfig(
            max_keypoints=128, max_keyframes=8, max_map_points=512, max_obs_per_point=8,
            local_ba_window_kf=4, local_ba_fixed_kf=2, local_ba_max_points=256,
            tracking_points=256, global_ba_max_points=256,
        ),
    )
    sys_ = SlamSystem(cfg, Sensor.RGBD, enable_mapping=True, enable_loop_closing=True,
                      device="cpu")
    impl = LoopCloserImpl(sys_, sys_.loop_closer)
    assert ("kf", 8) in calls, calls
    impl._start_global_ba(sys_.map, 0)
    assert ("pts", 256) in calls, calls
    assert impl._kf_group is None and impl._gba["group"] is None
    while impl._gba is not None:
        impl.tick()
    assert not impl.used_sharded_detect


def test_tum_runner_joins_a_world_of_one(tum, world_of_one, tmp_path, capsys):  # noqa: F811
    """The TUM runner joins through the trio (gloo on the CPU), prints the
    JAX runner's ``distributed:`` line and, as rank 0, writes its files."""
    traj, kf = tmp_path / "traj.txt", tmp_path / "kf.txt"
    run_tum_rgbd.main([tum["yaml"], tum["root"], tum["assoc"], "--device", "cpu",
                       "--max-frames", "2", "--out-trajectory", str(traj),
                       "--out-kf-trajectory", str(kf)])
    assert dist.is_initialized() and dist.get_world_size() == 1
    out = capsys.readouterr().out
    assert ("distributed: {'process_index': 0, 'process_count': 1, 'local_devices': 1, "
            "'global_devices': 1}") in out, out
    assert "frames        2  (lost 0" in out and traj.exists() and kf.exists()
