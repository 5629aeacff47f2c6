"""The port's TUM RGB-D runner, its sequence writer and its native loader,
on the CPU.

``testing.write_tum_sequence`` writes ``bench.make_frames()``-style
frames as a TUM directory; ``io.TumRgbdDataset`` of both packages reads
them back bit for bit.  The native loader (``io/native_loader.py``, a
copy of the JAX package's) reads the same shared library as the JAX
package's and agrees with it exactly and with PIL as
``tests/test_native_loader.py`` holds it; those cases skip where no
toolchain builds ``native/``.  The runner,
``python -m ydorbslam_tpu_torch.apps.run_tum_rgbd``, runs 4 frames on the
CPU at the settings file's defaults (``load_config``'s capacities: the
first local BA comes later) and prints the JAX runner's lines.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ydorbslam_tpu.io import native_loader as jnl
from ydorbslam_tpu.io.tum import TumRgbdDataset as JaxTumRgbdDataset

from ydorbslam_tpu_torch.apps import run_tum_rgbd
from ydorbslam_tpu_torch.config import SlamConfig, load_config
from ydorbslam_tpu_torch.io import TumRgbdDataset, read_tum_trajectory
from ydorbslam_tpu_torch.io import native_loader as pnl
from ydorbslam_tpu_torch.testing import TUM_RGBD_SETTINGS, write_tum_sequence

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 6


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    """``bench.make_frames``' first frames and their ground truth on disk."""
    sys.path.insert(0, REPO)
    import bench
    from synthetic import oscillating_trajectory

    frames = bench.make_frames(N_FRAMES)
    poses = oscillating_trajectory(N_FRAMES)
    root = str(tmp_path_factory.mktemp("tum") / "seq")
    yaml, assoc, gt = write_tum_sequence(root, frames, poses, TUM_RGBD_SETTINGS)
    return dict(root=root, yaml=yaml, assoc=assoc, gt=gt, frames=frames, poses=poses)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_written_sequence_reads_back_bit_exact(tum, package):
    cls = TumRgbdDataset if package == "port" else JaxTumRgbdDataset
    ds = cls(tum["root"], tum["assoc"], 5000.0)
    assert len(ds) == N_FRAMES
    for i, (t, gray, depth) in enumerate(tum["frames"]):
        t2, g2, d2 = ds[i]
        assert abs(t2 - t) < 1e-6
        assert g2.dtype == np.uint8 and d2.dtype == np.uint16
        np.testing.assert_array_equal(g2, gray)
        np.testing.assert_array_equal(d2, depth)


def test_written_settings_and_ground_truth(tum):
    cfg = load_config(tum["yaml"])
    with open(tum["yaml"]) as f:
        assert len(f.read().splitlines()) == 1 + len(TUM_RGBD_SETTINGS)
    c = cfg.camera
    assert (c.fx, c.fy, c.cx, c.cy, c.bf, c.fps, c.is_rgb) == (500.0, 500.0, 320.0, 240.0,
                                                                 50.0, 30.0, True)
    assert (c.k1, c.k2, c.p1, c.p2, c.k3) == (0.0,) * 5
    assert (cfg.depth.th_depth, cfg.depth.depth_map_factor) == (40.0, 5000.0)
    assert (cfg.orb.n_features, cfg.orb.scale_factor, cfg.orb.n_levels,
            cfg.orb.ini_th_fast, cfg.orb.min_th_fast) == (1000, 1.2, 8, 20, 7)
    # Capacities and the initialization gate stay at the defaults.
    assert cfg.capacity == SlamConfig().capacity and cfg.tracking == SlamConfig().tracking
    assert cfg.capacity.max_keyframes == 512 and cfg.capacity.max_map_points == 65536
    t, p, q = read_tum_trajectory(tum["gt"])
    np.testing.assert_allclose(t, [f[0] for f in tum["frames"]], atol=1e-6)
    for T, pos, quat in zip(tum["poses"], p, q):
        R_wc = T[:3, :3].T
        np.testing.assert_allclose(pos, -R_wc @ T[:3, 3], atol=1e-8)
        x, y, z, w = quat
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        np.testing.assert_allclose(R, R_wc, atol=1e-8)


def test_native_loader_uses_the_repository_library():
    assert pnl._LIB_PATH == jnl._LIB_PATH
    assert pnl._LIB_PATH == os.path.join(REPO, "native", "libtumloader.so")


@pytest.mark.parametrize("lookahead", [1, 4])
def test_native_loader_matches_jax_and_pil(tum, lookahead):
    if not pnl.native_available() and not pnl.build_native():
        pytest.skip("native toolchain unavailable")
    port = pnl.NativeTumLoader(tum["root"], tum["assoc"], 5000.0, lookahead=lookahead)
    jax = jnl.NativeTumLoader(tum["root"], tum["assoc"], 5000.0, lookahead=lookahead)
    ref = TumRgbdDataset(tum["root"], tum["assoc"], 5000.0)
    assert len(port) == len(jax) == N_FRAMES
    for i, ((t, g, d), (tj, gj, dj)) in enumerate(zip(port, jax)):
        assert t == tj
        np.testing.assert_array_equal(g, gj)
        np.testing.assert_array_equal(d, dj)
        t2, g2, d2 = ref[i]
        assert abs(t - t2) < 1e-6
        np.testing.assert_allclose(g, g2, atol=0.51)  # 8-bit rounding
        np.testing.assert_allclose(d, d2, atol=1e-4)
    port.close()
    jax.close()


def test_runner_on_the_cpu(tum, tmp_path, capsys):
    out = {k: str(tmp_path / f"{k}.txt") for k in ("traj", "kf")}
    viz = str(tmp_path / "map.png")
    system = run_tum_rgbd.main([
        tum["yaml"], tum["root"], tum["assoc"], "--groundtruth", tum["gt"], "--device", "cpu",
        "--max-frames", "4", "--out-trajectory", out["traj"], "--out-kf-trajectory", out["kf"],
        "--viz", viz])
    text = capsys.readouterr().out
    for line in ("sequence: 4 frames; starting SLAM", "frame 0/4 state=OK",
                 "median tracking time:", "mean tracking time:",
                 f"trajectories saved: {out['traj']}, {out['kf']}", "--- run stats ---",
                 "frames        4  (lost 0", "loops         0 closed",
                 f"map rendering saved: {viz}", "ATE RMSE:"):
        assert line in text, text
    assert float(text.split("ATE RMSE:")[1].split("m")[0]) < 0.01
    assert system.device.type == "cpu" and system.loop_closer is not None
    assert system.cfg.capacity.max_keyframes == 512
    with open(out["traj"]) as f:
        assert len(f.read().splitlines()) == 4
    t_kf, _, _ = read_tum_trajectory(out["kf"])
    assert len(t_kf) == system.run_stats()["keyframes_live"] >= 1
    assert os.path.getsize(viz) > 0


@pytest.mark.parametrize("extra", [["--pipelined"], ["--lag", "4"]])
def test_runner_refuses_what_is_not_ported(tum, extra, monkeypatch, capsys):
    """Everything is ported: both runners take ``--pipelined`` and
    ``--lag`` (default 16; tests/test_torch_pipeline.py and
    tests/test_torch_pipeline_stereo.py run them) and the multi-process
    join; with them, both refuse a coordinator given without the world
    size and rank, before they join or read a frame."""
    from ydorbslam_tpu_torch.apps import run_kitti_stereo

    want = ("--pipelined" in extra, 4 if "--lag" in extra else 16)
    tum_args = [tum["yaml"], tum["root"], tum["assoc"], "--device", "cpu", *extra]
    kitti_args = [tum["root"], "--device", "cpu", *extra]
    for parse, argv in ((run_tum_rgbd.parse_arguments, tum_args),
                        (run_kitti_stereo.parse_arguments, kitti_args)):
        args = parse(argv)
        assert (args.pipelined, args.lag) == want
    monkeypatch.setenv("YDORBSLAM_COORDINATOR", "localhost:1234")
    for parse, argv in ((run_tum_rgbd.parse_arguments, tum_args),
                        (run_kitti_stereo.parse_arguments, kitti_args)):
        with pytest.raises(SystemExit):
            parse(argv)
        assert "YDORBSLAM_COORDINATOR is set without" in capsys.readouterr().err


@pytest.mark.parametrize("env", [("YDORBSLAM_COORDINATOR", "localhost:1234"),
                                 ("YDORBSLAM_AUTO_DISTRIBUTED", "1")])
def test_runner_refuses_the_multi_host_join(tum, env, monkeypatch, capsys):
    """A join the environment asks for without saying how (a coordinator
    without world size and rank; the automatic join outside torchrun's
    environment) stops the runner before it tracks a frame.
    tests/test_torch_multihost.py runs the join itself."""
    for k in ("YDORBSLAM_NUM_PROCESSES", "YDORBSLAM_PROCESS_ID", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(*env)
    with pytest.raises(SystemExit):
        run_tum_rgbd.main([tum["yaml"], tum["root"], tum["assoc"], "--device", "cpu"])
    err = capsys.readouterr().err
    assert ("is set without YDORBSLAM_NUM_PROCESSES, YDORBSLAM_PROCESS_ID" in err
            if env[0] == "YDORBSLAM_COORDINATOR" else "needs torchrun's environment" in err), err


def test_runner_needs_a_card_by_default(tum):
    """``python -m ...run_tum_rgbd`` defaults to the card and fails
    without one; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "ydorbslam_tpu_torch.apps.run_tum_rgbd",
                          tum["yaml"], tum["root"], tum["assoc"]], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "sequence:" not in res.stdout
