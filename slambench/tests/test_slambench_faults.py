"""The rest of a run, driven here on the CPU at a small size with the
card's check skipped: sound, it comes out correct; with the timed path
broken underneath, ``correct`` comes out false, for each fault a cell
can have (one card: no exchange between chips to leave out).  The
benchmark's sync cell is driven, and the pipelined mix that stays under
``traffic/`` for a later cell."""

import pytest
import torch

from slambench import capture, harness

CONFIG = "kitti00_stereo"
MIXES = ("pipelined", "sync")


def _spec(traffic):
    """The cell of ``CONFIG`` under ``traffic``, found by the files' names
    (a mix under ``traffic/`` may have no cell), at small capacities."""
    cfg = harness.load_json(harness.HERE / "configs" / f"{CONFIG}.json")
    mix = harness.load_json(harness.HERE / "traffic" / f"{traffic}.json")
    cell = {"name": f"{CONFIG}.{traffic}", "config": CONFIG, "traffic": traffic, "chips": 1}
    cfg["capacity"] = {"max_keyframes": 48, "max_map_points": 8192, "max_obs_per_point": 16,
                       "local_ba_max_points": 1024, "tracking_points": 2048}
    return cell, cfg, dict(mix, warm_frames=4), []


def _pose_fault(kind):
    from ydorbslam_tpu_torch.optim import pose

    orig = pose.optimize_pose

    def broken(cam, T_init, obs, *a, **kw):
        if kind == "unchanged":  # the step returns its state unchanged
            return T_init, obs.valid, torch.sum(obs.valid)
        half = torch.arange(obs.valid.shape[0], device=obs.valid.device) % 2 == 0
        return orig(cam, T_init, obs._replace(valid=obs.valid & half), *a, **kw)
    return broken


def _ba_fault(orig):
    def broken(cam, prob, *a, **kw):  # the BA returns its state unchanged
        out = orig(cam, prob, *a, **kw)
        return (prob.T_cw, prob.p_w) + tuple(out[2:])
    return broken


def _altered_extraction(orig):
    def broken(*a, **kw):  # an answer altered where it is produced
        f, pyr = orig(*a, **kw)
        return f._replace(desc=f.desc ^ 1), pyr
    return broken


# Fault -> (the number it has to fail, the window's frames: 28 hold local
# BAs, 6 the extraction and pose samples).
FAULTS = {
    "sound": (None, 28),
    "state_unchanged": ("pose_gap_m", 6),
    "half_batch_left_out": ("pose_gap_m", 6),
    "answer_altered": ("extract_mismatch", 6),
    "ba_state_unchanged": ("ba_unmoved", 28),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("traffic", MIXES)
def test_fault_makes_the_run_incorrect(traffic, fault, monkeypatch):
    from ydorbslam_tpu_torch.optim import schur
    from ydorbslam_tpu_torch.slam import pipeline, system, tracking

    torch.set_num_threads(2)
    if fault in ("state_unchanged", "half_batch_left_out"):
        b = _pose_fault("unchanged" if fault == "state_unchanged" else "half")
        for mod in (tracking, system, pipeline):
            monkeypatch.setattr(mod, "optimize_pose", b)
    elif fault == "answer_altered":
        for mod in (tracking, pipeline):
            monkeypatch.setattr(mod, "_extract_orb_pyramid",
                                _altered_extraction(mod._extract_orb_pyramid))
    elif fault == "ba_state_unchanged":
        monkeypatch.setattr(schur, "lm_solve", _ba_fault(schur.lm_solve))
    number, frames = FAULTS[fault]
    # The kept frames are drawn from the window's first four.
    monkeypatch.setattr(capture, "FRAME_SPAN", 4)
    r = harness.run_cell(f"{CONFIG}.{traffic}", 3000000019, 0.0, False, device="cpu",
                         spec=_spec(traffic), window_frames=frames)
    if number is None:
        failing = [k for k, c in r["checks"].items()
                   if c["value"] is not None and not c["value"] <= c["limit"]]
        assert r["correct"], failing
    else:
        c = r["checks"][number]
        assert not r["correct"] and c["value"] > c["limit"], r["checks"]


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    """The control (the program with TF32 matmuls) at the cell's own size."""
    r = harness.run_cell(f"{CONFIG}.sync", 3000000019, 10.0, False, tf32=True)
    assert not r["correct"], r["checks"]
