"""The least-time counts on small shapes worked by hand."""
import pytest
import torch

from slambench import roofline
from slambench.reference.hamming import proj_gates


def test_k1_is_charged_by_bytes():
    # one 40x50 level, border 10: 2000 px, 8 bytes each; scored (40-20+2)*(50-20+2)
    # = 704 px at 16 ops, window 20*30 = 600 at 8 ops
    t, by = roofline.k1([(40, 50)], 10)
    assert by == "bytes" and t == pytest.approx(16000 / roofline.HBM_BYTES_S)
    ops = 704 * roofline.K1_OPS_SCORED + 600 * roofline.K1_OPS_WINDOW
    assert ops / roofline.LANE_OPS_S < t


def test_k2_charges_gated_pairs_only():
    # 1000 gated pairs: 8000 popcounts bind over 16,000 lane ops and 1 kB
    t, by = roofline.k2(600, 400, 1000, 1500)
    assert by == "operations"
    assert t == pytest.approx(max(8000 / roofline.POPC_S,
                                  (1000 * 15 + 1500) / roofline.LANE_OPS_S))
    assert roofline.k2(600, 400, 0, 0) == (1000 / roofline.HBM_BYTES_S, "bytes")


def test_k3_and_k4():
    assert roofline.k3(100, 20, 0)[0] == pytest.approx(120 / roofline.HBM_BYTES_S)
    assert roofline.k3(0, 0, 10)[0] == pytest.approx(80 / roofline.POPC_S)
    # O*P = 4*3 slots, 5 active, 3 points: 4 * (12*61 + 5*26 + 3*13) bytes
    assert roofline.k4(12, 5, 3) == (4 * (12 * 61 + 5 * 26 + 39) / roofline.HBM_BYTES_S, "bytes")


def test_proj_gates_count_by_hand():
    # attribute lanes: a = (u, v, ur, r_narrow, r_wide, oct_lo, oct_hi, valid),
    # b = (u, v, ur, octave, ..., valid) as ops/hamming.py packs them
    from slambench.reference import hamming as h

    a = torch.zeros(1, 8)
    a[0, [h.A_U, h.A_V, h.A_RN, h.A_RW, h.A_OLO, h.A_OHI, h.A_VALID]] = torch.tensor(
        [10.0, 10.0, 2.0, 5.0, 0.0, 7.0, 1.0])
    b = torch.zeros(3, 8)
    b[:, h.B_VALID] = 1.0
    b[:, h.B_U] = torch.tensor([11.0, 14.0, 30.0])
    b[:, h.B_V] = 10.0
    gn, gw = proj_gates(a, b)
    assert gn.tolist() == [[True, False, False]] and gw.tolist() == [[True, True, False]]
