"""The split-and-merge of the best/second kernels K2 and K3, on the CPU.

``csrc/proj_best2.cu`` and ``csrc/pair_best2.cu`` split the b-columns of
an a-row over the 32 lanes of a warp: each lane scans its own columns in
ascending order with the TPU kernels' sequential rule, and the lanes'
(best, second, idx) states are merged with the rule of ``csrc/best2.cuh``.
This file mirrors that in plain PyTorch, for S groups of columns split
lane-strided (column n in group n % S) or in contiguous runs, with the
merge applied as a tree, and holds the result exactly against
``proj_best2_plain`` (both ``check_ur``) and ``pair_best2_plain`` (both
modes) on the generated problems of ``ydorbslam_tpu_torch/testing.py``:
random, tie-heavy (descriptors from a pool of 4 behind wide gates), none
and exactly one column passing, and ragged shapes.  The kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.  Last, the kernels' wrappers refuse bad inputs before
they reach the card, and the kernel library's build key covers the
header the merge lives in.
"""
import functools

import numpy as np
import pytest
import torch

from ydorbslam_tpu_torch import _build
from ydorbslam_tpu_torch.ops import kernels
from ydorbslam_tpu_torch.ops.hamming import (
    INVALID_DIST, distance_matrix, pair_best2_plain, pair_gates, proj_best2_plain, proj_gates,
)
from ydorbslam_tpu_torch.testing import pair_problem, proj_problem

B_PAIRS = 3
PROBLEMS = [("random", 64, 200), ("ties", 64, 200), ("none", 40, 100), ("one", 40, 100),
            ("random", 1, 777), ("random", 31, 33), ("random", 33, 31), ("random", 777, 1)]
SPLITS = [(1, "strided"), (2, "strided"), (2, "runs"), (7, "strided"), (7, "runs"),
          (32, "strided"), (32, "runs")]
SEARCHES = ["proj", "proj_check_ur", "pair_proj", "pair_epi"]


def _groups(n: int, s: int, split: str) -> torch.Tensor:
    """(s, L) column indices of each group in ascending order, -1 padded."""
    if split == "strided":
        cols = [list(range(g, n, s)) for g in range(s)]
    else:
        run = -(-n // s)
        cols = [list(range(g * run, min(n, (g + 1) * run))) for g in range(s)]
    width = max(1, max(len(c) for c in cols))
    return torch.tensor([c + [-1] * (width - len(c)) for c in cols])


def _scan(dg: torch.Tensor, cols: torch.Tensor):
    """The sequential rule of each group over its columns, as each lane
    runs it: (best, second, idx), each (R, S)."""
    R, S = dg.shape[0], cols.shape[0]
    best = torch.full((R, S), INVALID_DIST, dtype=torch.int64)
    second = best.clone()
    idx = torch.full((R, S), -1, dtype=torch.int64)
    for step in range(cols.shape[1]):
        col = cols[:, step]
        d = torch.where(col >= 0, dg[:, col.clamp(min=0)], INVALID_DIST)
        lower = d < best
        second = torch.where(lower, best, torch.minimum(second, d))
        idx = torch.where(lower, col.expand(R, S), idx)
        best = torch.where(lower, d, best)
    return best, second, idx


def _merge(a, b):
    """best2.cuh's merge of the states of two disjoint column sets."""
    a_first = (a[0] < b[0]) | ((a[0] == b[0]) & (a[2] < b[2]))
    return (torch.where(a_first, a[0], b[0]),
            torch.where(a_first, torch.minimum(a[1], b[0]), torch.minimum(b[1], a[0])),
            torch.where(a_first, a[2], b[2]))


def split_merge_best2(dg: torch.Tensor, s: int, split: str):
    """(idx, best, second) of each row of the gated distances ``dg``
    (R, N), INVALID_DIST where the gate fails, by the kernels' split and
    a tree of merges."""
    best, second, idx = _scan(dg.to(torch.int64), _groups(dg.shape[1], s, split))
    states = [(best[:, g], second[:, g], idx[:, g]) for g in range(s)]
    while len(states) > 1:
        pairs = [_merge(states[i], states[i + 1]) for i in range(0, len(states) - 1, 2)]
        states = pairs + states[len(pairs) * 2:]
    best, second, idx = states[0]
    return idx, best, second


@functools.lru_cache(maxsize=None)
def _case(search: str, kind: str, M: int, N: int):
    """The gated distance rows of one search on one problem and the plain
    version's (idx, best, second) of each of them."""
    rng = np.random.default_rng([M, N, PROBLEMS.index((kind, M, N)), SEARCHES.index(search)])
    if search.startswith("proj"):
        prob = tuple(torch.from_numpy(x) for x in proj_problem(rng, M, N, kind))
        check_ur = search == "proj_check_ur"
        d = distance_matrix(prob[0], prob[2])
        rows = [torch.where(g, d, INVALID_DIST) for g in proj_gates(prob[1], prob[3], check_ur)]
        return list(zip(rows, proj_best2_plain(*prob, check_ur=check_ur)))
    mode = search[len("pair_"):]
    prob = tuple(torch.from_numpy(x) for x in pair_problem(rng, B_PAIRS, M, N, mode, kind))
    d = torch.stack([distance_matrix(prob[0][p], prob[2][p]) for p in range(B_PAIRS)])
    dg = torch.where(pair_gates(prob[1], prob[3], mode), d, INVALID_DIST)
    ref = pair_best2_plain(*prob, mode=mode)
    return [(dg.reshape(B_PAIRS * M, N), tuple(r.reshape(-1) for r in ref))]


@pytest.mark.parametrize("s,split", SPLITS)
@pytest.mark.parametrize("kind,M,N", PROBLEMS)
@pytest.mark.parametrize("search", SEARCHES)
def test_split_merge_equals_plain(search, kind, M, N, s, split):
    for dg, ref in _case(search, kind, M, N):
        got = split_merge_best2(dg, s, split)
        for g, r in zip(got, ref):
            assert torch.equal(g, r.to(torch.int64))


def test_problems_cover_ties_and_edges():
    """The generated problems are what they claim: most gated columns
    tie in "ties", nothing passes in "none", one column per valid row in
    "one" (both K2 radii and both K3 modes)."""
    for search in SEARCHES:
        by_kind = {kind: _case(search, kind, M, N) for kind, M, N in PROBLEMS[:4]}
        for dg, (idx, best, second) in by_kind["ties"]:
            hit = idx >= 0
            assert hit.float().mean() > 0.5 and (second[hit] == best[hit]).float().mean() > 0.5
        for dg, (idx, _, _) in by_kind["none"]:
            assert (dg == INVALID_DIST).all() and (idx == -1).all()
        for dg, (idx, _, second) in by_kind["one"]:
            passes = (dg < INVALID_DIST).sum(1)
            assert passes.max() == 1 and passes.sum() > 0
            assert (second == INVALID_DIST).all() and ((idx >= 0) == (passes == 1)).all()


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """An edit of a ``csrc/*.cuh`` header gives a new library path, so the
    kernels are rebuilt instead of a stale library being loaded."""
    (tmp_path / "k.cu").write_text('#include "best2.cuh"\n')
    header = tmp_path / "best2.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert _build.library_path() == first
    header.write_text("// v2\n")
    assert _build.library_path() != first


def _wrapper_inputs(kernel: str, bad: str):
    """K2 or K3 inputs on the CPU, with one fault."""
    lead = () if kernel == "proj" else (2,)
    t = [torch.zeros(lead + (5, 8), dtype=torch.int32), torch.zeros(lead + (5, 8)),
         torch.zeros(lead + (4, 8), dtype=torch.int32), torch.zeros(lead + (4, 8))]
    if bad == "dtype":
        t[1] = t[1].double()
    elif bad == "shape":
        t[3] = torch.zeros(lead + (4, 7))
    elif bad == "strided":
        t[2] = torch.zeros(lead + (8, 4), dtype=torch.int32).transpose(-1, -2)
    return t


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "none"])
@pytest.mark.parametrize("kernel", ["proj", "pair"])
def test_wrappers_refuse_bad_inputs(kernel, bad):
    """The K2 and K3 wrappers refuse CPU tensors, also with a wrong
    dtype, shape or layout, with an error that names the kernel, and
    neither launch nor count a launch."""
    before = kernels.launch_counts()
    fn = kernels.proj_best2_cuda if kernel == "proj" else kernels.pair_best2_cuda
    with pytest.raises(ValueError, match=f"^{kernel}_best2"):
        fn(*_wrapper_inputs(kernel, bad))
    assert kernels.launch_counts() == before
