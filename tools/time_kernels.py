#!/usr/bin/env python3
"""Time the port's hand-written kernels K1-K4 of any checkout.

    python3 tools/time_kernels.py [--root DIR] [--label TEXT]

Run on a CUDA machine.  Imports ``ydorbslam_tpu_torch`` from DIR (by
default this checkout), builds its kernels and times its wrappers at the
main path's shapes:

  * K1 per frame on the 8 pyramid levels of ``bench.make_frames()``
    frame 0 (this checkout's ``bench.py``, loaded by path): one
    ``fast_score_nms_levels_cuda`` launch where DIR has it, else
    ``fast_score_nms_cuda`` once per level (the per-level API of the
    checkouts before it);
  * K2 at 1024 x 1024 with ``check_ur`` (the motion search) and at
    8192 x 1024 without (the local-map search);
  * K3 in mode "proj" at B = 20 and in mode "epi" at B = 10, both
    M = N = 1024 (fusion and triangulation);
  * K4 on a seeded random (32, 16, 4096) input (local BA's shape).

The K2, K3 and K4 inputs come from this checkout's
``ydorbslam_tpu_torch/testing.py`` (``proj_problem``, ``pair_problem``,
"random", and ``lm_obs_problem``), loaded by path, with fixed seeds, so
two checkouts timed one after the other see the same inputs; the
wrappers of both keep the same signature.  Each gets ``device_ms`` (the
card's own time per call, back to back) and ``wall_ms`` (CUDA events
around 20 back-to-back calls, the host's dispatch included, as
``chip_smoke.py`` times them), and a digest of its outputs (sha256 of
the returned tensors, -0.0 read as 0.0) that shows whether two checkouts
compute the same bits.  Prints one JSON line, then the card's
name and power limit.  To compare a commit with its parent, unpack the
parent with ``git archive`` into a git-ignored directory and run parent,
change, change, parent.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*path):
    """A module of this checkout, loaded by path (not from DIR)."""
    spec = importlib.util.spec_from_file_location(
        "_time_kernels_" + path[-1][:-3], os.path.join(*path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(result) -> str:
    """A hash of every tensor a call returned, in order, with -0.0 read
    as 0.0, so two checkouts' outputs can be compared bit for bit."""
    import torch

    h = hashlib.sha256()
    stack = [result]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            x = x + 0.0 if x.is_floating_point() else x
            h.update(x.contiguous().cpu().numpy().tobytes())
        else:
            stack[:0] = list(x)
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose kernels are timed")
    ap.add_argument("--label", default="", help="text copied into the JSON line")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # its ydorbslam_tpu_torch, before this checkout's
    tm = _load(HERE, "ydorbslam_tpu_torch", "testing.py")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tools/time_kernels.py runs on a GPU")
    import ydorbslam_tpu_torch
    from ydorbslam_tpu_torch import _build
    from ydorbslam_tpu_torch.ops import kernels

    if not os.path.abspath(ydorbslam_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ydorbslam_tpu_torch.__file__}, not from {root}")
    info = _build.build()
    dev = torch.device("cuda")
    calls = {}
    cwd = os.getcwd()
    os.chdir(HERE)  # bench.make_frames reads tests/ relative to the root
    try:
        gray = _load(HERE, "bench.py").make_frames(1)[0][1]
    finally:
        os.chdir(cwd)
    from ydorbslam_tpu_torch.ops.extractor import DETECT_BORDER
    from ydorbslam_tpu_torch.ops.pyramid import build_pyramid

    levels = build_pyramid(torch.as_tensor(gray).to(dev).float())
    if hasattr(kernels, "fast_score_nms_levels_cuda"):
        calls["K1 frame 0, 8 levels"] = (
            lambda: kernels.fast_score_nms_levels_cuda(levels, DETECT_BORDER))
    else:
        calls["K1 frame 0, 8 levels"] = (
            lambda: [kernels.fast_score_nms_cuda(lv, DETECT_BORDER) for lv in levels])
    for seed, M, N, ur in ((1, 1024, 1024, True), (2, 8192, 1024, False)):
        prob = tm.on_device(dev, tm.proj_problem(np.random.default_rng(seed), M, N))
        calls[f"K2 {M}x{N} check_ur={ur}"] = (
            lambda prob=prob, ur=ur: kernels.proj_best2_cuda(*prob, check_ur=ur))
    for seed, mode, B in ((3, "proj", 20), (4, "epi", 10)):
        prob = tm.on_device(dev, tm.pair_problem(np.random.default_rng(seed), B, 1024, 1024, mode))
        calls[f"K3 {mode} B={B}"] = (
            lambda prob=prob, mode=mode: kernels.pair_best2_cuda(*prob, mode=mode))
    k4 = torch.as_tensor(tm.lm_obs_problem(np.random.default_rng(5), 16, 4096)).to(dev)
    calls["K4 (32, 16, 4096)"] = lambda: kernels.lm_obs_cuda(k4)
    times = {label: {"device_ms": tm.device_ms(fn), "wall_ms": tm.wall_ms(fn),
                     "digest": _digest(fn())}
             for label, fn in calls.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "root": root, "build_s": info["seconds"],
                      "times": times}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
