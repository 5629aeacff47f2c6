#!/usr/bin/env python3
"""Time the port's two best/second kernels, K2 and K3, of any checkout.

    python3 tools/time_best2.py [--root DIR] [--label TEXT]

Run on a CUDA machine.  Imports ``ydorbslam_tpu_torch`` from DIR (by
default this checkout), builds its kernels and times its wrappers
``proj_best2_cuda`` and ``pair_best2_cuda`` at the main path's shapes:

  * K2 at 1024 x 1024 with ``check_ur`` (the motion search) and at
    8192 x 1024 without (the local-map search);
  * K3 in mode "proj" at B = 20 and in mode "epi" at B = 10, both
    M = N = 1024 (fusion and triangulation).

The problems come from this checkout's ``ydorbslam_tpu_torch/testing.py``
(``proj_problem``, ``pair_problem``, "random"), loaded by path, with
fixed seeds, so two checkouts timed one after the other see the same
inputs; the wrappers of both keep the same signature.  Each shape gets
``device_ms`` (the card's own time per call, back to back) and
``wall_ms`` (CUDA events around 20 back-to-back calls, the host's
dispatch included, as ``chip_smoke.py`` times them).  Prints one JSON
line, then the card's name and power limit.  To compare a commit with
its parent, unpack the parent with ``git archive`` into a git-ignored
directory and run parent, change, change, parent.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose kernels are timed")
    ap.add_argument("--label", default="", help="text copied into the JSON line")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # its ydorbslam_tpu_torch, before this checkout's
    spec = importlib.util.spec_from_file_location(
        "_best2_testing", os.path.join(HERE, "ydorbslam_tpu_torch", "testing.py"))
    tm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tm)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tools/time_best2.py runs on a GPU")
    import ydorbslam_tpu_torch
    from ydorbslam_tpu_torch import _build
    from ydorbslam_tpu_torch.ops import kernels

    if not os.path.abspath(ydorbslam_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ydorbslam_tpu_torch.__file__}, not from {root}")
    info = _build.build()
    dev = torch.device("cuda")
    calls = {}
    for seed, M, N, ur in ((1, 1024, 1024, True), (2, 8192, 1024, False)):
        prob = tm.on_device(dev, tm.proj_problem(np.random.default_rng(seed), M, N))
        calls[f"K2 {M}x{N} check_ur={ur}"] = (
            lambda prob=prob, ur=ur: kernels.proj_best2_cuda(*prob, check_ur=ur))
    for seed, mode, B in ((3, "proj", 20), (4, "epi", 10)):
        prob = tm.on_device(dev, tm.pair_problem(np.random.default_rng(seed), B, 1024, 1024, mode))
        calls[f"K3 {mode} B={B}"] = (
            lambda prob=prob, mode=mode: kernels.pair_best2_cuda(*prob, mode=mode))
    times = {label: {"device_ms": tm.device_ms(fn), "wall_ms": tm.wall_ms(fn)}
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
