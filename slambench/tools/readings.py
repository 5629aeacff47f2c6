"""Read the two ends of each correctness limit on the card: the numbers
that sound runs of the program give on many seeds, and those the control
gives (the program with TF32 matmuls, the precision below the float32
the configurations state), all in one process so that set-up is paid
once per cell.

    python3 slambench/tools/readings.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--seconds 30] [--first-seed N]

Prints one JSON line per run and a summary per number: the largest sound
reading and the smallest control reading.  Also writes the lines to
chiprun_out/readings_<cell>.jsonl.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))

from slambench.harness import run_cell  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    args = ap.parse_args()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for w in args.workload:
        rows = []
        runs = [(args.first_seed + 7919 * i, False) for i in range(args.seeds)]
        runs += [(args.first_seed + 104729 * (i + 1), True) for i in range(args.control_seeds)]
        with open(out_dir / f"readings_{w}.jsonl", "w") as f:
            for seed, tf32 in runs:
                r = run_cell(w, seed, args.seconds, False, tf32=tf32)
                row = dict(workload=w, seed=seed, tf32=tf32, attempted=r["attempted"],
                           failed=r["failed"],
                           frames_per_s=r["metrics"]["frames_per_s"]["value"],
                           **{k: v["value"] for k, v in r["checks"].items()},
                           **r["diagnostics"])
                rows.append(row)
                line = json.dumps(row)
                print(line, flush=True)
                f.write(line + "\n")
        names = sorted({k for r in rows for k in r} - {"workload", "seed", "tf32", "attempted"})
        summary = {}
        for n in names:
            sound = [r[n] for r in rows if not r["tf32"] and r.get(n) is not None]
            ctrl = [r[n] for r in rows if r["tf32"] and r.get(n) is not None]
            summary[n] = dict(sound_max=max(sound, default=None),
                              sound_min=min(sound, default=None),
                              control_min=min(ctrl, default=None),
                              control_max=max(ctrl, default=None))
        print(json.dumps({"summary": w, **summary}), flush=True)


if __name__ == "__main__":
    main()
