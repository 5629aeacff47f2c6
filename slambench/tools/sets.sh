#!/bin/sh
# The measurements behind a cell's bounds: two sets of runs over the same
# seeds, each run a process of its own as the check makes them, then
# traced runs on other seeds.  Output under chiprun_out/sets_<cell>/.
# Usage: sh slambench/tools/sets.sh CELL SECONDS "SEEDS" "TRACE_SEEDS"
set -u
cell=$1; secs=$2; seeds=$3; tseeds=$4
out=chiprun_out/sets_$cell
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
for set in 1 2; do
  for s in $seeds; do
    python3 slambench/run.py --workload "$cell" --seed "$s" --seconds "$secs" --trace 0 \
      > "$out/run_${set}_$s.out" 2> "$out/run_${set}_$s.err"
    echo "set $set seed $s rc $? $(tail -n 1 "$out/run_${set}_$s.out" | cut -c 1-260)"
  done
done
for s in $tseeds; do
  python3 slambench/run.py --workload "$cell" --seed "$s" --seconds "$secs" --trace 1 \
    > "$out/trace_$s.out" 2> "$out/trace_$s.err"
  echo "trace seed $s rc $? $(tail -n 1 "$out/trace_$s.out" | cut -c 1-400)"
done
