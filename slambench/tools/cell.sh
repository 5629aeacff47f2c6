#!/bin/sh
# Everything a cell's entry in BENCHMARK.json rests on, in one call on the
# card: the limit readings (readings.py: sound seeds and the control, one
# process), then the two sets and the traced runs of sets.sh.
# Usage: sh slambench/tools/cell.sh CELL SECONDS READING_SEED "SEEDS" "TRACE_SEEDS"
set -u
python3 slambench/tools/readings.py --workload "$1" --seconds 15 --first-seed "$3" \
  > "chiprun_out/readings_$1.out" 2> "chiprun_out/readings_$1.err"
echo "readings rc $?"; grep summary "chiprun_out/readings_$1.out"
sh slambench/tools/sets.sh "$1" "$2" "$4" "$5"
