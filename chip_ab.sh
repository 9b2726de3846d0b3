#!/bin/bash
# Runs chip_smoke.py from two checkouts in turns on one card (A, B, B, A)
# and prints each run's end-to-end and kernel lines, tagged with the run.
#
#   bash chip_ab.sh DIR_A [DIR_B [LOG_DIR]]
#
# DIR_A is an unpacked checkout of the commit to compare with (for example
# `git archive <commit> | tar -x -C .chipcmd/parent`, in a directory that
# .gitignore lists); DIR_B defaults to this checkout.  Full logs go to
# LOG_DIR/ab_<n>_<A|B>.log (default .chip_smoke/ab under the current
# directory).
set -u
A=$(cd "$1" && pwd)
B=$(cd "${2:-$(dirname "$0")}" && pwd)
mkdir -p "${3:-.chip_smoke/ab}"
OUT=$(cd "${3:-.chip_smoke/ab}" && pwd)
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=0
for who in A B B A; do
  n=$((n + 1))
  if [ "$who" = A ]; then dir=$A; else dir=$B; fi
  log="$OUT/ab_${n}_${who}.log"
  (cd "$dir" && timeout 400 python3 chip_smoke.py > "$log" 2>&1)
  echo "run $n $who ($dir) rc=$?"
  grep -E "\[main\] (detections|warm)|\[train\] (22 steps|max_mem)|\[profile(-train)?\] one|\[timing\] (box|mask|plane|training)" \
    "$log" | sed -e "s/^/$n $who /"
done
