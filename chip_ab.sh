#!/bin/bash
# Runs the kernel bench (chip_smoke.py) from two checkouts in turns on one
# card (A, B, B, A) and prints each run's kernel lines, tagged with the run.
#
#   bash chip_ab.sh DIR_A [DIR_B [LOG_DIR]]
#
# DIR_A is an unpacked checkout of the commit to compare with (for example
# `git archive <commit> | tar -x -C .chipcmd/parent`, in a directory that
# .gitignore lists); DIR_B defaults to this checkout.  Full logs go to
# LOG_DIR/ab_<n>_<A|B>.log (default: a new temporary directory).  Both
# checkouts must have this kernel bench (one that prints "[k1]", "[k2]" and
# "[k4]" lines); the paths' end-to-end times are portbench's (README).
# Exits 1 after the four runs if any run failed or printed no kernel line,
# so that a checkout without this bench does not read as an empty result.
set -u
A=$(cd "$1" && pwd)
B=$(cd "${2:-$(dirname "$0")}" && pwd)
OUT=${3:-$(mktemp -d)}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)
echo "logs in $OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=0
bad=0
for who in A B B A; do
  n=$((n + 1))
  if [ "$who" = A ]; then dir=$A; else dir=$B; fi
  log="$OUT/ab_${n}_${who}.log"
  (cd "$dir" && timeout 600 python3 chip_smoke.py > "$log" 2>&1)
  rc=$?
  echo "run $n $who ($dir) rc=$rc"
  if ! grep -qE "^\[k[124]\]" "$log"; then
    echo "run $n $who: no kernel line (not this bench, or it failed early); see $log" >&2
    bad=1
  fi
  [ "$rc" -eq 0 ] || bad=1
  grep -E "^\[k[124]\]" "$log" | sed -e "s/^/$n $who /"
done
exit $bad
