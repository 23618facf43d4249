#!/bin/bash
# Run chip_smoke.py of several checkouts one after the other on the same card,
# so their times compare within one allocation. Each output line is stamped
# with the host seconds since that run began.
#
#   scripts/chip_smoke_compare.sh OUT_DIR CHECKOUT [CHECKOUT ...]
#
# Writes OUT_DIR/<name>.log (stamped standard output) and OUT_DIR/<name>.err
# for each checkout, <name> being its directory's base name, and prints each
# run's exit code and seconds, its per-phase lines and its last two lines.
# Exits 1 if any run did.
set -u
out=$(realpath -m "$1")
shift
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
for dir in "$@"; do
  name=$(basename "$dir")
  start=$(date +%s)
  (cd "$dir" && python3 -u chip_smoke.py) 2> "$out/$name.err" | python3 -u -c '
import sys, time
t = time.time()
for line in sys.stdin:
    sys.stdout.write(f"{time.time() - t:8.1f} {line}")' > "$out/$name.log"
  rc=${PIPESTATUS[0]}
  [ "$rc" = 0 ] || status=1
  echo "$name rc=$rc seconds=$(( $(date +%s) - start ))"
  grep -a "phase seconds\|took\|in all\|checks\? failed" "$out/$name.log" | cut -c1-240
  tail -n 2 "$out/$name.log" | cut -c1-200
done
exit $status
