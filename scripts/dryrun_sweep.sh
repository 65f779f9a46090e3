#!/usr/bin/env bash
# Every cell of the port's dry run (python -m repro_torch.launch.dryrun), one
# process per cell, JOBS at a time, each cut after CELL_TIMEOUT seconds, then
# the roofline table of the records. Needs no GPU.
#
#   scripts/dryrun_sweep.sh [OUT_DIR] [MESH]     # defaults: experiments/dryrun_torch single
#   JOBS=7 CELL_TIMEOUT=600 scripts/dryrun_sweep.sh
#
# A cell cut by the timeout leaves no record; its log (OUT_DIR/<arch>__<shape>.log)
# ends with "timeout".
set -u
OUT=${1:-experiments/dryrun_torch}
MESH=${2:-single}
JOBS=${JOBS:-7}
CELL_TIMEOUT=${CELL_TIMEOUT:-600}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH="$ROOT/src${PYTHONPATH:+:$PYTHONPATH}" OMP_NUM_THREADS=1
mkdir -p "$OUT"
python3 -c "from repro_torch.launch.dryrun import all_cells
for a, s in all_cells(): print(a, s)" |
  xargs -P "$JOBS" -L 1 sh -c '
    out=$0 limit=$1 mesh=$2 arch=$3 shape=$4
    log="$out/${arch}__${shape}.log"
    timeout "$limit" python3 -m repro_torch.launch.dryrun --arch "$arch" --shape "$shape" \
      --mesh "$mesh" --out "$out" > "$log" 2>&1
    [ $? -eq 124 ] && echo "[dryrun] $arch x $shape x $mesh: timeout after ${limit}s" | tee -a "$log"
    grep "^\[dryrun\] .*: \(OK\|FAIL\)" "$log" | head -n 1
  ' "$OUT" "$CELL_TIMEOUT" "$MESH"
python3 -m repro_torch.roofline.analysis --dir "$OUT" --mesh "$MESH"
