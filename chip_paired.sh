#!/bin/bash
# Times a change against its parent on one GPU: each fused CUDA source's
# nvcc seconds for both (build_times.py), then chip_smoke.py in the order
# parent, change, change, parent. Run from the change's checkout, with the
# parent's unpacked in PARENT_DIR (e.g. `git archive <parent> | tar -x -C
# _checkout/parent`, a directory .gitignore lists):
#
#     bash chip_paired.sh PARENT_DIR OUT_DIR [--phases a,b,...]
#
# Arguments after OUT_DIR go to all four chip_smoke.py runs (a smoke that
# predates --phases ignores them and runs every phase). Writes
# OUT_DIR/bt_{parent,change}.json and OUT_DIR/smoke_{p1,c1,c2,p2}.{jsonl,err};
# prints each run's exit code and wall seconds.
set -u
parent=${1:?usage: bash chip_paired.sh PARENT_DIR OUT_DIR}
mkdir -p "${2:?usage: bash chip_paired.sh PARENT_DIR OUT_DIR}"
out=$(cd "$2" && pwd)
shift 2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 build_times.py "$parent/pystella_tpu_torch/ops/csrc" \
  > "$out/bt_parent.json" 2> "$out/bt_parent.err"
python3 build_times.py > "$out/bt_change.json" 2> "$out/bt_change.err"
for run in p1 c1 c2 p2; do
  if [ "${run:0:1}" = p ]; then dir=$parent; else dir=.; fi
  t0=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py "$@" > "$out/smoke_$run.jsonl" \
    2> "$out/smoke_$run.err")
  echo "$run rc=$? seconds=$(( $(date +%s) - t0 ))"
done
