#!/bin/sh
# The measurements that set a cell's bounds and limits, in one call on the
# card: two sets of three runs on the same three seeds, three traced runs on
# three more seeds, and the bfloat16 control on three more, each at the
# cell's own size. Run from the root of a checkout:
#
#     sh benchmark/tools/prove.sh <cell> <seconds> <out> <base-seed>
#
# Seeds are <base-seed> + 1..3 (both sets), + 11..13 (traced) and + 21..23
# (control). Summaries go to <out>/set1.jsonl, set2.jsonl, traced.jsonl and
# control.jsonl, each run's output beside them (tools/series.py).
set -u
cell=$1 seconds=$2 out=$3 base=$4
mkdir -p "$out"
runs() {   # runs <first offset> <trace>
    for k in 0 1 2; do printf '%s:%s:%s:%s ' "$cell" $((base + $1 + k)) "$seconds" "$2"; done
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"
python3 benchmark/tools/series.py --out "$out" --runs $(runs 1 0) > "$out/set1.jsonl"
python3 benchmark/tools/series.py --out "$out/set2" --runs $(runs 1 0) > "$out/set2.jsonl"
python3 benchmark/tools/series.py --out "$out" --runs $(runs 11 1) > "$out/traced.jsonl"
python3 benchmark/tools/control.py --workload "$cell" \
    --seeds $((base + 21)) $((base + 22)) $((base + 23)) > "$out/control.jsonl"
cat "$out/card.txt" "$out/set1.jsonl" "$out/set2.jsonl" "$out/traced.jsonl"
