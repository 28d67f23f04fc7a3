#!/usr/bin/env bash
# Runs a parent commit's chip_smoke.py and this tree's in turns — parent,
# change, change, parent — on one card, so that a drift of order, clocks or
# host load weighs on both trees alike.
#
#   git archive <parent> | tar -x -C build/parent     # build/ is ignored
#   scripts/chip_turns.sh build/parent [PHASES]
#
# PHASES defaults to device,build,kernels.  Each turn's output goes to
# chiprun_out/turn_<n>_<tree>.txt; each tree builds its kernels into its
# own build/ once, so only its first turn pays for nvcc.  Prints one line
# per turn with its exit code, then every kernels-phase case as
# "turn kernel case ms graph_ms [parts]", and fails if a turn failed.
set -u
parent=$(cd "$1" && pwd)
phases=${2:-device,build,kernels}
root=$(cd "$(dirname "$0")/.." && pwd)
out=$root/chiprun_out
mkdir -p "$out"
rc_all=0
for turn in 1_parent 2_change 3_change 4_parent; do
    tree=$root
    [[ $turn == *parent ]] && tree=$parent
    (cd "$tree" && python3 chip_smoke.py --phases "$phases") \
        > "$out/turn_${turn}.txt" 2>&1
    rc=$?
    echo "turn $turn rc $rc"
    [[ $rc == 0 ]] || rc_all=1
done
python3 - "$out" <<'PY'
import json, pathlib, sys
for f in sorted(pathlib.Path(sys.argv[1]).glob("turn_*.txt")):
    for line in f.read_text().splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") == "kernels":
            parts = {k: (v["ms"], v["graph_ms"])
                     for k, v in rec.get("parts", {}).items()}
            print(f.stem[5:], rec["kernel"], "|", rec["case"], "|",
                  rec.get("ms"), rec.get("graph_ms"), *(
                      [parts] if parts else []))
PY
exit $rc_all
