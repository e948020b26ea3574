#!/bin/bash
# Compare two trees of this repo on one card: chip_smoke.py of parent,
# change, change, parent, one after another in one process group, so that
# all four runs share the card's state and power limit.
#
#   ab_chip_smoke.sh PARENT_DIR CHANGE_DIR [OUT_DIR]
#
# Both directories hold a checkout (for example `git archive <commit> | tar
# -x -C _scratch/parent`). Each run's whole output goes to
# OUT_DIR/ab_<i>_<side>.log (default _scratch/ab_logs/, git-ignored); its `time`, end-to-end
# and last two lines are printed, then the card tests of the change run.
# The card's name and power limit are the second-to-last line of each run.
set -u
root=$(pwd)
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
out=${3:-$root/_scratch/ab_logs}
mkdir -p "$out"
out=$(cd "$out" && pwd)
i=0
for side in parent change change parent; do
  i=$((i + 1))
  if [ "$side" = parent ]; then cd "$parent"; else cd "$change"; fi
  log=$out/ab_${i}_${side}.log
  python3 chip_smoke.py > "$log" 2>&1
  echo "run $i $side rc=$?"
  grep -E "^time |^train:|^end to end:|^classifier:" "$log"
  tail -n 2 "$log" | cut -c1-200
done
cd "$change"
python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
  tests/test_torch_cuda.py -q 2>&1 | tail -n 5
