#!/usr/bin/env bash
# Show that chip_smoke's ddp phase catches a loss normaliser that stays
# rank-local.  It runs the phase (`chip_smoke.run_ddp`) in two temporary
# copies of this tree whose `parallel/dist.py::global_count` is changed,
# and prints what the phase reports for each:
#   A: the count is not all-reduced (each rank divides by its own count);
#   B: the rank's count times the world size (each rank's count stands
#      for the ranks' mean, as an average of per-rank means has it).
# Each copy must fail the compared step's limits (`DDP_LIMITS`); the
# exit code is 0 only if both do.  The tree itself is not changed.
#
#   tools/torch_ddp_normaliser_check.sh [cuda|cpu]
#
# cuda (default): the full flagship at 1024^2, two ranks on the one card;
# cpu: the small flagship at 256^2 over gloo on the CPU.  PYTHON is the
# interpreter.
set -u
DEVICE=${1:-cuda}
PY=${PYTHON:-python3}
ROOT=$(cd "$(dirname "$0")/.." && pwd)
status=0
for m in A B; do
  D=$(mktemp -d)
  # what the phase runs, and the kernels' builds where there are any
  (cd "$ROOT" && cp -r chip_smoke.py aidet_tpu_torch configs tools "$D" &&
    if [ -d build ]; then cp -r build "$D"; fi)
  case $m in
    A) new='    pass' ;;
    B) new='    t = t * _LOSS_WORLD' ;;
  esac
  sed -i "s/^    dist.all_reduce(t)\$/$new/" "$D/aidet_tpu_torch/parallel/dist.py"
  if ! grep -qxF "$new" "$D/aidet_tpu_torch/parallel/dist.py"; then
    echo "copy $m: global_count's all-reduce not found"
    status=1
  else
    (cd "$D" && "$PY" - "$DEVICE" "$m" <<'PYEOF'
import sys
import chip_smoke
device, m = sys.argv[1:3]
if device != "cpu":
    chip_smoke.run_build()
try:
    out = chip_smoke.run_ddp(device=device, small=device == "cpu")
except AssertionError as e:
    msg = str(e)
    caught = msg.startswith("ddp: the 2-rank step against one process's")
    print(f"copy {m}: the phase {'failed' if caught else 'FAILED ELSEWHERE'}"
          f": {msg[:3000]}", flush=True)
    sys.exit(0 if caught else 1)
print(f"copy {m}: the phase PASSED: {out['against_one_process']}",
      flush=True)
sys.exit(1)
PYEOF
    ) || status=1
  fi
  rm -rf "$D"
done
exit $status
