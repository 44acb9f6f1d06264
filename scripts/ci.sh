#!/usr/bin/env bash
# CI gate (reference: /root/reference/.github/workflows/main.yml — 3 jobs:
# normal, leak-mode, second PHP version). The analogue here, runnable on any
# CPU host (and mirrored by .github/workflows/ci.yml):
#
#   1. full test suite on the 8-device virtual CPU mesh WITH the leak gate
#      (NPTPU_LEAK_GATE=1: after the suite + forced GC, every registered
#      NDArray buffer must have been unregistered — conftest.pytest_sessionfinish)
#   2. bench.py --quick smoke (CPU): must print the one-line JSON metric
#
# The compiled kernels run only on a GPU: `python chip_smoke.py` there.
# Exit nonzero on any failure.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== job 1: test suite (8-device virtual mesh) + leak gate =="
NPTPU_LEAK_GATE=1 JAX_PLATFORMS=cpu python -m pytest tests/ -q

echo "== job 2: bench smoke (CPU) =="
out=$(JAX_PLATFORMS=cpu python bench.py --quick 2>/dev/null | tail -1)
echo "$out"
python - "$out" <<'PY'
import json, sys
d = json.loads(sys.argv[1])
assert d["metric"] and d["value"] > 0 and d["unit"], d
print("bench smoke OK")
PY

echo "CI gate passed."
