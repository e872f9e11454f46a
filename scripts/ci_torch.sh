#!/usr/bin/env bash
# Verification of the PyTorch/CUDA port (src/repro_torch): its static
# analysis, the quickstart twin, the port's tests and the launcher's
# observability exports.  On a host with a CUDA card every stage runs the
# kernels; without one the analysis skips its kernel check and every
# stage runs the kernels' plain versions on the CPU.
# Usage: scripts/ci_torch.sh [extra pytest args]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

if python -c 'import sys, torch; sys.exit(not torch.cuda.is_available())'; then
  DEVICE=(--device cuda)
  ANALYSIS=()
else
  DEVICE=(--device cpu)
  ANALYSIS=(--no-kernel-check)
fi

# --- static analysis: lint vs baseline, the launch-contract check against
# live kernel launches (card only), the retrace guard on warmed engines -----
echo "== static analysis (${DEVICE[*]} ${ANALYSIS[*]:-}) =="
python -m repro_torch.analysis "${DEVICE[@]}" "${ANALYSIS[@]}"

# --- quickstart twin: the three impls must agree ---------------------------
echo "== examples/quickstart_torch.py =="
python examples/quickstart_torch.py "${DEVICE[@]}"

# --- the port's tests (they hold the port to the JAX package) --------------
echo "== tests/test_torch_*.py =="
python -m pytest -x -q tests/test_torch_*.py "$@"

# --- observability: launcher smoke with metrics + tracing ------------------
# The Chrome trace must hold balanced phase spans and the Prometheus
# exposition must pass the format checker.
echo "== observability =="
OBS_TMP=$(mktemp -d)
trap 'rm -rf "$OBS_TMP"' EXIT
python -m repro_torch.launch.serve --smoke "${DEVICE[@]}" --requests 4 \
  --slots 2 --max-new 4 --max-seq 64 --chunk 8 --cache-kind paged \
  --page-size 8 --prefix-cache \
  --metrics-out "$OBS_TMP/metrics.prom" --trace-out "$OBS_TMP/trace.json"
python - "$OBS_TMP" <<'PY'
import json, sys
from repro_torch.obs.metrics import validate_prometheus_text
tmp = sys.argv[1]
evs = json.load(open(f"{tmp}/trace.json"))["traceEvents"]
assert evs, "trace must record events"
depth = 0
for e in evs:
    assert {"name", "ph", "ts", "pid", "tid"} <= set(e), e
    depth += {"B": 1, "E": -1}.get(e["ph"], 0)
    assert depth >= 0, "unbalanced trace"
assert depth == 0, "unclosed phase spans"
assert any(e["ph"] == "B" for e in evs), "no phase spans recorded"
n = validate_prometheus_text(open(f"{tmp}/metrics.prom").read())
assert n > 100, f"suspiciously small exposition ({n} samples)"
print(f"observability ok: {len(evs)} trace events, {n} exposition samples")
PY
