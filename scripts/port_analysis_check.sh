#!/usr/bin/env bash
# The port's static-verification gate, the counterpart of
# scripts/analysis_check.sh: the invariant linter over
# datafusion_tpu_torch/, a smoke test of the plan verifier, a
# lockcheck-enabled pass of the analysis, cache and WAL tests, and the
# evaluation of that pass's lock-order report (no cycle, no blocking
# call under a held lock).  Runs on the CPU:
#     bash scripts/port_analysis_check.sh
set -euo pipefail
cd "$(dirname "$0")/.."

report="$(mktemp)"
trap 'rm -f "${report}"' EXIT

echo "== self-lint (python -m datafusion_tpu_torch.analysis) =="
python -m datafusion_tpu_torch.analysis datafusion_tpu_torch

echo "== plan verifier smoke (EXPLAIN VERIFY + reject) =="
python - <<'PY'
import os
import tempfile

from datafusion_tpu_torch.datatypes import DataType, Field, Schema
from datafusion_tpu_torch.errors import PlanVerificationError
from datafusion_tpu_torch.exec.context import ExecutionContext
from datafusion_tpu_torch.plan.expr import Column
from datafusion_tpu_torch.plan.logical import Projection, TableScan

tmp = tempfile.mkdtemp()
path = os.path.join(tmp, "t.csv")
with open(path, "w", encoding="utf-8") as f:
    f.write("city,lat\nSF,37.7\n")
schema = Schema([Field("city", DataType.UTF8), Field("lat", DataType.FLOAT64)])
ctx = ExecutionContext(device="cpu", result_cache=False)
ctx.register_csv("t", path, schema)
out = ctx.sql("EXPLAIN VERIFY SELECT city, MIN(lat) FROM t GROUP BY city")
assert out.ok and "::" in repr(out), repr(out)
try:
    ctx.execute(Projection([Column(9)], TableScan("default", "t", schema),
                           Schema([Field("x", DataType.INT64)])))
    raise SystemExit("verifier failed to reject an unknown column")
except PlanVerificationError as e:
    assert "unknown column #9" in str(e)
print("verifier smoke OK")
PY

echo "== lockcheck-enabled fast tests =="
# the tests import both packages, whose exit hooks would write one
# report file: the port's report is written here, in the same process
JAX_PLATFORMS=cpu DATAFUSION_TPU_LOCKCHECK=1 python - "${report}" <<'PY'
import json
import sys

import pytest

rc = pytest.main(["tests/test_torch_analysis.py", "tests/test_torch_cache.py",
                  "tests/test_torch_wal.py", "-q", "-p", "no:cacheprovider"])
from datafusion_tpu_torch.analysis import lockcheck

with open(sys.argv[1], "w", encoding="utf-8") as f:
    json.dump(lockcheck.report(), f)
sys.exit(int(rc))
PY

echo "== lock-order report =="
python -m datafusion_tpu_torch.analysis --lockcheck-report "${report}"

echo "PORT ANALYSIS CHECK PASSED"
