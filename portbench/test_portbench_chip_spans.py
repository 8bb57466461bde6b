"""On the card: a traced window of each cell reports the metrics read from
the program's own spans and counters, stage 2 ranks 51,300 candidates a
query in the exact cell (513 blocks of 4,096 over 2.1M documents, times
k = 100), and no program span reaches the device's timeline.  Run with
``python -m pytest -m chip portbench``."""

import json
import subprocess
import sys

import pytest

from portbench.harness import catalog

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]
#: the metrics read through ``harness/program_spans.py``
SPAN_METRICS = {"search.merge_ms.exact", "search.merge_rows.exact",
                "search.stages_host_ms.ivf", "search.route_host_ms.ivf",
                "search.fused_host_ms.ivf"}


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_traced_window_reads_the_program_spans(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 606), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=catalog.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    want = {m["name"] for m in catalog.find_cell(cell).per_layer} \
        & SPAN_METRICS
    assert want and want <= set(r["metrics"]), r["metrics"]
    if cell == "dpr24x.bulk":
        assert r["metrics"]["search.merge_rows.exact"]["value"] == 51300
    for name, _ in r["breakdown"]["device_ops"]:
        assert not name.startswith("repro_torch"), name
