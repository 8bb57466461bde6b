"""On the card: each cell's command at a short window prints a correct
result with the contract's keys, and the controls and the cuts planted
in the set-up at the cell's own size are not correct.  Run with
``python -m pytest -m chip portbench``."""

import json
import subprocess
import sys

import pytest

from portbench import control, faults, run
from portbench.harness import catalog

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_command_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 404), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=catalog.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, card):
    r = control.run_control(catalog.find_cell(cell), 2**31 + 505, card)
    assert not r["correct"], r["numbers"]


@pytest.mark.chip
def test_bf16_stages_on_the_card(card):
    r = control.run_control(catalog.find_cell("dpr24x.bulk"), 2**31 + 515,
                            card, "bf16")
    assert not r["correct"], r["numbers"]


@pytest.mark.chip
@pytest.mark.parametrize("fault", ["no_rotation", "no_lloyd"])
def test_cut_setup_on_the_card(fault, card):
    with faults.planted(fault):
        r = run.run_cell(catalog.find_cell("dpr100x-ivf.bulk"), 2**31 + 525,
                         1.0, False, card)
    assert not r["correct"], r["checks"]
