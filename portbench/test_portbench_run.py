"""Whole runs at a tiny size on the CPU: each cell comes out correct, and
its control (the reference one precision step down, in the program's
place) does not."""

import pytest

from portbench import control, run
from portbench.harness import catalog
from portbench.tiny import tiny_cell, tiny_pair

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]
#: the open-loop serving mix, which no cell runs yet (PERF.md, Open
#: questions), driven through the front door all the same
SERVE = ("hotpotqa-dpr-24x", "serve")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    r = run.run_cell(tiny_cell(cell, 8000), 2**31 + 101, 0.5, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    c = catalog.find_cell(cell)
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(c.config["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.run_control(tiny_cell(cell, 8000), 2**31 + 202, "cpu")
    assert not r["correct"], r["numbers"]


def test_float_stages_in_bf16_are_not_correct():
    """The 24x recipe's other step down: its float32 stages in bfloat16,
    which its int8 codes give away."""
    r = control.run_control(tiny_cell("dpr24x.bulk", 8000), 2**31 + 212,
                            "cpu", "bf16")
    assert not r["correct"], r["numbers"]
    assert r["checks"]["code_differ_median"]["value"] > \
        r["checks"]["code_differ_median"]["limit"]


def test_serving_mix_runs_correct():
    r = run.run_cell(tiny_pair(*SERVE, 8000), 2**31 + 111, 0.5, False,
                     "cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["metrics"]["p95_ms"]["value"] > 0


def test_serving_mix_control_is_not_correct():
    r = control.run_control(tiny_pair(*SERVE, 8000), 2**31 + 222, "cpu")
    assert not r["correct"], r["numbers"]
