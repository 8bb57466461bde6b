"""The benchmark is driven by data: cells, configurations, traffic mixes
and per-layer metrics are found by name, and ``BENCHMARK.json`` keeps to
its contract's shape."""

import json
import re
import shutil

import pytest

from portbench.harness import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = catalog.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_parts(cell):
    c = catalog.find_cell(cell)
    assert c.config["n_docs"] > 0 and c.traffic["loop"] in ("closed", "open")
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(catalog.metric_reader(m["name"]))


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
        cfg = catalog.load_json(catalog.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
        assert len(cfg["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _add_files(tmp_path):
    """A copy of the benchmark with one dummy of each kind added as new
    files and new entries, nothing existing edited."""
    root = tmp_path / "checkout"
    shutil.copytree(catalog.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((catalog.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/hotpotqa-dpr-24x.json")
                     .read_text())
    cfg.update(name="dummy-config", n_docs=1000)
    (root / "portbench/configs/dummy-config.json").write_text(
        json.dumps(cfg))
    (root / "portbench/traffic/dummy-mix.json").write_text(json.dumps(
        {"loop": "closed", "batch": 8, "k": 5, "pool": 64,
         "check_queries": 8}))
    (root / "portbench/layer_metrics/dummy.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "dummy-config", "source": "x",
                             "file": "portbench/configs/dummy-config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.cell", "config":
                               "dummy-config", "traffic": "dummy-mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy.metric", "unit": "rows",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "qps.exact",
                               "workloads": ["dummy.cell"]})
    qps = next(m for m in bench["end_to_end"] if m["name"] == "qps.exact")
    qps["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_new_files_are_found_without_edits(tmp_path):
    root = _add_files(tmp_path)
    cell = catalog.find_cell("dummy.cell", root)
    assert cell.config["name"] == "dummy-config"
    assert cell.traffic["batch"] == 8
    # a metric without a "workloads" key is reported by every cell
    assert {m["name"] for m in cell.per_layer} == {"dummy.metric",
                                                   "setup.build_s"}
    assert catalog.metric_reader("dummy.metric", root)(None) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {"qps.exact", "setup_s"}
    # the cells already there still find their own parts unchanged
    assert catalog.find_cell("dpr24x.bulk", root).traffic == \
        catalog.find_cell("dpr24x.bulk").traffic


def test_unknown_cell_is_named():
    with pytest.raises(KeyError, match="no workload"):
        catalog.find_cell("no.such.cell")
