"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells; a cell names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); a per-layer metric is read by
``portbench/layer_metrics/<metric>.py``.  Adding any of them is adding a
file and an entry: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list          # the end-to-end metric entries this cell reports
    per_layer: list           # the per-layer metric entries this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and metrics; raises ``KeyError`` for an unknown name."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in names]
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``layer_metrics/<name>.py``."""
    path = root / "portbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
