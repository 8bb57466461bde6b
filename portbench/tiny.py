"""A cell cut to a size the CPU tests can hold: the same recipe, the
same mix and the same comparison, on fewer documents, lists and queries.
The tests use it; a run never does."""

from __future__ import annotations

from portbench.harness import catalog


def shrink(cell: catalog.Cell, n_docs: int = 20_000) -> catalog.Cell:
    cell.config["n_docs"] = n_docs
    cell.config["queries_fit"] = 512
    if cell.config.get("ivf"):
        cell.config["ivf"].update(nlist=64, nprobe=8)
    t = cell.traffic
    if t["loop"] == "closed":
        t.update(batch=128, pool=512, check_queries=128)
    else:
        t.update(rows_per_s=400, pool=512, check_requests=32)
    return cell


def tiny_cell(name: str, n_docs: int = 20_000) -> catalog.Cell:
    """A cell of ``BENCHMARK.json``, cut to size."""
    return shrink(catalog.find_cell(name), n_docs)


def tiny_pair(config: str, mix: str, n_docs: int = 20_000) -> catalog.Cell:
    """A configuration under a mix that no cell pairs yet, cut to size,
    reporting what an open or closed loop measures."""
    root = catalog.ROOT / "portbench"
    traffic = catalog.load_json(root / "traffic" / f"{mix}.json")
    e2e = ["p50_ms", "p95_ms"] if traffic["loop"] == "open" else ["qps"]
    cell = catalog.Cell(
        name=f"{config}.{mix}",
        config=catalog.load_json(root / "configs" / f"{config}.json"),
        traffic=traffic, chips=1,
        end_to_end=[{"name": n, "unit": "x"} for n in e2e + ["setup_s"]],
        per_layer=[])
    return shrink(cell, n_docs)
