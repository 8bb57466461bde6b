"""The port's search examples (``examples_torch/``) against ``repro``'s.

Each example of both packages runs in this process at a tiny size on the
CPU: ``repro``'s through its ``main`` (its printed lines captured), the
port's through ``run(argv)`` with ``--device cpu``.  Neither file under
``examples/`` changes; both are loaded by path.

* quickstart: the KB's norms, the float R-Precision and index size, the
  compressed size and ratio print equal; the compressed R-Precision
  within 0.02.
* live_updates: every count (added, segment, gid range, deleted,
  tombstones, live docs, versions, updates, compactions) equal; the
  ``pca_onebit`` path (the port's ``binary_ip``) gives the same counts.
* serve_compressed ``--no-post --ivf-nlist 16``: versions, requests,
  queries, the live version and the open-loop trial's admitted and lost
  requests equal; the canary overlap within 0.15 (k-means fits differ by
  generator, ROADMAP §C; measured |Δ| 0.056); the port's ``--shards 2``
  act reads "bit-identical" on the CPU (``repro``'s skips in-process: one
  host device); the driver's open-loop generator is the port's own copy
  (``examples_torch/loadgen.py``), and that copy draws
  ``benchmarks/loadgen.py``'s Poisson schedule byte for byte.

Also the guard: nothing under ``examples_torch/`` or ``src/repro_torch/``
imports ``jax`` or ``repro``, and replint's passes are clean on
``examples_torch/``.
"""

import ast
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from examples_loader import REPO, load_example  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CPU = ["--device", "cpu"]


def examples(stem: str):
    """(repro's example module, the port's) for ``examples/<stem>.py``."""
    return (load_example("examples", stem),
            load_example("examples_torch", stem))


def run_both(stem: str, argv: list, capsys):
    """Run both examples on ``argv``: (repro's lines, the port's lines, the
    port's returned numbers)."""
    r_mod, p_mod = examples(stem)
    r_mod.main(argv)
    r_lines = capsys.readouterr().out.splitlines()
    out = p_mod.run(argv + CPU)
    p_lines = capsys.readouterr().out.splitlines()
    if stem == "serve_compressed":
        # the port's open-loop generator is its own copy, whatever
        # ``loadgen`` another module put on ``sys.path``
        assert p_mod.loadgen.__file__ == str(REPO / "examples_torch"
                                             / "loadgen.py")
        assert p_mod.loadgen.QueryOptions.__module__.startswith(
            "repro_torch.")
    return r_lines, p_lines, out


def line_with(lines, needle: str) -> str:
    hits = [ln for ln in lines if needle in ln]
    assert hits, f"no line with {needle!r} in {lines}"
    return hits[0]


def number_after(line: str, label: str) -> float:
    m = re.search(re.escape(label) + r"\s*([-0-9.]+)", line)
    assert m, (label, line)
    return float(m.group(1))


def test_quickstart_matches_repro(capsys):
    argv = ["--n-docs", "2000", "--n-queries", "64", "--dim", "32"]
    r_lines, p_lines, out = run_both("quickstart", argv, capsys)
    for needle in ("doc L2 norm", "R-Precision", "index size"):
        # the first line with each: norms; the float baseline; its size
        assert line_with(p_lines, needle) == line_with(r_lines, needle)
    r_size, p_size = (line_with(ls, "fitted + encoded") for ls in
                      (r_lines, p_lines))
    assert r_size.split("; ")[1] == p_size.split("; ")[1]   # size, ratio
    assert f"({out['ratio']:.0f}x smaller)" in r_size
    r_rp = number_after(line_with(r_lines, "of uncompressed"), "R-Precision")
    assert abs(out["rp"] - r_rp) <= 0.02, (out["rp"], r_rp)
    assert f"R-Precision {out['float_rp']:.3f}" in line_with(r_lines,
                                                            "index size")
    assert "(CPU)" in line_with(p_lines, "ms/query")


def _churn_counts(lines) -> dict:
    added = line_with(lines, "added ")
    m = re.search(r"added (\d+) docs as segment #(\d+) \(global ids "
                  r"(\d+)\.\.(\d+)\)", added)
    dele = re.search(r"deleted (\d+) docs \((\d+) tombstones, (\d+) live\)",
                     line_with(lines, "tombstones"))
    served = re.search(r"versions \[([0-9, ]+)\], live=v(\d+)",
                       line_with(lines, "across versions"))
    upd = re.search(r"updates=(\d+) compactions=(\d+) live_docs=(\d+) "
                    r"segments=(\d+)", line_with(lines, "updates="))
    return {"added": int(m[1]), "segment": int(m[2]),
            "gid_range": (int(m[3]), int(m[4]) + 1),
            "deleted": int(dele[1]), "tombstones": int(dele[2]),
            "n_live_after_delete": int(dele[3]),
            "versions": [int(v) for v in served[1].split(",")],
            "live": int(served[2]), "updates": int(upd[1]),
            "compactions": int(upd[2]), "n_live": int(upd[3]),
            "segments": int(upd[4]),
            "mean_shift": number_after(added, "mean_shift=")}


def test_live_updates_matches_repro(capsys):
    argv = ["--n-docs", "2000", "--requests", "8", "--batch", "4"]
    r_lines, p_lines, out = run_both("live_updates", argv, capsys)
    want = _churn_counts(r_lines)
    assert abs(out.pop("mean_shift") - want.pop("mean_shift")) <= 1e-3
    assert {k: out[k] for k in want} == want
    assert _churn_counts(p_lines)["n_live"] == want["n_live"]
    for needle in ("live docs, scorer", "trigger fired", "none touched"):
        assert line_with(p_lines, needle) == line_with(r_lines, needle)
    assert "(CPU)" in line_with(p_lines, "latency")

    # the 1-bit path (binary_ip's plain version): the same churn
    _, p_mod = examples("live_updates")
    onebit = p_mod.run(argv + ["--method", "pca_onebit"] + CPU)
    capsys.readouterr()
    assert onebit["scorer"] == "onebit"
    assert {k: onebit[k] for k in want} == want


def test_serve_compressed_matches_repro(capsys):
    argv = ["--n-docs", "4000", "--no-post", "--ivf-nlist", "16",
            "--requests", "8", "--batch", "8", "--shards", "2"]
    r_lines, p_lines, out = run_both("serve_compressed", argv, capsys)
    served = re.search(r"served (\d+) requests \((\d+) queries, \d+ "
                       r"micro-batches\) across versions \[([0-9, ]+)\], "
                       r"live=v(\d+)", line_with(r_lines, "micro-batches"))
    assert out["requests_served"] == int(served[1])
    assert out["queries_served"] == int(served[2])
    assert out["versions"] == [int(v) for v in served[3].split(",")]
    assert out["live"] == int(served[4]) == out["promoted"] == 2
    for tag in ("v1", "v2"):
        line = line_with(r_lines, f"  {tag}: ")
        assert f"{tag}: {out[tag]['n_docs']} docs, scorer " \
               f"{out[tag]['scorer']}," in line
    r_overlap = number_after(line_with(r_lines, "canary:"), "overlap")
    assert abs(out["canary_overlap"] - r_overlap) <= 0.15, \
        (out["canary_overlap"], r_overlap)
    assert out["canary_overlap"] >= 0.5

    trial = re.search(r"served (\d+) open-loop requests .*, (\d+) lost",
                      line_with(r_lines, "open-loop"))
    tiered = out["tiered"]
    assert tiered["trial"]["admitted"] == int(trial[1])
    assert tiered["trial"]["lost"] == int(trial[2]) == 0
    assert tiered["tier"]["hits"] + tiered["tier"]["misses"] > 0
    assert line_with(p_lines, "25% resident budget") == \
        line_with(r_lines, "25% resident budget")

    assert "sharded swap skipped" in line_with(r_lines, "sharded swap")
    sharded = out["sharded"]
    assert sharded["verdict"] == "bit-identical"
    assert "results vs single-host bit-identical" in \
        line_with(p_lines, "promoted v4")
    assert sum(s["n_docs"] for s in sharded["shards"]) == 4200
    assert [s["shard"] for s in sharded["shards"]] == [0, 1]


def test_loadgen_schedule_matches_benchmarks():
    """The port's copy draws ``benchmarks/loadgen.py``'s Poisson schedule
    byte for byte from one seed."""
    r_lg = load_example("benchmarks", "loadgen")
    p_lg = load_example("examples_torch", "loadgen")
    assert p_lg.DEFAULT_MENU == tuple(
        p_lg.MenuItem(**dataclasses.asdict(m)) for m in r_lg.DEFAULT_MENU)
    r_wl = r_lg.build_workload(np.random.default_rng(3), duration_s=2.0,
                               rows_per_s=150.0, arrival="poisson",
                               menu=r_lg.DEFAULT_MENU, pool_size=97,
                               zipf_alpha=1.1)
    p_wl = p_lg.build_workload(np.random.default_rng(3), duration_s=2.0,
                               rows_per_s=150.0, menu=p_lg.DEFAULT_MENU,
                               pool_size=97, zipf_alpha=1.1)
    assert p_wl.arrivals.tobytes() == r_wl.arrivals.tobytes()
    assert p_wl.menu_ids.tobytes() == r_wl.menu_ids.tobytes()
    assert len(p_wl.row_ids) == len(r_wl.row_ids) > 50
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(p_wl.row_ids, r_wl.row_ids))


@pytest.mark.parametrize("stem", ["quickstart", "live_updates",
                                  "serve_compressed", "train_retriever",
                                  "knn_lm"])
def test_example_needs_a_named_device_without_a_gpu(stem, monkeypatch):
    p_mod = load_example("examples_torch", stem)
    assert callable(p_mod.run) and callable(p_mod.main)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_mod.run([])


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_and_its_examples_import_neither_jax_nor_repro():
    files = sorted((REPO / "examples_torch").glob("*.py")) + sorted(
        (REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 60
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert bad == []


def test_replint_is_clean_on_examples_torch():
    from tools.repro_lint.cli import main as replint

    assert replint(["examples_torch", "--baseline",
                    "tools/repro_lint/baseline.json",
                    "--root", str(REPO)]) == 0
