"""The flat 1-bit cell (``dpr100x.bulk``) and what it brought: the
roofline arithmetic of ``binary_ip``, its reader, the two readers of the
top-k's tie counters (a share from given counters, nothing without them),
their catalog entries, and the cut the cell must catch.  On the card, the
cut at the cell's size is not correct and a traced window of the cell
reads all three."""

import json
import subprocess
import sys

import pytest

from portbench import faults, run
from portbench.harness import catalog, program, program_spans, readers
from portbench.roofline import binary_ip, peaks
from portbench.tiny import tiny_cell

CELL = "dpr100x.bulk"
#: the tie readers: (numerator, denominator) of the share in %
TIES = {"search.tie_tiles.exact": ("topk_blocks.tie_tiles",
                                   "topk_blocks.tiles"),
        "search.tie_rows.exact": ("topk_merge.tie_rows", "search.queries")}
NEW = ["binary_ip_roofline"] + sorted(TIES)


def test_binary_ip_bytes_by_hand():
    # Q=1024 int8 signs of 8 words (256 bytes), 2.1M rows of 8 words, the
    # (1024, 2.1M) f32 scores; s8 x s8 products over 256 positions
    b, ops, rate = binary_ip.work(1024, 2_100_000, 8)
    assert b == 262_144 + 67_200_000 + 8_601_600_000
    assert ops == 2.0 * 1024 * 2_100_000 * 256 and rate == "int8"


def _ctx(**kw):
    base = dict(config={"ivf": None}, trace=None, calls=[],
                facts={"n_docs": 2_100_000, "code_dim": 245,
                       "scorer": "onebit", "row_bytes": 32},
                rates=peaks.rates("H100"), spans={}, counters={},
                send_lags=[], setup={"build_s": 1.5})
    base.update(kw)
    return readers.Context(**base)


def test_binary_ip_roofline_from_a_trace():
    b, _, _ = binary_ip.work(1024, 2_100_000, 8)
    t_bound = b / 3.35e12       # the bytes bound it: ops take 0.22 of it
    trace = {"kernels": {"void (anonymous namespace)::binary_ip_kernel<4>("
                         "signed char const*)": [3 * 4 * t_bound, 3]},
             "busy_s": 0.8, "window_s": 1.0, "launches": {}}
    calls = [{"n": 1024, "k": 100}] * 3
    read = catalog.metric_reader("binary_ip_roofline")
    assert read(_ctx(trace=trace, calls=calls)) == pytest.approx(25.0)
    # an IVF index, an int8 index or no trace: nothing, never 0
    assert read(_ctx(trace=trace, calls=calls,
                     config={"ivf": {"nprobe": 64}})) is None
    assert read(_ctx(trace=trace, calls=calls,
                     facts={"n_docs": 2_100_000, "code_dim": 128,
                            "scorer": "int8", "row_bytes": 128})) is None
    assert read(_ctx(calls=calls)) is None
    assert catalog.metric_reader("int8_ip_roofline")(
        _ctx(trace=trace, calls=calls)) is None


@pytest.mark.parametrize("name", sorted(TIES))
def test_tie_readers_on_hand_built_counters(name, monkeypatch):
    """Two batches of 1,024 rows over 513 blocks: 2,052 of 1,050,624 tiles
    and 256 of 2,048 rows on the tie path read 0.1953…% and 12.5%; a count
    of 0 reads 0; a program without the counter, nothing."""
    num, den = TIES[name]
    total = 2 * 1024 * 513 if den == "topk_blocks.tiles" else 2048
    hits = 2052 if den == "topk_blocks.tiles" else 256
    base = {"topk_blocks.tiles": 2 * 1024 * 513, "search.queries": 2048,
            "topk.merge_candidates": 2 * 1024 * 51300}
    read = catalog.metric_reader(name)
    for counters, want in (({**base, num: hits}, 100.0 * hits / total),
                           ({**base, num: 0}, 0.0), (base, None),
                           ({num: hits}, None)):
        monkeypatch.setattr(program_spans, "program_counters",
                            lambda c=counters: c)
        got = read(None)
        assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", sorted(TIES))
def test_tie_readers_give_nothing_without_the_program_module(name,
                                                             monkeypatch):
    program.import_port()
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert catalog.metric_reader(name)(None) is None


def test_new_metrics_are_in_the_catalog_once():
    per_layer = {m["name"]: m for m in catalog.benchmark()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["moves"] == "qps.exact" and m["unit"] == "%"
        want = ([CELL] if name == "binary_ip_roofline"
                else ["dpr24x.bulk", CELL])
        assert m["workloads"] == want
        for cell in want:
            assert name in {x["name"]
                            for x in catalog.find_cell(cell).per_layer}
    assert catalog.find_cell(CELL).config["ivf"] is None


def test_queries_centred_with_the_documents_mean_are_not_correct():
    """The cut ``faults.py`` plants (the query-side means of both
    CenterNorm stages replaced by the documents'), in the flat cell:
    nearly every (row, rank) lands a gap."""
    with faults.planted("query_mean"):
        r = run.run_cell(tiny_cell(CELL, 8000), 2**31 + 313, 0.5, False,
                         "cpu")
    assert not r["correct"]
    c = r["checks"]["gap_share"]
    assert c["value"] > c["limit"], r["checks"]
    assert run.run_cell(tiny_cell(CELL, 8000), 2**31 + 313, 0.5, False,
                        "cpu")["correct"]


@pytest.mark.chip
def test_query_mean_cut_on_the_card(card):
    """The cut at the cell's own size on the card: not correct, by its
    gap share."""
    with faults.planted("query_mean"):
        r = run.run_cell(catalog.find_cell(CELL), 2**31 + 535, 1.0, False,
                         card)
    assert not r["correct"], r["checks"]
    c = r["checks"]["gap_share"]
    assert c["value"] > c["limit"], r["checks"]


@pytest.mark.chip
def test_traced_window_reads_the_new_metrics(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2**31 + 616), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=catalog.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    for name in NEW:
        assert 0.0 <= r["metrics"][name]["value"] <= 100.0, r["metrics"]
