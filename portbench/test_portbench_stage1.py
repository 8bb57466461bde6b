"""The reader of stage 1's survivors at its bound
(``search.bound_survivors.exact``): the program's device counter
``topk_blocks.bound_survivors`` over the tiles off the tie path, over the
traced calls' k, on hand-built counters; nothing from a program without
the counter or without ``repro_torch.tracing``; its catalog entry, once,
in both exact cells."""

import sys

import pytest

from portbench.harness import catalog, program, program_spans, readers
from portbench.roofline import peaks

NAME = "search.bound_survivors.exact"
CELLS = ["dpr24x.bulk", "dpr100x.bulk"]
TILES = 2 * 1024 * 513      # two batches of 1,024 rows over 513 blocks


def _ctx(calls):
    return readers.Context(
        config={"ivf": None}, trace=None, calls=calls,
        facts={"n_docs": 2_100_000}, rates=peaks.rates("H100"), spans={},
        counters={}, send_lags=[], setup={"build_s": 1.0})


CALLS = [{"rows": 0, "n": 1024, "k": 100}] * 3


@pytest.mark.parametrize("counters,calls,want", [
    # 1.1·k a tile, no tile on the tie path
    ({"topk_blocks.tiles": TILES, "topk_blocks.tie_tiles": 0,
      "topk_blocks.bound_survivors": 110 * TILES}, CALLS, 1.1),
    # tiles on the tie path count no survivors and leave the denominator
    ({"topk_blocks.tiles": TILES, "topk_blocks.tie_tiles": TILES // 2,
      "topk_blocks.bound_survivors": 125 * (TILES // 2)}, CALLS, 1.25),
    # no tie counter yet (no tile took the tie path): all tiles count
    ({"topk_blocks.tiles": TILES,
      "topk_blocks.bound_survivors": 100 * TILES}, CALLS, 1.0),
    # a program without the counter (the commit before it)
    ({"topk_blocks.tiles": TILES, "topk_blocks.tie_tiles": 0}, CALLS, None),
    # every tile on the tie path, or no tile at all
    ({"topk_blocks.tiles": TILES, "topk_blocks.tie_tiles": TILES,
      "topk_blocks.bound_survivors": 0}, CALLS, None),
    ({"topk_blocks.bound_survivors": 0}, CALLS, None),
    # no traced call to take k from, or calls at two depths
    ({"topk_blocks.tiles": TILES, "topk_blocks.tie_tiles": 0,
      "topk_blocks.bound_survivors": 110 * TILES}, [], None),
    ({"topk_blocks.tiles": TILES, "topk_blocks.tie_tiles": 0,
      "topk_blocks.bound_survivors": 110 * TILES},
     CALLS + [{"rows": 0, "n": 1024, "k": 64}], None),
], ids=["distinct", "half_tied", "no_tie_counter", "no_counter",
        "all_tied", "no_tiles", "no_calls", "two_depths"])
def test_reader_on_hand_built_counters(counters, calls, want, monkeypatch):
    monkeypatch.setattr(program_spans, "program_counters", lambda: counters)
    got = catalog.metric_reader(NAME)(_ctx(calls))
    assert got == (None if want is None else pytest.approx(want))


def test_reader_gives_nothing_without_the_program_module(monkeypatch):
    program.import_port()
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert program_spans.program_counters() is None
    assert catalog.metric_reader(NAME)(_ctx(CALLS)) is None


def test_reader_gives_nothing_from_an_empty_store(monkeypatch):
    monkeypatch.setattr(program_spans, "program_counters", lambda: {})
    assert catalog.metric_reader(NAME)(_ctx(CALLS)) is None
    assert catalog.metric_reader(NAME)(None) is None


def test_catalog_entry_once():
    entries = [m for m in catalog.benchmark()["per_layer"]
               if m["name"] == NAME]
    assert len(entries) == 1
    m = entries[0]
    assert m["layer"] == "kernels: repro_torch/csrc"
    assert m["source"] == "program_counter" and m["moves"] == "qps.exact"
    assert m["workloads"] == CELLS and m["better"] == "lower"
    for cell in CELLS:
        assert NAME in {x["name"] for x in catalog.find_cell(cell).per_layer}
    assert NAME not in {x["name"] for x in
                        catalog.find_cell("dpr100x-ivf.bulk").per_layer}
