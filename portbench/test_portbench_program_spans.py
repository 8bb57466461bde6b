"""The readers of the program's own spans and counters
(``harness/program_spans.py`` and the five ``layer_metrics`` that use
it): self time, the sums under each root ``search`` span, the medians,
the counter ratio, and nothing at all from a program that records no
spans."""

import sys

import pytest

from portbench.harness import catalog, program, program_spans

MS = 1_000_000   # ns


def _rec(i, parent, name, start_ms, end_ms, device_ms=None):
    return {"id": i, "parent": parent, "name": name,
            "start_ns": round(start_ms * MS), "end_ns": round(end_ms * MS),
            "device_ms": device_ms}


def _ivf_batch(first_id, t0, stages, route, fused, tail):
    """One IVF ``search``: three children back to back, then ``tail`` ms
    of the root's own work; the fused call holds a nested span."""
    r = first_id
    a, b, c = t0 + stages, t0 + stages + route, t0 + stages + route + fused
    return [_rec(r, None, "search", t0, c + tail),
            _rec(r + 1, r, "search.stages", t0, a),
            _rec(r + 2, r, "search.route", a, b),
            _rec(r + 3, r, "search.ivf_fused", b, c),
            _rec(r + 4, r + 3, "inner", b + 0.1, b + 0.3)]


IVF = (_ivf_batch(0, 0.0, 0.2, 0.5, 1.0, 0.1)
       + _ivf_batch(10, 5.0, 0.3, 0.4, 1.2, 0.2)
       + _ivf_batch(20, 9.0, 0.25, 0.6, 0.8, 0.1))
EXACT = [_rec(0, None, "search", 0.0, 2.0),
         _rec(1, 0, "search.topk.merge", 1.0, 1.1, device_ms=8.0),
         _rec(2, None, "search", 30.0, 32.0),
         _rec(3, 2, "search.topk.merge", 31.0, 31.1, device_ms=7.5),
         _rec(4, 2, "search.topk.merge", 31.2, 31.3, device_ms=0.5),
         _rec(5, None, "search", 60.0, 62.0),
         _rec(6, 5, "search.topk.merge", 61.0, 61.1, device_ms=9.0),
         # a stage 2 outside any search call is no batch's
         _rec(7, None, "search.topk.merge", 90.0, 91.0, device_ms=50.0)]


def test_self_time_is_the_duration_less_the_children():
    own = program_spans.self_host_ms(IVF[:5])
    assert own[0] == pytest.approx(0.1)        # 1.8 less 0.2 + 0.5 + 1.0
    assert own[1] == pytest.approx(0.2)
    assert own[3] == pytest.approx(1.0 - 0.2)  # less its nested span
    assert own[4] == pytest.approx(0.2)


def test_an_open_span_counts_for_nothing():
    recs = [_rec(0, None, "search", 0.0, 2.0),
            dict(_rec(1, 0, "search.route", 0.5, 1.0), end_ns=None)]
    assert program_spans.self_host_ms(recs) == {0: pytest.approx(2.0)}
    assert program_spans.per_root(recs, "search.route", "host") is None


def test_sums_under_each_root_and_the_median():
    assert program_spans.per_root(IVF, "search.route", "host") == \
        pytest.approx([0.5, 0.4, 0.6])
    assert program_spans.per_root(IVF, "search.ivf_fused", "host") == \
        pytest.approx([0.8, 1.0, 0.6])
    # the self times of a root and of every span under it add up to the
    # root's duration
    own = program_spans.self_host_ms(IVF)
    for root in (r for r in IVF if r["name"] == "search"):
        under = [i for i in own if root["id"] <= i < root["id"] + 10]
        assert sum(own[i] for i in under) == pytest.approx(
            program_spans.host_ms(root))
    assert program_spans.per_root(EXACT, "search.topk.merge", "device") \
        == pytest.approx([8.0, 8.0, 9.0])
    assert program_spans.median_ms("search.topk.merge", "device",
                                   EXACT) == pytest.approx(8.0)
    assert program_spans.median_ms("search.route", "host", EXACT) is None


def test_a_root_without_the_span_counts_as_zero():
    recs = EXACT[:2] + [_rec(9, None, "search", 40.0, 41.0)]
    assert program_spans.per_root(recs, "search.topk.merge", "device") == \
        pytest.approx([8.0, 0.0])


def test_counter_ratio():
    c = {"topk.merge_candidates": 1024 * 51300 * 3, "search.queries": 3072}
    assert program_spans.ratio("topk.merge_candidates", "search.queries",
                               c) == 51300
    assert program_spans.ratio("topk.merge_candidates", "search.queries",
                               {"search.queries": 0}) is None
    assert program_spans.ratio("topk.merge_candidates", "search.queries",
                               {}) is None


READS = {
    "search.merge_ms.exact": (EXACT, 8.0),
    "search.stages_host_ms.ivf": (IVF, 0.25),
    "search.route_host_ms.ivf": (IVF, 0.5),
    "search.fused_host_ms.ivf": (IVF, 0.8),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_span_readers_on_hand_built_records(name, monkeypatch):
    records, want = READS[name]
    monkeypatch.setattr(program_spans, "program_records", lambda: records)
    assert catalog.metric_reader(name)(None) == pytest.approx(want)


def test_counter_reader_on_hand_built_counters(monkeypatch):
    monkeypatch.setattr(program_spans, "program_counters", lambda: {
        "topk.merge_candidates": 2 * 1024 * 51300, "search.queries": 2048,
        "int8_ip.launches": 2})
    assert catalog.metric_reader("search.merge_rows.exact")(None) == 51300


NEW = sorted(READS) + ["search.merge_rows.exact"]


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_without_the_program_module(name,
                                                         monkeypatch):
    """A program without ``repro_torch.tracing`` (the commit before it):
    the reader gives nothing and does not raise."""
    program.import_port()
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert program_spans.program_records() is None
    assert catalog.metric_reader(name)(None) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_from_an_empty_store(name, monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    monkeypatch.setattr(program_spans, "program_counters", lambda: {})
    assert catalog.metric_reader(name)(None) is None


def test_each_new_metric_is_in_the_catalog_once():
    per_layer = {m["name"]: m for m in catalog.benchmark()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["layer"] == "index: repro_torch/retrieval search"
        cell = "dpr24x.bulk" if name.endswith(".exact") else \
            "dpr100x-ivf.bulk"
        assert m["workloads"] == [cell]
        assert m["moves"] == ("qps.exact" if cell == "dpr24x.bulk"
                              else "qps.ivf")
        assert name in {x["name"] for x in catalog.find_cell(cell).per_layer}


def test_readers_on_the_program_on_the_cpu():
    """The program's own records, from a tiny exact and a tiny IVF index
    searched on the CPU with recording on, through the readers."""
    import torch
    program.import_port()
    from repro_torch import tracing
    from repro_torch.retrieval.api import IndexSpec, build_index
    g = torch.Generator().manual_seed(3)
    docs, queries = torch.randn(2500, 48, generator=g), \
        torch.randn(16, 48, generator=g)
    exact = build_index(IndexSpec(method="pca_int8", dim=24, post=False,
                                  backend="kernel"), docs, queries,
                        device="cpu")
    ivf = build_index(IndexSpec(method="pca_onebit", dim=40, post=False,
                                backend="kernel", ivf=(8, 3)), docs,
                      queries, device="cpu")
    tracing.reset()
    tracing.enable()
    try:
        exact.search(queries, 10)
        exact.search(queries, 10)
        recs = tracing.records()
        rows = catalog.metric_reader("search.merge_rows.exact")(None)
        tracing.reset()
        ivf.search(queries, 10)
        ivf_recs = tracing.records()
        route = catalog.metric_reader("search.route_host_ms.ivf")(None)
    finally:
        tracing.disable()
        tracing.reset()
    assert rows == 3 * 10          # ceil(2500 / 1024) blocks × k
    # on the CPU a span has no device time
    assert program_spans.median_ms("search.topk.merge", "device",
                                   recs) is None
    assert program_spans.median_ms("search.topk.merge", "host", recs) > 0
    assert route > 0
    own = program_spans.self_host_ms(ivf_recs)
    root = next(r for r in ivf_recs if r["name"] == "search")
    assert sum(own.values()) == pytest.approx(program_spans.host_ms(root))
