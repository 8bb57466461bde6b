"""``repro_torch.tracing``: spans inside the search paths, always-on
counters, and counters that live on the device.

Off (no profiler recording, no ``enable()``), a span records nothing and
opens no profiler scope.  On, the exact path gives ``search`` ⊃
``search.topk.merge`` and the fused IVF path ``search`` ⊃
{``search.stages``, ``search.route``, ``search.ivf_fused``}; under a
profiler each span is a ``repro_torch.*`` CPU op, not a user annotation,
nested under the scope that encloses it.  Answers are the same bits
either way, and the kernels' launch counts read as before.  A device
counter is read only by ``counters()``; on the card the top-k's tie
counters rise on scores of a few values and stay at 0 on distinct ones
(``-m chip``: this file imports no JAX, so it runs there).
"""

import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import (WRAPPERS, launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.topk_blocks.ops import (default_block_d,  # noqa: E402
                                                 streaming_topk)
from repro_torch.kernels.topk_blocks.ref import topk_ref  # noqa: E402
from repro_torch.retrieval.api import IndexSpec, build_index  # noqa: E402

N_DOCS, DIM, Q, K = 3000, 64, 40, 10


@pytest.fixture(autouse=True)
def clean_store():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def indexes():
    g = torch.Generator().manual_seed(0)
    docs = torch.randn(N_DOCS, DIM, generator=g)
    queries = torch.randn(Q, DIM, generator=g)
    exact = build_index(IndexSpec(method="pca_int8", dim=32, post=False,
                                  backend="kernel"), docs, queries,
                        device="cpu")
    ivf = build_index(IndexSpec(method="pca_onebit", dim=45, post=False,
                                backend="kernel", ivf=(16, 4)), docs,
                      queries, device="cpu")
    assert ivf._use_fused_kernel
    return {"exact": exact, "ivf": ivf, "queries": queries}


def _tree(recs):
    return {r["id"]: r for r in recs}


def test_off_records_nothing_and_opens_no_profiler_scope(indexes,
                                                         monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler scope was opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("a") is tracing.span("b")     # shared, no allocation
    before = tracing.counters()
    indexes["exact"].search(indexes["queries"], K)
    indexes["ivf"].search(indexes["queries"], K)
    assert tracing.records() == []
    # counters stay on: two searches of Q rows
    assert tracing.counters()["search.queries"] == \
        before.get("search.queries", 0) + 2 * Q


def test_exact_path_span_tree(indexes):
    tracing.enable()
    indexes["exact"].search(indexes["queries"], K)
    recs = tracing.records()
    assert [r["name"] for r in recs] == ["search", "search.topk.merge"]
    root, merge = recs
    assert root["parent"] is None and merge["parent"] == root["id"]
    assert root["start_ns"] <= merge["start_ns"] <= merge["end_ns"] \
        <= root["end_ns"]
    assert root["device_ms"] is None and merge["device_ms"] is None


def test_streaming_topk_kernel_branch_spans_stage_two():
    scores = torch.randn(5, 3000, generator=torch.Generator().manual_seed(1))
    tracing.enable()
    with tracing.span("search"):
        streaming_topk(scores, K, use_kernel=True)
        streaming_topk(scores, K, use_kernel=False)   # no stage 2
    recs = tracing.records()
    assert [r["name"] for r in recs] == ["search", "search.topk.merge"]
    assert recs[1]["parent"] == recs[0]["id"]
    n_blocks = -(-3000 // default_block_d(K))
    assert tracing.counters()["topk.merge_candidates"] == 5 * n_blocks * K


def test_ivf_fused_path_span_tree(indexes):
    tracing.enable()
    indexes["ivf"].search(indexes["queries"], K)
    recs = tracing.records()
    names = [r["name"] for r in recs]
    assert names == ["search", "search.stages", "search.route",
                     "search.ivf_fused"]
    root = recs[0]
    assert root["parent"] is None
    prev_end = root["start_ns"]
    for r in recs[1:]:
        assert r["parent"] == root["id"]
        assert prev_end <= r["start_ns"] <= r["end_ns"] <= root["end_ns"]
        prev_end = r["end_ns"]


def test_ivf_fused_search_alone_gives_the_three_stages(indexes):
    ivf = indexes["ivf"]
    tracing.enable()
    with tracing.span("search"):
        ivf._fused_search(indexes["queries"], K, 4, ivf.scorer.params(),
                          *ivf._list_major_layout())
    recs = tracing.records()
    tree = _tree(recs)
    kids = {r["name"] for r in recs if r["parent"] is not None
            and tree[r["parent"]]["name"] == "search"}
    assert kids == {"search.stages", "search.route", "search.ivf_fused"}


@pytest.mark.parametrize("path", ["exact", "ivf"])
def test_spans_under_a_profiler_are_cpu_ops_not_annotations(indexes, path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("pb.search"):
            indexes[path].search(indexes["queries"], K)
    ours = [e for e in prof.events()
            if e.name.startswith(tracing.PROFILER_PREFIX)]
    want = {"exact": {"search", "search.topk.merge"},
            "ivf": {"search", "search.stages", "search.route",
                    "search.ivf_fused"}}[path]
    assert {e.name[len(tracing.PROFILER_PREFIX):] for e in ours} == want
    for e in ours:
        assert not e.is_user_annotation
        assert e.device_type == torch.autograd.DeviceType.CPU
        parent = "pb.search" if e.name == "repro_torch.search" \
            else "repro_torch.search"
        assert e.cpu_parent is not None and e.cpu_parent.name == parent
    # the profiler turned recording on: the store holds the same spans
    assert {r["name"] for r in tracing.records()} == want


@pytest.mark.parametrize("path", ["exact", "ivf"])
def test_answers_are_the_same_bits_with_tracing_on(indexes, path):
    off = indexes[path].search(indexes["queries"], K)
    tracing.enable()
    on = indexes[path].search(indexes["queries"], K)
    tracing.disable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = indexes[path].search(indexes["queries"], K)
    for got in (on, profiled):
        for a, b in zip(off, got):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_counts_read_the_counters():
    assert list(launch_counts()) == ["int8_ip", "binary_ip", "topk_blocks",
                                     "fused_ivf_topk", "fused_quantize"]
    assert launch_counts() == dict.fromkeys(WRAPPERS, 0)
    tracing.count("topk_blocks.launches", 3)
    tracing.count("int8_ip.launches")
    tracing.count("search.queries", 7)
    assert launch_counts() == {**dict.fromkeys(WRAPPERS, 0),
                               "topk_blocks": 3, "int8_ip": 1}
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(WRAPPERS, 0)
    assert tracing.counters() == {"search.queries": 7}


def test_cpu_searches_count_no_launches(indexes):
    before = launch_counts()
    indexes["exact"].search(indexes["queries"], K)
    indexes["ivf"].search(indexes["queries"], K)
    assert launch_counts() == before


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 2)
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
    assert [r["name"] for r in tracing.records()] == ["a", "b"]
    assert tracing.counters()["tracing.dropped"] == 1
    tracing.reset()
    with tracing.span("d"):
        pass
    assert [r["name"] for r in tracing.records()] == ["d"]


def test_an_exception_closes_the_span():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("x")
    with tracing.span("after"):
        pass
    recs = tracing.records()
    assert all(r["end_ns"] is not None for r in recs)
    assert recs[-1]["name"] == "after" and recs[-1]["parent"] is None


def test_threads_keep_their_own_parents():
    tracing.enable()
    n_threads, n_spans = 8, 200
    errors = []

    def work(i):
        try:
            for _ in range(n_spans):
                with tracing.span(f"outer{i}"):
                    with tracing.span(f"inner{i}"):
                        pass
        except Exception as e:   # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors
    recs = tracing.records()
    tree = _tree(recs)
    assert len(tree) == len(recs) == 2 * n_threads * n_spans
    for r in recs:
        if r["name"].startswith("inner"):
            assert tree[r["parent"]]["name"] == "outer" + r["name"][5:]
        else:
            assert r["parent"] is None


def test_counters_lose_no_update_across_threads():
    n_threads, n_adds = 8, 5000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [tracing.count("x") for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert tracing.counters()["x"] == n_threads * n_adds


def test_device_counters_add_read_and_reset():
    """A device counter is one int64 a kernel adds to: the same tensor on
    each call, read beside the host counters, and let go by a reset."""
    c = tracing.device_counter("t.dev", "cpu")
    assert c.dtype == torch.int64 and c.shape == (1,) and int(c) == 0
    assert tracing.device_counter("t.dev", torch.device("cpu")) is c
    c.add_(3)
    tracing.device_counter("t.dev", "cpu").add_(2)
    tracing.count("t.host", 4)
    assert tracing.counters() == {"t.dev": 5, "t.host": 4}
    assert launch_counts() == dict.fromkeys(WRAPPERS, 0)
    tracing.reset(["t.host"])
    assert tracing.counters() == {"t.dev": 5}
    tracing.reset(["t.dev"])
    assert tracing.counters() == {}
    fresh = tracing.device_counter("t.dev", "cpu")
    assert fresh is not c and int(fresh) == 0
    fresh.add_(7)
    tracing.reset()
    assert tracing.counters() == {}
    assert int(tracing.device_counter("t.dev", "cpu")) == 0


def test_device_counter_is_made_once_across_threads():
    """Threads asking for one counter at once all get the same tensor."""
    n_threads = 8
    got, barrier = [None] * n_threads, threading.Barrier(n_threads)

    def work(i):
        barrier.wait(timeout=60)
        got[i] = tracing.device_counter("t.race", "cpu")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert all(t is got[0] for t in got) and got[0] is not None


def test_no_device_counter_is_read_inside_a_span(indexes, monkeypatch):
    """Spans, counts and the search paths never read the counters (on the
    card that read waits for the device): only ``counters()`` does."""
    tracing.device_counter("t.dev", "cpu").add_(1)

    def refuse(*a, **k):
        raise AssertionError("the counters were read inside a span")
    monkeypatch.setattr(tracing, "counters", refuse)
    tracing.enable()
    with tracing.span("search"):
        tracing.count("t.host")
        tracing.device_counter("t.dev", "cpu").add_(1)
        indexes["exact"].search(indexes["queries"], K)
        indexes["ivf"].search(indexes["queries"], K)
        streaming_topk(torch.zeros(3, 2000), K, use_kernel=True)
    assert [r["name"] for r in tracing.records()][:2] == \
        ["search", "search"]
    monkeypatch.undo()
    assert tracing.counters()["t.dev"] == 2


@pytest.mark.chip
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card (torch.cuda.is_available() "
                    "is False)")
@pytest.mark.parametrize("k,block_d", [(100, 4096), (10, 1024)],
                         ids=["cta_k100", "warp_k10"])
def test_tie_counters_on_the_card(k, block_d):
    """On the card: scores of three values (a third of each tile at the
    top) send stage 1's tiles down the tie path (the radix select at k =
    100, the warp kernel's rounds at k = 10) and stage 2's rows down the
    overflow path; distinct scores leave both counters at 0.  Ids and
    value bits equal ``topk_ref``'s either way.  The last block is half a
    block: a last block of 100 columns, whose heads lie far below the
    others', sends stage 2 down the overflow path on distinct scores too
    (61 of 64 rows at k = 100)."""
    card = "cuda:0"
    g = torch.Generator(device=card).manual_seed(28)
    n_q, n_d = 64, 8 * block_d + block_d // 2
    n_blocks = -(-n_d // block_d)
    cases = {
        "distinct": torch.randn(n_q, n_d, generator=g, device=card),
        "three_values": 0.25 * torch.randint(
            0, 3, (n_q, n_d), generator=g, device=card).float()}
    for label, scores in cases.items():
        tracing.reset()
        vals, ids = streaming_topk(scores, k, use_kernel=True,
                                   block_d=block_d)
        got = tracing.counters()
        want_v, want_i = topk_ref(scores.cpu(), k)
        assert torch.equal(vals.cpu().view(torch.int32),
                           want_v.view(torch.int32)), label
        assert torch.equal(ids.cpu(), want_i), label
        assert got["topk_blocks.tiles"] == n_q * n_blocks
        tiles, rows = got["topk_blocks.tie_tiles"], got["topk_merge.tie_rows"]
        if label == "distinct":
            assert tiles == 0 and rows == 0, got
        else:
            assert 0 < tiles <= n_q * n_blocks and rows == n_q, got
