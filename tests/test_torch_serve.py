"""The serving front door in ``repro_torch``: ``RetrievalService`` over the
port's indexes, on the CPU.

Replays what ``tests/test_serve.py``, ``test_service.py``, ``test_cache.py``,
``test_limits.py`` and ``test_storage.py::
test_service_resident_budget_and_tier_stats`` pin for ``repro``: a query
through the front door equals direct search; stage, promote, rollback and
the canary gate; update and compact on mutable indexes; per-request nprobe
on a mutable IVF index; admission bounds under contending producers; the
result cache and rate limits; the tier gauges of a store-backed version.
One artifact served by both packages' services gives the same ids.  No
assertion rests on a sleep, and every thread is joined with a timeout.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval.api as r_api  # noqa: E402
from repro.serve import RetrievalService as RService  # noqa: E402
from repro_torch.retrieval import (DenseIndex, IndexSpec,  # noqa: E402
                                   build_index, load_index, load_index_meta,
                                   save_index)
from repro_torch.serve import (CanaryFailed, QueryOptions,  # noqa: E402
                               QueueFull, RateLimited, RateLimiter,
                               RetrievalService, ServeEngine, ServiceClosed,
                               ShadowScorer)
from repro_torch.serve.router import load_engine  # noqa: E402
from tools.repro_lint.runtime import LockSanitizer  # noqa: E402

CPU = "cpu"
D = 32
K = 5
JOIN_S = 60


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    return {
        "docs1": rng.standard_normal((400, D)).astype(np.float32),
        "docs2": rng.standard_normal((400, D)).astype(np.float32),
        "queries": rng.standard_normal((64, D)).astype(np.float32),
    }


def _build(spec, docs, corpus):
    return build_index(spec, docs, corpus["queries"],
                       rng=torch.Generator().manual_seed(0), device=CPU)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _bits(v):
    return _np(v).astype(np.float32).view(np.uint32)


def _join_all(threads):
    for th in threads:
        th.join(timeout=JOIN_S)
    assert not any(th.is_alive() for th in threads), "a thread hung"


@pytest.fixture(scope="module")
def artifacts(corpus, tmp_path_factory):
    """Two int8 artifacts over disjoint corpora (v1 and v2 of one KB)."""
    root = tmp_path_factory.mktemp("serve")
    spec = IndexSpec(method="int8", backend="torch", post=False)
    paths = []
    for tag in ("docs1", "docs2"):
        p = str(root / f"{tag}.npz")
        save_index(_build(spec, corpus[tag], corpus), p)
        paths.append(p)
    return paths


def _expected(path, q, k=K):
    return load_index(path, device=CPU).search(q, k)


def make_mutable(corpus, **spec_kw):
    return _build(IndexSpec(method="pca_int8", dim=16, backend="torch",
                            post=False, mutable=True, **spec_kw),
                  corpus["docs1"], corpus)


# ---------------------------------------------------------------------------
# query == direct search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "int8", "ivf_kernel"])
def test_query_matches_direct_search(corpus, kind):
    spec = {"dense": IndexSpec(method="dense"),
            "int8": IndexSpec(method="pca_int8", dim=16, post=False),
            "ivf_kernel": IndexSpec(method="pca_int8", dim=16, post=False,
                                    backend="kernel", ivf=(8, 4))}[kind]
    idx = _build(spec, corpus["docs1"], corpus)
    q = corpus["queries"][:16]                 # a whole bucket: no padding
    with RetrievalService(max_batch=16) as svc:
        svc.register("kb", idx)
        handle = svc.query(q, QueryOptions(index="kb", k=K))
        res = handle.result(timeout=JOIN_S)
        assert handle.done() and res.ids.shape == (16, K)
        assert isinstance(res.ids, np.ndarray) and res.latency_s >= 0
    want_v, want_i = idx.search(q, K)
    np.testing.assert_array_equal(res.ids, _np(want_i))
    np.testing.assert_array_equal(_bits(res.scores), _bits(want_v))


def test_query_options_and_names_are_validated(corpus):
    with RetrievalService() as svc:
        svc.register("kb", DenseIndex(corpus["docs1"], device=CPU))
        res = svc.query(corpus["queries"][0], index="kb", k=3).result(JOIN_S)
        assert res.ids.shape == (1, 3)
        with pytest.raises(TypeError):
            svc.query(corpus["queries"][:2], QueryOptions(index="kb"), k=3)
        with pytest.raises(ValueError):
            QueryOptions(index="kb", k=0)
        with pytest.raises(ValueError):
            svc.query(corpus["queries"][:0], index="kb")
        with pytest.raises(KeyError, match="unknown index 'nope'"):
            svc.query(corpus["queries"][:2], index="nope")
        with pytest.raises(ValueError, match="already registered"):
            svc.register("kb", DenseIndex(corpus["docs1"], device=CPU))
        with pytest.raises(ValueError, match="nprobe"):
            svc.query(corpus["queries"][:2], index="kb", nprobe=2)
        assert svc.pending_queries == 0


def test_engine_per_request_k_and_nprobe(corpus):
    idx = _build(IndexSpec(method="pca_int8", dim=16, post=False,
                           ivf=(16, 16), kmeans_iters=4), corpus["docs1"],
                 corpus)
    engine = ServeEngine(idx, k=K)
    q = corpus["queries"][:8]
    rids = [engine.submit(q), engine.submit(q, k=2),
            engine.submit(q, nprobe=1)]
    out = engine.drain()
    np.testing.assert_array_equal(out[rids[0]].ids, _np(idx.search(q, K)[1]))
    np.testing.assert_array_equal(out[rids[1]].ids, _np(idx.search(q, 2)[1]))
    np.testing.assert_array_equal(out[rids[2]].ids,
                                  _np(idx.search(q, K, nprobe=1)[1]))
    s = engine.stats()
    assert s["requests_served"] == s["requests_submitted"] == 3


def test_lazy_artifact_and_sharded_placement(artifacts, corpus):
    p1, _ = artifacts
    q = corpus["queries"][:4]
    with RetrievalService() as svc:
        svc.register("kb", artifact=p1, lazy=True, device=CPU)
        row = svc.stats()["indexes"]["kb"]["versions"][1]
        assert not row["loaded"] and row["kind"] == "CompressedIndex"
        res = svc.query(q, index="kb", k=K).result(JOIN_S)
        np.testing.assert_array_equal(res.ids, _np(_expected(p1, q)[1]))
        assert svc.stats()["indexes"]["kb"]["versions"][1]["loaded"]
        # sharded placement waits for the sharding slice (ROADMAP A.12)
        with pytest.raises(NotImplementedError, match="A.12"):
            svc.register("sharded", artifact=p1, shard=object(), device=CPU)
        assert "sharded" not in svc.indexes()
    with pytest.raises(NotImplementedError, match="A.12"):
        load_engine(p1, mesh=object(), device=CPU)


def test_one_artifact_serves_the_same_ids_in_both_packages(artifacts,
                                                           corpus):
    p1, _ = artifacts
    q = corpus["queries"][:16]
    with RetrievalService() as svc, RService() as r_svc:
        svc.register("kb", artifact=p1, device=CPU)
        r_svc.register("kb", artifact=p1)
        got = svc.query(q, index="kb", k=K).result(JOIN_S)
        want = r_svc.query(q, index="kb", k=K).result(JOIN_S)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# hot swap: stage / canary / promote / rollback
# ---------------------------------------------------------------------------


def test_stage_promote_rollback_lifecycle(artifacts, corpus):
    p1, p2 = artifacts
    q = corpus["queries"][:8]
    want1, want2 = _np(_expected(p1, q)[1]), _np(_expected(p2, q)[1])
    assert not np.array_equal(want1, want2)
    with RetrievalService() as svc:
        svc.register("kb", artifact=p1, device=CPU)
        with pytest.raises(ValueError, match="nothing staged"):
            svc.promote("kb")
        with pytest.raises(ValueError, match="no previous version"):
            svc.rollback("kb")
        v2 = svc.stage("kb", artifact=p2, device=CPU)
        res = svc.query(q, index="kb", k=K).result(JOIN_S)
        np.testing.assert_array_equal(res.ids, want1)  # staged serves nothing
        assert svc.promote("kb") == v2
        np.testing.assert_array_equal(
            svc.query(q, index="kb", k=K).result(JOIN_S).ids, want2)
        table = svc.stats()["indexes"]["kb"]
        assert (table["live"], table["staged"], table["previous"]) == \
            (v2, None, 1)
        assert svc.rollback("kb") == 1
        np.testing.assert_array_equal(
            svc.query(q, index="kb", k=K).result(JOIN_S).ids, want1)


def test_canary_gates_promote(artifacts, corpus):
    p1, p2 = artifacts
    q = corpus["queries"]
    with RetrievalService() as svc:
        svc.register("kb", artifact=p1, device=CPU)
        svc.stage("kb", artifact=p1, canary_every=1, device=CPU)
        with pytest.raises(CanaryFailed, match="no traffic"):
            svc.promote("kb", min_overlap=0.5)
        for i in range(4):
            svc.query(q[i * 8:(i + 1) * 8], index="kb", k=K).result(JOIN_S)
        c = svc.canary("kb")
        assert c["batches"] >= 4 and c["overlap"] == pytest.approx(1.0)
        v2 = svc.promote("kb", min_overlap=0.99)
        svc.stage("kb", artifact=p2, canary_every=1, device=CPU)
        for i in range(4):
            svc.query(q[i * 8:(i + 1) * 8], index="kb", k=K).result(JOIN_S)
        assert svc.canary("kb")["overlap"] < 0.5
        with pytest.raises(CanaryFailed, match="overlap"):
            svc.promote("kb", min_overlap=0.9)
        assert svc.promote("kb") > v2
        assert svc.canary("kb") is None


def test_shadow_for_compressed_tracks_overlap(corpus):
    idx = _build(IndexSpec(method="pca_int8", dim=16, post=False),
                 corpus["docs1"], corpus)
    shadow = ShadowScorer.for_compressed(idx, corpus["docs1"], every=2)
    engine = ServeEngine(idx, k=K, shadow=shadow)
    for i in range(4):
        engine.submit(corpus["queries"][i * 8:(i + 1) * 8])
        engine.drain()
    assert len(shadow.overlaps) == 2
    assert 0.5 < shadow.mean_overlap <= 1.0
    assert engine.stats()["shadow_batches"] == 2


def test_hot_swap_under_concurrent_load(artifacts, corpus):
    """4 producers submit through a mid-traffic stage + promote, under the
    lock sanitizer: nothing lost, each result ranks against one version,
    post-promote results equal a fresh load of the new artifact."""
    p1, p2 = artifacts
    queries = corpus["queries"]
    want1, want2 = (_np(_expected(p, queries)[1]) for p in (p1, p2))
    svc = RetrievalService(max_batch=32)
    svc.register("kb", artifact=p1, device=CPU)
    san = LockSanitizer().wrap(svc, "_lock", "_admission", "_update_lock")
    n_threads, per_thread = 4, 12
    promote_done = threading.Event()
    outcomes = [[] for _ in range(n_threads)]
    errors = []

    def producer(t):
        rng = np.random.default_rng(100 + t)
        try:
            for _ in range(per_thread):
                off, n = int(rng.integers(0, 56)), int(rng.integers(1, 9))
                post = promote_done.is_set()
                res = svc.query(queries[off:off + n], index="kb",
                                k=K).result(timeout=JOIN_S)
                outcomes[t].append((off, n, post, res))
        except Exception as e:                      # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    with san:
        for th in threads:
            th.start()
        svc.stage("kb", artifact=p2, device=CPU)
        svc.promote("kb")
        promote_done.set()
        _join_all(threads)
        final = svc.query(queries, index="kb", k=K).result(JOIN_S)
        svc.close()
    san.assert_clean()
    assert not errors
    for per in outcomes:
        assert len(per) == per_thread
        for off, n, post, res in per:
            m1 = np.array_equal(res.ids, want1[off:off + n])
            m2 = np.array_equal(res.ids, want2[off:off + n])
            assert m2 if post else (m1 or m2)
    np.testing.assert_array_equal(final.ids, want2)
    stats = svc.stats()
    assert stats["requests_served"] == n_threads * per_thread + 1
    assert stats["pending_queries"] == stats["requests_rejected"] == 0


# ---------------------------------------------------------------------------
# live updates on mutable indexes
# ---------------------------------------------------------------------------


def test_update_and_compact_keep_rankings_and_ids(corpus):
    q = corpus["queries"][:8]
    with RetrievalService() as svc:
        svc.register("kb", make_mutable(corpus))
        rep = svc.update("kb", add=corpus["docs2"][:50], delete=[0, 7, 410])
        assert (rep["added"], rep["deleted"]) == (50, 3)
        assert rep["gid_range"] == (400, 450) and rep["n_live"] == 447
        before = svc.query(q, index="kb", k=K).result(JOIN_S)
        assert not set(before.ids.ravel().tolist()) & {0, 7, 410}
        row = svc.stats()["indexes"]["kb"]["versions"][1]
        assert row["mutable"]["segments"] == 1
        assert row["mutable"]["drift"]["n_added"] == 50
        assert svc.compact("kb") == 2
        after = svc.query(q, index="kb", k=K).result(JOIN_S)
        np.testing.assert_array_equal(before.ids, after.ids)
        table = svc.stats()["indexes"]["kb"]
        assert table["live"] == 2 and table["previous"] == 1
        assert svc.stats()["compactions_run"] == 1
        assert svc.update("kb", delete=[449])["deleted"] == 1
        with pytest.raises(KeyError, match="unknown doc ids"):
            svc.update("kb", add=corpus["docs2"][:20], delete=[999_999])
        assert svc.update("kb", add=corpus["docs2"][:4])["gid_range"] == \
            (450, 454)                             # the bad update left none


def test_update_rules(corpus):
    with RetrievalService() as svc:
        svc.register("flat", DenseIndex(corpus["docs1"], device=CPU))
        with pytest.raises(TypeError, match="immutable"):
            svc.update("flat", add=corpus["docs2"][:4])
        with pytest.raises(ValueError, match="add= .*delete="):
            svc.update("flat")
        svc.register("kb", make_mutable(corpus))
        svc.update("kb", add=corpus["docs2"][:20], delete=[5])
        staged = svc.compact("kb", promote=False, canary_every=1)
        with pytest.raises(RuntimeError, match="frozen"):
            svc.update("kb", delete=[6])
        for i in range(2):
            svc.query(corpus["queries"][i * 8:(i + 1) * 8], index="kb",
                      k=K).result(JOIN_S)
        assert svc.canary("kb")["overlap"] == pytest.approx(1.0)
        assert svc.promote("kb", min_overlap=0.99) == staged
        assert svc.update("kb", delete=[6])["deleted"] == 1


def test_service_nprobe_on_mutable_ivf(corpus):
    q = corpus["queries"][:8]
    idx = make_mutable(corpus, ivf=(8, 4))
    with RetrievalService() as svc:
        svc.register("kb", idx)
        for nprobe in (8, 1):
            res = svc.query(q, index="kb", k=K, nprobe=nprobe).result(JOIN_S)
            np.testing.assert_array_equal(
                res.ids, _np(idx.search(q, K, nprobe=nprobe)[1]))
        svc.update("kb", add=corpus["docs2"][:30], delete=[2, 5])
        res = svc.query(q, index="kb", k=K, nprobe=8).result(JOIN_S)
        np.testing.assert_array_equal(res.ids,
                                      _np(idx.search(q, K, nprobe=8)[1]))
        svc.compact("kb")
        res = svc.query(q, index="kb", k=K, nprobe=8).result(JOIN_S)
        assert res.ids.shape == (8, K)


# ---------------------------------------------------------------------------
# admission, cache, rate limits
# ---------------------------------------------------------------------------


def test_admission_exact_at_bound_under_contention(corpus):
    bound = 16
    svc = RetrievalService(start=False, max_pending_queries=bound)
    svc.register("kb", DenseIndex(corpus["docs1"], device=CPU))
    n_threads, per_thread = 8, 8
    admitted, rejected = [], []
    gate = threading.Barrier(n_threads)

    def producer(t):
        gate.wait(timeout=JOIN_S)
        for i in range(per_thread):
            try:
                admitted.append(svc.query(corpus["queries"][t: t + 1],
                                          index="kb"))
            except QueueFull:
                rejected.append((t, i))

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    _join_all(threads)
    assert len(admitted) == bound
    assert len(rejected) == n_threads * per_thread - bound
    s = svc.stats()
    assert s["requests_admitted"] == s["queue_high_water"] == bound
    assert svc.drain_once() == bound
    for h in admitted:
        h.result(timeout=JOIN_S)
    svc.query(corpus["queries"][:6], index="kb")
    with pytest.raises(QueueFull):                   # whole block or nothing
        svc.query(corpus["queries"][:11], index="kb")
    assert svc.pending_queries == 6
    h = svc.query(corpus["queries"][:2], index="kb")
    svc.close(drain=False)
    with pytest.raises(ServiceClosed):
        h.result(timeout=1)
    assert svc.pending_queries == 0


def test_cache_hit_is_bit_identical_and_invalidated(corpus):
    q = corpus["queries"][:8]
    with RetrievalService(start=False, cache_rows=512) as svc:
        svc.register("kb", make_mutable(corpus))
        h1 = svc.query(q, index="kb", k=K)
        assert not h1.done()
        svc.drain_once()
        r1 = h1.result(JOIN_S)
        h2 = svc.query(q, index="kb", k=K)
        assert h2.done()                            # a hit resolves at once
        r2 = h2.result()
        np.testing.assert_array_equal(_bits(r1.scores), _bits(r2.scores))
        np.testing.assert_array_equal(r1.ids, r2.ids)
        svc.update("kb", delete=[int(r1.ids[0, 0])])
        h3 = svc.query(q, index="kb", k=K)
        assert not h3.done()                        # epoch bumped: a miss
        svc.drain_once()
        assert int(r1.ids[0, 0]) not in h3.result(JOIN_S).ids[0]
        assert svc.stats()["cache_hits"] == 1


def test_rate_limit_sheds_before_admission(corpus):
    now = [0.0]
    svc = RetrievalService(start=False,
                           limiter=RateLimiter(clock=lambda: now[0]))
    svc.register("kb", DenseIndex(corpus["docs1"], device=CPU))
    svc.set_rate_limit("kb", qps=10.0, burst=16.0, lanes={"bulk": 0.5})
    svc.query(corpus["queries"][:8], index="kb", lane="bulk")
    with pytest.raises(RateLimited):
        svc.query(corpus["queries"][:8], index="kb", lane="bulk")
    assert svc.pending_queries == 8
    s = svc.stats()
    assert s["requests_rate_limited"] == 1 and s["requests_admitted"] == 1
    now[0] += 10.0                                  # the bucket refills
    svc.query(corpus["queries"][:8], index="kb", lane="bulk")
    svc.drain_once()
    svc.close()


# ---------------------------------------------------------------------------
# a tiered (v3, store-backed) version behind the front door
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numerics", ["torch", "kernel"])
def test_service_resident_budget_and_tier_stats(corpus, tmp_path, numerics):
    idx = _build(IndexSpec(method="pca_int8", dim=16, post=False,
                           backend=numerics, ivf=(16, 6)),
                 corpus["docs1"], corpus)
    p3 = str(tmp_path / "kb.v3")
    save_index(idx, p3, chunked=True)
    enc = load_index_meta(p3)["encoded_nbytes"]
    q = corpus["queries"][:32]
    with RetrievalService(max_batch=32) as svc:
        svc.register("kb", artifact=p3, resident_budget=enc // 4,
                     device=CPU)
        r1 = svc.query(q, index="kb").result(JOIN_S)
        direct = load_index(p3, resident=enc // 4, device=CPU).search(q, 10)
        np.testing.assert_array_equal(r1.ids, _np(direct[1]))
        np.testing.assert_array_equal(_bits(r1.scores), _bits(direct[0]))
        tier = svc.stats()["indexes"]["kb"]["versions"][1]["tier"]
        assert tier["kind"] == "mmap" and tier["budget_bytes"] == enc // 4
        assert tier["misses"] > 0 and tier["bytes_resident"] <= enc // 4
        svc.stage("kb", artifact=p3, resident_budget="all", device=CPU)
        svc.promote("kb")
        r2 = svc.query(q, index="kb").result(JOIN_S)
        np.testing.assert_array_equal(r1.ids, r2.ids)
        np.testing.assert_array_equal(_bits(r1.scores), _bits(r2.scores))
        assert "tier" not in svc.stats()["indexes"]["kb"]["versions"][2]
    # repro's service over the same artifact at the same budget: same ids
    # and the same tier counters after the same query
    if numerics == "torch":
        with RService(max_batch=32) as r_svc:
            r_svc.register("kb", artifact=p3, resident_budget=enc // 4)
            want = r_svc.query(jnp.asarray(q), index="kb").result(JOIN_S)
            r_tier = r_svc.stats()["indexes"]["kb"]["versions"][1]["tier"]
        np.testing.assert_array_equal(r1.ids, want.ids)
        assert r_tier == tier
        assert r_api.load_index_meta(p3)["encoded_nbytes"] == enc
