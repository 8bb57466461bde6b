"""RetrievalService over sharded indexes in ``repro_torch``, on the CPU.

Replays what ``tests/test_sharded_service.py`` pins for ``repro``: the
front door serving a sharded index returns what it returns for the
single-host index — ids and score bytes — for every scorer backend,
through a live ``update()`` and a ``compact()`` (fold + re-shard), with no
request lost; staging a sharded version is all-or-none (one shard failing
placement leaves the registry untouched, the retried stage promotes and
serves the artifact's bytes); the stats carry a per-shard rollup.  The
meshes hold every shard on ``device="cpu"``; every thread is joined with a
timeout.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro_torch.parallel.placement as placement  # noqa: E402
from repro_torch.retrieval.api import (IndexSpec, ShardSpec,  # noqa: E402
                                       build_index, load_index, save_index)
from repro_torch.serve import (QueryOptions, RetrievalService,  # noqa: E402
                               ServiceStats, ShardStats, VersionStats)
from repro_torch.serve.router import load_engine  # noqa: E402

CPU = "cpu"
K = 10
JOIN_S = 60
BASE = (("CenterNorm", {}), ("PCA", {"dim": 32}))
TAILS = {"float": (), "fp16": (("FloatCast", {}),),
         "int8": (("Int8Quantizer", {}),),
         "onebit": (("OneBitQuantizer", {"offset": 0.5}),)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {"docs": rng.standard_normal((515, 64)).astype(np.float32),
            "queries": rng.standard_normal((64, 64)).astype(np.float32),
            "extra": rng.standard_normal((24, 64)).astype(np.float32)}


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def artifact(data, tmp_path_factory):
    """A single-host int8 IVF artifact (kernel numerics: the fused path)."""
    spec = IndexSpec(stages=BASE + TAILS["int8"], ivf=(12, 6),
                     backend="kernel")
    idx = build_index(spec, data["docs"], data["queries"][:16], device=CPU)
    path = str(tmp_path_factory.mktemp("sharded_serve") / "kb.npz")
    save_index(idx, path)
    return path, idx


@pytest.mark.parametrize("numerics", ["torch", "kernel"])
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_sharded_service_bit_parity(data, tail, numerics):
    """Sharded serving ≡ single-host in ids and score bytes, through a
    live update and a compaction, with zero lost requests."""
    spec = IndexSpec(stages=BASE + TAILS[tail], ivf=(12, 6),
                     backend=numerics, mutable=True)
    q = data["queries"]
    with RetrievalService() as svc:
        svc.register("single", index=build_index(spec, data["docs"], q[:16],
                                                 device=CPU))
        svc.register("sharded", index=build_index(
            dataclasses.replace(spec, shard=ShardSpec(shards=4)),
            data["docs"], q[:16], device=CPU))

        def check():
            out = {}
            for ix in ("single", "sharded"):
                res = svc.query(q[:12], QueryOptions(index=ix, k=K)).result(
                    timeout=JOIN_S)
                out[ix] = (res.ids, res.scores.tobytes())
            np.testing.assert_array_equal(out["single"][0],
                                          out["sharded"][0])
            assert out["single"][1] == out["sharded"][1]

        check()                                     # clean stream
        for ix in ("single", "sharded"):            # live delta lands
            svc.update(ix, add=data["extra"])
        for ix in ("single", "sharded"):
            svc.update(ix, delete=range(515, 527))
        check()
        for ix in ("single", "sharded"):            # fold + re-shard
            svc.compact(ix)
        check()
        stats = svc.stats()
        rows = stats["indexes"]["sharded"]["versions"][2]["shards"]
        assert len(rows) == 4 and sum(r["n_docs"] for r in rows) == 527
        assert "shards" not in stats["indexes"]["single"]["versions"][2]
        assert stats["requests_submitted"] - stats["requests_served"] \
            + stats["queue_depth"] == 0


def test_multi_shard_promote_all_or_none(artifact, data):
    """Shard 2 of 4 fails placement → the stage raises and the registry is
    untouched; the retried stage promotes and serves the artifact's bytes,
    with a 4-row shard rollup."""
    path, idx = artifact
    q = data["queries"][:8]
    sh = ShardSpec(shards=4)
    with RetrievalService() as svc:
        svc.register("kb", artifact=path, shard=sh, device=CPU)

        def hook(shard_id, n_shards):
            if shard_id == 2:
                raise RuntimeError("injected shard-2 placement failure")

        placement.SHARD_PLACEMENT_HOOK = hook
        try:
            with pytest.raises(RuntimeError, match="shard-2"):
                svc.stage("kb", artifact=path, shard=sh, device=CPU)
        finally:
            placement.SHARD_PLACEMENT_HOOK = None
        st = svc.stats()["indexes"]["kb"]
        assert st["staged"] is None and st["live"] == 1
        assert sorted(st["versions"]) == [1]
        vid = svc.stage("kb", artifact=path, shard=sh, device=CPU)
        assert svc.promote("kb") == vid == 3    # vid 2 burned by the abort
        res = svc.query(q, QueryOptions(index="kb", k=K)).result(JOIN_S)
        v0, i0 = idx.search(q, K)
        np.testing.assert_array_equal(res.ids, _np(i0))
        assert res.scores.tobytes() == _np(v0).tobytes()
        rollup = svc.stats()["indexes"]["kb"]["versions"][vid]["shards"]
        assert [r["shard"] for r in rollup] == [0, 1, 2, 3]
        assert sum(r["n_docs"] for r in rollup) == len(idx)
        assert all(r["n_lists"] >= 1 for r in rollup)


def test_register_shard_places_and_rolls_up(artifact, data):
    path, idx = artifact
    q = data["queries"][:8]
    with RetrievalService(start=False) as svc:
        svc.register("kb", artifact=path,
                     shard=ShardSpec(shards=2, replicas=2), device=CPU)
        h = svc.query(q, QueryOptions(index="kb", k=5))
        svc.drain_once()
        res = h.result(timeout=JOIN_S)
        want_v, want_i = idx.search(q, 5)
        np.testing.assert_array_equal(res.ids, _np(want_i))
        assert res.scores.tobytes() == _np(want_v).tobytes()
        row = svc.stats()["indexes"]["kb"]["versions"][1]
        assert row["kind"] == "IVFIndex"       # the artifact's own kind
        assert sum(s["n_docs"] for s in row["shards"]) == len(idx)


def test_register_failure_leaves_registry_clean(artifact, tmp_path):
    path, _ = artifact
    with RetrievalService(start=False) as svc:
        with pytest.raises(Exception):
            svc.register("kb", artifact=str(tmp_path / "missing.npz"))
        # a spec the devices cannot hold fails at placement, before any
        # entry exists
        with pytest.raises(ValueError, match="only 1 are available"):
            svc.register("kb", artifact=path, shard=ShardSpec(shards=2),
                         device=[CPU])
        assert svc.indexes() == []
        with pytest.raises(ValueError, match="exactly one"):
            svc.register("kb")                 # neither index nor artifact
        assert svc.indexes() == []


def test_stage_placement_failure_is_all_or_none(artifact):
    path, _ = artifact
    sh = ShardSpec(shards=1)
    with RetrievalService(start=False) as svc:
        svc.register("kb", artifact=path, shard=sh, device=CPU)
        before = svc.stats()["indexes"]["kb"]

        def hook(shard_id, n_shards):
            raise RuntimeError("injected placement failure")

        placement.SHARD_PLACEMENT_HOOK = hook
        try:
            with pytest.raises(RuntimeError, match="injected"):
                svc.stage("kb", artifact=path, shard=sh, device=CPU)
        finally:
            placement.SHARD_PLACEMENT_HOOK = None
        after = svc.stats()["indexes"]["kb"]
        assert after["staged"] is None
        assert after["live"] == before["live"]
        assert sorted(after["versions"]) == sorted(before["versions"])
        svc.stage("kb", artifact=path, shard=sh, device=CPU)
        assert svc.promote("kb") == 3


def test_stats_typed_matches_dict_shape(artifact, data):
    path, _ = artifact
    with RetrievalService(start=False) as svc:
        svc.register("kb", artifact=path, shard=ShardSpec(shards=3),
                     device=CPU)
        h = svc.query(data["queries"][:8], QueryOptions(index="kb", k=5))
        svc.drain_once()
        h.result(timeout=JOIN_S)
        typed = svc.stats_typed()
        assert isinstance(typed, ServiceStats)
        vs = typed.indexes["kb"].versions[1]
        assert isinstance(vs, VersionStats) and len(vs.shards) == 3
        assert all(isinstance(s, ShardStats) for s in vs.shards)
        assert typed.to_dict() == svc.stats()


def test_load_engine_shard_and_deprecated_mesh(artifact, data):
    path, idx = artifact
    q = data["queries"][:4]
    engine = load_engine(path, shard=ShardSpec(shards=2), device=CPU)
    assert type(engine.index).__name__ == "ShardedIVFIndex"
    mesh = ShardSpec(shards=2).build_mesh(CPU)
    with pytest.warns(DeprecationWarning, match="mesh"):
        old = load_engine(path, mesh=mesh, shard=ShardSpec())
    assert old.index.n_doc_shards == 2          # the mesh's, not the spec's
    for eng in (engine, old):
        v, i = eng.index.search(q, K)
        want = idx.search(q, K)
        np.testing.assert_array_equal(_np(i), _np(want[1]))
        assert _np(v).tobytes() == _np(want[0]).tobytes()
    # a sharded artifact brings its own placement to the front door
    sharded_path = path.replace("kb.npz", "kb_sharded.npz")
    load_index(path, shard=ShardSpec(shards=4), device=CPU).save(sharded_path)
    with RetrievalService(start=False) as svc:
        svc.register("kb", artifact=sharded_path, device=CPU)
        row = svc.stats()["indexes"]["kb"]["versions"][1]
        assert row["kind"] == "ShardedIVFIndex" and len(row["shards"]) == 4
