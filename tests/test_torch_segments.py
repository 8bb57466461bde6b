"""SegmentedIndex in ``repro_torch``: live adds + tombstones == a fresh build.

The port's counterparts of ``tests/test_segments.py`` — a segmented index
with delta segments and tombstones ranks like a fresh index over the
surviving corpus, per scorer backend (both numerics: ``torch`` and the
kernels' plain versions), under IVF at any probe width, through
compaction and the version-2 artifact — plus the crossings with
``repro``: a ``repro``-built v2 artifact loads and ranks the same in the
port, a port-built one in ``repro``, and one add/delete sequence replayed
on both packages from a shared v1 artifact gives the same ids.  Ids are
equal; 1-bit score bits are equal; other scores allclose (f32 sums).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval.api as r_api  # noqa: E402
from repro.retrieval.segments import SegmentedIndex as RSegmented  # noqa: E402
import repro_torch.retrieval.api as p_api  # noqa: E402
from repro_torch.core import (CenterNorm, CompressionPipeline,  # noqa: E402
                              FloatCast, Int8Quantizer, OneBitQuantizer, PCA)
from repro_torch.retrieval import (CompressedIndex, DenseIndex,  # noqa: E402
                                   DriftMonitor, IVFIndex, SegmentedIndex)
from repro_torch.retrieval.kmeans import assign  # noqa: E402
from repro_torch.retrieval.scorers import apply_float_stages  # noqa: E402
from repro_torch.retrieval.segments import fitted_center_mean  # noqa: E402

D = 48
K = 7
CPU = "cpu"
TAILS = {
    "float": [],
    "fp16": [FloatCast()],
    "int8": [Int8Quantizer()],
    "int8_post": [CenterNorm(), Int8Quantizer()],   # the fused 24× encode
    "onebit": [OneBitQuantizer(0.5)],
}
DEAD = [3, 10, 11, 299, 305]      # three main rows, two delta rows


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "docs": rng.standard_normal((300, D)).astype(np.float32),
        "extra": rng.standard_normal((60, D)).astype(np.float32),
        "queries": rng.standard_normal((12, D)).astype(np.float32),
    }


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_ranking(got, want, exact=False, id_map=None):
    (gv, gi), (wv, wi) = tuple(map(_np, got)), tuple(map(_np, want))
    if id_map is not None:
        wi = np.where(wi >= 0, id_map[np.maximum(wi, 0)], -1)
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
    else:
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)


def _alive(n=360):
    return np.setdiff1d(np.arange(n), DEAD)


# ---------------------------------------------------------------------------
# exact-search parity per scorer backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numerics", ["torch", "kernel"])
@pytest.mark.parametrize("backend", sorted(TAILS))
def test_parity_with_fresh_build_per_backend(data, backend, numerics):
    pipe = CompressionPipeline([CenterNorm(), PCA(24)] +
                               copy.deepcopy(TAILS[backend]))
    main = CompressedIndex.build(data["docs"], data["queries"], pipe,
                                 backend=numerics, device=CPU)
    seg = SegmentedIndex(main)
    seg.add(data["extra"])
    assert seg.delete(DEAD) == len(DEAD)
    assert len(seg) == 360 - len(DEAD)

    all_docs = np.concatenate([data["docs"], data["extra"]])
    alive = _alive()
    fresh = CompressedIndex(pipe, backend=numerics, device=CPU)
    fresh.add(all_docs[alive])
    sv, si = seg.search(data["queries"], K)
    # fresh ids are surviving-corpus positions; map them to global ids
    _assert_ranking((sv, si), fresh.search(data["queries"], K),
                    exact=backend == "onebit", id_map=alive)

    # compaction folds the layers but keeps rankings and global ids
    comp = seg.compact()
    assert isinstance(comp, SegmentedIndex) and len(comp) == len(seg)
    assert comp.n_segments == 0 and comp.n_deltas == 0
    _assert_ranking(comp.search(data["queries"], K), (sv, si),
                    exact=backend == "onebit")
    # the old index is untouched — compaction is copy-on-write
    _assert_ranking(seg.search(data["queries"], K), (sv, si), exact=True)


def test_dense_main_parity(data):
    seg = SegmentedIndex(DenseIndex(data["docs"], device=CPU))
    seg.add(data["extra"])
    seg.delete(DEAD)
    all_docs = np.concatenate([data["docs"], data["extra"]])
    alive = _alive()
    sv, si = seg.search(data["queries"], K)
    _assert_ranking((sv, si), DenseIndex(all_docs[alive], device=CPU)
                    .search(data["queries"], K), id_map=alive)
    _assert_ranking(seg.compact().search(data["queries"], K), (sv, si))


# ---------------------------------------------------------------------------
# IVF parity: same centroids, delta rows obey the same probe reachability
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numerics", ["torch", "kernel"])
@pytest.mark.parametrize("nprobe", [2, 4, 16])
def test_ivf_parity_with_equivalent_index(data, nprobe, numerics):
    """Segmented IVF == one IVF index with the same centroids holding all
    surviving rows, at narrow, medium and full probe widths (the kernel
    numerics run the fused path's plain version)."""
    pipe = CompressionPipeline([CenterNorm(), PCA(24), Int8Quantizer()])
    main = IVFIndex.build(data["docs"], data["queries"], pipe, nlist=16,
                          nprobe=4, backend=numerics, kmeans_iters=4,
                          device=CPU)
    seg = SegmentedIndex(main)
    seg.add(data["extra"])
    seg.delete(DEAD)

    ref = IVFIndex(pipe, nlist=16, nprobe=4, backend=numerics,
                   kmeans_iters=4, device=CPU)
    ref.float_stages = main.float_stages
    ref.scorer = copy.deepcopy(main.scorer)
    alive = _alive()
    x = apply_float_stages(main.float_stages, torch.from_numpy(
        np.concatenate([data["docs"], data["extra"]])[alive]), "docs")
    labels = assign(x, main.centroids).numpy()
    ref._install_routed(ref.scorer.encode_docs(x), labels, main.centroids,
                        int(x.shape[-1]))
    _assert_ranking(seg.search(data["queries"], K, nprobe=nprobe),
                    ref.search(data["queries"], K, nprobe=nprobe),
                    id_map=alive)


def test_ivf_compaction_full_probe_matches_exact(data):
    """After compaction the router is refit, so parity is checked at full
    probe width (== exact search over the surviving rows)."""
    spec = p_api.IndexSpec(method="pca_int8", dim=24, backend="torch",
                           post=False, ivf=(12, 12), kmeans_iters=4,
                           mutable=True)
    seg = p_api.build_index(spec, data["docs"], data["queries"], device=CPU)
    seg.add(data["extra"])
    seg.delete(DEAD)
    sv, si = seg.search(data["queries"], K, nprobe=12)
    comp = seg.compact()
    _assert_ranking(comp.search(data["queries"], K, nprobe=12), (sv, si))


# ---------------------------------------------------------------------------
# delete semantics, id allocation, guard rails
# ---------------------------------------------------------------------------


def test_delete_validation_and_idempotence(data):
    seg = SegmentedIndex(DenseIndex(data["docs"], device=CPU))
    assert seg.delete([5, 5, 7]) == 2
    assert seg.delete([5]) == 0                    # idempotent
    assert seg.delete([]) == 0
    with pytest.raises(KeyError):
        seg.delete([360])                          # never allocated
    with pytest.raises(KeyError):
        seg.delete([-1])
    assert len(seg) == 298 and seg.n_tombstoned == 2
    np.testing.assert_array_equal(seg.validate_ids([9, 3, 3]), [3, 9])
    np.testing.assert_array_equal(seg.validate_ids([301], n_pending_add=2),
                                  [301])


def test_deleted_ids_stay_dead_after_compaction(data):
    seg = SegmentedIndex(DenseIndex(data["docs"], device=CPU))
    seg.add(data["extra"])
    seg.delete([0, 350])
    comp = seg.compact()
    # replaying the delete log over the compacted index is a no-op
    assert comp.delete([0, 350]) == 0
    assert comp.next_gid == 360                    # allocator monotonic
    comp.add(data["extra"][:5])
    assert comp.next_gid == 365
    _, ids = comp.search(data["queries"], 360)
    got = set(ids.numpy().ravel().tolist())
    assert 0 not in got and 350 not in got
    assert 364 in got                              # fresh rows searchable


def test_add_validation_and_main_guard(data):
    main = DenseIndex(data["docs"], device=CPU)
    seg = SegmentedIndex(main)
    with pytest.raises(ValueError, match="n ≥ 1"):
        seg.add(data["extra"][:0])
    with pytest.raises(TypeError, match="cannot wrap"):
        SegmentedIndex(seg)
    with pytest.raises(ValueError, match="nprobe"):
        seg.search(data["queries"], K, nprobe=3)
    with pytest.raises(ValueError, match="empty"):
        SegmentedIndex(DenseIndex(data["docs"][:0], device=CPU))
    pipe = CompressionPipeline([CenterNorm(), PCA(8), Int8Quantizer()])
    cmain = CompressedIndex.build(data["docs"], data["queries"], pipe,
                                  backend="torch", device=CPU)
    cseg = SegmentedIndex(cmain)
    cmain.add(data["extra"])                       # out-of-band mutation
    with pytest.raises(ValueError, match="changed under"):
        cseg.search(data["queries"], K)
    residual = IVFIndex.build(data["docs"], data["queries"],
                              CompressionPipeline([CenterNorm(), PCA(8)]),
                              nlist=4, nprobe=2, kmeans_iters=2,
                              residual=True, device=CPU)
    with pytest.raises(TypeError, match="residual"):
        SegmentedIndex(residual)


def test_all_docs_deleted(data):
    seg = SegmentedIndex(DenseIndex(data["docs"][:4], device=CPU))
    seg.delete(range(4))
    assert len(seg) == 0
    with pytest.raises(ValueError, match="empty"):
        seg.compact()


def test_later_slices_raise_naming_their_slice(data, tmp_path):
    ivf = IVFIndex.build(data["docs"], data["queries"],
                         CompressionPipeline([CenterNorm(), PCA(8)]),
                         nlist=4, nprobe=2, kmeans_iters=2, device=CPU)
    seg = SegmentedIndex(ivf)
    assert seg.prefetch(data["queries"]) == 0      # fully resident
    assert SegmentedIndex(DenseIndex(data["docs"], device=CPU)) \
        .prefetch(data["queries"]) == 0
    assert seg.place() is seg
    assert seg.shard_stats() is None               # single-host, as repro
    sharded = type("ShardedIVFIndex", (), {})()
    with pytest.raises(NotImplementedError, match="A.12"):
        SegmentedIndex(sharded)
    # store-backed mains and chunked compaction came with the storage slice
    # (A.9): the fold serves back tiered, and prefetch warms its tier
    comp = seg.compact(out_path=str(tmp_path / "kb_v3"), resident=0)
    assert comp.main.store is not None and len(comp) == len(seg)
    assert comp.prefetch(data["queries"]) > 0
    with pytest.raises(TypeError, match="IVF"):
        SegmentedIndex(DenseIndex(data["docs"], device=CPU)).compact(
            out_path=str(tmp_path / "dense_v3"))


# ---------------------------------------------------------------------------
# drift monitor
# ---------------------------------------------------------------------------


def test_drift_monitor_flags_shifted_additions(data):
    pipe = CompressionPipeline([CenterNorm(), PCA(16), Int8Quantizer()])
    main = CompressedIndex.build(data["docs"], data["queries"], pipe,
                                 backend="torch", device=CPU)
    ref = fitted_center_mean(pipe)
    assert ref is not None and ref.shape == (D,) and ref.dtype == torch.float64

    in_dist = SegmentedIndex(main)
    in_dist.add(data["extra"])                     # same distribution
    shifted = SegmentedIndex(main)
    shifted.add(data["extra"] + 8.0)               # way off the fitted mean
    assert shifted.drift.mean_shift > 5 * max(in_dist.drift.mean_shift,
                                              1e-6)
    assert shifted.needs_compaction() and not in_dist.needs_compaction()
    st = shifted.mutable_stats()
    assert st["drift"]["n_added"] == 60 and st["needs_compaction"]
    assert (st["n_live"], st["n_main"], st["n_delta"], st["segments"]) == \
        (360, 300, 60, 1)


def test_drift_monitor_matches_repro(data):
    """The same docs give repro's drift statistics (float64 sums)."""
    from repro.retrieval.segments import DriftMonitor as RDrift
    ref = data["docs"].mean(axis=0)
    mine, theirs = DriftMonitor(ref), RDrift(ref)
    for block in (data["extra"], data["extra"][:7] + 1.5):
        mine.update(torch.from_numpy(block))
        theirs.update(block)
    for key, value in theirs.stats().items():
        assert mine.stats()[key] == pytest.approx(value, rel=1e-12)


def test_delta_fraction_triggers_compaction(data):
    seg = SegmentedIndex(DenseIndex(data["docs"][:64], device=CPU),
                         max_delta_fraction=0.25)
    assert not seg.needs_compaction()
    seg.add(data["extra"])                         # 60/124 ≈ 0.48 > 0.25
    assert seg.needs_compaction()
    assert not seg.compact().needs_compaction()    # folded → trigger clears
    tomb = SegmentedIndex(DenseIndex(data["docs"][:64], device=CPU),
                          max_delta_fraction=0.25)
    tomb.delete(range(20))                         # 20/64 > 0.25
    assert tomb.needs_compaction()


def test_drift_monitor_empty_and_ref_free():
    m = DriftMonitor()
    assert m.mean_shift == 0.0
    assert np.isnan(m.stats()["mean_norm"])
    m.update(np.ones((4, 8)))
    assert m.stats()["n_added"] == 4
    assert m.mean_shift > 0                        # vs zero reference


# ---------------------------------------------------------------------------
# persistence: segments + tombstones + allocator round-trip (version 2)
# ---------------------------------------------------------------------------

#: case → IndexSpec kwargs (both packages take the same spec)
SPECS = {
    "pca_int8": dict(method="pca_int8", dim=24, post=False),
    "pca_onebit": dict(method="pca_onebit", dim=33, post=False),
    "dense": dict(method="dense"),
    "ivf": dict(method="pca_int8", dim=24, post=False, ivf=(12, 5),
                kmeans_iters=4),
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_segmented_artifact_round_trip(tmp_path, data, case):
    spec = p_api.IndexSpec(**SPECS[case], mutable=True)
    seg = p_api.build_index(spec, data["docs"], data["queries"], device=CPU)
    assert isinstance(seg, SegmentedIndex)
    seg.add(data["extra"])
    seg.delete(DEAD)
    v0, i0 = seg.search(data["queries"], K)

    path = str(tmp_path / "kb.npz")
    seg.save(path)
    meta = p_api.load_index_meta(path)
    assert meta["kind"] == "SegmentedIndex" and meta["format_version"] == 2
    assert meta["mutable"] and meta["n_docs"] == 360 - len(DEAD)

    back = SegmentedIndex.load(path, device=CPU)
    assert back.spec == spec
    assert back.next_gid == 360 and len(back) == 360 - len(DEAD)
    assert back.drift.n_added == 60
    assert back.drift.mean_shift == pytest.approx(seg.drift.mean_shift)
    _assert_ranking(back.search(data["queries"], K), (v0, i0), exact=True)

    # the loaded copy is still mutable: add → delete → compact → search
    back.add(data["extra"][:8])
    assert back.next_gid == 368
    back.delete([361])
    _, ci = back.compact().search(data["queries"], K)
    assert 361 not in set(ci.numpy().ravel().tolist())


# ---------------------------------------------------------------------------
# crossing with repro: v2 artifacts both ways, one update log on both
# ---------------------------------------------------------------------------


def _repro_search(idx, queries, case):
    kw = {"nprobe": 5} if case == "ivf" else {}
    return idx.search(jnp.asarray(queries), K, **kw)


def _port_search(idx, queries, case):
    kw = {"nprobe": 5} if case == "ivf" else {}
    return idx.search(queries, K, **kw)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_repro_v2_artifact_ranks_the_same_in_the_port(tmp_path, data, case):
    rseg = r_api.build_index(r_api.IndexSpec(**SPECS[case], backend="jnp",
                                             mutable=True),
                             jnp.asarray(data["docs"]),
                             jnp.asarray(data["queries"]))
    rseg.add(jnp.asarray(data["extra"]))
    rseg.delete(DEAD)
    path = str(tmp_path / "repro.npz")
    rseg.save(path)
    pseg = p_api.load_index(path, device=CPU, backend="torch")
    assert isinstance(pseg, SegmentedIndex)
    assert (len(pseg), pseg.next_gid, pseg.n_segments) == \
        (len(rseg), rseg.next_gid, rseg.n_segments)
    assert p_api.load_index_meta(path) == r_api.load_index_meta(path)
    _assert_ranking(_port_search(pseg, data["queries"], case),
                    _repro_search(rseg, data["queries"], case),
                    exact=case == "pca_onebit")


@pytest.mark.parametrize("case", sorted(SPECS))
def test_port_v2_artifact_ranks_the_same_in_repro(tmp_path, data, case):
    pseg = p_api.build_index(p_api.IndexSpec(**SPECS[case], backend="torch",
                                             mutable=True),
                             data["docs"], data["queries"], device=CPU)
    pseg.add(data["extra"])
    pseg.delete(DEAD)
    path = str(tmp_path / "port.npz")
    pseg.save(path)
    rseg = r_api.load_index(path)
    assert isinstance(rseg, RSegmented)
    assert (len(rseg), rseg.next_gid, rseg.drift.n_added) == \
        (len(pseg), pseg.next_gid, 60)
    assert rseg.drift.mean_shift == pytest.approx(pseg.drift.mean_shift)
    _assert_ranking(_repro_search(rseg, data["queries"], case),
                    _port_search(pseg, data["queries"], case),
                    exact=case == "pca_onebit")


@pytest.mark.parametrize("case", sorted(SPECS))
def test_one_update_log_replayed_on_both_packages(tmp_path, data, case):
    """A shared v1 artifact, then the same adds and deletes in each
    package: the same live set and the same ranking."""
    ridx = r_api.build_index(r_api.IndexSpec(**SPECS[case], backend="jnp"),
                             jnp.asarray(data["docs"]),
                             jnp.asarray(data["queries"]))
    path = str(tmp_path / "v1.npz")
    ridx.save(path)
    rseg = RSegmented(r_api.load_index(path))
    pseg = SegmentedIndex(p_api.load_index(path, device=CPU,
                                           backend="torch"))
    for seg, arr in ((rseg, jnp.asarray), (pseg, np.asarray)):
        seg.add(arr(data["extra"][:40]))
        seg.delete(DEAD[:3] + [320])
        seg.add(arr(data["extra"][40:]))
        seg.delete([305, 355])
    assert (len(pseg), pseg.next_gid, pseg.n_tombstoned) == \
        (len(rseg), rseg.next_gid, rseg.n_tombstoned)
    _assert_ranking(_port_search(pseg, data["queries"], case),
                    _repro_search(rseg, data["queries"], case),
                    exact=case == "pca_onebit")
