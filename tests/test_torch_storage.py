"""Tiered storage in ``repro_torch``: v3 chunked artifacts and list stores.

The port's counterparts of ``tests/test_storage.py``, held against
``repro`` on the same inputs at ``repro``'s own small size (500 × 48 docs,
12 queries):

* the container both ways — the port's ``ChunkWriter`` writes the bytes
  ``repro``'s writes (1-bit words as uint32), each reader reads the
  other's files, corruption and truncation name the list;
* ``MmapStore`` — one stream of gets, prefetches and pins gives equal
  ``stats()`` in both packages;
* v3 artifacts both ways for float, int8, ``pca_rot_onebit`` and
  ``ivf_residual`` at budgets 0 … ``"all"``: ids equal ``repro``'s (1-bit
  score bits too), and after the same searches ``store.stats()`` equals
  ``repro``'s;
* tiered equals resident in the port, bit for bit, at every budget, with
  the ``torch`` backend (streaming) and the ``kernel`` backend (the
  per-block fused route, through the kernel's plain version on the CPU);
* segmented tiered mains, the segmented v3 round trip and
  ``compact(out_path=)`` both ways; the read-only guards.
"""

import json
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.retrieval.api as r_api  # noqa: E402
import repro.storage as r_storage  # noqa: E402
from repro.retrieval.segments import SegmentedIndex as RSegmented  # noqa: E402
import repro_torch.retrieval.api as p_api  # noqa: E402
import repro_torch.storage as p_storage  # noqa: E402
from repro_torch.retrieval.ivf import artifact_rows  # noqa: E402
from repro_torch.retrieval.segments import SegmentedIndex  # noqa: E402
from repro_torch.storage.format import CHUNK_ALIGN, CHUNKS_NAME  # noqa: E402

CPU = "cpu"
K = 10
#: recipe → IndexSpec kwargs: the four storage layouts of the acceptance
#: list (post=False keeps the quantizer's storage)
RECIPES = {
    "float": dict(method="dense", dim=24),
    "int8": dict(method="pca_int8", dim=24, post=False),
    "onebit": dict(method="pca_rot_onebit", dim=32, post=False),
    "residual": dict(method="pca_int8", dim=24, post=False,
                     ivf_residual=True),
}
BUDGETS = ("zero", "eighth", "half", "full", "all")
#: (k, nprobe): the default probe, an odd probe (the phantom pad slot) and
#: k past the probed pool (the −inf/−1 fill)
SEARCHES = ((K, None), (K, 5), (40, 3))


def _spec(recipe, backend="jnp"):
    return dict(ivf=(16, 6), backend=backend, **RECIPES[recipe])


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _bits(v):
    return _np(v).astype(np.float32).view(np.uint32)


def _assert_bits(got, want):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(_np(gi), _np(wi))
    np.testing.assert_array_equal(_bits(gv), _bits(wv))


def _assert_ids(got, want, exact):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(_np(gi), _np(wi))
    if exact:
        np.testing.assert_array_equal(_bits(gv), _bits(wv))
    else:
        np.testing.assert_allclose(_np(gv), _np(wv), rtol=1e-5, atol=1e-5)


def _budget(name, enc):
    return {"zero": 0, "eighth": enc // 8, "half": enc // 2, "full": enc,
            "all": "all"}[name]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return {"docs": rng.standard_normal((500, 48)).astype(np.float32),
            "queries": rng.standard_normal((12, 48)).astype(np.float32),
            "extra": rng.standard_normal((60, 48)).astype(np.float32)}


@pytest.fixture(scope="module")
def repro_v3(corpus, tmp_path_factory):
    """recipe → (repro index, its v3 artifact path, encoded bytes)."""
    root = tmp_path_factory.mktemp("repro_v3")
    out = {}
    for recipe in RECIPES:
        idx = r_api.build_index(r_api.IndexSpec(**_spec(recipe)),
                                jnp.asarray(corpus["docs"]))
        path = str(root / f"{recipe}.v3")
        r_api.save_index(idx, path, chunked=True)
        out[recipe] = (idx, path,
                       r_api.load_index_meta(path)["encoded_nbytes"])
    return out


@pytest.fixture(scope="module")
def port_v3(corpus, tmp_path_factory):
    """(recipe, numerics) → (port index, its v3 artifact path, bytes)."""
    root = tmp_path_factory.mktemp("port_v3")
    out = {}
    for recipe in RECIPES:
        for numerics in ("torch", "kernel"):
            idx = p_api.build_index(
                p_api.IndexSpec(**_spec(recipe, numerics)), corpus["docs"],
                rng=torch.Generator().manual_seed(0), device=CPU)
            path = str(root / f"{recipe}_{numerics}.v3")
            p_api.save_index(idx, path, chunked=True)
            out[recipe, numerics] = (
                idx, path, p_api.load_index_meta(path)["encoded_nbytes"])
    return out


# ---------------------------------------------------------------------------
# the container, both ways
# ---------------------------------------------------------------------------


def _toy_lists(kind, n_lists=6, width=5, seed=0):
    rng = np.random.default_rng(seed)
    lists = []
    for lid in range(n_lists):
        n = int(rng.integers(0, 9)) if lid else 0      # list 0 empty
        if kind == "u8":
            rows = rng.integers(0, 256, (n, width)).astype(np.uint8)
        elif kind == "f32":
            rows = rng.standard_normal((n, width)).astype(np.float32)
        else:        # 1-bit words as the port holds them: int32, sign bit set
            rows = rng.integers(-2**31, 2**31, (n, width), dtype=np.int64) \
                .astype(np.int32)
        lists.append((rows, rng.permutation(1000)[:n].astype(np.int32)))
    return lists


_DTYPES = {"u8": np.uint8, "f32": np.float32, "words": np.uint32}


def _write(storage_mod, path, kind, lists, aux):
    w = storage_mod.ChunkWriter(path, storage_dtype=_DTYPES[kind],
                                storage_width=lists[0][0].shape[1])
    for rows, ids in lists:
        w.write_list(artifact_rows(rows) if storage_mod is p_storage
                     else rows.view(_DTYPES[kind]), ids)
    return w.finish({"kind": "toy", "format_version": 3}, aux)


def _npz_members(path):
    with zipfile.ZipFile(path) as zf:
        return {i.filename: zf.read(i.filename) for i in zf.infolist()}


@pytest.mark.parametrize("kind", ["u8", "f32", "words"])
def test_chunk_writer_bytes_match_repro(tmp_path, kind):
    lists = _toy_lists(kind)
    aux = {"centroids": np.arange(12, dtype=np.float32).reshape(3, 4),
           "main_gids": np.arange(5, dtype=np.int32)}
    pm = _write(p_storage, str(tmp_path / "p"), kind, lists, aux)
    rm = _write(r_storage, str(tmp_path / "r"), kind, lists, aux)
    assert pm == rm
    assert pm["storage_dtype"] == np.dtype(_DTYPES[kind]).str
    for name in (CHUNKS_NAME, "manifest.json"):
        with open(tmp_path / "p" / name, "rb") as a, \
                open(tmp_path / "r" / name, "rb") as b:
            assert a.read() == b.read(), name
    # aux.npz: the same members, byte for byte (the zip headers carry a
    # write time, so the archives are compared member by member)
    assert _npz_members(tmp_path / "p" / "aux.npz") == \
        _npz_members(tmp_path / "r" / "aux.npz")


@pytest.mark.parametrize("writer,reader", [(p_storage, r_storage),
                                           (r_storage, p_storage)],
                         ids=["port_writes", "repro_writes"])
def test_readers_read_each_others_files(tmp_path, writer, reader):
    lists = _toy_lists("words", seed=3)
    path = str(tmp_path / "kb")
    _write(writer, path, "words", lists, {"a": np.arange(3)})
    assert reader.is_chunked_artifact(path)
    r = reader.ChunkReader(path)
    assert r.storage_dtype == np.uint32 and r.n_lists == len(lists)
    for lid, rows, ids in r.iter_lists():
        np.testing.assert_array_equal(rows.view(np.int32), lists[lid][0])
        np.testing.assert_array_equal(ids, lists[lid][1])
        assert r.chunks[lid][0] % CHUNK_ALIGN == 0
    with r.load_aux() as aux:
        np.testing.assert_array_equal(aux["a"], np.arange(3))
    r.close()


@pytest.mark.parametrize("writer,reader", [(p_storage, r_storage),
                                           (r_storage, p_storage)],
                         ids=["port_writes", "repro_writes"])
def test_corruption_and_truncation_name_the_list(tmp_path, writer, reader):
    lists = _toy_lists("u8", seed=5)
    path = str(tmp_path / "kb")
    _write(writer, path, "u8", lists, {})
    r = reader.ChunkReader(path)
    victim = max(range(r.n_lists), key=lambda lid: r.chunks[lid][1])
    off = r.chunks[victim][0]
    r.close()
    cpath = os.path.join(path, CHUNKS_NAME)
    with open(cpath, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(reader.ArtifactError,
                       match=f"inverted list {victim}"):
        reader.ChunkReader(path).read_list(victim)
    with open(cpath, "r+b") as f:
        f.truncate(os.path.getsize(cpath) - CHUNK_ALIGN)
    with pytest.raises(reader.ArtifactError, match="truncated"):
        reader.ChunkReader(path).read_list(0)


def test_npz_member_nbytes_matches_repro(tmp_path):
    path = str(tmp_path / "toy.npz")
    np.savez(path, a=np.zeros((3, 7), np.uint8), b=np.arange(5),
             c=np.ones((2, 2), np.float16))
    assert p_storage.npz_member_nbytes(path) == \
        r_storage.npz_member_nbytes(path)


# ---------------------------------------------------------------------------
# MmapStore: one stream of touches, equal counters in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", ["zero", "small", "full"])
def test_mmap_store_stats_match_repro(tmp_path, budget):
    lists = _toy_lists("u8", n_lists=8, width=16, seed=7)
    path = str(tmp_path / "kb")
    manifest = _write(r_storage, path, "u8", lists, {})
    enc = manifest["encoded_nbytes"]
    nbytes = {"zero": 0, "small": enc // 3, "full": enc}[budget]
    stores = [mod.MmapStore(mod.ChunkReader(path), nbytes)
              for mod in (p_storage, r_storage)]
    rng = np.random.default_rng(2)
    for step in range(120):
        op = rng.choice(["get"] * 6 + ["prefetch", "pin", "unpin"])
        lids = rng.integers(0, 8, int(rng.integers(1, 4))).tolist()
        got = []
        for store in stores:
            if op == "get":
                got.append(store.get(lids[0]))
            else:
                getattr(store, op)(lids)
        if op == "get":
            np.testing.assert_array_equal(got[0][0], got[1][0])
            np.testing.assert_array_equal(got[0][1], got[1][1])
        assert stores[0].stats() == stores[1].stats(), (step, op)
    assert stores[0].stats()["hits"] + stores[0].stats()["misses"] > 0


# ---------------------------------------------------------------------------
# v3 artifacts through the Index API, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_repro_v3_loads_in_the_port(repro_v3, corpus, recipe, budget):
    ridx, path, enc = repro_v3[recipe]
    tiered = p_api.load_index(path, resident=_budget(budget, enc),
                              device=CPU)
    assert (tiered.store is None) == (budget == "all")
    assert (tiered.storage is None) == (budget != "all")
    exact = recipe == "onebit"       # residual 1-bit carries a GEMM term
    q = corpus["queries"]
    for k, nprobe in SEARCHES:
        _assert_ids(tiered.search(q, k, nprobe=nprobe),
                    ridx.search(jnp.asarray(q), k, nprobe=nprobe), exact)


@pytest.mark.parametrize("budget", ["zero", "eighth", "full"])
@pytest.mark.parametrize("recipe", ["int8", "onebit"])
def test_store_stats_match_repro_after_the_same_searches(repro_v3, corpus,
                                                         recipe, budget):
    _, path, enc = repro_v3[recipe]
    b = _budget(budget, enc)
    r_idx = r_api.load_index(path, resident=b)
    q = corpus["queries"]
    for k, nprobe in SEARCHES:
        r_idx.search(jnp.asarray(q), k, nprobe=nprobe, query_chunk=5)
    for numerics in ("torch", "kernel"):    # streaming and per-block fused
        p_idx = p_api.load_index(path, resident=b, backend=numerics,
                                 device=CPU)
        for k, nprobe in SEARCHES:
            p_idx.search(q, k, nprobe=nprobe, query_chunk=5)
        assert p_idx.store.stats() == r_idx.store.stats(), numerics
    assert r_idx.store.stats()["misses"] > 0


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_port_v3_loads_in_repro(port_v3, corpus, recipe):
    pidx, path, enc = port_v3[recipe, "torch"]
    q = corpus["queries"]
    for budget in ("zero", "all"):
        ridx = r_api.load_index(path, resident=_budget(budget, enc))
        for k, nprobe in SEARCHES:
            _assert_ids(pidx.search(q, k, nprobe=nprobe),
                        ridx.search(jnp.asarray(q), k, nprobe=nprobe),
                        exact=recipe == "onebit")
    assert r_api.load_index_meta(path) == p_api.load_index_meta(path)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_load_index_meta_v3_matches_repro(repro_v3, recipe):
    _, path, _ = repro_v3[recipe]
    meta = p_api.load_index_meta(path)
    assert meta == r_api.load_index_meta(path)
    assert meta["artifact_version"] == 3


def test_port_resaves_repro_chunks_byte_for_byte(repro_v3, tmp_path):
    """A repro artifact loaded by the port, resident or tiered, saves the
    same chunk stream (1-bit words back as uint32)."""
    _, path, enc = repro_v3["onebit"]
    with open(os.path.join(path, CHUNKS_NAME), "rb") as f:
        want = f.read()
    for budget in (0, "all"):
        out = str(tmp_path / f"resave_{budget}")
        p_api.save_index(p_api.load_index(path, resident=budget, device=CPU),
                         out, chunked=True)
        with open(os.path.join(out, CHUNKS_NAME), "rb") as f:
            assert f.read() == want, budget
        with open(os.path.join(out, "manifest.json")) as f:
            assert json.load(f)["storage_dtype"] == "<u4"


def test_v3_resident_all_matches_npz_load(repro_v3, corpus, tmp_path):
    ridx, path, _ = repro_v3["int8"]
    p1 = str(tmp_path / "kb.npz")
    r_api.save_index(ridx, p1)
    a = p_api.load_index(p1, device=CPU)
    b = p_api.load_index(path, resident="all", device=CPU)
    assert torch.equal(a.storage, b.storage) and torch.equal(a.lists,
                                                             b.lists)
    _assert_bits(b.search(corpus["queries"], K),
                 a.search(corpus["queries"], K))


# ---------------------------------------------------------------------------
# tiered == resident in the port, bit for bit, both numerics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numerics", ["torch", "kernel"])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_tiered_bit_identity_all_budgets(port_v3, corpus, recipe, numerics):
    pidx, path, enc = port_v3[recipe, numerics]
    q = corpus["queries"]
    full = p_api.load_index(path, resident="all", device=CPU)
    _assert_bits(full.search(q, K), pidx.search(q, K))
    # the kernel backend takes the fused route: per block when tiered
    assert full._use_fused_kernel == (numerics == "kernel")
    for budget in BUDGETS[:-1]:
        tiered = p_api.load_index(path, resident=_budget(budget, enc),
                                  device=CPU)
        assert tiered._use_fused_kernel == full._use_fused_kernel
        for k, nprobe in SEARCHES:
            _assert_bits(tiered.search(q, k, nprobe=nprobe),
                         full.search(q, k, nprobe=nprobe))
        # several query chunks: the store is walked chunk by chunk
        _assert_bits(tiered.search(q, K, query_chunk=5), full.search(q, K))


def test_prefetch_warms_the_tier_as_repro(repro_v3, corpus):
    ridx, path, enc = repro_v3["float"]
    q = corpus["queries"]
    r_t = r_api.load_index(path, resident=enc)
    p_t = p_api.load_index(path, resident=enc, device=CPU)
    assert p_t.prefetch(q) == r_t.prefetch(jnp.asarray(q)) > 0
    before = p_t.store.stats()["bytes_read"]
    _assert_ids(p_t.search(q, K), ridx.search(jnp.asarray(q), K), False)
    assert p_t.store.stats()["bytes_read"] == before   # all from the tier
    r_t.search(jnp.asarray(q), K)
    assert p_t.store.stats() == r_t.store.stats()


def test_corrupted_artifact_raises_through_search(port_v3, corpus, tmp_path):
    _, path, _ = port_v3["float", "torch"]
    out = str(tmp_path / "kb.v3")
    p_api.save_index(p_api.load_index(path, resident=0, device=CPU), out,
                     chunked=True)
    r = p_storage.ChunkReader(out)
    victim = max(range(r.n_lists), key=lambda lid: r.chunks[lid][1])
    off = r.chunks[victim][0]
    with open(os.path.join(out, CHUNKS_NAME), "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    tiered = p_api.load_index(out, resident=0, device=CPU)
    with pytest.raises(p_storage.ArtifactError,
                       match=f"inverted list {victim}"):
        tiered.search(corpus["queries"], K, nprobe=16)


def test_store_backed_is_read_only(port_v3, corpus, tmp_path):
    _, path, _ = port_v3["int8", "torch"]
    tiered = p_api.load_index(path, resident=0, device=CPU)
    assert tiered.nbytes == p_api.load_index_meta(path)["encoded_nbytes"]
    with pytest.raises(ValueError, match="read-only"):
        tiered.add(corpus["docs"][:4])
    with pytest.raises(ValueError, match="chunked=True"):
        tiered.state_dict()
    with pytest.raises(ValueError, match="chunked=True"):
        p_api.save_index(tiered, str(tmp_path / "nope.npz"))
    with pytest.raises(TypeError, match="inverted lists"):
        exact = p_api.build_index(p_api.IndexSpec(method="pca_int8", dim=8,
                                                  post=False),
                                  corpus["docs"], device=CPU)
        p_api.save_index(exact, str(tmp_path / "exact.v3"), chunked=True)
    with pytest.raises(ValueError, match="byte budget"):
        p_api.load_index(path, resident=-1, device=CPU)


# ---------------------------------------------------------------------------
# SegmentedIndex over a tiered main; compaction both ways
# ---------------------------------------------------------------------------


def _mutated(seg, extra):
    seg.add(extra[:40])
    seg.delete([3, 17, 180, 420, 510])
    seg.add(extra[40:])
    return seg


@pytest.mark.parametrize("numerics", ["torch", "kernel"])
@pytest.mark.parametrize("recipe", ["int8", "onebit"])
def test_segmented_over_tiered_main(repro_v3, corpus, recipe, numerics,
                                    tmp_path):
    _, path, enc = repro_v3[recipe]
    q, extra = corpus["queries"], corpus["extra"]

    def load(resident):
        return p_api.load_index(path, resident=resident, backend=numerics,
                                device=CPU)

    ref = _mutated(SegmentedIndex(load("all")), extra)
    seg = _mutated(SegmentedIndex(load(enc // 4)), extra)
    assert seg.main.store.stats()["pinned_lists"] > 0
    _assert_bits(seg.search(q, K), ref.search(q, K))
    rv, ri = ref.search(q, K)
    if numerics == "torch":
        # the same operations in repro, on the same artifact: same ids
        r_seg = _mutated(RSegmented(r_api.load_index(path,
                                                     resident=enc // 4)),
                         jnp.asarray(extra))
        _assert_ids((rv, ri), r_seg.search(jnp.asarray(q), K),
                    exact=recipe == "onebit")

    # in-memory compaction of the store-backed main: router kept, ids kept
    comp = seg.compact()
    assert comp.main.store is None
    cv, ci = comp.search(q, K)
    np.testing.assert_allclose(_np(cv), _np(rv), rtol=1e-5, atol=1e-6)
    if recipe == "int8":
        np.testing.assert_array_equal(_np(ci), _np(ri))

    # chunked compaction: a fresh v3 artifact, tiered equals resident, and
    # both compaction flavours fold the same layout
    out = str(tmp_path / "compacted.v3")
    comp2 = seg.compact(out_path=out, resident=enc // 4)
    assert p_storage.is_chunked_artifact(out)
    assert comp2.main.store is not None
    again = p_api.load_index(out, resident="all", device=CPU)
    _assert_bits(comp2.main.search(q, K), again.search(q, K))
    _assert_bits(comp2.search(q, K), (cv, ci))


@pytest.mark.parametrize("recipe", ["int8", "onebit"])
def test_fold_stream_and_chunked_compaction_match_repro(repro_v3, corpus,
                                                        recipe, tmp_path):
    """One mutable index in both packages — repro's segments, read by the
    port from repro's v3 save — folds to the same list stream and the same
    compacted artifact, and each package reads the other's fold."""
    _, path, enc = repro_v3[recipe]
    q = jnp.asarray(corpus["queries"])
    r_seg = _mutated(RSegmented(r_api.load_index(path, resident=enc // 4)),
                     jnp.asarray(corpus["extra"]))
    p3 = str(tmp_path / "seg.v3")
    r_api.save_index(r_seg, p3, chunked=True)
    seg = p_api.load_index(p3, resident=enc // 4, device=CPU)
    assert seg.main.store.stats()["pinned_lists"] == \
        r_api.load_index(p3, resident=enc // 4).main.store.stats()[
            "pinned_lists"]
    folds = zip(seg._iter_folded_lists(seg._state),
                r_seg._iter_folded_lists(r_seg._state), strict=True)
    for (lid, rows, new_ids, gids), (r_lid, r_rows, r_new, r_gids) in folds:
        assert lid == r_lid
        assert artifact_rows(rows).tobytes() == np.asarray(r_rows).tobytes()
        np.testing.assert_array_equal(new_ids, r_new)
        np.testing.assert_array_equal(gids, r_gids)
    outs = {"port": str(tmp_path / "p.v3"), "repro": str(tmp_path / "r.v3")}
    p_comp = seg.compact(out_path=outs["port"], resident=0)
    r_comp = r_seg.compact(out_path=outs["repro"], resident=0)
    for name in (CHUNKS_NAME, "manifest.json"):
        with open(os.path.join(outs["port"], name), "rb") as a, \
                open(os.path.join(outs["repro"], name), "rb") as b:
            assert a.read() == b.read(), name
    exact = recipe == "onebit"
    _assert_ids(p_comp.search(corpus["queries"], K),
                r_comp.search(q, K), exact)
    _assert_ids(p_api.load_index(outs["repro"], resident=0,
                                 device=CPU).search(corpus["queries"], K),
                r_api.load_index(outs["port"], resident=0).search(q, K),
                exact)


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_segmented_v3_roundtrip_with_deltas(repro_v3, corpus, writer,
                                            tmp_path):
    """save(chunked) of a segmented index keeps deltas and tombstones, and
    the other package reads it."""
    ridx, _, _ = repro_v3["int8"]
    q, extra = corpus["queries"], corpus["extra"]
    p1 = str(tmp_path / "main.npz")
    r_api.save_index(ridx, p1)
    p_seg = _mutated(SegmentedIndex(p_api.load_index(p1, device=CPU)), extra)
    r_seg = _mutated(RSegmented(r_api.load_index(p1)), jnp.asarray(extra))
    p3 = str(tmp_path / "seg.v3")
    if writer == "port":
        p_api.save_index(p_seg, p3, chunked=True)
    else:
        r_api.save_index(r_seg, p3, chunked=True)
    meta = p_api.load_index_meta(p3)
    assert meta == r_api.load_index_meta(p3)
    assert meta["artifact_version"] == 3 and meta["mutable"] is True
    for resident in ("all", 0):
        back = p_api.load_index(p3, resident=resident, device=CPU)
        assert isinstance(back, SegmentedIndex) and len(back) == len(p_seg)
        _assert_bits(back.search(q, K), p_seg.search(q, K))
        r_back = r_api.load_index(p3, resident=resident)
        _assert_ids(back.search(q, K), r_back.search(jnp.asarray(q), K),
                    exact=False)
