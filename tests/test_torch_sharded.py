"""Sharded exact and IVF search in ``repro_torch``, against the single host
and against ``repro``.

At ``repro``'s own test sizes (515 × 64 docs, 16 queries, PCA-32, IVF
nlist 12): on meshes of ``device="cpu"`` (1×8 and 2×2, a ragged last
shard), a sharded index ranks as the single-host index of the same state,
ids and score bits equal, for float / fp16 / int8 / 1-bit storage in both
numerics (``kernel`` runs each kernel's plain version on the CPU), at k =
10 and k above a shard's rows, IVF at nprobe 3, 6 and 12.  Against
``repro``: a ``repro``-built single-host artifact served sharded by the
port ranks as ``repro``'s own search (ids equal, 1-bit score bits equal,
other scores allclose); ``repro``'s sharded artifacts load in the port and
the port's in ``repro`` (one subprocess with 8 forced host devices, as
``tests/test_sharded_index.py`` runs ``repro``), with equal ids,
``shard_stats()`` and ``load_index_meta``.  Then the placement rules and
guards, and a SegmentedIndex over a sharded main.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.retrieval.api as r_api  # noqa: E402
import repro_torch.parallel.placement as placement  # noqa: E402
import repro_torch.retrieval.api as p_api  # noqa: E402
from repro_torch.core import (CenterNorm, CompressionPipeline,  # noqa: E402
                              FloatCast, Int8Quantizer, OneBitQuantizer, PCA)
from repro_torch.parallel import (Mesh, available_devices,  # noqa: E402
                                  mesh_from_spec)
from repro_torch.retrieval import (CompressedIndex, IVFIndex,  # noqa: E402
                                   SegmentedIndex, ShardedCompressedIndex,
                                   ShardedIVFIndex, partition_ivf_lists)
from repro_torch.retrieval.api import IndexSpec, ShardSpec  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CPU = "cpu"
K = 10
N_DOCS, D, N_Q = 515, 64, 16
BASE = (("CenterNorm", {}), ("PCA", {"dim": 32}))
TAILS = {"float": (), "fp16": (("FloatCast", {}),),
         "int8": (("Int8Quantizer", {}),),
         "onebit": (("OneBitQuantizer", {"offset": 0.5}),)}
#: 1×8: 65 rows a shard, the last 60 (ragged); 2×2: two replicas of 2
MESHES = {"1x8": ShardSpec(shards=8),
          "2x2": ShardSpec(shards=2, replicas=2)}
NUMERICS = ("torch", "kernel")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {"docs": rng.standard_normal((N_DOCS, D)).astype(np.float32),
            "queries": rng.standard_normal((N_Q, D)).astype(np.float32),
            "extra": rng.standard_normal((24, D)).astype(np.float32)}


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_bits(got, want):
    """Ids and score bits equal."""
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_array_equal(_np(got[0]).view(np.int32),
                                  _np(want[0]).view(np.int32))


def _assert_vs_repro(got, want, onebit):
    """ROADMAP's bar against repro: ids equal, 1-bit score bits equal,
    other scores allclose (f32 summation order)."""
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    if onebit:
        np.testing.assert_array_equal(_np(got[0]).view(np.int32),
                                      _np(want[0]).view(np.int32))
    else:
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5,
                                   atol=1e-5)


def _spec(tail, numerics, ivf=None, shard=None):
    return IndexSpec(stages=BASE + TAILS[tail], backend=numerics, ivf=ivf,
                     shard=shard)


# ---------------------------------------------------------------------------
# sharded == single-host, in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("numerics", NUMERICS)
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_sharded_exact_equals_single_host(data, tail, numerics, mesh):
    single = p_api.build_index(_spec(tail, numerics), data["docs"],
                               data["queries"], device=CPU)
    sharded = p_api.build_index(_spec(tail, numerics, shard=MESHES[mesh]),
                                data["docs"], data["queries"], device=CPU)
    assert isinstance(sharded, ShardedCompressedIndex)
    rows = [r["n_docs"] for r in sharded.shard_stats()]
    assert sum(rows) == N_DOCS and rows[-1] <= rows[0]
    # k = 10, k above a shard's rows (65 / 258), and k past the corpus
    for k in (K, 300, N_DOCS + 5):
        _assert_bits(sharded.search(data["queries"], k),
                     single.search(data["queries"], k))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("numerics", NUMERICS)
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_sharded_ivf_equals_single_host(data, tail, numerics, mesh):
    pipe = CompressionPipeline([CenterNorm(), PCA(32)]
                               + _tail_stages(tail))
    single = IVFIndex.build(data["docs"], data["queries"], pipe, nlist=12,
                            nprobe=6, kmeans_iters=8, backend=numerics,
                            device=CPU)
    spec = MESHES[mesh]
    sharded = ShardedIVFIndex(single, spec.build_mesh(CPU),
                              query_axis=spec.effective_query_axis)
    assert sharded._fused == single._use_fused_kernel
    for nprobe in (3, 6, 12):
        for k in (K, 100):
            _assert_bits(sharded.search(data["queries"], k, nprobe=nprobe),
                         single.search(data["queries"], k, nprobe=nprobe))


def _tail_stages(tail):
    return {"float": [], "fp16": [FloatCast()], "int8": [Int8Quantizer()],
            "onebit": [OneBitQuantizer(0.5)]}[tail]


@pytest.mark.parametrize("numerics", NUMERICS)
def test_build_index_sharded_ivf_equals_single_host(data, numerics):
    """``build_index`` with ``shard`` and ``ivf`` fits on the lead device
    as the single-host build does, so both rank the same; query shards
    that get no row of a small batch still merge cleanly."""
    single = p_api.build_index(_spec("int8", numerics, ivf=(12, 6)),
                               data["docs"], data["queries"], device=CPU)
    sharded = p_api.build_index(
        _spec("int8", numerics, ivf=(12, 6),
              shard=ShardSpec(shards=3, replicas=2)),
        data["docs"], data["queries"], device=CPU)
    assert isinstance(sharded, ShardedIVFIndex)
    assert sharded.n_doc_shards == 3 and sharded.n_query_shards == 2
    for q in (data["queries"], data["queries"][:5], data["queries"][:1]):
        _assert_bits(sharded.search(q, K), single.search(q, K))


def test_more_shards_than_lists_or_rows(data):
    """Shards that own no list (nlist 3 over 5 shards) or no rows (20 docs
    over 8 shards) answer nothing and the merge still ranks as one host."""
    docs, q = data["docs"], data["queries"]
    ivf = IVFIndex.build(docs, q, CompressionPipeline(
        [CenterNorm(), PCA(16), Int8Quantizer()]), nlist=3, nprobe=2,
        kmeans_iters=4, backend="kernel", device=CPU)
    sharded = ShardedIVFIndex(ivf, ShardSpec(shards=5).build_mesh(CPU))
    assert [r["n_lists"] for r in sharded.shard_stats()].count(0) == 2
    _assert_bits(sharded.search(q, K), ivf.search(q, K))
    small = p_api.build_index(_spec("int8", "torch"), docs[:20], q,
                              device=CPU)
    wide = p_api.build_index(_spec("int8", "torch",
                                   shard=ShardSpec(shards=8)),
                             docs[:20], q, device=CPU)
    assert [r["n_docs"] for r in wide.shard_stats()] == [3] * 6 + [2, 0]
    _assert_bits(wide.search(q, 25), small.search(q, 25))


def test_partition_matches_repro():
    from repro.retrieval.sharded import partition_ivf_lists as r_partition
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 9, 200)
    from repro_torch.retrieval.ivf import build_padded_lists
    lists = build_padded_lists(labels, 9)
    storage = rng.integers(0, 255, (200, 6)).astype(np.uint8)
    for n_shards in (1, 3, 4):
        for got, want in zip(partition_ivf_lists(lists, storage, n_shards),
                             r_partition(lists, storage, n_shards)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# against repro, in process: one repro-built single-host artifact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ivf", [None, (12, 6)], ids=["exact", "ivf"])
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_repro_single_host_artifact_served_sharded(data, tmp_path, tail,
                                                   ivf):
    r_idx = r_api.build_index(
        r_api.IndexSpec(stages=BASE + TAILS[tail], ivf=ivf, backend="jnp"),
        data["docs"], data["queries"])
    path = str(tmp_path / "kb.npz")
    r_idx.save(path)
    want = r_idx.search(data["queries"], K)
    for spec in MESHES.values():
        got = p_api.load_index(path, shard=spec, device=CPU)
        assert type(got).__name__ == ("ShardedIVFIndex" if ivf
                                      else "ShardedCompressedIndex")
        assert got.spec.shard == spec
        _assert_vs_repro(got.search(data["queries"], K), want,
                         onebit=tail == "onebit")


# ---------------------------------------------------------------------------
# against repro's sharded run: 8 forced host devices in a subprocess
# ---------------------------------------------------------------------------

_REPRO_SHARDED = """
    import json, sys
    import numpy as np
    from repro.retrieval.api import (IndexSpec, ShardSpec, build_index,
                                     load_index, load_index_meta,
                                     save_index)

    out = sys.argv[1]
    rng = np.random.default_rng(0)
    docs = rng.standard_normal((515, 64)).astype(np.float32)
    queries = rng.standard_normal((16, 64)).astype(np.float32)
    BASE = (("CenterNorm", {}), ("PCA", {"dim": 32}))
    TAILS = {"int8": (("Int8Quantizer", {}),),
             "onebit": (("OneBitQuantizer", {"offset": 0.5}),)}
    arrays, info = {}, {}
    for tail, stages in TAILS.items():
        for kind, ivf in (("exact", None), ("ivf", (12, 6))):
            name = f"{kind}_{tail}"
            idx = build_index(IndexSpec(stages=BASE + stages, ivf=ivf,
                                        backend="jnp",
                                        shard=ShardSpec(shards=8)),
                              docs, queries)
            save_index(idx, f"{out}/repro_{name}.npz")
            for who, index in (("repro", idx),
                               ("port", load_index(f"{out}/port_{name}.npz"))):
                v, i = index.search(queries, 10)
                arrays[f"{who}_{name}_v"] = np.asarray(v)
                arrays[f"{who}_{name}_i"] = np.asarray(i)
                info[f"{who}_{name}"] = {
                    "kind": type(index).__name__,
                    "stats": index.shard_stats(),
                    "meta": load_index_meta(f"{out}/{who}_{name}.npz")}
    np.savez(f"{out}/results.npz", **arrays)
    with open(f"{out}/results.json", "w") as f:
        json.dump(info, f)
"""

REPRO_CASES = ("exact_int8", "exact_onebit", "ivf_int8", "ivf_onebit")


@pytest.fixture(scope="module")
def repro_sharded(data, tmp_path_factory):
    """The port writes its sharded artifacts first; then one ``repro``
    process with 8 forced host devices builds and saves its own, searches
    both, and records shard stats and artifact headers."""
    out = tmp_path_factory.mktemp("sharded_both")
    port = {}
    for name in REPRO_CASES:
        kind, tail = name.split("_")
        idx = p_api.build_index(
            _spec(tail, "torch", ivf=(12, 6) if kind == "ivf" else None,
                  shard=ShardSpec(shards=8)),
            data["docs"], data["queries"], device=CPU)
        idx.save(str(out / f"port_{name}.npz"))
        port[name] = idx
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REPRO_SHARDED), str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(out / "results.npz") as f:
        arrays = dict(f)
    info = json.loads((out / "results.json").read_text())
    return {"dir": out, "port": port, "arrays": arrays, "info": info}


@pytest.mark.parametrize("name", REPRO_CASES)
def test_repro_sharded_artifact_in_port(repro_sharded, data, name):
    path = str(repro_sharded["dir"] / f"repro_{name}.npz")
    idx = p_api.load_index(path, device=CPU)
    info = repro_sharded["info"][f"repro_{name}"]
    assert type(idx).__name__ == info["kind"]
    assert idx.n_doc_shards == 8
    a = repro_sharded["arrays"]
    _assert_vs_repro(idx.search(data["queries"], K),
                     (a[f"repro_{name}_v"], a[f"repro_{name}_i"]),
                     onebit=name.endswith("onebit"))
    assert idx.shard_stats() == info["stats"]
    assert p_api.load_index_meta(path) == info["meta"]


@pytest.mark.parametrize("name", REPRO_CASES)
def test_port_sharded_artifact_in_repro(repro_sharded, data, name):
    own = repro_sharded["port"][name]
    info = repro_sharded["info"][f"port_{name}"]
    assert info["kind"] == type(own).__name__
    a = repro_sharded["arrays"]
    _assert_vs_repro((a[f"port_{name}_v"], a[f"port_{name}_i"]),
                     own.search(data["queries"], K),
                     onebit=name.endswith("onebit"))
    assert own.shard_stats() == info["stats"]
    path = str(repro_sharded["dir"] / f"port_{name}.npz")
    assert p_api.load_index_meta(path) == info["meta"]


# ---------------------------------------------------------------------------
# artifacts in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ivf", [None, (12, 6)], ids=["exact", "ivf"])
def test_sharded_artifacts_round_trip(data, tmp_path, ivf):
    q = data["queries"]
    single = p_api.build_index(_spec("onebit", "kernel", ivf=ivf),
                               data["docs"], q, device=CPU)
    want = single.search(q, K)
    one = str(tmp_path / "single.npz")
    single.save(one)
    spec = ShardSpec(shards=4)
    sharded = p_api.load_index(one, shard=spec, device=CPU)
    _assert_bits(sharded.search(q, K), want)
    path = str(tmp_path / "sharded.npz")
    sharded.save(path)
    meta = p_api.load_index_meta(path)
    assert meta["kind"] == type(sharded).__name__
    assert meta["spec"]["shard"] == spec.to_dict()
    back = type(sharded).load(path, device=CPU)      # the embedded spec
    assert back.n_doc_shards == 4
    _assert_bits(back.search(q, K), want)
    over = p_api.load_index(path, shard=ShardSpec(shards=2, replicas=2),
                            device=CPU)             # shard= overrides it
    assert (over.n_query_shards, over.n_doc_shards) == (2, 2)
    _assert_bits(over.search(q, K), want)
    if ivf is not None:                             # chunked, served sharded
        v3 = str(tmp_path / "single.v3")
        p_api.save_index(single, v3, chunked=True)
        tiered = p_api.load_index(v3, shard=spec, device=CPU, resident=0)
        assert isinstance(tiered, ShardedIVFIndex)
        _assert_bits(tiered.search(q, K), want)
        with pytest.raises(TypeError, match="inverted lists"):
            p_api.save_index(sharded, str(tmp_path / "x.v3"), chunked=True)


def test_mesh_kwarg_is_deprecated_but_honoured(data, tmp_path):
    mesh = ShardSpec(shards=2).build_mesh(CPU)
    with pytest.warns(DeprecationWarning, match="mesh"):
        idx = p_api.build_index(_spec("int8", "torch", shard=ShardSpec()),
                                data["docs"], mesh=mesh, device=CPU)
    assert idx.n_doc_shards == 2
    path = str(tmp_path / "kb.npz")
    p_api.build_index(_spec("int8", "torch"), data["docs"],
                      device=CPU).save(path)
    with pytest.warns(DeprecationWarning, match="mesh"):
        out = p_api.load_index(path, mesh=mesh, shard=ShardSpec())
    assert isinstance(out, ShardedCompressedIndex) and out.n_doc_shards == 2


# ---------------------------------------------------------------------------
# placement: the device rule, errors, the hook
# ---------------------------------------------------------------------------


def test_mesh_layout_and_device_rule():
    m = mesh_from_spec(ShardSpec(shards=2, replicas=2), CPU)
    assert isinstance(m, Mesh) and m.axis_names == ("data", "model")
    assert m.shape == {"data": 2, "model": 2}
    assert {d.type for d in m.devices.flat} == {"cpu"}
    # a named device: shards=None is one shard there
    assert mesh_from_spec(ShardSpec(), torch.device("cpu")).shape == \
        {"model": 1}
    # multi-axis doc axes: the count on the last, the others size 1
    m = mesh_from_spec(ShardSpec(doc_axis=("pod", "model"), shards=3), CPU)
    assert m.shape == {"pod": 1, "model": 3}
    # an explicit list: repro's rules
    four = ["cpu"] * 4
    assert available_devices(four) == [torch.device("cpu")] * 4
    assert mesh_from_spec(ShardSpec(), four).shape == {"model": 4}
    assert mesh_from_spec(ShardSpec(replicas=2), four).shape == \
        {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        mesh_from_spec(ShardSpec(replicas=3), four)
    with pytest.raises(ValueError, match="only 4 are available"):
        mesh_from_spec(ShardSpec(shards=8), four)
    with pytest.raises(ValueError, match="shards must be"):
        ShardSpec(shards=0)
    # None: CUDA, and never a quiet CPU fallback
    if not torch.cuda.is_available():
        for fn in (lambda: available_devices(),
                   lambda: ShardSpec(shards=1).build_mesh(),
                   lambda: mesh_from_spec(ShardSpec(), ["cuda:0"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


def test_placement_hook_fires_per_shard_before_any_copy(data):
    calls = []

    def record(sid, n):
        calls.append((sid, n))

    def fail_at_2(sid, n):
        calls.append((sid, n))
        if sid == 2:
            raise RuntimeError("injected shard-2 placement failure")

    single = p_api.build_index(_spec("int8", "kernel", ivf=(12, 6)),
                               data["docs"], data["queries"], device=CPU)
    mesh = ShardSpec(shards=4).build_mesh(CPU)
    try:
        placement.SHARD_PLACEMENT_HOOK = record
        ShardedIVFIndex(single, mesh)
        assert calls == [(s, 4) for s in range(4)]
        calls.clear()
        placement.SHARD_PLACEMENT_HOOK = fail_at_2
        with pytest.raises(RuntimeError, match="shard-2"):
            ShardedIVFIndex(single, mesh)
        assert calls == [(0, 4), (1, 4), (2, 4)]
        # exact placement is lazy: place() (the serving layer's call) fails
        sharded = ShardedCompressedIndex(CompressionPipeline([]), mesh)
        sharded.add(data["docs"])
        with pytest.raises(RuntimeError, match="shard-2"):
            sharded.place()
        assert sharded._placed is None           # nothing was placed
    finally:
        placement.SHARD_PLACEMENT_HOOK = None
    assert sharded.place() is sharded and sharded._placed is not None


# ---------------------------------------------------------------------------
# guards and the delegated surface
# ---------------------------------------------------------------------------


def test_sharded_ivf_guards_and_surface(data):
    docs, q = data["docs"], data["queries"]
    mesh = ShardSpec(shards=2).build_mesh(CPU)
    pipe = CompressionPipeline([CenterNorm(), PCA(16), Int8Quantizer()])
    residual = IVFIndex.build(docs, q, pipe, nlist=4, nprobe=2,
                              kmeans_iters=3, residual=True, device=CPU)
    with pytest.raises(ValueError, match="residual"):
        ShardedIVFIndex(residual, mesh)
    with pytest.raises(ValueError, match="single-host"):
        IndexSpec(method="pca_int8", ivf=(4, 2), ivf_residual=True,
                  shard=ShardSpec())
    with pytest.raises(ValueError, match="fitted"):
        ShardedIVFIndex(IVFIndex(device=CPU), mesh)
    ivf = IVFIndex.build(docs, q, CompressionPipeline(
        [CenterNorm(), PCA(16), Int8Quantizer()]), nlist=6, nprobe=3,
        kmeans_iters=3, device=CPU)
    sharded = ShardedIVFIndex(ivf, mesh)
    assert sharded.store is None and sharded.prefetch(q) == 0
    assert sharded.place() is sharded and sharded.residual is False
    assert (len(sharded), sharded.nlist, sharded.nprobe, sharded.nbytes) == \
        (len(ivf), ivf.nlist, ivf.nprobe, ivf.nbytes)
    assert sharded.centroids is ivf.centroids and \
        sharded.storage is ivf.storage and sharded.lists is ivf.lists
    assert sharded.pipeline is ivf.pipeline and sharded.backend == ivf.backend
    assert sharded._version == ivf._version
    for k in (0, -1):
        with pytest.raises(ValueError, match="k must be"):
            sharded.search(q, k)
    with pytest.raises(ValueError, match="nprobe must be"):
        sharded.search(q, K, nprobe=0)
    _assert_bits(sharded.search(q, K, nprobe=99), ivf.search(q, K, nprobe=6))
    with pytest.raises(NotImplementedError, match="cannot add"):
        sharded.add(data["extra"])
    with pytest.raises(NotImplementedError, match="partitions"):
        sharded.load_state_dict(sharded.state_dict())
    ivf.add(data["extra"])
    with pytest.raises(ValueError, match="changed since sharding"):
        sharded.search(q, K)
    with pytest.raises(TypeError, match="cannot wrap"):
        p_api._shard_loaded(p_api.build_index(IndexSpec(method="dense"),
                                              docs, device=CPU),
                            ShardSpec(shards=2), mesh)


def test_sharded_exact_surface(data):
    idx = p_api.build_index(_spec("int8", "torch", shard=ShardSpec(shards=4)),
                            data["docs"], data["queries"], device=CPU)
    assert idx.store is None and len(idx) == N_DOCS
    assert idx.storage.shape == (N_DOCS, 32) and idx.nbytes == N_DOCS * 32
    assert idx.place() is idx
    sd = idx.state_dict()
    clone = ShardedCompressedIndex(idx.pipeline, idx.mesh, backend="torch")
    clone.load_state_dict(sd)
    _assert_bits(clone.search(data["queries"], K),
                 idx.search(data["queries"], K))
    idx.add(data["extra"])                      # re-placed lazily
    assert len(idx) == N_DOCS + 24 and idx._placed is None
    single = CompressedIndex(idx.pipeline, backend="torch", device=CPU)
    single.load_state_dict({**sd, "storage": idx.storage,
                            "n_docs": len(idx)})
    _assert_bits(idx.search(data["queries"], K),
                 single.search(data["queries"], K))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_from_index_equals_single_host(data, tail, mesh):
    """``ShardedCompressedIndex.from_index`` wraps a built single-host
    index as it stands (pipeline, scorer state, rows) and ranks as it."""
    single = p_api.build_index(_spec(tail, "kernel"), data["docs"],
                               data["queries"], device=CPU)
    spec = MESHES[mesh]
    sharded = ShardedCompressedIndex.from_index(
        single, spec.build_mesh(CPU), query_axis=spec.effective_query_axis)
    assert len(sharded) == N_DOCS and sharded.backend == single.backend
    assert torch.equal(sharded.storage, single.storage)
    for k in (K, 300):
        _assert_bits(sharded.search(data["queries"], k),
                     single.search(data["queries"], k))


def test_fused_shard_layout_skips_unowned_probes(data):
    """Each fused shard keeps its owned lists and one empty list last; an
    unowned list maps to −1, which the kernel skips and its plain version
    reads as the empty last list — the same result as pointing the slot
    at the empty list."""
    from repro_torch.kernels.ivf_fused.kernel import fused_ivf_topk
    ivf = IVFIndex.build(data["docs"], data["queries"], CompressionPipeline(
        [CenterNorm(), PCA(32), Int8Quantizer()]), nlist=12, nprobe=6,
        kmeans_iters=8, backend="kernel", device=CPU)
    sharded = ShardedIVFIndex(ivf, ShardSpec(shards=4).build_mesh(CPU))
    assert sharded._fused
    qe, base_q, probe, _ = sharded.fused_inputs(
        data["queries"], 12, sharded.scorer.params())
    for s, (list_storage, list_ids, g2l) in enumerate(sharded._shards[0]):
        owned = sharded.list_owner == s
        empty = list_storage.shape[0] - 1
        assert empty == int(owned.sum())
        assert (list_ids[empty] == -1).all()
        np.testing.assert_array_equal(_np(g2l)[owned], np.arange(empty))
        assert (_np(g2l)[~owned] == -1).all()
        table = g2l[probe.long()]
        base = base_q[:, None].expand(table.shape).float().contiguous()
        to_empty = torch.where(table < 0, empty, table).to(torch.int32)
        _assert_bits(fused_ivf_topk(table, qe, list_storage, list_ids, base,
                                    K, "int8"),
                     fused_ivf_topk(to_empty, qe, list_storage, list_ids,
                                    base, K, "int8"))


# ---------------------------------------------------------------------------
# a SegmentedIndex over a sharded main
# ---------------------------------------------------------------------------

SEG_CASES = {"exact_int8": ("int8", "torch", None),
             "exact_onebit": ("onebit", "kernel", None),
             "ivf_int8": ("int8", "kernel", (12, 6)),
             "ivf_fp16": ("fp16", "torch", (12, 6))}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segmented_sharded_main_equals_single_host(data, case):
    tail, numerics, ivf = SEG_CASES[case]
    q = data["queries"]
    main = p_api.build_index(_spec(tail, numerics, ivf=ivf), data["docs"],
                             q, device=CPU)
    spec = ShardSpec(shards=4)
    seg_1 = SegmentedIndex(main)
    seg_n = p_api._shard_loaded(SegmentedIndex(copy.deepcopy(main)), spec,
                                spec.build_mesh(CPU))
    assert isinstance(seg_n.main, (ShardedCompressedIndex, ShardedIVFIndex))
    for seg in (seg_1, seg_n):
        seg.add(data["extra"])
        seg.delete([2, 7, 300, N_DOCS + 1, N_DOCS + 20])
    _assert_bits(seg_n.search(q, K), seg_1.search(q, K))
    rows = seg_n.shard_stats()
    assert seg_1.shard_stats() is None and len(rows) == 4
    if ivf is not None:
        # live delta rows by the shard owning their routed list
        assert sum(r["n_delta"] for r in rows) == 24 - 2
        assert [r["n_lists"] for r in rows] == \
            [r["n_lists"] for r in seg_n.main.shard_stats()]
    else:
        assert all(r["n_delta"] == 0 for r in rows)
    assert seg_n.place() is seg_n
    with pytest.raises(TypeError, match="single host"):
        seg_n.compact(out_path="unused")
    # compaction: fold + re-shard over the same mesh
    comp_1, comp_n = seg_1.compact(), seg_n.compact()
    assert type(comp_n.main) is type(seg_n.main)
    assert comp_n.main.mesh is seg_n.main.mesh
    assert sum(r["n_docs"] for r in comp_n.shard_stats()) == len(comp_1)
    _assert_bits(comp_n.search(q, K), comp_1.search(q, K))
    if ivf is not None:
        _assert_bits(comp_n.search(q, K, nprobe=12),
                     comp_1.search(q, K, nprobe=12))


def test_segmented_sharded_spec_builds_and_saves(data, tmp_path):
    spec = IndexSpec(stages=BASE + TAILS["int8"], ivf=(12, 6),
                     backend="kernel", mutable=True,
                     shard=ShardSpec(shards=2, replicas=2))
    seg = p_api.build_index(spec, data["docs"], data["queries"], device=CPU)
    assert isinstance(seg, SegmentedIndex)
    assert isinstance(seg.main, ShardedIVFIndex)
    seg.add(data["extra"])
    seg.delete([0, N_DOCS])
    path = str(tmp_path / "seg.npz")
    seg.save(path)
    meta = p_api.load_index_meta(path)
    assert meta["kind"] == "SegmentedIndex" and meta["mutable"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = SegmentedIndex.load(path, device=CPU)
    assert isinstance(back.main, ShardedIVFIndex)
    assert back.main.n_query_shards == 2
    _assert_bits(back.search(data["queries"], K),
                 seg.search(data["queries"], K))
