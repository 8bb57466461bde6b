"""The slice as a whole: exact search in ``repro_torch`` against ``repro``.

Indexes cross between the packages through the version-1 ``.npz``
artifact, both ways: ``repro`` builds, saves, and the port loads and
searches; the port builds, saves, and ``repro`` loads and searches.  Ids
must be equal for every backend, 1-bit scores bit-equal, other scores
allclose (int8 kernel numerics to atol = 1e-5·max: f32 summation order).
The port's own fits are held to ``repro``'s by retrieval quality.
"""

import ast
import dataclasses
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.retrieval.api as r_api  # noqa: E402
from repro.core import (CenterNorm, CompressionPipeline, Int8Quantizer,  # noqa: E402
                        OneBitQuantizer, PCA)
from repro.data import make_dpr_like_kb  # noqa: E402
from repro.retrieval import CompressedIndex as RCompressedIndex  # noqa: E402
from repro.retrieval import DenseIndex as RDenseIndex  # noqa: E402
import repro_torch.retrieval.api as p_api  # noqa: E402
from repro_torch import utils as p_utils  # noqa: E402
from repro_torch.data import make_dpr_like_kb as p_make_kb  # noqa: E402
from repro_torch.retrieval import CompressedIndex, DenseIndex  # noqa: E402
from repro_torch.retrieval.rprecision import (r_precision,  # noqa: E402
                                              r_precision_from_ids,
                                              recall_at_k)

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "rankings.json"
K = 10

#: case → (repro IndexSpec kwargs)
CASES = {
    "exact_float": dict(method="dense"),
    "pca_int8": dict(method="pca_int8", dim=32, post=False),
    "pca_onebit": dict(method="pca_onebit", dim=45, post=False),
}


@pytest.fixture(scope="module")
def kb():
    return make_dpr_like_kb(n_queries=64, n_docs=1500, d=64, r_eff=32,
                            seed=5)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_same_ranking(case, got, want):
    (gv, gi), (wv, wi) = (tuple(map(_np, got)), tuple(map(_np, want)))
    np.testing.assert_array_equal(gi, wi)
    if case == "pca_onebit":
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
    else:
        np.testing.assert_allclose(gv, wv, rtol=1e-5,
                                   atol=1e-5 * np.abs(wv).max())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_repro_artifact_ranks_the_same_in_the_port(kb, tmp_path, case,
                                                   backend):
    spec = r_api.IndexSpec(**CASES[case], backend=backend)
    ridx = r_api.build_index(spec, kb.docs, kb.queries)
    path = str(tmp_path / "kb.npz")
    ridx.save(path)
    pidx = p_api.load_index(path, device="cpu")
    assert type(pidx).__name__ == type(ridx).__name__ and len(pidx) == len(ridx)
    assert pidx.nbytes == ridx.nbytes
    assert pidx.spec.to_dict() == ridx.spec.to_dict()
    _assert_same_ranking(case, pidx.search(np.asarray(kb.queries), K),
                         ridx.search(kb.queries, K))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_port_artifact_ranks_the_same_in_repro(kb, tmp_path, case, backend):
    spec = p_api.IndexSpec(**CASES[case], backend=backend)
    pidx = p_api.build_index(spec, np.asarray(kb.docs),
                             np.asarray(kb.queries), device="cpu")
    path = str(tmp_path / "kb.npz")
    pidx.save(path)
    ridx = r_api.load_index(path)
    assert ridx.spec.backend == p_utils.backend_to_repro(backend)
    want = ridx.search(kb.queries, K)
    got = pidx.search(np.asarray(kb.queries), K)
    _assert_same_ranking(case, got, want)
    # and it round-trips in the port itself, bit for bit
    again = p_api.load_index(path, device="cpu").search(
        np.asarray(kb.queries), K)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _golden_indexes():
    kb = make_dpr_like_kb(n_queries=16, n_docs=800, d=64, r_eff=32, seed=2026)
    return kb, {
        "exact_float": RDenseIndex(kb.docs),
        "exact_int8": RCompressedIndex.build(
            kb.docs, kb.queries,
            CompressionPipeline([CenterNorm(), PCA(32), Int8Quantizer()]),
            backend="jnp"),
        "exact_onebit": RCompressedIndex.build(
            kb.docs, kb.queries,
            CompressionPipeline([CenterNorm(), OneBitQuantizer(0.5)]),
            backend="jnp"),
    }


@pytest.mark.parametrize("case", ["exact_float", "exact_int8",
                                  "exact_onebit"])
def test_golden_rankings_through_the_port(tmp_path, case):
    """``tests/golden/rankings.json`` as a second oracle, via artifacts."""
    golden = json.loads(GOLDEN.read_text())
    corpus = golden["corpus"]
    kb, indexes = _golden_indexes()
    path = str(tmp_path / f"{case}.npz")
    indexes[case].save(path)
    vals, ids = p_api.load_index(path, device="cpu").search(
        np.asarray(kb.queries[: corpus["n_queries"]]), corpus["k"])
    want = golden["cases"][case]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want["ids"]))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want["scores"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method,dim", [("pca_int8", 32), ("pca_onebit", 45)])
def test_port_build_matches_repro_by_quality(kb, method, dim):
    """Own fits: eigenvector signs may differ, so compare what they do."""
    ridx = r_api.build_index(
        r_api.IndexSpec(method=method, dim=dim, post=False, backend="jnp"),
        kb.docs, kb.queries)
    pidx = p_api.build_index(
        p_api.IndexSpec(method=method, dim=dim, post=False, backend="torch"),
        np.asarray(kb.docs), np.asarray(kb.queries),
        device="cpu")
    _, wi = ridx.search(kb.queries, K)
    _, gi = pidx.search(np.asarray(kb.queries), K)
    assert recall_at_k(gi, _np(wi)) >= 0.9
    rel = kb.relevant
    rp_port = r_precision_from_ids(gi, rel)
    rp_repro = r_precision_from_ids(torch.from_numpy(_np(wi)), rel)
    assert abs(rp_port - rp_repro) <= 0.02
    assert pidx.nbytes == ridx.nbytes


def test_r_precision_matches_repro(kb):
    from repro.retrieval.rprecision import r_precision as r_rp
    want = r_rp(kb.queries, kb.docs, jnp.asarray(kb.relevant))
    got = r_precision(torch.tensor(np.asarray(kb.queries)),
                      torch.tensor(np.asarray(kb.docs)), kb.relevant)
    assert got == pytest.approx(want, abs=1e-6)


def test_onebit_offset0_ranking_ignores_the_query_in_both_packages(kb,
                                                                   tmp_path):
    """Reference fault, reproduced on purpose: the {0,1} encoding's query
    values are all ≥ 0, so every query sign is +1 and the ranking is the
    same for every query.  The port matches ``repro`` bit for bit here."""
    spec = r_api.IndexSpec(method="onebit_offset0", post=False, backend="jnp")
    ridx = r_api.build_index(spec, kb.docs, kb.queries)
    path = str(tmp_path / "kb.npz")
    ridx.save(path)
    got = p_api.load_index(path, device="cpu").search(
        np.asarray(kb.queries[:8]), 5)
    _assert_same_ranking("pca_onebit", got, ridx.search(kb.queries[:8], 5))
    assert (got[1] == got[1][0]).all()


def test_spec_json_round_trips_through_repro():
    spec = p_api.IndexSpec(method="pca_int8", dim=128, post=False,
                           backend="kernel",
                           shard=p_api.ShardSpec(shards=2, replicas=2))
    r_spec = r_api.IndexSpec.from_json(spec.to_json())
    assert r_spec.backend == "pallas"
    back = p_api.IndexSpec.from_json(r_spec.to_json())
    assert back == spec and back.backend == "kernel"
    stages = p_api.IndexSpec(stages=(("CenterNorm", {}),
                                     ("PCA", {"dim": 8})), backend="jnp")
    assert stages.backend == "torch"
    assert r_api.IndexSpec.from_json(stages.to_json()).to_dict() == \
        stages.to_dict()


def test_load_index_meta_matches_repro(kb, tmp_path):
    ridx = r_api.build_index(r_api.IndexSpec(method="pca_onebit", dim=45,
                                             post=False), kb.docs, kb.queries)
    path = str(tmp_path / "kb.npz")
    ridx.save(path)
    assert p_api.load_index_meta(path) == r_api.load_index_meta(path)


def test_later_slices_raise_not_implemented(kb, tmp_path):
    docs = np.asarray(kb.docs)
    # sharded indexes build since the sharding slice (A.12): a named
    # device holds every shard, and the rows split as repro splits them
    spec = p_api.IndexSpec(method="pca_int8", dim=16, post=False,
                           shard=p_api.ShardSpec(shards=4))
    sharded = p_api.build_index(spec, docs, device="cpu")
    assert type(sharded).__name__ == "ShardedCompressedIndex"
    assert [r["n_docs"] for r in sharded.shard_stats()] == [375] * 4
    single = p_api.build_index(dataclasses.replace(spec, shard=None), docs,
                               device="cpu")
    for got, want in zip(sharded.search(docs[:5], 7),
                         single.search(docs[:5], 7)):
        assert torch.equal(got, want)
    # mutable indexes build since the mutable slice
    seg = p_api.build_index(p_api.IndexSpec(method="pca_int8", dim=16,
                                            post=False, mutable=True),
                            docs, device="cpu")
    assert type(seg).__name__ == "SegmentedIndex" and len(seg) == len(docs)
    # chunked (v3) artifacts load since the storage slice; a directory
    # without a manifest is no artifact, as in repro
    with pytest.raises(OSError):
        p_api.load_index(str(tmp_path), device="cpu")
    # IVF builds and loads since slice 2
    spec = p_api.IndexSpec(method="pca_int8", dim=16, post=False, ivf=(8, 2))
    built = p_api.build_index(spec, docs, device="cpu")
    ivf = r_api.build_index(r_api.IndexSpec.from_json(spec.to_json()),
                            kb.docs, kb.queries)
    path = str(tmp_path / "ivf.npz")
    ivf.save(path)
    loaded = p_api.load_index(path, device="cpu")
    assert type(loaded) is type(built) and loaded.spec == spec
    assert loaded.search(docs[:3], 4)[1].shape == (3, 4)
    v3 = str(tmp_path / "ivf.v3")
    r_api.save_index(ivf, v3, chunked=True)
    tiered = p_api.load_index(v3, resident=0, device="cpu")
    assert tiered.store is not None and tiered.spec == spec
    assert torch.equal(tiered.search(docs[:3], 4)[1],
                       loaded.search(docs[:3], 4)[1])
    with pytest.raises(TypeError):
        p_api.save_index(object(), str(tmp_path / "x.npz"))


def test_entry_points_without_a_device_raise_when_cuda_is_absent(
        kb, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    docs = np.asarray(kb.docs)
    path = str(tmp_path / "kb.npz")
    p_api.build_index(p_api.IndexSpec(method="dense"), docs,
                      device="cpu").save(path)
    calls = [
        lambda: p_api.build_index(p_api.IndexSpec(method="dense"), docs),
        lambda: p_api.load_index(path),
        lambda: DenseIndex(docs),
        lambda: CompressedIndex(p_api.IndexSpec(
            method="pca_int8", dim=8).build_pipeline()),
        lambda: p_make_kb(n_queries=2, n_docs=10, d=64, r_eff=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert p_utils.resolve_device("cpu").type == "cpu"


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(REPO)} imports {name}"


def test_kernel_sources_sit_beside_the_package():
    csrc = REPO / "src" / "repro_torch" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == [
        "binary_ip.cu", "fused_quantize.cu", "int8_ip.cu", "ivf_fused.cu",
        "topk_blocks.cu"]
    for src in csrc.glob("*.cu"):
        text = src.read_text()
        assert "src/repro/kernels/" in text and "Bound on an H100" in text
        assert "extern \"C\" int" in text and "cudaGetLastError" in text
    assert os.path.basename(p_api.__file__) == "api.py"
