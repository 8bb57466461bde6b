"""Artifacts with every off-path stage, both ways between the packages.

For each of the 12 Table-2 methods the port added, and for the two
quantized off-path recipes (AE + int8, Gaussian + 1-bit), an index built
and saved by ``repro`` is loaded and searched in the port, and one built
and saved by the port is loaded and searched in ``repro``.  Ids are
equal, float and int8 scores allclose (atol 1e-5·max: f32 summation
order), 1-bit score bits equal.  Under the kernel numerics of int8
(bf16(q⊙scale) × u8) a last-ulp difference of the AE's float-stage
queries (tanh) can move a bf16 query element one bf16 step, so there the
float-stage queries are held allclose and the port scores ``repro``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.retrieval.api as r_api  # noqa: E402
from repro.core.registry import build_method as r_build_method  # noqa: E402
from repro.data import make_dpr_like_kb  # noqa: E402
from repro.retrieval import CompressedIndex as RCompressedIndex  # noqa: E402
from repro.retrieval.rprecision import make_dim_drop_scorer as r_scorer  # noqa: E402
import repro_torch.retrieval.api as p_api  # noqa: E402
from repro_torch.retrieval.topk import topk_score_then_id  # noqa: E402
from repro_torch.core.registry import build_method as p_build_method  # noqa: E402
from repro_torch.core.registry import pipeline_spec  # noqa: E402
from repro_torch.retrieval import CompressedIndex as PCompressedIndex  # noqa: E402
from repro_torch.retrieval.rprecision import make_dim_drop_scorer as p_scorer  # noqa: E402

K, DIM = 10, 16
NEW_METHODS = ("gaussian_projection", "sparse_projection", "dim_drop",
               "greedy_dim_drop", "ae_linear", "ae_full", "ae_shallow",
               "ae_linear_l1", "ae_full_l1", "ae_shallow_l1",
               "distance_learning", "contrastive")
#: the quantized off-path recipes (repro's stage descriptors)
RECIPES = {
    "ae_int8": (("CenterNorm", {}),
                ("Autoencoder", {"variant": "shallow_decoder",
                                 "bottleneck": DIM, "l1": 10 ** -5.9,
                                 "epochs": 2}),
                ("CenterNorm", {}), ("Int8Quantizer", {})),
    "gaussian_onebit": (("CenterNorm", {}),
                        ("GaussianProjection", {"dim": 64}),
                        ("CenterNorm", {}),
                        ("OneBitQuantizer", {"offset": 0.5})),
}


#: shorter training than the methods' defaults (5 epochs, 2,000 and 1,000
#: steps)
SHORT = {"Autoencoder": {"epochs": 2},
         "SimilarityPreservingProjection": {"steps": 50},
         "ContrastiveProjection": {"steps": 50}}


@pytest.fixture(scope="module")
def kb():
    kb = make_dpr_like_kb(n_queries=64, n_docs=1500, d=64, r_eff=32, seed=5)
    return np.array(kb.docs), np.array(kb.queries), np.array(kb.relevant)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_same_ranking(got, want, onebit: bool):
    (gv, gi), (wv, wi) = tuple(map(_np, got)), tuple(map(_np, want))
    np.testing.assert_array_equal(gi, wi)
    if onebit:
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
    else:
        np.testing.assert_allclose(gv, wv, rtol=1e-5,
                                   atol=1e-5 * np.abs(wv).max())


def _check(pidx, ridx, queries, case, backend):
    """The port's search against repro's on the same artifact."""
    rq = np.asarray(ridx.encode_queries(jnp.asarray(queries)))
    pq = pidx.encode_queries(torch.from_numpy(queries))
    np.testing.assert_allclose(pq.numpy(), rq, rtol=1e-5, atol=1e-6)
    if backend == "pallas" and case == "ae_int8":
        s = pidx.scorer.scores(pidx.scorer.encode_queries(
            torch.from_numpy(np.array(rq))), pidx.storage,
            params=pidx.scorer.params())
        got = topk_score_then_id(s, torch.arange(s.shape[1]), K)
    else:
        got = pidx.search(torch.from_numpy(queries), K)
    _assert_same_ranking(got, ridx.search(jnp.asarray(queries), K),
                         case == "gaussian_onebit")


def _stages(case):
    """The method's stages (``build_method``'s, pre and post CenterNorm),
    trained for fewer steps: the artifacts are under test, not the fits."""
    if case in RECIPES:
        return RECIPES[case]
    return tuple((name, {**cfg, **SHORT.get(name, {})})
                 for name, cfg in pipeline_spec(p_build_method(case, DIM)))


def _repro_index(case, kb):
    docs, queries, relevant = kb
    if case == "greedy_dim_drop":
        pipe = r_build_method(case, DIM, greedy_scorer=r_scorer(
            relevant, n_queries=32, n_docs=512))
        return RCompressedIndex.build(jnp.asarray(docs), jnp.asarray(queries),
                                      pipe)
    return r_api.build_index(r_api.IndexSpec(stages=_stages(case)),
                             jnp.asarray(docs), jnp.asarray(queries))


def _port_index(case, kb):
    docs, queries, relevant = map(torch.from_numpy, kb)
    if case == "greedy_dim_drop":
        pipe = p_build_method(case, DIM, greedy_scorer=p_scorer(
            relevant, n_queries=32, n_docs=512))
        return PCompressedIndex.build(docs, queries, pipe, device="cpu")
    return p_api.build_index(p_api.IndexSpec(stages=_stages(case)), docs,
                             queries, device="cpu")


def _backends(case):
    return ("jnp", "pallas") if case in RECIPES else ("auto",)


@pytest.mark.parametrize("case", NEW_METHODS + tuple(RECIPES))
def test_repro_artifact_ranks_the_same_in_the_port(kb, tmp_path, case):
    ridx = _repro_index(case, kb)
    path = str(tmp_path / "kb.npz")
    ridx.save(path)
    queries = kb[1]
    for backend in _backends(case):
        pidx = p_api.load_index(path, device="cpu", backend=backend)
        assert len(pidx) == len(ridx) and pidx.nbytes == ridx.nbytes
        assert [type(t).__name__ for t in pidx.pipeline.transforms] == \
            [type(t).__name__ for t in ridx.pipeline.transforms]
        _check(pidx, r_api.load_index(path, backend=backend), queries, case,
               backend)


@pytest.mark.parametrize("case", NEW_METHODS + tuple(RECIPES))
def test_port_artifact_ranks_the_same_in_repro(kb, tmp_path, case):
    pidx = _port_index(case, kb)
    path = str(tmp_path / "kb.npz")
    pidx.save(path)
    queries = kb[1]
    for backend in _backends(case):
        ridx = r_api.load_index(path, backend=backend)
        assert len(ridx) == len(pidx) and ridx.nbytes == pidx.nbytes
        _check(p_api.load_index(path, device="cpu", backend=backend), ridx,
               queries, case, backend)
    # state keys and dtypes are repro's: e.g. DimensionDrop's keep int32
    data = np.load(path)
    for key in data.files:
        if key.endswith(":keep"):
            assert data[key].dtype == np.int32
