"""IVF search in ``repro_torch`` against ``repro``: ``repro``'s artifacts.

``repro`` builds and saves IVF indexes for the paper's int8 and 1-bit
recipes, the rotated 1-bit recipe and float storage, each plain, with
residual encoding, and with kmeans++ and balanced lists; the port loads
them (the build side, port → ``repro``, is ``test_torch_ivf_build.py``).
Each artifact is searched in both
packages with the same numerics: ``repro``'s ``jnp`` path against the
port's streaming ``torch`` path, and ``repro``'s Pallas kernel (interpret
mode) against the port's fused path, which on CPU tensors runs the plain
version of the Hopper kernel.  Ids are equal; 1-bit score bits are equal
(except with residual encoding, whose routed q·centroid term is a float
GEMM); other scores agree to 1e-5·max|v|.  The port's own fits are judged
by quality: k-means inertia, list sizes, rotation error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.retrieval.api as r_api  # noqa: E402
from repro.core.rotation import LearnedRotation as RRotation  # noqa: E402
from repro.data import make_dpr_like_kb  # noqa: E402
from repro.retrieval import kmeans as r_km  # noqa: E402
from repro.retrieval.scorers import backend_tail_stages  # noqa: E402
from repro.retrieval.scorers import get_scorer as r_get_scorer  # noqa: E402
from repro.retrieval.topk import similarity as r_similarity  # noqa: E402
import repro_torch.retrieval.api as p_api  # noqa: E402
from repro_torch.core.rotation import LearnedRotation  # noqa: E402
from repro_torch.retrieval import IVFFlatIndex, IVFIndex  # noqa: E402
from repro_torch.retrieval import kmeans as p_km  # noqa: E402
from repro_torch.retrieval.ivf import route  # noqa: E402
from repro_torch.retrieval.scorers import get_scorer  # noqa: E402

K = 10
NPROBES = (1, 6, 24)

#: case → IndexSpec kwargs (both packages take the same spec)
CASES = {
    "pca_int8": dict(method="pca_int8", dim=32, post=False),
    "pca_onebit": dict(method="pca_onebit", dim=45, post=False),
    "pca_rot_onebit": dict(method="pca_rot_onebit", dim=45, post=False),
    "float": dict(method="pca", dim=32, post=False),
}
VARIANTS = {
    "plain": dict(),
    "residual": dict(ivf_residual=True),
    "pp_balanced": dict(kmeans_init="++", balanced_lists=True),
}
#: the port's backend name ↔ repro's, for the same numerics
BACKENDS = (("torch", "jnp"), ("kernel", "pallas"))


@pytest.fixture(scope="module")
def kb():
    return make_dpr_like_kb(n_queries=32, n_docs=1200, d=64, r_eff=24)


def _spec_kwargs(case, variant):
    return dict(**CASES[case], **VARIANTS[variant], ivf=(24, 6),
                kmeans_iters=6)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_same_ranking(got, want, exact):
    (gv, gi), (wv, wi) = (tuple(map(_np, got)), tuple(map(_np, want)))
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
    else:
        fin = np.isfinite(wv)
        np.testing.assert_array_equal(np.isfinite(gv), fin)
        np.testing.assert_allclose(gv[fin], wv[fin], rtol=0,
                                   atol=1e-5 * np.abs(wv[fin]).max())


def _assert_same_search(pidx, ridx, queries, case, variant):
    exact = "onebit" in case and variant != "residual"
    for nprobe in NPROBES:
        _assert_same_ranking(
            pidx.search(np.asarray(queries), K, nprobe=nprobe),
            ridx.search(queries, K, nprobe=nprobe), exact)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_repro_artifact_routes_and_ranks_the_same_in_the_port(
        kb, tmp_path, case, variant):
    ridx = r_api.build_index(r_api.IndexSpec(**_spec_kwargs(case, variant),
                                             backend="jnp"),
                             kb.docs, kb.queries)
    path = str(tmp_path / "ivf.npz")
    ridx.save(path)
    q = kb.queries[:8]
    for p_backend, r_backend in BACKENDS:
        pidx = p_api.load_index(path, device="cpu", backend=p_backend)
        r_view = r_api.load_index(path, backend=r_backend)
        assert type(pidx).__name__ == "IVFIndex" and len(pidx) == len(ridx)
        assert pidx._use_fused_kernel == r_view._use_fused_kernel
        assert (pidx.nlist, pidx.nbytes) == (ridx.nlist, ridx.nbytes)
        # the routed probe table first: similarity + lax.top_k in repro
        rq = ridx.encode_queries(q).astype(jnp.float32)
        _, want = jax.lax.top_k(r_similarity(rq, ridx.centroids, "ip"),
                                ridx.nlist)
        _, got = route(pidx.encode_queries(np.asarray(q)).float(),
                       pidx.centroids, "ip", pidx.nlist)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_same_search(pidx, r_view, q, case, variant)


# ---------------------------------------------------------------------------
# the streaming path's scorer: scores_gathered against repro's vmap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numerics", [("torch", "jnp"), ("kernel", "pallas")])
@pytest.mark.parametrize("name,sim", [("float", "ip"), ("float", "l2"),
                                      ("fp16", "ip"), ("int8", "ip"),
                                      ("int8", "l2"), ("onebit", "ip")])
def test_scores_gathered_matches_repro(kb, name, sim, numerics):
    rng = np.random.default_rng(1)
    tail = backend_tail_stages()[name]
    docs = np.array(kb.docs[:120, :40])
    r_scorer = r_get_scorer(name, tail[0] if tail else None, sim=sim,
                            backend=numerics[1])
    if tail:
        tail[0].fit(jnp.asarray(docs))
    r_store = r_scorer.encode_docs(jnp.asarray(docs))
    p_scorer = get_scorer(name, sim=sim, backend=numerics[0])
    if tail:
        state = {k: torch.from_numpy(np.array(v))
                 for k, v in tail[0].state.items()}
        p_scorer.quantizer.state = state
        p_scorer.quantizer.fitted = True
    p_store = p_scorer.encode_docs(torch.from_numpy(docs))
    q = rng.standard_normal((6, 40)).astype(np.float32)
    cand = rng.integers(0, 120, (6, 30))
    want = r_scorer.scores_gathered(r_scorer.encode_queries(jnp.asarray(q)),
                                    r_store[jnp.asarray(cand)])
    got = p_scorer.scores_gathered(
        p_scorer.encode_queries(torch.from_numpy(q)),
        p_store[torch.from_numpy(cand)])
    _assert_same_ranking((got, torch.from_numpy(cand)),
                         (np.asarray(want), cand), exact=name == "onebit")


# ---------------------------------------------------------------------------
# fits, judged on quality
# ---------------------------------------------------------------------------


def _inertia(x, c):
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return float(d2.min(axis=1).sum())


def test_assign_gives_repro_labels_for_equal_centroids(kb):
    x = np.asarray(kb.docs)
    c = x[np.random.default_rng(0).permutation(len(x))[:24]] + 0.01
    want = np.asarray(r_km.assign(jnp.asarray(x), jnp.asarray(c)))
    got = p_km.assign(torch.from_numpy(x), torch.from_numpy(c), chunk=500)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("init", ["random", "++"])
def test_kmeans_inertia_within_ten_percent_of_repro(kb, init):
    x = np.asarray(kb.docs)
    want = np.asarray(r_km.kmeans_fit(jnp.asarray(x), 24, 8, init=init))
    got = p_km.kmeans_fit(torch.from_numpy(x), 24, 8,
                          rng=torch.Generator().manual_seed(0), init=init)
    assert got.shape == (24, x.shape[1])
    assert _inertia(x, got.numpy()) <= 1.10 * _inertia(x, want)


def test_balanced_peak_within_five_percent_of_repro(kb):
    x = np.asarray(kb.docs)
    c = np.asarray(r_km.kmeans_fit(jnp.asarray(x), 24, 6))
    want = np.asarray(r_km.assign_balanced(jnp.asarray(x), jnp.asarray(c)))
    got = p_km.assign_balanced(torch.from_numpy(x), torch.from_numpy(c),
                               chunk=500)
    peak = np.bincount(got.numpy(), minlength=24).max()
    assert peak <= 1.05 * np.bincount(want, minlength=24).max()
    assert peak <= np.bincount(np.asarray(r_km.assign(
        jnp.asarray(x), jnp.asarray(c))), minlength=24).max()


def _binarisation_error(x, r):
    z = x @ r
    return float(((z - np.where(z >= 0, 0.5, -0.5)) ** 2).sum() / len(x))


def test_learned_rotation_quality_matches_repro(kb):
    x = np.asarray(kb.docs)[:, :32]
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    want = np.asarray(RRotation(n_iters=5).fit(jnp.asarray(x))
                      .state["rotation"])
    rot = LearnedRotation(n_iters=5, max_fit_samples=1000).fit(
        torch.from_numpy(x), rng=torch.Generator().manual_seed(0))
    r = rot.state["rotation"].numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-5)
    assert abs(_binarisation_error(x, r) / _binarisation_error(x, want)
               - 1) <= 0.01


def test_learned_rotation_applies_repro_rotation(kb, tmp_path):
    ridx = r_api.build_index(r_api.IndexSpec(**CASES["pca_rot_onebit"]),
                             kb.docs, kb.queries)
    path = str(tmp_path / "rot.npz")
    ridx.save(path)
    pidx = p_api.load_index(path, device="cpu")
    r_rot, p_rot = ridx.pipeline.transforms[2], pidx.pipeline.transforms[2]
    assert isinstance(p_rot, LearnedRotation)
    center_norm, pca = ridx.pipeline.transforms[:2]
    z = np.asarray(pca(center_norm(kb.queries, "queries"), "queries"))
    np.testing.assert_allclose(p_rot(torch.from_numpy(z)).numpy(),
                               np.asarray(r_rot(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# guards, ported from tests/test_ivf.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_docs", [1, 5, 15])
def test_nlist_beyond_the_corpus_clamps(n_docs):
    rng = np.random.default_rng(0)
    docs = rng.standard_normal((n_docs, 8)).astype(np.float32)
    ivf = IVFFlatIndex(nlist=16, nprobe=16, kmeans_iters=3,
                       device="cpu").fit(docs)
    assert ivf.nlist == n_docs
    vals, ids = ivf.search(rng.standard_normal((2, 8)).astype(np.float32),
                           20)
    assert vals.shape == (2, n_docs)
    assert sorted(ids[0].tolist()) == list(range(n_docs))
    ivf.fit(np.random.default_rng(1).standard_normal((40, 8))
            .astype(np.float32))
    assert ivf.nlist == 16                     # the clamp is per fit


def test_empty_corpus_and_bad_arguments_raise():
    with pytest.raises(ValueError, match="empty"):
        IVFFlatIndex(nlist=4, device="cpu").fit(np.zeros((0, 8), np.float32))
    with pytest.raises(ValueError, match="nlist"):
        IVFIndex(nlist=0, device="cpu")
    with pytest.raises(ValueError, match="IP-only"):
        IVFIndex(None, sim="l2", residual=True, device="cpu")
    docs = np.random.default_rng(0).standard_normal((64, 8)) \
        .astype(np.float32)
    ivf = IVFFlatIndex(nlist=4, nprobe=2, kmeans_iters=2,
                       device="cpu").fit(docs)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="nprobe"):
            ivf.search(docs[:2], 3, nprobe=bad)
    with pytest.raises(ValueError, match="not fitted"):
        IVFIndex(device="cpu").search(docs[:2], 3)
    assert ivf.prefetch(docs[:2]) == 0         # fully resident, as repro


def test_add_after_to_ivf_makes_the_view_raise(kb):
    exact = p_api.build_index(
        p_api.IndexSpec(method="pca_int8", dim=16, post=False),
        np.asarray(kb.docs[:300]), np.asarray(kb.queries), device="cpu")
    ivf = exact.to_ivf(nlist=4, nprobe=4, kmeans_iters=3)
    ivf.search(np.asarray(kb.queries[:2]), 3)
    exact.add(np.asarray(kb.docs[300:310]))
    with pytest.raises(ValueError, match="to_ivf"):
        ivf.search(np.asarray(kb.queries[:2]), 3)


def test_partial_probe_pads_unreachable_slots():
    rng = np.random.default_rng(0)
    docs = rng.standard_normal((40, 8)).astype(np.float32)
    for backend in ("torch", "kernel"):
        ivf = IVFIndex(nlist=20, nprobe=1, kmeans_iters=5, backend=backend,
                       device="cpu").fit(docs)
        vals, ids = ivf.search(docs[:3], 10)
        assert vals.shape == (3, 10)
        short = ~torch.isfinite(vals)
        assert short.any()                      # one list holds < 10 docs
        assert (ids[short] == -1).all() and (ids[~short] >= 0).all()


def test_add_routes_to_existing_centroids_and_round_trips(kb, tmp_path):
    docs = np.asarray(kb.docs)
    ivf = IVFFlatIndex(nlist=8, nprobe=8, kmeans_iters=5,
                       device="cpu").fit(docs[:500])
    centroids = ivf.centroids.clone()
    ivf.add(docs[500:600])
    assert len(ivf) == 600 and torch.equal(ivf.centroids, centroids)
    q = np.asarray(kb.queries[:8])
    path = str(tmp_path / "flat.npz")
    ivf.save(path)
    back = IVFFlatIndex.load(path, device="cpu")
    assert type(back) is IVFFlatIndex and back.aux_nbytes == ivf.aux_nbytes
    for a, b in zip(back.search(q, 5), ivf.search(q, 5)):
        assert torch.equal(a, b)
    _assert_same_ranking(back.search(q, 5),
                         r_api.load_index(path).search(kb.queries[:8], 5),
                         exact=False)
