"""IVF search in ``repro_torch`` against ``repro``: the port's builds.

The port builds and saves the IVF indexes of ``test_torch_ivf.py``'s
cases; ``repro`` loads them and both packages search them with the same
numerics, to the same bars.  ``CompressedIndex.to_ivf`` at nprobe = nlist
ranks as exact search does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.retrieval.api as r_api  # noqa: E402
import repro_torch.retrieval.api as p_api  # noqa: E402
from test_torch_ivf import (BACKENDS, CASES, K, VARIANTS,  # noqa: E402,F401
                            _assert_same_ranking, _assert_same_search,
                            _spec_kwargs, kb)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_artifact_ranks_the_same_in_repro(kb, tmp_path, case, variant):
    pidx = p_api.build_index(
        p_api.IndexSpec(**_spec_kwargs(case, variant), backend="torch"),
        np.asarray(kb.docs), np.asarray(kb.queries), device="cpu")
    path = str(tmp_path / "ivf.npz")
    pidx.save(path)
    assert p_api.load_index_meta(path) == r_api.load_index_meta(path)
    q = kb.queries[:8]
    for p_backend, r_backend in BACKENDS:
        p_view = p_api.load_index(path, device="cpu", backend=p_backend)
        ridx = r_api.load_index(path, backend=r_backend)
        assert ridx.spec.to_dict() == pidx.spec.to_dict()
        _assert_same_search(p_view, ridx, q, case, variant)
    # and it round-trips in the port, bit for bit
    again = p_api.load_index(path, device="cpu", backend="torch")
    for a, b in zip(again.search(np.asarray(q), K),
                    pidx.search(np.asarray(q), K)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("method,dim", [("pca", 32), ("pca_int8", 32),
                                        ("pca_onebit", 45)])
def test_full_probe_equals_exact_search(kb, method, dim, backend):
    """nprobe = nlist reaches every doc: the ranking is exact search's."""
    exact = p_api.build_index(
        p_api.IndexSpec(method=method, dim=dim, post=False, backend=backend),
        np.asarray(kb.docs), np.asarray(kb.queries), device="cpu")
    ivf = exact.to_ivf(nlist=16, nprobe=16, kmeans_iters=6)
    assert ivf._use_fused_kernel == (backend == "kernel")
    q = np.asarray(kb.queries[:16])
    _assert_same_ranking(ivf.search(q, K), exact.search(q, K),
                         exact=method == "pca_onebit")


def test_to_ivf_shares_storage_and_routes_on_docs(kb):
    exact = p_api.build_index(
        p_api.IndexSpec(method="pca_onebit", dim=45, post=False),
        np.asarray(kb.docs), np.asarray(kb.queries), device="cpu")
    ivf = exact.to_ivf(nlist=8, nprobe=8, docs=np.asarray(kb.docs),
                       kmeans_iters=3)
    assert ivf.storage is exact.storage and ivf.scorer is not exact.scorer
    assert ivf.scorer.dim == exact.scorer.dim
    with pytest.raises(ValueError, match="indexed corpus"):
        exact.to_ivf(nlist=8, docs=np.asarray(kb.docs[:10]))


def test_probe_and_score_matches_repro(kb, tmp_path):
    """The one-shot gather + score of every probed candidate, in probe
    order, against ``repro``'s on the same artifact."""
    from repro.retrieval.ivf import probe_and_score as r_probe_and_score
    from repro_torch.retrieval.ivf import probe_and_score

    ridx = r_api.build_index(
        r_api.IndexSpec(**_spec_kwargs("pca_onebit", "plain"),
                        backend="jnp"), kb.docs, kb.queries)
    path = str(tmp_path / "ivf.npz")
    ridx.save(path)
    pidx = p_api.load_index(path, device="cpu", backend="torch")
    q = kb.queries[:8]
    want = r_probe_and_score(ridx.encode_queries(q), ridx.centroids,
                             ridx.lists, ridx.storage, ridx.scorer,
                             ridx.scorer.params(), "ip", 6)
    got = probe_and_score(pidx.encode_queries(np.asarray(q)),
                          pidx.centroids, pidx.lists, pidx.storage,
                          pidx.scorer, pidx.scorer.params(), "ip", 6)
    (gs, gc, gvalid), (ws, wc, wvalid) = got, map(np.asarray, want)
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  ws.view(np.int32))     # 1-bit: same bits
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_array_equal(gvalid.numpy(), wvalid)


def test_install_routed_keeps_the_router(kb):
    """Adopting storage already routed to a router rebuilds only the list
    table: the search is unchanged."""
    from repro_torch.retrieval import IVFIndex

    built = p_api.build_index(
        p_api.IndexSpec(**_spec_kwargs("pca_int8", "plain"),
                        backend="torch"),
        np.asarray(kb.docs), np.asarray(kb.queries), device="cpu")
    again = IVFIndex(built.pipeline, nlist=built.nlist, nprobe=6,
                     backend="torch", device="cpu")
    again._install_routed(built.storage, built._labels, built.centroids,
                          built._dim)
    q = np.asarray(kb.queries[:8])
    for a, b in zip(again.search(q, K), built.search(q, K)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="one cluster id"):
        again._install_routed(built.storage, built._labels[:5],
                              built.centroids, built._dim)


def _update_by_index_add(x, labels, n_clusters, old):
    """k-means' update as the port had it before its build repeated on the
    card: f32 ``index_add_`` (sequential on the CPU, atomic on the card)."""
    sums = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype).index_add_(
        0, labels, x)
    counts = torch.zeros((n_clusters,), dtype=x.dtype).index_add_(
        0, labels, torch.ones_like(x[:, 0]))
    new = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, new, old)


@pytest.mark.parametrize("seed", range(5))
def test_kmeans_update_keeps_the_cpu_bits(seed):
    """The fixed-order segment sum gives the bits of the sequential
    ``index_add_``, wide and narrow rows, with empty clusters (which keep
    their old centroid) and values of mixed scale."""
    from repro_torch.retrieval.kmeans import _update

    g = torch.Generator().manual_seed(seed)
    n, k, d = (20_000, 64, 37) if seed % 2 else (5_000, 256, 128)
    x = torch.randn(n, d, generator=g) * torch.rand(n, 1, generator=g) * 100
    labels = torch.randint(0, k, (n,), generator=g)
    labels[labels == 3] = 4                     # cluster 3 empty
    labels[labels == k - 1] = 0                 # and the last
    old = torch.randn(k, d, generator=g)
    got = _update(x, labels, k, old)
    want = _update_by_index_add(x, labels, k, old)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[3], old[3]) and torch.equal(got[k - 1], old[k - 1])


@pytest.mark.parametrize("method,dim", [("pca_int8", 32),
                                        ("pca_rot_onebit", 45)])
def test_ivf_build_keeps_the_cpu_bits(kb, monkeypatch, method, dim):
    """The gated IVF recipe (kmeans++, balanced lists) built on the CPU
    gives the centroids, list assignment and lists of the ``index_add_``
    update, bit for bit."""
    from repro_torch.retrieval import kmeans

    spec = p_api.IndexSpec(method=method, dim=dim, post=False, ivf=(16, 4),
                           kmeans_iters=6, kmeans_init="++",
                           balanced_lists=True, backend="torch")
    docs, queries = np.asarray(kb.docs), np.asarray(kb.queries)
    new = p_api.build_index(spec, docs, queries, device="cpu")
    monkeypatch.setattr(kmeans, "_update", _update_by_index_add)
    old = p_api.build_index(spec, docs, queries, device="cpu")
    assert torch.equal(new.centroids.view(torch.int32),
                       old.centroids.view(torch.int32))
    np.testing.assert_array_equal(new._labels, old._labels)
    assert torch.equal(new.lists, old.lists)
