"""``repro_torch.retrieval.topk`` against ``repro.retrieval.topk``, bit for bit.

Scores are small integers (as float32), so ties are everywhere: every
function must reproduce ``repro``'s (score desc, id asc) order exactly.
"""

import ast
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.retrieval import topk as rt  # noqa: E402
from repro_torch.retrieval import topk as pt  # noqa: E402


def _tie_scores(seed, q=6, n=50, levels=5, neg_inf=0.0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, levels, size=(q, n)).astype(np.float32)
    if neg_inf:
        s[rng.random((q, n)) < neg_inf] = -np.inf
    ids = np.stack([rng.permutation(n) for _ in range(q)]).astype(np.int32)
    return s, ids


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("k", [1, 5, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_score_then_id(k, seed):
    s, ids = _tie_scores(seed)
    _eq(pt.topk_score_then_id(_t(s), _t(ids), k),
        rt.topk_score_then_id(jnp.asarray(s), jnp.asarray(ids), k))


@pytest.mark.parametrize("k", [3, 50, 64])
def test_masked_topk_by_id(k):
    s, ids = _tie_scores(2, neg_inf=0.3)
    _eq(pt.masked_topk_by_id(_t(s), _t(ids), k),
        rt.masked_topk_by_id(jnp.asarray(s), jnp.asarray(ids), k))


@pytest.mark.parametrize("k", [1, 10])
def test_merge_topk_block(k):
    s, ids = _tie_scores(3, n=40, neg_inf=0.1)
    run = rt.masked_topk_by_id(jnp.asarray(s[:, :20]), jnp.asarray(ids[:, :20]), k)
    want = rt.merge_topk_block(run[0], run[1], jnp.asarray(s[:, 20:]),
                               jnp.asarray(ids[:, 20:]), k)
    got = pt.merge_topk_block(_t(run[0]), _t(run[1]), _t(s[:, 20:]),
                              _t(ids[:, 20:]), k)
    _eq(got, want)


@pytest.mark.parametrize("block", [1, 7, 100])
@pytest.mark.parametrize("k", [1, 6])
def test_streaming_masked_topk(block, k):
    s, ids = _tie_scores(4, n=60, neg_inf=0.1)
    want = rt.streaming_masked_topk(jnp.asarray(s), jnp.asarray(ids), k, block)
    got = pt.streaming_masked_topk(_t(s), _t(ids), k, block)
    _eq(got, want)
    # any block size gives the monolithic answer
    _eq(got, pt.masked_topk_by_id(_t(s), _t(ids), k))


@pytest.mark.parametrize("sim", ["ip", "l2", "cos"])
def test_similarity(sim):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    d = rng.standard_normal((30, 24)).astype(np.float32)
    np.testing.assert_allclose(
        pt.similarity(_t(q), _t(d), sim).numpy(),
        np.asarray(rt.similarity(jnp.asarray(q), jnp.asarray(d), sim)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("doc_chunk,k", [(7, 5), (64, 10), (1000, 3),
                                         (4, 9)])
def test_topk_search_integer_scores(backend, doc_chunk, k):
    """Integer-valued vectors make every score exact and tie-heavy."""
    rng = np.random.default_rng(doc_chunk + k)
    q = rng.integers(-1, 2, size=(9, 8)).astype(np.float32)
    d = rng.integers(-1, 2, size=(120, 8)).astype(np.float32)
    want = rt.topk_search(jnp.asarray(q), jnp.asarray(d), k,
                          doc_chunk=doc_chunk)
    got = pt.topk_search(_t(q), _t(d), k, doc_chunk=doc_chunk,
                         backend=backend)
    _eq(got, want)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("query_chunk", [3, None])
@pytest.mark.parametrize("doc_chunk", [None, 7, 64])
def test_exact_loop_is_block_invariant(doc_chunk, query_chunk, backend):
    """The one exact loop gives the full row's (score desc, id asc) top k,
    ids and bits, whatever its query chunks and doc blocks (``None``: one
    covers all), k = 9 above a 7-row block included."""
    rng = np.random.default_rng(11)
    q = _t(rng.integers(-1, 2, size=(9, 8)).astype(np.float32))
    d = _t(rng.integers(-1, 2, size=(120, 8)).astype(np.float32))
    got = pt.topk_search(q, d, 9, doc_chunk=doc_chunk or 120,
                         query_chunk=query_chunk or 9, backend=backend)
    want = pt.topk_score_then_id(q @ d.T, torch.arange(120), 9)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def test_kernels_never_import_the_retrieval_layer():
    """The order's primitives sit below the kernels: no module of
    ``repro_torch.kernels`` imports ``repro_torch.retrieval``, at module
    level or inside a function."""
    import repro_torch.kernels as kernels

    root = pathlib.Path(kernels.__file__).parent
    found = []
    for path in sorted(root.rglob("*.py")):
        package = ".".join(("repro_torch", "kernels")
                           + path.relative_to(root).parent.parts)
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = importlib.util.resolve_name(
                    "." * node.level + (node.module or ""), package)
                names = [base] + [f"{base}.{a.name}" for a in node.names]
            else:
                continue
            if any(n.split(".")[:2] == ["repro_torch", "retrieval"]
                   for n in names):
                found.append(f"{path.relative_to(root)}:{node.lineno}")
    assert not found, found


def test_merge_topk_keeps_earlier_entries_first():
    va = np.array([[3.0, 1.0]], np.float32)
    vb = np.array([[3.0, 2.0]], np.float32)
    ia = np.array([[5, 6]], np.int32)
    ib = np.array([[1, 2]], np.int32)
    _eq(pt.merge_topk(_t(va), _t(ia), _t(vb), _t(ib), 3),
        rt.merge_topk(jnp.asarray(va), jnp.asarray(ia), jnp.asarray(vb),
                      jnp.asarray(ib), 3))


@pytest.mark.parametrize("k,n", [(1, 5), (9, 5), (5, 5)])
def test_resolve_k(k, n):
    assert pt.resolve_k(k, n) == rt.resolve_k(k, n)


@pytest.mark.parametrize("nprobe,nlist,default", [(None, 8, 3), (20, 8, None),
                                                  (2, 8, None)])
def test_resolve_nprobe(nprobe, nlist, default):
    assert pt.resolve_nprobe(nprobe, nlist, default) == \
        rt.resolve_nprobe(nprobe, nlist, default)


def test_resolve_guards_raise_like_repro():
    for fn in (lambda m: m.resolve_k(0, 4),
               lambda m: m.resolve_nprobe(None, 4)):
        with pytest.raises(ValueError):
            fn(rt)
        with pytest.raises(ValueError):
            fn(pt)
