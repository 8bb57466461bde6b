"""The port's random projections and greedy dimension drop against
``repro``'s.

Applied to ``repro``-fitted state the port gives ``repro``'s outputs
(dimension drops bit for bit, projections to rtol 1e-5).  The port's own
fits draw from a ``torch.Generator``, so they are held by what they are:
``keep`` a sorted set of distinct int32 indices, Gaussian entries of
variance 1/d′, sparse entries in {0, ±√(s/d′)} at density 1/s, and the
JL / density checks of ``tests/test_random_projection.py``.  The greedy
scorer is deterministic: per-dimension quality and ``keep`` equal
``repro``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import random_projection as R  # noqa: E402
from repro.data import make_dpr_like_kb  # noqa: E402
from repro.retrieval import rprecision as r_rp  # noqa: E402
from repro_torch.core import random_projection as P  # noqa: E402
from repro_torch.retrieval import rprecision as p_rp  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(3).standard_normal((300, 64)).astype(
        np.float32)


@pytest.fixture(scope="module")
def kb():
    kb = make_dpr_like_kb(n_queries=50, n_docs=1000, d=64, r_eff=16)
    return np.array(kb.docs), np.array(kb.queries), np.array(kb.relevant)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _carry(port_cls, repro_t, **kw):
    sd = repro_t.state_dict()
    return port_cls(**kw).load_state(
        {"state": {k: np.asarray(v) for k, v in sd["state"].items()},
         "fitted": sd["fitted"]}, CPU)


@pytest.mark.parametrize("name,kw", [
    ("DimensionDrop", {"dim": 16}), ("GaussianProjection", {"dim": 24}),
    ("SparseProjection", {"dim": 32, "s": 3.0})])
def test_port_applies_repro_state(data, name, kw):
    rt = getattr(R, name)(**kw).fit(jnp.asarray(data),
                                    rng=jax.random.PRNGKey(5))
    pt = _carry(getattr(P, name), rt, **kw)
    assert pt.init_config() == rt.init_config()
    want = np.asarray(rt(jnp.asarray(data)))
    got = pt(torch.from_numpy(data)).numpy()
    if name == "DimensionDrop":
        assert pt.state["keep"].dtype == torch.int32
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dimension_drop_fit(data):
    x = torch.from_numpy(data)
    t = P.DimensionDrop(16).fit(x, rng=_gen(0))
    keep = t.state["keep"]
    assert keep.dtype == torch.int32 and keep.shape == (16,)
    assert torch.equal(keep, torch.unique(keep))       # sorted, distinct
    assert int(keep.min()) >= 0 and int(keep.max()) < 64
    np.testing.assert_array_equal(t(x).numpy(), data[:, keep.numpy()])
    again = P.DimensionDrop(16).fit(x, rng=_gen(0))
    assert torch.equal(again.state["keep"], keep)
    # the default generator is the CPU one seeded 0
    assert torch.equal(P.DimensionDrop(16).fit(x).state["keep"], keep)


def test_gaussian_projection_jl_and_variance(data):
    """JL property (tests/test_random_projection.py) and entry variance."""
    t = P.GaussianProjection(48).fit(torch.from_numpy(data), rng=_gen(1))
    y = t(torch.from_numpy(data)).numpy()
    corr = np.corrcoef((data @ data.T).ravel(), (y @ y.T).ravel())[0, 1]
    assert corr > 0.6
    m = t.state["matrix"].numpy()
    assert m.shape == (64, 48) and m.dtype == np.float32
    # 3,072 draws: the sample variance lies within ±10% of 1/d′
    assert abs(m.var() * 48 - 1.0) < 0.1 and abs(m.mean()) < 0.01


def test_sparse_projection_entries_and_density(data):
    x = jnp.asarray(data)
    rt = R.SparseProjection(32, s=3.0).fit(x, rng=jax.random.PRNGKey(2))
    pt = P.SparseProjection(32, s=3.0).fit(torch.from_numpy(data),
                                           rng=_gen(2))
    m = pt.state["matrix"].numpy()
    assert 0.2 < np.mean(m != 0) < 0.5                 # expected 1/3
    # the same three values as repro's entries, bit for bit
    np.testing.assert_array_equal(np.unique(m),
                                  np.unique(np.asarray(rt.state["matrix"])))
    nz = m[m != 0]
    assert 0.4 < np.mean(nz > 0) < 0.6


def test_generator_on_another_device_moves_the_draws(data):
    # a meta-device tensor stands for "the data lies elsewhere": the draws
    # come from the CPU generator and land on the data's device
    x = torch.from_numpy(data).to("meta")
    for t in (P.DimensionDrop(8), P.GaussianProjection(8),
              P.SparseProjection(8)):
        t.fit(x, rng=_gen(0))
        assert all(v.device.type == "meta" for v in t.state.values())


@pytest.mark.parametrize("sim", ["ip", "l2"])
def test_dim_drop_scorer_and_keep_equal_repro(kb, sim):
    docs, queries, relevant = kb
    kw = dict(sim=sim, n_queries=32, n_docs=256, dim_chunk=16)
    want = np.asarray(r_rp.make_dim_drop_scorer(relevant, **kw)(
        jnp.asarray(queries), jnp.asarray(docs)))
    got = p_rp.make_dim_drop_scorer(relevant, **kw)(
        torch.from_numpy(queries), torch.from_numpy(docs))
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    # dim_chunk only batches the work
    other = p_rp.make_dim_drop_scorer(relevant, **{**kw, "dim_chunk": 7})(
        torch.from_numpy(queries), torch.from_numpy(docs))
    np.testing.assert_array_equal(other.numpy(), want)

    scorer_r = r_rp.make_dim_drop_scorer(relevant, **kw)
    scorer_p = p_rp.make_dim_drop_scorer(relevant, **kw)
    rt = R.GreedyDimensionDrop(16, scorer=scorer_r).fit(
        jnp.asarray(docs), jnp.asarray(queries))
    pt = P.GreedyDimensionDrop(16, scorer=scorer_p).fit(
        torch.from_numpy(docs), torch.from_numpy(queries))
    assert pt.state["keep"].dtype == torch.int32
    np.testing.assert_array_equal(pt.state["keep"].numpy(),
                                  np.asarray(rt.state["keep"]))
    np.testing.assert_array_equal(pt.state["per_dim_quality"].numpy(),
                                  np.asarray(rt.state["per_dim_quality"]))
    assert pt(torch.from_numpy(docs)).shape == (1000, 16)


def test_greedy_keeps_the_lowest_dimension_among_ties():
    # equal qualities everywhere: the stable order keeps dims 0 … d′−1
    t = P.GreedyDimensionDrop(4, scorer=lambda q, d: torch.zeros(10))
    t.fit(torch.zeros((3, 10)), torch.zeros((2, 10)))
    assert t.state["keep"].tolist() == [0, 1, 2, 3]


def test_greedy_requires_scorer(data):
    with pytest.raises(ValueError):
        P.GreedyDimensionDrop(8).fit(torch.from_numpy(data))


def test_r_precision_from_scores_matches_repro_on_ties():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (3, 40, 60)).astype(np.float32)
    relevant = rng.integers(0, 60, (40, 2)).astype(np.int32)
    relevant[::7, 1] = -1
    want = [float(r_rp.r_precision_from_scores(jnp.asarray(s),
                                               jnp.asarray(relevant)))
            for s in scores]
    got = p_rp.r_precision_from_scores(torch.from_numpy(scores),
                                       torch.from_numpy(relevant))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
