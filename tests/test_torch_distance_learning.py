"""The port's similarity-preserving and contrastive projections against
``repro.core.distance_learning``.

``repro`` draws its pair and batch indices with ``jax.random`` inside the
jitted step; the port draws them with ``torch.randint``.  Fed ``repro``'s
index stream (re-derived from its keys) and started from ``repro``'s
initial parameters, the port's step loops reach ``repro``'s fitted
parameters at rtol 1e-4.  The port's own fits are held by quality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import distance_learning as R  # noqa: E402
from repro_torch.core import distance_learning as P  # noqa: E402
from repro_torch.train.optimizer import params_from_numpy  # noqa: E402

CPU = torch.device("cpu")
STEPS, BATCH = 20, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    z = rng.standard_normal((300, 6)).astype(np.float32)
    return z @ rng.standard_normal((6, 32)).astype(np.float32) \
        + 0.1 * rng.standard_normal((300, 32)).astype(np.float32)


def _np(t):
    return t.detach().numpy()


def _repro_spp_start(cfg, d_in, n):
    """``repro``'s initial parameters and (ia, ib) stream, as its fit
    derives them."""
    k1, k2, k_loop = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    if cfg.hidden:
        p0 = {"w1": jax.random.normal(k1, (d_in, cfg.hidden)) / np.sqrt(d_in),
              "b1": jnp.zeros((cfg.hidden,)),
              "w2": jax.random.normal(k2, (cfg.hidden, cfg.dim))
              / np.sqrt(cfg.hidden),
              "b2": jnp.zeros((cfg.dim,))}
    else:
        p0 = {"w1": jax.random.normal(k1, (d_in, cfg.dim)) / np.sqrt(d_in),
              "b1": jnp.zeros((cfg.dim,))}
    pairs = []
    for key in jax.random.split(k_loop, cfg.steps):
        ka, kb = jax.random.split(key)
        pairs.append(tuple(
            torch.from_numpy(np.array(jax.random.randint(
                k, (cfg.batch_size,), 0, n))).long() for k in (ka, kb)))
    return {k: np.asarray(v) for k, v in p0.items()}, pairs


@pytest.mark.parametrize("sim,hidden", [("ip", 0), ("l2", 0), ("ip", 16)])
def test_spp_steps_reach_repro_fit(data, sim, hidden):
    kw = dict(dim=8, sim=sim, hidden=hidden, steps=STEPS, batch_size=BATCH,
              lr=1e-2, seed=2)
    ref = R.SimilarityPreservingProjection(**kw).fit(jnp.asarray(data))
    port = P.SimilarityPreservingProjection(**kw)
    assert port.init_config() == ref.init_config()
    assert dataclasses.asdict(P.DistanceLearnerConfig()) == \
        dataclasses.asdict(R.DistanceLearnerConfig())
    p0, pairs = _repro_spp_start(port.config, 32, 300)
    got = port._train(params_from_numpy(p0, CPU), torch.from_numpy(data),
                      pairs)
    assert sorted(got) == sorted(ref.params)
    for k, v in ref.params.items():
        if sim == "l2" and k == "b1":
            # a shift leaves every l2 distance alone: b1's gradient is zero
            # but for round-off, which Adam scales to ±lr a step in both
            # packages alike, so b1 is fixed by neither
            continue
        np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=1e-4,
                                   atol=1e-6)


def test_contrastive_steps_reach_repro_fit(data):
    kw = dict(dim=8, steps=STEPS, batch_size=BATCH, lr=1e-2, seed=1)
    ref = R.ContrastiveProjection(**kw).fit(jnp.asarray(data))
    port = P.ContrastiveProjection(**kw)
    assert port.init_config() == ref.init_config()
    k_init, k_loop = jax.random.split(jax.random.PRNGKey(1))
    w0 = np.asarray(jax.random.normal(k_init, (32, 8)) / np.sqrt(32))
    batches = [torch.from_numpy(np.array(jax.random.randint(
        k, (BATCH,), 0, 300))).long()
        for k in jax.random.split(k_loop, STEPS)]
    xs = torch.from_numpy(data)
    # the positives: first-occurrence argmax of x xᵀ − 1e9·I, as repro's
    sims = jnp.asarray(data) @ jnp.asarray(data).T - 1e9 * jnp.eye(300)
    pos = P.ContrastiveProjection.positives(xs)
    np.testing.assert_array_equal(pos.numpy(),
                                  np.asarray(jnp.argmax(sims, axis=1)))
    got = port._train(params_from_numpy({"w": w0}, CPU), xs, pos, batches)
    np.testing.assert_allclose(_np(got["w"]), np.asarray(ref.params["w"]),
                               rtol=1e-4, atol=1e-6)


def test_positives_take_the_first_of_tied_neighbours():
    x = torch.tensor([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    assert P.ContrastiveProjection.positives(x).tolist() == [1, 0, 0, 0]


@pytest.mark.parametrize("name", ["SimilarityPreservingProjection",
                                  "ContrastiveProjection"])
def test_repro_fitted_state_loads_in_the_port(data, name):
    kw = dict(dim=8, steps=5)
    ref = getattr(R, name)(**kw).fit(jnp.asarray(data))
    sd = ref.state_dict()
    pt = getattr(P, name)(**ref.init_config()).load_state(
        {"state": {k: np.asarray(v) for k, v in sd["state"].items()},
         "fitted": True}, CPU)
    np.testing.assert_allclose(pt(torch.from_numpy(data)).numpy(),
                               np.asarray(ref(jnp.asarray(data))),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="missing keys"):
        getattr(P, name)(**kw).load_state({"state": {}, "fitted": True})


def _ip_corr(x, y):
    return np.corrcoef((x @ x.T).ravel(), (y @ y.T).ravel())[0, 1]


@pytest.mark.parametrize("hidden", [0, 16])
def test_spp_fit_learns_the_similarities(data, hidden):
    x = torch.from_numpy(data)
    cfg = dict(dim=8, steps=300, batch_size=64, lr=1e-2, hidden=hidden)
    t = P.SimilarityPreservingProjection(**cfg).fit(
        x, rng=torch.Generator().manual_seed(0))
    start = P.SimilarityPreservingProjection(**cfg)
    p0 = start.init_params(torch.Generator().manual_seed(0), 32, CPU)
    with torch.no_grad():
        loss0 = float(t._loss(p0, x, x))
        loss1 = float(t._loss(t.params, x, x))
    assert loss1 < 0.5 * loss0
    assert _ip_corr(data, _np(t(x))) > 0.9
    assert sorted(t.state) == (["b1", "b2", "w1", "w2"] if hidden
                               else ["b1", "w1"])
    again = P.SimilarityPreservingProjection(**cfg).fit(
        x, rng=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again(x), t(x), rtol=0, atol=0)


def test_contrastive_fit_keeps_neighbours(data):
    x = torch.from_numpy(data)
    t = P.ContrastiveProjection(dim=8, steps=200, batch_size=64,
                                lr=1e-2).fit(x)
    y = _np(t(x))
    assert y.shape == (300, 8) and np.isfinite(y).all()
    # each point's original nearest neighbour ranks near the top in f(x)
    pos = P.ContrastiveProjection.positives(x).numpy()

    def median_rank(y):
        yn = y / np.linalg.norm(y, axis=1, keepdims=True)
        sims = yn @ yn.T - 1e9 * np.eye(300)
        return np.median((sims > sims[np.arange(300), pos][:, None]).sum(1))

    w0 = P._randn(torch.Generator().manual_seed(0), (32, 8), CPU, 32)
    # of 299 candidates: a random projection ranks it lower than training
    assert median_rank(y) < min(20, median_rank(data @ w0.numpy()))
