"""``repro_torch.models.recsys`` against ``repro.models.recsys``.

Each model at its REDUCED config, from ``repro``'s parameters (converted
with ``state_from_numpy``) on batches from ``make_batch`` (byte-equal in
both packages).  Bars: activations computed in bf16 (towers, DIN, DCN)
compared in f32 at rtol = atol = 1.6e-2; losses within 1e-3 relative;
each gradient leaf at cosine ≥ 0.999 against ``repro``'s, except DIN's
at 0.99: its bf16 gradients are noisy in both packages (``repro``'s own
sit at cosine 0.997–0.9998 from the f64 evaluation of the same function),
so both are also held to that f64 evaluation (ROADMAP §C).  f32-only
functions at rtol 1e-5: the embedding bags, FM (the sum-square trick and
its candidate decomposition), ``bce_loss`` and the in-batch softmax CE on
given embeddings.  Then ``repro``'s own tests replayed on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import base as r_base  # noqa: E402
from repro.configs import registry as r_reg  # noqa: E402
from repro.data import batches as r_batches  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.configs.base import (DCNConfig, DINConfig,  # noqa: E402
                                      FMConfig)
from repro_torch.models import recsys as PR  # noqa: E402
from repro_torch.train.optimizer import (tree_leaves,  # noqa: E402
                                         tree_map, tree_unflatten)
from repro_torch.train.trainer import state_from_numpy  # noqa: E402

CPU = "cpu"
F32_RTOL = 1e-5
BF16_TOL = 1.6e-2
LOSS_RTOL = 1e-3
GRAD_COS = 0.999
#: DIN's bf16 gradient leaves against repro's, and each package's against
#: the f64 evaluation (ROADMAP §C)
DIN_GRAD_COS = 0.99

MODELS = {  # arch → (spec, loss, logits / score)
    "two-tower-retrieval": ("two_tower_spec", "two_tower_loss",
                            "two_tower_score"),
    "fm": ("fm_spec", "fm_loss", "fm_logits"),
    "din": ("din_spec", "din_loss", "din_logits"),
    "dcn-v2": ("dcn_spec", "dcn_loss", "dcn_logits"),
}
CAND = {"fm": "fm_candidate_scores", "din": "din_candidate_scores",
        "dcn-v2": "dcn_candidate_scores",
        "two-tower-retrieval": "retrieval_scores"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to_port(tree):
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, tree), CPU)


def _setup(arch_name, shape_name, seed=0):
    """REDUCED cfg (both packages), repro's params (both), one batch."""
    r_arch, p_arch = r_reg.get_arch(arch_name), p_reg.get_arch(arch_name)
    r_cfg, p_cfg = r_arch.reduced, p_arch.reduced
    spec = getattr(RR, MODELS[arch_name][0])(r_cfg)
    r_params = RL.init_params(jax.random.PRNGKey(seed), spec)
    batch = r_batches.make_batch(np.random.default_rng(seed), r_arch,
                                 r_arch.shape(shape_name), reduced=True)
    return r_cfg, p_cfg, r_params, _to_port(r_params), batch, _to_port(batch)


def _leaves64(tree):
    if isinstance(tree, (dict, list)):
        leaves = tree_leaves(tree)
        if leaves and isinstance(leaves[0], torch.Tensor):
            return [x.double().numpy().ravel() for x in leaves]
    return [np.asarray(x, np.float64).ravel()
            for x in jax.tree_util.tree_leaves(tree)]


def _assert_grads_close(got, want, bar=GRAD_COS):
    got, want = _leaves64(got), _leaves64(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        ng, nw = np.linalg.norm(g), np.linalg.norm(w)
        if nw == 0:
            assert ng == 0
            continue
        assert g @ w / (ng * nw) >= bar, g @ w / (ng * nw)


def _port_grads(loss_fn, params):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


@pytest.mark.parametrize("arch_name", sorted(MODELS))
def test_loss_and_grads_match_repro(arch_name):
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup(
        arch_name, "train_batch")
    _, loss_name, _ = MODELS[arch_name]
    r_loss_fn = lambda p: getattr(RR, loss_name)(p, r_batch, r_cfg)[0]
    p_loss_fn = lambda p: getattr(PR, loss_name)(p, p_batch, p_cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(r_loss_fn))(r_params)
    got_loss, got_grads = _port_grads(p_loss_fn, p_params)
    assert got_loss.dtype == torch.float32
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=LOSS_RTOL)
    _assert_grads_close(got_grads, want_grads,
                        DIN_GRAD_COS if arch_name == "din" else GRAD_COS)
    _, metrics = getattr(PR, loss_name)(p_params, p_batch, p_cfg)
    assert sorted(metrics) == sorted(jax.eval_shape(
        lambda p: getattr(RR, loss_name)(p, r_batch, r_cfg)[1], r_params))


def test_din_bf16_grads_near_the_f64_evaluation(monkeypatch):
    """DIN's bf16 gradients, the port's and ``repro``'s, against the
    port's f64 evaluation of the same function (every bf16 step in f64)."""
    from repro_torch.models import layers as PL
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup(
        "din", "train_batch")
    want = jax.jit(jax.grad(
        lambda p: RR.din_loss(p, r_batch, r_cfg)[0]))(r_params)
    _, got = _port_grads(lambda p: PR.din_loss(p, p_batch, p_cfg), p_params)
    mlp = PL.mlp
    monkeypatch.setattr(PR, "BF16", torch.float64)
    monkeypatch.setattr(PL, "mlp", lambda p, x, act=torch.relu: mlp(
        p, x, act, compute_dtype=torch.float64))
    f64 = lambda t: tree_map(lambda x: x.double() if x.is_floating_point()
                             else x, t)
    _, truth = _port_grads(lambda p: PR.din_loss(p, f64(p_batch), p_cfg),
                           f64(p_params))
    _assert_grads_close(got, truth, DIN_GRAD_COS)
    _assert_grads_close(want, truth, DIN_GRAD_COS)


@pytest.mark.parametrize("arch_name", sorted(MODELS))
@pytest.mark.parametrize("shape_name", ["serve_p99", "retrieval_cand"])
def test_outputs_match_repro(arch_name, shape_name):
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup(
        arch_name, shape_name, seed=1)
    fn = MODELS[arch_name][2] if shape_name == "serve_p99" \
        else CAND[arch_name]
    got = getattr(PR, fn)(p_params, p_batch, p_cfg)
    want = jax.jit(lambda p, b: getattr(RR, fn)(p, b, r_cfg))(r_params,
                                                             r_batch)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    tol = F32_RTOL if arch_name == "fm" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=1e-6 if arch_name == "fm" else tol)


def test_two_tower_embeddings_match_repro():
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup(
        "two-tower-retrieval", "train_batch", seed=2)
    for fn, key in (("user_embedding", "user_ids"),
                    ("item_embedding", "item_ids")):
        got = getattr(PR, fn)(p_params, p_batch[key], p_cfg)
        want = getattr(RR, fn)(r_params, r_batch[key], r_cfg)
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0,
                                   rtol=1e-5)


@pytest.mark.parametrize("with_logq", [False, True])
def test_softmax_ce_on_given_embeddings_f32(monkeypatch, with_logq):
    """The in-batch softmax CE (and its logQ term) on given f32 tower
    outputs: f32 only, rtol 1e-5."""
    rng = np.random.default_rng(3)
    u, v = (rng.standard_normal((2, 16, 8)) * 0.3).astype(np.float32)
    logq = rng.standard_normal(16).astype(np.float32)
    p_cfg = p_reg.get_arch("two-tower-retrieval").reduced
    r_cfg = r_reg.get_arch("two-tower-retrieval").reduced
    for mod, conv in ((PR, torch.from_numpy), (RR, jnp.asarray)):
        monkeypatch.setattr(mod, "user_embedding", lambda p, i, c, x=u,
                            f=conv: f(x))
        monkeypatch.setattr(mod, "item_embedding", lambda p, i, c, x=v,
                            f=conv: f(x))
    batch = {"user_ids": None, "item_ids": None}
    p_batch = dict(batch, log_q=torch.from_numpy(logq)) if with_logq \
        else batch
    r_batch = dict(batch, log_q=jnp.asarray(logq)) if with_logq else batch
    got, _ = PR.two_tower_loss({}, p_batch, p_cfg)
    want, _ = RR.two_tower_loss({}, r_batch, r_cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=F32_RTOL)


def test_embedding_bag_modes_match_repro_with_an_empty_bag():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((20, 4)).astype(np.float32)
    ids = np.array([0, 1, 2, 5, 5, 7], np.int32)
    seg = np.array([0, 0, 1, 1, 1, 3], np.int32)   # bag 2 is empty
    w = rng.standard_normal(6).astype(np.float32)
    for mode in ("sum", "mean", "max"):
        for weights in (None, w):
            got = PR.embedding_bag(
                torch.from_numpy(table), torch.from_numpy(ids),
                torch.from_numpy(seg), 4, mode,
                None if weights is None else torch.from_numpy(weights))
            want = RR.embedding_bag(
                jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 4,
                mode, None if weights is None else jnp.asarray(weights))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=F32_RTOL, atol=1e-6)
            empty = got[2].numpy()
            assert np.all(empty == (-np.inf if mode == "max" else 0.0))
    with pytest.raises(ValueError):
        PR.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                         torch.from_numpy(seg), 4, "median")


def test_embedding_bag_max_gradient_matches_repro():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((10, 3)).astype(np.float32)
    ids = np.array([0, 1, 2, 3, 4], np.int32)
    seg = np.array([0, 0, 1, 1, 1], np.int32)
    want = jax.grad(lambda t: jnp.sum(RR.embedding_bag(
        t, jnp.asarray(ids), jnp.asarray(seg), 2, "max")))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    PR.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(seg), 2,
                     "max").sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def test_lookups_match_repro():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((30, 5)).astype(np.float32)
    ids = rng.integers(0, 10, (4, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        PR.fused_field_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                              10).numpy(),
        np.asarray(RR.fused_field_lookup(jnp.asarray(table),
                                         jnp.asarray(ids), 10)))
    np.testing.assert_array_equal(
        PR.embedding_lookup(torch.from_numpy(table),
                            torch.from_numpy(ids)).numpy(),
        np.asarray(RR.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))))


def test_bce_loss_matches_repro_and_known_value():
    loss, m = PR.bce_loss(torch.tensor([0.0, 100.0, -100.0]),
                          torch.tensor([0.5, 1.0, 0.0]))
    assert float(loss) == pytest.approx(np.log(2) / 3, rel=1e-4)
    assert set(m) == {"bce"}
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal(64) * 4).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    got, _ = PR.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want, _ = RR.bce_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# repro's tests/test_models_recsys.py, replayed on the port (repro's params)
# ---------------------------------------------------------------------------


def test_fm_sum_square_trick_matches_bruteforce():
    rng = np.random.default_rng(0)
    kw = dict(n_sparse=6, embed_dim=4, vocab_per_field=50)
    cfg = FMConfig(**kw)
    params = _to_port(RL.init_params(jax.random.PRNGKey(0),
                                     RR.fm_spec(r_base.FMConfig(**kw))))
    ids = torch.from_numpy(rng.integers(0, 50, (3, 6)).astype(np.int32))
    got = PR.fm_logits(params, {"sparse_ids": ids}, cfg).numpy()
    v = PR.fused_field_lookup(params["v"], ids, 50).numpy().astype(np.float64)
    lin = PR.fused_field_lookup(params["w_lin"], ids, 50).numpy()[..., 0]
    brute = [float(params["w0"][0]) + lin[b].sum()
             + sum(v[b, i] @ v[b, j] for i in range(6)
                   for j in range(i + 1, 6)) for b in range(3)]
    np.testing.assert_allclose(got, brute, rtol=F32_RTOL, atol=1e-6)


def test_fm_candidate_scores_match_full():
    rng = np.random.default_rng(1)
    kw = dict(n_sparse=5, embed_dim=4, vocab_per_field=30)
    cfg = FMConfig(**kw)
    params = _to_port(RL.init_params(jax.random.PRNGKey(1),
                                     RR.fm_spec(r_base.FMConfig(**kw))))
    ctx = torch.from_numpy(rng.integers(0, 30, (1, 4)).astype(np.int32))
    cands = torch.from_numpy(rng.integers(0, 30, (7,)).astype(np.int32))
    got = PR.fm_candidate_scores(params, {"context_ids": ctx,
                                          "cand_ids": cands}, cfg)
    full = torch.cat([ctx.expand(7, 4), cands[:, None]], dim=1)
    want = PR.fm_logits(params, {"sparse_ids": full}, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_RTOL,
                               atol=1e-6)


def test_din_candidate_scores_match_batch():
    rng = np.random.default_rng(2)
    kw = dict(item_vocab=100, context_vocab=20, seq_len=6, attn_mlp=(8,),
              mlp=(12,), n_context_features=2, embed_dim=6)
    cfg = DINConfig(**kw)
    params = _to_port(RL.init_params(jax.random.PRNGKey(2),
                                     RR.din_spec(r_base.DINConfig(**kw))))
    hist = torch.from_numpy(rng.integers(0, 100, (1, 6)).astype(np.int32))
    ctx = torch.from_numpy(rng.integers(0, 20, (1, 2)).astype(np.int32))
    cands = torch.from_numpy(rng.integers(0, 100, (5,)).astype(np.int32))
    got = PR.din_candidate_scores(params, {"history_ids": hist,
                                           "context_ids": ctx,
                                           "cand_ids": cands}, cfg)
    want = PR.din_logits(params, {"target_ids": cands,
                                  "history_ids": hist.expand(5, 6),
                                  "context_ids": ctx.expand(5, 2)}, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=1e-3)


def test_dcn_cross_layer_math():
    """x1 = x0 ⊙ (W x0 + b) + x0 for a single cross layer."""
    rng = np.random.default_rng(3)
    kw = dict(n_dense=2, n_sparse=2, embed_dim=2, n_cross_layers=1, mlp=(4,),
              vocab_per_field=10)
    cfg = DCNConfig(**kw)
    params = _to_port(RL.init_params(jax.random.PRNGKey(3),
                                     RR.dcn_spec(r_base.DCNConfig(**kw))))
    batch = {"dense": torch.from_numpy(
                 rng.standard_normal((1, 2)).astype(np.float32)),
             "sparse_ids": torch.from_numpy(
                 rng.integers(0, 10, (1, 2)).astype(np.int32))}
    emb = PR.fused_field_lookup(params["table"], batch["sparse_ids"], 10)
    x0 = np.concatenate([batch["dense"].numpy(),
                         emb.numpy().reshape(1, -1)], -1)
    w, b = (params["cross"][0][k].numpy() for k in ("w", "b"))
    x1 = x0 * (x0 @ w + b) + x0
    logits = PR.dcn_logits(params, batch, cfg)
    w_m = [layer["w"].numpy() for layer in params["mlp"]]
    b_m = [layer["b"].numpy() for layer in params["mlp"]]
    h = np.maximum(x1 @ w_m[0] + b_m[0], 0)
    want = (h @ w_m[1] + b_m[1])[:, 0]
    np.testing.assert_allclose(logits.numpy(), want, rtol=5e-2, atol=1e-2)


def test_two_tower_retrieval_scores_are_tower_dots():
    r_cfg, p_cfg, _, params, _, batch = _setup("two-tower-retrieval",
                                               "train_batch", seed=4)
    loss, _ = PR.two_tower_loss(params, batch, p_cfg)
    assert np.isfinite(float(loss))
    scores = PR.retrieval_scores(params, {"user_ids": batch["user_ids"][:2],
                                          "cand_ids": batch["item_ids"]},
                                 p_cfg)
    u = PR.user_embedding(params, batch["user_ids"][:2], p_cfg)
    v = PR.item_embedding(params, batch["item_ids"], p_cfg)
    np.testing.assert_allclose(scores.numpy(), (u @ v.T).numpy(),
                               rtol=F32_RTOL, atol=1e-6)
