"""``repro_torch.models.transformer`` against ``repro.models.transformer``.

Over ``repro``'s two test configs (``tests/test_models_lm.py``: DENSE with
a GQA, ``qkv_bias`` model chunked by 8; MOE with 4 experts, top-2) and the
five REDUCED LM configs (phi4-mini, qwen1.5, qwen3-moe, dbrx, nemotron):

- ``repro``'s seven checks replayed on the port (finite loss and
  gradients, chunked CE = full CE, scan = unrolled, prefill = forward,
  decode = teacher forcing, aux loss ≥ 1, parameter count), at
  ``repro``'s own bars;
- from ``repro``'s parameters (``state_from_numpy``), over the five
  REDUCED configs: ``forward``, ``loss_fn`` and gradients, ``prefill``
  and ``decode_step`` held to ``repro``'s at the port's bf16 bars (activations
  rtol 1.6e-2 with atol 1.6e-2·max|·|, as for SchNet; losses 1e-3
  relative; gradient leaves at cosine ≥ 0.999, or, where ``repro``'s
  own bf16 gradient lies further than that from the f64 evaluation of
  the same loss, as close to ``repro``'s as that), and ``loss_fn`` with
  and without a mask and ``loss_chunk``;
- remat none / dots / full give the same loss and gradients, bit for
  bit;
- the init quirk both packages share: a stacked leaf's fan-in counts the
  L axis, so init statistics depend on depth.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import registry as r_reg  # noqa: E402
from repro.configs.base import LMConfig as RLMConfig  # noqa: E402
from repro.configs.base import MoEConfig as RMoEConfig  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.configs.base import LMConfig, MoEConfig  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train import trainer as PTR  # noqa: E402

CPU = "cpu"
BF16_TOL = 1.6e-2
LOSS_RTOL = 1e-3
GRAD_COS = 0.999

_DENSE = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=128, attn_q_chunk=8, qkv_bias=True,
              loss_chunk=None)
_MOE = dict(name="tm", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
            d_ff=16, vocab_size=128, attn_q_chunk=16, loss_chunk=None)
ARCHS = ("phi4-mini-3.8b", "qwen1.5-4b", "qwen3-moe-30b-a3b", "dbrx-132b",
         "nemotron-4-340b")
CFGS = ("dense", "moe") + ARCHS
MOE_CFGS = ("moe", "qwen3-moe-30b-a3b", "dbrx-132b")
DENSE_CFGS = tuple(n for n in CFGS if n not in MOE_CFGS)


def _configs(name):
    """(repro's config, the port's) by name."""
    if name == "dense":
        return RLMConfig(**_DENSE), LMConfig(**_DENSE)
    if name == "moe":
        return (RLMConfig(**_MOE, moe=RMoEConfig(4, 2)),
                LMConfig(**_MOE, moe=MoEConfig(4, 2)))
    return r_reg.get_arch(name).reduced, p_reg.get_arch(name).reduced


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=BF16_TOL):
    """A whole model's outputs at rtol 1.6e-2 and atol 1.6e-2·max|want|
    (the SchNet tests' form): an f32 sum taken in another order can put one
    bf16 activation on the other side of a rounding boundary, and that
    ulp travels the residual stream (ROADMAP §C)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _to_port(tree):
    return PTR.state_from_numpy(jax.tree_util.tree_map(np.asarray, tree), CPU)


def _tokens(cfg, seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _repro_init(key, cfg):
    """``repro``'s ``init``, under ``jit``: the same draws, compiled once
    instead of one dispatch per leaf."""
    return jax.jit(RT.init, static_argnums=1)(key, cfg)


@functools.lru_cache(maxsize=None)
def _all_repro_params():
    """``repro``'s parameters for the five REDUCED configs, from
    ``PRNGKey(0)``, in one compiled call (the init reads no ``loss_chunk``
    or ``remat``)."""
    cfgs = [_configs(name)[0] for name in ARCHS]
    params = jax.jit(lambda k: [RT.init(k, c) for c in cfgs])(
        jax.random.PRNGKey(0))
    return dict(zip(ARCHS, params))


def _repro_params(name):
    return _all_repro_params()[name]


def _port_init(cfg, seed=0):
    return PT.init(torch.Generator().manual_seed(seed), cfg, CPU)


def _port_value_and_grad(params, batch, cfg):
    leaves = [p.detach().requires_grad_() for p in PO.tree_leaves(params)]
    loss, metrics = PT.loss_fn(PO.tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _cosines(got, want):
    out = []
    for g, w in zip(got, want):
        a = np.asarray(g, np.float64).ravel()
        b = np.asarray(w, np.float64).ravel()
        out.append(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return np.array(out)


@contextlib.contextmanager
def _f64_evaluation():
    """The port's LM evaluated in f64: every bf16 step (``BF16``) and every
    f32 upcast (``Tensor.float``) becomes f64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PT, "BF16", torch.float64)
        mp.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
        yield


def _assert_grads_close(port, repro, params, batch, cfg):
    """Each gradient leaf of the port at cosine ≥ 0.999 against
    ``repro``'s, or, where ``repro``'s own bf16 leaf lies further than
    that from the f64 evaluation of the same loss, at least as close to
    ``repro``'s as ``repro``'s is to the f64 one (ROADMAP §C: one bf16
    activation rounded the other way, by an f32 sum in another order,
    moves whole leaves of these random-init models)."""
    port = [g.double().numpy() for g in port]
    repro = [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(
        repro)]
    got = _cosines(port, repro)
    if got.min() >= GRAD_COS:
        return
    with _f64_evaluation():
        _, _, truth = _port_value_and_grad(
            PO.tree_map(lambda t: t.double(), params), batch, cfg)
    bar = np.minimum(GRAD_COS, _cosines(repro, [t.numpy() for t in truth]))
    assert (got >= bar).all(), (got, bar)


@pytest.fixture(scope="module")
def repro_runs():
    """Per REDUCED config: repro's parameters, a train batch, and, in one
    jit, repro's loss, gradients and logits on them and its prefill into
    a 40-slot cache followed by one decode step at position 32.
    ``repro`` runs without remat (the same values, half the program to
    compile); the port keeps the config's."""
    cache = {}

    def get(name):
        if name not in cache:
            r_cfg, p_cfg = _configs(name)
            r_cfg = dataclasses.replace(r_cfg, remat="none")
            params = _repro_params(name)
            toks = _tokens(r_cfg, shape=(2, 32))
            batch = {"tokens": toks, "labels": toks}
            nxt = np.full((2,), 7, np.int32)

            def train_side(p, b):
                return (jax.value_and_grad(lambda q: RT.loss_fn(q, b, r_cfg),
                                           has_aux=True)(p),
                        RT.forward(p, b["tokens"], r_cfg))

            def serve_side(p, t, n):
                pre = RT.prefill(p, t, r_cfg, cache_len=40)
                return pre, RT.decode_step(p, pre[1], n, jnp.asarray(32),
                                           r_cfg)

            (((loss, metrics), grads), (logits, aux)), (pre, dec) = jax.jit(
                lambda p, b, n: (train_side(p, b),
                                 serve_side(p, b["tokens"], n)))(
                params, batch, nxt)
            cache[name] = dict(p_cfg=p_cfg, params=params, batch=batch,
                               loss=loss, metrics=metrics, grads=grads,
                               logits=logits, aux=aux, pre=pre, nxt=nxt,
                               dec=dec)
        return cache[name]

    return get


# ---------------------------------------------------------------------------
# repro's tests/test_models_lm.py, replayed on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CFGS)
def test_loss_and_grads_finite(name):
    _, cfg = _configs(name)
    toks = torch.from_numpy(_tokens(cfg))
    loss, metrics, grads = _port_value_and_grad(
        _port_init(cfg), {"tokens": toks, "labels": toks}, cfg)
    assert np.isfinite(float(loss))
    assert float(loss) == pytest.approx(float(metrics["ce"]), rel=0.2)
    gn = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("name", CFGS)
def test_chunked_ce_equals_full(name):
    """loss_chunk must not change the loss value."""
    _, cfg = _configs(name)
    cfg = dataclasses.replace(cfg, loss_chunk=None)
    params = _port_init(cfg)
    toks = torch.from_numpy(_tokens(cfg))
    batch = {"tokens": toks, "labels": toks}
    full = PT.loss_fn(params, batch, cfg)[0]
    chunked = PT.loss_fn(params, batch,
                         dataclasses.replace(cfg, loss_chunk=8))[0]
    assert float(full) == pytest.approx(float(chunked), rel=1e-5)


@pytest.mark.parametrize("name", CFGS)
def test_scan_equals_unrolled(name):
    """One loop serves both settings: the same bits (``repro`` asks for
    correlation > 0.999 and greedy agreement > 0.9 between its two
    compilations)."""
    _, cfg = _configs(name)
    params = _port_init(cfg)
    toks = torch.from_numpy(_tokens(cfg))
    a, _ = PT.forward(params, toks, cfg)
    b, _ = PT.forward(params, toks,
                      dataclasses.replace(cfg, scan_layers=False))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", CFGS)
def test_prefill_matches_forward(name):
    _, cfg = _configs(name)
    params = _port_init(cfg, seed=1)
    toks = torch.from_numpy(_tokens(cfg))
    logits_f, _ = PT.forward(params, toks, cfg)
    logits_p, cache = PT.prefill(params, toks, cfg, cache_len=24)
    np.testing.assert_allclose(logits_p.numpy(), logits_f[:, -1].numpy(),
                               rtol=2e-2, atol=1e-3)
    for c in cache:
        assert c.shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
        assert c.dtype == torch.bfloat16
        assert not bool(c[:, :, 16:].any())        # padding stays zero


@pytest.mark.parametrize("name", DENSE_CFGS)
def test_decode_matches_teacher_forcing(name):
    """Greedy decode step-by-step == forward on the extended sequence.
    (Dense configs, as in ``repro``: a MoE's capacity follows the token
    count, so one decoded token and a whole sequence drop differently.)"""
    _, cfg = _configs(name)
    params = _port_init(cfg, seed=2)
    toks = torch.from_numpy(_tokens(cfg))
    _, cache = PT.prefill(params, toks, cfg, cache_len=20)
    s = toks.shape[1]
    new_tok = torch.full((2,), 7, dtype=torch.int32)
    logits_d, cache = PT.decode_step(params, cache, new_tok, s, cfg)
    ext = torch.cat([toks, new_tok[:, None]], dim=1)
    logits_full, _ = PT.forward(params, ext, cfg)
    np.testing.assert_allclose(logits_d.numpy(), logits_full[:, -1].numpy(),
                               rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("name", MOE_CFGS)
def test_moe_aux_loss_positive(name):
    _, cfg = _configs(name)
    toks = torch.from_numpy(_tokens(cfg))
    _, metrics = PT.loss_fn(_port_init(cfg), {"tokens": toks,
                                              "labels": toks}, cfg)
    assert float(metrics["aux"]) >= 1.0   # Switch aux loss ≥ 1 (C-S)


@pytest.mark.parametrize("name", CFGS)
def test_param_count_close_to_formula(name):
    r_cfg, cfg = _configs(name)
    spec = PT.lm_spec(cfg)
    n = PL.param_count(spec)
    assert n == RL.param_count(RT.lm_spec(r_cfg))
    # formula covers matmul params; norms/biases add < 1%
    assert cfg.params_dense() <= n <= cfg.params_dense() * 1.01 + 1000


# ---------------------------------------------------------------------------
# the port against repro, from repro's parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CFGS)
def test_spec_matches_repro(name):
    r_cfg, p_cfg = _configs(name)
    want = jax.tree_util.tree_leaves(RT.lm_spec(r_cfg),
                                     is_leaf=lambda x: isinstance(
                                         x, RL.ParamSpec))
    got = PO.tree_leaves(PT.lm_spec(p_cfg))
    assert [(s.shape, s.axes, s.init, s.scale) for s in got] == \
        [(s.shape, s.axes, s.init, s.scale) for s in want]
    assert PT.cache_logical_axes() == RT.cache_logical_axes()
    ks, vs = PT.init_cache(p_cfg, 3, 10, device=CPU)
    rk, _ = RT.init_cache(r_cfg, 3, 10)
    assert ks.shape == vs.shape == rk.shape and ks.dtype == torch.bfloat16
    assert not bool(ks.any())


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_repro(name, repro_runs):
    run = repro_runs(name)
    params = _to_port(run["params"])
    logits, aux = PT.forward(params, torch.from_numpy(run["batch"]["tokens"]),
                             run["p_cfg"])
    assert logits.dtype == torch.float32
    _close(logits, run["logits"])
    np.testing.assert_allclose(float(aux), float(run["aux"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_repro(name, repro_runs):
    run = repro_runs(name)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    params = _to_port(run["params"])
    loss, metrics, grads = _port_value_and_grad(params, batch, run["p_cfg"])
    np.testing.assert_allclose(float(loss), float(run["loss"]),
                               rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(run["metrics"]) == ["aux", "ce"]
    _assert_grads_close(grads, run["grads"], params, batch, run["p_cfg"])


@pytest.mark.parametrize("loss_chunk,masked", [
    (None, False), (16, True), (24, True)],
    ids=["onepass", "chunk16_mask", "chunk24_ragged_mask"])
def test_loss_variants_match_repro(loss_chunk, masked):
    """``loss_chunk`` that divides the 64 tokens (scanned in ``repro``,
    one loop of checkpointed chunks in the port) and one that does not
    (one pass in both), with and without a 0/1 mask (the masked mean
    over max(Σmask, 1)), on phi4-mini's REDUCED config."""
    r_cfg, p_cfg = _configs("phi4-mini-3.8b")
    r_cfg = dataclasses.replace(r_cfg, loss_chunk=loss_chunk)
    p_cfg = dataclasses.replace(p_cfg, loss_chunk=loss_chunk)
    params = _repro_params("phi4-mini-3.8b")
    toks = _tokens(r_cfg, seed=3, shape=(2, 32))
    batch = {"tokens": toks, "labels": toks}        # make_batch's proxy
    if masked:
        batch["mask"] = (np.random.default_rng(4).random((2, 32)) < 0.6
                         ).astype(np.float32)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, b, r_cfg), has_aux=True))(params, batch)
    p_params = _to_port(params)
    p_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = _port_value_and_grad(p_params, p_batch, p_cfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(want_m["ce"]),
                               rtol=LOSS_RTOL)
    _assert_grads_close(grads, want_g, p_params, p_batch, p_cfg)


@pytest.mark.parametrize("name", ["dense", "moe", "dbrx-132b"])
def test_remat_modes_give_the_same_bits(name):
    _, cfg = _configs(name)
    params = _port_init(cfg, seed=5)
    toks = torch.from_numpy(_tokens(cfg, seed=5))
    batch = {"tokens": toks, "labels": toks}
    runs = [_port_value_and_grad(params, batch, dataclasses.replace(
        cfg, remat=remat)) for remat in ("none", "dots", "full")]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2]))


def test_dots_policy_keeps_unbatched_products_only():
    """``remat="dots"`` saves what ``mm`` and one-batch ``bmm`` produce
    (the projections and FFN products) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    save, redo = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    x2, x3 = torch.ones(2, 2), torch.ones(1, 2, 2)
    assert PT._dots_policy(None, mm, x2, x2) == save
    assert PT._dots_policy(None, bmm, x3, x3) == save
    assert PT._dots_policy(None, bmm, torch.ones(4, 2, 2), x3) == redo
    assert PT._dots_policy(None, torch.ops.aten.exp.default, x2) == redo


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_repro(name, repro_runs):
    """``prefill`` into a 40-slot cache, then one ``decode_step`` at
    position 32: logits and both caches (the port's updated in place)."""
    run = repro_runs(name)
    params = _to_port(run["params"])
    cfg = run["p_cfg"]
    logits, (ks, vs) = PT.prefill(
        params, torch.from_numpy(run["batch"]["tokens"]), cfg, cache_len=40)
    want_logits, (want_k, want_v) = run["pre"]
    _close(logits, want_logits)
    _close(ks, want_k)
    _close(vs, want_v)
    dec_logits, (dk, dv) = PT.decode_step(
        params, (ks, vs), torch.from_numpy(run["nxt"]), 32, cfg)
    assert dk is ks and dv is vs
    want_d, (want_dk, want_dv) = run["dec"]
    _close(dec_logits, want_d)
    _close(dk, want_dk)
    _close(dv, want_dv)


@pytest.mark.parametrize("n_layers", [2, 8])
def test_stacked_init_counts_depth_in_fan_in(n_layers):
    """Both packages draw a stacked ``normal`` leaf at std 1/√L: its
    fan-in is its shape[0], the layer count, so init statistics depend on
    depth (a reference quirk, kept)."""
    common = dict(_DENSE, n_layers=n_layers, d_model=64, d_ff=128)
    r_params = _repro_init(jax.random.PRNGKey(0), RLMConfig(**common))
    p_params = _port_init(LMConfig(**common))
    want = 1 / np.sqrt(n_layers)
    for params in (r_params, p_params):
        std = float(np.std(np.asarray(params["layers"]["attn"]["wq"])))
        assert std == pytest.approx(want, rel=0.05)
    assert float(p_params["embed"].std()) == pytest.approx(0.02, rel=0.05)
