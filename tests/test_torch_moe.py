"""``repro_torch.models.moe`` against ``repro.models.moe``.

From ``repro``'s parameters (``state_from_numpy``) on bf16 tokens made
from a numpy seed: ``moe_ffn``'s output and aux loss for SwiGLU, squared
ReLU and GELU experts, with and without capacity drops, and its
gradients; the dispatch itself (the same tokens kept in the same slots,
the same tokens dropped); router ties broken to the lowest expert in both
packages; and the activations, which follow XLA's own evaluation of
``jax.nn.silu`` and ``jax.nn.gelu`` op for op.  Bars (the port's bf16
bars): activations rtol = atol = 1.6e-2, losses 1e-3 relative, gradient
leaves at cosine ≥ 0.999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import LMConfig as RLMConfig  # noqa: E402
from repro.configs.base import MoEConfig as RMoEConfig  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro_torch.configs.base import LMConfig, MoEConfig  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.train.optimizer import (tree_leaves,  # noqa: E402
                                         tree_unflatten)
from repro_torch.train.trainer import state_from_numpy  # noqa: E402

CPU = "cpu"
BF16_TOL = 1.6e-2
LOSS_RTOL = 1e-3
GRAD_COS = 0.999

CASES = {  # name → (ffn, experts, top-k, capacity factor)
    "swiglu": ("swiglu", 4, 2, 1.25),
    "squared_relu": ("squared_relu", 8, 2, 1.25),
    "gelu": ("gelu", 4, 1, 1.25),
    "drops": ("swiglu", 4, 2, 0.5),
    "drops_gelu": ("gelu", 8, 3, 0.3),
}


def _configs(name):
    ffn, e, k, cf = CASES[name]
    common = dict(name=name, n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                  d_ff=16, vocab_size=64, ffn=ffn)
    return (RLMConfig(**common, moe=RMoEConfig(e, k, capacity_factor=cf)),
            LMConfig(**common, moe=MoEConfig(e, k, capacity_factor=cf)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=BF16_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _setup(name, seed=0, t=48):
    r_cfg, p_cfg = _configs(name)
    r_params = RL.init_params(jax.random.PRNGKey(seed), RM.moe_spec(r_cfg))
    p_params = state_from_numpy(jax.tree_util.tree_map(np.asarray, r_params),
                                CPU)
    x = np.random.default_rng(seed).standard_normal(
        (t, r_cfg.d_model)).astype(np.float32)
    return (r_cfg, p_cfg, r_params, p_params,
            jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _capacity(cfg, t):
    moe = cfg.moe
    return max(1, int(moe.capacity_factor * t * moe.top_k / moe.n_experts))


def test_spec_matches_repro():
    for name in CASES:
        r_cfg, p_cfg = _configs(name)
        want, got = RM.moe_spec(r_cfg), PM.moe_spec(p_cfg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert (got[k].shape, got[k].axes, got[k].init) == \
                (want[k].shape, want[k].axes, want[k].init)
    assert PM._n_groups(48) == RM._n_groups(48) == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_matches_repro(name):
    r_cfg, p_cfg, r_p, p_p, rx, px = _setup(name)
    want_out, want_aux = jax.jit(lambda p, x: RM.moe_ffn(p, x, r_cfg))(r_p, rx)
    got_out, got_aux = PM.moe_ffn(p_p, px, p_cfg)
    assert got_out.dtype == torch.bfloat16 and got_aux.dtype == torch.float32
    _close(got_out, want_out)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["swiglu", "drops", "drops_gelu"])
def test_dispatch_keeps_and_drops_the_same_tokens(name):
    """The capacity drop keeps each expert's first tokens in both
    packages: the same kept mask, slots and dispatch buffer, bit for bit,
    and (with a low capacity factor) some tokens really dropped."""
    r_cfg, p_cfg, _, _, rx, px = _setup(name, seed=1)
    t, e, k = rx.shape[0], r_cfg.moe.n_experts, r_cfg.moe.top_k
    cap = _capacity(r_cfg, t)
    ids = np.random.default_rng(2).integers(0, e, (t, k)).astype(np.int32)
    gate = np.random.default_rng(3).random((t, k)).astype(np.float32)
    r_buf, r_meta = RM._dispatch_group(rx, jnp.asarray(ids),
                                       jnp.asarray(gate), cap, e, jnp.bfloat16)
    p_buf, p_meta = PM._dispatch_group(px, torch.from_numpy(ids).long(),
                                       torch.from_numpy(gate), cap, e,
                                       torch.bfloat16)
    _, r_slot, r_token, r_keep, _ = r_meta
    _, p_e, p_slot, p_keep, _ = p_meta
    np.testing.assert_array_equal(p_keep.numpy(), np.asarray(r_keep))
    np.testing.assert_array_equal(p_slot.numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(_np(p_buf), _np(r_buf))
    if CASES[name][3] < 1:
        assert not bool(p_keep.all())


def test_router_ties_go_to_the_lowest_expert():
    """Exact ties in the router's probabilities: with a zero router every
    expert ties, and with duplicated router columns pairs tie.  Both
    packages pick the lowest experts, in the same order."""
    r_cfg, p_cfg, r_p, p_p, rx, px = _setup("swiglu", seed=4, t=16)
    rng = np.random.default_rng(5)
    router = rng.standard_normal((r_cfg.d_model, 4)).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    for w in (np.zeros_like(router), router):
        r_p = dict(r_p, router=jnp.asarray(w))
        p_p = dict(p_p, router=torch.from_numpy(w))
        probs = jax.nn.softmax(rx.astype(jnp.float32) @ r_p["router"], -1)
        want = np.asarray(jax.lax.top_k(probs, 2)[1])
        got = PM._router_top_k(torch.softmax(px.float() @ p_p["router"], -1),
                               2)[1].numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] < got[:, 1]).all()      # a tie: lower one first
        want_out, _ = jax.jit(lambda p, x: RM.moe_ffn(p, x, r_cfg))(r_p, rx)
        _close(PM.moe_ffn(p_p, px, p_cfg)[0], want_out)


def test_load_balance_loss_matches_repro():
    rng = np.random.default_rng(6)
    probs = rng.random((2, 24, 8)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    ids = rng.integers(0, 8, (2, 24)).astype(np.int32)
    want = RM.load_balance_loss(jnp.asarray(probs), jnp.asarray(ids), 8)
    got = PM.load_balance_loss(torch.from_numpy(probs),
                               torch.from_numpy(ids), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["swiglu", "squared_relu", "drops_gelu"])
def test_moe_grads_match_repro(name):
    r_cfg, p_cfg, r_p, p_p, rx, px = _setup(name, seed=7)
    w = np.random.default_rng(8).standard_normal(
        (rx.shape[0], r_cfg.d_model)).astype(np.float32)

    def r_loss(p):
        out, aux = RM.moe_ffn(p, rx, r_cfg)
        return jnp.sum(out.astype(jnp.float32) * w) + aux

    want = jax.jit(jax.grad(r_loss))(r_p)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(p_p)]
    out, aux = PM.moe_ffn(tree_unflatten(p_p, leaves), px, p_cfg)
    got = torch.autograd.grad(
        torch.sum(out.float() * torch.from_numpy(w)) + aux, leaves)
    for g, want_leaf in zip(got, jax.tree_util.tree_leaves(want)):
        a = g.double().numpy().ravel()
        b = np.asarray(want_leaf, np.float64).ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= GRAD_COS


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_activations_follow_jax(dtype):
    """``silu`` and ``gelu_tanh`` against ``jax.nn.silu`` / ``jax.nn.gelu``
    (whose default is the tanh form): bit for bit in bf16, as XLA
    evaluates them op for op; within 1e-6 in f32."""
    x = (np.random.default_rng(9).standard_normal(8192) * 6).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for ours, theirs in ((PL.silu, jax.nn.silu), (PL.gelu_tanh, jax.nn.gelu)):
        got, want = _np(ours(tx)), _np(jax.jit(theirs)(jx))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gelu_is_the_tanh_form_not_erf():
    """torch's default GELU is the erf form; the port's is jax's tanh."""
    x = torch.linspace(-4, 4, 801)
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    np.testing.assert_allclose(PL.gelu_tanh(x).numpy(), tanh.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert (PL.gelu_tanh(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_combine_repeats_and_needs_no_scatter_add():
    """Two forwards give the same bits, and a token routed to k experts
    sums their outputs in dispatch order (by expert)."""
    r_cfg, p_cfg, _, p_p, _, px = _setup("drops", seed=10)
    a, _ = PM.moe_ffn(p_p, px, p_cfg)
    b, _ = PM.moe_ffn(p_p, px, p_cfg)
    assert torch.equal(a, b)
    p_cfg = dataclasses.replace(p_cfg, moe=dataclasses.replace(
        p_cfg.moe, capacity_factor=8.0))
    t, d = px.shape
    e, k = p_cfg.moe.n_experts, p_cfg.moe.top_k
    ids = torch.tensor([[1, 0]] * t)
    gate = torch.full((t, k), 0.5)
    buf, meta = PM._dispatch_group(px, ids, gate, t, e, torch.bfloat16)
    out_buf = torch.randn((e, t, d)).to(torch.bfloat16)
    out = PM._combine_group(out_buf, meta, t, torch.bfloat16)
    half = lambda x: x * torch.tensor(0.5, dtype=torch.bfloat16)
    want = (torch.zeros((t, d), dtype=torch.bfloat16)
            + half(out_buf[0, :t])) + half(out_buf[1, :t])
    assert torch.equal(out, want)
