"""``repro_torch.models.attention`` against ``repro.models.attention``.

Every case starts from ``repro``'s parameters (``state_from_numpy``) and
one bf16 input made from a numpy seed.  Both schedules (query-chunked and
online), a sequence that the chunk divides and one it does not (one chunk
then), ``qkv_bias``, GQA and MHA, and ``head_dim`` ≠ d/H (as in qwen3).
Bars (the port's bf16 bars, as for the recsys models): activations
rtol = atol = 1.6e-2, gradient leaves at cosine ≥ 0.999.  Decode writes
the new k and v into the caches at ``pos`` (in place in the port) and
masks the slots above it; it is held at several positions, first slot
and last included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import LMConfig as RLMConfig  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs.base import LMConfig  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.train.optimizer import (tree_leaves,  # noqa: E402
                                         tree_unflatten)
from repro_torch.train.trainer import state_from_numpy  # noqa: E402

CPU = "cpu"
BF16_TOL = 1.6e-2
GRAD_COS = 0.999

CASES = {  # name → (LMConfig fields, sequence length)
    "gqa_bias": (dict(d_model=32, n_heads=4, n_kv_heads=2, qkv_bias=True,
                      attn_q_chunk=8), 32),
    "gqa_ragged": (dict(d_model=32, n_heads=4, n_kv_heads=2, qkv_bias=True,
                        attn_q_chunk=8), 20),
    "mha": (dict(d_model=32, n_heads=4, n_kv_heads=4, attn_q_chunk=16), 48),
    "head_dim": (dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=24,
                      attn_q_chunk=8), 24),
}


def _configs(name, impl):
    fields, s = CASES[name]
    common = dict(name=name, n_layers=1, d_ff=64, vocab_size=64,
                  attn_impl=impl, **fields)
    return RLMConfig(**common), LMConfig(**common), s


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=BF16_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _setup(name, impl, seed=0, batch=2):
    r_cfg, p_cfg, s = _configs(name, impl)
    r_params = RL.init_params(jax.random.PRNGKey(seed),
                              RA.attention_spec(r_cfg))
    p_params = state_from_numpy(jax.tree_util.tree_map(np.asarray, r_params),
                                CPU)
    x = np.random.default_rng(seed).standard_normal(
        (batch, s, r_cfg.d_model)).astype(np.float32)
    return (r_cfg, p_cfg, r_params, p_params,
            jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _angles(cfg, n):
    return (RL.rope_angles(cfg.resolved_head_dim, n, cfg.rope_theta),
            PL.rope_angles(cfg.resolved_head_dim, n, cfg.rope_theta,
                           device=CPU))


def test_constants_and_spec_match_repro():
    assert PA.NEG_INF == RA.NEG_INF == -1e30
    for name in CASES:
        for bias in (False, True):
            r_cfg, p_cfg, _ = _configs(name, "chunked")
            r_cfg = dataclasses.replace(r_cfg, qkv_bias=bias)
            p_cfg = dataclasses.replace(p_cfg, qkv_bias=bias)
            want = RA.attention_spec(r_cfg)
            got = PA.attention_spec(p_cfg)
            assert sorted(got) == sorted(want)
            for k in want:
                assert (got[k].shape, got[k].axes, got[k].init) == \
                    (want[k].shape, want[k].axes, want[k].init)


@pytest.mark.parametrize("s,chunk,want", [(32, 8, 8), (20, 8, 20),
                                          (8, 16, 8), (16, None, 16)])
def test_chunk_rule(s, chunk, want):
    """``min(attn_q_chunk or s, s)``; a length the chunk does not divide
    is one chunk."""
    cfg = LMConfig("c", 1, 8, 2, 2, 8, 8, attn_q_chunk=chunk)
    assert PA._q_chunk(cfg, s) == want


@pytest.mark.parametrize("impl", ["chunked", "online"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_self_attention_matches_repro(name, impl):
    r_cfg, p_cfg, r_p, p_p, rx, px = _setup(name, impl)
    (rc, rs), (pc, ps) = _angles(r_cfg, rx.shape[1])
    want = jax.jit(lambda p, x: RA.self_attention(p, x, rc, rs, r_cfg))(
        r_p, rx)
    got = PA.self_attention(p_p, px, pc, ps, p_cfg)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_online_equals_chunked_in_the_port(name):
    """The two schedules compute one function, rounding at other places
    (the online form's running f32 sums; bf16 weights per tile): equal
    within the bar, its atol scaled by max|output| as the output
    projection sums with cancellation."""
    _, p_cfg, _, p_p, _, px = _setup(name, "chunked", seed=1)
    pc, ps = PL.rope_angles(p_cfg.resolved_head_dim, px.shape[1],
                            device=CPU)
    a = PA.self_attention(p_p, px, pc, ps, p_cfg)
    b = PA.self_attention(p_p, px, pc, ps,
                          dataclasses.replace(p_cfg, attn_impl="online"))
    np.testing.assert_allclose(_np(b), _np(a), rtol=BF16_TOL,
                               atol=BF16_TOL * float(a.abs().max()))


@pytest.mark.parametrize("impl", ["chunked", "online"])
def test_prefill_attention_returns_repro_kv(impl):
    r_cfg, p_cfg, r_p, p_p, rx, px = _setup("gqa_bias", impl)
    (rc, rs), (pc, ps) = _angles(r_cfg, rx.shape[1])
    want = jax.jit(lambda p, x: RA.prefill_attention(p, x, rc, rs, r_cfg))(
        r_p, rx)
    got = PA.prefill_attention(p_p, px, pc, ps, p_cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w)


@pytest.mark.parametrize("impl", ["chunked", "online"])
@pytest.mark.parametrize("name", ["gqa_bias", "head_dim"])
def test_self_attention_grads_match_repro(name, impl):
    r_cfg, p_cfg, r_p, p_p, rx, px = _setup(name, impl, seed=2)
    (rc, rs), (pc, ps) = _angles(r_cfg, rx.shape[1])
    w = np.random.default_rng(3).standard_normal(
        (rx.shape[1], r_cfg.d_model)).astype(np.float32)
    r_loss = lambda p: jnp.sum(RA.self_attention(
        p, rx, rc, rs, r_cfg).astype(jnp.float32) * w)
    want = jax.jit(jax.grad(r_loss))(r_p)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(p_p)]
    out = PA.self_attention(tree_unflatten(p_p, leaves), px, pc, ps, p_cfg)
    got = torch.autograd.grad(torch.sum(out.float() * torch.from_numpy(w)),
                              leaves)
    for g, want_leaf in zip(got, jax.tree_util.tree_leaves(want)):
        a = g.double().numpy().ravel()
        b = np.asarray(want_leaf, np.float64).ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= GRAD_COS


@pytest.mark.parametrize("pos", [0, 5, 17, 23])
@pytest.mark.parametrize("name", ["gqa_bias", "mha", "head_dim"])
def test_decode_attention_matches_repro(name, pos):
    """One token against a 24-slot cache of random rows (the slots above
    ``pos`` are masked, as rows a longer earlier request left there would
    be): the output and both updated caches; the port's caches are the
    ones passed in, and only slot ``pos`` changes."""
    r_cfg, p_cfg, r_p, p_p, _, _ = _setup(name, "chunked", seed=4)
    rng = np.random.default_rng(pos)
    b, s_max = 2, 24
    hd, kv = r_cfg.resolved_head_dim, r_cfg.n_kv_heads
    x = rng.standard_normal((b, 1, r_cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    (rc, rs), (pc, ps) = _angles(r_cfg, s_max)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    want = jax.jit(lambda p, x, k, v, i: RA.decode_attention(
        p, x, k, v, i, rc, rs, r_cfg))(r_p, bf(x), bf(ck), bf(cv),
                                       jnp.asarray(pos))
    p_k, p_v = tb(ck), tb(cv)
    out, got_k, got_v = PA.decode_attention(p_p, tb(x), p_k, p_v, pos, pc,
                                            ps, p_cfg)
    assert got_k is p_k and got_v is p_v
    _close(out, want[0])
    _close(got_k, want[1])
    _close(got_v, want[2])
    # untouched slots keep their bits; a tensor position works the same
    keep = [i for i in range(s_max) if i != pos]
    assert torch.equal(got_k[:, keep], tb(ck)[:, keep])
    again = PA.decode_attention(p_p, tb(x), tb(ck), tb(cv),
                                torch.tensor(pos), pc, ps, p_cfg)[0]
    assert torch.equal(again, out)
