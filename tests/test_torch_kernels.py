"""Each kernel's plain version against ``repro``'s Pallas kernel.

The Pallas kernels run with ``interpret=True`` on the CPU, as
``tests/test_kernels.py`` runs them.  On CPU tensors the port's kernel
wrappers run these plain versions; the CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.

Bars: binary_ip and topk_blocks exactly (integer arithmetic, scores that
are 0.25 × an integer / ordering);
int8_ip to atol = 1e-5·max|scores| (f32 summation order), and the ops to
the reference's own bars (``tests/test_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core.quantization import Int8Quantizer, pack_bits  # noqa: E402
from repro.kernels.binary_ip import ops as r_bops  # noqa: E402
from repro.kernels.binary_ip import ref as r_bref  # noqa: E402
from repro.kernels.binary_ip.kernel import binary_ip_pallas  # noqa: E402
from repro.kernels.int8_ip import ops as r_iops  # noqa: E402
from repro.kernels.int8_ip import ref as r_iref  # noqa: E402
from repro.kernels.int8_ip.kernel import int8_ip_pallas  # noqa: E402
from repro.kernels.topk_blocks import ops as r_tops  # noqa: E402
from repro.kernels.topk_blocks.kernel import topk_blocks_pallas  # noqa: E402
from repro_torch.core.quantization import words_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.binary_ip import ops as p_bops  # noqa: E402
from repro_torch.kernels.binary_ip.kernel import binary_ip  # noqa: E402
from repro_torch.kernels.binary_ip.ref import (binary_ip_ref,  # noqa: E402
                                               sign_dot_ref)
from repro_torch.kernels.int8_ip import ops as p_iops  # noqa: E402
from repro_torch.kernels.int8_ip.kernel import int8_ip  # noqa: E402
from repro_torch.kernels.int8_ip.ref import int8_ip_ref  # noqa: E402
from repro_torch.kernels.topk_blocks import ops as p_tops  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.kernels.topk_blocks.kernel import (topk_blocks,  # noqa: E402
                                                    topk_merge)
from repro_torch.kernels.topk_blocks.ref import topk_blocks_ref  # noqa: E402
from repro_torch.retrieval.topk import topk_score_then_id  # noqa: E402


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _int8_case(q, d, dim, seed):
    rng = np.random.default_rng(seed)
    queries, docs = _rand(rng, q, dim), _rand(rng, d, dim)
    quant = Int8Quantizer().fit(jnp.asarray(docs))
    codes = np.asarray(quant.encode(jnp.asarray(docs)))
    scale = np.asarray(quant.state["scale"])
    zero = np.asarray(quant.state["zero"])
    return queries, codes, scale, zero


# ---------------------------------------------------------------------------
# int8_ip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,d,dim,bq,bd", [(5, 37, 48, 8, 16),
                                           (16, 100, 64, 8, 32),
                                           (1, 3, 128, 8, 16)])
def test_int8_ip_ref_matches_pallas(q, d, dim, bq, bd):
    queries, codes, scale, _ = _int8_case(q, d, dim, q + d)
    q_scaled = (jnp.asarray(queries) * scale).astype(jnp.bfloat16)
    want = np.asarray(int8_ip_pallas(q_scaled, jnp.asarray(codes), block_q=bq,
                                     block_d=bd, interpret=True))
    got_q = (torch.from_numpy(queries) * torch.from_numpy(scale)) \
        .to(torch.bfloat16)
    got = int8_ip_ref(got_q, torch.from_numpy(codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(int8_ip(got_q, torch.from_numpy(codes))
                                  .numpy(), got)


@pytest.mark.parametrize("q,d,dim", [(5, 37, 48), (16, 100, 64),
                                     (7, 64, 100)])
def test_int8_ip_bias_is_one_add(q, d, dim):
    """The kernel's epilogue bias: one f32 add of the finished sum, so the
    wrapper equals the plain product plus bias[:, None] bit for bit."""
    queries, codes, scale, zero = _int8_case(q, d, dim, q * d)
    tq = (torch.from_numpy(queries) * torch.from_numpy(scale)) \
        .to(torch.bfloat16)
    tc = torch.from_numpy(codes)
    bias = torch.from_numpy(queries) @ torch.from_numpy(zero)
    want = int8_ip_ref(tq, tc) + bias[:, None]
    assert torch.equal(int8_ip_ref(tq, tc, bias), want)
    assert torch.equal(int8_ip(tq, tc, bias=bias), want)


def test_int8_ip_rejects_a_bad_bias():
    q = torch.zeros(2, 4, dtype=torch.bfloat16)
    u8 = torch.zeros(3, 4, dtype=torch.uint8)
    for bad in (torch.zeros(3), torch.zeros(2, dtype=torch.float64),
                torch.zeros(2, 1)):
        with pytest.raises(ValueError):
            int8_ip(q, u8, bias=bad)


@pytest.mark.parametrize("sim", ["ip", "l2"])
@pytest.mark.parametrize("q,d,dim", [(5, 37, 48), (16, 100, 64),
                                     (7, 64, 100)])
def test_int8_scores_both_numerics(sim, q, d, dim):
    queries, codes, scale, zero = _int8_case(q, d, dim, q + d)
    jq, jc, js, jz = (jnp.asarray(a) for a in (queries, codes, scale, zero))
    tq, tc, ts, tz = (torch.from_numpy(a) for a in (queries, codes, scale,
                                                    zero))
    oracle = np.asarray(r_iref.int8_scores_ref(jq, jc, js, jz, sim))
    mag = np.abs(oracle).max()
    # jnp numerics: decode to f32, GEMM
    got = p_iops.int8_scores(tq, tc, ts, tz, sim, use_kernel=False).numpy()
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5 * mag)
    # pallas numerics: bf16(q⊙scale) × u8, as repro's interpret-mode path
    want = np.asarray(r_iops.int8_scores(jq, jc, js, jz, sim,
                                         use_pallas=True, interpret=True,
                                         block_q=8, block_d=16))
    got = p_iops.int8_scores(tq, tc, ts, tz, sim, use_kernel=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * mag)
    np.testing.assert_allclose(got, oracle, atol=0.02 * mag)  # bf16 queries


# ---------------------------------------------------------------------------
# binary_ip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,d,dim,bq,bd", [(7, 33, 64, 8, 16),
                                           (32, 128, 96, 16, 64),
                                           (1, 5, 32, 8, 8),
                                           (64, 300, 256, 32, 128)])
def test_sign_dot_ref_matches_pallas(q, d, dim, bq, bd):
    rng = np.random.default_rng(q * d)
    queries, docs = _rand(rng, q, dim), _rand(rng, d, dim)
    signs = np.where(queries >= 0, 1, -1).astype(np.int8)
    words = np.asarray(pack_bits(jnp.asarray(docs)))
    want = np.asarray(binary_ip_pallas(jnp.asarray(signs), jnp.asarray(words),
                                       block_q=bq, block_d=bd, interpret=True))
    got = sign_dot_ref(torch.from_numpy(signs), words_from_numpy(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's entry writes the scaled f32 score, 0.25·dot, exactly
    scores = binary_ip(torch.from_numpy(signs), words_from_numpy(words))
    assert scores.dtype == torch.float32
    np.testing.assert_array_equal(scores.numpy(),
                                  0.25 * want.astype(np.float32))


@pytest.mark.parametrize("offset", [0.5, 0.0, 0.25])
@pytest.mark.parametrize("dim", [64, 45])
def test_binary_ip_scores_both_backends(offset, dim):
    rng = np.random.default_rng(0)
    queries, docs = _rand(rng, 9, dim), _rand(rng, 40, dim)
    pad = (-dim) % 32
    docs_p = np.pad(docs, ((0, 0), (0, pad)), constant_values=-1.0)
    words = np.asarray(pack_bits(jnp.asarray(docs_p)))
    want = np.asarray(r_bops.binary_ip_scores(
        jnp.asarray(queries), jnp.asarray(words), dim, offset=offset,
        use_pallas=True, interpret=True, block_q=8, block_d=16))
    for use_kernel in (False, True):
        got = p_bops.binary_ip_scores(torch.from_numpy(queries),
                                      words_from_numpy(words), dim,
                                      offset=offset, use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), want)
    if dim % 32 == 0:   # the reference's f32 oracle
        ref = np.asarray(r_bref.binary_ip_scores_ref(
            pack_bits(jnp.asarray(queries)), jnp.asarray(words), dim, offset))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("offset", [0.5, 0.0, 0.25])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_words,q,d", [(1, 7, 33), (3, 5, 101),
                                         (8, 13, 257), (9, 3, 65)])
def test_binary_ip_f32_scores_match_repro_pallas(n_words, q, d, packed,
                                                 offset):
    """The f32 entry's plain version (what CPU tensors run) against
    ``repro``'s ``binary_ip_scores(use_pallas=True)`` in interpret mode,
    bit for bit: 1, 3, 8 and 9 words, odd Q and D, float queries (the
    packed width padded past d) and packed ones, and the α ≠ 0.5 offset
    terms added to the new f32 values."""
    rng = np.random.default_rng(100 * n_words + q)
    dim = 32 * n_words if packed else 32 * n_words - 5
    queries, docs = _rand(rng, q, dim), _rand(rng, d, dim)
    docs_p = np.pad(docs, ((0, 0), (0, 32 * n_words - dim)),
                    constant_values=-1.0)
    words = np.asarray(pack_bits(jnp.asarray(docs_p)))
    q_r = pack_bits(jnp.asarray(queries)) if packed else jnp.asarray(queries)
    want = np.asarray(r_bops.binary_ip_scores(
        q_r, jnp.asarray(words), dim, offset=offset, use_pallas=True,
        interpret=True, block_q=8, block_d=16))
    q_p = words_from_numpy(np.asarray(q_r)) if packed \
        else torch.from_numpy(queries)
    words_t = words_from_numpy(words)
    got = p_bops.binary_ip_scores(q_p, words_t, dim, offset=offset,
                                  use_kernel=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if offset == 0.5:   # the entry itself, and its plain version
        signs = p_bops._query_signs(q_p, n_words, dim)
        for entry in (binary_ip, binary_ip_ref):
            np.testing.assert_array_equal(
                _bits(entry(signs, words_t).numpy()), _bits(want))


def test_binary_ip_scores_packed_queries():
    rng = np.random.default_rng(1)
    queries, docs = _rand(rng, 5, 32), _rand(rng, 20, 32)
    qp, dp = pack_bits(jnp.asarray(queries)), pack_bits(jnp.asarray(docs))
    want = np.asarray(r_bops.binary_ip_scores(qp, dp, 32, use_pallas=False))
    got = p_bops.binary_ip_scores(words_from_numpy(np.asarray(qp)),
                                  words_from_numpy(np.asarray(dp)), 32)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# topk_blocks
# ---------------------------------------------------------------------------


def _tie_matrix():
    return np.tile(np.arange(16)[::-1] // 2, (3, 1)).astype(np.float32)


@pytest.mark.parametrize("q,d,k,bd", [(10, 333, 7, 64), (3, 50, 10, 16),
                                      (33, 1000, 16, 128), (4, 20, 20, 8)])
def test_topk_blocks_ref_matches_pallas(q, d, k, bd):
    """Pads and short last blocks included: (3, 50, 10, 16) leaves two real
    columns in its last block; (4, 20, 20, 8) has k > block_d."""
    rng = np.random.default_rng(q * d + k)
    scores = _rand(rng, q, d)
    wv, wi = topk_blocks_pallas(jnp.asarray(scores), k, block_q=8,
                                block_d=bd, interpret=True)
    gv, gi = topk_blocks_ref(torch.from_numpy(scores), k, bd)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    kv, ki = topk_blocks(torch.from_numpy(scores), k, bd)
    assert torch.equal(kv, gv) and torch.equal(ki, gi)


@pytest.mark.parametrize("k,bd", [(4, 8), (16, 16), (5, 4)])
def test_topk_blocks_ref_matches_pallas_with_ties(k, bd):
    scores = _tie_matrix()
    wv, wi = topk_blocks_pallas(jnp.asarray(scores), k, block_q=2,
                                block_d=bd, interpret=True)
    gv, gi = topk_blocks_ref(torch.from_numpy(scores), k, bd)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _signed_zeros():
    """−0.0 and +0.0 tied at the top of a block, in both column orders."""
    s = np.full((3, 24), -1.0, np.float32)
    s[0, [2, 5, 9]] = [-0.0, 0.0, -0.0]
    s[1, [1, 4, 17]] = [0.0, -0.0, 0.0]
    s[2, ::2] = -0.0
    s[2, 1::2] = 0.0
    return s


def _more_neg_inf_than_k():
    """A block with 3 finite columns and k = 6: its tail is (−inf, the
    block's first column), through the D-padding of the last block too."""
    s = np.full((2, 20), -np.inf, np.float32)
    s[0, [3, 11, 19]] = [0.5, -2.0, 0.5]
    s[1, [0, 8, 9, 17]] = [1.0, 1.0, -1.0, 3.0]
    return s


@pytest.mark.parametrize("case,k,bd", [(_signed_zeros, 4, 8),
                                       (_signed_zeros, 5, 24),
                                       (_more_neg_inf_than_k, 6, 8),
                                       (_more_neg_inf_than_k, 6, 16)])
def test_topk_blocks_ref_matches_pallas_zeros_and_neg_inf(case, k, bd):
    scores = case()
    wv, wi = topk_blocks_pallas(jnp.asarray(scores), k, block_q=2,
                                block_d=bd, interpret=True)
    gv, gi = topk_blocks_ref(torch.from_numpy(scores), k, bd)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [110, 1010])
def test_streaming_topk_default_block_matches_repro(k):
    """The new default_block_d (4096 at k = 110, 32,768 at k = 1,010) gives
    repro's two-stage ranking: its interpret-mode Pallas kernel at k = 110,
    its lax.top_k order at k = 1,010 (whose rounds the interpreter unrolls
    too slowly)."""
    rng = np.random.default_rng(k)
    scores = np.round(_rand(rng, 4, 3000) * 8)    # many ties
    if k == 110:
        want = r_tops.streaming_topk(jnp.asarray(scores), k, use_pallas=True,
                                     interpret=True, block_q=8, block_d=1024)
    else:
        want = r_tops.streaming_topk(jnp.asarray(scores), k)
    gv, gi = p_tops.streaming_topk(torch.from_numpy(scores), k,
                                   use_kernel=True)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("q,d,k,bd", [(10, 333, 7, 64), (3, 50, 10, 16),
                                      (33, 1000, 16, 128)])
@pytest.mark.parametrize("ties", [False, True])
def test_streaming_topk_matches_repro(q, d, k, bd, ties):
    rng = np.random.default_rng(q * d + k)
    scores = _rand(rng, q, d)
    if ties:
        scores = np.round(scores * 2)
    want = r_tops.streaming_topk(jnp.asarray(scores), k, use_pallas=True,
                                 interpret=True, block_q=8, block_d=bd)
    for use_kernel in (False, True):
        gv, gi = p_tops.streaming_topk(torch.from_numpy(scores), k,
                                       use_kernel=use_kernel, block_d=bd)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(want[1]))


def _normal(q, d):
    return lambda: _rand(np.random.default_rng(q * d), q, d)


def _ties_at_kth():
    """Values 0 … 3 over 300 columns: each row's k-th value is held by
    ~75 columns across every block."""
    return np.random.default_rng(3).integers(0, 4, (4, 300)).astype(
        np.float32)


@pytest.mark.parametrize("case,k,bd", [
    (_normal(3, 200), 4, 16),        # 13 lists ≥ k = 4; ragged last block
    (_normal(3, 100), 10, 32),       # 4 lists < k = 10; ragged last block
    (_normal(4, 20), 20, 8),         # k > block_d: −inf pads in each list
    (_ties_at_kth, 8, 32),           # heavy ties at the k-th value
    (_signed_zeros, 5, 8),           # −0.0 and +0.0 tied, both orders
    (_more_neg_inf_than_k, 6, 8),    # fewer than k finite entries a row
    (_normal(3, 50), 10, 64)],       # a single block
    ids=["lists_ge_k", "lists_lt_k", "k_gt_block", "ties_at_kth",
         "signed_zeros", "few_finite", "one_block"])
def test_topk_merge_is_stage_two(case, k, bd):
    """``topk_merge`` on CPU tensors (its plain version) is stage 2 on
    ``topk_blocks_ref``'s candidates bit for bit, and the full row's top k
    (ids equal wherever the value is finite: the full row's −inf slots
    name the row's lowest −inf columns, stage 2's the blocks' pads).  On
    meta tensors it gives the outputs' shapes and dtypes; it launches
    nothing on the CPU."""
    scores = torch.from_numpy(case())
    k = min(k, scores.shape[1])
    cv, ci = topk_blocks_ref(scores, k, bd)
    launches = tracing.counters().get("topk_merge.launches", 0)
    gv, gi = topk_merge(cv, ci, k)
    assert tracing.counters().get("topk_merge.launches", 0) == launches
    wv, wi = topk_score_then_id(cv, ci, k)
    assert gi.dtype == torch.int64 and gv.shape == (scores.shape[0], k)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(gi, wi.long())
    rv, ri = p_tops.streaming_topk(scores, k, use_kernel=False)
    fin = torch.isfinite(rv)
    assert torch.equal(gv.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(gi[fin], ri[fin])
    sv, si = p_tops.streaming_topk(scores, k, use_kernel=True, block_d=bd)
    assert torch.equal(sv.view(torch.int32), gv.view(torch.int32))
    assert torch.equal(si, gi)
    mv, mi = topk_merge(cv.to("meta"), ci.to("meta"), k)
    assert mv.device.type == mi.device.type == "meta"
    assert (mv.shape, mv.dtype, mi.shape, mi.dtype) == \
        (gv.shape, torch.float32, gi.shape, torch.int64)


@pytest.mark.parametrize("k,want", [(1, 1024), (10, 1024), (1024, 32768),
                                    (1025, 32768), (5000, 32768),
                                    (100, 4096), (110, 4096), (1010, 32768),
                                    (40000, 65536)])
def test_default_block_d_holds_k(k, want):
    """max(1024, next_pow2(k), min(32768, next_pow2(32·k))): a block holds
    k, and stage 2 sees about 1/32 of a row at deep k."""
    assert p_tops.default_block_d(k) == want
    assert p_tops.default_block_d(k) >= k


# ---------------------------------------------------------------------------
# wrapper contracts
# ---------------------------------------------------------------------------


def test_wrappers_reject_wrong_types():
    with pytest.raises(TypeError):
        int8_ip(torch.zeros(2, 4), torch.zeros(3, 4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        int8_ip(torch.zeros(2, 4, dtype=torch.bfloat16),
                torch.zeros(3, 5, dtype=torch.uint8))
    with pytest.raises(TypeError):
        binary_ip(torch.ones(2, 32, dtype=torch.int8),
                  torch.zeros(3, 1, dtype=torch.int64))
    with pytest.raises(ValueError):
        binary_ip(torch.ones(2, 64, dtype=torch.int8),
                  torch.zeros(3, 1, dtype=torch.int32))
    with pytest.raises(TypeError):
        topk_blocks(torch.zeros(2, 4, dtype=torch.float64), 2, 4)
    with pytest.raises(TypeError):
        topk_merge(torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        topk_merge(torch.zeros(2, 6), torch.zeros(2, 6, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        topk_merge(torch.zeros(4, 2).T, torch.zeros(4, 2, dtype=torch.int32).T,
                   2)


def test_cpu_tensors_never_count_as_launches():
    before = launch_counts()
    int8_ip(torch.zeros(2, 4, dtype=torch.bfloat16),
            torch.zeros(3, 4, dtype=torch.uint8))
    binary_ip(torch.ones(2, 32, dtype=torch.int8),
              torch.zeros(3, 1, dtype=torch.int32))
    topk_blocks(torch.zeros(2, 4), 2, 4)
    assert launch_counts() == before
