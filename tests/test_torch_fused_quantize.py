"""The one-pass doc encode: the port's plain version against ``repro``'s.

``repro`` fits ``[CenterNorm, PCA, CenterNorm, Int8Quantizer]`` on seeded
numpy data; its fitted state goes into the port's pipeline, and the same
rows are encoded by ``repro``'s ``fused_quantize_pallas`` (interpret mode,
as ``tests/test_kernels.py`` runs it), by ``repro``'s plain version, and by
the port's plain version — the function ``csrc/fused_quantize.cu`` is held
against on the card.  Bar (``repro``'s own, ``tests/test_kernels.py``):
codes differ by at most 1, on fewer than 1% of the elements.  The port's
plain version equals its own staged four-pass encode bit for bit, its
rows do not depend on the batch, and ``encode_storage`` takes the fused
route only for the fusable stage list with kernel numerics.

``fused_quantize_split_ref`` mirrors the kernel's numerics (the product as
three bf16 products, the first normalize after it): it is held within the
same bar against ``repro``'s interpret-mode Pallas kernel and against the
plain version on DPR-like data at the paper's widths, its W split
reconstructs W to bf16's second word, and its rows do not depend on the
batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import (CenterNorm as RCenterNorm,  # noqa: E402
                        CompressionPipeline as RPipeline,
                        Int8Quantizer as RInt8, PCA as RPCA)
from repro.kernels.fused_quantize import ops as r_ops  # noqa: E402
from repro_torch.core import (Center, CenterNorm, CompressionPipeline,  # noqa: E402
                              Int8Quantizer, OneBitQuantizer, PCA)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.fused_quantize import ops as p_ops  # noqa: E402
from repro_torch.kernels.fused_quantize.kernel import (  # noqa: E402
    fused_quantize)
from repro_torch.kernels.fused_quantize.ref import (  # noqa: E402
    fused_normalize_ref, fused_quantize_ref, fused_quantize_split_ref,
    split_bf16)
from repro_torch.retrieval import scorers as p_scorers  # noqa: E402

#: (n, d, d′, Pallas block_n): repro's two cases and the paper's widths
CASES = [(50, 64, 16, 16), (257, 96, 32, 64), (300, 768, 128, 64)]


def _data(n, d, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    docs = rng.standard_normal((n, d)).astype(np.float32) + 0.7
    queries = rng.standard_normal((max(n // 4, 2), d)).astype(np.float32)
    return docs, queries


def _repro_pipeline(docs, queries, dc):
    pipe = RPipeline([RCenterNorm(), RPCA(dc), RCenterNorm(), RInt8()])
    return pipe.fit(jnp.asarray(docs), jnp.asarray(queries))


def _port_pipeline(repro_pipe):
    """The port's pipeline carrying ``repro_pipe``'s fitted state."""
    sd = repro_pipe.state_dict()
    stages = [{"state": {k: np.asarray(v) for k, v in st["state"].items()},
               "fitted": st["fitted"]} for st in sd["stages"]]
    pipe = CompressionPipeline([CenterNorm(), PCA(repro_pipe.transforms[1]
                                                  .dim), CenterNorm(),
                                Int8Quantizer()])
    return pipe.load_state_dict({"stages": stages, "types": sd["types"]},
                                torch.device("cpu"))


def _assert_within_bar(got, want):
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _staged(pipe, x):
    t = pipe.transforms
    return t[3].encode(t[2](t[1](t[0](x, "docs"), "docs"), "docs"), "docs")


@pytest.mark.parametrize("n,d,dc,bn", CASES)
def test_plain_version_matches_repro_kernel_and_ref(n, d, dc, bn):
    docs, queries = _data(n, d)
    rpipe = _repro_pipeline(docs, queries, dc)
    ppipe = _port_pipeline(rpipe)
    got = p_ops.fused_quantize(torch.from_numpy(docs), ppipe)
    assert got.dtype == torch.uint8 and got.shape == (n, dc)
    pallas = r_ops.fused_quantize(jnp.asarray(docs), rpipe, use_pallas=True,
                                  interpret=True, block_n=bn)
    _assert_within_bar(got.numpy(), pallas)
    _assert_within_bar(got.numpy(),
                       r_ops.fused_quantize(jnp.asarray(docs), rpipe))
    # the folded parameters themselves: μ₂′ = μ₂ + pca_mean·W
    for mine, theirs in zip(p_ops.params_from_pipeline(ppipe),
                            r_ops.params_from_pipeline(rpipe)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,d,dc,exact", [(50, 64, 16, True),
                                          (257, 96, 32, True),
                                          (300, 768, 128, False)])
def test_plain_version_equals_the_staged_encode(n, d, dc, exact):
    """Bit for bit at ``repro``'s cases, as ``repro`` holds its own ref;
    at the paper's widths the folded PCA mean and the other normalize
    round a code on a rounding boundary (1 of 38,400 here), so there the
    kernel's bar holds instead."""
    docs, queries = _data(n, d)
    pipe = CompressionPipeline([CenterNorm(), PCA(dc), CenterNorm(),
                                Int8Quantizer()])
    x = torch.from_numpy(docs)
    pipe.fit(x, torch.from_numpy(queries))
    got, staged = p_ops.fused_quantize(x, pipe), _staged(pipe, x)
    if exact:
        torch.testing.assert_close(got, staged, rtol=0, atol=0)
    else:
        _assert_within_bar(got, staged)


@pytest.mark.parametrize("stages", [
    [CenterNorm()],
    [CenterNorm(), PCA(8), Int8Quantizer()],
    [Center(), PCA(8), CenterNorm(), Int8Quantizer()],
    [CenterNorm(), PCA(8), CenterNorm(), OneBitQuantizer()],
], ids=["one_stage", "no_post", "center_only", "onebit"])
def test_params_from_pipeline_rejects_other_stage_lists(stages):
    assert not p_ops.fusable(stages)
    with pytest.raises(ValueError, match="fused_quantize expects"):
        p_ops.params_from_pipeline(CompressionPipeline(stages))


#: the paper's pre+post-normalized 24× recipe as stage descriptors
FUSED_24X = [("CenterNorm", {}), ("PCA", {"dim": 16}), ("CenterNorm", {}),
             ("Int8Quantizer", {})]


@pytest.mark.parametrize("stages,backend,fused", [
    (FUSED_24X, "kernel", True),
    (FUSED_24X, "torch", False),
    (FUSED_24X, "auto", False),            # auto on a CPU tensor: torch
    (FUSED_24X[:2] + FUSED_24X[3:], "kernel", False),
    (FUSED_24X[:3] + [("OneBitQuantizer", {})], "kernel", False),
], ids=["fused", "torch", "auto_cpu", "no_post", "onebit"])
def test_encode_storage_takes_the_fused_route_only_when_fusable(
        monkeypatch, stages, backend, fused):
    from repro_torch.core.registry import build_pipeline_from_spec

    docs, queries = _data(200, 64, seed=3)
    x = torch.from_numpy(docs)
    pipe = build_pipeline_from_spec(stages).fit(x, torch.from_numpy(queries))
    float_stages, scorer = p_scorers.scorer_for_pipeline(pipe,
                                                         backend=backend)
    calls = []
    real = p_ops.fused_quantize

    def spy(*args, **kw):
        calls.append(kw.get("use_kernel"))
        return real(*args, **kw)

    monkeypatch.setattr(p_ops, "fused_quantize", spy)
    enc, dim = p_scorers.encode_storage(float_stages, scorer, x)
    assert calls == ([True] if fused else [])
    assert dim == 16
    staged = scorer.encode_docs(p_scorers.apply_float_stages(float_stages, x,
                                                             "docs"))
    torch.testing.assert_close(enc, staged, rtol=0, atol=0)


@pytest.mark.parametrize("n,d,dc", [(600, 768, 384), (1000, 320, 300)])
def test_encode_storage_fuses_any_output_width(monkeypatch, n, d, dc):
    """Outputs wider than one 128-column pass of the kernel still take the
    fused route, and stay within the bar of the staged encode."""
    from repro_torch.core.registry import build_pipeline_from_spec

    docs, queries = _data(n, d, seed=5)
    x = torch.from_numpy(docs)
    stages = [FUSED_24X[0], ("PCA", {"dim": dc}), *FUSED_24X[2:]]
    pipe = build_pipeline_from_spec(stages).fit(x, torch.from_numpy(queries))
    float_stages, scorer = p_scorers.scorer_for_pipeline(pipe,
                                                         backend="kernel")
    calls = []
    real = p_ops.fused_quantize
    monkeypatch.setattr(p_ops, "fused_quantize",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    enc, dim = p_scorers.encode_storage(float_stages, scorer, x)
    assert calls == [1] and dim == dc and enc.shape == (n, dc)
    _assert_within_bar(enc, scorer.encode_docs(
        p_scorers.apply_float_stages(float_stages, x, "docs")))


@pytest.mark.parametrize("n,d,dc", [c[:3] for c in CASES])
def test_a_rows_codes_do_not_depend_on_the_batch(n, d, dc):
    docs, queries = _data(n, d)
    pipe = CompressionPipeline([CenterNorm(), PCA(dc), CenterNorm(),
                                Int8Quantizer()])
    x = torch.from_numpy(docs)
    pipe.fit(x, torch.from_numpy(queries))
    full = p_ops.fused_quantize(x, pipe, use_kernel=True)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)[:n // 2 + 1])
    torch.testing.assert_close(p_ops.fused_quantize(x[perm], pipe),
                               full[perm], rtol=0, atol=0)


def test_wrapper_checks_and_cpu_launches_do_not_count():
    docs, queries = _data(64, 32, seed=4)
    pipe = CompressionPipeline([CenterNorm(), PCA(8), CenterNorm(),
                                Int8Quantizer()])
    x = torch.from_numpy(docs)
    pipe.fit(x, torch.from_numpy(queries))
    mu1, w, mu2, scale, zero = p_ops.params_from_pipeline(pipe)
    before = launch_counts()
    fused_quantize(x, mu1, w, mu2, scale, zero)
    assert launch_counts() == before and "fused_quantize" in before
    with pytest.raises(ValueError, match="do not match"):
        fused_quantize(x[:, :7], mu1, w, mu2, scale, zero)
    with pytest.raises(ValueError, match="μ₁"):
        fused_quantize(x, mu1[:5], w, mu2, scale, zero)
    with pytest.raises(TypeError, match="float"):
        fused_quantize(x.to(torch.int32), mu1, w, mu2, scale, zero)


@pytest.mark.parametrize("n,d,dc,bn", CASES)
def test_split_mirror_matches_repro_kernel(n, d, dc, bn):
    """The kernel's numerics (three bf16 products) against ``repro``'s
    interpret-mode Pallas kernel, within repro's bar."""
    docs, queries = _data(n, d)
    rpipe = _repro_pipeline(docs, queries, dc)
    params = p_ops.params_from_pipeline(_port_pipeline(rpipe))
    got = fused_quantize_split_ref(torch.from_numpy(docs), *params)
    assert got.dtype == torch.uint8 and got.shape == (n, dc)
    pallas = r_ops.fused_quantize(jnp.asarray(docs), rpipe, use_pallas=True,
                                  interpret=True, block_n=bn)
    _assert_within_bar(got.numpy(), pallas)


def _dpr_params(n, dc):
    from repro_torch.data import make_dpr_like_kb

    kb = make_dpr_like_kb(n_queries=64, n_docs=n, d=768, seed=0,
                          device="cpu")
    pipe = CompressionPipeline([CenterNorm(), PCA(dc), CenterNorm(),
                                Int8Quantizer()])
    pipe.fit(kb.docs, kb.queries)
    return kb.docs, p_ops.params_from_pipeline(pipe)


@pytest.mark.parametrize("n,dc", [(4096, 128), (4096, 384)])
def test_split_mirror_within_the_bar_on_dpr_like_data(n, dc):
    """At the paper's widths on DPR-like rows (where one bf16 product moves
    3% of the codes) the three-product split keeps the bar with room:
    under 0.1% of codes differ from the plain f32 version, by 1."""
    x, params = _dpr_params(n, dc)
    got = fused_quantize_split_ref(x, *params)
    want = fused_quantize_ref(x, *params)
    _assert_within_bar(got, want)
    diff = (got.int() - want.int()).abs()
    assert float((diff > 0).float().mean()) < 1e-3


def test_w_split_reconstructs_w_to_the_second_bf16_word():
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((768, 128))
                          * 10.0 ** rng.uniform(-6, 2, (768, 128)))
                         .astype(np.float32))
    w[0, :4] = torch.tensor([0.0, -0.0, 1.0, -3.5])
    hi, lo = split_bf16(w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, w.to(torch.bfloat16))          # round to nearest
    resid = (w.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -16 * w.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -8 * w.double().abs()).all())
    assert torch.equal(hi[0, :4].float(), w[0, :4]) and \
        not bool(lo[0, :4].float().any())                  # exact: lo = 0


@pytest.mark.parametrize("n,d,dc", [(300, 768, 128), (257, 96, 32),
                                    (600, 320, 300)])
def test_split_mirror_rows_do_not_depend_on_the_batch(n, d, dc):
    docs, queries = _data(n, d)
    pipe = CompressionPipeline([CenterNorm(), PCA(dc), CenterNorm(),
                                Int8Quantizer()])
    x = torch.from_numpy(docs)
    pipe.fit(x, torch.from_numpy(queries))
    params = p_ops.params_from_pipeline(pipe)
    full = fused_quantize_split_ref(x, *params)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(n)[:n // 3])
    assert torch.equal(fused_quantize_split_ref(x[perm], *params), full[perm])
    assert torch.equal(fused_quantize_split_ref(x[n - 1:], *params),
                       full[n - 1:])


@pytest.mark.parametrize("n,d,dc", [(500, 96, 40), (4096, 96, 40)])
def test_split_mirror_keeps_the_floor_scale_rule(n, d, dc):
    """A column at Int8Quantizer's floor scale (1e-12/255) codes the sign
    of w − zero, so a last-bit difference in w at the row that set zero
    moves its code by 255.  The rule ``chip_smoke.py`` holds the kernel
    to: in that column codes differ only where the plain version's
    |w − zero| ≤ 2^-16; the other columns keep the bar.  The plain
    version's codes are its own normalized rows, encoded."""
    docs, queries = _data(n, d)
    pipe = CompressionPipeline([CenterNorm(), PCA(dc), CenterNorm(),
                                Int8Quantizer()])
    x = torch.from_numpy(docs)
    pipe.fit(x, torch.from_numpy(queries))
    mu1, w, mu2, scale, zero = p_ops.params_from_pipeline(pipe)
    scale = scale.clone()
    scale[5] = 1e-12 / 255
    want = fused_quantize_ref(x, mu1, w, mu2, scale, zero)
    rows = fused_normalize_ref(x, mu1, w, mu2)
    torch.testing.assert_close(rows.norm(dim=1), torch.ones(n))
    assert torch.equal(
        torch.clamp(torch.round((rows - zero) / scale), 0, 255).to(
            torch.uint8), want)
    got = fused_quantize_split_ref(x, mu1, w, mu2, scale, zero)
    keep = [c for c in range(dc) if c != 5]
    _assert_within_bar(got[:, keep], want[:, keep])
    assert set(want[:, 5].tolist()) <= {0, 255}
    edge = (rows[:, 5] - zero[5]).abs() <= 2.0 ** -16
    assert not bool(((got[:, 5] != want[:, 5]) & ~edge).any())
