"""The plain reference against plain math at a tiny size."""

import numpy as np
import torch

from portbench.gen import dpr_like
from portbench.reference import plain


def test_topk_score_id_takes_ties_by_lowest_id():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                      [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], dtype=torch.float64)
    v, i = plain.topk_score_id(s, 3)
    assert i.tolist() == [[1, 2, 4], [0, 1, 2]]
    v, i = plain.topk_score_id(s, 4)
    assert i.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]]
    assert v[0].tolist() == [3.0, 3.0, 3.0, 2.0]


def test_pca_is_the_top_eigenvectors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(500, 6, generator=g) * torch.tensor([5, 4, 3, .2, .1,
                                                         .05])
    st = plain.fit_pca(x, 3, plain.REFERENCE)
    xn = x.double().numpy()
    cov = np.cov(xn, rowvar=False, bias=True)
    evals, evecs = np.linalg.eigh(cov)
    top = evecs[:, ::-1][:, :3]
    # the same subspace, each vector up to its sign
    assert np.allclose(np.abs(top.T @ st["W"].numpy()), np.eye(3),
                       atol=1e-8)
    assert np.allclose(st["mean"].numpy(), xn.mean(0))


def test_int8_codes_and_scores_by_hand():
    x = torch.tensor([[0.0, 1.0], [1.0, -1.0], [0.5, 0.0]],
                     dtype=torch.float64)
    quant = plain.fit_quantizer([("Int8Quantizer", {})], x, plain.REFERENCE)
    p = quant[1]
    assert p["scale"].tolist() == [1 / 255, 2 / 255]
    codes = plain.encode(quant, x)
    assert codes.tolist() == [[0, 255], [255, 0], [128, 128]]
    state = plain.State(stages=[], quant=quant, storage=codes, dim=2)
    s = plain.Searcher(state)
    q = torch.tensor([[1.0, 1.0]], dtype=torch.float64)
    dec = codes.double() * p["scale"] + p["zero"]
    vals, ids = s.search(q, 3)
    assert torch.allclose(vals[0], torch.sort(dec.sum(1), descending=True)
                          .values)


def test_int4_codes_have_sixteen_levels():
    x = torch.linspace(-1, 1, 101, dtype=torch.float64)[:, None]
    quant = plain.fit_quantizer([("Int8Quantizer", {})], x, plain.INT4)
    assert int(plain.encode(quant, x).max()) == 15


def test_one_bit_score_is_a_quarter_sign_dot_over_the_packed_width():
    x = torch.tensor([[0.3, -0.2, 0.1], [-0.4, -0.1, 0.2]],
                     dtype=torch.float64)
    quant = ("onebit", {"offset": 0.5})
    state = plain.State(stages=[], quant=quant, storage=plain.encode(quant,
                                                                     x),
                        dim=3)
    s = plain.Searcher(state)
    q = torch.tensor([[1.0, 1.0, -1.0]], dtype=torch.float64)
    sc, _ = s.scores(q)
    # signs (+,-,+) and (-,-,+) against (+,+,-): dots -1 and -3, plus 29
    # pad dims that are -1 on both sides
    assert sc[0].tolist() == [0.25 * (-1 + 29), 0.25 * (-3 + 29)]


def test_ivf_search_keeps_to_the_probed_lists():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(300, 4, generator=g, dtype=torch.float64)
    quant = ("int8", {"scale": torch.ones(4, dtype=torch.float64),
                      "zero": torch.zeros(4, dtype=torch.float64),
                      "levels": 255.0})
    cents = torch.eye(4, dtype=torch.float64)
    labels = plain.assign(x, cents, plain.REFERENCE)
    state = plain.State(stages=[], quant=quant,
                        storage=x.round().clamp(0, 255).to(torch.int16),
                        dim=4, centroids=cents, labels=labels)
    q = torch.tensor([[0.0, 0.0, 5.0, 0.0]], dtype=torch.float64)
    vals, ids = plain.Searcher(state, nprobe=1).search(q, 5)
    assert torch.all(labels[ids[0]] == 2)


def test_generator_is_fixed_by_its_seed():
    pop = dpr_like.population(3, "cpu")
    a = dpr_like.draw_docs(pop, 1000, 9)
    b = dpr_like.draw_docs(dpr_like.population(3, "cpu"), 1000, 9)
    assert torch.equal(a, b) and a.shape == (1000, 768)
    q = dpr_like.draw_queries(pop, 64, 10)
    assert q.shape == (64, 768)
    # documents are far from the origin, queries more centered (DPR-CLS)
    assert a.mean(0).norm() > 2 * q.mean(0).norm()


def test_draws_in_chunks_keep_the_population(monkeypatch):
    pop = dpr_like.population(4, "cpu")
    monkeypatch.setattr(dpr_like, "CHUNK", 256)
    chunked = dpr_like.draw_docs(pop, 1000, 5)
    monkeypatch.setattr(dpr_like, "CHUNK", 10**9)
    whole = dpr_like.draw_docs(pop, 1000, 5)
    # chunks draw in another order, so rows differ; their statistics agree
    assert chunked.shape == whole.shape
    assert torch.allclose(chunked.mean(0), whole.mean(0), atol=0.05)
