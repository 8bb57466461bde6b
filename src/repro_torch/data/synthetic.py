"""Synthetic DPR-like knowledge base (offline stand-in for HotpotQA/NQ).

A numpy copy of ``repro.data.synthetic``'s generator: the same draws from
``np.random.default_rng(seed)`` in the same order, so both packages get
byte-identical corpora from the same seed.  Only the boundary differs —
this one returns torch tensors on ``device``.

The corpus has the statistics the paper reports for DPR-CLS embeddings:
768-dim fp32, non-centered (documents carry a large mean offset and norm
jitter; queries are "more centered"), low effective rank with a power-law
spectrum and a few rogue dimensions, and two relevant documents per query
(HotpotQA's two supporting passages).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass
class KBData:
    docs: torch.Tensor       # (n_docs, d) fp32
    queries: torch.Tensor    # (n_queries, d) fp32
    relevant: torch.Tensor   # (n_queries, max_r) int32 doc ids, −1 pad
    meta: dict

    @property
    def dim(self) -> int:
        return int(self.docs.shape[-1])


#: rows per block of the row-wise passes, and the threads that run them
#: (numpy releases the GIL in array work).  Each row gets the arithmetic of
#: the whole-array expression, so the bytes do not depend on either.
_ROWS = 16_384
_THREADS = 4


def _row_blocks(n: int):
    return (slice(s, min(s + _ROWS, n)) for s in range(0, n, _ROWS))


def _per_block(fn, n: int) -> None:
    """``fn(rows)`` for every block of ``n`` rows; blocks write disjoint
    rows."""
    with ThreadPoolExecutor(_THREADS) as pool:
        list(pool.map(fn, _row_blocks(n)))


def _population(rng, d, r_eff, alpha, doc_mean_norm, query_mean_norm,
                mean_in_signal):
    """The corpus's population, the first draws of ``rng``: (q_full,
    basis, spectrum, mu_docs, mu_queries)."""
    # signal basis: r_eff orthonormal directions, power-law scaled, with 4
    # "rogue" high-variance dims mixed in
    q_full, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    basis = q_full[:, :r_eff]                                   # (d, r_eff)
    spectrum = np.arange(1, r_eff + 1, dtype=np.float32) ** (-alpha / 2)
    spectrum /= np.sqrt(np.mean(spectrum ** 2))
    rogue = rng.choice(r_eff, size=4, replace=False)
    spectrum[rogue] *= 3.0

    # population means: much of the document offset lies inside the signal
    # subspace (breaks raw L2, removed exactly by centering); queries get a
    # smaller offset partially aligned with the documents'
    mu_dir_in = ((rng.standard_normal((1, r_eff)).astype(np.float32)
                  * spectrum[None, :]) @ basis.T)[0]
    mu_dir_in /= np.linalg.norm(mu_dir_in)
    mu_docs = doc_mean_norm * (mean_in_signal * mu_dir_in
                               + np.sqrt(1 - mean_in_signal ** 2)
                               * q_full[:, r_eff])
    mu_queries = query_mean_norm * (
        0.7 * mu_docs / np.linalg.norm(mu_docs)
        + np.sqrt(1 - 0.7 ** 2) * q_full[:, r_eff + 1])
    return q_full, basis, spectrum, mu_docs, mu_queries


def _kb_arrays(n_queries, n_docs, d, seed, r_eff, alpha, query_noise,
               doc_noise, doc_mean_norm, query_mean_norm, norm_jitter,
               beta_sigma, style_scale, mean_in_signal, spans_per_article):
    rng = np.random.default_rng(seed)
    q_full, basis, spectrum, mu_docs, mu_queries = _population(
        rng, d, r_eff, alpha, doc_mean_norm, query_mean_norm, mean_in_signal)

    def latent_to_obs(z):                                        # (n, r_eff)
        return (z * spectrum[None, :]) @ basis.T                 # (n, d)

    # article latents with a tight norm spread (DPR: 12.3 ± 0.6)
    n_articles = max(2, n_docs // spans_per_article)
    z_art = rng.standard_normal((n_articles, r_eff)).astype(np.float32)
    sig = latent_to_obs(z_art)
    jitter = np.exp(rng.normal(0, 0.05, size=(n_articles, 1))
                    ).astype(np.float32)

    def scale_articles(b):
        sig[b] = sig[b] / np.linalg.norm(sig[b], axis=1, keepdims=True) \
            * 8.0 * jitter[b]

    _per_block(scale_articles, n_articles)

    # documents: article signal + span noise + mean offset + "style"
    # components orthogonal to every query (per-document norm variance)
    art_of_doc = np.repeat(np.arange(n_articles), spans_per_article)[:n_docs]
    eps_d = np.empty((n_docs, d), np.float32)
    for b in _row_blocks(n_docs):   # the draws of one (n_docs, d) draw
        eps_d[b] = rng.standard_normal((b.stop - b.start, d)) \
            .astype(np.float32) * doc_noise
    n_style = 8
    style_basis = q_full[:, r_eff + 2: r_eff + 2 + n_style]      # (d, 8)
    h = rng.standard_normal((n_docs, n_style)).astype(np.float32) \
        * (style_scale / np.sqrt(n_style))
    s_i = np.exp(rng.normal(0.0, norm_jitter, size=(n_docs, 1))
                 ).astype(np.float32)
    style = h @ style_basis.T
    # the sum is promoted (float64); its row norms feed meta, and the
    # documents are kept in float32 as every caller stores them
    dt = np.result_type(mu_docs, s_i, sig, style, eps_d)
    docs = np.empty((n_docs, d), np.float32)
    doc_l2, doc_l1 = np.empty(n_docs, dt), np.empty(n_docs, dt)

    def make_docs(b):
        block = mu_docs[None, :] + s_i[b] * sig[art_of_doc[b]] \
            + style[b] + eps_d[b]
        doc_l2[b] = np.linalg.norm(block, axis=1)
        doc_l1[b] = np.sum(np.abs(block), axis=1)
        docs[b] = block

    _per_block(make_docs, n_docs)
    del eps_d, style

    # queries: midpoint of two articles + in-subspace noise, scaled by a
    # heavy-tailed per-query signal strength β
    a1 = rng.integers(0, n_articles, size=n_queries)
    a2 = (a1 + 1 + rng.integers(0, n_articles - 1, size=n_queries)) \
        % n_articles
    beta = np.exp(rng.normal(0.0, beta_sigma, size=(n_queries, 1))
                  ).astype(np.float32)
    eps_q = latent_to_obs(
        rng.standard_normal((n_queries, r_eff)).astype(np.float32))
    eps_q *= query_noise * 8.0 / np.sqrt(np.mean(np.sum(eps_q ** 2, -1)))
    queries = (mu_queries[None, :]
               + beta * 0.55 * (sig[a1] + sig[a2]) + eps_q)

    first_span = np.arange(n_articles) * spans_per_article
    rel = np.stack([first_span[a1], first_span[a2]], axis=1)
    rel = np.minimum(rel, n_docs - 1).astype(np.int32)

    meta = {
        "doc_l2": float(np.mean(doc_l2)),
        "query_l2": float(np.mean(np.linalg.norm(queries, axis=1))),
        "doc_l1": float(np.mean(doc_l1)),
        "query_l1": float(np.mean(np.sum(np.abs(queries), axis=1))),
        "seed": seed, "r_eff": r_eff, "alpha": alpha,
    }
    return docs, queries, rel, meta


def make_dpr_like_kb(n_queries: int = 2000, n_docs: int = 50_000,
                     d: int = 768, seed: int = 0, r_eff: int = 144,
                     alpha: float = 0.5, query_noise: float = 0.55,
                     doc_noise: float = 0.15, doc_mean_norm: float = 8.0,
                     query_mean_norm: float = 3.0, norm_jitter: float = 0.08,
                     beta_sigma: float = 0.8, style_scale: float = 6.0,
                     mean_in_signal: float = 0.6,
                     spans_per_article: int = 1,
                     device: DeviceLike = None) -> KBData:
    dev = resolve_device(device)
    docs, queries, rel, meta = _kb_arrays(
        n_queries, n_docs, d, seed, r_eff, alpha, query_noise, doc_noise,
        doc_mean_norm, query_mean_norm, norm_jitter, beta_sigma, style_scale,
        mean_in_signal, spans_per_article)
    # jnp.asarray in repro lands in float32; so do these
    return KBData(docs=torch.from_numpy(np.asarray(docs, np.float32)).to(dev),
                  queries=torch.from_numpy(
                      np.asarray(queries, np.float32)).to(dev),
                  relevant=torch.from_numpy(rel).to(dev), meta=meta)


def add_distractors(kb: KBData, n_extra: int, seed: int = 1) -> KBData:
    """Append irrelevant documents drawn from the same marginal (Fig. 6):
    ``repro``'s draws from ``np.random.default_rng(seed)``, so the added
    rows are byte-equal to its; the result lies on ``kb``'s device."""
    rng = np.random.default_rng(seed)
    docs = kb.docs.detach().cpu().numpy()
    i = rng.integers(0, docs.shape[0], size=n_extra)
    j = rng.integers(0, docs.shape[0], size=n_extra)
    w = rng.uniform(0.3, 0.7, size=(n_extra, 1)).astype(np.float32)
    extra = w * docs[i] + (1 - w) * docs[j] \
        + 0.3 * rng.standard_normal((n_extra, docs.shape[1])).astype(np.float32)
    new_docs = np.concatenate([docs, extra], axis=0)
    return KBData(docs=torch.from_numpy(new_docs).to(kb.docs.device),
                  queries=kb.queries, relevant=kb.relevant,
                  meta={**kb.meta, "n_distractors": n_extra})


@dataclasses.dataclass
class DPRPopulation:
    """The population :func:`make_dpr_like_kb` draws from (its first
    draws from the seed), as tensors on one device, for drawing more of
    the same corpus there in chunks (:func:`draw_dpr_like_docs`,
    :func:`draw_dpr_like_queries`).  The chunks come from a
    ``torch.Generator``, so they are not ``make_dpr_like_kb``'s rows."""
    basis: torch.Tensor          # (d, r_eff)
    spectrum: torch.Tensor       # (r_eff,)
    style_basis: torch.Tensor    # (d, 8)
    mu_docs: torch.Tensor        # (d,)
    mu_queries: torch.Tensor     # (d,)


def dpr_like_population(seed: int = 0,
                        device: DeviceLike = None) -> DPRPopulation:
    """The population of ``make_dpr_like_kb(seed=seed)`` at its default
    settings (768 dims), on ``device``."""
    dev = resolve_device(device)
    r_eff = 144
    q_full, basis, spectrum, mu_docs, mu_queries = _population(
        np.random.default_rng(seed), 768, r_eff, alpha=0.5,
        doc_mean_norm=8.0, query_mean_norm=3.0, mean_in_signal=0.6)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return DPRPopulation(basis=t(basis), spectrum=t(spectrum),
                         style_basis=t(q_full[:, r_eff + 2: r_eff + 10]),
                         mu_docs=t(mu_docs), mu_queries=t(mu_queries))


def _signals(pop: DPRPopulation, n: int, g: torch.Generator
             ) -> torch.Tensor:
    """n article signals: latent draws, norm 8 with a 5% jitter."""
    dev = pop.basis.device
    z = torch.randn((n, pop.basis.shape[1]), generator=g, device=dev)
    sig = (z * pop.spectrum) @ pop.basis.T
    jitter = torch.exp(0.05 * torch.randn((n, 1), generator=g, device=dev))
    return sig / torch.linalg.vector_norm(sig, dim=1, keepdim=True) \
        * 8.0 * jitter


def draw_dpr_like_docs(pop: DPRPopulation, n: int, g: torch.Generator
                       ) -> torch.Tensor:
    """n documents of the population (one span an article), drawn from
    ``g`` on its device: mean + jittered signal + style + noise, at
    ``make_dpr_like_kb``'s default noise, style and norm jitter."""
    dev = pop.basis.device
    d = pop.basis.shape[0]
    sig = _signals(pop, n, g)
    s_i = torch.exp(0.08 * torch.randn((n, 1), generator=g, device=dev))
    n_style = pop.style_basis.shape[1]
    h = torch.randn((n, n_style), generator=g, device=dev) \
        * (6.0 / np.sqrt(n_style))
    noise = torch.randn((n, d), generator=g, device=dev) * 0.15
    return pop.mu_docs + s_i * sig + h @ pop.style_basis.T + noise


def draw_dpr_like_queries(pop: DPRPopulation, n: int, g: torch.Generator
                          ) -> torch.Tensor:
    """n queries of the population, each the midpoint of two fresh
    article signals with in-subspace noise and a heavy-tailed strength
    (``make_dpr_like_kb``'s defaults: noise 0.55, log-strength σ 0.8)."""
    dev = pop.basis.device
    pair = _signals(pop, 2 * n, g)
    beta = torch.exp(0.8 * torch.randn((n, 1), generator=g, device=dev))
    eps = (torch.randn((n, pop.basis.shape[1]), generator=g, device=dev)
           * pop.spectrum) @ pop.basis.T
    eps = eps * (0.55 * 8.0 / torch.sqrt(torch.mean(
        torch.sum(eps * eps, dim=-1))))
    return pop.mu_queries + beta * 0.55 * (pair[:n] + pair[n:]) + eps
