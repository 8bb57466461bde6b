"""The DPR-like corpus, drawn on the device from a seed.

A frozen copy of the port's on-card generator
(``repro_torch/data/synthetic.py``: ``_population``,
``dpr_like_population``, ``draw_dpr_like_docs``,
``draw_dpr_like_queries``), kept here so that a change to the program
cannot move the benchmark's inputs.  It imports nothing of the program.

The corpus has the statistics the paper reports for DPR-CLS embeddings
(768-dim f32, non-centered documents with a large mean offset and a
tight norm spread, "more centered" queries, a low effective rank with a
power-law spectrum and four rogue dimensions).  The population (basis,
spectrum, means) comes from ``np.random.default_rng(seed)``; rows come
from a ``torch.Generator`` on the device, in chunks, so a 2.1M-row KB is
drawn on the card in well under a second.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DIM = 768
R_EFF = 144
#: rows drawn per generator call: bounds the temporaries of a draw
CHUNK = 262_144


@dataclasses.dataclass
class Population:
    basis: torch.Tensor          # (d, r_eff)
    spectrum: torch.Tensor       # (r_eff,)
    style_basis: torch.Tensor    # (d, 8)
    mu_docs: torch.Tensor        # (d,)
    mu_queries: torch.Tensor     # (d,)


def population(seed: int, device) -> Population:
    """The population the corpus is drawn from, the first draws of
    ``np.random.default_rng(seed)`` (the program's defaults: 768 dims,
    r_eff 144, alpha 0.5, mean norms 8 and 3, 60% of the document mean in
    the signal subspace)."""
    rng = np.random.default_rng(seed)
    d, r_eff, alpha = DIM, R_EFF, 0.5
    doc_mean_norm, query_mean_norm, mean_in_signal = 8.0, 3.0, 0.6
    q_full, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    basis = q_full[:, :r_eff]
    spectrum = np.arange(1, r_eff + 1, dtype=np.float32) ** (-alpha / 2)
    spectrum /= np.sqrt(np.mean(spectrum ** 2))
    rogue = rng.choice(r_eff, size=4, replace=False)
    spectrum[rogue] *= 3.0
    mu_dir_in = ((rng.standard_normal((1, r_eff)).astype(np.float32)
                  * spectrum[None, :]) @ basis.T)[0]
    mu_dir_in /= np.linalg.norm(mu_dir_in)
    mu_docs = doc_mean_norm * (mean_in_signal * mu_dir_in
                               + np.sqrt(1 - mean_in_signal ** 2)
                               * q_full[:, r_eff])
    mu_queries = query_mean_norm * (
        0.7 * mu_docs / np.linalg.norm(mu_docs)
        + np.sqrt(1 - 0.7 ** 2) * q_full[:, r_eff + 1])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return Population(basis=t(basis), spectrum=t(spectrum),
                      style_basis=t(q_full[:, r_eff + 2: r_eff + 10]),
                      mu_docs=t(mu_docs), mu_queries=t(mu_queries))


def _signals(pop: Population, n: int, g: torch.Generator) -> torch.Tensor:
    """n article signals: latent draws, norm 8 with a 5% jitter."""
    dev = pop.basis.device
    z = torch.randn((n, pop.basis.shape[1]), generator=g, device=dev)
    sig = (z * pop.spectrum) @ pop.basis.T
    jitter = torch.exp(0.05 * torch.randn((n, 1), generator=g, device=dev))
    return sig / torch.linalg.vector_norm(sig, dim=1, keepdim=True) \
        * 8.0 * jitter


def _docs(pop: Population, n: int, g: torch.Generator) -> torch.Tensor:
    dev = pop.basis.device
    d = pop.basis.shape[0]
    sig = _signals(pop, n, g)
    s_i = torch.exp(0.08 * torch.randn((n, 1), generator=g, device=dev))
    n_style = pop.style_basis.shape[1]
    h = torch.randn((n, n_style), generator=g, device=dev) \
        * (6.0 / np.sqrt(n_style))
    noise = torch.randn((n, d), generator=g, device=dev) * 0.15
    return pop.mu_docs + s_i * sig + h @ pop.style_basis.T + noise


def _queries(pop: Population, n: int, g: torch.Generator) -> torch.Tensor:
    dev = pop.basis.device
    pair = _signals(pop, 2 * n, g)
    beta = torch.exp(0.8 * torch.randn((n, 1), generator=g, device=dev))
    eps = (torch.randn((n, pop.basis.shape[1]), generator=g, device=dev)
           * pop.spectrum) @ pop.basis.T
    eps = eps * (0.55 * 8.0 / torch.sqrt(torch.mean(
        torch.sum(eps * eps, dim=-1))))
    return pop.mu_queries + beta * 0.55 * (pair[:n] + pair[n:]) + eps


def _draw(fn, pop: Population, n: int, seed: int) -> torch.Tensor:
    dev = pop.basis.device
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((n, pop.basis.shape[0]), dtype=torch.float32,
                      device=dev)
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        out[s:e] = fn(pop, e - s, g)
    return out


def draw_docs(pop: Population, n: int, seed: int) -> torch.Tensor:
    """(n, 768) f32 documents, one span an article, on the population's
    device; the same ``seed`` gives the same rows."""
    return _draw(_docs, pop, n, seed)


def draw_queries(pop: Population, n: int, seed: int) -> torch.Tensor:
    """(n, 768) f32 queries, each the midpoint of two fresh article
    signals with in-subspace noise and a heavy-tailed strength."""
    return _draw(_queries, pop, n, seed)
