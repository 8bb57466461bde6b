"""Lloyd k-means: the coarse quantizer of IVF search.

Counterpart of ``repro.retrieval.kmeans``, on tensors of any device.
Random draws come from a ``torch.Generator`` (on its own device; the
numbers are moved to the data's device), so a fit cannot match
``jax.random``'s bit for bit: fits are judged by inertia and list sizes.
"""

from __future__ import annotations

from typing import Optional

import torch


def _sq_dists(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, k) squared L2 distances, in ``repro``'s expression order."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=-1)
    return x2 + c2[None, :] - 2.0 * (x @ centroids.T)


def assign(x: torch.Tensor, centroids: torch.Tensor,
           chunk: int = 65536) -> torch.Tensor:
    """Nearest centroid (L2) per row of x; ties go to the lowest index.
    Rows go in ``chunk``-sized slices (each row's argmin is its own)."""
    return torch.cat([torch.argmin(_sq_dists(part, centroids), dim=-1)
                      for part in x.split(chunk)])


def _update(x: torch.Tensor, labels: torch.Tensor, n_clusters: int,
            old: torch.Tensor) -> torch.Tensor:
    """Cluster means; a cluster that went empty keeps its old centroid.

    Each cluster's rows are added one after another in row order: a stable
    sort by label, then a segment reduce that walks each segment in
    sequence.  The sums are the bits of a sequential ``index_add_`` (the
    CPU's) on every device and run; the card's ``index_add_`` adds with
    atomics, in an order that changes from run to run."""
    counts = torch.bincount(labels, minlength=n_clusters)
    order = torch.argsort(labels, stable=True)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)
    counts = counts.to(x.dtype)
    new = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, new, old)


def _kmeanspp_init(x: torch.Tensor, n_clusters: int,
                   rng: torch.Generator) -> torch.Tensor:
    """kmeans++ D² sampling (Arthur & Vassilvitskii 2007).

    One centroid a round, drawn ∝ squared distance to the nearest chosen
    one, as Gumbel-top-1 over log D².  The chosen index stays a device
    tensor, so the loop never waits for the device.
    """
    n, d = x.shape
    x2 = torch.sum(x * x, dim=-1)

    def d2_to(c):
        return torch.clamp(x2 - 2.0 * (x @ c) + torch.sum(c * c), min=0.0)

    first = int(torch.randint(0, n, (), generator=rng, device=rng.device))
    centroids = torch.zeros((n_clusters, d), dtype=x.dtype, device=x.device)
    centroids[0] = x[first]
    min_d2 = d2_to(x[first])
    for i in range(1, n_clusters):
        logits = torch.where(min_d2 > 0.0, torch.log(min_d2 + 1e-30),
                             float("-inf"))
        # all-duplicate corner: every D² is 0 → sample uniformly instead
        logits = torch.where((min_d2 > 0.0).any(), logits,
                             torch.zeros_like(logits))
        u = torch.rand((n,), generator=rng, device=rng.device).to(x.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        idx = torch.argmax(logits + gumbel)
        centroids[i] = x[idx]
        min_d2 = torch.minimum(min_d2, d2_to(x[idx]))
    return centroids


def _penalized_assign(x: torch.Tensor, centroids: torch.Tensor,
                      penalty: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """argmin(D² + penalty[c]) per row, and the unpenalised margin
    (second-nearest D² − nearest D²)."""
    d2 = _sq_dists(x, centroids)
    labels = torch.argmin(d2 + penalty[None, :], dim=-1)
    if centroids.shape[0] >= 2:
        two = torch.topk(d2, 2, dim=-1, largest=False).values
        margin = two[:, 1] - two[:, 0]
    else:
        margin = torch.zeros((x.shape[0],), device=x.device)
    return labels, margin


def assign_balanced(x: torch.Tensor, centroids: torch.Tensor, *,
                    slack: float = 1.25, rounds: int = 4,
                    chunk: int = 65536) -> torch.Tensor:
    """Capacity-aware nearest-centroid assignment (penalty rounds).

    Each round re-assigns with a per-centroid penalty that grows for lists
    over ``slack × n/k`` and relaxes for lists under it, in units of the
    mean assignment margin.  The lowest-peak round is kept; round 1 has no
    penalty, so the result is never more skewed than plain argmin.  Rows
    go in ``chunk``-sized slices, so the (n, k) distance matrix is never
    whole.
    """
    x = x.float()
    n, k = x.shape[0], centroids.shape[0]
    cap = max(slack * n / k, 1.0)
    penalty = torch.zeros((k,), device=x.device)
    scale = None
    best_labels, best_peak = None, None
    for _ in range(max(1, rounds)):
        parts, margins = [], []
        for s in range(0, n, chunk):
            lab, mg = _penalized_assign(x[s: s + chunk], centroids, penalty)
            parts.append(lab)
            margins.append(mg)
        labels = torch.cat(parts)
        if scale is None:   # typical flip cost sets the penalty unit
            scale = float(torch.mean(torch.cat(margins))) + 1e-6
        counts = torch.bincount(labels, minlength=k).float()
        peak = float(counts.max())
        if best_peak is None or peak < best_peak:
            best_labels, best_peak = labels, peak
        if peak <= cap:
            break
        over = torch.clamp(counts - cap, min=0.0) / cap
        under = torch.clamp(cap - counts, min=0.0) / cap
        penalty = torch.clamp(penalty + scale * (over - 0.5 * under), min=0.0)
    return best_labels


def kmeans_fit(x: torch.Tensor, n_clusters: int, n_iters: int = 20,
               rng: Optional[torch.Generator] = None,
               init: str = "random") -> torch.Tensor:
    """Fit k-means centroids.

    ``init="random"`` seeds with random distinct rows (repeated when the
    corpus has fewer rows than clusters); ``init="++"`` uses kmeans++.
    """
    if init not in ("random", "++"):
        raise ValueError(f"unknown kmeans init {init!r}")
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    x = x.float()
    n = x.shape[0]
    if init == "++" and n > n_clusters:
        centroids = _kmeanspp_init(x, n_clusters, rng)
    else:
        perm = torch.randperm(n, generator=rng, device=rng.device)
        centroids = x[perm[: min(n_clusters, n)].to(x.device)]
        if centroids.shape[0] < n_clusters:  # tiny corpora: repeat rows
            reps = -(-n_clusters // centroids.shape[0])
            centroids = centroids.repeat(reps, 1)[:n_clusters]
    for _ in range(n_iters):
        labels = assign(x, centroids)
        centroids = _update(x, labels, n_clusters, centroids)
    return centroids
