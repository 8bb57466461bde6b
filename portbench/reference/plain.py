"""The plain reference: the paper's compression recipes and exact search,
in plain PyTorch, in blocks of rows.

It imports neither ``jax`` nor ``repro`` nor anything of the program
(``repro_torch``); it takes the documents and queries that the benchmark
drew and works out every fitted stage, every code and every ranking
again.  A recipe is the configuration's list of stages, by the names the
program's ``IndexSpec(stages=...)`` uses:

- ``CenterNorm``: x ← (x − mean) / ‖x − mean‖, with the means of the
  documents and of the queries fitted apart (paper §3.3);
- ``PCA`` (``dim``): x ← (x − μ) W, W the top-``dim`` eigenvectors of the
  documents' covariance, by descending eigenvalue (paper §4.2);
- ``LearnedRotation``: x ← x R, R learned by ITQ (B ← Q(XR), R ← UVᵀ for
  UΣVᵀ = XᵀB; 10 rounds on 65,536 documents drawn by ``randperm`` from
  the build's generator);
- ``Int8Quantizer``: per-dimension affine codes, scale (max − min)/255
  and zero min, fitted on the documents; a query is scored in float
  against the decoded codes;
- ``OneBitQuantizer`` (offset 0.5): the sign bit; a score is 0.25 × the
  sign dot over the packed width (the pad bits are −1 on both sides);
- IVF: k-means++ seeding and Lloyd rounds on 100,000 rows drawn by
  ``randperm`` from the same generator, the capacity-aware assignment
  (slack 1.25, 4 penalty rounds), and routing to the ``nprobe`` centroids
  of highest inner product.

Every ranking is by (score desc, id asc).

``Numerics`` says how a stage computes: the reference runs in float64;
the controls run it one step lower (``BF16``: every product's inputs and
every stored stage in bfloat16) or with 4-bit codes in place of 8-bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

#: rows per block of every pass over the documents
ROWS = 262_144
#: queries per block of exact scoring
QROWS = 128


@dataclasses.dataclass(frozen=True)
class Numerics:
    """How the reference computes: ``compute`` is the dtype of the
    arithmetic, ``store`` the dtype every stage's output and fitted state
    is rounded to, ``int_bits`` the width of the integer codes."""
    compute: torch.dtype = torch.float64
    store: torch.dtype = torch.float64
    int_bits: int = 8

    def r(self, t: torch.Tensor) -> torch.Tensor:
        """Round to the stored precision, back in the compute dtype."""
        return t.to(self.store).to(self.compute)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.store == torch.bfloat16:
            return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)
                    ).to(self.compute)
        return a.to(self.compute) @ b.to(self.compute)


REFERENCE = Numerics()
BF16 = Numerics(compute=torch.float32, store=torch.bfloat16)
INT4 = Numerics(int_bits=4)


def exact_matmul() -> None:
    """No TF32 in float32 products, here or in the program."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- fitted state -------------------------------------------------------

@dataclasses.dataclass
class State:
    """A fitted recipe: the float stages, the quantizer, the codes and, for
    IVF, the router.  The harness reads the program's fitted state into
    the same form, so one check reads both."""
    stages: list                      # [(name, {key: tensor})]
    quant: tuple                      # ("int8", {"scale", "zero"}) | ("onebit", {"offset"})
    storage: Optional[torch.Tensor] = None   # int8: (N, d) codes; onebit: (N, d) bool signs
    dim: int = 0                      # width of the float rows
    centroids: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def apply_stage(name: str, st: dict, x: torch.Tensor, kind: str,
                num: Numerics = REFERENCE) -> torch.Tensor:
    """One float stage on a block of rows, in ``num``."""
    x = x.to(num.compute)
    if name == "CenterNorm":
        mean = st["mean_queries" if kind == "queries" else "mean_docs"]
        return num.r(_l2n(x - mean.to(num.compute)))
    if name == "PCA":
        return num.r(num.mm(x - st["mean"].to(num.compute), st["W"]))
    if name == "LearnedRotation":
        return num.r(num.mm(x, st["R"]))
    raise ValueError(f"unknown stage {name!r}")


def apply_stages(stages: list, x: torch.Tensor, kind: str,
                 num: Numerics = REFERENCE) -> torch.Tensor:
    for name, st in stages:
        x = apply_stage(name, st, x, kind, num)
    return x


def _blocks(n: int, rows: int = ROWS):
    return ((s, min(s + rows, n)) for s in range(0, n, rows))


def _transformed(stages, docs, num):
    """All documents through ``stages``, block by block."""
    return torch.cat([apply_stages(stages, docs[s:e], "docs", num)
                      for s, e in _blocks(docs.shape[0])])


def _mean(x: torch.Tensor, num: Numerics) -> torch.Tensor:
    total = sum(x[s:e].to(num.compute).sum(0) for s, e in _blocks(x.shape[0]))
    return num.r(total / x.shape[0])


def covariance(x: torch.Tensor, num: Numerics = REFERENCE
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, covariance) of the rows of ``x``."""
    d = x.shape[1]
    s = torch.zeros(d, dtype=num.compute, device=x.device)
    ss = torch.zeros((d, d), dtype=num.compute, device=x.device)
    for a, b in _blocks(x.shape[0]):
        blk = x[a:b].to(num.compute)
        s += blk.sum(0)
        ss += num.mm(blk.T, blk)
    mean = s / x.shape[0]
    return mean, ss / x.shape[0] - torch.outer(mean, mean)


def fit_pca(x: torch.Tensor, dim: int, num: Numerics) -> dict:
    mean, cov = covariance(x, num)
    evals, evecs = torch.linalg.eigh(cov.to(torch.float64)
                                     if num.compute != torch.float64
                                     else cov)
    w = evecs.flip(1)[:, :dim].to(num.compute)
    return {"mean": num.r(mean), "W": num.r(w)}


def fit_rotation(x: torch.Tensor, g: torch.Generator, num: Numerics,
                 n_iters: int = 10, offset: float = 0.5,
                 max_fit: int = 65_536) -> dict:
    if x.shape[0] > max_fit:
        idx = torch.randperm(x.shape[0], generator=g, device=g.device)
        x = x[idx[:max_fit].to(x.device)]
    x = x.to(num.compute)
    r = torch.eye(x.shape[1], dtype=num.compute, device=x.device)
    for _ in range(n_iters):
        b = torch.where(num.mm(x, r) >= 0.0, 1.0 - offset, -offset
                        ).to(num.compute)
        u, _, vt = torch.linalg.svd(num.mm(x.T, b).to(torch.float64),
                                    full_matrices=False)
        r = num.r((u @ vt).to(num.compute))
    return {"R": r}


def mean_sq_norm(x: torch.Tensor, num: Numerics = REFERENCE) -> float:
    """E‖x‖² over the rows of ``x``."""
    return float(sum(torch.sum(x[s:e].to(num.compute) ** 2)
                     for s, e in _blocks(x.shape[0])) / x.shape[0])


def abs_sum(x: torch.Tensor, r: torch.Tensor,
            num: Numerics = REFERENCE) -> float:
    """Σ|x R| over every row: what ITQ raises, since with the sign targets
    ±(1 − offset) and offset 0.5 its loss ‖B − XR‖² is a constant less
    Σ|XR|."""
    return float(sum(torch.sum(torch.abs(num.mm(x[s:e], r)))
                     for s, e in _blocks(x.shape[0])))


def fit_stages(recipe: list, docs: torch.Tensor, queries: torch.Tensor,
               g: Optional[torch.Generator], num: Numerics
               ) -> tuple[list, torch.Tensor, torch.Tensor]:
    """Fit every float stage of ``recipe`` in order; returns (stages,
    documents, queries) through them."""
    stages = []
    x, q = docs, queries
    for name, cfg in recipe:
        if name in ("Int8Quantizer", "OneBitQuantizer"):
            break
        if name == "CenterNorm":
            st = {"mean_docs": _mean(x, num), "mean_queries": _mean(q, num)}
        elif name == "PCA":
            st = fit_pca(x, int(cfg["dim"]), num)
        elif name == "LearnedRotation":
            st = fit_rotation(x, g, num)
        else:
            raise ValueError(f"unknown stage {name!r}")
        stages.append((name, st))
        x = _transformed([(name, st)], x, num)
        q = apply_stage(name, st, q, "queries", num)
    return stages, x, q


def fit_quantizer(recipe: list, x: torch.Tensor, num: Numerics) -> tuple:
    name, cfg = recipe[-1]
    if name == "Int8Quantizer":
        levels = float(2 ** num.int_bits - 1)
        lo = torch.amin(x, 0).to(num.compute)
        hi = torch.amax(x, 0).to(num.compute)
        return ("int8", {"scale": num.r(torch.clamp(hi - lo, min=1e-12)
                                         / levels),
                         "zero": num.r(lo), "levels": levels})
    if name == "OneBitQuantizer":
        return ("onebit", {"offset": float(cfg.get("offset", 0.5))})
    raise ValueError(f"recipe must end in a quantizer, got {name!r}")


def encode(quant: tuple, x: torch.Tensor) -> torch.Tensor:
    kind, p = quant
    if kind == "int8":
        levels = p.get("levels", 255.0)
        return torch.clamp(torch.round((x.to(p["scale"].dtype) - p["zero"])
                                       / p["scale"]), 0, levels
                           ).to(torch.int16)
    return x >= 0


# -- k-means and the capacity-aware assignment -----------------------------

def _sq_dists(x, c, num):
    return (torch.sum(x * x, -1, keepdim=True) + torch.sum(c * c, -1)[None]
            - 2.0 * num.mm(x, c.T))


def assign(x, c, num, chunk: int = 65_536):
    return torch.cat([torch.argmin(_sq_dists(x[s:e], c, num), -1)
                      for s, e in _blocks(x.shape[0], chunk)])


def kmeanspp(x: torch.Tensor, n_clusters: int, g: torch.Generator,
             num: Numerics) -> torch.Tensor:
    n = x.shape[0]
    x2 = torch.sum(x * x, -1)

    def d2_to(c):
        return torch.clamp(x2 - 2.0 * num.mm(x, c[:, None])[:, 0]
                           + torch.sum(c * c), min=0.0)

    first = int(torch.randint(0, n, (), generator=g, device=g.device))
    cents = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype,
                        device=x.device)
    cents[0] = x[first]
    min_d2 = d2_to(x[first])
    for i in range(1, n_clusters):
        logits = torch.where(min_d2 > 0.0, torch.log(min_d2 + 1e-30),
                             float("-inf"))
        logits = torch.where((min_d2 > 0.0).any(), logits,
                             torch.zeros_like(logits))
        u = torch.rand((n,), generator=g, device=g.device).to(x.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20))).to(x.dtype)
        idx = torch.argmax(logits + gumbel)
        cents[i] = x[idx]
        min_d2 = torch.minimum(min_d2, d2_to(x[idx]))
    return cents


def lloyd(x, cents, iters, num):
    k = cents.shape[0]
    for _ in range(iters):
        labels = assign(x, cents, num)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        sums = torch.zeros_like(cents).index_add_(0, labels, x)
        new = num.r(sums / torch.clamp(counts[:, None], min=1.0))
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def inertia(x: torch.Tensor, c: torch.Tensor,
            num: Numerics = REFERENCE, chunk: int = 65_536) -> float:
    """The k-means loss: the mean squared distance of each row to its
    nearest centroid."""
    c = c.to(num.compute)
    total = sum(torch.sum(torch.clamp(
        _sq_dists(x[s:e].to(num.compute), c, num).min(-1).values, min=0.0))
        for s, e in _blocks(x.shape[0], chunk))
    return float(total) / x.shape[0]


def assign_balanced(x, cents, num, slack: float = 1.25, rounds: int = 4,
                    chunk: int = 65_536) -> torch.Tensor:
    n, k = x.shape[0], cents.shape[0]
    cap = max(slack * n / k, 1.0)
    penalty = torch.zeros((k,), dtype=x.dtype, device=x.device)
    scale = None
    best, best_peak = None, None
    for _ in range(max(1, rounds)):
        parts, margins = [], []
        for s, e in _blocks(n, chunk):
            d2 = _sq_dists(x[s:e], cents, num)
            parts.append(torch.argmin(d2 + penalty[None], -1))
            two = torch.topk(d2, 2, dim=-1, largest=False).values
            margins.append(two[:, 1] - two[:, 0])
        labels = torch.cat(parts)
        if scale is None:
            scale = float(torch.mean(torch.cat(margins))) + 1e-6
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        peak = float(counts.max())
        if best_peak is None or peak < best_peak:
            best, best_peak = labels, peak
        if peak <= cap:
            break
        over = torch.clamp(counts - cap, min=0.0) / cap
        under = torch.clamp(cap - counts, min=0.0) / cap
        penalty = torch.clamp(penalty + scale * (over - 0.5 * under), min=0.0)
    return best


def fit_router(x_route: torch.Tensor, nlist: int, iters: int,
               g: torch.Generator, num: Numerics,
               train_size: int = 100_000) -> torch.Tensor:
    """k-means++ and Lloyd on ``train_size`` rows drawn from ``g``."""
    n = x_route.shape[0]
    train = x_route
    if n > train_size:
        sel = torch.randperm(n, generator=g, device=g.device)
        train = x_route[sel[:train_size].to(x_route.device)]
    train = train.to(num.compute)
    cents = num.r(kmeanspp(train, nlist, g, num))
    return lloyd(train, cents, iters, num)


# -- building and searching -------------------------------------------------

def build(cfg: dict, docs: torch.Tensor, queries_fit: torch.Tensor,
          build_seed: int, num: Numerics = REFERENCE) -> State:
    """Fit the configuration's recipe (and router) on ``docs``."""
    recipe = cfg["stages"]
    dev = docs.device
    g = torch.Generator(device=dev).manual_seed(build_seed)
    stages, x, _ = fit_stages(recipe, docs, queries_fit, g, num)
    quant = fit_quantizer(recipe, x, num)
    state = State(stages=stages, quant=quant, dim=int(x.shape[1]))
    ivf = cfg.get("ivf")
    if ivf is not None:
        state.centroids = fit_router(x, int(ivf["nlist"]),
                                     int(ivf["kmeans_iters"]), g, num)
        state.labels = assign_balanced(x.to(num.compute), state.centroids,
                                       num)
    state.storage = encode(quant, x)
    return state


def doc_matrix(state: State) -> torch.Tensor:
    """The documents as the scorer sees them: decoded int8 rows, or ±1
    signs padded with −1 to the packed width."""
    kind, p = state.quant
    if kind == "int8":
        return state.storage.to(p["scale"].dtype) * p["scale"] + p["zero"]
    signs = state.storage.to(torch.float32) * 2.0 - 1.0
    pad = (-signs.shape[1]) % 32
    return torch.nn.functional.pad(signs, (0, pad), value=-1.0)


def query_matrix(state: State, q_float: torch.Tensor) -> torch.Tensor:
    if state.quant[0] == "int8":
        return q_float
    signs = torch.where(q_float >= 0, 1.0, -1.0).to(torch.float32)
    pad = (-signs.shape[1]) % 32
    return torch.nn.functional.pad(signs, (0, pad), value=-1.0)


def score_scale(state: State) -> float:
    """The factor from the matrices' product to the score (1-bit: 0.25)."""
    return 1.0 if state.quant[0] == "int8" else 0.25


def topk_score_id(scores: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row by (score desc, id asc), exactly, ties and all."""
    thr = torch.topk(scores, k, dim=1).values[:, -1:]
    gt = scores > thr
    eq = scores == thr
    room = k - gt.sum(1, keepdim=True)
    take = gt | (eq & (torch.cumsum(eq.to(torch.int32), 1) <= room))
    ids = take.nonzero()[:, 1].view(scores.shape[0], k)
    s = scores.gather(1, ids)
    order = torch.sort(-s, dim=1, stable=True).indices
    return s.gather(1, order), ids.gather(1, order)


def route(state: State, qf: torch.Tensor, nprobe: int,
          num: Numerics) -> torch.Tensor:
    """(Q, nprobe) probed lists, by inner product with the centroids."""
    cs = num.mm(qf, state.centroids.to(num.compute).T)
    return topk_score_id(cs, nprobe)[1]


class Searcher:
    """Exact (or IVF-restricted) search over a fitted ``State``, in blocks
    of queries; the document matrix is decoded once."""

    def __init__(self, state: State, num: Numerics = REFERENCE,
                 nprobe: Optional[int] = None):
        self.state, self.num, self.nprobe = state, num, nprobe
        dm = doc_matrix(state)
        self.docs = dm.to(num.compute) if state.quant[0] == "int8" else dm
        self.scale = score_scale(state)

    def scores(self, q_raw: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(scores over every document with unprobed ones at −inf,
        float query rows) for a block of raw queries."""
        st, num = self.state, self.num
        qf = apply_stages(st.stages, q_raw, "queries", num)
        qm = query_matrix(st, qf)
        if st.quant[0] == "int8":
            s = num.mm(qm, self.docs.T)
        else:   # ±1 sums are exact in float32
            s = (qm @ self.docs.T).to(torch.float64) * self.scale
        if self.nprobe is not None:
            lists = route(st, qf, self.nprobe, num)
            probed = torch.zeros((qf.shape[0], st.centroids.shape[0]),
                                 dtype=torch.bool, device=qf.device)
            probed.scatter_(1, lists, True)
            s = torch.where(probed[:, st.labels], s, float("-inf"))
        return s, qf

    def search(self, q_raw: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        vals, ids = [], []
        for s, e in _blocks(q_raw.shape[0], QROWS):
            sc, _ = self.scores(q_raw[s:e])
            v, i = topk_score_id(sc, k)
            vals.append(v)
            ids.append(i)
        return torch.cat(vals), torch.cat(ids)

    def score_of(self, q_raw: torch.Tensor, ids: torch.Tensor
                 ) -> torch.Tensor:
        """The reference's score of given documents, unprobed or not."""
        keep, self.nprobe = self.nprobe, None
        try:
            out = []
            for s, e in _blocks(q_raw.shape[0], QROWS):
                sc, _ = self.scores(q_raw[s:e])
                out.append(sc.gather(1, ids[s:e].clamp(0, sc.shape[1] - 1)))
            return torch.cat(out)
        finally:
            self.nprobe = keep
