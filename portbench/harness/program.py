"""The one place the benchmark touches the program (``repro_torch``): its
front door (``build_index``, ``search``, ``RetrievalService``), its
kernel launch counters, and, for the checks that follow the program from
its own fitted state, that state read into the reference's form."""

from __future__ import annotations

import sys

import torch

from portbench.harness.catalog import ROOT
from portbench.reference import plain


def import_port() -> None:
    """Put the checkout's ``src`` first on the path; import the port."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.retrieval  # noqa: F401


def index_spec(cfg: dict):
    from repro_torch.retrieval.api import IndexSpec
    kw = {"stages": tuple((n, dict(c)) for n, c in cfg["stages"])}
    ivf = cfg.get("ivf")
    if ivf is not None:
        kw.update(ivf=(int(ivf["nlist"]), int(ivf["nprobe"])),
                  kmeans_iters=int(ivf["kmeans_iters"]),
                  kmeans_init=ivf["kmeans_init"],
                  balanced_lists=bool(ivf["balanced_lists"]))
    return IndexSpec(**kw)


def build(cfg: dict, docs: torch.Tensor, queries_fit: torch.Tensor,
          build_seed: int, device: torch.device):
    """The index, through the port's front door, with the build's
    generator on ``device``."""
    from repro_torch.retrieval.api import build_index
    rng = torch.Generator(device=device).manual_seed(build_seed)
    return build_index(index_spec(cfg), docs, queries_fit, rng=rng,
                       device=device)


def service(index, traffic: dict):
    """A started ``RetrievalService`` serving ``index`` as ``default``."""
    from repro_torch.serve import RetrievalService
    svc = RetrievalService(max_batch=int(traffic["max_batch"]),
                           cache_rows=int(traffic.get("cache_rows", 0)),
                           max_pending_queries=int(
                               traffic.get("max_pending_queries", 4096)))
    svc.register("default", index)
    return svc


def query_options(k: int):
    from repro_torch.serve import QueryOptions
    return QueryOptions(index="default", k=int(k))


def refusals():
    from repro_torch.serve import QueueFull
    return QueueFull


def served_totals(svc) -> dict:
    return dict(svc.stats_typed().totals)


def launch_counts() -> dict:
    from repro_torch.kernels import launch_counts as counts
    return counts()


def index_facts(index) -> dict:
    """Sizes the roofline arithmetic reads: rows, code width, and for an
    IVF index its lists' lengths."""
    facts = {"n_docs": len(index), "row_bytes":
             int(index.storage.shape[1] * index.storage.element_size()),
             "code_dim": int(index._dim), "scorer": index.scorer.name}
    lists = getattr(index, "lists", None)
    if lists is not None:
        facts["list_len"] = (lists >= 0).sum(1)
    return facts


def probes(index, q_raw: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The lists the program probes for ``q_raw`` (its own routing)."""
    from repro_torch.retrieval.ivf import route
    q = index.encode_queries(q_raw).float()
    return route(q, index.centroids, index.sim, nprobe)[1]


def _unpack(words: torch.Tensor, d: int) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :d].bool()


def fitted_state(index) -> plain.State:
    """The program's fitted recipe, codes and router, copied into the
    reference's form."""
    transforms = index.pipeline.transforms
    stages = []
    for t in transforms[:-1]:
        name = type(t).__name__
        if name == "CenterNorm":
            st = {"mean_docs": t.state["mean_docs"],
                  "mean_queries": t.state["mean_queries"]}
        elif name == "PCA":
            st = {"mean": t.state["mean"], "W": t.projection_matrix()}
        elif name == "LearnedRotation":
            st = {"R": t.state["rotation"]}
        else:
            raise ValueError(f"no reference for stage {name}")
        stages.append((name, {k: v.detach().clone() for k, v in st.items()}))
    q = transforms[-1]
    dim = int(index._dim)
    if type(q).__name__ == "Int8Quantizer":
        quant = ("int8", {"scale": q.state["scale"].clone(),
                          "zero": q.state["zero"].clone()})
        storage = index.storage.to(torch.int16)
    else:
        quant = ("onebit", {"offset": float(q.offset)})
        storage = _unpack(index.storage, dim)
    state = plain.State(stages=stages, quant=quant, storage=storage, dim=dim)
    if getattr(index, "centroids", None) is not None:
        state.centroids = index.centroids.detach().clone()
        state.labels = torch.from_numpy(index._labels).to(
            index.centroids.device).long()
    return state
