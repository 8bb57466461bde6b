"""End-to-end serving driver: a request stream against the
:class:`~repro_torch.serve.RetrievalService` front door, including a
mid-stream staged → canaried → promoted KB refresh.

    python examples_torch/serve_compressed.py --requests 50   # on the card
    PYTHONPATH=src python examples_torch/serve_compressed.py --device cpu \\
        --n-docs 4000 --no-post --ivf-nlist 16 --shards 2

The PyTorch counterpart of ``examples/serve_compressed.py``.  The index is
described declaratively (:class:`IndexSpec`), built once with
:func:`build_index`, saved to a single ``.npz`` artifact, and the service
registers that artifact as version 1 of a named index — exactly like a
production serve process: no raw corpus, no re-fit.  Producer code then
streams query blocks through the async API (``service.query(...) →
QueryHandle``) while a background drain loop micro-batches and dispatches
them.  Halfway through, a *refreshed* corpus (the nightly-rebuild
scenario: new documents appended) is built into a second artifact, staged
off the serving path, canaried against live traffic via shadow overlap,
and promoted with zero downtime — requests keep flowing throughout and
each one ranks entirely against the version it bound to.

With ``--ivf-nlist`` the driver adds a third act: the refreshed KB is
streamed to a *chunked* (v3) artifact and hot-swapped in with only a 25%
hot-tier byte budget resident — the encoded inverted lists stay on disk,
Zipf-skewed open-loop traffic (``examples_torch/loadgen.py``) keeps the
LRU hot tier warm, and the per-version ``stats()`` row reports the tier
hit rate.

With ``--shards N`` a fourth act shards the refreshed KB N ways
(``ShardSpec(shards=N)`` on ``--device``: a named device holds every
shard, so the act runs on one card or on the CPU) and hot-swaps it in:
staging places every shard or none, the promote is the same atomic pointer
flip, results match the single-host version bit-for-bit, and the
``stats()`` row grows a per-shard rollup.

With ``--no-post`` storage stays quantized: on a CUDA device exact search
scores through ``int8_ip`` (or ``binary_ip``) and ranks through
``topk_blocks``, and IVF search runs ``fused_ivf_topk``.  ``--device``
defaults to CUDA and raises without a card; ``--device cpu`` runs every
kernel's plain version.
"""

import argparse
import dataclasses
import importlib.util
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.data import make_dpr_like_kb
from repro_torch.retrieval import (IndexSpec, ShardSpec, build_index,
                                   load_index_meta, save_index)
from repro_torch.serve import QueryOptions, RetrievalService
from repro_torch.utils import device_name, human_bytes, resolve_device


def _load_loadgen():
    """``examples_torch/loadgen.py``, loaded by its path beside this file
    (never another module that happens to be named ``loadgen``)."""
    name = "examples_torch_loadgen"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "loadgen.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


loadgen = _load_loadgen()

def serve_tiered(service, idx, tmp, queries, dev) -> dict:
    """Act three: same KB, v3 chunked artifact, 25% resident budget."""
    path = os.path.join(tmp, "kb_v3")
    save_index(idx, path, chunked=True)
    enc = load_index_meta(path)["encoded_nbytes"]
    budget = max(1, enc // 4)
    print(f"\ntiered swap: v3 chunked artifact ({human_bytes(enc)} encoded "
          f"lists) staged at a 25% resident budget "
          f"({human_bytes(budget)})")
    service.stage("kb", artifact=path, resident_budget=budget, device=dev)
    live = service.promote("kb")
    menu = loadgen.DEFAULT_MENU
    loadgen.warmup(service, "kb", queries, menu, 64, 120.0)
    wl = loadgen.build_workload(np.random.default_rng(3), duration_s=1.0,
                                rows_per_s=150.0, menu=menu,
                                pool_size=len(queries), zipf_alpha=1.1)
    r = loadgen.run_trial(service, "kb", queries, menu, wl)
    tier = service.stats()["indexes"]["kb"]["versions"][live]["tier"]
    print(f"  served {r['admitted']} open-loop requests "
          f"(p50={r['p50_ms']:.1f}ms p99={r['p99_ms']:.1f}ms, "
          f"{r['lost']} lost)")
    print(f"  tier: hit rate {tier['hit_rate']:.1%} "
          f"({tier['hits']} hits, {tier['misses']} misses), "
          f"{human_bytes(tier['bytes_resident'])} of "
          f"{human_bytes(tier['budget_bytes'])} hot tier resident, "
          f"{human_bytes(tier['bytes_read'])} paged from disk")
    return {"live": live, "encoded_nbytes": enc, "budget": budget,
            "trial": r, "tier": tier}


def serve_sharded(service, spec, docs, sample, queries, n_shards, batch, k,
                  dev) -> dict:
    """Act four: the same KB sharded n_shards ways on ``dev``, hot-swapped
    in behind the same front door — identical results, per-shard rollup."""
    print(f"\nsharded swap: rebuilding over ShardSpec(shards={n_shards}) "
          f"(every shard on {dev}: {device_name(dev)})")
    sharded = build_index(
        dataclasses.replace(spec, shard=ShardSpec(shards=n_shards)),
        docs, sample, device=dev)
    before = service.query(queries[:batch],
                           QueryOptions(index="kb", k=k)).result(timeout=120)
    service.stage("kb", index=sharded)   # places every shard, or raises
    live = service.promote("kb")
    after = service.query(queries[:batch],
                          QueryOptions(index="kb", k=k)).result(timeout=120)
    same_ids = np.array_equal(before.ids, after.ids)
    same_bits = same_ids and before.scores.tobytes() == after.scores.tobytes()
    row = service.stats()["indexes"]["kb"]["versions"][live]
    # quantizer-tail pipelines (--no-post) are bit-identical in score
    # bytes too; post-CenterNorm specs score on the float decode path,
    # where ids still match but the last ulp may differ per shard shape
    verdict = "bit-identical" if same_bits else \
        "same top-k ids" if same_ids else "DIVERGED"
    print(f"  promoted v{live}: results vs single-host {verdict}")
    for s in row.get("shards", []):
        lists = f", {s['n_lists']} lists" if "n_lists" in s else ""
        print(f"    shard {s['shard']}: {s['n_docs']} docs{lists}")
    return {"live": live, "verdict": verdict,
            "shards": row.get("shards", [])}


def run(argv=None) -> dict:
    """Run the serving driver; returns the numbers it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="pca_int8",
                    choices=("pca_int8", "pca_onebit", "onebit", "int8"))
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-docs", type=int, default=50_000)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--no-post", action="store_true",
                    help="skip post-quantization CenterNorm: storage stays "
                         "quantized and scoring runs the int8/1-bit kernels")
    ap.add_argument("--ivf-nlist", type=int, default=0,
                    help="build an IVF index with this many lists "
                         "(0 = exact search)")
    ap.add_argument("--ivf-nprobe", type=int, default=0,
                    help="default probe width (0 = nlist/2); every 4th "
                         "request overrides it per-request to nlist")
    ap.add_argument("--shards", type=int, default=0,
                    help="fourth act: hot-swap in the KB sharded this many "
                         "ways, every shard on --device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; "
                         "--device cpu runs every kernel's plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dim = 245 if args.method == "pca_onebit" else args.dim
    kb = make_dpr_like_kb(n_queries=max(64, args.requests * args.batch),
                          n_docs=args.n_docs, device=dev)
    fresh = make_dpr_like_kb(n_queries=8, n_docs=max(64, args.n_docs // 20),
                             seed=1, device=dev)

    ivf = None
    full_probe = None
    if args.ivf_nlist:
        nprobe = args.ivf_nprobe or max(1, args.ivf_nlist // 2)
        ivf = (args.ivf_nlist, nprobe)
        full_probe = args.ivf_nlist

    spec = IndexSpec(method=args.method, dim=dim, post=not args.no_post,
                     ivf=ivf)
    queries = kb.queries.cpu().numpy()
    k = args.k
    out = {"device": str(dev)}

    def build_artifact(docs, path, tag):
        idx = build_index(spec, docs, kb.queries[:512], device=dev)
        idx.save(path)
        out[tag] = {"n_docs": len(idx), "scorer": idx.scorer.name,
                    "artifact_bytes": os.path.getsize(path)}
        print(f"  {tag}: {len(idx)} docs, scorer {idx.scorer.name}, "
              f"artifact {human_bytes(os.path.getsize(path))}")
        return idx

    served = [0]

    def stream(service, lo, hi):
        """Submit requests [lo, hi); resolve async handles as they land."""
        handles = []
        for r in range(lo, hi):
            nprobe = full_probe if (full_probe and r % 4 == 3) else None
            off = (r * args.batch) % max(1, len(queries) - args.batch)
            handles.append(service.query(
                queries[off: off + args.batch],
                QueryOptions(index="kb", k=k, nprobe=nprobe)))
        for h in handles:
            h.result(timeout=120)
        served[0] += len(handles)

    print(f"building v1 index from spec [{args.method}"
          f"{', ivf=' + str(ivf) if ivf else ''}] ...")
    with tempfile.TemporaryDirectory() as tmp:
        path_v1 = os.path.join(tmp, "kb_v1.npz")
        path_v2 = os.path.join(tmp, "kb_v2.npz")
        build_artifact(kb.docs, path_v1, "v1")

        with RetrievalService(default_k=k,
                              max_batch=args.max_batch) as service:
            service.register("kb", artifact=path_v1, device=dev)
            print("  service cold-started from the artifact "
                  "(no corpus, no re-fit)\n")

            half, three_q = args.requests // 2, (3 * args.requests) // 4
            stream(service, 0, half)

            # the nightly refresh: corpus grows, new artifact is staged off
            # the serving path, canaried on live traffic, then promoted
            print(f"refresh after {served[0]} requests: building v2 "
                  f"(+{len(fresh.docs)} new docs) while serving continues")
            docs_v2 = torch.cat([kb.docs, fresh.docs], dim=0)
            idx_v2 = build_artifact(docs_v2, path_v2, "v2")
            service.stage("kb", artifact=path_v2, canary_every=2,
                          device=dev)
            stream(service, half, max(half + 1, three_q))
            canary = service.canary("kb")
            print(f"  canary: overlap {canary['overlap']:.3f} over "
                  f"{canary['batches']} sampled batches")
            live = service.promote("kb", min_overlap=0.5)
            print(f"  promoted v{live} (rollback(\"kb\") would undo)\n")
            stream(service, max(half + 1, three_q), args.requests)

            stats = service.stats()
            table = stats["indexes"]["kb"]
            out.update(canary_overlap=canary["overlap"],
                       canary_batches=canary["batches"], promoted=live,
                       requests_served=stats["requests_served"],
                       queries_served=stats["queries_served"],
                       batches_served=stats["batches_served"],
                       versions=sorted(table["versions"]),
                       live=table["live"], p50_ms=stats["p50_ms"],
                       p95_ms=stats["p95_ms"], p99_ms=stats["p99_ms"],
                       pending=stats["pending_queries"],
                       rejected=stats["requests_rejected"])
            print(f"served {stats['requests_served']} requests "
                  f"({stats['queries_served']} queries, "
                  f"{stats['batches_served']} micro-batches) across "
                  f"versions {sorted(table['versions'])}, "
                  f"live=v{table['live']}")
            print(f"  latency p50={stats['p50_ms']:.1f}ms "
                  f"p95={stats['p95_ms']:.1f}ms "
                  f"p99={stats['p99_ms']:.1f}ms  ({device_name(dev)})")
            print(f"  admission: {stats['pending_queries']} pending, "
                  f"{stats['requests_rejected']} rejected")

            if ivf:
                out["tiered"] = serve_tiered(service, idx_v2, tmp, queries,
                                             dev)

            if args.shards:
                out["sharded"] = serve_sharded(
                    service, spec, docs_v2, kb.queries[:512], queries,
                    args.shards, args.batch, k, dev)
    return out


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
