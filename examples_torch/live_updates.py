"""Live KB churn against a serving index: add → drift → delete → compact.

    python examples_torch/live_updates.py --requests 40      # on the card
    PYTHONPATH=src python examples_torch/live_updates.py --device cpu \\
        --method pca_onebit

The PyTorch counterpart of ``examples/live_updates.py``: the production-
churn scenario the static paper setup doesn't cover.  A compressed index
built once (``IndexSpec(mutable=True)``) keeps serving while documents
arrive and disappear.  New docs are encoded through the *frozen* fitted
pipeline into delta segments and are searchable immediately; deletes
tombstone global doc ids and take effect on the next query; the
preprocessing-drift monitor watches the added docs' mean/norm statistics
against the pipeline's fitted centering stats, and when the delta fraction
(or drift) crosses the trigger the index is compacted — folded into a
fresh main artifact and hot-swapped through the same stage → promote
machinery as a nightly rebuild, without pausing the request stream.  On a
CUDA device ``pca_int8`` scores through ``int8_ip`` and ``pca_onebit``
through ``binary_ip``, both ranked by ``topk_blocks``.

``--device`` defaults to CUDA and raises without a card; ``--device cpu``
runs every kernel's plain version.
"""

import argparse
import sys

import numpy as np

from repro_torch.data import make_dpr_like_kb
from repro_torch.retrieval import IndexSpec, build_index
from repro_torch.serve import QueryOptions, RetrievalService
from repro_torch.utils import device_name, human_bytes, resolve_device


def run(argv=None) -> dict:
    """Run the churn scenario; returns the numbers it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="pca_int8",
                    choices=("pca_int8", "pca_onebit", "onebit", "int8"))
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-docs", type=int, default=20_000)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; "
                         "--device cpu runs every kernel's plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dim = 245 if args.method == "pca_onebit" else args.dim
    kb = make_dpr_like_kb(n_queries=max(128, args.requests * args.batch),
                          n_docs=args.n_docs, device=dev)
    fresh = make_dpr_like_kb(n_queries=8, n_docs=max(64, args.n_docs // 8),
                             seed=1, device=dev)
    queries = kb.queries.cpu().numpy()

    spec = IndexSpec(method=args.method, dim=dim, post=False, mutable=True)
    print(f"building mutable index [{args.method}] over {args.n_docs} docs")
    index = build_index(spec, kb.docs, kb.queries[:512], device=dev)
    out = {"device": str(dev), "method": args.method, "n_docs": len(index),
           "scorer": index.scorer.name, "nbytes": index.nbytes}
    print(f"  {len(index)} live docs, scorer {index.scorer.name}, "
          f"{human_bytes(index.nbytes)} storage\n")

    served = [0]

    def stream(service, n, tag, forbidden=()):
        handles = []
        for r in range(n):
            off = (served[0] + r) * args.batch % (len(queries) - args.batch)
            handles.append(service.query(
                queries[off: off + args.batch],
                QueryOptions(index="kb", k=args.k)))
        for h in handles:
            ids = set(np.asarray(h.result(timeout=120).ids).ravel().tolist())
            dead = ids & set(forbidden)
            if dead:
                raise SystemExit(f"{tag}: served deleted doc ids {dead}")
        served[0] += n
        print(f"  [{tag}] {n} requests served, none touched a deleted doc")

    quarter = max(1, args.requests // 4)
    with RetrievalService(default_k=args.k) as service:
        service.register("kb", index)
        stream(service, quarter, "steady state")

        # breaking news: new docs land in a delta segment, via the frozen
        # pipeline — searchable on the very next query
        rep = service.update("kb", add=fresh.docs)
        lo, hi = rep["gid_range"]
        out.update(added=rep["added"], segment=rep["segments"],
                   gid_range=(lo, hi),
                   mean_shift=rep["drift"]["mean_shift"])
        print(f"added {rep['added']} docs as segment #{rep['segments']} "
              f"(global ids {lo}..{hi - 1}); "
              f"drift mean_shift={rep['drift']['mean_shift']:.3f}")
        stream(service, quarter, "post-add")

        # retractions: tombstone a slice of the new docs + some originals
        dead = [*range(lo, lo + 32), 0, 1, 2, 3]
        rep = service.update("kb", delete=dead)
        out.update(deleted=rep["deleted"], tombstones=rep["tombstones"],
                   n_live_after_delete=rep["n_live"])
        print(f"deleted {rep['deleted']} docs "
              f"({rep['tombstones']} tombstones, {rep['n_live']} live)")
        stream(service, quarter, "post-delete", forbidden=dead)

        # fold: segments + tombstones → fresh main, staged and promoted
        # under live traffic; global ids survive the swap
        trigger = rep["needs_compaction"]
        live = service.compact("kb")
        out.update(compacted_into=live, trigger=trigger)
        print(f"compacted into v{live} "
              f"(trigger fired: {trigger}) — zero downtime")
        stream(service, max(1, args.requests - 3 * quarter),
               "post-compact", forbidden=dead)

        stats = service.stats()
        table = stats["indexes"]["kb"]
        mut = table["versions"][table["live"]]["mutable"]
        out.update(requests_served=stats["requests_served"],
                   versions=sorted(table["versions"]), live=table["live"],
                   updates=stats["updates_applied"],
                   compactions=stats["compactions_run"],
                   n_live=mut["n_live"], segments=mut["segments"],
                   p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"])
        print(f"\nserved {stats['requests_served']} requests across "
              f"versions {sorted(table['versions'])}, live=v{table['live']}")
        print(f"  updates={stats['updates_applied']} "
              f"compactions={stats['compactions_run']} "
              f"live_docs={mut['n_live']} segments={mut['segments']}")
        print(f"  latency p50={stats['p50_ms']:.1f}ms "
              f"p99={stats['p99_ms']:.1f}ms  ({device_name(dev)})")
    return out


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
