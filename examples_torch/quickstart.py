"""Quickstart: compress a KB index 24×, save the artifact, serve from it.

    python examples_torch/quickstart.py                      # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu \\
        --n-docs 2000 --n-queries 64

The PyTorch counterpart of ``examples/quickstart.py``.  Builds a DPR-like
synthetic KB (the same bytes as ``repro``'s from the same seed), fits the
paper's best practical pipeline (center+norm → PCA-128 → center+norm →
int8) through the declarative :class:`IndexSpec` / :func:`build_index`
API, compares retrieval quality + storage against the uncompressed index,
then round-trips the full index artifact through ``save``/``load_index`` —
the cold-start path a serve process uses (no raw corpus, no re-fit).  On a
CUDA device the build encodes through ``fused_quantize`` and the search
scores through ``int8_ip`` and ranks through ``topk_blocks``.

``--device`` defaults to CUDA and raises without a card; ``--device cpu``
runs every kernel's plain version.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.core import CenterNorm
from repro_torch.data import make_dpr_like_kb
from repro_torch.retrieval import (DenseIndex, IndexSpec, build_index,
                                   load_index, r_precision)
from repro_torch.utils import (device_name, human_bytes, resolve_device,
                               synchronize)


def run(argv=None) -> dict:
    """Run the quickstart; returns the numbers it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=50_000)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=128,
                    help="PCA target dimensionality")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; "
                         "--device cpu runs every kernel's plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"1) synthesizing DPR-like KB ({args.n_docs} docs x 768 dims) ...")
    kb = make_dpr_like_kb(n_queries=args.n_queries, n_docs=args.n_docs,
                          device=dev)
    print(f"   doc L2 norm  {kb.meta['doc_l2']:.1f} "
          f"(paper: 12.3)   query L2 {kb.meta['query_l2']:.1f} (paper: 9.3)")

    print("2) uncompressed baseline ...")
    pre = CenterNorm().fit(kb.docs, kb.queries)
    docs_n, queries_n = pre(kb.docs, "docs"), pre(kb.queries, "queries")
    exact = DenseIndex(docs_n, device=dev)
    base_rp = r_precision(queries_n, docs_n, kb.relevant, "ip")
    print(f"   R-Precision {base_rp:.3f}   index size "
          f"{human_bytes(exact.nbytes)}")
    del docs_n, queries_n

    print(f"3) building the 24x index from a declarative spec "
          f"(center+norm → PCA-{args.dim} → center+norm → int8) ...")
    # the paper's exact stage order: post-processing *before* the trailing
    # quantizer, so storage is real int8 codes (24x) on the kernel path
    spec = IndexSpec(stages=(("CenterNorm", {}), ("PCA", {"dim": args.dim}),
                             ("CenterNorm", {}), ("Int8Quantizer", {})))
    t0 = time.perf_counter()
    idx = build_index(spec, kb.docs, kb.queries, device=dev)
    synchronize(dev)
    build_s = time.perf_counter() - t0
    ratio = exact.nbytes / idx.nbytes
    print(f"   fitted + encoded in {build_s:.1f}s; "
          f"index size {human_bytes(idx.nbytes)} "
          f"({ratio:.0f}x smaller)")

    print("4) save artifact, cold-start reload (no corpus, no re-fit) ...")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kb_index.npz")
        idx.save(path)
        artifact_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        idx = load_index(path, device=dev)
        load_s = time.perf_counter() - t0
        stages = " -> ".join(n for n, _ in idx.spec.stages)
        print(f"   artifact {human_bytes(artifact_bytes)}, "
              f"loaded in {load_s:.2f}s ({stages})")

    print("5) serving queries from the reloaded compressed index ...")
    synchronize(dev)
    t0 = time.perf_counter()
    _, ids = idx.search(kb.queries, k=2)
    synchronize(dev)
    dt = time.perf_counter() - t0
    relevant = kb.relevant.cpu().numpy()
    hits = float(np.mean([len(set(ids_i.tolist()) & set(rel_i.tolist())) / 2
                          for ids_i, rel_i in zip(ids.cpu().numpy(),
                                                  relevant)]))
    ms_per_query = 1000 * dt / len(kb.queries)
    print(f"   R-Precision {hits:.3f} "
          f"({100 * hits / base_rp:.0f}% of uncompressed) "
          f"at {ms_per_query:.4f} ms/query ({device_name(dev)})")

    reproduced = hits / base_rp > 0.85
    print("\npaper's claim: 24x compression retains ~92% retrieval "
          "performance — reproduced." if reproduced else
          "\nWARNING: ratio below expectation")
    return {"device": str(dev), "doc_l2": kb.meta["doc_l2"],
            "query_l2": kb.meta["query_l2"], "float_rp": base_rp,
            "float_nbytes": exact.nbytes, "nbytes": idx.nbytes,
            "ratio": ratio, "artifact_bytes": artifact_bytes,
            "build_s": build_s, "load_s": load_s, "rp": hits,
            "rp_share": hits / base_rp, "ms_per_query": ms_per_query,
            "reproduced": reproduced}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
