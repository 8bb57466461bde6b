#!/usr/bin/env python3
"""Faults planted in the program's set-up, each a cut that a later change
could make for speed: a run with one of them must come out not correct.

    python3 portbench/faults.py --workload <cell> --fault <name> \\
        --seeds <n> [<n> ...] [--seconds <s>]

- ``no_rotation``: the learned rotation left at the identity (ITQ skipped);
- ``no_lloyd``: k-means stops after its seeding (no Lloyd rounds);
- ``query_mean``: queries centred with the documents' mean.

For each seed it runs the cell with the fault planted, at a short window,
and prints one line with every compared number and the verdict, then a
last JSON line with them all.  It is not part of a run: its readings are
the upper ends of the limits that no control reaches (PERF.md), and a
test keeps it at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ("no_rotation", "no_lloyd", "query_mean")


def _patches(fault: str) -> list:
    """(owner, attribute, replacement) that plant ``fault``."""
    import torch

    from repro_torch.core.preprocess import Center
    from repro_torch.core.rotation import LearnedRotation
    from repro_torch.retrieval import ivf
    if fault == "no_rotation":
        fit = LearnedRotation.fit

        def rotation_fit(self, docs, queries=None, rng=None):
            fit(self, docs, queries, rng)
            r = self.state["rotation"]
            self.state["rotation"] = torch.eye(r.shape[0], dtype=r.dtype,
                                               device=r.device)
            return self
        return [(LearnedRotation, "fit", rotation_fit)]
    if fault == "no_lloyd":
        kmeans_fit = ivf.kmeans_fit

        def seeding_only(x, n_clusters, n_iters=20, rng=None, init="random"):
            return kmeans_fit(x, n_clusters, 0, rng, init=init)
        return [(ivf, "kmeans_fit", seeding_only)]
    if fault == "query_mean":
        fit = Center.fit

        def center_fit(self, docs, queries=None, rng=None):
            fit(self, docs, queries, rng)
            self.state["mean_queries"] = self.state["mean_docs"].clone()
            return self
        return [(Center, "fit", center_fit)]
    raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, for the duration."""
    from portbench.harness import program
    program.import_port()
    patches = _patches(fault)
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    try:
        for o, a, f in patches:
            setattr(o, a, f)
        yield
    finally:
        for o, a, f in saved:
            setattr(o, a, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    from portbench import run
    from portbench.harness import catalog
    cell = catalog.find_cell(args.workload)
    out = []
    for s in args.seeds:
        numbers = {}
        with planted(args.fault):
            r = run.run_cell(cell, s, args.seconds, False, args.device,
                             readings=numbers)
        print(f"[fault] {args.workload} {args.fault} seed {s}: correct "
              f"{r['correct']} {json.dumps(numbers)}", flush=True)
        out.append({"seed": s, "fault": args.fault,
                    "correct": r["correct"], "numbers": numbers})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
