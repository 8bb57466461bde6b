#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place, one precision step below what the configuration states,
must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

The configuration's ``control`` names the step, ``--step`` another:
``int4`` (4-bit codes for its int8 codes) or ``bf16`` (every product's inputs and every fitted
stage in bfloat16 for its float32).  For each seed the control draws the
cell's inputs as a run does, builds its index in those numerics, answers
the rows a run checks (for an open-loop mix, pool rows at the menu's
depths), and the cell's own comparison judges the answers.  It prints
one line a seed with every number and the verdict, and a last JSON line
with them all.  It is not part of a run: it is how the limits were set,
and a test keeps it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numerics(name: str):
    from portbench.reference import plain
    return {"int4": plain.INT4, "bf16": plain.BF16}[name]


def rows_checked(traffic: dict, rng):
    """(pool rows, depths) that a run of the mix checks."""
    import numpy as np
    pool = int(traffic["pool"])
    if traffic["loop"] == "closed":
        n = min(int(traffic["check_queries"]), pool)
        return np.sort(rng.choice(pool, n, replace=False)), \
            [int(traffic["k"])] * n
    menu = traffic["menu"]
    w = np.asarray([m["weight"] for m in menu], np.float64)
    picks = rng.choice(len(menu), size=int(traffic["check_requests"]),
                       p=w / w.sum())
    rows, ks = [], []
    for m in picks:
        rows.extend(rng.choice(pool, size=menu[m]["rows"]).tolist())
        ks.extend([menu[m]["k"]] * menu[m]["rows"])
    return np.asarray(rows), ks


def run_control(cell, seed: int, device, step: str | None = None) -> dict:
    """The control's numbers and verdict for one seed; ``step`` names the
    precision step, the configuration's ``control`` by default."""
    import numpy as np
    import torch

    from portbench.harness import correct
    from portbench.reference import plain
    from portbench.run import draw_inputs, sub_seeds

    cfg, mix = cell.config, cell.traffic
    device = torch.device(device)
    plain.exact_matmul()
    seeds = sub_seeds(seed)
    _, docs, qfit, pool = draw_inputs(cfg, mix, seeds, device)
    num = control_numerics(step or cfg["control"])
    state = plain.build(cfg, docs, qfit, seeds["build"], num)
    nprobe = cfg["ivf"]["nprobe"] if cfg.get("ivf") else None
    searcher = plain.Searcher(state, num, nprobe=nprobe)
    rows, ks = rows_checked(mix, np.random.default_rng(seeds["traffic"]))
    q = pool[torch.as_tensor(rows, dtype=torch.long, device=device)]
    vals, ids = searcher.search(q, max(ks))
    vals, ids = vals.float().cpu().numpy(), ids.cpu().numpy()
    scores = [v[:k] for v, k in zip(vals, ks)]
    idl = [i[:k] for i, k in zip(ids, ks)]
    del searcher
    numbers = correct.check(cfg, docs, qfit, q, ks, scores, idl,
                            seeds["build"], state)
    ok, checks = correct.verdict(numbers, cfg["limits"])
    return {"seed": seed, "correct": ok, "numbers": numbers,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--step", choices=("int4", "bf16"),
                    help="the precision step (default: the configuration's)")
    args = ap.parse_args(argv)
    from portbench.harness import catalog
    cell = catalog.find_cell(args.workload)
    out = []
    for s in args.seeds:
        r = run_control(cell, s, args.device, args.step)
        print(f"[control] {args.workload} seed {s}: correct {r['correct']} "
              f"{json.dumps(r['numbers'])}", flush=True)
        out.append(r)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
