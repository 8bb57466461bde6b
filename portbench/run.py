#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``).  The run draws the KB, the queries
fitted on and the query pool on the card from ``--seed``, builds the
index through ``repro_torch.retrieval.build_index``, warms the mix's own
shapes, drives the mix for ``--seconds`` and then holds what the window
produced against the plain reference.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics from a profiled window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which are also the last lines of standard error.

Without a CUDA card (or with fewer than the cell asks for) it exits 2 and
prints no result; if the process holds JAX or the JAX package once the
window has closed, it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def process_age() -> float:
    """Seconds since this process started (its start in /proc, by the
    boot clock); the host clock at import where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def sub_seeds(seed: int) -> dict:
    """Independent seeds for each draw, from any whole ``seed``."""
    import numpy as np
    names = ("docs", "queries_fit", "pool", "build", "traffic")
    vals = np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(
        len(names), dtype=np.uint32)
    return {n: int(v) for n, v in zip(names, vals)}


def draw_inputs(cfg: dict, traffic: dict, seeds: dict, device):
    """(population, docs, queries fitted on, query pool), drawn on
    ``device``: the configuration fixes the corpus's population (its
    basis, spectrum and means), the seed draws the rows from it."""
    from portbench.gen import dpr_like
    pop = dpr_like.population(int(cfg["population_seed"]), device)
    docs = dpr_like.draw_docs(pop, int(cfg["n_docs"]), seeds["docs"])
    qfit = dpr_like.draw_queries(pop, int(cfg["queries_fit"]),
                                 seeds["queries_fit"])
    pool = dpr_like.draw_queries(pop, int(traffic["pool"]), seeds["pool"])
    return pop, docs, qfit, pool


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ivf_calls(index, pool, calls: list, facts: dict, nprobe: int) -> list:
    """Each traced call's probed work: (query, row) pairs and the rows of
    its distinct probed lists, from the program's own routing."""
    from portbench.harness import program
    lens = facts["list_len"].to(pool.device)
    work = {}
    for c in calls:
        key = (c["rows"], c["n"])
        if key not in work:
            p = program.probes(index, pool[c["rows"]:c["rows"] + c["n"]],
                               nprobe).long()
            work[key] = (int(lens[p].sum()), int(lens[p.unique()].sum()))
        c.update(nprobe=nprobe, pairs=work[key][0], list_rows=work[key][1])
    return calls


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             readings: dict | None = None) -> dict:
    """One run of ``cell`` (a ``catalog.Cell``); returns the result, and
    fills ``readings``, where given, with every number compared."""
    import numpy as np
    import torch

    from portbench.harness import catalog, correct, program, readers, traffic
    from portbench.harness.trace import Tracer
    from portbench.reference import plain
    from portbench.roofline import peaks

    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    plain.exact_matmul()
    program.import_port()
    seeds = sub_seeds(seed)
    _, docs, qfit, pool = draw_inputs(cfg, mix, seeds, device)
    _sync(device)
    t0 = time.perf_counter()
    index = program.build(cfg, docs, qfit, seeds["build"], device)
    _sync(device)
    build_s = time.perf_counter() - t0
    facts = program.index_facts(index)
    del docs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tracer = Tracer(trace)
    tracer.warm()
    drv = traffic.driver(index, pool, mix, tracer)
    drv.warmup()
    _sync(device)
    setup_s = process_age()
    rng = np.random.default_rng(seeds["traffic"])
    win = drv.run(float(seconds), rng)
    on_card = device.type == "cuda"
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": False, "attempted": int(win.attempted),
              "failed": int(win.failed)}
    if trace:
        tr = tracer.reduce()
        calls = win.calls
        if cfg.get("ivf") and calls:
            calls = _ivf_calls(index, pool, calls, facts,
                               int(cfg["ivf"]["nprobe"]))
        ctx = readers.Context(
            config=cfg, trace=tr, calls=calls, facts=facts,
            rates=peaks.rates(dev_info["kind"]), spans=win.spans,
            counters=win.counters, send_lags=win.send_lags,
            setup={"build_s": build_s})
        metrics = {}
        for m in cell.per_layer:
            v = catalog.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    else:
        # a metric's quantity is its name up to the first dot: the
        # window's "qps" is reported as "qps.exact" or "qps.ivf"
        values = dict(win.metrics, setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"].split(".")[0]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev_info
    state = program.fitted_state(index)
    if hasattr(drv, "close"):
        drv.close()
    del index, drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _, docs, _, _ = draw_inputs(cfg, mix, seeds, device)
    q_rows = pool[torch.as_tensor(win.rows, dtype=torch.long,
                                  device=device)]
    numbers = correct.check(cfg, docs, qfit, q_rows, win.ks, win.scores,
                            win.ids, seeds["build"], state)
    ok, checks = correct.verdict(numbers, cfg["limits"])
    if readings is not None:
        readings.update(numbers)
    result["correct"] = bool(ok and win.lost == 0)
    result["checks"] = checks
    print(f"[portbench] {cell.name} seed {seed}: window "
          f"{win.seconds:.3f} s, setup {setup_s:.3f} s (build "
          f"{build_s:.3f} s), reference {time.perf_counter() - t1:.3f} s, "
          f"{len(win.ks)} rows checked, lost {win.lost}", file=sys.stderr)
    print("[portbench] readings " + json.dumps(numbers), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import catalog
    from portbench.harness.imports import forbidden_loaded
    cell = catalog.find_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: the process holds {bad}: the port's run must "
              "load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
