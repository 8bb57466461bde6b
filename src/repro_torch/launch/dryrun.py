"""Dry run: every (architecture × input shape) cell at FULL size on the
production meshes, over meta tensors (counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper-dpr \
        --shape search_exact
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --workers 4                # every cell, cells shared by 4 processes

Per cell and mesh (16×16 single pod, 2×16×16 multi-pod):

1. *deployment pass*: the FULL bundle is built on the production mesh and
   its step run once over meta tensors through
   :func:`~repro_torch.launch.roofline.count_step`.  Passing every op at
   FULL shapes is the port's counterpart of ``repro``'s lower + compile:
   a shape error or an op without a meta kernel fails the cell.
2. *cost pass* (LM cells on the single pod): ``repro``'s exact
   extrapolation from two unrolled depths, 4 and 8 layers, when the model
   has more than 8 (cost(L) = cost(8) + (L − 8)·(cost(8) − cost(4))/4;
   transformer layers are homogeneous); at 8 layers or fewer, one unrolled
   pass.  Every other cell takes pass 1's counts.

The peak per device is the arguments' bytes one mesh position holds, from
the specs (``StepBundle.per_device_arg_bytes``): exact for arguments;
temporaries are not modelled, and each row says so.  ``fits_hbm`` holds
it against the card's memory.  ``device=None`` means ``cuda:0`` (its
name picks the rates) and raises without CUDA; ``device="cpu"`` models an
H100 against the host's memory.  Results are appended to
``build/dryrun/results.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.configs.registry import ALL_NAMES, get_arch
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh, rules_for_mesh
from repro_torch.launch.steps import build_step
from repro_torch.utils import DeviceLike, human_bytes, resolve_device

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")

#: what the peak leaves out
PEAK_NOTE = "arguments only; temporaries not modelled"


def card_of(device: DeviceLike) -> tuple[str, int]:
    """(card name, memory bytes) of the device the rows are sized for."""
    dev = resolve_device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return props.name, int(props.total_memory)
    return "H100", os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _extrapolate(arch, shape, mesh, rules, l_full: int):
    """``repro``'s cost pass: counts of unrolled 4- and 8-layer models,
    extended linearly to ``l_full`` layers."""
    samples = {}
    for l_sub in (4, 8):
        arch_l = dataclasses.replace(
            arch, model=dataclasses.replace(arch.model, n_layers=l_sub))
        b = build_step(arch_l, shape, mesh, rules, unroll=True)
        samples[l_sub] = roofline.count_step(b.fn, b.abstract_args)[:3]

    def extra(a, b):
        return b + (l_full - 8) * (b - a) / 4.0

    (f4, n4, c4), (f8, n8, c8) = samples[4], samples[8]
    coll = {k: extra(c4.get(k, 0), v) for k, v in c8.items()}
    return extra(f4, f8), extra(n4, n8), coll


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             device: DeviceLike = None, verbose: bool = True,
             card: Optional[tuple[str, int]] = None) -> dict:
    """One cell on one production mesh.  ``card`` = (name, memory bytes)
    of the card to size for, where the caller has read them (a sweep's
    workers then need no CUDA context); else :func:`card_of` ``device``."""
    card, hbm = card or card_of(device)
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rules = rules_for_mesh(mesh)
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    chips = mesh.devices.size
    mesh_desc = "x".join(str(s) for s in mesh.devices.shape)

    # ---- pass 1: deployment (every op at FULL shapes)
    bundle = build_step(arch, shape, mesh, rules)
    flops, nbytes, coll, _ = roofline.count_step(bundle.fn,
                                                 bundle.abstract_args)
    t_deploy = time.perf_counter() - t0

    # ---- pass 2: cost (LM cells, single pod)
    needs_unroll = shape.kind.startswith("lm")
    t_cost = 0.0
    if needs_unroll and not multi_pod:
        t1 = time.perf_counter()
        l_full = arch.model.n_layers
        if l_full <= 8:
            b = build_step(arch, shape, mesh, rules, unroll=True)
            flops, nbytes, coll = roofline.count_step(b.fn,
                                                      b.abstract_args)[:3]
        else:
            flops, nbytes, coll = _extrapolate(arch, shape, mesh, rules,
                                               l_full)
        t_cost = time.perf_counter() - t1

    model_flops = bundle.model_flops_fn() if bundle.model_flops_fn else None
    modelled = bundle.counts_collectives
    report = roofline.RooflineReport(
        name=f"{arch_name}:{shape_name}", mesh=mesh_desc, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=nbytes / 1e9,
        coll_gbytes=(sum(coll.values()) / 1e9 if modelled else None),
        per_collective=coll,
        model_gflops=(model_flops / 1e9 if model_flops else None),
        peak_memory_bytes=bundle.per_device_arg_bytes(mesh), card=card)

    result = report.to_dict()
    result.update({
        "arch": arch_name, "shape": shape_name, "multi_pod": multi_pod,
        "cost_exact": True,
        "peak_note": PEAK_NOTE,
        "deploy_s": round(t_deploy, 2), "cost_s": round(t_cost, 2),
        "hbm_bytes": hbm,
        "fits_hbm": report.peak_memory_bytes < hbm,
        "status": "ok",
        "note": shape.note,
    })
    if verbose:
        print(format_row(result), flush=True)
    return result


def _t(x) -> str:
    return "not modelled" if x is None else f"{x:.3e} s"


def format_row(r: dict) -> str:
    return (f"[dryrun] {r['name']} mesh={r['mesh']} "
            f"GFLOP={r['hlo_gflops']:.4g} GB={r['hlo_gbytes']:.4g} "
            f"model GFLOP={r['model_gflops'] or 0:.4g} "
            f"args/dev={human_bytes(r['peak_memory_bytes'])} "
            f"({r['peak_note']}) fits_hbm={r['fits_hbm']} "
            f"compute={_t(r['t_compute_s'])} memory={_t(r['t_memory_s'])} "
            f"collective={_t(r['t_collective_s'])} "
            f"bottleneck={r['bottleneck']} "
            f"pass {r['deploy_s']}+{r['cost_s']} s")


def _append_result(result: dict, out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(result) + "\n")


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for name in ALL_NAMES:
        arch = get_arch(name)
        for shape in arch.shapes:
            cells.append((name, shape.name))
    return cells


def _weight(cell) -> int:
    """A rough host cost of a cell's passes, to balance a sweep's workers
    (a MoE or wide LM train step's meta pass is the longest)."""
    kind = get_arch(cell[0]).shape(cell[1]).kind
    return {"lm_train": 20, "lm_prefill": 3, "lm_decode": 2}.get(kind, 1)


def _read_rows(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _key(r: dict) -> tuple[str, str, str]:
    return r["arch"], r["shape"], "multi" if r.get("multi_pod") else "single"


def sweep(cells, out_path: str, workers: int = 1, timeout: int = 3600,
          device: DeviceLike = None,
          card: Optional[tuple[str, int]] = None
          ) -> list[tuple[str, str, str]]:
    """Run the (arch, shape, "single"|"multi") cells in ``workers``
    processes, each taking a share balanced by :func:`_weight` and running
    it cell after cell (a failed cell is recorded and the rest go on; a
    process pays torch's import once); returns the cells without an "ok"
    row."""
    groups = [[] for _ in range(max(1, min(workers, len(cells))))]
    loads = [0] * len(groups)
    for cell in sorted(cells, key=_weight, reverse=True):
        i = loads.index(min(loads))
        groups[i].append(cell)
        loads[i] += _weight(cell)

    def run(group):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
               ",".join(":".join(c) for c in group), "--out", out_path]
        if device is not None:
            cmd += ["--device", str(device)]
        if card is not None:
            cmd += ["--card", card[0], "--hbm", str(card[1])]
        try:
            subprocess.run(cmd, env=os.environ, timeout=timeout)
        except subprocess.TimeoutExpired:
            pass

    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        list(pool.map(run, groups))
    ok = {_key(r) for r in _read_rows(out_path) if r.get("status") == "ok"}
    return [c for c in cells if c not in ok]


def run_cells(cells, out_path: str, device: DeviceLike = None,
              card: Optional[tuple[str, int]] = None) -> bool:
    """Run cells in this process, appending a row each (an error row for
    a cell that raises); True if every cell ran."""
    all_ok = True
    for arch_name, shape_name, mesh_kind in cells:
        try:
            result = run_cell(arch_name, shape_name,
                              multi_pod=(mesh_kind == "multi"),
                              device=device, card=card)
        except Exception as e:
            traceback.print_exc()
            all_ok = False
            result = {"arch": arch_name, "shape": shape_name,
                      "multi_pod": mesh_kind == "multi",
                      "status": f"error: {type(e).__name__}: {e}"}
        _append_result(result, out_path)
    return all_ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--cells", default=None,
                    help="arch:shape:single|multi,... run in this process")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600,
                    help="seconds a worker process of --all may take")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes under --all")
    ap.add_argument("--device", default=None,
                    help="the card the rows are sized for (default cuda:0)")
    ap.add_argument("--card", default=None,
                    help="size for this card name instead of --device's "
                         "(with --hbm, its memory in bytes)")
    ap.add_argument("--hbm", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = (args.card, args.hbm) if args.card else None

    out_path = args.out or os.path.abspath(
        os.path.join(RESULTS_DIR, "results.jsonl"))
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    if args.all:
        done = set()
        if args.skip_done:
            done = {_key(r) for r in _read_rows(out_path)
                    if r.get("status") == "ok"}
        todo = [(a, sh, m) for a, sh in all_cells() for m in meshes
                if (a, sh, m) not in done]
        failures = sweep(todo, out_path, args.workers, args.timeout,
                         args.device, card)
        print(f"\n{len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, m) for m in meshes]
    else:
        ap.error("--arch and --shape required (or --cells, or --all)")
    sys.exit(0 if run_cells(cells, out_path, args.device, card) else 1)


if __name__ == "__main__":
    main()
