"""Drive the PyTorch/CUDA port's exact and IVF search paths on one NVIDIA GPU.

    python3 chip_smoke.py [--n-docs 1000000] [--n-queries 2048] [--seed 0]

Phases, each printed as it runs:

1. environment — torch/CUDA versions and the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN.  No CUDA device: exit 1.
2. build — nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a into
   ``build/`` (one process per source, in parallel).
3. kernels — each Hopper kernel (int8_ip, binary_ip, topk_blocks,
   fused_ivf_topk) runs on the card at the main path's shapes (Q=256,
   D=1M; d=128 int8, 8 words 1-bit; top-k at k=10 and k=100; IVF with
   nlist 1024, lists of 1221 rows, 64 probes) and is held against its
   plain PyTorch version on the same inputs: binary_ip, topk_blocks and
   1-bit IVF exactly, the f32 sums of int8_ip and float/fp16/int8 IVF to
   atol = 1e-5·max|plain| (summation order), IVF ids equal wherever the
   plain values' neighbours lie further apart.  Timed with CUDA events
   beside the plain version, one PyTorch library call (``library_ms``,
   used nowhere in the port; none gathers, scores and ranks per probe, so
   null for IVF) and the card's bound.
4. main path — a synthetic DPR-like KB (768-dim f32, ``--n-docs`` docs)
   indexed with the paper's 24× recipe (PCA-128 + int8) and 100× recipe
   (PCA-245 + 1-bit) plus a float baseline, through ``build_index``;
   each index is saved, loaded back and must rank bit-identically; then
   the queries are searched in batches of 256 at k=10 (qps, p50/p99
   batch latency, R-precision and its share of the float baseline).
   Every kernel's launch counter must rise during these searches.  The
   kernel path is checked against the plain-torch path on the card, and
   one batch per index is traced with torch.profiler (device time by
   kernel, busy share).
5. IVF — the repo's gated IVF recipe (kmeans++, balanced lists, 8
   Lloyd iterations) at the paper's two widths, nlist 1024 ≈ √1M, nprobe
   64: PCA-128 + int8 and PCA-245 + rotated 1-bit, through
   ``build_index``; each is saved and loaded (bit-identical ranking), its
   kernel path held against the streaming plain-torch path, and
   nprobe = nlist search over the exact indexes' storage (``to_ivf``)
   held against exact search.  Then the queries are searched in batches
   of 256 at nprobe 16, 64 and 256 (qps, p50/p99, recall@10 against
   nprobe = nlist, R-precision's share of float), with the launch counts
   set to 0 before and read after; one batch per index is traced.
6. the last two lines: ``{"kernels": [...]}`` and the device line.

Any failure raises before the last line, and the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402

from repro_torch.kernels import (_build, launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.binary_ip.kernel import binary_ip  # noqa: E402
from repro_torch.kernels.binary_ip.ref import sign_dot_ref  # noqa: E402
from repro_torch.kernels.int8_ip.kernel import int8_ip  # noqa: E402
from repro_torch.kernels.int8_ip.ref import int8_ip_ref  # noqa: E402
from repro_torch.kernels.ivf_fused.kernel import (  # noqa: E402
    MAX_K, fused_ivf_topk)
from repro_torch.kernels.ivf_fused.ref import fused_ivf_topk_ref  # noqa: E402
from repro_torch.kernels.topk_blocks.kernel import topk_blocks  # noqa: E402
from repro_torch.kernels.topk_blocks.ops import (  # noqa: E402
    default_block_d, streaming_topk)
from repro_torch.kernels.topk_blocks.ref import topk_blocks_ref  # noqa: E402

Q, D_MAIN, D_INT8, W_ONEBIT = 256, 1_000_000, 128, 8
BATCH, K = 256, 10
#: IVF at 1M docs: nlist ≈ √1M, the balanced cap's longest list, nprobe
NLIST, L_MAIN, NPROBE = 1024, 1221, 64
NPROBES_TIMED = (16, 64, 256)

#: name fragment → (bytes/s, bf16 FLOP/s, int8 OP/s, f32 FLOP/s), dense
#: rates from NVIDIA's data sheets; the SXM part is the default
CARDS = {
    "H100 PCIe": (2.0e12, 756e12, 1513e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 1671e12, 60e12),
    "H200": (4.8e12, 989e12, 1979e12, 67e12),
    "H100": (3.35e12, 989e12, 1979e12, 67e12),
}


def card_rates(name: str) -> tuple[float, float, float, float]:
    for frag, rates in CARDS.items():
        if frag in name:
            return rates
    return CARDS["H100"]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, op_rate: float,
          byte_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / byte_rate, n_ops / op_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}")
    print(f"[env] tf32 off: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    print(smi)            # the card's name and power limit, as nvidia-smi says
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")


def check_ragged_shapes(gen) -> None:
    """Edges the main path's shapes miss: partial tiles, d not a multiple
    of the staging width, k > block_d, −inf scores and ties."""
    dev = "cuda"
    for q, d, dim in ((5, 37, 48), (130, 1000, 100), (1, 3, 128)):
        qs = torch.randn(q, dim, device=dev, generator=gen).to(torch.bfloat16)
        u8 = torch.randint(0, 256, (d, dim), device=dev, generator=gen,
                           dtype=torch.uint8)
        got, want = int8_ip(qs, u8), int8_ip_ref(qs, u8)
        if float((got - want).abs().max()) > 1e-5 * float(want.abs().max()):
            raise AssertionError(f"int8_ip disagrees at {(q, d, dim)}")
    for q, d, n_words in ((7, 33, 2), (65, 130, 3), (1, 1, 1), (9, 70, 9)):
        signs = (torch.randint(0, 2, (q, 32 * n_words), device=dev,
                               generator=gen) * 2 - 1).to(torch.int8)
        words = torch.randint(-2**31, 2**31 - 1, (d, n_words), device=dev,
                              generator=gen, dtype=torch.int32)
        if not torch.equal(binary_ip(signs, words),
                           sign_dot_ref(signs, words)):
            raise AssertionError(f"binary_ip disagrees at {(q, d, n_words)}")
    ties = torch.arange(16, device=dev).flip(0).div(2, rounding_mode="floor")
    for scores, k, bd in (
            (torch.randn(3, 50, device=dev, generator=gen), 10, 16),
            (torch.randn(4, 20, device=dev, generator=gen), 20, 8),
            (torch.randn(10, 333, device=dev, generator=gen)
             .masked_fill_(torch.rand(10, 333, device=dev, generator=gen)
                           < 0.9, float("-inf")), 7, 64),
            (ties.float().repeat(3, 1), 5, 4)):
        got, want = topk_blocks(scores, k, bd), topk_blocks_ref(scores, k, bd)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"topk_blocks disagrees at "
                                 f"{tuple(scores.shape)} k={k} block_d={bd}")
    torch.cuda.synchronize()
    print("[kernel] ragged shapes, k > block_d, -inf and ties: all exact")


def phase_kernels(rates) -> list[dict]:
    byte_rate, bf16_rate, int8_rate, f32_rate = rates
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    check_ragged_shapes(gen)
    out = []

    # -- int8_ip: (Q, 128) bf16 × (1M, 128) u8 --------------------------
    q_scaled = torch.randn(Q, D_INT8, device=dev, generator=gen) \
        .mul_(0.01).to(torch.bfloat16)
    codes = torch.randint(0, 256, (D_MAIN, D_INT8), device=dev,
                          generator=gen, dtype=torch.uint8)
    got, want = int8_ip(q_scaled, codes), int8_ip_ref(q_scaled, codes)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    ok = err <= tol
    print(f"[kernel] int8_ip (256, 1M, d=128): max_abs_err {err:.3g} "
          f"(tol {tol:.3g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("int8_ip disagrees with int8_ip_ref")
    docs_bf16 = codes.to(torch.bfloat16)
    b_ms, b_by = bound(Q * D_INT8 * 2 + D_MAIN * D_INT8 + Q * D_MAIN * 4,
                       2.0 * Q * D_MAIN * D_INT8, bf16_rate, byte_rate)
    out.append({
        "name": "int8_ip", "route": "cuda",
        "source": "src/repro_torch/csrc/int8_ip.cu",
        "replaces": "src/repro/kernels/int8_ip/kernel.py:51",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: int8_ip(q_scaled, codes), 20),
        "plain_ms": cuda_ms(lambda: int8_ip_ref(q_scaled, codes), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.mm(q_scaled, docs_bf16.T), 20),
        "shape": "Q=256 D=1000000 d=128"})
    del got, want, docs_bf16, codes

    # -- binary_ip: (Q, 256) ±1 signs × (1M, 8) words -----------------
    d_packed = 32 * W_ONEBIT
    signs = (torch.randint(0, 2, (Q, d_packed), device=dev, generator=gen)
             * 2 - 1).to(torch.int8)
    words = torch.randint(-2**31, 2**31 - 1, (D_MAIN, W_ONEBIT), device=dev,
                          generator=gen, dtype=torch.int32)
    got, want = binary_ip(signs, words), sign_dot_ref(signs, words)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[kernel] binary_ip (256, 1M, 8 words): max_abs_err {err:g} "
          f"{'ok' if err == 0 else 'MISMATCH'}")
    if not torch.equal(got, want):
        raise AssertionError("binary_ip disagrees with sign_dot_ref")
    tie_scores = got.float().mul_(0.25)       # the 1-bit path's top-k input
    del got, want
    from repro_torch.core.quantization import unpack_bits
    docs_pm = unpack_bits(words, d_packed).to(torch.float16)
    signs_h = signs.to(torch.float16)
    b_ms, b_by = bound(Q * d_packed + D_MAIN * W_ONEBIT * 4 + Q * D_MAIN * 4,
                       2.0 * Q * D_MAIN * d_packed, int8_rate, byte_rate)
    out.append({
        "name": "binary_ip", "route": "cuda",
        "source": "src/repro_torch/csrc/binary_ip.cu",
        "replaces": "src/repro/kernels/binary_ip/kernel.py:69",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: binary_ip(signs, words), 20),
        "plain_ms": cuda_ms(lambda: sign_dot_ref(signs, words), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.mm(signs_h, docs_pm.T), 20),
        "shape": "Q=256 D=1000000 words=8"})
    del docs_pm, signs_h, words

    # -- topk_blocks: (Q, 1M) f32, k=10 and k=100, random and tie-heavy --
    normal = torch.randn(Q, D_MAIN, device=dev, generator=gen)
    entry = None
    for k in (K, 100):
        bd = default_block_d(k)
        for label, scores in (("normal", normal), ("ties", tie_scores)):
            gv, gi = topk_blocks(scores, k, bd)
            wv, wi = topk_blocks_ref(scores, k, bd)
            torch.cuda.synchronize()
            same = torch.equal(gv, wv) and torch.equal(gi, wi)
            print(f"[kernel] topk_blocks (256, 1M) k={k} {label}: "
                  f"{'exact' if same else 'MISMATCH'}")
            if not same:
                raise AssertionError(f"topk_blocks k={k} ({label}) disagrees "
                                     "with topk_blocks_ref")
            # two stages against lax.top_k's order on the full row
            fv, fi = streaming_topk(scores, k, use_kernel=True)
            rv, ri = streaming_topk(scores, k, use_kernel=False)
            if not (torch.equal(fv, rv) and torch.equal(fi, ri)):
                raise AssertionError(f"streaming_topk k={k} ({label}) "
                                     "disagrees with the full-row top-k")
        n_blocks = -(-D_MAIN // bd)
        b_ms, b_by = bound(Q * D_MAIN * 4 + Q * n_blocks * k * 8,
                           float(Q * D_MAIN), f32_rate, byte_rate)
        rec = {
            "name": "topk_blocks", "route": "cuda",
            "source": "src/repro_torch/csrc/topk_blocks.cu",
            "replaces": "src/repro/kernels/topk_blocks/kernel.py:75",
            "max_abs_err": float((gv - wv).abs().max()),
            "ms": cuda_ms(lambda: topk_blocks(normal, k, bd), 10),
            "plain_ms": cuda_ms(lambda: topk_blocks_ref(normal, k, bd), 2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.topk(normal, k), 10),
            "two_stage_ms": cuda_ms(
                lambda: streaming_topk(normal, k, use_kernel=True), 10),
            "shape": f"Q=256 D=1000000 k={k} block_d={bd}"}
        print(f"[kernel] topk_blocks k={k}: {json.dumps(rec)}")
        if k == K:
            entry = rec
    out.append(entry)
    del normal, tie_scores
    for rec in out[:2]:
        print(f"[kernel] {rec['name']}: {json.dumps(rec)}")
    torch.cuda.empty_cache()
    return out


def ranking_agrees(got, want, exact: bool) -> tuple[bool, float]:
    """Do two (Q, k) rankings agree?  ``exact``: ids and value bits equal.
    Otherwise values within 1e-5·max|want| (f32 summation order), and ids
    equal at every rank whose neighbouring wanted values lie further apart
    than that, and wherever the wanted value is −inf."""
    (gv, gi), (wv, wi) = got, want
    fin = torch.isfinite(wv)
    if gi.shape != wi.shape or not torch.equal(torch.isfinite(gv), fin):
        return False, float("inf")
    if not bool(fin.any()):
        return torch.equal(gi, wi), 0.0
    err = float((gv[fin] - wv[fin]).abs().max())
    if exact:
        return (torch.equal(gi, wi) and torch.equal(
            gv.view(torch.int32), wv.view(torch.int32))), err
    tol = 1e-5 * float(wv[fin].abs().max())
    d = (wv[:, 1:] - wv[:, :-1]).abs().nan_to_num(nan=float("inf"))
    gap = torch.full_like(wv, float("inf"))
    gap[:, 1:] = torch.minimum(gap[:, 1:], d)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d)
    apart = fin & (gap > tol)
    ok = (err <= tol and torch.equal(gi[apart], wi[apart])
          and torch.equal(gi[~fin], wi[~fin]))
    return ok, err


def ivf_case(gen, backend: str, n_q: int, nlist: int, max_len: int,
             nprobe: int, dim: int = D_INT8, all_pad: int = 4):
    """Synthetic list-major inputs for ``fused_ivf_topk``: distinct doc ids
    with ~15% −1 pads and ``all_pad`` empty lists, ``nprobe`` distinct
    probes per query and a random base, on the card."""
    dev = "cuda"
    ids = torch.randperm(nlist * max_len, device=dev, generator=gen) \
        .to(torch.int32).view(nlist, max_len)
    ids[torch.rand(nlist, max_len, device=dev, generator=gen) < 0.15] = -1
    ids[:all_pad] = -1
    shape = (nlist, max_len, dim)
    if backend == "float":
        store = torch.randn(shape, device=dev, generator=gen)
    elif backend == "fp16":
        store = torch.randn(shape, device=dev, generator=gen).half()
    elif backend == "int8":
        store = torch.randint(0, 256, shape, device=dev, generator=gen,
                              dtype=torch.uint8)
    else:
        store = torch.randint(-2**31, 2**31 - 1, (nlist, max_len, dim // 32),
                              device=dev, generator=gen, dtype=torch.int32)
    if backend == "onebit":
        qe = (torch.randint(0, 2, (n_q, dim), device=dev, generator=gen)
              * 2 - 1).to(torch.int8)
    else:
        qe = torch.randn(n_q, dim, device=dev, generator=gen)
        if backend == "int8":
            qe = qe.mul_(0.01).to(torch.bfloat16)
    probes = torch.stack([
        torch.randperm(nlist, device=dev, generator=gen)[:nprobe]
        for _ in range(n_q)]).to(torch.int32)
    base = torch.randn(n_q, nprobe, device=dev, generator=gen)
    return probes, qe, store, ids, base


def check_ivf_ragged(gen) -> None:
    """IVF edges the main shapes miss: one probe, k = 100, k beyond the
    reachable rows (tail (−inf, −1)), k = MAX_K, lists longer than a tile,
    one-row lists, odd widths."""
    cases = [  # (n_q, nlist, L, nprobe, k, dim)
        (5, 64, 300, 1, 10, 128), (7, 64, 300, 5, 100, 96),
        (3, 16, 50, 2, MAX_K, 64), (4, 8, 5000, 3, 10, 160),
        (9, 32, 1, 32, 20, 32), (2, 16, 77, 16, 300, 288)]
    for n_q, nlist, max_len, nprobe, k, dim in cases:
        for backend in ("float", "fp16", "int8", "onebit"):
            args = ivf_case(gen, backend, n_q, nlist, max_len, nprobe, dim,
                            all_pad=1)
            want = fused_ivf_topk_ref(*args, k=k, backend=backend)
            ok, _ = ranking_agrees(fused_ivf_topk(*args, k, backend), want,
                                   exact=backend == "onebit")
            if not ok:
                raise AssertionError(
                    f"fused_ivf_topk[{backend}] disagrees at Q={n_q} "
                    f"nlist={nlist} L={max_len} nprobe={nprobe} k={k}")
            if nprobe * max_len < k and not bool(
                    (want[1][:, -1] == -1).all()):
                raise AssertionError("unreachable tail is not (-inf, -1)")
    torch.cuda.synchronize()
    print("[kernel] fused_ivf_topk ragged: nprobe 1, k 100, k > reachable, "
          f"k = {MAX_K}, L > tile, L = 1, odd widths: all agree")


def phase_ivf_kernel(rates) -> dict:
    """fused_ivf_topk at the main path's shapes, all four backends."""
    byte_rate, bf16_rate, int8_rate, f32_rate = rates
    gen = torch.Generator(device="cuda").manual_seed(1)
    check_ivf_ragged(gen)
    rec = {"name": "fused_ivf_topk", "route": "cuda",
           "source": "src/repro_torch/csrc/ivf_fused.cu",
           "replaces": "src/repro/kernels/ivf_fused/kernel.py:146",
           "library_ms": None,
           "library_note": "no single PyTorch call gathers, scores and "
                           "ranks each query's probed lists",
           "shape": f"Q={Q} nlist={NLIST} L={L_MAIN} nprobe={NPROBE} "
                    f"k={K}; int8 d={D_INT8}, 1-bit {W_ONEBIT} words"}
    for backend in ("float", "fp16", "int8", "onebit"):
        dim = 32 * W_ONEBIT if backend == "onebit" else D_INT8
        args = ivf_case(gen, backend, Q, NLIST, L_MAIN, NPROBE, dim)
        probes, qe, store, ids, base = args
        got = fused_ivf_topk(*args, K, backend)
        want = fused_ivf_topk_ref(*args, k=K, backend=backend)
        torch.cuda.synchronize()
        ok, err = ranking_agrees(got, want, exact=backend == "onebit")
        print(f"[kernel] fused_ivf_topk[{backend}] (Q={Q}, nlist={NLIST}, "
              f"L={L_MAIN}, nprobe={NPROBE}, k={K}): max_abs_err {err:.3g} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"fused_ivf_topk[{backend}] disagrees with "
                                 "fused_ivf_topk_ref")
        if backend not in ("int8", "onebit"):
            continue
        # bound: each distinct probed list's rows and ids once, queries,
        # probes, base and outputs; the valid (query, row) pairs' products
        n_lists = int(torch.unique(probes).numel())
        row_bytes = store.shape[-1] * store.element_size()
        n_bytes = (n_lists * L_MAIN * (row_bytes + 4)
                   + qe.numel() * qe.element_size() + probes.numel() * 8
                   + Q * K * 8)
        pairs = int((ids[probes.long()] >= 0).sum())
        n_ops = 2.0 * pairs * dim
        b_ms, b_by = bound(n_bytes, n_ops,
                           bf16_rate if backend == "int8" else int8_rate,
                           byte_rate)
        ms = cuda_ms(lambda: fused_ivf_topk(*args, K, backend), 10)
        plain_ms = cuda_ms(
            lambda: fused_ivf_topk_ref(*args, k=K, backend=backend), 2)
        pre = "" if backend == "int8" else "onebit_"
        rec.update({f"{pre}max_abs_err": err, f"{pre}ms": ms,
                    f"{pre}plain_ms": plain_ms, f"{pre}bound_ms": b_ms,
                    f"{pre}bound_by": b_by,
                    f"{pre}distinct_lists": n_lists})
        print(f"[kernel] fused_ivf_topk[{backend}]: {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{n_bytes / 1e9:.4f} GB, {n_ops / 1e9:.3f} GOP)")
        del got, want, args, probes, qe, store, ids, base
    torch.cuda.empty_cache()
    print(f"[kernel] fused_ivf_topk: {json.dumps(rec)}")
    return rec


def _search_batches(index, queries, k, **kw):
    """Search in batches of BATCH; (values, ids, per-batch seconds)."""
    vals, ids, secs = [], [], []
    for s in range(0, queries.shape[0], BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, i = index.search(queries[s: s + BATCH], k, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids), secs


def profile_batches(indexes, queries, **kw) -> None:
    """Device time by kernel for one search batch per index (torch.profiler)
    and the device's busy share of the batch's wall time.  A warm-up step
    inside the profiler comes first: without it the trace lost the first
    kernels of short batches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for name, index in indexes.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            index.search(queries[:BATCH], K, **kw)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            index.search(queries[:BATCH], K, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        rows = []
        for evt in prof.key_averages():
            # kernels only: an operator's row repeats its kernels' time, and
            # the schedule's step row spans the whole step
            if evt.device_type != torch.autograd.DeviceType.CUDA or \
                    evt.key.startswith("ProfilerStep"):
                continue
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us / 1e3, evt.key, evt.count))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        top = "; ".join(f"{key[:60]} x{n} {ms:.3f} ms" for ms, key, n in rows[:8])
        print(f"[profile] {name}: batch {BATCH} wall {wall_ms:.3f} ms "
              f"(profiled), device {busy:.3f} ms, busy share "
              f"{busy / wall_ms:.3f}; {top}")


def make_kb(args):
    from repro_torch.data import make_dpr_like_kb

    t0 = time.perf_counter()
    kb = make_dpr_like_kb(n_queries=args.n_queries, n_docs=args.n_docs,
                          d=768, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] KB {tuple(kb.docs.shape)} f32 docs, "
          f"{tuple(kb.queries.shape)} queries, seed {args.seed}: "
          f"{time.perf_counter() - t0:.1f} s")
    return kb


def phase_main_path(args, kb):
    """Exact search; returns (launch counts, loaded indexes, float R-prec.)."""
    from repro_torch.retrieval import (IndexSpec, build_index, load_index,
                                       r_precision_from_ids, recall_at_k)

    recipes = {
        "float": IndexSpec(method="dense"),
        "pca_int8_24x": IndexSpec(method="pca_int8", dim=128, post=False),
        "pca_onebit_100x": IndexSpec(method="pca_onebit", dim=245,
                                     post=False),
    }
    path_kernels = {"float": ("topk_blocks",),
                    "pca_int8_24x": ("int8_ip", "topk_blocks"),
                    "pca_onebit_100x": ("binary_ip", "topk_blocks")}
    queries = kb.queries
    indexes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, spec in recipes.items():
            t0 = time.perf_counter()
            built = build_index(spec, kb.docs, kb.queries, device="cuda")
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.npz")
            built.save(path)
            loaded = load_index(path, device="cuda")
            bv, bi = built.search(queries[:BATCH], K)
            lv, li = loaded.search(queries[:BATCH], K)
            same = torch.equal(bi, li) and torch.equal(
                bv.view(torch.int32), lv.view(torch.int32))
            print(f"[main] {name}: built in {t_build:.1f} s, "
                  f"{loaded.nbytes / len(loaded):g} B/doc "
                  f"({768 * 4 * len(loaded) / loaded.nbytes:.1f}x vs f32), "
                  f"saved+loaded ranking "
                  f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"{name}: loaded artifact ranks "
                                     "differently from the built index")
            indexes[name] = loaded
            # the plain-torch path on the card as the reference
            ref = load_index(path, device="cuda", backend="torch")
            rv, ri = ref.search(queries[:BATCH], K)
            overlap = recall_at_k(li, ri)
            exact = torch.equal(li, ri) and torch.equal(lv, rv)
            print(f"[main] {name}: kernel path vs plain-torch path on the "
                  f"card: recall@{K} {overlap:.4f}, "
                  f"{'bit-identical' if exact else 'not bit-identical'}")
            if name != "pca_int8_24x" and not exact:
                raise AssertionError(f"{name}: kernel path disagrees with "
                                     "the plain-torch path")
            if overlap < 0.95:
                raise AssertionError(f"{name}: kernel path overlaps the "
                                     f"plain-torch path by {overlap:.3f}")
            del built, ref
        torch.cuda.empty_cache()

    # warm-up batch per index, outside the counted run
    for index in indexes.values():
        index.search(queries[:BATCH], K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    results, per_recipe = {}, {}
    for name, index in indexes.items():
        before = launch_counts()
        vals, ids, secs = _search_batches(index, queries, K)
        after = launch_counts()
        per_recipe[name] = {n: after[n] - before[n] for n in after}
        results[name] = (vals, ids, secs)
    counts = launch_counts()

    rp_float = r_precision_from_ids(results["float"][1], kb.relevant)
    for name, (vals, ids, secs) in results.items():
        if vals.shape != (queries.shape[0], K) or \
                not bool(torch.isfinite(vals).all()) or \
                int(ids.min()) < 0 or int(ids.max()) >= args.n_docs:
            raise AssertionError(f"{name}: malformed search output")
        rp = r_precision_from_ids(ids, kb.relevant)
        ms = sorted(s * 1e3 for s in secs)
        p99 = ms[min(len(ms) - 1, round(0.99 * (len(ms) - 1)))]
        print(f"[main] {name}: {queries.shape[0] / sum(secs):.1f} qps, "
              f"batch {BATCH} p50 {statistics.median(ms):.3f} ms p99 "
              f"{p99:.3f} ms, R-precision {rp:.4f} "
              f"({rp / rp_float:.4f} of float), "
              f"{indexes[name].nbytes} encoded bytes, "
              f"launches {per_recipe[name]}")
        for kern in path_kernels[name]:
            if per_recipe[name][kern] < 1:
                raise AssertionError(f"{name}: {kern} never launched on the "
                                     "main path")
    print(f"[main] launches over the main path: {counts}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_batches(indexes, queries)
    return counts, indexes, rp_float


def phase_ivf(args, kb, exact, rp_float) -> dict[str, int]:
    """IVF search at the paper's two widths; returns the launch counts of
    the timed run."""
    from repro_torch.retrieval import (IndexSpec, build_index, load_index,
                                       r_precision_from_ids, recall_at_k)

    gated = dict(post=False, ivf=(NLIST, NPROBE), kmeans_iters=8,
                 kmeans_init="++", balanced_lists=True)
    recipes = {   # name → (spec, exact index over the same recipe's storage)
        "ivf_int8_24x": (IndexSpec(method="pca_int8", dim=128, **gated),
                         "pca_int8_24x"),
        "ivf_rot_onebit_100x": (
            IndexSpec(method="pca_rot_onebit", dim=245, **gated),
            "pca_onebit_100x"),
    }
    queries, q0 = kb.queries, kb.queries[:BATCH]
    search_kw = dict(query_chunk=BATCH)
    indexes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (spec, exact_name) in recipes.items():
            onebit = "onebit" in name
            t0 = time.perf_counter()
            built = build_index(spec, kb.docs, kb.queries, device="cuda")
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.npz")
            built.save(path)
            loaded = load_index(path, device="cuda")
            bv, bi = built.search(q0, K, **search_kw)
            lv, li = loaded.search(q0, K, **search_kw)
            same = torch.equal(bi, li) and torch.equal(
                bv.view(torch.int32), lv.view(torch.int32))
            sizes = torch.bincount(torch.from_numpy(loaded._labels).long(),
                                   minlength=loaded.nlist)
            print(f"[ivf] {name}: built in {t_build:.1f} s, nlist "
                  f"{loaded.nlist}, longest list L {loaded.lists.shape[1]} "
                  f"(mean {len(loaded) / loaded.nlist:.1f}, empty "
                  f"{int((sizes == 0).sum())}), {loaded.nbytes} encoded "
                  f"bytes, aux_nbytes {loaded.aux_nbytes} (list-major copy "
                  f"included), saved+loaded ranking "
                  f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"{name}: loaded artifact ranks "
                                     "differently from the built index")
            # the streaming plain-torch path on the card as the reference
            ref = load_index(path, device="cuda", backend="torch")
            rv, ri = ref.search(q0, K, **search_kw)
            overlap = recall_at_k(li, ri)
            exact_bits = torch.equal(li, ri) and torch.equal(lv, rv)
            print(f"[ivf] {name}: kernel path vs streaming plain-torch path "
                  f"on the card: recall@{K} {overlap:.4f}, "
                  f"{'bit-identical' if exact_bits else 'not bit-identical'}")
            if (onebit and not exact_bits) or overlap < 0.95:
                raise AssertionError(f"{name}: kernel path disagrees with "
                                     "the streaming path")
            # nprobe = nlist over the exact index's own storage: exact search
            t0 = time.perf_counter()
            promoted = exact[exact_name].to_ivf(NLIST, NPROBE, docs=kb.docs)
            fv, fi = promoted.search(q0, K, nprobe=NLIST, **search_kw)
            torch.cuda.synchronize()
            t_full = time.perf_counter() - t0
            ok, err = ranking_agrees((fv, fi), exact[exact_name].search(q0, K),
                                     exact=onebit)
            print(f"[ivf] {exact_name}.to_ivf({NLIST}) at nprobe = nlist "
                  f"(L {promoted.lists.shape[1]}, {t_full:.1f} s with the "
                  f"fit) vs exact search: max_abs_err {err:.3g}, "
                  f"{'agrees' if ok else 'DIFFERS'}"
                  f"{' bit for bit' if ok and onebit else ''}")
            if not ok:
                raise AssertionError(f"{name}: full probe differs from exact "
                                     "search")
            del built, ref, promoted
            indexes[name] = loaded
            torch.cuda.empty_cache()

    # each index's own nprobe = nlist ranking is the recall reference
    full = {name: _search_batches(index, queries, K, nprobe=NLIST,
                                  **search_kw)[1]
            for name, index in indexes.items()}
    for index in indexes.values():            # warm-up, outside the count
        for nprobe in NPROBES_TIMED:
            index.search(q0, K, nprobe=nprobe, **search_kw)
    torch.cuda.synchronize()

    reset_launch_counts()
    per_index = {}
    for name, index in indexes.items():
        before = launch_counts()
        for nprobe in NPROBES_TIMED:
            vals, ids, secs = _search_batches(index, queries, K,
                                              nprobe=nprobe, **search_kw)
            if vals.shape != (queries.shape[0], K) or \
                    not bool(torch.isfinite(vals).all()) or \
                    int(ids.min()) < 0 or int(ids.max()) >= args.n_docs:
                raise AssertionError(f"{name}: malformed search output")
            rp = r_precision_from_ids(ids, kb.relevant)
            ms = sorted(x * 1e3 for x in secs)
            p99 = ms[min(len(ms) - 1, round(0.99 * (len(ms) - 1)))]
            print(f"[ivf] {name} nprobe {nprobe}: "
                  f"{queries.shape[0] / sum(secs):.1f} qps, batch {BATCH} "
                  f"p50 {statistics.median(ms):.3f} ms p99 {p99:.3f} ms, "
                  f"recall@{K} vs nprobe=nlist "
                  f"{recall_at_k(ids, full[name]):.4f}, R-precision "
                  f"{rp:.4f} ({rp / rp_float:.4f} of float)")
        after = launch_counts()
        per_index[name] = {n: after[n] - before[n] for n in after}
        print(f"[ivf] {name}: launches {per_index[name]}")
        if per_index[name]["fused_ivf_topk"] < 1:
            raise AssertionError(f"{name}: fused_ivf_topk never launched")
    counts = launch_counts()
    print(f"[ivf] launches over the IVF path: {counts}")
    profile_batches(indexes, queries, nprobe=NPROBE, **search_kw)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=1_000_000)
    ap.add_argument("--n-queries", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    rates = card_rates(smi)
    kernels = phase_kernels(rates) + [phase_ivf_kernel(rates)]
    kb = make_kb(args)
    counts, exact, rp_float = phase_main_path(args, kb)
    ivf_counts = phase_ivf(args, kb, exact, rp_float)
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
    kernels[-1]["launches"] = ivf_counts["fused_ivf_topk"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s; card {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
