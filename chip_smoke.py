"""Drive the PyTorch/CUDA port's exact, IVF, sharded, tiered, served,
off-path and mutable paths, its model and LM paths, its launch path
(the paper's sharded KB search step, the dry run) and its five examples,
on one NVIDIA GPU.

    python3 chip_smoke.py [--n-docs 1000000] [--n-queries 2048] [--seed 0]

Phases, each printed as it runs:

1. environment — torch/CUDA versions and the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN.  No CUDA device: exit 1.
2. build — nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a into
   ``build/`` (one process per source, in parallel).
3. kernels — each Hopper kernel (int8_ip, binary_ip, topk_blocks,
   fused_ivf_topk, fused_quantize) runs on the card at the main path's
   shapes (Q=256, D=1M; d=128 int8 with and without its q·zero bias, 8
   words 1-bit; top-k at k=10, 100 and 1,010 — an exact main probed past
   1,000 tombstones — on random and tie-heavy scores, each with the
   two-stage time; ragged int8 widths and alignments, ±0.0 ties and blocks
   above 32,768 columns; binary_ip's f32 scores at 1 to 130 words and odd
   row offsets; IVF
   with nlist 1024, lists of 1221 rows, 64 and 256 probes, k=10 and
   k=1,510 (the seg_ivf_24x main after its deletes), k=1025/2048 above
   the shared-memory top-k, and int8 at k=16,384 and 282,778, the
   deepest probe of the seg_ivf_24x cell before it needs a compaction,
   each IVF shape timed with its sub-kernels' device ms from one traced
   call; the encode at (1M, 768) → 128 — its GB/s, share of its bytes
   bound, W's L2 bytes as the tile count gives them and an add's 16,384
   rows — and ragged widths up to 384 outputs, d = 77, rows off 16-byte
   boundaries, a scale of 1e30 and a column at the quantizer's floor
   scale, with the share of codes that differ from
   ``fused_quantize_split_ref``, the plain mirror of its split-bf16
   numerics, printed as information)
   and is held against its plain PyTorch version on the same inputs:
   binary_ip, topk_blocks and 1-bit IVF exactly, the f32 sums of int8_ip
   and float/fp16/int8 IVF to atol = 1e-5·max|plain| (summation order),
   IVF ids equal wherever the plain values' neighbours lie further apart,
   fused_quantize codes within 1 on < 1% (repro's bar) and each row's
   codes independent of the batch (bit for bit).  Timed with CUDA events
   beside the plain version, one PyTorch library call (``library_ms``,
   used nowhere in the port: a bf16 ``torch.mm`` writing f32 for int8_ip,
   an fp16 ±1 ``torch.mm`` for binary_ip (and the same writing f32),
   ``torch.topk`` for topk_blocks; none gathers, scores and ranks per
   probe, so null for IVF; the product alone for fused_quantize) and the
   card's bound.  Then stage 2 of the exact top-k, topk_merge, on
   topk_blocks' candidates at the dpr24x.bulk cell's shape (1,024 × 2.1M,
   k=100: 513 lists) and at (256, 1M) for k=10, 100 and 1,010, over
   normal, tie-heavy, seven-valued, ±0.0 and mostly −inf scores and the
   ragged top-k cases: ids and value bits equal to the sort path
   (``topk_score_then_id``), its CUDA-event ms beside the sort path's
   (``library_ms``) and its bound, its launches and the card, on a
   ``[kernel] topk_merge`` line of its own.
4. main path — a synthetic DPR-like KB (768-dim f32, ``--n-docs`` docs;
   both KBs are made on the host in worker threads while phases 2–3 run)
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
   held against exact search; each is built a second time from the same
   seed and held to the first bit for bit (centroids, list assignment,
   lists, codes, every fitted stage's state, one searched batch), beside
   k-means' update run three times each as the atomic ``index_add_`` the
   port had and as its fixed-order segment sum.  Then the queries are
   searched in batches of 256 at nprobe 16, 64 and 256 (qps, p50/p99,
   recall@10 against nprobe = nlist, R-precision's share of float), with
   the launch counts set to 0 before and read after; one batch per index
   is traced.
6. sharded — the 24x, 100x, IVF 24x and IVF 100x indexes saved as
   single-host artifacts and served with ``load_index(shard=...)``
   over a 1x4 and a 2x2 (replicas 2) mesh, all
   on cuda:0 (one card: multi-card placement is not exercised, and a line
   says so); the 2,048 queries in batches of 256 at k = 10 (IVF at nprobe
   16 and 64): p50/p99/qps beside the single-host index's, launches a
   batch by kernel, ids and score bits equal to the single-host search.
   The 1x4 24x and IVF 24x saved as sharded artifacts and loaded back; a
   sharded build of the post recipe (fused_quantize, codes equal); a
   SegmentedIndex over the sharded 24x main (16,384 adds, 100 main
   deletes) against one over the single host, and its compaction (fold +
   re-shard); the front door with the artifact registered sharded, a
   stage whose shard 2 fails placement (registry untouched), then a stage
   and a promote.  After the count: a traced batch per 1x4 index and the
   empty list's share of ``ivf_score_lists`` on shard 0.
7. tiered and served — the IVF phase's 24x and 100x indexes saved as
   chunked v3 artifacts under build/tiered (gitignored, removed at the
   end) and loaded at hot-tier budgets 0, enc/8, enc/2, enc and "all"
   (enc: the encoded bytes); 4 batches of 256 queries searched at nprobe
   16 and 64, ids and score bits held equal to the resident index's fused
   search; per budget p50/p99, qps, fused launches a batch, host ms
   assembling blocks (store gets, packing), the store's counters and a
   traced batch (device ms).  Repeat reads come from the page cache.
   Small float and fp16 IVF indexes (32,768 docs) are held to the same
   bits tiered at budget 0, at nprobe 7 and past the probed pool.  Then a
   SegmentedIndex over the tiered 24x index at enc/4 (16,384 adds, 100
   main deletes) against the same operations on a resident main, both
   folded by ``compact(out_path=)`` (files byte-identical, tiered reload
   equal to resident), and a RetrievalService with the artifact
   registered at enc/4 and then promoted to "all" (answers equal direct
   search bit for bit; p50 at the front door; tier gauges).
8. off-path — on the main KB: the 12 Table-2 methods the port added
   (random projections, dimension drops, the six autoencoders, similarity
   and contrastive learning) at dim 128 with pre and post CenterNorm, each
   fitted on F = the first 65,536 docs with the 2,048 queries as the query
   sample (greedy dimension drop on all docs: its scorer indexes the KB's
   relevance) with a cuda generator seeded 0, every doc encoded into a
   float index and the queries searched exactly in batches of 256 at k=10
   (fit s, encode s, p50, R-precision and its share of float; the AEs'
   loss_history); the AE + int8 (24x) and Gaussian-256 + 1-bit (96x)
   recipes fitted on F, their kernel search held against the plain
   versions of int8_ip / binary_ip and the top-k, saved and loaded (ids
   and score bits equal), p50 and qps; each fitted transform applied on
   cuda and on the CPU to 4,096 docs from the same state (equal for the
   dimension drops, else within 1e-5·max).  Launch counts set to 0
   before and read after.
9. mutable — a second KB of 1M + 131,072 docs: the first 1M are the
   main, the rest arrive as 8 adds of 16,384.  ``seg_24x_post`` (the
   paper's pre+post-normalized 24x recipe, encoded by fused_quantize on
   the build and every add; 100 main and 100 delta deletes) and
   ``seg_ivf_24x`` (the IVF 24x recipe; 1,500 main deletes, so the main is
   probed 1,510 deep) are searched in batches of 256 on the main alone,
   after the adds and after the deletes (nprobe 16, 64, 256 for IVF),
   with the launch counts set to 0 before and read after.  Then each is
   held against an equivalent index over the surviving rows (a fresh
   build: ids and score bits equal; one IVF index with the same centroids:
   ids equal), through ``compact()`` and a v2 save/load; the fused encode
   against the staged plain encode on the card; R-precision's share of
   float; one batch per index traced.
10. models — the two-tower retriever of examples/train_retriever.py at
   its "100m" size (embed 256, towers 1024-512-256, 8 + 8 features, vocab
   150,000 each; its world of 64 clusters and 10,000 users with 1,000,000
   items, batches drawn on the card) trained 300 steps at batch 8,192
   with adamw (cosine 3e-3, warmup 20, weight decay 1e-4, clip 1.0):
   once uninterrupted, once with an async checkpoint every 100 steps and
   a SIGTERM at step 150 (PreemptionHandler: a blocking checkpoint,
   restored into a fresh state bit for bit, resumed to 300, the final
   state bit for bit the uninterrupted one's); ms a step, examples/s and
   the loss every 50 steps.  The frozen item tower embeds every item,
   and 2,048 users are searched at k=10 in batches of 256, exactly
   (float) and through [CenterNorm, PCA(128), CenterNorm, Int8Quantizer]
   (one fused_quantize encode, int8_ip + topk_blocks): cluster
   precision@10 of both and its share, recall@10 of the float top-10
   (held to a floor: the world saturates cluster precision), the
   compression ratio, p50, qps, encode s; the launch counts set to 0
   before and read after, then the kernel path held against the plain
   versions.  FULL configs: the
   two-tower's 15.4 GB of tables initialised on the card and its serving
   (512, 262,144) and candidate (1 × 1M, top-100) forwards; FM, DIN and
   DCN-v2 3 train steps at train_batch and their forwards at serve_p99,
   serve_bulk and retrieval_cand; SchNet 3 train steps at each GNN shape;
   a shape is skipped, and printed with the bytes, only where an exact
   lower bound on what its step holds at once exceeds the free memory
   (the two-tower's full-vocab training, ogb_products).  Then each model
   at its REDUCED config, cuda against the CPU from the same parameters:
   outputs at the bf16 bar, losses within 1e-3 relative except SchNet's
   graph task, whose loss takes the bar its per-node outputs' bars imply
   (a mean of 4 squared sums of bf16 node outputs), and each device's
   bf16 loss within 1e-2 relative of the f64 evaluation of the same
   function; that line also gives both losses with the segment sums in
   f32.
11. lm — the five LM architectures (phi4-mini, qwen1.5, qwen3-moe, dbrx,
   nemotron).  Each REDUCED config, one set of parameters, on the card
   against the CPU: a train step's loss and gradient leaves, the logits,
   and a prompt's prefill with 8 greedy decode steps (logits, and the
   greedy tokens wherever the CPU's top-2 margin clears the bar).  RoPE's
   cos and sin on both at positions 32,767 and 524,287.  Then every arch
   × LM shape at the config's published widths with random parameters:
   prefill_32k (a 32,768-token prompt, then 32 greedy steps), decode_32k
   (steps against a 32,768-slot cache, the largest batch that fits, up to
   128), long_500k (a 4,096-token prompt into a 524,288-slot cache, then
   8 greedy steps, run twice and held equal bit for bit) and train_4k (3
   adamw steps at 4,096 tokens a sequence in the config's microbatches).
   Each runs at the full depth and the largest batch whose exact lower
   bound of bytes fits the free memory, else at batch 1 with layers cut,
   else is skipped; the cut and the bound's parts are printed beside ms
   a step, tokens/s, prefill ms, decode ms a token and the peak.  The
   five kernels' launch counts do not rise: the LM path launches none.
12. launch — ``repro_torch.launch``: the paper's pre+post recipe
   [CenterNorm, PCA(128), CenterNorm, Int8Quantizer] fitted on the main
   KB, and ``fit_pca_distributed`` over 4 "data" shards of it against
   ``PCA.fit`` (each |cos| within 1e-3 of 1).  The search_exact (2.1M
   docs) and search_50m (49.7M) KBs drawn on the card from the main KB's
   population in 1M-row chunks, each encoded by fused_quantize (padded to
   a multiple of 512 rows; 6.4 GB of codes at 49.7M; the float KB is
   never whole), and 6,000 queries searched at k = 16 through the
   kb_search bundle with no mesh (naive and two_stage) and on the 16×16
   and 2×16×16 meshes of cuda:0: s a batch, q/s, the index's bytes, ids
   and score bits equal across the ways (naive skipped at 49.7M, its
   scores printed in GB); the same at 1-bit on search_exact; two_stage at
   131,072 docs on the kernels against the CPU's plain versions.  Every
   cell's REDUCED bundle once on cuda:0.  The compressed exchange of the
   "100m" retriever's parameter count of floats over a 1×8 "data" mesh
   (ms an exchange, bytes gathered against f32's 4n) and 20 steps of
   error feedback at repro's bars (int8 < 0.02, 1-bit < 0.35).  An
   elastic resume of a REDUCED two-tower run from data=8 onto
   ``plan_remesh``'s 4 devices (losses against the uninterrupted run).
   The dry run's 84 rows (every cell × both meshes: FLOPs, bytes, model
   FLOPs, arguments a position, fits, the three terms, the bottleneck at
   the card's rates), run in the background from the end of the
   kernel phase (earlier, it skewed the kernel phase's timings).  The
   int8_ip, topk_blocks, binary_ip and fused_quantize counts must rise.
13. examples — each ``examples_torch/*.py`` example's ``run`` in this
   process on cuda, its printed lines tagged: quickstart on the main KB
   (``--n-docs``, ``--n-queries``: 24×, and the R-Precision share of its
   kernel path within 0.01 of the same recipe scored by the port's plain
   torch scoring path, ``backend="torch"``, on the main KB itself) and
   at its defaults (R-Precision ≥ 0.85 of float at 24×, the example's
   claim);
   live_updates ``pca_int8`` at ``--n-docs`` and ``pca_onebit`` at its
   defaults (no deleted id served; 2 updates, 1 compaction);
   serve_compressed ``--no-post --ivf-nlist 1024 --shards 4`` at
   ``--n-docs`` (canary ≥ 0.5 and v2 promoted, the tiered act's
   open-loop trial with the tier read and ``lost`` printed, the sharded
   act bit-identical to the single host) and at its defaults;
   train_retriever ``--size small`` (compressed cluster precision@10 ≥
   0.9 of uncompressed), then ``--resume`` (step 300 restored, no step
   trained); knn_lm (both perplexities finite, kNN-LM below LM-only).
   The launch counts set to 0 before these runs and read after: all five
   kernels must rise (``launches_examples``).  Then each example at a
   tiny size on cuda and on the CPU, from equal weights: compression
   ratios, norms and counts equal; R-Precision, the canary overlap,
   precision@10 and the perplexities within ``EXAMPLE_CLOSE``'s bars; the
   sharded act bit-identical on both.
   Every run prints before a failed claim raises.
14. the last two lines: ``{"kernels": [...]}`` and the device line.

Any failure raises before the last line, and the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import (_build, launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.binary_ip.kernel import binary_ip  # noqa: E402
from repro_torch.kernels.binary_ip.ref import binary_ip_ref  # noqa: E402
from repro_torch.kernels.fused_quantize.kernel import (  # noqa: E402
    K_CHUNK, PASS_D_OUT, TILE_ROWS, fused_quantize)
from repro_torch.kernels.fused_quantize.ref import (  # noqa: E402
    fused_normalize_ref, fused_quantize_ref, fused_quantize_split_ref)
from repro_torch.kernels.int8_ip.kernel import int8_ip  # noqa: E402
from repro_torch.kernels.int8_ip.ref import int8_ip_ref  # noqa: E402
from repro_torch.kernels.ivf_fused.kernel import (  # noqa: E402
    MAX_K, candidates_per_pair, fused_ivf_topk)
from repro_torch.kernels.ivf_fused.ref import fused_ivf_topk_ref  # noqa: E402
from repro_torch.kernels.topk_blocks.kernel import (  # noqa: E402
    topk_blocks, topk_merge)
from repro_torch.kernels.topk_blocks.ops import (  # noqa: E402
    default_block_d, streaming_topk)
from repro_torch.kernels.topk_blocks.ref import topk_blocks_ref  # noqa: E402
from repro_torch.launch.roofline import card_rates  # noqa: E402
from repro_torch.retrieval.topk import topk_score_then_id  # noqa: E402

Q, D_MAIN, D_INT8, W_ONEBIT = 256, 1_000_000, 128, 8
BATCH, K = 256, 10
#: IVF at 1M docs: nlist ≈ √1M, the balanced cap's longest list, nprobe
NLIST, L_MAIN, NPROBE = 1024, 1221, 64
NPROBES_TIMED = (16, 64, 256)
#: the deepest probe timed, and the probe depth of the seg_ivf_24x main
#: after its 1,500 deletes (k + #dead)
NPROBE_DEEP, SEG_K = 256, 1_510
#: fused_ivf_topk above MAX_K: a segmented IVF main is probed k + #dead deep
LARGE_KS = (1025, 2048)
#: the probe depth's growth with #dead(main), int8 only: 16,384, and the
#: deepest probe of the seg_ivf_24x cell before needs_compaction() fires
#: (tombstones ≤ 25% of its 1,131,072 rows: #dead 282,768)
GROWTH_KS = (16_384, 10 + 282_768)
#: topk_blocks at #dead(main) = 1,000 (the exact main probed k + #dead)
TOPK_DEEP = 1_010
#: the mutable phase: live adds on top of the main
N_ADDS, ADD_ROWS = 8, 16_384
#: the tiered phase: probe widths and batches searched at every hot-tier
#: budget, and the segmented main over the tiered 24x index (one add, main
#: deletes, batches)
TIERED_NPROBES, TIERED_BATCHES = (16, 64), 4
#: the float and fp16 tiered check's docs
TIERED_SMALL_DOCS = 32_768
SEG_ADDS, SEG_DEAD, SEG_BATCHES = 16_384, 100, 2

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


#: int8_ip edges: (Q, D, d, row offset of the codes).  Partial tiles; d
#: zero-padded to 64 (48, 100, 77, 24); rows that take 4-byte (100), 8-byte
#: (24 at an odd row offset) and 1-byte (77) copies; 128 queries a CTA up to
#: d = 256, 64 at 384, 32 at 768 (the float-free int8 recipe) and 2048.
INT8_RAGGED = ((5, 37, 48, 0), (130, 1000, 100, 0), (1, 3, 128, 0),
               (33, 517, 77, 0), (300, 2000, 24, 1), (70, 999, 768, 0),
               (40, 300, 384, 0), (9, 129, 2048, 0), (257, 4099, 128, 3))


#: binary_ip edges: (Q, D, words, row offset of the words).  Partial tiles;
#: 1 / 3 / 9 words (4-byte copies, a part-filled 8-word stage); 2 words at
#: an odd offset (4-byte copies); 8 words at an odd offset (8-byte
#: copies); 130 words (two launches, the second adding to the first).
BINARY_RAGGED = ((7, 33, 2, 1), (65, 130, 3, 1), (1, 1, 1, 0), (9, 70, 9, 3),
                 (33, 517, 1, 5), (301, 1001, 8, 1), (3, 257, 130, 2))


def topk_ragged_cases(gen):
    """topk_blocks edges: (scores, k, block_d).  Partial blocks, k > block_d,
    −inf-heavy rows, ties (integers, one repeated value, a few ones), ±0.0
    ties, denormals, the block kernel at k ≤ 32 (block 4096), a block above
    32,768 (read from global memory), a sort above 8,192 (global scratch)
    and rows that do not start 16 bytes apart (D = 1001)."""
    dev = "cuda"
    ties = torch.arange(16, device=dev).flip(0).div(2, rounding_mode="floor")
    zeros = torch.zeros(4, 40, device=dev)
    zeros[:, ::3] = -0.0
    zeros[:, 5] = 1.0
    zeros[1, 7:] = float("-inf")
    sparse = torch.randn(10, 333, device=dev, generator=gen).masked_fill_(
        torch.rand(10, 333, device=dev, generator=gen) < 0.9, float("-inf"))
    return [
        (torch.randn(3, 50, device=dev, generator=gen), 10, 16),
        (torch.randn(4, 20, device=dev, generator=gen), 20, 8),
        (sparse, 7, 64), (ties.float().repeat(3, 1), 5, 4),
        (zeros, 6, 16), (zeros, 30, 32),
        ((torch.randint(-3, 4, (3, 3000), device=dev, generator=gen) * 0.25)
         .float(), 100, 1024),
        (torch.ones(3, 2500, device=dev), 10, 1024),
        ((torch.rand(4, 3000, device=dev, generator=gen) < 0.05).float(), 10,
         1024),
        (torch.randn(6, 1024, device=dev, generator=gen).mul(1e-42), 17, 1024),
        (torch.randn(5, 9000, device=dev, generator=gen), 25, 4096),
        (torch.randn(2, 1001, device=dev, generator=gen), 13, 333),
        (torch.randn(4, 100_000, device=dev, generator=gen), 50, 65_536),
        ((torch.randint(-40, 40, (3, 70_000), device=dev, generator=gen)
          * 0.25).float(), 300, 40_000),
        (torch.randn(3, 40_000, device=dev, generator=gen), 9000, 32_768)]


def check_ragged_shapes(gen) -> None:
    """Edges the main path's shapes miss: partial tiles, d not a multiple
    of the staging width, unaligned rows, k > block_d, −inf scores, ties,
    ±0.0 and blocks beyond shared memory."""
    dev = "cuda"
    for q, d, dim, off in INT8_RAGGED:
        qs = torch.randn(q, dim, device=dev, generator=gen).to(torch.bfloat16)
        u8 = torch.randint(0, 256, (d + off, dim), device=dev, generator=gen,
                           dtype=torch.uint8)[off:]
        bias = torch.randn(q, device=dev, generator=gen)
        for b in (None, bias):
            got, want = int8_ip(qs, u8, b), int8_ip_ref(qs, u8, b)
            err = float((got - want).abs().max())
            if err > 1e-5 * float(want.abs().max()):
                raise AssertionError(f"int8_ip disagrees at {(q, d, dim)} "
                                     f"offset {off}, bias {b is not None}: "
                                     f"{err:.3g}")
    for q, d, n_words, off in BINARY_RAGGED:
        signs = (torch.randint(0, 2, (q, 32 * n_words), device=dev,
                               generator=gen) * 2 - 1).to(torch.int8)
        words = torch.randint(-2**31, 2**31 - 1, (d + off, n_words),
                              device=dev, generator=gen,
                              dtype=torch.int32)[off:]
        if not torch.equal(binary_ip(signs, words).view(torch.int32),
                           binary_ip_ref(signs, words).view(torch.int32)):
            raise AssertionError(f"binary_ip disagrees at {(q, d, n_words)} "
                                 f"offset {off}")
    for scores, k, bd in topk_ragged_cases(gen):
        got, want = topk_blocks(scores, k, bd), topk_blocks_ref(scores, k, bd)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"topk_blocks disagrees at "
                                 f"{tuple(scores.shape)} k={k} block_d={bd}")
    torch.cuda.synchronize()
    print("[kernel] ragged shapes (int8_ip with and without bias; binary_ip "
          "at 1 / 2 / 3 / 8 / 9 / 130 words, odd Q, D and row offsets), k > "
          "block_d, -inf, ties, +-0.0, blocks above 32768: int8_ip within "
          "1e-5*max, binary_ip and topk_blocks bit for bit")


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
    bias = torch.randn(Q, device=dev, generator=gen)   # the path's q·zero
    err = 0.0
    for b in (None, bias):
        got, want = int8_ip(q_scaled, codes, b), int8_ip_ref(q_scaled, codes, b)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        print(f"[kernel] int8_ip (256, 1M, d=128), bias {b is not None}: "
              f"max_abs_err {e:.3g} (tol {tol:.3g}) "
              f"{'ok' if e <= tol else 'MISMATCH'}")
        if e > tol:
            raise AssertionError("int8_ip disagrees with int8_ip_ref")
        err = max(err, e)
        del got, want
    docs_bf16 = codes.to(torch.bfloat16)
    b_ms, b_by = bound(Q * D_INT8 * 2 + D_MAIN * D_INT8 + Q * 4
                       + Q * D_MAIN * 4, 2.0 * Q * D_MAIN * D_INT8,
                       bf16_rate, byte_rate)
    out.append({
        "name": "int8_ip", "route": "cuda",
        "source": "src/repro_torch/csrc/int8_ip.cu",
        "replaces": "src/repro/kernels/int8_ip/kernel.py:51",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: int8_ip(q_scaled, codes, bias), 20),
        "ms_no_bias": cuda_ms(lambda: int8_ip(q_scaled, codes), 20),
        "plain_ms": cuda_ms(lambda: int8_ip_ref(q_scaled, codes, bias), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        # the yardstick: one bf16 product that writes f32, as the kernel does
        "library_ms": cuda_ms(lambda: torch.mm(
            q_scaled, docs_bf16.T, out_dtype=torch.float32), 20),
        "library_call": "torch.mm(bf16, bf16, out_dtype=float32)",
        "shape": "Q=256 D=1000000 d=128, bias (Q,)"})
    del docs_bf16, codes

    # -- binary_ip: (Q, 256) ±1 signs × (1M, 8) words -----------------
    d_packed = 32 * W_ONEBIT
    signs = (torch.randint(0, 2, (Q, d_packed), device=dev, generator=gen)
             * 2 - 1).to(torch.int8)
    words = torch.randint(-2**31, 2**31 - 1, (D_MAIN, W_ONEBIT), device=dev,
                          generator=gen, dtype=torch.int32)
    got, want = binary_ip(signs, words), binary_ip_ref(signs, words)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    print(f"[kernel] binary_ip (256, 1M, 8 words) f32 0.25*dot: max_abs_err "
          f"{err:g}, {'bit for bit' if same else 'MISMATCH'}")
    if not same:
        raise AssertionError("binary_ip disagrees with binary_ip_ref")
    tie_scores = got.clone()                  # the 1-bit path's top-k input
    del want
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
        "plain_ms": cuda_ms(lambda: binary_ip_ref(signs, words), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.mm(signs_h, docs_pm.T), 20),
        "library_call": "torch.mm(fp16 +-1, fp16 +-1), fp16 output",
        "library_f32_out_ms": cuda_ms(lambda: torch.mm(
            signs_h, docs_pm.T, out_dtype=torch.float32), 20),
        # what writing the (Q, D) f32 output alone takes (fill_)
        "write_only_ms": cuda_ms(lambda: got.fill_(0.0), 20),
        "shape": "Q=256 D=1000000 words=8, f32 output"})
    del docs_pm, signs_h, words, got

    # -- topk_blocks: (Q, 1M) f32 at k = 10 (the main path), 100 and 1,010
    #    (an exact segmented main probed k + #dead(main) deep), random and
    #    tie-heavy scores: stage 1 bit for bit against its plain version,
    #    both stages against the full-row top-k, and their times
    normal = torch.randn(Q, D_MAIN, device=dev, generator=gen)
    entry = None
    for k in (K, 100, TOPK_DEEP):
        bd = default_block_d(k)
        plain_ms = None
        for label, scores in (("normal", normal), ("ties", tie_scores)):
            gv, gi = topk_blocks(scores, k, bd)
            if k < TOPK_DEEP or label == "normal":
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                wv, wi = topk_blocks_ref(scores, k, bd)
                end.record()
                torch.cuda.synchronize()
                if label == "normal":
                    plain_ms = start.elapsed_time(end)
                same = torch.equal(gv, wv) and torch.equal(gi, wi)
                print(f"[kernel] topk_blocks (256, 1M) k={k} block_d={bd} "
                      f"{label}: {'exact' if same else 'MISMATCH'}")
                if not same:
                    raise AssertionError(f"topk_blocks k={k} ({label}) "
                                         "disagrees with topk_blocks_ref")
                del wv, wi
            # two stages against lax.top_k's order on the full row
            fv, fi = streaming_topk(scores, k, use_kernel=True)
            rv, ri = streaming_topk(scores, k, use_kernel=False)
            if not (torch.equal(fv, rv) and torch.equal(fi, ri)):
                raise AssertionError(f"streaming_topk k={k} ({label}) "
                                     "disagrees with the full-row top-k")
            del gv, gi, fv, fi, rv, ri
        n_blocks = -(-D_MAIN // bd)
        b_ms, b_by = bound(Q * D_MAIN * 4 + Q * n_blocks * k * 8,
                           float(Q * D_MAIN), f32_rate, byte_rate)
        rec = {
            "name": "topk_blocks", "route": "cuda",
            "source": "src/repro_torch/csrc/topk_blocks.cu",
            "replaces": "src/repro/kernels/topk_blocks/kernel.py:75",
            "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: topk_blocks(normal, k, bd), 10),
            "ms_ties": cuda_ms(lambda: topk_blocks(tie_scores, k, bd), 10),
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.topk(normal, k), 10),
            "two_stage_ms": cuda_ms(
                lambda: streaming_topk(normal, k, use_kernel=True), 10),
            "shape": f"Q=256 D=1000000 k={k} block_d={bd}"}
        print(f"[kernel] topk_blocks k={k}: {json.dumps(rec)}")
        if entry is None:
            entry = rec
        else:
            entry[f"k{k}"] = {key: rec[key] for key in (
                "ms", "ms_ties", "plain_ms", "bound_ms", "library_ms",
                "two_stage_ms", "shape")}
    out.append(entry)
    del normal, tie_scores
    check_topk_cells_shape(rates, gen)
    for rec in out[:2]:
        print(f"[kernel] {rec['name']}: {json.dumps(rec)}")
    torch.cuda.empty_cache()
    return out


#: stage 1 at the exact cells' shape: 1,024 queries over 2.1M documents
#: at k = 100, 513 blocks of 4,096 (the last 2,848 columns)
CELLS_Q, CELLS_D, CELLS_K = 1024, 2_100_000, 100


def check_topk_cells_shape(rates, gen) -> None:
    """Stage 1 at the exact cells' shape on Gaussian and few-valued (0.25
    × an integer in [−60, 60], as ``dpr100x.bulk``'s) scores: the first 64
    rows of the full call bit for bit equal to ``topk_blocks_ref`` on that
    slice, and the full call's time beside its bound (the scores read
    once, the candidates written once)."""
    byte_rate, _, _, f32_rate = rates
    bd = default_block_d(CELLS_K)
    n_blocks = -(-CELLS_D // bd)
    b_ms, b_by = bound(CELLS_Q * CELLS_D * 4 + CELLS_Q * n_blocks * CELLS_K
                       * 8, float(CELLS_Q * CELLS_D), f32_rate, byte_rate)
    rec = {"shape": f"Q={CELLS_Q} D={CELLS_D} k={CELLS_K} block_d={bd}",
           "bound_ms": b_ms, "bound_by": b_by}
    for label in ("gaussian", "few"):
        if label == "gaussian":
            scores = torch.randn(CELLS_Q, CELLS_D, device="cuda",
                                 generator=gen)
        else:
            scores = torch.randint(-60, 61, (CELLS_Q, CELLS_D), device="cuda",
                                   generator=gen, dtype=torch.int8
                                   ).float().mul_(0.25)
        gv, gi = topk_blocks(scores, CELLS_K, bd)
        wv, wi = topk_blocks_ref(scores[:64], CELLS_K, bd)
        same = (torch.equal(gv[:64].view(torch.int32), wv.view(torch.int32))
                and torch.equal(gi[:64], wi))
        print(f"[kernel] topk_blocks cells' shape {label}: first 64 rows "
              f"{'exact' if same else 'MISMATCH'}")
        if not same:
            raise AssertionError(f"topk_blocks at the cells' shape ({label}) "
                                 "disagrees with topk_blocks_ref")
        del gv, gi, wv, wi
        rec[f"ms_{label}"] = cuda_ms(
            lambda: topk_blocks(scores, CELLS_K, bd), 10)
        rec[f"roofline_{label}"] = 100.0 * b_ms / rec[f"ms_{label}"]
        del scores
        torch.cuda.empty_cache()
    print(f"[kernel] topk_blocks cells' shape: {json.dumps(rec)}")


#: stage 2 at the dpr24x.bulk cell's shape (1,024 queries over 2.1M docs
#: at k = 100: 513 lists of 100), then at the kernel phase's (256, 1M)
MERGE_SHAPES = ((1024, 2_100_000, 100), (Q, D_MAIN, K), (Q, D_MAIN, 100),
                (Q, D_MAIN, TOPK_DEEP))
MERGE_LABELS = ("normal", "ties", "few", "zeros", "sparse")


def merge_scores(label: str, q: int, d: int, k: int, gen) -> torch.Tensor:
    """(q, d) scores for topk_merge's check.  ``ties``: 0.5·round(16·x),
    ~160 values, ties as sign-dot scores tie; ``few``: 7 values, so the
    runs at τ₀ overflow the buffer (the exact path); ``zeros``: ±0.0 with
    ~k/2 ones and 10% −inf, so ±0.0 ties decide the k-th slot; ``sparse``:
    ~k/2 finite entries a row, the rest −inf (−inf pads in the output)."""
    dev = "cuda"
    if label in ("normal", "ties"):
        s = torch.randn(q, d, device=dev, generator=gen)
        return s.mul_(16).round_().mul_(0.5) if label == "ties" else s
    if label == "few":
        return torch.randint(-3, 4, (q, d), device=dev,
                             generator=gen).float().mul_(0.25)
    u = torch.rand(q, d, device=dev, generator=gen)
    if label == "zeros":
        s = torch.where(u < 0.5, -0.0, 0.0)
        s.masked_fill_(u > 0.9, float("-inf"))
        return s.masked_fill_(u < 0.5 * k / d, 1.0)
    s = torch.randn(q, d, device=dev, generator=gen)
    return s.masked_fill_(u >= 0.5 * k / d, float("-inf"))


def phase_topk_merge(rates, smi: str) -> dict:
    """Stage 2 of the exact top-k, ``topk_merge``, against the sort path
    (``topk_score_then_id``) on the same ``topk_blocks`` candidates: ids
    and value bits equal at every shape and label of ``merge_scores`` and
    on the ragged stage-1 cases (k > block_d, −inf rows, ties, ±0.0, a
    buffer in global scratch at k = 9,000).  Times both with CUDA events
    beside the bound: every candidate read once, the output written
    once."""
    byte_rate, _, _, f32_rate = rates
    gen = torch.Generator(device="cuda").manual_seed(27)
    before = tracing.counters().get("topk_merge.launches", 0)

    def check(cv, ci, k, what):
        gv, gi = topk_merge(cv, ci, k)
        wv, wi = topk_score_then_id(cv, ci, k)
        if not (torch.equal(gv.view(torch.int32), wv.view(torch.int32))
                and torch.equal(gi, wi.long())):
            raise AssertionError(f"topk_merge disagrees with the sort path "
                                 f"at {what}")
        return gv, gi

    for scores, k, bd in topk_ragged_cases(gen):
        kk = min(k, scores.shape[1])
        cv, ci = topk_blocks(scores, kk, bd)
        check(cv, ci, kk, f"{tuple(scores.shape)} k={kk} block_d={bd}")
    rec = None
    for q, d, k in MERGE_SHAPES:
        bd = default_block_d(k)
        n_lists = -(-d // bd)
        b_ms, b_by = bound(q * n_lists * k * 8 + q * k * 12, 0.0, f32_rate,
                           byte_rate)
        row = {"shape": f"Q={q} D={d} k={k} block_d={bd} lists={n_lists}",
               "bound_ms": b_ms, "bound_by": b_by}
        for label in MERGE_LABELS:
            scores = merge_scores(label, q, d, k, gen)
            cv, ci = topk_blocks(scores, k, bd)
            gv, gi = check(cv, ci, k, f"({q}, {d}) k={k} {label}")
            if label == "normal":
                # the two-stage op: one launch of each stage, the same bits
                c0 = tracing.counters()
                sv, si = streaming_topk(scores, k, use_kernel=True)
                c1 = tracing.counters()
                row["two_stage_launches"] = {n: c1.get(n, 0) - c0.get(n, 0)
                                             for n in ("topk_blocks.launches",
                                                       "topk_merge.launches")}
                if set(row["two_stage_launches"].values()) != {1} or not (
                        torch.equal(sv.view(torch.int32),
                                    gv.view(torch.int32))
                        and torch.equal(si, gi)):
                    raise AssertionError(f"streaming_topk at ({q}, {d}) "
                                         f"k={k}: {row}")
                del sv, si
            del scores, gv, gi
            key = "ms" if label == "normal" else f"ms_{label}"
            row[key] = cuda_ms(lambda: topk_merge(cv, ci, k), 20)
            if label == "normal":
                row["library_ms"] = cuda_ms(
                    lambda: topk_score_then_id(cv, ci, k), 5)
            del cv, ci
            torch.cuda.empty_cache()
        print(f"[kernel] topk_merge ({q}, {d}) k={k}: ids and value bits "
              f"equal to the sort path on {', '.join(MERGE_LABELS)}; "
              f"{row['ms']:.4f} ms (sorts {row['library_ms']:.4f}, bound "
              f"{b_ms:.4f})")
        if rec is None:
            rec = {"name": "topk_merge", "route": "cuda",
                   "source": "src/repro_torch/csrc/topk_blocks.cu",
                   "replaces": "src/repro/kernels/topk_blocks/ops.py:23",
                   "library_call": "topk_score_then_id (two stable "
                                   "segmented sorts and four gathers)",
                   **row}
        else:
            rec[f"k{k}" if q == Q else f"q{q}"] = row
    torch.cuda.synchronize()
    rec["launches"] = tracing.counters().get("topk_merge.launches", 0) \
        - before
    rec["card"] = smi
    print(f"[kernel] topk_merge {json.dumps(rec)}")
    return rec


def ranking_agrees(got, want, exact: bool, cut=None) -> tuple[bool, float]:
    """Do two (Q, k) rankings agree?  ``exact``: ids and value bits equal.
    Otherwise values within 1e-5·max|want| (f32 summation order), and ids
    equal at every rank whose neighbouring wanted values lie further apart
    than that, and wherever the wanted value is −inf.  ``cut`` (Q,), the
    wanted (k+1)-th value, is the last rank's neighbour beyond the top-k:
    a near-tie across the cut may keep either row in the last slot."""
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
    if cut is not None:
        gap[:, -1] = torch.minimum(
            gap[:, -1], (wv[:, -1] - cut).abs().nan_to_num(nan=float("inf")))
    apart = fin & (gap > tol)
    bad = apart & (gi != wi)
    if bool(bad.any()):
        rows, cols = torch.nonzero(bad, as_tuple=True)
        print(f"[check] {int(bad.sum())} ranks differ where apart (tol "
              f"{tol:.3g}); first: " + "; ".join(
                  f"q{int(r)} rank {int(c)} got ({float(gv[r, c]):.6g}, "
                  f"{int(gi[r, c])}) want ({float(wv[r, c]):.6g}, "
                  f"{int(wi[r, c])}) gap {float(gap[r, c]):.3g}"
                  for r, c in zip(rows[:4], cols[:4])))
    ok = (err <= tol and not bool(bad.any())
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
        (3, 16, 50, 2, MAX_K, 64), (5, 16, 300, 8, MAX_K + 76, 96),
        (4, 8, 5000, 3, 10, 160),
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
          f"k = {MAX_K} and {MAX_K + 76}, L > tile, L = 1, odd widths: all "
          "agree")


def check_ivf_large_k(gen) -> dict:
    """fused_ivf_topk above MAX_K (running top-k in a global scratch) at
    the main path's shapes, all four backends against the plain version;
    returns the int8 times."""
    out = {}
    for k in LARGE_KS:
        for backend in ("float", "fp16", "int8", "onebit"):
            dim = 32 * W_ONEBIT if backend == "onebit" else D_INT8
            args = ivf_case(gen, backend, Q, NLIST, L_MAIN, NPROBE, dim)
            got = fused_ivf_topk(*args, k, backend)
            wv, wi = fused_ivf_topk_ref(*args, k=k + 1, backend=backend)
            want = (wv[:, :k], wi[:, :k])
            torch.cuda.synchronize()
            ok, err = ranking_agrees(got, want, exact=backend == "onebit",
                                     cut=wv[:, k])
            print(f"[kernel] fused_ivf_topk[{backend}] k={k} (Q={Q}, nlist="
                  f"{NLIST}, L={L_MAIN}, nprobe={NPROBE}): max_abs_err "
                  f"{err:.3g} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"fused_ivf_topk[{backend}] k={k} "
                                     "disagrees with fused_ivf_topk_ref")
            if backend == "int8":
                out[f"k{k}_ms"] = cuda_ms(
                    lambda: fused_ivf_topk(*args, k, backend), 3)
                out[f"k{k}_plain_ms"] = cuda_ms(
                    lambda: fused_ivf_topk_ref(*args, k=k, backend=backend),
                    1)
                print(f"[kernel] fused_ivf_topk[int8] k={k}: "
                      f"{out[f'k{k}_ms']:.3f} ms, plain "
                      f"{out[f'k{k}_plain_ms']:.3f} ms")
            del got, want, args
    # how the cost grows with the probe depth: int8 at the main's shapes
    args = ivf_case(gen, "int8", Q, NLIST, L_MAIN, NPROBE, D_INT8)
    for k in GROWTH_KS:
        wv, wi = fused_ivf_topk_ref(*args, k=k + 1, backend="int8")
        ok, err = ranking_agrees(fused_ivf_topk(*args, k, "int8"),
                                 (wv[:, :k], wi[:, :k]), exact=False,
                                 cut=wv[:, k])
        if not ok:
            raise AssertionError(f"fused_ivf_topk[int8] k={k} disagrees with "
                                 "fused_ivf_topk_ref")
        del wv, wi
        out[f"k{k}_ms"] = cuda_ms(lambda: fused_ivf_topk(*args, k, "int8"), 2)
        out[f"k{k}_plain_ms"] = cuda_ms(
            lambda: fused_ivf_topk_ref(*args, k=k, backend="int8"), 1)
        print(f"[kernel] fused_ivf_topk[int8] k={k}: max_abs_err {err:.3g} "
              f"ok; {out[f'k{k}_ms']:.3f} ms, plain "
              f"{out[f'k{k}_plain_ms']:.3f} ms")
    del args
    torch.cuda.empty_cache()
    return out


def ivf_sub_kernels(fn) -> dict[str, float]:
    """Device ms of each of fused_ivf_topk's sub-kernels in one traced
    call (torch.profiler): invert (count, scan, scatter), score the
    lists, merge the candidates."""
    import re
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        found = re.search(r"ivf_\w+", evt.key)
        if found and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[found.group(0)] = getattr(
                evt, "self_device_time_total",
                getattr(evt, "self_cuda_time_total", 0)) / 1e3
    return out


def phase_ivf_kernel(rates) -> dict:
    """fused_ivf_topk at the main and mutable paths' shapes, all four
    backends: nprobe 64 and 256, k = 10 and SEG_K (the segmented IVF
    main probed past its tombstones)."""
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
                    f"k={K}; int8 d={D_INT8}, 1-bit {W_ONEBIT} words; "
                    f"also nprobe 256 and k={SEG_K}"}
    for backend in ("float", "fp16", "int8", "onebit"):
        dim = 32 * W_ONEBIT if backend == "onebit" else D_INT8
        for nprobe in (NPROBE, NPROBE_DEEP):
            args = ivf_case(gen, backend, Q, NLIST, L_MAIN, nprobe, dim)
            probes, qe, store, ids, base = args
            for k in (K, SEG_K):
                got = fused_ivf_topk(*args, k, backend)
                if k == K:
                    want = fused_ivf_topk_ref(*args, k=k, backend=backend)
                    cut = None
                else:  # a near-tie across the cut may keep either row
                    wv, wi = fused_ivf_topk_ref(*args, k=k + 1,
                                                backend=backend)
                    want, cut = (wv[:, :k], wi[:, :k]), wv[:, k]
                torch.cuda.synchronize()
                ok, err = ranking_agrees(got, want, exact=backend == "onebit",
                                         cut=cut)
                print(f"[kernel] fused_ivf_topk[{backend}] (Q={Q}, nlist="
                      f"{NLIST}, L={L_MAIN}, nprobe={nprobe}, k={k}): "
                      f"max_abs_err {err:.3g} {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(
                        f"fused_ivf_topk[{backend}] nprobe={nprobe} k={k} "
                        "disagrees with fused_ivf_topk_ref")
                del got, want, cut
                if backend not in ("int8", "onebit"):
                    continue
                if (nprobe, k) == (NPROBE, K):
                    pre = "" if backend == "int8" else "onebit_"
                    rec[f"{pre}max_abs_err"] = err
                rec.update(time_ivf(args, backend, dim, nprobe, k, rates))
            del args, probes, qe, store, ids, base
    torch.cuda.empty_cache()
    rec.update(check_ivf_large_k(gen))
    print(f"[kernel] fused_ivf_topk: {json.dumps(rec)}")
    return rec


def time_ivf(args, backend: str, dim: int, nprobe: int, k: int,
             rates) -> dict:
    """Times of one fused_ivf_topk shape beside its bound, the bytes its
    stages move and its sub-kernels' device ms; the main shape (nprobe
    64, k = 10) under the record's plain keys."""
    byte_rate, bf16_rate, int8_rate, f32_rate = rates
    probes, qe, store, ids, base = args
    # bound: each distinct probed list's rows and ids once, queries,
    # probes, base and outputs; the valid (query, row) pairs' products
    counts = torch.bincount(probes.reshape(-1).long(), minlength=NLIST)
    n_lists = int((counts > 0).sum())
    row_bytes = store.shape[-1] * store.element_size()
    n_bytes = (n_lists * L_MAIN * (row_bytes + 4)
               + qe.numel() * qe.element_size() + probes.numel() * 8
               + Q * k * 8)
    pairs = int((ids[probes.long()] >= 0).sum())
    n_ops = 2.0 * pairs * dim
    b_ms, b_by = bound(n_bytes, n_ops,
                       bf16_rate if backend == "int8" else int8_rate,
                       byte_rate)
    # what the stages move: each group of 32 (query, slot) pairs reads its
    # list once; the (Q, nprobe, m) candidates are written and read once
    m = candidates_per_pair(k, L_MAIN)
    list_reads = int(((counts + 31) // 32).sum()) * L_MAIN * (row_bytes + 4)
    cand_bytes = 2 * Q * nprobe * m * 8
    ms = cuda_ms(lambda: fused_ivf_topk(*args, k, backend), 10)
    plain_ms = cuda_ms(
        lambda: fused_ivf_topk_ref(*args, k=k, backend=backend), 1)
    subs = ivf_sub_kernels(lambda: fused_ivf_topk(*args, k, backend))
    print(f"[kernel] fused_ivf_topk[{backend}] nprobe {nprobe} k {k}: "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {n_bytes / 1e9:.4f} GB, {n_ops / 1e9:.3f} GOP); "
          f"reads {list_reads / 1e9:.4f} GB of lists ({n_lists} distinct), "
          f"candidates {cand_bytes / 1e9:.4f} GB written+read")
    print(f"[profile] fused_ivf_topk[{backend}] nprobe {nprobe} k {k}: "
          + "; ".join(f"{name} {t:.4f} ms" for name, t in subs.items()))
    pre = "" if backend == "int8" else "onebit_"
    if (nprobe, k) != (NPROBE, K):
        pre += f"nprobe{nprobe}_k{k}_"
    return {f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
            f"{pre}bound_ms": b_ms, f"{pre}bound_by": b_by,
            f"{pre}sub_kernels_ms": subs}


def quantize_case(gen, n: int, d: int, d_out: int, n_fit: int = 65536):
    """(N, d) f32 rows off the origin and the fused parameters of a
    [CenterNorm, PCA, CenterNorm, Int8Quantizer] pipeline fitted on the
    first ``n_fit`` of them, on the card."""
    from repro_torch.core import (CenterNorm, CompressionPipeline,
                                  Int8Quantizer, PCA)
    from repro_torch.kernels.fused_quantize.ops import params_from_pipeline

    x = torch.randn(n, d, device="cuda", generator=gen)
    x += 3.0 * torch.randn(d, device="cuda", generator=gen)
    pipe = CompressionPipeline([CenterNorm(), PCA(d_out), CenterNorm(),
                                Int8Quantizer()])
    pipe.fit(x[:n_fit])
    return x, params_from_pipeline(pipe)


def codes_agree(got, want) -> tuple[bool, int, float]:
    """The kernel's bar (repro's tests/test_kernels.py): codes differ by at
    most 1, on fewer than 1% of the elements."""
    diff = (got.int() - want.int()).abs()
    worst = int(diff.max()) if diff.numel() else 0
    share = float((diff > 0).float().mean()) if diff.numel() else 0.0
    return worst <= 1 and share < 0.01, worst, share


def _unaligned(x):
    """``x`` copied to a view whose rows start 4 bytes past a 16-byte
    boundary (the kernel's 4-byte copies)."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def check_floor_scale(gen) -> None:
    """A column whose fitted range is under 1e-12 takes Int8Quantizer's
    floor scale, 1e-12/255: its code is 0 or 255 by the sign of w − zero,
    so where the plain version's w lies on zero (the row that set it) a
    last-bit difference in w moves the code by 255.  The rule for that
    column: codes differ only where the plain version's |w − zero| ≤
    2^-16.  The other columns keep the bar; rows stay batch-independent."""
    col, n, d, d_out = 5, 70000, 96, 40
    x, params = quantize_case(gen, n, d, d_out)
    scale = params[3].clone()
    scale[col] = 1e-12 / 255
    params = (*params[:3], scale, params[4])
    got, want = fused_quantize(x, *params), fused_quantize_ref(x, *params)
    keep = [c for c in range(d_out) if c != col]
    ok, worst, share = codes_agree(got[:, keep], want[:, keep])
    gap = (fused_normalize_ref(x, *params[:3])[:, col] - params[4][col]).abs()
    edge = gap <= 2.0 ** -16
    moved = got[:, col] != want[:, col]
    sub = torch.randperm(n, device="cuda", generator=gen)[:131]
    same = torch.equal(fused_quantize(x[sub], *params), got[sub])
    print(f"[kernel] fused_quantize ({n}, {d}) -> {d_out}, column {col} at "
          f"the floor scale: {int(moved.sum())} of its codes differ, all at "
          f"rows with |w - zero| <= 2^-16 ({int(edge.sum())} such rows): "
          f"{'yes' if not bool((moved & ~edge).any()) else 'NO'}; other "
          f"columns max diff {worst}, share {share:.3g}; a permuted 131-row "
          f"subset {'bit-identical' if same else 'DIFFERS'}")
    if not ok or bool((moved & ~edge).any()) or not same:
        raise AssertionError("fused_quantize breaks the floor-scale rule")


def phase_quantize_kernel(rates) -> dict:
    """fused_quantize at the build's shapes, (1M, 768) → 128, against the
    four staged passes, plus ragged shapes and row independence."""
    byte_rate, bf16_rate, int8_rate, f32_rate = rates
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, d, d_out = D_MAIN, 768, D_INT8
    x, params = quantize_case(gen, n, d, d_out)
    got = fused_quantize(x, *params)
    want = fused_quantize_ref(x, *params)
    torch.cuda.synchronize()
    ok, worst, share = codes_agree(got, want)
    print(f"[kernel] fused_quantize ({n}, {d}) -> {d_out}: max code diff "
          f"{worst}, share differing {share:.3g} (bar <= 1 on < 1%) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("fused_quantize disagrees with its plain version")
    # information, not a bar: the plain mirror of the kernel's own numerics
    # (three bf16 products) differs from it only by the order of f32 sums
    _, worst_s, share_s = codes_agree(got, fused_quantize_split_ref(x,
                                                                    *params))
    print(f"[kernel] fused_quantize vs fused_quantize_split_ref (the split "
          f"product in plain torch): max code diff {worst_s}, share "
          f"differing {share_s:.3g}")
    # a row's codes depend on that row alone: a permuted odd-sized subset
    # and a single row encode to the full encode's rows, bit for bit
    perm = torch.randperm(n, device="cuda", generator=gen)[:65537]
    one = fused_quantize(x[777:778], *params)
    same = torch.equal(fused_quantize(x[perm], *params), got[perm]) and \
        torch.equal(one, got[777:778])
    print(f"[kernel] fused_quantize row independence (permuted 65537-row "
          f"subset, one row): {'bit-identical' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("fused_quantize codes depend on the batch")
    cases = [(one, fused_quantize_ref(x[777:778], *params), (1, d, d_out))]
    # above 128 outputs the kernel takes several passes through a scratch;
    # d % 4 != 0 and rows off 16-byte boundaries take 4-byte copies; a
    # scale above the epilogue's fast division's range takes its `/` path
    wide = ((257, 96, 32), (1000, 64, 16), (600, 288, 256), (600, 768, 384),
            (1000, 320, 300), (333, 77, 24), (1001, 768, 128), (500, 96, 40))
    for shape in wide:
        xr, pr = quantize_case(gen, *shape, n_fit=shape[0])
        if shape == (1001, 768, 128):
            xr = _unaligned(xr)
        if shape == (500, 96, 40):
            pr = (*pr[:3], pr[3].clone().index_fill_(0, torch.tensor(
                [5], device="cuda"), 1e30), pr[4])
        full = fused_quantize(xr, *pr)
        cases.append((full, fused_quantize_ref(xr, *pr), shape))
        sub = torch.randperm(shape[0], device="cuda", generator=gen)[:131]
        if not torch.equal(fused_quantize(xr[sub], *pr), full[sub]):
            raise AssertionError(f"fused_quantize codes depend on the batch "
                                 f"at {shape}")
    for got_r, want_r, shape in cases:
        ok_r, worst_r, share_r = codes_agree(got_r, want_r)
        if not ok_r:
            raise AssertionError(f"fused_quantize disagrees at {shape}: max "
                                 f"{worst_r}, share {share_r:.3g}")
    print("[kernel] fused_quantize ragged (1, 768)->128, " + ", ".join(
        f"({n_}, {d_})->{o_}" for n_, d_, o_ in wide) + " ((1001, 768) with "
        "its rows 4 bytes off 16-byte boundaries, (500, 96) with a scale of "
        "1e30): within the bar, a permuted 131-row subset of each "
        "bit-identical")
    check_floor_scale(gen)
    mu1, w = params[0], params[1]
    n_bytes = n * d * 4 + n * d_out + (d * d_out + d + 3 * d_out) * 4
    # three bf16 products on the tensor cores; one f32 product on the CUDA
    # cores was the earlier kernel's bound
    b_ms, b_by = bound(n_bytes, 3 * 2.0 * n * d * d_out, bf16_rate,
                       byte_rate)
    b32_ms, b32_by = bound(n_bytes, 2.0 * n * d * d_out, f32_rate, byte_rate)
    rec = {
        "name": "fused_quantize", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_quantize.cu",
        "replaces": "src/repro/kernels/fused_quantize/kernel.py:58",
        "max_abs_err": float(worst), "share_differing": share,
        "share_differing_split_ref": share_s,
        "ms": cuda_ms(lambda: fused_quantize(x, *params), 10),
        "plain_ms": cuda_ms(lambda: fused_quantize_ref(x, *params), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.mm(x, w), 10),
        "library_note": "torch.mm (N, 768) x (768, 128) f32, tf32 off: the "
                        "product alone",
        "shape": f"N={n} d={d} d_out={d_out}"}
    x16 = x[:ADD_ROWS].clone()
    rec["add_rows_ms"] = cuda_ms(lambda: fused_quantize(x16, *params), 20)
    # modelled, not measured: every tile reads Wᵀ hi and lo once a pass
    w_l2 = -(-n // TILE_ROWS) * 4 * (-(-d // K_CHUNK) * K_CHUNK) * (
        -(-d_out // PASS_D_OUT) * PASS_D_OUT)
    print(f"[kernel] fused_quantize: {rec['ms']:.4f} ms, "
          f"{n_bytes / 1e6 / rec['ms']:.1f} GB/s, {b_ms / rec['ms']:.3f} of "
          f"its bound ({b_ms:.4f} ms, {b_by}; one f32 product on the CUDA "
          f"cores {b32_ms:.4f} ms, {b32_by}); W's L2 reads by the tile count "
          f"(modelled) {w_l2 / 1e9:.3f} GB against {n * d * 4 / 1e9:.3f} GB "
          f"of x; {ADD_ROWS} rows (an add) {rec['add_rows_ms']:.4f} ms")
    del x, x16, got, want, perm, mu1, w, params
    torch.cuda.empty_cache()
    print(f"[kernel] fused_quantize: {json.dumps(rec)}")
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


def profile_call(tag: str, fn) -> None:
    """Device time by kernel for one call of ``fn`` (torch.profiler) and
    the device's busy share of the call's wall time.  A warm-up call
    inside the profiler comes first: without it the trace lost the first
    kernels of short batches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
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
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms (profiled), device "
          f"{busy:.3f} ms, busy share {busy / wall_ms:.3f}; {top}")


def profile_batches(indexes, queries, **kw) -> None:
    """:func:`profile_call` on one search batch per index."""
    for name, index in indexes.items():
        profile_call(f"{name}: batch {BATCH}",
                     lambda: index.search(queries[:BATCH], K, **kw))


def start_kbs(args, pool):
    """Make both KBs on the host in worker threads (numpy releases the GIL
    in its draws and products) while the kernel phase runs on the card:
    the main path's ``--n-docs`` KB and the mutable phase's, with
    ``N_ADDS · ADD_ROWS`` more docs.  Returns their futures."""
    from repro_torch.data import make_dpr_like_kb

    t0 = time.perf_counter()

    def make(n_docs):
        kb = make_dpr_like_kb(n_queries=args.n_queries, n_docs=n_docs, d=768,
                              seed=args.seed, device="cpu")
        return kb, time.perf_counter() - t0

    return (pool.submit(make, args.n_docs),
            pool.submit(make, args.n_docs + N_ADDS * ADD_ROWS))


def kb_on_card(future, tag: str, args):
    """Wait for a KB made by :func:`start_kbs` and move it to the card."""
    from repro_torch.data.synthetic import KBData

    t0 = time.perf_counter()
    kb, made_s = future.result()
    kb = KBData(docs=kb.docs.cuda(), queries=kb.queries.cuda(),
                relevant=kb.relevant.cuda(), meta=kb.meta)
    torch.cuda.synchronize()
    print(f"[{tag}] KB {tuple(kb.docs.shape)} f32 docs, "
          f"{tuple(kb.queries.shape)} queries, seed {args.seed}: made on the "
          f"host in {made_s:.1f} s beside the earlier phases, waited "
          f"{time.perf_counter() - t0:.1f} s with the copy to the card")
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


def _update_by_index_add(x, labels, n_clusters, old):
    """k-means' update as the port had it before its IVF build repeated on
    the card: an f32 ``index_add_``, whose adds are atomic there."""
    sums = torch.zeros((n_clusters, x.shape[1]), device=x.device
                       ).index_add_(0, labels, x)
    counts = torch.zeros((n_clusters,), device=x.device).index_add_(
        0, labels, torch.ones_like(x[:, 0]))
    new = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, new, old)


def check_ivf_build_repeats(name, spec, kb, built, q0, search_kw) -> None:
    """Build the IVF index a second time from the same seed and hold the
    two to equal bits: centroids, list assignment, lists, stored codes,
    every fitted stage's state (the rotation included) and one searched
    batch.  Then k-means' update on the build's own routing rows, labels
    and centroids, three times each way: the atomic ``index_add_`` form
    (the port's before) against the fixed-order segment sum."""
    from repro_torch.retrieval import build_index
    from repro_torch.retrieval.kmeans import _update
    from repro_torch.retrieval.scorers import apply_float_stages

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    again = build_index(spec, kb.docs, kb.queries, device="cuda")
    pairs = [("centroids", built.centroids, again.centroids),
             ("labels", torch.from_numpy(built._labels),
              torch.from_numpy(again._labels)),
             ("lists", built.lists, again.lists),
             ("codes", built.storage, again.storage)]
    for ta, tb in zip(built.pipeline.transforms, again.pipeline.transforms):
        for key, val in (ta.state or {}).items():
            if isinstance(val, torch.Tensor):
                pairs.append((f"{type(ta).__name__}.{key}", val,
                              tb.state[key]))
    va, ia = built.search(q0, K, nprobe=NPROBE, **search_kw)
    vb, ib = again.search(q0, K, nprobe=NPROBE, **search_kw)
    pairs += [("searched ids", ia, ib), ("searched scores", va, vb)]
    differ = [tag for tag, a, b in pairs if not torch.equal(bits(a), bits(b))]
    x = apply_float_stages(built.float_stages, kb.docs, "docs").float()
    labels = torch.from_numpy(built._labels).to(x.device).long()
    runs = {form: [fn(x, labels, built.nlist, built.centroids)
                   for _ in range(3)]
            for form, fn in (("index_add_", _update_by_index_add),
                             ("segment", _update))}
    moved = {form: sum(not torch.equal(bits(r), bits(rs[0])) for r in rs[1:])
             for form, rs in runs.items()}
    print(f"[ivf] {name}: a second build from the same seed: "
          f"{', '.join(tag for tag, _, _ in pairs)} "
          f"{'equal bit for bit' if not differ else 'DIFFER: ' + str(differ)}"
          f"; k-means' update over its {x.shape[0]} routing rows, 3 runs "
          f"each: index_add_ (atomic) differs from its first run in "
          f"{moved['index_add_']} of 2, the fixed-order segment sum in "
          f"{moved['segment']} of 2")
    if differ or moved["segment"]:
        raise AssertionError(f"{name}: the IVF build does not repeat on the "
                             "card")
    del again, x, runs


def phase_ivf(args, kb, exact, rp_float):
    """IVF search at the paper's two widths; returns the launch counts of
    the timed run and the loaded indexes."""
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
            check_ivf_build_repeats(name, spec, kb, built, q0, search_kw)
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
    return counts, indexes


#: the sharded phase: meshes on the one card (doc shards × replicas), the
#: IVF probe widths searched there, and the post-recipe sharded build's docs
SHARD_MESHES = (("1x4", dict(shards=4)), ("2x2", dict(shards=2, replicas=2)))
SHARD_NPROBES = (16, 64)
SHARD_POST_DOCS = 65_536


def score_lists_ms(fn, reps: int = 10) -> float:
    """Mean device ms of one ``ivf_score_lists`` launch over ``reps``
    traced calls of ``fn`` (the trace may drop a short call's first
    kernels, so the mean is over the launches it kept)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if "ivf_score_lists" in evt.key and evt.count and \
                evt.device_type == torch.autograd.DeviceType.CUDA:
            return getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0)) \
                / evt.count / 1e3
    return float("nan")


def ivf_empty_list_share(sharded, queries, nprobe: int) -> dict:
    """Shard 0 of a 1x4 sharded IVF index, one 256-query batch, three
    probe tables: every slot (an unowned probe points at the shard's empty
    list, whose L rows are scored like any list's), the owned slots only
    (unowned slots at −1, which the kernel skips — the search's table) and
    the cut table (owned slots first, as wide as the batch's largest owned
    count).  For each, the mean device ms of ``ivf_score_lists`` (traced)
    and of the whole ``fused_ivf_topk`` call (CUDA events).  The empty
    list's share is 1 − owned / every slot; the model's, the empty list's
    groups of 32 (query, slot) pairs over all groups."""
    from repro_torch.kernels.ivf_fused import kernel as fused_kernel

    qe, base_q, probe, _ = sharded.fused_inputs(
        queries[:BATCH], nprobe, sharded.scorer.params())
    list_storage, list_ids, g2l = sharded._shards[0][0]
    empty = list_storage.shape[0] - 1
    search = g2l[probe.long()]
    owned = search >= 0
    every = torch.where(owned, search, empty)
    width = int(owned.sum(dim=1).max())
    order = torch.sort((~owned).to(torch.int8), dim=1,
                       stable=True).indices[:, :width]
    tables = {"every slot": every, "owned only": search,
              "cut": torch.gather(every, 1, order)}
    out = {}
    for label, table in tables.items():
        table = table.to(torch.int32).contiguous()
        base = base_q[:, None].expand(table.shape).float().contiguous()

        def call():
            fused_kernel.fused_ivf_topk(table, qe, list_storage, list_ids,
                                        base, K, sharded.scorer.name)

        out[label] = (score_lists_ms(call), cuda_ms(call, 20),
                      int(table.shape[1]))
    groups = (torch.bincount(every.reshape(-1).long(),
                             minlength=empty + 1) + 31) // 32
    out["share"] = 1.0 - out["owned only"][0] / out["every slot"][0]
    out["share_call"] = 1.0 - out["owned only"][1] / out["every slot"][1]
    out["share_model"] = float(groups[empty]) / float(groups.sum())
    return out


def phase_sharded(args, kb, exact, ivf_indexes) -> dict[str, int]:
    """Sharded search on the one card: the main and IVF phases' 1M-doc
    indexes (24x, 100x, IVF 24x, IVF 100x), each served from its
    single-host artifact with ``load_index(shard=...)`` over a 1x4 and a
    2x2 (replicas 2) mesh on cuda:0, searched in batches of 256 at k = 10
    (IVF at nprobe 16 and 64) and held to the single-host search in ids
    and score bits; the sharded artifacts saved and reloaded; a sharded
    build of the post recipe (fused_quantize); a SegmentedIndex over the
    sharded 24x main with its compaction (fold + re-shard); the front door
    with all-or-none staging.  Returns the launch counts of the run."""
    import shutil

    import repro_torch.parallel.placement as placement
    from repro_torch.retrieval import (IndexSpec, SegmentedIndex,
                                       ShardedCompressedIndex, ShardSpec,
                                       build_index, load_index)
    from repro_torch.serve import RetrievalService

    t_phase = time.perf_counter()
    dev = "cuda:0"
    print("[sharded] multi-card placement is not exercised: this machine "
          f"has {torch.cuda.device_count()} card, so every shard of every "
          "mesh lives on cuda:0 (no peer copy between cards, no shards "
          "running on two cards at once)")
    queries = kb.queries
    n_q = queries.shape[0]
    n_batches = -(-n_q // BATCH)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "sharded")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    singles = {"pca_int8_24x": exact["pca_int8_24x"],
               "pca_onebit_100x": exact["pca_onebit_100x"],
               "ivf_int8_24x": ivf_indexes["ivf_int8_24x"],
               "ivf_rot_onebit_100x": ivf_indexes["ivf_rot_onebit_100x"]}

    def kw_of(nprobe):
        return {} if nprobe is None else dict(nprobe=nprobe, query_chunk=BATCH)

    probes = {name: (SHARD_NPROBES if name.startswith("ivf") else (None,))
              for name in singles}
    paths, ref = {}, {}
    for name, idx in singles.items():
        paths[name] = os.path.join(root, f"{name}.npz")
        idx.save(paths[name])
        for nprobe in probes[name]:
            idx.search(queries[:BATCH], K, **kw_of(nprobe))      # warm-up
            ref[(name, nprobe)] = _search_batches(idx, queries, K,
                                                  **kw_of(nprobe))
    # -- the single-host twins of the post-recipe build and the segmented
    # main, run before the count so that it holds the sharded path alone
    post = IndexSpec(stages=(("CenterNorm", {}), ("PCA", {"dim": 128}),
                             ("CenterNorm", {}), ("Int8Quantizer", {})))
    docs = kb.docs[:SHARD_POST_DOCS]
    single = build_index(post, docs, queries, device=dev)
    post_ref = single.search(queries[:BATCH], K)
    post_pipeline, post_codes = single.pipeline, single.storage
    del single
    main24 = "pca_int8_24x"
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 23)
    n_main = len(singles[main24])
    pick = torch.randint(0, n_main, (SEG_ADDS,), generator=gen, device="cuda")
    adds = kb.docs[pick] + 0.05 * torch.randn(
        (SEG_ADDS, kb.docs.shape[1]), generator=gen, device="cuda")
    seg = SegmentedIndex(load_index(paths[main24], device=dev))
    seg.add(adds)
    first = _search_batches(seg, queries, K)[1].cpu().numpy()
    pool = np.unique(first.ravel())
    dead = np.random.default_rng(args.seed + 29).choice(
        pool[pool < n_main], SEG_DEAD, replace=False).tolist()

    def seg_searched(seg, tag):
        if seg.delete(dead) != SEG_DEAD:
            raise AssertionError(f"segmented {tag} main: deletes not taken")
        seg.search(queries[:BATCH], K)                           # warm-up
        vals, ids, secs = _search_batches(seg, queries, K)
        print(f"[sharded] seg over {main24} ({tag} main): {SEG_ADDS} adds, "
              f"{SEG_DEAD} main deletes, main probed k + #dead = "
              f"{K + SEG_DEAD} deep: {latency(secs, n_q)}")
        stats = seg.shard_stats()
        t0 = time.perf_counter()
        comp = seg.compact()
        torch.cuda.synchronize()
        return (vals, ids), stats, comp, time.perf_counter() - t0

    seg_ref, _, comp, comp_s = seg_searched(seg, "single")
    comp_ref = _search_batches(comp, queries, K)[:2]
    del seg, comp
    print(f"[sharded] single-host artifacts saved, references and twins "
          f"searched in {time.perf_counter() - t_phase:.1f} s")

    reset_launch_counts()
    keep = {}
    for mesh_name, mesh_kw in SHARD_MESHES:
        spec = ShardSpec(**mesh_kw)
        for name in singles:
            t0 = time.perf_counter()
            idx = load_index(paths[name], shard=spec, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            rows = idx.shard_stats()
            print(f"[sharded] {mesh_name} {name}: {type(idx).__name__} "
                  f"({idx.n_query_shards} x {idx.n_doc_shards}) loaded with "
                  f"shard={spec} in {load_s:.2f} s; shards "
                  f"{json.dumps(rows)}")
            for nprobe in probes[name]:
                kw = kw_of(nprobe)
                idx.search(queries[:BATCH], K, **kw)              # warm-up
                before = launch_counts()
                vals, ids, secs = _search_batches(idx, queries, K, **kw)
                per_batch = {n: c / n_batches for n, c in diff_counts(
                    before, launch_counts()).items()}
                _checked(name, vals, ids, n_q, len(idx))
                same_ids, same_bits = _same_bits((vals, ids),
                                                 ref[(name, nprobe)][:2])
                tag = "" if nprobe is None else f" nprobe {nprobe}"
                print(f"[sharded] {mesh_name} {name}{tag}: "
                      f"{latency(secs, n_q)} (single-host "
                      f"{latency(ref[(name, nprobe)][2], n_q)}); launches "
                      f"a batch {json.dumps(per_batch)}; vs single-host ids "
                      f"{'equal' if same_ids else 'DIFFER'}, score bits "
                      f"{'equal' if same_bits else 'DIFFER'}")
                if not (same_ids and same_bits):
                    raise AssertionError(f"sharded {mesh_name} {name}{tag} "
                                         "differs from the single host")
            if mesh_name == "1x4":
                keep[name] = idx
            del idx
        torch.cuda.empty_cache()

    # -- the sharded artifacts, saved and loaded back -------------------
    for name in ("pca_int8_24x", "ivf_int8_24x"):
        path = os.path.join(root, f"{name}.sharded.npz")
        keep[name].save(path)
        back = load_index(path, device=dev)
        nprobe = probes[name][-1]
        vals, ids, _ = _search_batches(back, queries, K, **kw_of(nprobe))
        same = _same_bits((vals, ids), ref[(name, nprobe)][:2])
        print(f"[sharded] {name}: the 1x4 sharded artifact "
              f"({os.path.getsize(path) / 2**20:.1f} MiB) loaded back as "
              f"{type(back).__name__} ({back.n_doc_shards} shards, from the "
              f"embedded spec): ids {'equal' if same[0] else 'DIFFER'}, "
              f"score bits {'equal' if same[1] else 'DIFFER'}")
        if not all(same):
            raise AssertionError(f"{name}: the reloaded sharded artifact "
                                 "differs from the single host")
        del back

    # -- a sharded build of the post recipe encodes by fused_quantize ----
    sharded = ShardedCompressedIndex(post_pipeline,
                                     ShardSpec(shards=4).build_mesh(dev))
    before = launch_counts()["fused_quantize"]
    sharded.add(docs)
    encodes = launch_counts()["fused_quantize"] - before
    same = (torch.equal(sharded.storage, post_codes),
            *_same_bits(sharded.search(queries[:BATCH], K), post_ref))
    print(f"[sharded] post recipe, {SHARD_POST_DOCS} docs over 4 shards: "
          f"fused_quantize launches {encodes}; codes, ids, score bits vs the "
          f"single-host index: {same}")
    if encodes < 1 or not all(same):
        raise AssertionError("the sharded post-recipe build differs from the "
                             "single host")
    del sharded, docs, post_codes

    # -- a SegmentedIndex over the sharded 24x main ----------------------
    seg = SegmentedIndex(load_index(paths[main24], shard=ShardSpec(shards=4),
                                    device=dev))
    seg.add(adds)
    got, stats, comp, comp_s = seg_searched(seg, "sharded")
    same = _same_bits(got, seg_ref)
    print(f"[sharded] seg over the 1x4 sharded {main24} vs over the single "
          f"host: ids {'equal' if same[0] else 'DIFFER'}, score bits "
          f"{'equal' if same[1] else 'DIFFER'}; shard_stats "
          f"{json.dumps(stats)}")
    if not all(same):
        raise AssertionError("the segmented sharded main ranks differently "
                             "from the single host")
    resharded = (type(comp.main) is ShardedCompressedIndex
                 and comp.main.mesh is seg.main.mesh
                 and comp.main.n_doc_shards == 4)
    same = _same_bits(_search_batches(comp, queries, K)[:2], comp_ref)
    fold = ("re-sharded over the same mesh" if resharded
            else "NOT RE-SHARDED")
    print(f"[sharded] compact() of the sharded main in {comp_s:.2f} s: the "
          f"fold {fold} ({len(comp)} live); vs the single-host fold ids "
          f"{'equal' if same[0] else 'DIFFER'}, score bits "
          f"{'equal' if same[1] else 'DIFFER'}; shard_stats "
          f"{json.dumps(comp.shard_stats())}")
    if not (resharded and all(same)):
        raise AssertionError("compaction of the sharded main differs")
    del seg, comp, adds

    # -- the front door over the sharded 24x artifact --------------------
    direct_v, direct_i, _ = ref[(main24, None)]
    shard4 = ShardSpec(shards=4)

    def served_equal(svc, version, tag):
        lat, same = [], True
        for s in range(0, n_q, BATCH):
            res = svc.query(queries[s: s + BATCH].cpu().numpy(),
                            index="kb").result(300)
            lat.append(res.latency_s)
            same &= (np.array_equal(res.ids, direct_i[s: s + BATCH]
                                    .cpu().numpy()) and
                     np.array_equal(res.scores.view(np.int32),
                                    direct_v[s: s + BATCH].view(torch.int32)
                                    .cpu().numpy()))
        rows = svc.stats()["indexes"]["kb"]["versions"][version]["shards"]
        ms = sorted(x * 1e3 for x in lat)
        print(f"[sharded] front door v{version} ({tag}): {len(lat)} queries "
              f"of {BATCH} rows, p50 {statistics.median(ms):.3f} ms p99 "
              f"{ms[-1]:.3f} ms; vs direct search "
              f"{'bit-identical' if same else 'DIFFERS'}; shards "
              f"{json.dumps(rows)}")
        if not same or len(rows) != 4:
            raise AssertionError("the sharded front door's answer differs "
                                 "from direct search")

    def fail_shard_2(shard_id, n_shards):
        if shard_id == 2:
            raise RuntimeError("injected shard-2 placement failure")

    with RetrievalService(max_batch=BATCH) as svc:
        svc.register("kb", artifact=paths[main24], shard=shard4, device=dev)
        served_equal(svc, 1, "registered with shard=ShardSpec(shards=4)")
        placement.SHARD_PLACEMENT_HOOK = fail_shard_2
        try:
            svc.stage("kb", artifact=paths[main24], shard=shard4, device=dev)
            failed = False
        except RuntimeError:
            failed = True
        finally:
            placement.SHARD_PLACEMENT_HOOK = None
        st = svc.stats()["indexes"]["kb"]
        clean = (st["staged"] is None and st["live"] == 1
                 and sorted(st["versions"]) == [1])
        print(f"[sharded] front door: a stage with shard 2 failing placement "
              f"{'raised' if failed else 'DID NOT RAISE'}; registry "
              f"{'untouched' if clean else 'CHANGED'} (live {st['live']}, "
              f"staged {st['staged']}, versions {sorted(st['versions'])})")
        if not (failed and clean):
            raise AssertionError("a failed sharded stage changed the registry")
        vid = svc.stage("kb", artifact=paths[main24], shard=shard4,
                        device=dev)
        svc.promote("kb")
        served_equal(svc, vid, "staged and promoted")
    counts = launch_counts()
    print(f"[sharded] launches over the sharded path (its single-host "
          f"twins ran before the count): {counts}")
    for kern in ("int8_ip", "binary_ip", "topk_blocks", "fused_ivf_topk",
                 "fused_quantize"):
        if counts[kern] < 1:
            raise AssertionError(f"{kern} never launched on the sharded path")

    # -- after the count: traces and the empty list's cost ---------------
    for name, idx in keep.items():
        kw = {} if probes[name] == (None,) else kw_of(NPROBE)
        profile_batches({f"sharded 1x4 {name}": idx}, queries, **kw)
    for name in ("ivf_int8_24x", "ivf_rot_onebit_100x"):
        for nprobe in SHARD_NPROBES:
            e = ivf_empty_list_share(keep[name], queries, nprobe)
            print(f"[sharded] {name} 1x4 shard 0 nprobe {nprobe}, "
                  f"ivf_score_lists ms / whole fused_ivf_topk ms (table "
                  f"width): " + "; ".join(
                      f"{t} {e[t][0]:.4f} / {e[t][1]:.4f} ({e[t][2]})"
                      for t in ("every slot", "owned only", "cut"))
                  + f"; the empty list's share of ivf_score_lists "
                  f"{e['share']:.3f} ({e['share_call']:.3f} of the call; "
                  f"{e['share_model']:.3f} of the 32-pair groups)")
    del keep
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


class _HostClock:
    """Host seconds inside a tiered index's block assembly, by step: its
    store fetches and its packing into the staging buffer (instance
    wrappers; the index's code is unchanged)."""

    def __init__(self, index):
        self.seconds = {"_fetch_block": 0.0, "_assemble_block": 0.0}
        for name in self.seconds:
            setattr(index, name, self._timed(name, getattr(index, name)))

    def _timed(self, name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return call


def _same_bits(got, want) -> tuple[bool, bool]:
    (gv, gi), (wv, wi) = got, want
    return (torch.equal(gi, wi),
            torch.equal(gv.view(torch.int32), wv.view(torch.int32)))


def check_tiered_float_backends(kb, root: str) -> None:
    """The per-block fused route for the float and fp16 rows too: small IVF
    indexes over the KB's first docs, tiered at budget 0 against resident,
    bit for bit, at an odd nprobe (a phantom pad slot) and k past the
    probed pool (the (−inf, −1) fill)."""
    from repro_torch.retrieval import (IndexSpec, build_index, load_index,
                                       save_index)

    docs, q = kb.docs[:TIERED_SMALL_DOCS], kb.queries[:BATCH]
    for name, spec in (("float", IndexSpec(method="dense", ivf=(64, 7))),
                       ("fp16", IndexSpec(method="fp16", post=False,
                                          ivf=(64, 7)))):
        path = os.path.join(root, f"small_{name}.v3")
        built = build_index(spec, docs, q, device="cuda")
        save_index(built, path, chunked=True)
        tiered = load_index(path, resident=0, device="cuda")
        same = [_same_bits(tiered.search(q, k, nprobe=7, query_chunk=BATCH),
                           built.search(q, k, nprobe=7, query_chunk=BATCH))
                for k in (K, 3 * TIERED_SMALL_DOCS // 64 * 7)]
        print(f"[tiered] {name} IVF ({TIERED_SMALL_DOCS} docs, nlist 64, "
              f"nprobe 7) at budget 0 vs resident, k = 10 and past the "
              f"probed pool: {same}")
        if not all(a and b for a, b in same):
            raise AssertionError(f"{name}: tiered search differs from the "
                                 "resident index")


def phase_tiered(args, kb, ivf_indexes) -> dict[str, int]:
    """Tiered and served IVF: the IVF phase's 24x and 100x indexes saved as
    chunked v3 artifacts, loaded at several hot-tier budgets and searched
    (the per-block fused route), a segmented main over the tiered 24x
    index, chunked compaction, and the serving front door.  Returns the
    launch counts of the run."""
    import filecmp
    import shutil

    from repro_torch.retrieval import (SegmentedIndex, load_index,
                                       load_index_meta, save_index)
    from repro_torch.serve import RetrievalService

    queries = kb.queries[:TIERED_BATCHES * BATCH]
    kw = dict(query_chunk=BATCH)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "tiered")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    print("[tiered] the artifacts are written under build/tiered and read "
          "back at once: repeat reads of a chunk come from the page cache, "
          "not the disk (no cache is dropped), so a miss costs a copy out "
          "of the map and its CRC on the first read, not a disk read; the "
          "budgets bound the hot tier's materialised copies")
    reset_launch_counts()
    paths, refs = {}, {}
    for name, index in ivf_indexes.items():
        path = paths[name] = os.path.join(root, f"{name}.v3")
        t0 = time.perf_counter()
        save_index(index, path, chunked=True)
        save_s = time.perf_counter() - t0
        enc = load_index_meta(path)["encoded_nbytes"]
        print(f"[tiered] {name}: save_index(chunked=True) {save_s:.2f} s, "
              f"{enc} encoded bytes in {index.nlist} lists")
        ref = refs[name] = {
            nprobe: _search_batches(index, queries, K, nprobe=nprobe, **kw)
            for nprobe in TIERED_NPROBES}
        for label, budget in (("0", 0), ("enc/8", enc // 8),
                              ("enc/2", enc // 2), ("enc", enc),
                              ("all", "all")):
            t0 = time.perf_counter()
            tiered = load_index(path, resident=budget, device="cuda")
            load_s = time.perf_counter() - t0
            if (tiered.store is None) != (budget == "all"):
                raise AssertionError(f"{name} resident={label}: wrong tier")
            clock = _HostClock(tiered) if tiered.store is not None else None
            for nprobe in TIERED_NPROBES:
                before = launch_counts()["fused_ivf_topk"]
                host0 = dict(clock.seconds) if clock else {}
                vals, ids, secs = _search_batches(tiered, queries, K,
                                                  nprobe=nprobe, **kw)
                launches = launch_counts()["fused_ivf_topk"] - before
                same_ids, same_bits = _same_bits((vals, ids),
                                                 ref[nprobe][:2])
                fetch, pack = ((clock.seconds[n] - host0[n]) * 1e3
                               / TIERED_BATCHES for n in host0) \
                    if clock else (0.0, 0.0)
                print(f"[tiered] {name} resident={label} nprobe {nprobe}: "
                      f"{latency(secs, queries.shape[0])}; fused launches "
                      f"a batch {launches / TIERED_BATCHES:g}; host ms a "
                      f"batch assembling blocks {fetch + pack:.3f} (store "
                      f"gets {fetch:.3f}, packing {pack:.3f}); vs the "
                      f"resident fused search ids "
                      f"{'equal' if same_ids else 'DIFFER'}, score bits "
                      f"{'equal' if same_bits else 'DIFFER'}")
                if not (same_ids and same_bits):
                    raise AssertionError(f"{name} resident={label} nprobe "
                                         f"{nprobe}: tiered search differs "
                                         "from the resident index")
            stats = (json.dumps({k: tiered.store.stats()[k] for k in (
                "hits", "misses", "evictions", "bytes_resident",
                "budget_bytes", "bytes_read")})
                if tiered.store is not None else "no store (resident)")
            print(f"[tiered] {name} resident={label}: load {load_s:.2f} s; "
                  f"store {stats}")
            profile_batches({f"{name} resident={label}": tiered}, queries,
                            nprobe=NPROBE, **kw)
            del tiered
            torch.cuda.empty_cache()

    check_tiered_float_backends(kb, root)

    # -- a segmented main over the tiered 24x index ----------------------
    name = "ivf_int8_24x"
    path = paths[name]
    enc = load_index_meta(path)["encoded_nbytes"]
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 17)
    n_main = ivf_indexes[name]._n_docs
    pick = torch.randint(0, n_main, (SEG_ADDS,), generator=gen,
                         device="cuda")
    adds = kb.docs[pick] + 0.05 * torch.randn(
        (SEG_ADDS, kb.docs.shape[1]), generator=gen, device="cuda")
    segs = {"resident": SegmentedIndex(load_index(path, resident="all",
                                                  device="cuda")),
            "tiered": SegmentedIndex(load_index(path, resident=enc // 4,
                                                device="cuda"))}
    for seg in segs.values():
        seg.add(adds)
    queries = queries[:SEG_BATCHES * BATCH]
    first = _search_batches(segs["resident"], queries, K, nprobe=NPROBE)[1]
    pool = np.unique(first.cpu().numpy().ravel())
    dead = np.random.default_rng(args.seed + 19).choice(
        pool[pool < n_main], SEG_DEAD, replace=False).tolist()
    for seg in segs.values():
        if seg.delete(dead) != SEG_DEAD:
            raise AssertionError("segmented tiered main: deletes not taken")
    got = {}
    for tag, seg in segs.items():
        vals, ids, secs = _search_batches(seg, queries, K, nprobe=NPROBE)
        got[tag] = (vals, ids)
        print(f"[tiered] seg over {name} ({tag} main): {SEG_ADDS} adds, "
              f"{SEG_DEAD} main deletes, nprobe {NPROBE}, main probed "
              f"k + #dead = {K + SEG_DEAD} deep: "
              f"{latency(secs, queries.shape[0])}")
    same_ids, same_bits = _same_bits(got["tiered"], got["resident"])
    st = segs["tiered"].main.store.stats()
    print(f"[tiered] seg over {name}: tiered main at enc/4 vs resident main "
          f"ids {'equal' if same_ids else 'DIFFER'}, score bits "
          f"{'equal' if same_bits else 'DIFFER'}; pinned lists "
          f"{st['pinned_lists']}, store {json.dumps(st)}")
    if not same_ids:
        raise AssertionError("segmented tiered main ranks differently from "
                             "the resident main")
    comps = {}
    for tag, seg in segs.items():
        out = os.path.join(root, f"seg_{tag}.v3")
        t0 = time.perf_counter()
        # the tiered main's fold served tiered, the resident main's resident
        comps[tag] = seg.compact(
            out_path=out, resident=enc // 4 if tag == "tiered" else "all")
        print(f"[tiered] seg ({tag} main) compact(out_path=) to a v3 "
              f"artifact, reloaded {'at enc/4' if tag == 'tiered' else 'resident'}: "
              f"{time.perf_counter() - t0:.2f} s")
    same_files = all(filecmp.cmp(os.path.join(root, "seg_tiered.v3", f),
                                 os.path.join(root, "seg_resident.v3", f),
                                 shallow=False)
                     for f in ("chunks.bin", "manifest.json"))
    cv, ci, _ = _search_batches(comps["tiered"], queries, K + 1,
                                nprobe=NPROBE)
    rv, ri, _ = _search_batches(comps["resident"], queries, K + 1,
                                nprobe=NPROBE)
    c_ids, c_bits = _same_bits((cv, ci), (rv, ri))
    ok, err = ranking_agrees(got["tiered"], (rv[:, :K], ri[:, :K]),
                             exact=False, cut=rv[:, K])
    print(f"[tiered] compacted artifacts of the tiered and the resident main "
          f"{'byte-identical' if same_files else 'DIFFER'}; the fold at enc/4 "
          f"vs resident: ids {'equal' if c_ids else 'DIFFER'}, score bits "
          f"{'equal' if c_bits else 'DIFFER'}; vs before the fold "
          f"{'agrees' if ok else 'DIFFERS'} (max_abs_err {err:.3g}; delta "
          f"rows were scored by int8_ip, now by the fused kernel)")
    if not (same_files and c_ids and c_bits and ok):
        raise AssertionError("compact(out_path=) of the tiered main differs "
                             "from the resident main's")
    del segs, comps, adds
    torch.cuda.empty_cache()

    # -- the front door: direct search is the resident fused search ------
    queries = kb.queries[:TIERED_BATCHES * BATCH]
    direct_v, direct_i, _ = refs[name][NPROBE]
    with RetrievalService(max_batch=BATCH) as svc:
        svc.register("kb", artifact=path, resident_budget=enc // 4,
                     device="cuda")
        for version, budget in ((1, enc // 4), (2, "all")):
            lat, same = [], True
            for s in range(0, queries.shape[0], BATCH):
                q = queries[s: s + BATCH]
                res = svc.query(q.cpu().numpy(), index="kb").result(300)
                lat.append(res.latency_s)
                dv, di = direct_v[s: s + BATCH], direct_i[s: s + BATCH]
                same &= (np.array_equal(res.ids, di.cpu().numpy()) and
                         np.array_equal(res.scores.view(np.int32),
                                        dv.view(torch.int32).cpu().numpy()))
            row = svc.stats()["indexes"]["kb"]["versions"][version]
            ms = sorted(x * 1e3 for x in lat)
            print(f"[tiered] front door v{version} resident={budget}: "
                  f"{len(lat)} queries of {BATCH} rows, p50 "
                  f"{statistics.median(ms):.3f} ms p99 {ms[-1]:.3f} ms; vs "
                  f"direct search {'bit-identical' if same else 'DIFFERS'}; "
                  f"tier gauges "
                  f"{json.dumps(row['tier']) if 'tier' in row else 'none'}")
            if not same:
                raise AssertionError("the front door's answer differs from "
                                     "direct search")
            if (version == 1) != ("tier" in row):
                raise AssertionError("tier gauges wrong for the version")
            if version == 1:
                svc.stage("kb", artifact=path, resident_budget="all",
                          device="cuda")
                svc.promote("kb")
    counts = launch_counts()
    print(f"[tiered] launches over the tiered path: {counts}")
    if counts["fused_ivf_topk"] < 1:
        raise AssertionError("fused_ivf_topk never launched on the tiered "
                             "path")
    shutil.rmtree(root, ignore_errors=True)
    return counts


#: the off-path phase: the fit set F (the KB's first docs, with the 2,048
#: queries as the query sample), the reduced width, and the Table-2 rows
#: the port added, in repro's METHODS order
OFFPATH_FIT_DOCS, OFFPATH_DIM, OFFPATH_XDEV_DOCS = 65_536, 128, 4_096
OFFPATH_METHODS = ("gaussian_projection", "sparse_projection", "dim_drop",
                   "greedy_dim_drop", "ae_linear", "ae_full", "ae_shallow",
                   "ae_linear_l1", "ae_full_l1", "ae_shallow_l1",
                   "distance_learning", "contrastive")


def plain_search(index, queries, k):
    """``index``'s kernel-numerics search with each kernel's plain version
    (``int8_ip_ref`` or ``binary_ip_ref``, then the plain two-stage
    top-k): the reference its kernel search is held to on the card."""
    from repro_torch.kernels.binary_ip import ops as binary_ops
    from repro_torch.retrieval.scorers import Int8Scorer

    scorer = index.scorer
    q = scorer.encode_queries(index.encode_queries(queries))
    if isinstance(scorer, Int8Scorer):
        p = scorer.params()
        scores = int8_ip_ref((q * p["scale"]).to(torch.bfloat16),
                             index.storage, q @ p["zero"])
    else:
        scores = binary_ops.binary_ip_scores(
            q, index.storage, scorer.dim, offset=scorer.quantizer.offset,
            use_kernel=False)
    return streaming_topk(scores, k, use_kernel=False)


def check_cross_device(name, t, x) -> str:
    """One fitted transform applied on the card and, from the same state,
    on the CPU: exact for the dimension drops, else within 1e-5·max|y|
    (f32 GEMM order)."""
    from repro_torch.core.registry import build_transform, transform_spec

    sd = t.state_dict()
    on_cpu = build_transform(*transform_spec(t)).load_state(
        {"state": {k: v.cpu().numpy() for k, v in sd["state"].items()},
         "fitted": sd["fitted"]}, torch.device("cpu"))
    got, want = t(x).cpu(), on_cpu(x.cpu())
    err = float((got - want).abs().max())
    exact = "DimensionDrop" in type(t).__name__
    ok = torch.equal(got, want) if exact else \
        err <= 1e-5 * float(want.abs().max())
    if not ok:
        raise AssertionError(f"{name}: {type(t).__name__} on cuda differs "
                             f"from the CPU by {err:.3g}")
    return f"{name} {'equal' if exact else f'{err:.2g}'}"


def _loss_history(t) -> str:
    from repro_torch.core import Autoencoder

    if not isinstance(t, Autoencoder):
        return ""
    return f", loss_history {[round(v, 6) for v in t.loss_history]}"


def phase_offpath(args, kb, rp_float) -> dict[str, int]:
    """The off-path transforms on the main KB: the 12 Table-2 methods the
    port added (fit on F, all docs encoded into a float 128-d index,
    searched exactly), the AE + int8 and Gaussian + 1-bit recipes through
    ``int8_ip`` / ``binary_ip`` (held to the plain versions, saved and
    loaded bit-identically), and each new transform on cuda against the
    CPU.  Returns the launch counts of the phase."""
    from repro_torch.core import (PAPER_L1, Autoencoder, CenterNorm,
                                  CompressionPipeline, GaussianProjection,
                                  Int8Quantizer, OneBitQuantizer,
                                  build_method)
    from repro_torch.retrieval import (CompressedIndex, load_index,
                                       make_dim_drop_scorer,
                                       r_precision_from_ids, save_index)

    t_phase = time.perf_counter()
    fit_docs, queries = kb.docs[:OFFPATH_FIT_DOCS], kb.queries
    x_xdev = kb.docs[:OFFPATH_XDEV_DOCS]
    greedy_scorer = make_dim_drop_scorer(kb.relevant, n_queries=256,
                                         n_docs=8192)
    reset_launch_counts()

    def fit(pipe, docs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.fit(docs, queries,
                 rng=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def encode(pipe):
        t0 = time.perf_counter()
        index = CompressedIndex(pipe, device="cuda").add(kb.docs)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    xdev, traced = [], {}
    for name in OFFPATH_METHODS:
        pipe = build_method(name, OFFPATH_DIM, greedy_scorer=greedy_scorer)
        # greedy's scorer indexes kb.relevant, so it sees the whole KB
        fit_s = fit(pipe, kb.docs if name == "greedy_dim_drop" else fit_docs)
        index, enc_s = encode(pipe)
        vals, ids, secs = _search_batches(index, queries, K)
        _checked(name, vals, ids, queries.shape[0], args.n_docs)
        rp = r_precision_from_ids(ids, kb.relevant)
        core = pipe.transforms[1]
        print(f"[offpath] {name}: fit {fit_s:.2f} s, encode {enc_s:.2f} s "
              f"({len(index)} docs, {index.nbytes / len(index):g} B/doc), "
              f"{latency(secs, queries.shape[0])}, R-precision {rp:.4f} "
              f"({rp / rp_float:.4f} of float){_loss_history(core)}")
        xdev.append((name, core, pipe.transforms[0](x_xdev, "docs")))
        if not traced:                 # one float 128-d index traced
            traced[name] = index
        del index, vals, ids
    torch.cuda.empty_cache()

    recipes = {
        "ae_int8_24x": lambda: [
            CenterNorm(), Autoencoder(variant="shallow_decoder",
                                      bottleneck=OFFPATH_DIM, l1=PAPER_L1),
            CenterNorm(), Int8Quantizer()],
        "gauss_onebit_96x": lambda: [
            CenterNorm(), GaussianProjection(256), CenterNorm(),
            OneBitQuantizer(offset=0.5)],
    }
    with tempfile.TemporaryDirectory() as tmp:
        for name, stages in recipes.items():
            pipe = CompressionPipeline(stages())
            fit_s = fit(pipe, fit_docs)
            index, enc_s = encode(pipe)
            path = os.path.join(tmp, f"{name}.npz")
            save_index(index, path)
            loaded = load_index(path, device="cuda")
            vals, ids, _ = _search_batches(index, queries, K)
            lv, li, secs = _search_batches(loaded, queries, K)
            same = _same_bits((lv, li), (vals, ids))
            _checked(name, lv, li, queries.shape[0], args.n_docs)
            rp = r_precision_from_ids(li, kb.relevant)
            print(f"[offpath] {name}: fit {fit_s:.2f} s, encode {enc_s:.2f} "
                  f"s, {768 * 4 * len(loaded) / loaded.nbytes:.1f}x vs f32, "
                  f"saved+loaded ids / score bits equal {same}; loaded: "
                  f"{latency(secs, queries.shape[0])}, R-precision "
                  f"{rp:.4f} ({rp / rp_float:.4f} of float)"
                  f"{_loss_history(pipe.transforms[1])}")
            if not all(same):
                raise AssertionError(f"{name}: the loaded artifact ranks "
                                     "differently from the built index")
            traced[name] = loaded
            del index, loaded
    counts = launch_counts()
    for kern in ("int8_ip", "binary_ip", "topk_blocks"):
        if counts[kern] < 1:
            raise AssertionError(f"{kern} never launched on the off-path "
                                 "phase")

    # after the count: each recipe's kernel search against the plain
    # versions of its kernels
    for name in recipes:
        index = traced[name]
        ok, err = ranking_agrees(index.search(queries[:BATCH], K),
                                 plain_search(index, queries[:BATCH], K),
                                 exact=index.scorer.name == "onebit")
        print(f"[offpath] {name}: kernel search vs the plain versions: "
              f"{'ok' if ok else 'MISMATCH'} (max_abs_err {err:.3g})")
        if not ok:
            raise AssertionError(f"{name}: kernel search disagrees with "
                                 "its plain versions")

    print(f"[offpath] cuda vs cpu on {OFFPATH_XDEV_DOCS} docs: " + "; ".join(
        check_cross_device(name, t, x) for name, t, x in xdev))
    print(f"[offpath] launches {counts}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    profile_batches(traced, queries)           # after the count
    torch.cuda.empty_cache()
    return counts


def latency(secs, n_queries: int) -> str:
    ms = sorted(x * 1e3 for x in secs)
    p99 = ms[min(len(ms) - 1, round(0.99 * (len(ms) - 1)))]
    return (f"{n_queries / sum(secs):.1f} qps, batch {BATCH} p50 "
            f"{statistics.median(ms):.3f} ms p99 {p99:.3f} ms")


def _checked(name, vals, ids, n_queries, n_ids):
    if vals.shape != (n_queries, K) or not bool(torch.isfinite(vals).all()) \
            or int(ids.min()) < 0 or int(ids.max()) >= n_ids:
        raise AssertionError(f"{name}: malformed search output")
    return vals, ids


def drive_mutable(name, spec, kb, n_main, nprobes, dead_of):
    """One mutable index through the live-update path, as a user drives
    it: build over the first ``n_main`` docs, search, 8 adds, search,
    deletes (``dead_of(ranking) → ids``), search.  Returns the index and
    what each state printed and ranked."""
    from repro_torch.retrieval import build_index

    queries, n_total = kb.queries, kb.docs.shape[0]
    add_rows = (n_total - n_main) // N_ADDS
    run = {"counts": {}, "results": {}, "n_main_dead": 0}
    before = launch_counts()
    t0 = time.perf_counter()
    seg = build_index(spec, kb.docs[:n_main], queries, device="cuda")
    torch.cuda.synchronize()
    run["build_s"] = time.perf_counter() - t0
    run["counts"]["build"] = diff_counts(before, launch_counts())
    print(f"[mutable] {name}: built over {n_main} docs in "
          f"{run['build_s']:.1f} s; launches {run['counts']['build']}")

    def search_state(state):
        for nprobe in nprobes:
            kw = {} if nprobe is None else {"nprobe": nprobe}
            seg.search(queries[:BATCH], K, **kw)          # warm-up
            vals, ids, secs = _search_batches(seg, queries, K, **kw)
            _checked(name, vals, ids, queries.shape[0], n_total)
            run["results"][(state, nprobe)] = (vals, ids)
            tag = "" if nprobe is None else f" nprobe {nprobe}"
            print(f"[mutable] {name} {state}{tag}: "
                  f"{latency(secs, queries.shape[0])}; main probed "
                  f"k + #dead(main) = {K + run['n_main_dead']} deep")

    search_state("main")
    before = launch_counts()
    add_ms = []
    for i in range(N_ADDS):
        block = kb.docs[n_main + i * add_rows: n_main + (i + 1) * add_rows]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg.add(block)
        torch.cuda.synchronize()
        add_ms.append((time.perf_counter() - t0) * 1e3)
    run["counts"]["adds"] = diff_counts(before, launch_counts())
    run["add_ms"] = add_ms
    print(f"[mutable] {name}: {N_ADDS} adds of {add_rows} rows, ms each "
          f"{', '.join(f'{x:.2f}' for x in add_ms)} (median "
          f"{statistics.median(add_ms):.3f}); launches "
          f"{run['counts']['adds']}")
    search_state("added")
    dead = dead_of(run["results"])
    n_dead = seg.delete(dead)
    if n_dead != len(dead):
        raise AssertionError(f"{name}: deleted {n_dead} of {len(dead)}")
    run["dead"] = np.asarray(dead)
    run["n_main_dead"] = int((run["dead"] < n_main).sum())
    search_state("deleted")
    run["index"] = seg
    return run


def diff_counts(before: dict, after: dict) -> dict:
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


def phase_mutable(args, kb) -> dict[str, int]:
    """Mutable indexes: a 1M-doc main, 8 live adds of 16,384 rows, deletes,
    through the paper's pre+post-normalized 24x recipe (fused_quantize on
    build and adds) and the IVF 24x recipe (the main probed k + #dead
    deep: fused_ivf_topk above MAX_K); each checked against an equivalent
    fresh index, through compact() and a v2 save/load.  Returns the launch
    counts of the driven run."""
    from repro_torch.retrieval import (CompressedIndex, DenseIndex, IVFIndex,
                                       IndexSpec, load_index,
                                       r_precision_from_ids, recall_at_k)
    from repro_torch.retrieval.ivf import build_padded_lists
    from repro_torch.retrieval.scorers import (apply_float_stages,
                                               encode_storage)

    n_main = args.n_docs
    queries, n_total = kb.queries, kb.docs.shape[0]
    print(f"[mutable] main {n_main} docs, then {N_ADDS} adds of {ADD_ROWS}")
    rng = np.random.default_rng(args.seed + 13)

    def top_ids(results, state, nprobe, lo, hi, n):
        """``n`` distinct ids in [lo, hi) that the ranking returned: the
        deletes hit documents that searches find."""
        ids = results[(state, nprobe)][1].cpu().numpy().ravel()
        pool = np.unique(ids[(ids >= lo) & (ids < hi)])
        return rng.choice(pool, n, replace=False).tolist()

    post_spec = IndexSpec(stages=(("CenterNorm", {}), ("PCA", {"dim": 128}),
                                  ("CenterNorm", {}), ("Int8Quantizer", {})),
                          mutable=True)
    ivf_spec = IndexSpec(method="pca_int8", dim=128, post=False,
                         ivf=(NLIST, NPROBE), kmeans_iters=8,
                         kmeans_init="++", balanced_lists=True, mutable=True)
    reset_launch_counts()
    runs = {
        "seg_24x_post": drive_mutable(
            "seg_24x_post", post_spec, kb, n_main, (None,),
            lambda res: top_ids(res, "added", None, 0, n_main, 100)
            + top_ids(res, "added", None, n_main, n_total, 100)),
        "seg_ivf_24x": drive_mutable(
            "seg_ivf_24x", ivf_spec, kb, n_main, NPROBES_TIMED,
            lambda res: top_ids(res, "added", NPROBE, 0, n_main, 1500)),
    }
    counts = launch_counts()
    print(f"[mutable] launches over the mutable path: {counts}")
    post = runs["seg_24x_post"]
    if post["counts"]["build"].get("fused_quantize", 0) < 1 or \
            post["counts"]["adds"].get("fused_quantize", 0) < N_ADDS:
        raise AssertionError("seg_24x_post: fused_quantize did not encode "
                             "the build and every add")
    for kern in ("int8_ip", "topk_blocks", "fused_ivf_topk",
                 "fused_quantize"):
        if counts[kern] < 1:
            raise AssertionError(f"{kern} never launched on the mutable path")

    # -- seg_24x_post: a fresh build over the surviving rows ------------
    seg = post["index"]
    vals, ids = post["results"][("deleted", None)]
    alive = np.setdiff1d(np.arange(n_total), post["dead"])
    alive_t = torch.from_numpy(alive).cuda()
    fresh = CompressedIndex(seg.main.pipeline, sim=seg.sim,
                            backend=seg.main.backend, device="cuda")
    fresh.add(kb.docs[alive_t])
    fv, fi, _ = _search_batches(fresh, queries, K)
    same_ids = torch.equal(alive_t[fi], ids)
    same_bits = torch.equal(fv.view(torch.int32), vals.view(torch.int32))
    print(f"[mutable] seg_24x_post vs a fresh CompressedIndex over the "
          f"{len(alive)} surviving rows (same fitted pipeline): ids "
          f"{'equal' if same_ids else 'DIFFER'}, score bits "
          f"{'equal' if same_bits else 'DIFFER'} (max |dv| "
          f"{float((fv - vals).abs().max()):.3g})")
    if not (same_ids and same_bits):
        raise AssertionError("seg_24x_post ranks differently from a fresh "
                             "build over the surviving rows")
    del fresh, fv, fi

    # the fused encode against the staged plain path on the card
    main_docs = kb.docs[:n_main]
    plain_codes = seg.scorer.encode_docs(
        apply_float_stages(seg.float_stages, main_docs, "docs"))
    ok, worst, share = codes_agree(seg.main.storage, plain_codes)
    plain = CompressedIndex(seg.main.pipeline, sim=seg.sim,
                            backend=seg.main.backend, device="cuda")
    plain.load_state_dict({"pipeline": seg.main.pipeline.state_dict(),
                           "storage": plain_codes, "n_docs": n_main,
                           "dim": seg.main._dim})
    _, pi, _ = _search_batches(plain, queries, K)
    overlap = recall_at_k(post["results"][("main", None)][1], pi)
    print(f"[mutable] seg_24x_post build: fused_quantize codes vs the staged "
          f"plain encode on the card: max diff {worst}, share differing "
          f"{share:.3g} ({'within' if ok else 'OUTSIDE'} the bar), search "
          f"recall@{K} {overlap:.4f}")
    if not ok:
        raise AssertionError("fused_quantize build disagrees with the staged "
                             "encode")
    del plain, plain_codes, pi
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode_storage(seg.float_stages, seg.scorer, main_docs)
    torch.cuda.synchronize()
    post["encode_docs_s"] = n_main / (time.perf_counter() - t0)

    # -- seg_ivf_24x: one IVF index, same centroids, all surviving rows --
    ivf_run = runs["seg_ivf_24x"]
    seg_ivf = ivf_run["index"]
    main = seg_ivf.main
    sd = seg_ivf.state_dict()
    tomb = np.zeros(seg_ivf.next_gid, bool)
    tomb[sd["tombstones"]] = True
    # the layers' own codes and routing labels: the IVF encode is staged
    # (cuBLAS, whose rows may round differently at another batch size), so
    # the check is of the search over main + delta layers
    keep_m = ~tomb[sd["main_gids"]]
    rows = [main.storage[torch.from_numpy(keep_m).cuda()]]
    labels = [sd["main"]["labels"][keep_m]]
    gids = [sd["main_gids"][keep_m]]
    for s_ in sd["segments"]:
        keep = ~tomb[s_["gids"]]
        rows.append(s_["storage"][torch.from_numpy(keep).cuda()])
        labels.append(s_["labels"][keep])
        gids.append(s_["gids"][keep])
    labels, gids = np.concatenate(labels), np.concatenate(gids)
    gids_t = torch.from_numpy(gids.astype(np.int64)).cuda()
    ref = IVFIndex(main.pipeline, nlist=main.nlist, nprobe=main.nprobe,
                   sim=main.sim, backend=main.backend, device="cuda")
    ref.load_state_dict({
        "pipeline": main.pipeline.state_dict(), "storage": torch.cat(rows),
        "centroids": main.centroids, "labels": labels,
        "lists": build_padded_lists(labels, main.nlist),
        "nlist": main.nlist, "nprobe": main.nprobe, "n_docs": len(labels),
        "dim": main._dim})
    for nprobe in NPROBES_TIMED:
        # K + 1: the (k+1)-th value marks near-ties across the cut (delta
        # rows are scored by int8_ip here, by the fused kernel there)
        rv, ri, _ = _search_batches(ref, queries, K + 1, nprobe=nprobe)
        got = ivf_run["results"][("deleted", nprobe)]
        ok, err = ranking_agrees(got, (rv[:, :K], gids_t[ri[:, :K]]),
                                 exact=False, cut=rv[:, K])
        print(f"[mutable] seg_ivf_24x nprobe {nprobe} vs one IVFIndex with "
              f"the same centroids over the {len(gids)} surviving rows: "
              f"max_abs_err {err:.3g}, {'agrees' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("seg_ivf_24x ranks differently from the "
                                 "equivalent IVF index")
    del ref, rows
    t0 = time.perf_counter()
    encode_storage(main.float_stages, main.scorer, main_docs)
    torch.cuda.synchronize()
    ivf_run["encode_docs_s"] = n_main / (time.perf_counter() - t0)

    # -- compaction, the v2 round trip, quality, stats, traces -----------
    float_ids = _search_batches(DenseIndex(kb.docs, device="cuda"), queries,
                                K)[1]
    rp_float = r_precision_from_ids(float_ids, kb.relevant)
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in runs.items():
            seg = run["index"]
            ivf = seg.nprobe is not None
            q = queries[:BATCH] if ivf else queries
            kw = {"nprobe": NLIST} if ivf else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comp = seg.compact()
            torch.cuda.synchronize()
            run["compact_s"] = time.perf_counter() - t0
            # an IVF compaction refits the router: compare at full probe
            cv, ci, _ = _search_batches(comp, q, K + 1, **kw)
            sv, si, _ = _search_batches(seg, q, K, **kw)
            ok, err = ranking_agrees((sv, si), (cv[:, :K], ci[:, :K]),
                                     exact=not ivf, cut=cv[:, K])
            print(f"[mutable] {name}: compact() in {run['compact_s']:.2f} s "
                  f"({len(comp)} live, {comp.n_segments} segments); ranking"
                  f"{' at nprobe = nlist' if ivf else ''} "
                  f"{'kept' if ok else 'CHANGED'}"
                  f"{'' if ivf else ' bit for bit'} (max_abs_err {err:.3g})")
            if not ok:
                raise AssertionError(f"{name}: compact() changed the ranking")
            del comp
            path = os.path.join(tmp, f"{name}.npz")
            seg.save(path)
            loaded = load_index(path, device="cuda")
            state = ("deleted", NPROBE if ivf else None)
            kw = {"nprobe": NPROBE} if ivf else {}
            lv, li, _ = _search_batches(loaded, queries, K, **kw)
            rv_, ri_ = run["results"][state]
            same = torch.equal(li, ri_) and torch.equal(
                lv.view(torch.int32), rv_.view(torch.int32))
            print(f"[mutable] {name}: v2 save + load_index "
                  f"({os.path.getsize(path) / 2**20:.1f} MiB) ranking "
                  f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"{name}: the v2 artifact ranks "
                                     "differently")
            del loaded
            for nprobe in (NPROBES_TIMED if ivf else (None,)):
                rp = r_precision_from_ids(run["results"][("added", nprobe)][1],
                                          kb.relevant)
                tag = "" if nprobe is None else f" nprobe {nprobe}"
                print(f"[mutable] {name}{tag}: R-precision after the adds "
                      f"{rp:.4f} ({rp / rp_float:.4f} of float "
                      f"{rp_float:.4f} over the same {n_total} docs)")
            print(f"[mutable] {name}: encode {run['encode_docs_s']:.0f} "
                  f"docs/s; mutable_stats {json.dumps(seg.mutable_stats())}")
    profile_batches({"seg_24x_post": runs["seg_24x_post"]["index"]}, queries)
    profile_batches({"seg_ivf_24x": runs["seg_ivf_24x"]["index"]}, queries,
                    nprobe=NPROBE)
    return counts


#: the [models] phase: the two-tower retriever of examples/train_retriever.py
#: at its "100m" size (the published two-tower-retrieval widths, vocab cut
#: to 150,000 rows a table), its world (64 clusters, 10,000 users) with
#: 1,000,000 items, trained 300 steps at batch 8,192 with a preemption at
#: step 150, then its item tower's embeddings of every item indexed
N_CLUSTERS, RETRIEVER_USERS, RETRIEVER_ITEMS = 64, 10_000, 1_000_000
RETRIEVER_STEPS, RETRIEVER_BATCH, RETRIEVER_EVAL_USERS = 300, 8_192, 2_048
RETRIEVER_CKPT_EVERY, RETRIEVER_PREEMPT_AT, RETRIEVER_LOG_EVERY = 100, 150, 50
#: the compressed index's recall@10 of the float top-10 must reach this: two
#: thirds of the 0.1522 an H100 gave (cluster precision saturates at 1.0 in
#: this world, so it cannot show a degraded index)
RETRIEVER_RECALL_FLOOR = 0.10
#: train steps and forward repeats timed at each FULL-config shape
FULL_TRAIN_STEPS, FULL_FWD_REPS = 3, 3
#: the card vs the CPU, the CPU tests' bars (tests/test_torch_models_*):
#: losses within 1e-3 relative, outputs at rtol 1.6e-2 and atol
#: 1.6e-2·max(1, max|CPU output|) (bf16 activations; per node for SchNet's
#: graph task, whose energies and MSE take the bars the node outputs imply)
XDEV_LOSS_RTOL, XDEV_BF16_TOL = 1e-3, 1.6e-2
#: the LMs' gradient leaves, card against CPU (tests/test_torch_models_lm)
XDEV_GRAD_COS = 0.999
#: SchNet's graph-task loss on each device within this of its f64
#: evaluation (the CPU tests' bar on that MSE against repro)
XDEV_GRAPH_MSE_RTOL = 1e-2


def retriever_config():
    from repro_torch.configs.base import TwoTowerConfig

    return TwoTowerConfig(embed_dim=256, tower_mlp=(1024, 512, 256),
                          n_user_features=8, n_item_features=8,
                          user_vocab=150_000, item_vocab=150_000)


def feature_ids(entities, cluster_of, n_features: int, vocab: int):
    """examples/train_retriever.py's features on the card: feature 0 is the
    entity's cluster, the rest are hashes of its id into the vocab."""
    cols = [cluster_of[entities]]
    for j in range(1, n_features):
        cols.append((entities * 31 + j * 7919) % (vocab - N_CLUSTERS)
                    + N_CLUSTERS)
    return torch.stack(cols, dim=1).to(torch.int32)


def retriever_world(seed: int) -> dict:
    """Users and items with a cluster each (the example's make_world, drawn
    with numpy), on the card, with the items grouped by cluster."""
    rng = np.random.default_rng(seed)
    users = torch.from_numpy(rng.integers(0, N_CLUSTERS, RETRIEVER_USERS))
    items = torch.from_numpy(rng.integers(0, N_CLUSTERS, RETRIEVER_ITEMS))
    users, items = users.cuda(), items.cuda()
    counts = torch.bincount(items, minlength=N_CLUSTERS)
    return {"user_cluster": users, "item_cluster": items,
            "by_cluster": torch.argsort(items, stable=True),
            "counts": counts, "offsets": torch.cumsum(counts, 0) - counts}


def retriever_batch(world: dict, cfg, step: int, seed: int) -> dict:
    """Step ``step``'s interactions: users uniform, each with a positive
    item from its own cluster (the example's stream), drawn on the card
    from a generator seeded by the step, so a resumed run sees the same
    batches."""
    gen = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + step)
    users = torch.randint(0, RETRIEVER_USERS, (RETRIEVER_BATCH,),
                          generator=gen, device="cuda")
    c = world["user_cluster"][users]
    u = torch.rand(RETRIEVER_BATCH, generator=gen, device="cuda")
    pos = world["offsets"][c] + torch.minimum(
        (u * world["counts"][c]).long(), world["counts"][c] - 1)
    items = world["by_cluster"][pos]
    return {"user_ids": feature_ids(users, world["user_cluster"],
                                    cfg.n_user_features, cfg.user_vocab),
            "item_ids": feature_ids(items, world["item_cluster"],
                                    cfg.n_item_features, cfg.item_vocab)}


def _train_leg(step_fn, state, world, cfg, seed, total, tag, ck=None,
               handler=None, preempt_at=None):
    """``run_train_loop`` from ``state``'s step to ``total`` (a checkpoint
    every RETRIEVER_CKPT_EVERY steps with ``ck``; a SIGTERM while step
    ``preempt_at`` runs); returns the state, the loss history and the ms a
    step of each logged interval."""
    from repro_torch.train import trainer

    start = int(state["step"])
    marks = [(start, time.perf_counter())]

    def batches():
        for s in range(start, total):
            if s + 1 == preempt_at:
                # the preemption notice arrives while step s + 1 runs
                os.kill(os.getpid(), signal.SIGTERM)
            yield retriever_batch(world, cfg, s, seed)

    def log(msg):
        if msg.startswith("step "):
            n = int(msg.split()[1].rstrip(":"))
            marks.append((n, time.perf_counter()))   # float(loss) synced
            (n0, t0), (n1, t1) = marks[-2], marks[-1]
            ms = (t1 - t0) * 1e3 / (n1 - n0)
            print(f"[models] {tag}{msg}; {ms:.2f} ms a "
                  f"step, {RETRIEVER_BATCH / ms * 1e3:.0f} examples/s")
        else:
            print(f"[models] {msg}")

    cfg_loop = trainer.TrainLoopConfig(
        total_steps=total, log_every=RETRIEVER_LOG_EVERY,
        checkpoint_every=RETRIEVER_CKPT_EVERY if ck else 0)
    state, hist = trainer.run_train_loop(
        step_fn, state, batches(), cfg_loop, checkpointer=ck,
        preemption=handler, log_fn=log)
    intervals = [(b[0] - a[0], (b[1] - a[1]) * 1e3 / (b[0] - a[0]))
                 for a, b in zip(marks, marks[1:])]
    return state, hist, intervals


def _leaves_equal(a, b) -> tuple[bool, float]:
    from repro_torch.train.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    same = len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))
    err = max(float((x.double() - y.double()).abs().max())
              for x, y in zip(la, lb) if x.numel())
    return same, err


def train_retriever(args, world, cfg):
    """300 steps uninterrupted, then the same 300 with a SIGTERM at step
    150: emergency checkpoint, restore into a fresh state (bit for bit),
    resume.  Returns the resumed run's final state."""
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.fault_tolerance import PreemptionHandler
    from repro_torch.train.optimizer import tree_num_params, tree_size_bytes

    spec = R.two_tower_spec(cfg)
    tx = O.adamw(O.cosine_schedule(3e-3, 20, RETRIEVER_STEPS),
                 weight_decay=1e-4, max_grad_norm=1.0)
    step_fn = trainer.make_train_step(
        lambda p, b: R.two_tower_loss(p, b, cfg), tx)

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        return trainer.init_state(
            gen, lambda g: L.init_params(g, spec, "cuda"), tx)

    state = fresh()
    print(f"[models] two-tower retriever: {tree_num_params(state['params'])} "
          f"params (embed {cfg.embed_dim}, towers {cfg.tower_mlp}, "
          f"{cfg.n_user_features} + {cfg.n_item_features} features, vocab "
          f"{cfg.user_vocab} each), state {tree_size_bytes(state) / 1e9:.3f} "
          f"GB; adamw(cosine 3e-3, warmup 20), weight decay 1e-4, clip 1.0, "
          f"batch {RETRIEVER_BATCH}, {RETRIEVER_STEPS} steps")
    ref, ref_hist, ref_ms = _train_leg(step_fn, state, world, cfg, args.seed,
                                       RETRIEVER_STEPS, tag="uninterrupted ")
    del state
    steady = [ms for _, ms in ref_ms[1:]]
    print(f"[models] uninterrupted: {statistics.median(steady):.2f} ms a step "
          f"(median of the {len(steady)} intervals after the first), "
          f"{RETRIEVER_BATCH / statistics.median(steady) * 1e3:.0f} "
          f"examples/s; first interval {ref_ms[0][1]:.2f} ms a step")

    handler = PreemptionHandler()
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp, keep=2)
        try:
            state, _, _ = _train_leg(step_fn, fresh(), world, cfg, args.seed,
                                     RETRIEVER_STEPS, ck=ck, handler=handler,
                                     preempt_at=RETRIEVER_PREEMPT_AT,
                                     tag="preempted run ")
        finally:
            handler.uninstall()
        ck.wait()
        saved = int(state["step"])
        like = trainer.abstract_state(L.abstract_params(spec), tx)
        t0 = time.perf_counter()
        restored = ck.restore(like, device="cuda")
        torch.cuda.synchronize()
        same, err = _leaves_equal(restored, state)
        print(f"[models] SIGTERM at step {RETRIEVER_PREEMPT_AT}: stopped at "
              f"step {saved}, checkpoints {ck.all_steps()} (LATEST "
              f"{ck.latest_step()}); restored into a fresh state in "
              f"{time.perf_counter() - t0:.2f} s: "
              f"{'bit for bit' if same else f'DIFFERS (max {err:.3g})'}")
        if not (saved == RETRIEVER_PREEMPT_AT == ck.latest_step() and same):
            raise AssertionError("the emergency checkpoint does not restore "
                                 "the preempted state")
        del state
        resumed, _, _ = _train_leg(step_fn, restored, world, cfg,
                                      args.seed, RETRIEVER_STEPS, ck=ck,
                                      tag="resumed ")
        ck.wait()
    same, err = _leaves_equal(resumed, ref)
    losses = [(h["step"], round(h["loss"], 4)) for h in ref_hist]
    print(f"[models] resumed at step {RETRIEVER_STEPS} vs uninterrupted: "
          f"{'bit for bit' if same else f'max |diff| {err:.3g}'}; loss "
          f"history {losses}")
    if not same:
        # the step is deterministic on the card (F.embedding's sorted
        # backward, cuBLAS, no atomics): a difference is a fault
        raise AssertionError("resumed training differs from the "
                             "uninterrupted run")
    if not ref_hist[-1]["loss"] < 0.75 * np.log(RETRIEVER_BATCH):
        # an untrained model's in-batch softmax CE is ln(batch)
        raise AssertionError("the retriever did not learn")
    return resumed["params"]


def _cluster_precision(world, users, top_ids) -> float:
    got = world["item_cluster"][top_ids.long()]
    return float((got == world["user_cluster"][users][:, None]).float().mean())


def retriever_index(args, world, cfg, params) -> dict[str, int]:
    """The frozen item tower embeds every item; the 2,048 eval users are
    searched exactly (float) and through the compressed index built with
    [CenterNorm, PCA(128), CenterNorm, Int8Quantizer] (one fused_quantize
    encode, int8_ip + topk_blocks search).  Returns the part's launches."""
    from repro_torch.core import (CenterNorm, CompressionPipeline,
                                  Int8Quantizer, PCA)
    from repro_torch.models import recsys as R
    from repro_torch.retrieval import (CompressedIndex, DenseIndex,
                                       recall_at_k)
    from repro_torch.retrieval.scorers import (apply_float_stages,
                                               encode_storage)
    from repro_torch.utils import chunked

    t0 = time.perf_counter()
    with torch.no_grad():
        items = torch.arange(RETRIEVER_ITEMS, device="cuda")
        emb = torch.cat([R.item_embedding(params, feature_ids(
            items[s:e], world["item_cluster"], cfg.n_item_features,
            cfg.item_vocab), cfg) for s, e in chunked(RETRIEVER_ITEMS,
                                                      131_072)])
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
        users = torch.randint(0, RETRIEVER_USERS, (RETRIEVER_EVAL_USERS,),
                              generator=gen, device="cuda")
        queries = R.user_embedding(params, feature_ids(
            users, world["user_cluster"], cfg.n_user_features,
            cfg.user_vocab), cfg)
    torch.cuda.synchronize()
    print(f"[models] item tower: {tuple(emb.shape)} f32 candidate "
          f"embeddings of every item in {time.perf_counter() - t0:.2f} s; "
          f"{RETRIEVER_EVAL_USERS} users")
    if not bool(torch.isfinite(emb).all() and torch.isfinite(queries).all()):
        raise AssertionError("non-finite tower outputs")

    reset_launch_counts()
    exact = DenseIndex(emb, device="cuda")
    _, exact_ids, exact_secs = _search_batches(exact, queries, K)
    p_exact = _cluster_precision(world, users, exact_ids)
    pipe = CompressionPipeline([CenterNorm(), PCA(128), CenterNorm(),
                                Int8Quantizer()])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = CompressedIndex.build(
        emb, queries, pipe, rng=torch.Generator(device="cuda").manual_seed(
            args.seed), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    vals, ids, secs = _search_batches(index, queries, K)
    counts = launch_counts()
    _checked("retriever 24x recipe", vals, ids, RETRIEVER_EVAL_USERS,
             RETRIEVER_ITEMS)
    for kern in ("fused_quantize", "int8_ip", "topk_blocks"):
        if counts[kern] < 1:
            raise AssertionError(f"{kern} never launched on the retriever's "
                                 "index")
    p_comp = _cluster_precision(world, users, ids)
    overlap = recall_at_k(ids, exact_ids)
    ratio = emb.numel() * emb.element_size() / index.nbytes
    print(f"[models] exact float search: {latency(exact_secs, len(users))}; "
          f"cluster precision@{K} {p_exact:.4f} (chance "
          f"{1 / N_CLUSTERS:.4f})")
    print(f"[models] [CenterNorm, PCA(128), CenterNorm, Int8Quantizer] "
          f"({emb.shape[1]} -> {index.storage.shape[1]} dims + int8): built "
          f"in {build_s:.2f} s, "
          f"{ratio:.1f}x smaller than f32; {latency(secs, len(users))}; "
          f"cluster precision@{K} {p_comp:.4f}, "
          f"{p_comp / max(p_exact, 1e-9):.4f} of the float search's; "
          f"recall@{K} of the float search's top-{K} {overlap:.4f}")

    # after the count: the encode's time, then each kernel against its
    # plain version at the main path's bars
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, _ = encode_storage(index.float_stages, index.scorer, emb)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    plain = index.scorer.encode_docs(
        apply_float_stages(index.float_stages, emb, "docs"))
    ok_codes, worst, share = codes_agree(index.storage, plain)
    ok_rank, err = ranking_agrees(index.search(queries[:BATCH], K),
                                  plain_search(index, queries[:BATCH], K),
                                  exact=False)
    print(f"[models] encode (fused_quantize) {encode_s:.3f} s, "
          f"{RETRIEVER_ITEMS / encode_s:.0f} items/s, codes "
          f"{'equal' if torch.equal(codes, index.storage) else 'DIFFER'} "
          f"on a second pass; vs the staged plain encode: max diff {worst}, "
          f"share differing {share:.3g} "
          f"({'within' if ok_codes else 'OUTSIDE'} the bar); int8_ip + "
          f"topk_blocks search vs the plain versions: "
          f"{'ok' if ok_rank else 'MISMATCH'} (max_abs_err {err:.3g})")
    if not (ok_codes and ok_rank and torch.equal(codes, index.storage)):
        raise AssertionError("the retriever's index disagrees with the "
                             "plain versions of its kernels")
    if overlap < RETRIEVER_RECALL_FLOOR:
        raise AssertionError(f"the compressed index's recall@{K} "
                             f"{overlap:.4f} is under the floor "
                             f"{RETRIEVER_RECALL_FLOOR}")
    print(f"[models] retriever index launches {counts}")
    return counts


def floor_bytes(model, specs: dict, train: bool, n_params: int,
                held: bool) -> tuple[float, str]:
    """An exact lower bound on the bytes a shape's step or forward must
    allocate beside what is already held, and what it is made of: the
    batch; for a train step the gradients and the old and new Adam moments
    (20 B a parameter, alive together when ``scale_by_adam`` returns),
    plus the parameters themselves where they are not ``held`` yet; for
    SchNet the (E, n_rbf) radial basis in f32 and the bf16 copy that the
    first filter reads, alive together."""
    from repro_torch.configs.base import SchNetConfig

    parts = [("batch", sum(t.numel() * t.element_size()
                           for t in specs.values()))]
    if train:
        parts.append(("grads and old and new Adam moments", 20 * n_params))
    if not held:
        parts.append(("params", 4 * n_params))
    if isinstance(model, SchNetConfig):
        e = specs["edge_index"].shape[1]
        parts.append((f"rbf ({e}, {model.n_rbf}) f32 + bf16",
                      6 * e * model.n_rbf))
    return float(sum(b for _, b in parts)), ", ".join(
        f"{name} {b / 1e9:.1f} GB" for name, b in parts)


def _timed(fn, reps: int) -> tuple[list[float], object]:
    out, ms = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def _ms(ms) -> str:
    return " / ".join(f"{x:.2f}" for x in ms) + " ms"


def full_config_runs(args) -> None:
    """FULL configs on the card: the two-tower's tables initialised and its
    serving and candidate forwards run; FM, DIN and DCN-v2 train steps at
    train_batch and their forwards at the serving and candidate shapes;
    SchNet train steps at each GNN shape.  A shape whose exact lower bound
    of bytes exceeds the free memory is printed with it and skipped."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.batches import input_specs, make_batch, shape_dims
    from repro_torch.models import gnn as G
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.retrieval.topk import topk_score_then_id
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer

    recsys = {  # arch → (spec, loss, score, candidate scores)
        "two-tower-retrieval": (R.two_tower_spec, R.two_tower_loss,
                                R.two_tower_score, R.retrieval_scores),
        "fm": (R.fm_spec, R.fm_loss, R.fm_logits, R.fm_candidate_scores),
        "din": (R.din_spec, R.din_loss, R.din_logits,
                R.din_candidate_scores),
        "dcn-v2": (R.dcn_spec, R.dcn_loss, R.dcn_logits,
                   R.dcn_candidate_scores),
    }
    rng = np.random.default_rng(args.seed)
    gb = 1e9

    def fits(tag, arch, model, shape, train, n_params, held) -> bool:
        specs = input_specs(arch, shape, reduced=False)
        need, parts = floor_bytes(model, specs, train, n_params, held)
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        if need > free:
            print(f"[models] {tag} {shape.name} {shape_dims(shape, False)}: "
                  f"skipped, needs at least {need / gb:.1f} GB ({parts}) "
                  f"of {free / gb:.1f} GB free")
            return False
        return True

    def train_steps(tag, arch, shape, params, loss_fn):
        tx = O.OptimizerConfig(lr=1e-3, total_steps=10000).build()
        state = {"params": params, "opt": tx.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        step = trainer.make_train_step(loss_fn, tx)
        batch = make_batch(rng, arch, shape, reduced=False, device="cuda")
        losses = []

        def one():
            nonlocal state
            state, m = step(state, batch)
            losses.append(m["loss"])

        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms, _ = _timed(one, FULL_TRAIN_STEPS)
        vals = [float(v) for v in losses]
        if not all(np.isfinite(vals)):
            raise AssertionError(f"{tag} {shape.name}: non-finite loss")
        print(f"[models] {tag} {shape.name} train {FULL_TRAIN_STEPS} steps "
              f"(batch {shape_dims(shape, False)}): {_ms(ms)}; loss "
              f"{[round(v, 4) for v in vals]}; peak "
              f"{torch.cuda.max_memory_allocated() / gb:.2f} GB allocated "
              f"({held / gb:.2f} GB before the steps)")
        return state["params"]

    for name, (spec_fn, loss, score, cand) in recsys.items():
        arch = get_arch(name)
        cfg = arch.model
        spec = spec_fn(cfg)
        n_params = L.param_count(spec)
        ms, params = _timed(lambda: L.init_params(
            torch.Generator(device="cuda").manual_seed(args.seed), spec,
            "cuda"), 1)
        print(f"[models] {name} FULL: {n_params} params "
              f"({n_params * 4 / gb:.2f} GB f32), initialised on the card in "
              f"{_ms(ms)}")
        for shape in arch.shapes:
            kind = shape.kind
            if kind == "recsys_train":
                if not fits(name, arch, cfg, shape, True, n_params, True):
                    total = torch.cuda.get_device_properties(0).total_memory
                    print(f"[models] {name}: params, grads and two Adam "
                          f"moments alone take 16 B x {n_params} = "
                          f"{16 * n_params / gb:.1f} GB of the card's "
                          f"{total / gb:.1f} GB, and the functional "
                          f"optimizer holds old and new moments at once "
                          f"(24 B a parameter, {24 * n_params / gb:.1f} "
                          "GB): not trained at the full vocab")
                    continue
                params = train_steps(name, arch, shape, params,
                                     lambda p, b, f=loss, c=cfg: f(p, b, c))
                continue
            if not fits(name, arch, cfg, shape, False, n_params, True):
                continue
            batch = make_batch(rng, arch, shape, reduced=False, device="cuda")
            with torch.no_grad():
                if kind == "recsys_serve":
                    ms, out = _timed(lambda: score(params, batch, cfg),
                                     FULL_FWD_REPS)
                else:
                    def retrieve():
                        s = cand(params, batch, cfg)
                        s = s[None, :] if s.ndim == 1 else s
                        ids = torch.arange(s.shape[-1], dtype=torch.int32,
                                           device="cuda").expand(s.shape)
                        return topk_score_then_id(s, ids, min(100,
                                                              s.shape[-1]))
                    ms, out = _timed(retrieve, FULL_FWD_REPS)
                    out = out[0]
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} {shape.name}: non-finite output")
            print(f"[models] {name} {shape.name} forward "
                  f"{shape_dims(shape, False)} -> {tuple(out.shape)}"
                  f"{' top-100' if kind == 'retrieval_cand' else ''}: "
                  f"{_ms(ms)}")
            del batch, out
        del params
        torch.cuda.empty_cache()

    arch = get_arch("schnet")
    for shape in arch.shapes:
        dims = shape_dims(shape, False)
        if shape.kind in ("gnn_full", "gnn_mini"):
            cfg = dataclasses.replace(arch.model, d_feat_in=dims.get(
                "d_feat", 602), task="node", n_classes=64)
        else:
            cfg = dataclasses.replace(arch.model, d_feat_in=0, task="graph")
        if not fits("schnet", arch, cfg, shape, True,
                    L.param_count(G.schnet_spec(cfg)), False):
            continue
        params = G.init(torch.Generator(device="cuda").manual_seed(
            args.seed), cfg, "cuda")
        train_steps(f"schnet ({cfg.task} task)", arch, shape, params,
                    lambda p, b, c=cfg: G.loss_fn(p, b, c))
        torch.cuda.empty_cache()


def _graph_bars(params, batch, cfg, node_out) -> tuple:
    """SchNet's graph task on the CPU: the energies and, from the per-node
    outputs they sum, each energy's bar (rtol·|E| + atol·Σ|node output|)
    and the bar on the MSE that those bars imply."""
    from repro_torch.models import gnn as G
    from repro_torch.models.recsys import segment_sum

    energy = G.forward(params, batch, cfg)
    bar = XDEV_BF16_TOL * (energy.abs() + segment_sum(
        node_out.abs(), batch["graph_ids"], energy.shape[0]))
    err = (energy - batch["targets"]).abs()
    return energy, bar, float(torch.mean(2 * err * bar + bar * bar))


def schnet_loss_probe(params, batch, cfg, repeats: int = 5
                      ) -> tuple[str, float]:
    """SchNet's graph-task loss on one batch, beside the CPU's f64
    evaluation of the same function (every bf16 step in f64): the card's
    bf16 loss over ``repeats`` runs (its atomic bf16 segment sums add in
    a varying order) and the CPU's, then both with the segment sums in
    f32, so the line shows how far each bf16 evaluation sits from the f64
    one and how much of that the segment sums make.  Returns the line and
    the largest relative distance of a bf16 loss from the f64 one."""
    from unittest import mock

    from repro_torch.models import gnn as G
    from repro_torch.models import layers as L
    from repro_torch.models.recsys import segment_sum
    from repro_torch.train.optimizer import tree_map

    dense = L.dense
    card_p, card_b = (tree_map(lambda x: x.cuda(), t)
                      for t in (params, batch))

    def losses():
        with torch.no_grad():
            card = [float(G.loss_fn(card_p, card_b, cfg)[0])
                    for _ in range(repeats)]
            return card, float(G.loss_fn(params, batch, cfg)[0])

    def f32_sums(x, ids, n):
        return segment_sum(x.float(), ids, n).to(x.dtype)

    card, cpu = losses()
    with mock.patch.object(G, "segment_sum", f32_sums):
        card32, cpu32 = losses()
    with mock.patch.object(G, "BF16", torch.float64), mock.patch.object(
            L, "dense", lambda p, x, compute_dtype=None: dense(
                p, x, torch.float64)), torch.no_grad():
        f64 = float(G.loss_fn(params, batch, cfg)[0])

    def rel(v):
        return f"{v:.5f} ({(v - f64) / f64:+.2e})"

    worst = max(abs(v - f64) / f64 for v in card + [cpu])
    return (f"f64 evaluation on the CPU {f64:.5f}; relative to it: bf16 "
            f"segment sums: card {rel(min(card))} … {rel(max(card))} over "
            f"{repeats} runs, CPU {rel(cpu)}; f32 segment sums: card "
            f"{rel(min(card32))} … {rel(max(card32))}, CPU {rel(cpu32)}"
            ), worst


def cross_device(args) -> None:
    """Each model at its REDUCED config, one batch, from the same
    parameters: loss and outputs on the card against the CPU, at the CPU
    tests' bars.  SchNet's graph task is held per node, per energy, by
    the MSE bar its energy bars imply, and each device's loss against the
    f64 evaluation (``schnet_loss_probe``)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.batches import make_batch
    from repro_torch.models import gnn as G
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import tree_map

    def per_node(p, b, c):
        """The graph task with every node its own graph: the per-node
        outputs that the energies sum."""
        n = b["positions"].shape[0]
        ids = torch.arange(n, dtype=torch.int32, device=b["positions"].device)
        return G.forward(p, dict(b, graph_ids=ids), c, n_graphs=n)

    cases = [("two-tower-retrieval", "train_batch", R.two_tower_spec,
              R.two_tower_loss, R.two_tower_score),
             ("fm", "train_batch", R.fm_spec, R.fm_loss, R.fm_logits),
             ("din", "train_batch", R.din_spec, R.din_loss, R.din_logits),
             ("dcn-v2", "train_batch", R.dcn_spec, R.dcn_loss, R.dcn_logits),
             ("schnet", "molecule", G.schnet_spec, G.loss_fn, per_node),
             ("schnet", "full_graph_sm", G.schnet_spec, G.loss_fn,
              G.forward)]
    on_card = lambda t: tree_map(lambda x: x.cuda(), t)
    report = []
    for name, shape_name, spec_fn, loss_fn, out_fn in cases:
        arch = get_arch(name)
        shape = arch.shape(shape_name)
        cfg = arch.reduced
        if name == "schnet" and shape.kind == "gnn_full":
            cfg = dataclasses.replace(cfg, task="node", n_classes=64,
                                      d_feat_in=shape.dims["d_feat"])
        params = L.init_params(torch.Generator().manual_seed(args.seed),
                               spec_fn(cfg), "cpu")
        batch = make_batch(np.random.default_rng(args.seed), arch, shape,
                           reduced=True, device="cpu")
        with torch.no_grad():
            lc, _ = loss_fn(params, batch, cfg)
            lg, _ = loss_fn(on_card(params), on_card(batch), cfg)
            oc = out_fn(params, batch, cfg)
            og = out_fn(on_card(params), on_card(batch), cfg).cpu()
            loss_bar = XDEV_LOSS_RTOL * abs(float(lc))
            energies_ok = True
            if out_fn is per_node:
                energy, bar, loss_bar = _graph_bars(params, batch, cfg, oc)
                e_gpu = G.forward(on_card(params), on_card(batch), cfg)
                energies_ok = bool(((e_gpu.cpu() - energy).abs()
                                    <= bar).all())
        scale = max(1.0, float(oc.abs().max()))
        # the atol each output needs beside rtol·|CPU output|
        need = max(0.0, float(((og - oc).abs()
                              - XDEV_BF16_TOL * oc.abs()).max()))
        loss_err = abs(float(lg) - float(lc))
        ok = (loss_err <= loss_bar and need <= XDEV_BF16_TOL * scale
              and energies_ok and bool(torch.isfinite(og).all()))
        report.append(f"{name}:{shape_name} loss {float(lg):.5f} vs "
                      f"{float(lc):.5f} (|diff| {loss_err:.2g} of "
                      f"{loss_bar:.2g}), outputs {tuple(oc.shape)} need atol "
                      f"{need:.3g} of {XDEV_BF16_TOL * scale:.3g}"
                      + ("" if out_fn is not per_node else
                         f", energies {'within' if energies_ok else 'OUTSIDE'}"
                         " their bars"))
        if out_fn is per_node:
            line, worst = schnet_loss_probe(params, batch, cfg)
            ok = ok and worst <= XDEV_GRAPH_MSE_RTOL
            print(f"[models] {name}:{shape_name} loss, {line} (bar "
                  f"{XDEV_GRAPH_MSE_RTOL})")
        if not ok:
            print("[models] cuda vs cpu: " + "; ".join(report))
            raise AssertionError(f"{name} {shape_name}: the card and the CPU "
                                 "disagree")
    print(f"[models] cuda vs cpu (reduced configs, outputs rtol "
          f"{XDEV_BF16_TOL}): " + "; ".join(report))


def phase_models(args) -> dict[str, int]:
    """The model path: the retriever trained with a preemption and resumed,
    its item index compressed and searched through the kernels, the FULL
    configs' steps and forwards, and the card against the CPU.  Returns
    the launch counts of the retriever's index."""
    t_phase = time.perf_counter()
    cfg = retriever_config()
    world = retriever_world(args.seed)
    params = train_retriever(args, world, cfg)
    counts = retriever_index(args, world, cfg, params)
    del params
    torch.cuda.empty_cache()
    t_full = time.perf_counter()
    full_config_runs(args)
    print(f"[models] FULL configs {time.perf_counter() - t_full:.1f} s")
    cross_device(args)
    print(f"[models] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return counts


#: the [lm] phase: the five LM architectures (src/repro_torch/configs)
LM_ARCHS = ("phi4-mini-3.8b", "qwen1.5-4b", "qwen3-moe-30b-a3b", "dbrx-132b",
            "nemotron-4-340b")
#: greedy decode steps after a REDUCED prompt, card against CPU
LM_XDEV_DECODE = 8
#: greedy decode steps after the 32k prompt; decode steps timed in
#: decode_32k and long_500k; long_500k's prompt (its 500k prefill, the
#: quadratic case, is skipped as configs/base.py's shape note says)
LM_PROMPT_DECODE, LM_TIMED_DECODE, LM_LONG_PROMPT = 32, 8, 4_096
LM_TRAIN_STEPS = 3
#: bytes kept free beside an LM shape's bound: the allocator's slack,
#: cuBLAS workspaces and the tensors no part of the bound names; and, for
#: a train step, 8 B more a parameter (a phi4-mini step at 6 layers held
#: over 81.6 GB against its 73.3 GB bound: the functional optimizer's
#: transients beyond the ones the bound counts)
LM_SLACK, LM_TRAIN_HEADROOM = 8e9, 8


@contextlib.contextmanager
def lm_f64_evaluation():
    """The port's LM evaluated in f64 on the CPU: every bf16 step and every
    f32 upcast (``Tensor.float``) becomes f64."""
    from unittest import mock

    from repro_torch.models import transformer as PT

    with mock.patch.object(PT, "BF16", torch.float64), mock.patch.object(
            torch.Tensor, "float", lambda self, *a, **k: self.double()):
        yield


def lm_value_and_grad(params, batch, cfg):
    from repro_torch.models import transformer as PT
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = PT.loss_fn(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.double().cpu() for g in grads]


def _cosines(a, b) -> np.ndarray:
    return np.array([float((x.flatten() @ y.flatten())
                           / (x.norm() * y.norm())) for x, y in zip(a, b)])


def lm_cross_device(args) -> list[str]:
    """Each arch's REDUCED config, one set of parameters, card against CPU
    at the CPU tests' bars: a train step's loss (1e-3 relative) and
    gradients (each leaf at cosine ≥ 0.999, or, where the CPU's bf16 leaf
    lies further than that from the CPU's f64 evaluation, as close to the
    CPU's as that); ``forward``'s logits (rtol 1.6e-2, atol
    1.6e-2·max|logits|); a prompt's ``prefill`` and LM_XDEV_DECODE greedy
    ``decode_step``s fed the CPU's tokens: logits at the same bar, and the
    card's greedy token equal to the CPU's wherever the CPU's top-2 margin
    exceeds twice that atol.  Returns the report."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.batches import make_batch
    from repro_torch.models import transformer as PT
    from repro_torch.train.optimizer import tree_map

    on_card = lambda t: tree_map(lambda x: x.cuda(), t)
    report = []
    for name in LM_ARCHS:
        arch = get_arch(name)
        cfg = arch.reduced
        params = PT.init(torch.Generator().manual_seed(args.seed), cfg, "cpu")
        rng = np.random.default_rng(args.seed)
        batch = make_batch(rng, arch, arch.shape("train_4k"), device="cpu")
        prompt = make_batch(rng, arch, arch.shape("prefill_32k"),
                            device="cpu")["tokens"]
        lc, gc = lm_value_and_grad(params, batch, cfg)
        lg, gg = lm_value_and_grad(on_card(params), on_card(batch), cfg)
        cos = _cosines(gg, gc)
        bar = np.full_like(cos, XDEV_GRAD_COS)
        if cos.min() < XDEV_GRAD_COS:
            with lm_f64_evaluation():
                _, truth = lm_value_and_grad(
                    tree_map(lambda x: x.double(), params), batch, cfg)
            bar = np.minimum(bar, _cosines(gc, truth))
        with torch.no_grad():
            fc, _ = PT.forward(params, batch["tokens"], cfg)
            fg, _ = PT.forward(on_card(params), batch["tokens"].cuda(), cfg)
            logit_need = _atol_need(fg.cpu(), fc)
            steps = []
            cache_len = prompt.shape[1] + LM_XDEV_DECODE
            lgc, cc = PT.prefill(params, prompt, cfg, cache_len=cache_len)
            lgg, cg = PT.prefill(on_card(params), prompt.cuda(), cfg,
                                 cache_len=cache_len)
            for i in range(LM_XDEV_DECODE + 1):
                steps.append((lgc, lgg.cpu()))
                if i == LM_XDEV_DECODE:
                    break
                tok = torch.argmax(lgc, dim=-1).to(torch.int32)
                pos = prompt.shape[1] + i
                lgc, cc = PT.decode_step(params, cc, tok, pos, cfg)
                lgg, cg = PT.decode_step(on_card(params), cg, tok.cuda(), pos,
                                         cfg)
        need = max(_atol_need(g, c) for c, g in steps)
        flips = 0
        for c, g in steps:
            atol = XDEV_BF16_TOL * float(c.abs().max())
            top2 = torch.topk(c, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * atol
            flips += int((sure & (torch.argmax(g, -1) != torch.argmax(c, -1))
                          ).sum())
        f_bar = XDEV_BF16_TOL * float(fc.abs().max())
        s_bar = min(XDEV_BF16_TOL * float(c.abs().max()) for c, _ in steps)
        ok = (abs(lg - lc) <= XDEV_LOSS_RTOL * abs(lc)
              and bool((cos >= bar).all()) and logit_need <= f_bar
              and need <= s_bar and flips == 0)
        report.append(
            f"{name}: loss {lg:.5f} vs {lc:.5f}; gradient leaves' cosine "
            f"min {cos.min():.5f} (bar min {bar.min():.5f}); logits need "
            f"atol {logit_need:.3g} of {f_bar:.3g}; prefill + "
            f"{LM_XDEV_DECODE} greedy steps need atol {need:.3g} of "
            f"{s_bar:.3g}, sure greedy tokens that differ {flips}")
        if not ok:
            print("[lm] cuda vs cpu: " + "; ".join(report))
            raise AssertionError(f"{name}: the card and the CPU disagree")
    return report


def _atol_need(got, want) -> float:
    """The atol ``got`` needs beside rtol 1.6e-2·|want|."""
    return max(0.0, float(((got - want).abs()
                           - XDEV_BF16_TOL * want.abs()).max()))


def rope_ulps() -> str:
    """cos/sin of RoPE's angles on the card against the CPU's, at the last
    positions of the 32k and 500k shapes (head dim 128)."""
    from repro_torch.models.layers import rope_angles

    n = 524_288
    cc, sc = rope_angles(128, n, device="cpu")
    cg, sg = (t.cpu() for t in rope_angles(128, n, device="cuda"))
    out = []
    for pos in (32_767, n - 1):
        d = max(float((cg[pos] - cc[pos]).abs().max()),
                float((sg[pos] - sc[pos]).abs().max()))
        same = float(((cg[pos] == cc[pos]) & (sg[pos] == sc[pos])).float()
                     .mean())
        out.append(f"pos {pos}: max |card - CPU| {d:.3g}, {same:.3f} of "
                   "the 64 frequencies equal")
    whole = max(float((cg - cc).abs().max()), float((sg - sc).abs().max()))
    return "; ".join(out) + f"; over all {n} positions {whole:.3g}"


def lm_bound(cfg, shape, b: int) -> tuple[float, list]:
    """An exact lower bound of the bytes that an LM shape's request holds
    at one moment, and its parts.  Training, when ``scale_by_adam`` forms
    its updates: the f32 parameters, the gradients and their clipped copy,
    the old and new Adam moments, and Adam's denominator, one temporary
    and the updates (40 B a parameter in all).  Serving: the f32
    parameters and the bf16 KV caches, with the largest of the prompt's
    attention (one q chunk's tile: the f32 scores, their softmax and its
    bf16 copy), a MoE layer over the prompt (its dispatch buffer and
    expert activations: for SwiGLU the input and gate products, two of
    σ's temporaries and σ itself), and a decode step's attention (a
    layer's K in f32, and above batch 1 that copy laid out for the
    product)."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as PT
    from repro_torch.models.layers import param_count

    n = param_count(PT.lm_spec(cfg))
    hd, kv, h = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads
    s = shape.dims["seq_len"]
    parts = [("params f32", 4 * n)]
    if shape.kind == "lm_train":
        parts += [("gradients and their clipped copy", 8 * n),
                  ("old and new Adam moments", 16 * n),
                  ("Adam's denominator, a temporary and the updates",
                   12 * n)]
        return float(sum(v for _, v in parts)), parts
    prompt = (s if shape.kind == "lm_prefill" else
              LM_LONG_PROMPT if shape.name == "long_500k" else 0)
    cache_len = s + LM_PROMPT_DECODE if shape.kind == "lm_prefill" else s
    parts.append(("KV caches bf16", 4 * cfg.n_layers * b * cache_len * kv
                  * hd))
    decode = ("a decode step's K operand",
              (8 if b > 1 else 4) * b * cache_len * kv * hd)
    moments = [decode]
    if prompt:
        moments.append(("prompt attention tile", 10 * b * h
                        * A._q_chunk(cfg, prompt) * prompt))
    if prompt and cfg.moe:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = int(cfg.moe.capacity_factor * b * prompt * k / e)
        acts = 5 if cfg.ffn == "swiglu" else 2
        moments.append(("MoE dispatch buffer and expert activations",
                        2 * e * cap * (cfg.d_model + acts * cfg.d_ff)))
    parts.append(max(moments, key=lambda m: m[1]))
    return float(sum(v for _, v in parts)), parts


def lm_cut(cfg, shape, start_batch: int, free: float):
    """The batch and depth an LM shape runs at: the full depth at the
    largest batch ≤ ``start_batch`` whose bound fits ``free`` (less
    LM_SLACK, and LM_TRAIN_HEADROOM a parameter for a train step); at
    batch 1 (or the config's microbatch count) the depth is cut a layer
    at a time.  Returns (cut config, batch, bound, parts), the
    config None where one layer does not fit."""
    train = shape.kind == "lm_train"
    low = cfg.train_microbatches if train else 1
    for layers in range(cfg.n_layers, 0, -1):
        cut = dataclasses.replace(cfg, n_layers=layers)
        for b in range(start_batch, low - 1, -low):
            need, parts = lm_bound(cut, shape, b)
            headroom = LM_TRAIN_HEADROOM * parts[0][1] / 4 if train else 0
            if need + LM_SLACK + headroom <= free:
                return cut, b, need, parts
    need, parts = lm_bound(dataclasses.replace(cfg, n_layers=1), shape, low)
    return None, low, need, parts


def _parts(parts) -> str:
    return ", ".join(f"{name} {v / 1e9:.2f} GB" for name, v in parts)


def lm_serve(name, cfg, shape, params, b, seed) -> dict:
    """One FULL-width serving request: ``prefill_32k`` (the prompt, then
    LM_PROMPT_DECODE greedy steps), ``decode_32k`` (LM_TIMED_DECODE steps
    against a 32,768-slot cache of random rows) or ``long_500k``
    (LM_LONG_PROMPT tokens of prompt into a 524,288-slot cache, then
    LM_TIMED_DECODE greedy steps).  Returns the times, the peak and the
    logits of every step."""
    from repro_torch.models import transformer as PT

    s = shape.dims["seq_len"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"logits": []}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        if shape.name == "decode_32k":
            cache = PT.init_cache(cfg, b, s, device="cuda")
            for c in cache:
                c.normal_(generator=gen)
            tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                                device="cuda", dtype=torch.int32)
            first, steps = s - LM_TIMED_DECODE, LM_TIMED_DECODE
            out["prefill_ms"] = None
        else:
            prompt = s if shape.kind == "lm_prefill" else LM_LONG_PROMPT
            cache_len = s + LM_PROMPT_DECODE if shape.kind == "lm_prefill" \
                else s
            toks = torch.randint(0, cfg.vocab_size, (b, prompt),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = PT.prefill(params, toks, cfg, cache_len=cache_len)
            torch.cuda.synchronize()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            out["prefill_tokens"] = b * prompt
            out["logits"].append(logits)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            first = prompt
            steps = (LM_PROMPT_DECODE if shape.kind == "lm_prefill"
                     else LM_TIMED_DECODE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = PT.decode_step(params, cache, tok, first + i, cfg)
            out["logits"].append(logits)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    out["steps"] = steps
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not all(bool(torch.isfinite(x).all()) for x in out["logits"]):
        raise AssertionError(f"{name} {shape.name}: non-finite logits")
    return out


def lm_train(name, cfg, b, seq_len, seed) -> dict:
    """LM_TRAIN_STEPS ``adamw`` steps on ``b`` sequences of ``seq_len``
    tokens in the config's ``train_microbatches``; ms a step, the tokens a
    step, the losses and the peak."""
    from repro_torch.models import transformer as PT
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = PT.init(gen, cfg, "cuda")
    tx = O.adamw(3e-4, weight_decay=0.1, max_grad_norm=1.0)
    state = {"params": params, "opt": tx.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = trainer.make_train_step(lambda p, bt: PT.loss_fn(p, bt, cfg), tx,
                                   microbatches=cfg.train_microbatches)
    toks = torch.randint(0, cfg.vocab_size, (b, seq_len), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}     # make_batch's proxy
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train_4k: non-finite loss")
    return {"ms": ms, "losses": losses, "tokens": b * seq_len,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def lm_full_runs(args, smi: str) -> None:
    """Every arch × LM shape at the config's published widths, with
    parameters random from the seed, at the batch and depth ``lm_cut``
    lets fit in the free memory; long_500k's request twice, its logits
    held equal bit for bit."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as PT

    gb = 1e9
    for name in LM_ARCHS:
        arch = get_arch(name)
        cfg = arch.model
        for shape in arch.shapes:
            dims = shape.dims
            # prefill_32k and long_500k serve one prompt, decode_32k the
            # largest batch that fits, train_4k a sequence a microbatch
            start = {"decode_32k": dims["global_batch"],
                     "train_4k": cfg.train_microbatches}.get(shape.name, 1)
            torch.cuda.empty_cache()
            free = torch.cuda.mem_get_info()[0]
            cut, b, need, parts = lm_cut(cfg, shape, start, free)
            head = f"[lm] {name} {shape.name} {dims}"
            bound = f"bound {need / gb:.1f} GB ({_parts(parts)})"
            if cut is None:
                print(f"{head}: skipped at batch {b} and one layer, {bound} "
                      f"with {free / gb:.1f} GB free; card {smi}")
                continue
            line = (f"{head}: batch {b}"
                    + (f" (cut from {dims['global_batch']})"
                       if b != dims["global_batch"] else "")
                    + f", {cut.n_layers} of {cfg.n_layers} layers; ")
            if shape.kind == "lm_train":
                r = lm_train(name, cut, b, dims["seq_len"], args.seed)
                line += (
                    f"{cut.train_microbatches} microbatches; {_ms(r['ms'])} "
                    f"a step (the first warms the allocator and cuBLAS up), "
                    f"{r['tokens'] / statistics.mean(r['ms'][1:]) * 1e3:.0f}"
                    f" tokens/s after it; loss "
                    f"{[round(v, 4) for v in r['losses']]}")
            else:
                params = PT.init(torch.Generator(device="cuda").manual_seed(
                    args.seed), cut, "cuda")
                r = lm_serve(name, cut, shape, params, b, args.seed)
                if r["prefill_ms"] is not None:
                    rate = r["prefill_tokens"] / r["prefill_ms"] * 1e3
                    line += (f"prefill {r['prefill_ms']:.1f} ms ({rate:.0f} "
                             "tokens/s), ")
                line += (f"decode {r['decode_ms']:.2f} ms a token step over "
                         f"{r['steps']} steps ({b / r['decode_ms'] * 1e3:.0f}"
                         f" tokens/s)")
                if shape.name == "long_500k":
                    again = lm_serve(name, cut, shape, params, b, args.seed)
                    same = all(torch.equal(x.view(torch.int32),
                                           y.view(torch.int32))
                               for x, y in zip(r["logits"], again["logits"]))
                    line += (f"; a second run of the request: logits of all "
                             f"{len(r['logits'])} steps "
                             f"{'equal bit for bit' if same else 'DIFFER'}")
                    if not same:
                        raise AssertionError(f"{name}: serving does not "
                                             "repeat")
                    del again
                del params
            print(f"{line}; peak {r['peak_gb']:.2f} GB; {bound}; card {smi}")
            del r


def phase_lm(args, smi: str) -> None:
    """The LM family: REDUCED configs card against CPU, RoPE's angles on
    both, then every arch × shape at FULL widths.  The five kernels'
    launch counts are read before and after: the LM path launches none."""
    t_phase = time.perf_counter()
    before = launch_counts()
    report = lm_cross_device(args)
    print(f"[lm] cuda vs cpu (REDUCED configs; logits rtol {XDEV_BF16_TOL}, "
          f"atol {XDEV_BF16_TOL}·max|logits|): " + "; ".join(report))
    print(f"[lm] RoPE angles, card vs CPU: {rope_ulps()}")
    t_full = time.perf_counter()
    lm_full_runs(args, smi)
    print(f"[lm] FULL widths {time.perf_counter() - t_full:.1f} s")
    after = launch_counts()
    risen = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    print(f"[lm] kernel launches during the phase: "
          f"{risen or 'none of ' + str(sorted(after))}")
    if risen:
        raise AssertionError(f"the LM path launched kernels: {risen}")
    print(f"[lm] phase {time.perf_counter() - t_phase:.1f} s; card {smi}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# launch: the paper's sharded KB search step at full scale, the dry run,
# every cell for real, the compressed exchange, distributed PCA, elastic
# resume
# ---------------------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
#: rows a chunk of the launch KB is drawn and encoded in
LAUNCH_CHUNK = 1_000_000
#: the launch KB's rows are padded to a multiple of the 2×16×16 mesh
LAUNCH_PAD = 512
#: the two_stage step held against the CPU's plain versions
LAUNCH_CHECK_DOCS, LAUNCH_CHECK_Q = 131_072, 500
#: error feedback over 20 steps, at repro's bars
EXCHANGE_STEPS = 20
EXCHANGE_BARS = {"int8": 0.02, "onebit": 0.35}
#: elastic resume: steps, the step the checkpoint is taken at, the bar of
#: a short Adam trajectory (ROADMAP §C: loss history within 5e-3)
ELASTIC_STEPS, ELASTIC_AT, ELASTIC_RTOL = 10, 5, 5e-3
DRYRUN_DIR = os.path.join(HERE, "build", "dryrun")
DRYRUN_OUT = os.path.join(DRYRUN_DIR, "chip_smoke.jsonl")
DRYRUN_WORKERS = 4


class BackgroundDryRun:
    """The dry run of every cell × both meshes
    (``repro_torch.launch.dryrun --all``: the cells shared by a few
    processes, at lower priority), run beside the card's phases: its
    passes are host work over meta tensors.  It starts after the kernel
    phase, whose CUDA-event times it would otherwise skew (host threads
    that enqueue the timed launches compete with it).  The workers see no
    CUDA device; the card's name and memory are passed to them."""

    def __init__(self) -> None:
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        props = torch.cuda.get_device_properties(0)
        os.makedirs(DRYRUN_DIR, exist_ok=True)
        if os.path.exists(DRYRUN_OUT):
            os.remove(DRYRUN_OUT)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(HERE, "src")]
                       + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.log = open(os.path.join(DRYRUN_DIR, "chip_smoke.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "both", "--workers", str(DRYRUN_WORKERS), "--card",
             props.name, "--hbm", str(props.total_memory), "--out",
             DRYRUN_OUT],
            env=env, stdout=self.log, stderr=subprocess.STDOUT,
            start_new_session=True)
        # the sweep and the cell processes it starts run below the card's
        # phases' priority
        os.setpriority(os.PRIO_PGRP, self.proc.pid, 10)
        self.started = time.perf_counter()

    def stop(self) -> None:
        """End the sweep and every process it started."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait()
        self.log.close()
        self.proc = None


def launch_recipe(kb, seed: int):
    """The paper's pre+post recipe [CenterNorm, PCA(128), CenterNorm,
    Int8Quantizer] fitted on the main KB: its doc-side and query-side
    fused parameters (μ₁, W, μ₂′, scale, zero)."""
    from repro_torch.core import (CenterNorm, CompressionPipeline,
                                  Int8Quantizer, PCA)
    from repro_torch.kernels.fused_quantize.ops import params_from_pipeline

    pipe = CompressionPipeline([CenterNorm(), PCA(128), CenterNorm(),
                                Int8Quantizer()])
    pipe.fit(kb.docs, kb.queries,
             rng=torch.Generator(device="cuda").manual_seed(seed))
    return params_from_pipeline(pipe, "docs"), \
        params_from_pipeline(pipe, "queries")


def launch_kb(pop, n_rows: int, doc_params, seed: int, onebit: bool):
    """``n_rows`` docs of the main KB's population, drawn on the card in
    chunks of 1M rows from a cuda generator seeded ``seed`` (the same rows
    for both storages) and encoded chunk by chunk: int8 codes by
    ``fused_quantize``, 1-bit words as the signs of the same normalized
    rows.  The float KB is never whole."""
    from repro_torch.core.quantization import pack_bits
    from repro_torch.data import draw_dpr_like_docs

    mu1, w, mu2, scale, zero = doc_params
    g = torch.Generator(device="cuda").manual_seed(seed)
    width, dt = (w.shape[1] // 32, torch.int32) if onebit \
        else (w.shape[1], torch.uint8)
    out = torch.empty((n_rows, width), dtype=dt, device="cuda")
    for s in range(0, n_rows, LAUNCH_CHUNK):
        x = draw_dpr_like_docs(pop, min(LAUNCH_CHUNK, n_rows - s), g)
        out[s:s + x.shape[0]] = (
            pack_bits(fused_normalize_ref(x, mu1, w, mu2)) if onebit
            else fused_quantize(x, mu1, w, mu2, scale, zero))
        del x
    return out


def _launch_ways(arch, shape, storage: str):
    """(label, bundle) for the four ways the step is driven: no mesh
    (naive and two_stage), the 16×16 and the 2×16×16 mesh, all on
    cuda:0."""
    from repro_torch.launch.mesh import make_production_mesh, rules_for_mesh
    from repro_torch.launch.steps import build_step

    def variant(topk_impl):
        return dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, storage=storage, topk_impl=topk_impl))

    ways = [("no mesh naive", variant("naive"), None),
            ("no mesh two_stage", variant("two_stage"), None)]
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="cuda:0")
        ways.append(("x".join(map(str, mesh.devices.shape)),
                     variant("two_stage"), mesh))
    return [(label, build_step(a, shape, mesh, rules_for_mesh(mesh)
                               if mesh is not None else None))
            for label, a, mesh in ways]


def launch_search(args, pop, doc_params, query_params, queries, smi):
    """The paper's step at search_exact and search_50m, int8 (and 1-bit
    at search_exact): every way's ids and score bits equal; then the
    two_stage ranking held against the CPU's plain versions."""
    from repro_torch.configs.registry import get_arch

    arch = get_arch("paper-dpr")
    mu1, w, mu2, scale, zero = query_params
    index = {"mu1": mu1, "w": w, "mu2": mu2, "scale": scale, "zero": zero}
    for shape_name, storage in (("search_exact", "int8"),
                                ("search_exact", "onebit"),
                                ("search_50m", "int8")):
        shape = arch.shape(shape_name)
        n_docs, k = shape.dims["n_docs"], shape.dims["k"]
        n_rows = -(-n_docs // LAUNCH_PAD) * LAUNCH_PAD
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index["storage"] = launch_kb(pop, n_rows, doc_params,
                                     args.seed + 1, storage == "onebit")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = index["storage"]
        head = (f"[launch] kb_search {shape_name} {storage}: {n_docs:,} "
                f"docs padded to {n_rows:,} (a multiple of the 2x16x16 "
                f"mesh), index {st.numel() * st.element_size() / 1e9:.3f} "
                f"GB, drawn and encoded in {build_s:.2f} s; "
                f"{queries.shape[0]} queries at k = {k}")
        print(head)
        first = None
        for label, bundle in _launch_ways(arch, shape, storage):
            if label == "no mesh naive" and shape_name == "search_50m":
                need = queries.shape[0] * n_rows * 4
                print(f"[launch]   {label}: skipped, its (Q, D) f32 scores "
                      f"alone take {need / 1e9:.0f} GB; card {smi}")
                continue
            batch = {"queries": queries}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, ids = bundle.fn(index, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if first is None:
                first = (label, vals, ids)
                _checked(f"kb_search {label}", vals[:, :K], ids[:, :K],
                         queries.shape[0], n_rows)
                same = "the reference way"
            else:
                ok = (torch.equal(ids, first[2]) and torch.equal(
                    vals.view(torch.int32), first[1].view(torch.int32)))
                if not ok:
                    raise AssertionError(f"kb_search {shape_name} {storage}"
                                         f" {label} differs from "
                                         f"{first[0]}")
                same = f"ids and score bits equal to {first[0]}"
            print(f"[launch]   {label}: {secs:.3f} s a batch of "
                  f"{queries.shape[0]}, {queries.shape[0] / secs:.0f} q/s; "
                  f"{same}; card {smi}")
            del vals, ids
            torch.cuda.empty_cache()
        if shape_name == "search_exact":
            for label, bundle in _launch_ways(arch, shape, storage)[::2]:
                profile_call(f"kb_search {shape_name} {storage} {label}",
                             lambda: bundle.fn(index, {"queries": queries}))
            launch_check_cpu(index, queries, storage, k)
        del first
        index.pop("storage")
        torch.cuda.empty_cache()


def launch_check_cpu(index, queries, storage: str, k: int) -> None:
    """The two_stage ranking over the first 131,072 docs on the card (the
    kernels) against the same on the CPU (their plain versions), from the
    same encoded queries."""
    from repro_torch.launch.steps import encode_kb_queries, kb_search_topk

    sub = dict(index, storage=index["storage"][:LAUNCH_CHECK_DOCS])
    z = encode_kb_queries(sub, queries[:LAUNCH_CHECK_Q])
    kw = dict(storage_kind=storage, topk_impl="two_stage", k=k,
              doc_chunk=65_536)
    got = kb_search_topk(sub, z, **kw)
    want = kb_search_topk({n: t.cpu() for n, t in sub.items()}, z.cpu(),
                          **kw)
    ok, err = ranking_agrees(tuple(t.cpu() for t in got), want,
                             exact=storage == "onebit")
    print(f"[launch]   two_stage at {LAUNCH_CHECK_DOCS:,} docs, "
          f"{LAUNCH_CHECK_Q} queries, card (kernels) vs CPU (plain "
          f"versions): max |Δscore| {err:.3g}, "
          f"{'ids and bits equal' if storage == 'onebit' else 'ids equal where apart'}"
          f": {'ok' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError(f"kb_search {storage}: card and CPU disagree")


def launch_dryrun(dryrun: BackgroundDryRun, smi: str) -> None:
    """Wait for the background dry run and print its 84 rows."""
    from repro_torch.launch.dryrun import all_cells, format_row

    t0 = time.perf_counter()
    rc = dryrun.proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    wall = time.perf_counter() - dryrun.started
    with open(DRYRUN_OUT) as f:
        rows = [json.loads(line) for line in f]
    order = {(a, s, mp): i for i, (a, s) in enumerate(all_cells())
             for mp in (False, True)}
    rows.sort(key=lambda r: (order.get((r["arch"], r["shape"],
                                        r.get("multi_pod")), -1),
                             r.get("multi_pod")))
    bad = [r for r in rows if r.get("status") != "ok"]
    for r in rows:
        if r.get("status") == "ok":
            print(format_row(r) + f"; card {smi}")
    fits = sum(bool(r.get("fits_hbm")) for r in rows)
    by = {}
    for r in rows:
        if r.get("status") == "ok":
            by[r["bottleneck"]] = by.get(r["bottleneck"], 0) + 1
    print(f"[launch] dry run: {len(rows)} rows ({len(rows) - len(bad)} ok) "
          f"of {2 * len(all_cells())}, at "
          f"{next((r['card'] for r in rows if 'card' in r), '?')} rates; arguments fit the card's memory in {fits}; bottleneck "
          f"{by}; {DRYRUN_WORKERS} workers beside the phases after the "
          f"kernel phase, {wall:.1f} s from their start, {waited:.1f} s "
          f"waited here; "
          f"card {smi}")
    if rc != 0 or bad or len(rows) != 2 * len(all_cells()):
        raise AssertionError(f"dry run: exit {rc}, failed rows "
                             f"{[(r['arch'], r['shape']) for r in bad]}")


def launch_cells(args) -> None:
    """Every cell's REDUCED bundle once on cuda:0 (the smoke checks)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.batches import make_batch, reduce_dims
    from repro_torch.launch.dryrun import all_cells
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optimizer import tree_leaves, tree_map

    g = torch.Generator(device="cuda").manual_seed(args.seed)

    def mat(x, zeros=False):
        if not isinstance(x, torch.Tensor):
            return x
        if not zeros and x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=g, device="cuda")
                    * 0.02).to(x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype, device="cuda")

    t0 = time.perf_counter()
    ms = {}
    for arch_name, shape_name in all_cells():
        arch = get_arch(arch_name)
        shape = arch.shape(shape_name)
        bundle = build_step(arch, shape, None, None, reduced=True)
        cargs = []
        for a in bundle.abstract_args[:-1]:
            if isinstance(a, dict) and "opt" in a:
                cargs.append({"params": tree_map(mat, a["params"]),
                              "opt": tree_map(lambda x: mat(x, True),
                                              a["opt"]),
                              "step": torch.zeros((), dtype=torch.int32,
                                                  device="cuda")})
            else:
                cargs.append(tree_map(mat, a))
        batch = make_batch(np.random.default_rng(42), arch, shape,
                           reduced=True, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = bundle.fn(*cargs, batch)
        torch.cuda.synchronize()
        ms[f"{arch_name}:{shape_name}"] = (time.perf_counter() - t1) * 1e3
        finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(out)
                     if isinstance(x, torch.Tensor)
                     and x.dtype.is_floating_point)
        ok = finite
        if shape.kind == "lm_train":
            ok = ok and float(out[1]["loss"]) > 0
        elif shape.kind == "lm_decode":
            ok = ok and tuple(out[0].shape) == (
                reduce_dims(shape)["global_batch"], arch.reduced.vocab_size)
        elif shape.kind == "retrieval_cand":
            ok = ok and out[0].shape[0] >= 1
        if not ok:
            raise AssertionError(f"{arch_name}:{shape_name} REDUCED on the "
                                 "card: non-finite or misshapen output")
    slow = sorted(ms.items(), key=lambda kv: -kv[1])[:3]
    print(f"[launch] every cell's REDUCED bundle on cuda:0: {len(ms)} of "
          f"{len(all_cells())} finite with repro's shape checks, "
          f"{time.perf_counter() - t0:.1f} s (first calls included; slowest "
          + ", ".join(f"{n} {v:.0f} ms" for n, v in slow) + ")")


def launch_exchange(args, smi: str) -> None:
    """The compressed exchange over a 1×8 "data" mesh of cuda:0 at the
    size of the "100m" retriever's parameter tree: ms an exchange and the
    bytes gathered; then 20 steps of error feedback at repro's bars."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import param_count
    from repro_torch.models.recsys import two_tower_spec
    from repro_torch.parallel.collectives import COUNTER
    from repro_torch.parallel.compression_comm import (
        init_residual, make_compressed_grad_exchange)

    n = param_count(two_tower_spec(retriever_config()))
    mesh = make_test_mesh(8, 1, device="cuda:0")
    shards = mesh.shape["data"]

    def draws(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [{"w": torch.randn(n, generator=g, device="cuda")}
                for _ in range(shards)]

    grads = draws(args.seed)
    parts = []
    for scheme in ("none", "int8", "onebit"):
        ex = make_compressed_grad_exchange(scheme, "data")
        res = None if scheme == "none" else [
            init_residual(gr) for gr in grads]
        COUNTER.reset()
        ex(grads, res)
        nbytes = COUNTER.total()
        ms = cuda_ms(lambda: ex(grads, res), 5)
        COUNTER.reset()
        parts.append(f"{scheme} {ms:.2f} ms, {nbytes:,} B gathered "
                     f"({nbytes / (4 * n):.4f} of f32's 4n)")
    print(f"[launch] exchange of {n:,} floats (the 100m retriever's "
          f"parameters) over 1x{shards} 'data' on cuda:0: "
          + "; ".join(parts) + f"; card {smi}")
    del grads
    acc = {}
    for scheme in ("none", "int8", "onebit"):
        ex = make_compressed_grad_exchange(scheme, "data")
        res, total = None, torch.zeros(n, device="cuda")
        for t in range(EXCHANGE_STEPS):
            grads = draws(args.seed + 1 + t)
            if res is None and scheme != "none":
                res = [init_residual(gr) for gr in grads]
            mean, res = ex(grads, res)
            total += mean["w"]
            del grads, mean
        acc[scheme] = total
        del res
    rel = {s: float(torch.linalg.vector_norm(acc[s] - acc["none"])
                    / torch.linalg.vector_norm(acc["none"]))
           for s in EXCHANGE_BARS}
    ok = all(rel[s] < EXCHANGE_BARS[s] for s in rel)
    print(f"[launch] error feedback, {EXCHANGE_STEPS} steps: relative error "
          "of the accumulated mean " + ", ".join(
              f"{s} {rel[s]:.4f} (bar {EXCHANGE_BARS[s]})" for s in rel)
          + f": {'ok' if ok else 'FAILED'}")
    COUNTER.reset()
    if not ok:
        raise AssertionError(f"compressed exchange: {rel}")
    del acc
    torch.cuda.empty_cache()


def launch_pca(kb, smi: str) -> None:
    """fit_pca_distributed over 4 "data" shards of the main KB against
    PCA.fit on the same rows."""
    from repro_torch.core.pca import PCA, fit_pca_distributed
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(8, 2, device="cuda:0")
    shards = list(torch.chunk(kb.docs, mesh.shape["data"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = fit_pca_distributed(shards, 128, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    local = PCA(128).fit(kb.docs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cos = torch.abs(torch.sum(dist.state["components"]
                              * local.state["components"], dim=0))
    worst = float((1 - cos).abs().max())
    print(f"[launch] fit_pca_distributed over {len(shards)} shards of the "
          f"main KB {tuple(kb.docs.shape)}: {t1 - t0:.3f} s, PCA.fit "
          f"{t2 - t1:.3f} s; max |1 − |cos|| over 128 components "
          f"{worst:.2e} (bar 1e-3): {'ok' if worst <= 1e-3 else 'FAILED'};"
          f" card {smi}")
    if worst > 1e-3:
        raise AssertionError("distributed PCA differs from the local fit")


def launch_elastic(args) -> None:
    """A REDUCED two-tower run checkpointed on a data=8 mesh, restored onto
    plan_remesh's 4-device mesh and resumed at microbatch_scale × the
    microbatches, against the uninterrupted run.  The single controller
    runs a data-parallel step as one microbatch a data position (each
    computes its loss, in-batch negatives included, over its share of the
    global batch), so the old mesh takes 8 microbatches a step and the new
    one 4 × microbatch_scale: the same global batch in the same shares."""
    import functools

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.batches import make_batch, reduce_dims
    from repro_torch.launch.steps import _ctx_loss, build_step
    from repro_torch.models import layers as L
    from repro_torch.models import recsys as R
    from repro_torch.parallel.sharding import SINGLE_POD_RULES
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.elastic import build_mesh, plan_remesh, \
        reshard_state

    arch = get_arch("two-tower-retrieval")
    shape = arch.shape("train_batch")
    cfg = arch.reduced
    rules = SINGLE_POD_RULES
    plan = plan_remesh({"data": 8, "model": 1}, 4)
    old = build_mesh(plan.old_shape, "cuda:0")
    new = build_mesh(plan.new_shape, "cuda:0")
    tx = opt_lib.OptimizerConfig(lr=1e-3, total_steps=10000).build()

    def step_on(mesh, micro):
        return trainer.make_train_step(functools.partial(
            _ctx_loss, R.two_tower_loss, cfg, mesh, rules), tx,
            microbatches=micro)

    micro_old = old.shape["data"]
    micro_new = new.shape["data"] * plan.microbatch_scale
    step_old, step_new = step_on(old, micro_old), step_on(new, micro_new)
    specs_new = build_step(arch, shape, new, rules, reduced=True).in_specs[0]
    state0 = trainer.init_state(
        torch.Generator(device="cuda").manual_seed(args.seed),
        lambda g: L.init_params(g, R.two_tower_spec(cfg), "cuda"), tx)
    batches = [make_batch(np.random.default_rng(args.seed + i), arch, shape,
                          reduced=True, device="cuda")
               for i in range(ELASTIC_STEPS)]
    s, want = state0, []
    for b in batches:
        s, m = step_old(s, b)
        want.append(float(m["loss"]))
    s, got = state0, []
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        for b in batches[:ELASTIC_AT]:
            s, m = step_old(s, b)
            got.append(float(m["loss"]))
        ck = Checkpointer(tmp, keep=1)
        ck.save(s, ELASTIC_AT, blocking=True)
        restored = ck.restore(s, device="cuda")
        same, _ = _leaves_equal(restored, s)
        s = reshard_state(restored, specs_new, new)
        for b in batches[ELASTIC_AT:]:
            s, m = step_new(s, b)
            got.append(float(m["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    ok = same and rel <= ELASTIC_RTOL and int(s["step"]) == ELASTIC_STEPS
    print(f"[launch] elastic resume: {plan.old_shape} → {plan.new_shape}, "
          f"microbatch_scale {plan.microbatch_scale} ({micro_old} → "
          f"{micro_new} microbatches of the global batch "
          f"{reduce_dims(shape)['batch']}); checkpoint at step {ELASTIC_AT} "
          f"restored {'bit for bit' if same else 'CHANGED'}, resharded and "
          f"resumed; losses {[round(x, 5) for x in got]} against the "
          f"uninterrupted {[round(x, 5) for x in want]}: max rel "
          f"{rel:.2e} (bar {ELASTIC_RTOL}"
          f"{', bit for bit' if got == want else ''}): "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("elastic resume does not match")


def phase_launch(args, smi: str, main_kb,
                 dryrun: BackgroundDryRun) -> dict[str, int]:
    """launch/: the paper's sharded KB search step at full scale on the
    kernels, the dry run's rows, every cell's REDUCED bundle, the
    compressed exchange, distributed PCA and elastic resume."""
    from repro_torch.data import dpr_like_population, draw_dpr_like_queries

    t_phase = time.perf_counter()
    before = launch_counts()
    kb = kb_on_card(main_kb, "launch", args)
    doc_params, query_params = launch_recipe(kb, args.seed)
    launch_pca(kb, smi)
    del kb
    torch.cuda.empty_cache()
    pop = dpr_like_population(args.seed, device="cuda")
    queries = draw_dpr_like_queries(
        pop, 6000, torch.Generator(device="cuda").manual_seed(args.seed + 2))
    launch_search(args, pop, doc_params, query_params, queries, smi)
    t_search = time.perf_counter() - t_phase
    launch_cells(args)
    counts = diff_counts(before, launch_counts())
    print(f"[launch] kernel launches in the phase: {counts}")
    for name in ("int8_ip", "topk_blocks", "binary_ip", "fused_quantize"):
        if not counts.get(name):
            raise AssertionError(f"the launch path did not launch {name}")
    launch_exchange(args, smi)
    launch_elastic(args)
    launch_dryrun(dryrun, smi)
    print(f"[launch] phase {time.perf_counter() - t_phase:.1f} s (KB search "
          f"{t_search:.1f} s); card {smi}")
    torch.cuda.empty_cache()
    return {n: counts.get(n, 0) for n in launch_counts()}


def example_runs(args) -> list[tuple[str, str, list, bool]]:
    """The examples' runs on the card: (tag, example, argv, at the main
    size).  Each at its own defaults; the paper's path also at the main
    cells' size (PERF §4's KB: ``--n-docs``, ``--n-queries``)."""
    n_docs, n_q = str(args.n_docs), str(args.n_queries)
    return [
        ("quickstart main KB", "quickstart",
         ["--n-docs", n_docs, "--n-queries", n_q], True),
        ("quickstart", "quickstart", [], False),
        ("live_updates main size", "live_updates", ["--n-docs", n_docs],
         True),
        ("live_updates pca_onebit", "live_updates",
         ["--method", "pca_onebit"], False),
        ("serve_compressed main size", "serve_compressed",
         ["--no-post", "--ivf-nlist", "1024", "--shards", "4",
          "--n-docs", n_docs], True),
        ("serve_compressed", "serve_compressed", [], False),
        ("train_retriever", "train_retriever", ["--size", "small"], False),
        ("train_retriever --resume", "train_retriever",
         ["--size", "small", "--resume"], False),
        ("knn_lm", "knn_lm", [], False),
    ]


#: each example at a tiny size, on the card and on the CPU
EXAMPLE_TINY = {
    "quickstart": ["--n-docs", "4000", "--n-queries", "512", "--dim", "32"],
    "live_updates": ["--n-docs", "4000", "--requests", "8", "--batch", "8"],
    "serve_compressed": ["--n-docs", "4000", "--no-post", "--ivf-nlist",
                         "16", "--requests", "8", "--batch", "8",
                         "--shards", "2"],
    "train_retriever": ["--steps", "20"],
    "knn_lm": ["--steps", "5"],
}
#: what must be equal on the card and the CPU, where the path is
#: deterministic
EXAMPLE_EQUAL = {
    "quickstart": ("doc_l2", "query_l2", "float_nbytes", "nbytes", "ratio"),
    "live_updates": ("n_docs", "nbytes", "added", "segment", "gid_range",
                     "deleted", "tombstones", "n_live_after_delete",
                     "versions", "live", "updates", "compactions", "n_live",
                     "segments"),
    "serve_compressed": ("versions", "live", "promoted", "requests_served",
                         "queries_served"),
    "train_retriever": ("n_params", "ratio", "steps_trained"),
    "knn_lm": ("datastore", "ratio"),
}
#: what the card computes, within a bar of the CPU's: (key, bar, relative).
#: The examples draw their weights on the CPU and move them, so both start
#: equal; the order of float sums differs between the card and the CPU,
#: and Adam's first steps (update ≈ lr·sign(g)) turn that into weight
#: differences of lr.  Measured on an H100 (PERF §6, PR 23): R-Precision
#: and the canary overlap equal; precision@10 |d| 0.0059 / 0.0051; the
#: kNN-LM's bf16 perplexities 1.3% / 5.1% apart (the CPU of this check
#: and another CPU differ by 2.4% in the kNN-LM one).
EXAMPLE_CLOSE = {
    "quickstart": (("float_rp", 0.01, False), ("rp", 0.01, False)),
    "live_updates": (),
    "serve_compressed": (("canary_overlap", 0.02, False),),
    "train_retriever": (("exact_p10", 0.02, False),
                        ("compressed_p10", 0.02, False)),
    "knn_lm": (("ppl_lm", 0.03, True), ("ppl_knn", 0.10, True)),
}


def load_example(stem: str):
    """``examples_torch/<stem>.py`` as a module, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{stem}",
        os.path.join(HERE, "examples_torch", f"{stem}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, tag: str, argv: list) -> dict:
    """``mod.run(argv)`` with its printed lines tagged; adds ``seconds``."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.run(argv)
    finally:
        for line in buf.getvalue().splitlines():
            if line.strip():
                print(f"[examples] {tag} | {line}")
    out["seconds"] = time.perf_counter() - t0
    print(f"[examples] {tag}: {out['seconds']:.1f} s")
    return out


def check_example(tag: str, stem: str, out: dict, main_size: bool) -> str:
    """The example's own claim; returns its summary.  The quickstart's
    85% claim is held at its defaults; at the main KB (1M docs) the
    reference's own recipe falls below it on this synthetic KB (ROADMAP
    §C), so there the kernel path is held to the port's plain torch
    scoring path instead (:func:`quickstart_plain_scoring`)."""
    if stem == "quickstart":
        if round(out["ratio"]) != 24 or (not main_size
                                         and out["rp_share"] < 0.85):
            raise AssertionError(f"{tag}: R-Precision share "
                                 f"{out['rp_share']:.4f} or ratio "
                                 f"{out['ratio']:.2f}x off the claim")
        return (f"R-Precision {out['rp']:.4f} = {out['rp_share']:.4f} of "
                f"float {out['float_rp']:.4f} at {out['ratio']:.1f}x "
                f"(the example's 85% claim "
                f"{'met' if out['reproduced'] else 'not met'}); build "
                f"{out['build_s']:.2f} s, load {out['load_s']:.3f} s, "
                f"search {out['ms_per_query']:.4f} ms a query")
    if stem == "live_updates":
        if (out["updates"], out["compactions"], out["deleted"]) != (2, 1, 36):
            raise AssertionError(f"{tag}: updates {out['updates']}, "
                                 f"compactions {out['compactions']}, "
                                 f"deleted {out['deleted']}")
        return (f"scorer {out['scorer']}, {out['added']} added, "
                f"{out['deleted']} deleted (none served), "
                f"{out['updates']} updates, {out['compactions']} compaction, "
                f"{out['n_live']} live; p50 {out['p50_ms']:.2f} ms, p99 "
                f"{out['p99_ms']:.2f} ms")
    if stem == "serve_compressed":
        if out["canary_overlap"] < 0.5 or out["live"] != 2:
            raise AssertionError(f"{tag}: canary overlap "
                                 f"{out['canary_overlap']:.3f}, live "
                                 f"v{out['live']}")
        line = (f"v2 {out['v2']['n_docs']} docs, canary overlap "
                f"{out['canary_overlap']:.4f}, promoted v{out['promoted']}, "
                f"{out['requests_served']} requests, p50 "
                f"{out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms")
        if "tiered" in out:
            tier, trial = out["tiered"]["tier"], out["tiered"]["trial"]
            if tier["hits"] + tier["misses"] == 0:
                raise AssertionError(f"{tag}: the tier was never read")
            line += (f"; tiered {trial['admitted']} open-loop requests, "
                     f"{trial['lost']} lost, p50 {trial['p50_ms']:.2f} ms, "
                     f"p99 {trial['p99_ms']:.2f} ms, hit rate "
                     f"{tier['hit_rate']:.4f} ({tier['hits']} hits, "
                     f"{tier['misses']} misses)")
        if "sharded" in out:
            if out["sharded"]["verdict"] != "bit-identical":
                raise AssertionError(f"{tag}: sharded act "
                                     f"{out['sharded']['verdict']}")
            line += (f"; {len(out['sharded']['shards'])} shards "
                     f"bit-identical")
        return line
    if stem == "train_retriever":
        if "--resume" in tag:
            if out["resumed_from"] != 300 or out["steps_trained"] != 0:
                raise AssertionError(f"{tag}: resumed from "
                                     f"{out['resumed_from']}, trained "
                                     f"{out['steps_trained']} steps")
        if out["retained"] < 0.9:
            raise AssertionError(f"{tag}: compressed cluster precision "
                                 f"{out['retained']:.4f} of uncompressed")
        return (f"{out['n_params']} params, resumed from "
                f"{out['resumed_from']}, {out['steps_trained']} steps, "
                f"cluster-precision@10 {out['exact_p10']:.4f} -> "
                f"{out['compressed_p10']:.4f} at {out['ratio']:.1f}x")
    if not (np.isfinite(out["ppl_lm"]) and np.isfinite(out["ppl_knn"])
            and out["ppl_knn"] < out["ppl_lm"]):
        raise AssertionError(f"{tag}: perplexity LM {out['ppl_lm']} kNN-LM "
                             f"{out['ppl_knn']}")
    return (f"datastore {out['datastore']} at {out['ratio']:.1f}x, "
            f"perplexity LM-only {out['ppl_lm']:.4f}, kNN-LM "
            f"{out['ppl_knn']:.4f}")


def examples_card_vs_cpu(mods: dict) -> None:
    """Each example at a tiny size on the card and on the CPU: the
    deterministic numbers equal, the computed ones (R-Precision, canary
    overlap, precision@10, perplexities) within :data:`EXAMPLE_CLOSE`'s
    bars, the sharded verdict on both."""
    failures = []
    for stem, argv in EXAMPLE_TINY.items():
        outs = {}
        for dev in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as tmp:
                extra = (["--ckpt-dir", tmp] if stem == "train_retriever"
                         else [])
                with contextlib.redirect_stdout(io.StringIO()):
                    outs[dev] = mods[stem].run(argv + extra
                                               + ["--device", dev])
        card, cpu = outs["cuda"], outs["cpu"]
        diff = {k: (card[k], cpu[k]) for k in EXAMPLE_EQUAL[stem]
                if card[k] != cpu[k]}
        line = f"{len(EXAMPLE_EQUAL[stem])} numbers equal"
        for key, bar, relative in EXAMPLE_CLOSE[stem]:
            d = abs(card[key] - cpu[key])
            if relative:
                d /= abs(cpu[key])
            if not d <= bar:
                diff[key] = (card[key], cpu[key])
            line += (f", {key} {card[key]:.4f} / {cpu[key]:.4f} "
                     f"(|d|{'/cpu' if relative else ''} {d:.4g} <= {bar})")
        if stem == "serve_compressed":
            verdicts = (card["sharded"]["verdict"], cpu["sharded"]["verdict"])
            if verdicts != ("bit-identical",) * 2:
                diff["sharded verdict"] = verdicts
            line += f", sharded {verdicts[0]} on both"
        if diff:
            failures.append(f"{stem}: the card and the CPU differ: {diff}")
            line = f"DIFFER: {diff}; {line}"
        print(f"[examples] {stem} {' '.join(argv)}: cuda vs cpu: {line}")
    if failures:
        raise AssertionError("; ".join(failures))


def quickstart_plain_scoring(main_kb, args, out: dict) -> str:
    """The quickstart's 24x recipe on the main KB (the quickstart's own KB:
    the same size and seed) scored by the port's plain torch scoring path
    on the card (``backend="torch"``: staged encode, codes decoded to f32,
    one f32 product): its R-Precision share within 0.01 of the kernel
    path's (``fused_quantize``, ``int8_ip``, ``topk_blocks``) in ``out``.
    Both share the port's CenterNorm and PCA fit, so this clears the
    kernels, not the fit."""
    from repro_torch.retrieval import (IndexSpec, build_index,
                                       r_precision_from_ids)

    kb = kb_on_card(main_kb, "examples", args)
    spec = IndexSpec(stages=(("CenterNorm", {}), ("PCA", {"dim": 128}),
                             ("CenterNorm", {}), ("Int8Quantizer", {})),
                     backend="torch")
    idx = build_index(spec, kb.docs, kb.queries, device="cuda")
    _, ids = idx.search(kb.queries, k=2)
    share = r_precision_from_ids(ids, kb.relevant) / out["float_rp"]
    del kb, idx
    torch.cuda.empty_cache()
    if abs(share - out["rp_share"]) > 0.01:
        raise AssertionError(f"quickstart main KB: kernel path share "
                             f"{out['rp_share']:.4f}, the plain path "
                             f"{share:.4f}")
    return (f"R-Precision share on the plain torch path {share:.4f}, the "
            f"kernel path {out['rp_share']:.4f}")


def phase_examples(smi: str, args, main_kb) -> dict[str, int]:
    """``examples_torch/``: each example's ``run`` in-process on the card,
    its own claims asserted, the five kernels' counts rising, then each
    example at a tiny size on the card against the CPU.  Every run
    completes before a failed claim raises, so one call shows them all."""
    t_phase = time.perf_counter()
    mods = {stem: load_example(stem) for stem in EXAMPLE_TINY}
    failures, summaries, outs = [], [], {}
    with tempfile.TemporaryDirectory() as ckpt:
        reset_launch_counts()
        for tag, stem, argv, main_size in example_runs(args):
            extra = ["--ckpt-dir", ckpt] if stem == "train_retriever" else []
            outs[tag] = out = run_example(mods[stem], tag, argv + extra)
            try:
                line = check_example(tag, stem, out, main_size)
            except AssertionError as e:
                failures.append(str(e))
                line = f"FAILED: {e}"
            summaries.append((tag, line, out["seconds"]))
        counts = launch_counts()
    t_main = time.perf_counter() - t_phase
    print(f"[examples] kernel launches in the examples' runs: {counts}")
    failures += [f"the examples did not launch {name}"
                 for name, n in counts.items() if not n]
    for tag, line, secs in summaries:
        print(f"[examples] {tag}: {line}; {secs:.1f} s; card {smi}")
    if args.seed == 0:
        try:
            line = quickstart_plain_scoring(
                main_kb, args, outs["quickstart main KB"])
            print(f"[examples] quickstart main KB: {line}; card {smi}")
        except AssertionError as e:
            failures.append(str(e))
    else:
        print("[examples] quickstart main KB: its KB is seed 0, the main "
              f"KB seed {args.seed}: no plain-scoring check")
    try:
        examples_card_vs_cpu(mods)
    except AssertionError as e:
        failures.append(str(e))
    print(f"[examples] phase {time.perf_counter() - t_phase:.1f} s (runs on "
          f"the card {t_main:.1f} s); card {smi}")
    if failures:
        raise AssertionError("[examples] " + "; ".join(failures))
    torch.cuda.empty_cache()
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=1_000_000)
    ap.add_argument("--n-queries", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    smi = phase_environment()
    dryrun = BackgroundDryRun()
    try:
        return run_phases(args, smi, t_start, dryrun)
    finally:
        dryrun.stop()


def run_phases(args, smi: str, t_start: float,
               dryrun: BackgroundDryRun) -> int:
    times = {}

    def lap(name):
        times[name] = round(time.perf_counter() - t_start - sum(
            times.values()), 1)

    with ThreadPoolExecutor(max_workers=2) as pool:
        main_kb, mutable_kb = start_kbs(args, pool)
        phase_build()
        lap("build")
        rates = card_rates(smi)
        kernels = phase_kernels(rates) + [phase_ivf_kernel(rates),
                                          phase_quantize_kernel(rates)]
        phase_topk_merge(rates, smi)
        lap("kernels")
        dryrun.start()
        kb = kb_on_card(main_kb, "main", args)
        lap("KB wait")
        counts, exact, rp_float = phase_main_path(args, kb)
        lap("main path")
        ivf_counts, ivf_indexes = phase_ivf(args, kb, exact, rp_float)
        lap("IVF")
        sharded_counts = phase_sharded(args, kb, exact, ivf_indexes)
        lap("sharded")
        del exact
        torch.cuda.empty_cache()
        tiered_counts = phase_tiered(args, kb, ivf_indexes)
        lap("tiered")
        del ivf_indexes
        torch.cuda.empty_cache()
        offpath_counts = phase_offpath(args, kb, rp_float)
        lap("offpath")
        del kb
        torch.cuda.empty_cache()
        mutable_counts = phase_mutable(args, kb_on_card(mutable_kb,
                                                        "mutable", args))
        lap("mutable")
    torch.cuda.empty_cache()
    models_counts = phase_models(args)
    lap("models")
    phase_lm(args, smi)
    lap("lm")
    launch_counts_ = phase_launch(args, smi, main_kb, dryrun)
    lap("launch")
    examples_counts = phase_examples(smi, args, main_kb)
    lap("examples")
    # each kernel's launches on the path that drives it (the IVF kernel's
    # on the resident and the tiered IVF paths together), plus the sharded,
    # off-path, model, launch and examples phases
    ivf_counts = {n: ivf_counts[n] + tiered_counts[n] for n in ivf_counts}
    path_counts = {"fused_ivf_topk": ivf_counts,
                   "fused_quantize": mutable_counts}
    for rec in kernels:
        rec["launches"] = (path_counts.get(rec["name"], counts)[rec["name"]]
                           + sharded_counts[rec["name"]]
                           + offpath_counts[rec["name"]]
                           + models_counts[rec["name"]]
                           + launch_counts_[rec["name"]]
                           + examples_counts[rec["name"]])
        rec["launches_sharded"] = sharded_counts[rec["name"]]
        rec["launches_offpath"] = offpath_counts[rec["name"]]
        rec["launches_models"] = models_counts[rec["name"]]
        rec["launches_launch"] = launch_counts_[rec["name"]]
        rec["launches_examples"] = examples_counts[rec["name"]]
    print(f"[done] {time.perf_counter() - t_start:.1f} s ("
          + ", ".join(f"{n} {t} s" for n, t in times.items())
          + f"); card {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
