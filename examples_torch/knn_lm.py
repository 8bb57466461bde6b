"""kNN-LM with a compressed datastore (Khandelwal et al. 2019 × this paper).

    python examples_torch/knn_lm.py                           # on the card
    PYTHONPATH=src python examples_torch/knn_lm.py --device cpu --steps 20

The PyTorch counterpart of ``examples/knn_lm.py``.  The paper motivates
index compression partly through kNN-LM-style pipelines (§1).  This
example builds the full loop with the port's substrate:

  1. train a tiny transformer LM on a synthetic Zipfian corpus (the same
     tokens as ``repro``'s from the same seed),
  2. run it over the corpus collecting (hidden state → next token) pairs —
     the datastore,
  3. compress the datastore index with PCA+int8,
  4. serve the kNN lookups through the :class:`RetrievalService` front
     door (the datastore registered as a named index, queried via the
     async handle API), then decode with p = λ·p_kNN + (1−λ)·p_LM and
     compare perplexity LM-only vs kNN-LM-compressed.

On a CUDA device the datastore is encoded in one ``fused_quantize`` pass,
scored through ``int8_ip`` and ranked through ``topk_blocks``.
``--device`` defaults to CUDA and raises without a card; ``--device cpu``
runs every kernel's plain version.
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core import (CenterNorm, CompressionPipeline, Int8Quantizer,
                              PCA)
from repro_torch.models import transformer as T
from repro_torch.retrieval import CompressedIndex
from repro_torch.serve import QueryOptions, RetrievalService
from repro_torch.train import optimizer as O
from repro_torch.train import trainer
from repro_torch.utils import resolve_device

CFG = LMConfig("knn-lm-tiny", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab_size=256, attn_q_chunk=32,
               loss_chunk=None, remat="none")


def zipf_corpus(rng, n_seqs, seq_len, vocab, trans, device):
    """Markov token stream over a SHARED transition table (so the kNN
    datastore built on train text transfers to test text); int32 tokens on
    ``device``."""
    toks = np.zeros((n_seqs, seq_len), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n_seqs)
    for t in range(1, seq_len):
        choice = rng.integers(0, 4, n_seqs)
        toks[:, t] = trans[toks[:, t - 1], choice]
    return torch.from_numpy(toks).to(device)


def run(argv=None) -> dict:
    """Train, build the datastore, compress, serve, decode; returns the
    numbers it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; "
                         "--device cpu runs every kernel's plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    trans = rng.integers(0, CFG.vocab_size, (CFG.vocab_size, 4))
    train_toks = zipf_corpus(rng, 256, 64, CFG.vocab_size, trans, dev)
    test_toks = zipf_corpus(rng, 32, 64, CFG.vocab_size, trans, dev)

    # --- 1) train the LM
    tx = O.adamw(1e-3, max_grad_norm=1.0)
    # drawn on the CPU and moved: every device starts from equal weights
    state = trainer.init_state(torch.Generator().manual_seed(0),
                               lambda g: T.init(g, CFG, dev), tx)
    step = trainer.make_train_step(lambda p, b: T.loss_fn(p, b, CFG), tx)
    losses = []
    for i in range(args.steps):
        sel = torch.from_numpy(rng.integers(0, train_toks.shape[0], 16))
        toks = train_toks[sel.to(dev)]
        state, metrics = step(state, {"tokens": toks, "labels": toks})
        if (i + 1) % 50 == 0:
            losses.append((i + 1, float(metrics["loss"])))
            print(f"step {i + 1}: loss={losses[-1][1]:.3f}")
    params = state["params"]
    d = CFG.d_model

    with torch.no_grad():
        # --- 2) datastore: (hidden state at position t → token t+1)
        feats, _ = T.forward_features(params, train_toks, CFG)
        keys = feats[:, :-1].float().reshape(-1, d)
        vals = train_toks[:, 1:].reshape(-1).cpu().numpy()
        print(f"datastore: {keys.shape[0]} entries × {keys.shape[1]} dims")

        # --- 3) compress it (PCA to half dims + int8)
        pipe = CompressionPipeline([CenterNorm(), PCA(32), CenterNorm(),
                                    Int8Quantizer()])
        idx = CompressedIndex.build(keys, None, pipe, device=dev)
        ratio = keys.numel() * keys.element_size() / idx.nbytes
        print(f"compressed {ratio:.0f}x")

        # --- 4) evaluate perplexity with and without kNN mixing
        feats_t, _ = T.forward_features(params, test_toks, CFG)
        head = params["lm_head"]
        logits = feats_t.float() @ head.float()
        q = feats_t[:, :-1].float().reshape(-1, d).cpu().numpy()
        targets = test_toks[:, 1:].reshape(-1).cpu().numpy()
        logp_lm = torch.log_softmax(
            logits[:, :-1].reshape(-1, CFG.vocab_size), -1).cpu().numpy()
    nll_lm = -logp_lm[np.arange(len(targets)), targets]

    # the datastore is a named index behind the serving front door; the
    # eval loop is just another producer submitting async query blocks
    with RetrievalService(default_k=args.k) as service:
        service.register("datastore", idx)
        handle = service.query(q, QueryOptions(index="datastore",
                                               k=args.k))
        res = handle.result(timeout=300)
        dists, ids = res.scores, res.ids
    knn_tokens = vals[np.asarray(ids)]                      # (N, k)
    w = torch.softmax(torch.from_numpy(dists), -1).numpy()  # similarity IP
    p_knn = np.zeros((len(targets), CFG.vocab_size), np.float32)
    np.add.at(p_knn, (np.arange(len(targets))[:, None], knn_tokens), w)
    lam = args.lam
    p_mix = lam * p_knn + (1 - lam) * np.exp(logp_lm)
    nll_mix = -np.log(np.maximum(
        p_mix[np.arange(len(targets)), targets], 1e-9))

    ppl_lm, ppl_knn = float(np.exp(nll_lm.mean())), \
        float(np.exp(nll_mix.mean()))
    print(f"\nperplexity LM-only:            {ppl_lm:.2f}")
    print(f"perplexity kNN-LM (24x index): {ppl_knn:.2f}")
    if ppl_knn < ppl_lm:
        print("→ compressed datastore still improves the LM "
              "(the paper's motivating use case).")
    return {"device": str(dev), "losses": losses,
            "datastore": tuple(keys.shape), "ratio": ratio,
            "ppl_lm": ppl_lm, "ppl_knn": ppl_knn,
            "improves": ppl_knn < ppl_lm}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
