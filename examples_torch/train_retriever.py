"""Train a two-tower retriever end-to-end, then compress its item index.

    python examples_torch/train_retriever.py --steps 300      # on the card
    PYTHONPATH=src python examples_torch/train_retriever.py --device cpu \\
        --steps 50

The PyTorch counterpart of ``examples/train_retriever.py``.  Demonstrates
the full training substrate: in-batch sampled-softmax training, cosine LR
schedule, grad clipping, checkpointing with resume (``--resume`` also reads
a checkpoint that ``repro``'s example wrote), preemption handling — then
freezes the item tower, embeds a candidate corpus, and compresses it with
the paper's PCA+int8 pipeline, reporting cluster-precision@10 before/after
compression (the end-to-end effect of the paper's technique on a *trained*
system, not just synthetic embeddings).  The world and the interaction
stream draw ``repro``'s numpy sequence; parameters are drawn by a CPU
``torch.Generator`` and moved to the device, so every device starts from
the same weights.  On a CUDA device the exact search
ranks through ``topk_blocks``; the compressed index is encoded by
``fused_quantize`` and scored through ``int8_ip``.

``--device`` defaults to CUDA and raises without a card; ``--device cpu``
runs every kernel's plain version.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import TwoTowerConfig
from repro_torch.core import (CenterNorm, CompressionPipeline, Int8Quantizer,
                              PCA)
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.retrieval import CompressedIndex, topk_search
from repro_torch.train import optimizer as O
from repro_torch.train import trainer
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import PreemptionHandler
from repro_torch.train.optimizer import tree_num_params
from repro_torch.utils import resolve_device


SIZES = {
    # embed_dim, tower, user/item vocab — "100m" ≈ 1.0e8 params
    "small": TwoTowerConfig(embed_dim=32, tower_mlp=(128, 64, 32),
                            n_user_features=4, n_item_features=4,
                            user_vocab=20_000, item_vocab=40_000),
    "100m": TwoTowerConfig(embed_dim=256, tower_mlp=(1024, 512, 256),
                           n_user_features=8, n_item_features=8,
                           user_vocab=150_000, item_vocab=150_000),
}


N_CLUSTERS = 64


def make_world(rng, n_users=10_000, n_items=20_000):
    return (rng.integers(0, N_CLUSTERS, n_users),
            rng.integers(0, N_CLUSTERS, n_items))


def feature_ids(entities, cluster_of, n_features, vocab):
    """Feature 0 = cluster id (categorical signal, e.g. genre); the rest are
    id hashes (memorization capacity)."""
    cols = [cluster_of[entities]]
    for j in range(1, n_features):
        cols.append((entities * 31 + j * 7919) % (vocab - N_CLUSTERS)
                    + N_CLUSTERS)
    return np.stack(cols, axis=1)


def synthetic_interactions(rng, cfg, batch, user_cluster, item_cluster,
                           device):
    """Clustered user→item preference structure (so training has signal);
    the ids reach ``device`` as int32, as ``repro``'s reach jnp."""
    n_users, n_items = len(user_cluster), len(item_cluster)
    by_cluster = [np.where(item_cluster == c)[0] for c in range(N_CLUSTERS)]

    def ids(x):
        return torch.from_numpy(x.astype(np.int32)).to(device)

    while True:
        users = rng.integers(0, n_users, batch)
        c = user_cluster[users]
        # positive item from the user's cluster
        items = np.array([by_cluster[ci][rng.integers(len(by_cluster[ci]))]
                          for ci in c])
        yield ({"user_ids": ids(feature_ids(users, user_cluster,
                                            cfg.n_user_features,
                                            cfg.user_vocab)),
                "item_ids": ids(feature_ids(items, item_cluster,
                                            cfg.n_item_features,
                                            cfg.item_vocab))},
               users, items)


def run(argv=None) -> dict:
    """Train, checkpoint, embed and compress; returns the numbers it
    prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="small", choices=tuple(SIZES))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_two_tower"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist; "
                         "--device cpu runs every kernel's plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SIZES[args.size]
    spec = R.two_tower_spec(cfg)
    tx = O.adamw(O.cosine_schedule(args.lr, 20, args.steps),
                 weight_decay=1e-4, max_grad_norm=1.0)
    state = trainer.init_state(
        torch.Generator().manual_seed(0),
        lambda g: L.init_params(g, spec, dev), tx)
    n_params = tree_num_params(state["params"])
    out = {"device": str(dev), "n_params": n_params, "resumed_from": None}
    print(f"model: {n_params / 1e6:.1f}M params")

    ck = Checkpointer(args.ckpt_dir, keep=2)
    if args.resume and ck.latest_step() is not None:
        state = ck.restore(state, device=dev)
        out["resumed_from"] = int(state["step"])
        print(f"resumed from step {int(state['step'])}")

    step_fn = trainer.make_train_step(
        lambda p, b: R.two_tower_loss(p, b, cfg), tx)
    handler = PreemptionHandler()
    try:
        rng = np.random.default_rng(0)
        user_cluster, item_cluster = make_world(rng)
        stream = synthetic_interactions(rng, cfg, args.batch, user_cluster,
                                        item_cluster, dev)
        first = int(state["step"])
        out["losses"] = []
        for i in range(first, args.steps):
            batch, _, _ = next(stream)
            state, metrics = step_fn(state, batch)
            if handler.should_stop():
                ck.save(state, i + 1, blocking=True)
                print(f"[preempted] checkpoint at step {i + 1}")
                out.update(preempted_at=i + 1, steps_trained=i + 1 - first)
                return out
            if (i + 1) % 50 == 0:
                loss = float(metrics["loss"])
                out["losses"].append((i + 1, loss))
                print(f"step {i + 1}: loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.2f}")
                ck.save(state, i + 1)
        ck.wait()
        out["steps_trained"] = max(0, args.steps - first)
    finally:
        handler.uninstall()

    # ---- build + compress the candidate index from the trained item tower
    print("\nembedding 20k candidate items ...")
    n_items = len(item_cluster)
    all_item_ids = feature_ids(np.arange(n_items), item_cluster,
                               cfg.n_item_features, cfg.item_vocab)
    item_emb = R.item_embedding(
        state["params"],
        torch.from_numpy(all_item_ids.astype(np.int32)).to(dev), cfg)

    batch, users, items = next(stream)
    user_emb = R.user_embedding(state["params"], batch["user_ids"], cfg)

    def cluster_p10(top10):
        got = item_cluster[top10.cpu().numpy()]             # (B, 10)
        want = user_cluster[users][:, None]
        return float(np.mean(got == want))

    _, exact10 = topk_search(user_emb, item_emb, 10)
    exact_p = cluster_p10(exact10)
    print(f"uncompressed cluster-precision@10: {exact_p:.3f} "
          f"(chance {1 / N_CLUSTERS:.3f})")

    dim = min(cfg.embed_dim // 2, 128)
    pipe = CompressionPipeline([CenterNorm(), PCA(dim), CenterNorm(),
                                Int8Quantizer()])
    idx = CompressedIndex.build(item_emb, user_emb, pipe, device=dev)
    _, comp10 = idx.search(user_emb, 10)
    comp_p = cluster_p10(comp10)
    ratio = (item_emb.numel() * 4) / idx.nbytes
    print(f"compressed  cluster-precision@10: {comp_p:.3f} at {ratio:.0f}x "
          f"smaller index "
          f"({100 * comp_p / max(exact_p, 1e-9):.0f}% retained)")
    out.update(exact_p10=exact_p, compressed_p10=comp_p, ratio=ratio,
               retained=comp_p / max(exact_p, 1e-9))
    return out


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    sys.exit(main())
