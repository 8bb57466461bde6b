"""two-tower-retrieval [recsys] — embed_dim=256 tower_mlp=1024-512-256
interaction=dot, sampled-softmax retrieval.  [RecSys'19 (YouTube)]

This is the paper's own setting transplanted to recsys: the candidate item
index (10⁶–10⁷ embeddings) is exactly a KB index; the ``retrieval_cand``
shape exercises the compressed-index scoring path."""

from repro_torch.configs.base import ArchConfig, RECSYS_SHAPES, TwoTowerConfig

FULL = TwoTowerConfig(
    name="two-tower-retrieval", embed_dim=256, tower_mlp=(1024, 512, 256),
    n_user_features=8, n_item_features=8,
    user_vocab=5_000_000, item_vocab=10_000_000)

REDUCED = TwoTowerConfig(
    name="two-tower-smoke", embed_dim=16, tower_mlp=(64, 32, 16),
    n_user_features=4, n_item_features=4, user_vocab=1000, item_vocab=1000)

ARCH = ArchConfig(name="two-tower-retrieval", family="recsys", model=FULL,
                  shapes=RECSYS_SHAPES, reduced=REDUCED)
