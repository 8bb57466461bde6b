"""din [recsys] — embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80,
target attention over user history.  [arXiv:1706.06978]"""

from repro_torch.configs.base import ArchConfig, DINConfig, RECSYS_SHAPES

FULL = DINConfig(name="din", embed_dim=18, seq_len=100,
                 attn_mlp=(80, 40), mlp=(200, 80),
                 item_vocab=2_000_000, n_context_features=4,
                 context_vocab=100_000)

REDUCED = DINConfig(name="din-smoke", embed_dim=8, seq_len=12,
                    attn_mlp=(16, 8), mlp=(24, 12), item_vocab=500,
                    n_context_features=2, context_vocab=100)

ARCH = ArchConfig(name="din", family="recsys", model=FULL,
                  shapes=RECSYS_SHAPES, reduced=REDUCED)
