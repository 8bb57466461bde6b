"""dcn-v2 [recsys] — n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512, cross interaction.  [arXiv:2008.13535]"""

from repro_torch.configs.base import ArchConfig, DCNConfig, RECSYS_SHAPES

FULL = DCNConfig(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                 n_cross_layers=3, mlp=(1024, 1024, 512),
                 vocab_per_field=1_000_000)

REDUCED = DCNConfig(name="dcn-v2-smoke", n_dense=5, n_sparse=6, embed_dim=4,
                    n_cross_layers=2, mlp=(32, 16), vocab_per_field=200)

ARCH = ArchConfig(name="dcn-v2", family="recsys", model=FULL,
                  shapes=RECSYS_SHAPES, reduced=REDUCED)
