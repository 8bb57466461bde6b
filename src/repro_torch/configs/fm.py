"""fm [recsys] — n_sparse=39 embed_dim=10, 2-way FM via the O(nk)
sum-square trick.  [Rendle, ICDM'10]"""

from repro_torch.configs.base import ArchConfig, FMConfig, RECSYS_SHAPES

FULL = FMConfig(name="fm", n_sparse=39, embed_dim=10,
                vocab_per_field=1_000_000)

REDUCED = FMConfig(name="fm-smoke", n_sparse=8, embed_dim=4,
                   vocab_per_field=500)

ARCH = ArchConfig(name="fm", family="recsys", model=FULL,
                  shapes=RECSYS_SHAPES, reduced=REDUCED)
