"""schnet [gnn] — n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
[arXiv:1706.08566; paper]"""

from repro_torch.configs.base import ArchConfig, GNN_SHAPES, SchNetConfig

FULL = SchNetConfig(
    name="schnet", n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)

REDUCED = SchNetConfig(
    name="schnet-smoke", n_interactions=2, d_hidden=16, n_rbf=24,
    cutoff=10.0, n_atom_types=16)

ARCH = ArchConfig(name="schnet", family="gnn", model=FULL,
                  shapes=GNN_SHAPES, reduced=REDUCED)
