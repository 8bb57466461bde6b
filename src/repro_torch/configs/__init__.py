"""Architecture configs: one module per assigned architecture + the paper's
own DPR-768 retrieval setup.  ``repro_torch.configs.registry`` resolves
``--arch`` names to :class:`~repro_torch.configs.base.ArchConfig` objects;
copies of ``repro.configs``, field for field (the LM configs are data for
the LM models still to port)."""

from repro_torch.configs.base import (ArchConfig, DCNConfig, DINConfig,
                                      FMConfig, LMConfig, MoEConfig,
                                      SchNetConfig, ShapeSpec, TwoTowerConfig)
from repro_torch.configs.registry import ARCH_NAMES, get_arch

__all__ = ["ArchConfig", "DCNConfig", "DINConfig", "FMConfig", "LMConfig",
           "MoEConfig", "SchNetConfig", "ShapeSpec", "TwoTowerConfig",
           "ARCH_NAMES", "get_arch"]
