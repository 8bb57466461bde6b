"""``--arch`` name → ArchConfig resolution."""

from __future__ import annotations

import importlib

_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "schnet": "repro_torch.configs.schnet",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "fm": "repro_torch.configs.fm",
    "din": "repro_torch.configs.din",
    "dcn-v2": "repro_torch.configs.dcn_v2",
    "paper-dpr": "repro_torch.configs.paper_dpr",
}

ARCH_NAMES = tuple(n for n in _MODULES if n != "paper-dpr")
ALL_NAMES = tuple(_MODULES)


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).ARCH
