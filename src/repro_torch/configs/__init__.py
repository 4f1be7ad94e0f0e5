"""Registry of the 10 assigned architectures (+ reduced smoke variants).

Every config cites its source in ``ModelConfig.source``; ``get_config(id)``
returns the full assigned config, ``get_reduced(id)`` the <=2-layer /
<=512-d_model / <=4-expert smoke variant exercised on CPU.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

ARCH_IDS: List[str] = [
    "qwen2_vl_2b",
    "qwen3_14b",
    "seamless_m4t_medium",
    "nemotron_4_340b",
    "deepseek_v2_236b",
    "mamba2_780m",
    "dbrx_132b",
    "deepseek_67b",
    "zamba2_2p7b",
    "llama3_8b",
]

#: CLI-facing ids (--arch <id>) -> module name
ALIASES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen3-14b": "qwen3_14b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "nemotron-4-340b": "nemotron_4_340b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-780m": "mamba2_780m",
    "dbrx-132b": "dbrx_132b",
    "deepseek-67b": "deepseek_67b",
    "zamba2-2.7b": "zamba2_2p7b",
    "llama3-8b": "llama3_8b",
}


def _module(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def list_archs() -> List[str]:
    return list(ALIASES.keys())
