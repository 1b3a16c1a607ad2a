"""Architecture registry of the port (the configs of the ported families)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    HybridConfig, ModelConfig, MoEConfig, SSMConfig,
)

# canonical names → module ids (dense, MoE, SSM, hybrid and
# encoder-decoder); the JAX zoo's vlm (pixtral-12b) comes with its family
# (ROADMAP.md queue 1, item 7b)
NAME_TO_MODULE = {
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "gemma3-1b": "gemma3_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen3-8b": "qwen3_8b",
    "qwen3-32b": "qwen3_32b",
    "dbrx-132b": "dbrx_132b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def get_config(name: str) -> ModelConfig:
    """Look up an architecture config by name or module id."""
    mod_name = NAME_TO_MODULE.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in NAME_TO_MODULE.values():
        raise ValueError(
            f"arch {name!r} is not ported yet (available: "
            f"{sorted(NAME_TO_MODULE)}); see ROADMAP.md queue 1")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


__all__ = ["HybridConfig", "ModelConfig", "MoEConfig", "NAME_TO_MODULE",
           "SSMConfig", "get_config"]
