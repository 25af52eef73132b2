"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

The port's own copy of ``repro.configs`` (plain dataclasses; copied, never
imported, so ``repro_torch`` stays free of the reference package).  One
module per assigned architecture (exact published config).
"""

from __future__ import annotations

import importlib

from .base import (SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig, SSMConfig,
                   production_cfg)

ARCH_IDS = (
    "granite_moe_3b",
    "llama4_maverick_400b",
    "musicgen_medium",
    "hymba_1p5b",
    "minicpm3_4b",
    "yi_6b",
    "h2o_danube3_4b",
    "internlm2_1p8b",
    "phi3_vision_4p2b",
    "xlstm_1p3b",
)

# canonical spec ids (with dashes) → module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "granite-moe-3b-a800m": "granite_moe_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "musicgen-medium": "musicgen_medium",
    "hymba-1.5b": "hymba_1p5b",
    "minicpm3-4b": "minicpm3_4b",
    "yi-6b": "yi_6b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "internlm2-1.8b": "internlm2_1p8b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "xlstm-1.3b": "xlstm_1p3b",
})


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod.CONFIG


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS


__all__ = ["ARCH_IDS", "SHAPES", "MLAConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "ShapeConfig", "get_config", "list_archs",
           "production_cfg"]
