"""Architecture registry: --arch <id> resolves here (one module per assigned
architecture, exact public-literature configs; the same ten as the JAX
package's ``repro/configs``, widths unchanged)."""
from ..models.config import ModelConfig

from . import (olmoe_1b_7b, arctic_480b, stablelm_1_6b, deepseek_coder_33b,
               h2o_danube_1_8b, granite_8b, qwen2_vl_2b, zamba2_2_7b,
               mamba2_1_3b, seamless_m4t_large_v2)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (olmoe_1b_7b, arctic_480b, stablelm_1_6b, deepseek_coder_33b,
              h2o_danube_1_8b, granite_8b, qwen2_vl_2b, zamba2_2_7b,
              mamba2_1_3b, seamless_m4t_large_v2)
}

ARCH_IDS = tuple(sorted(REGISTRY))

__all__ = ["REGISTRY", "ARCH_IDS", "get_config", "ModelConfig"]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]
