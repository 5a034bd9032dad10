from .base import (LM_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   LoRAConfig, MoEConfig, ModelConfig, ShapeConfig, SSMConfig,
                   reduced, shapes_for)
from .archs import (ASSIGNED, PAPER_MODELS, REGISTRY, get_config)

__all__ = [
    "LM_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K", "TRAIN_4K",
    "LoRAConfig", "MoEConfig", "ModelConfig", "ShapeConfig", "SSMConfig",
    "reduced", "shapes_for", "ASSIGNED", "PAPER_MODELS", "REGISTRY",
    "get_config",
]
