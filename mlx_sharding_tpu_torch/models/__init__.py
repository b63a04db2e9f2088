"""Model construction (port of ``mlx_sharding_tpu/models/__init__.py``): a
registry keyed like JAX's by the remapped ``model_type``.
"""

from __future__ import annotations

import importlib

import torch

from mlx_sharding_tpu_torch.config import config_from_dict

# model_type -> (module, class)
MODEL_REGISTRY: dict[str, tuple[str, str]] = {
    "llama": ("mlx_sharding_tpu_torch.models.llama", "LlamaModel"),
    "qwen3": ("mlx_sharding_tpu_torch.models.qwen3", "Qwen3Model"),
    "gemma2": ("mlx_sharding_tpu_torch.models.gemma2", "Gemma2Model"),
    "mixtral": ("mlx_sharding_tpu_torch.models.mixtral", "MixtralModel"),
    "deepseek_v2": ("mlx_sharding_tpu_torch.models.deepseek_v2", "DeepseekV2Model"),
}


def build_model(config_dict: dict, dtype=torch.bfloat16):
    """config.json dict -> (model on the ``meta`` device, config). Give it
    weights with ``model.init_params`` or ``load_state_dict(assign=True)``."""
    cfg = config_from_dict(config_dict)
    module_name, class_name = MODEL_REGISTRY[cfg.model_type]
    cls = getattr(importlib.import_module(module_name), class_name)
    return cls(cfg, dtype=dtype), cfg
