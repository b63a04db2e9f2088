"""Model construction (port of ``mlx_sharding_tpu/models/__init__.py``).

Only the Llama family (Llama, Mistral, Qwen2) is ported; every other
architecture raises and names the ROADMAP item that brings it.
"""

from __future__ import annotations

import torch

from mlx_sharding_tpu_torch.config import config_from_dict
from mlx_sharding_tpu_torch.models.llama import LlamaModel


def build_model(config_dict: dict, dtype=torch.bfloat16):
    """config.json dict -> (model on the ``meta`` device, config). Give it
    weights with ``model.init_params`` or ``load_state_dict(assign=True)``."""
    cfg = config_from_dict(config_dict)
    if cfg.model_type != "llama":
        raise NotImplementedError(
            f"model type {cfg.model_type!r} is not yet ported to PyTorch: see "
            "ROADMAP.md queue 1, item 5 (the other model families)"
        )
    return LlamaModel(cfg, dtype=dtype), cfg
