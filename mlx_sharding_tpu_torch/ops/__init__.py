from mlx_sharding_tpu_torch.ops.attention import causal_attention
from mlx_sharding_tpu_torch.ops.norms import rms_norm
from mlx_sharding_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["apply_rope", "causal_attention", "rms_norm", "rope_frequencies"]
