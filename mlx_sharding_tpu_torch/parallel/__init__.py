from mlx_sharding_tpu_torch.parallel.pipeline import DecodePlan, PipelineEngine

__all__ = ["DecodePlan", "PipelineEngine"]
