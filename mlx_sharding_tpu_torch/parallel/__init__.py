__all__ = ["DecodePlan", "PipelineEngine"]


def __getattr__(name):
    # loaded on first use: the models import ``parallel.mesh``, which the
    # engine's module imports in turn
    if name in __all__:
        from mlx_sharding_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)
