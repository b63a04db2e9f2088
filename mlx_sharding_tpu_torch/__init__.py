"""PyTorch/CUDA port of ``mlx_sharding_tpu``, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; each module here carries
its counterpart's name. This package imports ``torch`` and never ``jax`` or
anything of ``mlx_sharding_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; kernels live in ``csrc/`` and are built with
``nvcc`` on first use.

Ported so far: the single-stream Llama-family serving path (config,
tokenizer utilities, ops, dense KV cache, model, sampler, loading,
generation, CLI and OpenAI server). See ROADMAP.md for what follows.
"""
