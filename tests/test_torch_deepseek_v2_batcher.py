"""DeepSeek-V2 through the paged batcher against the JAX batcher, on the
tiny config of ``tests/test_torch_deepseek_v2.py`` (f32) over the
compressed pool (one latent head, a dummy V; the paged decode reads the
latent as values): greedy streams of the packed model over an f32 pool and
of the dense model over an int8 pool, token-identical."""

from tests.test_torch_deepseek_v2 import _pair
from tests.test_torch_families import batcher_streams
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401


def test_batcher_streams_match_jax():
    """The packed model, three slots a step over the compressed f32 pool:
    the routed GEMV's gather path at N = 3, the paged decode with
    values_from_k."""
    _, jm, params, tm = _pair("compressed-packed")
    want, got = batcher_streams(jm, params, tm)
    assert got == want


def test_int8_pool_batcher_streams_match_jax():
    """An int8 pool (the latent rows quantized per row, K's scale serving
    V) against JAX's int8 batcher."""
    _, jm, params, tm = _pair("compressed")
    want, got = batcher_streams(jm, params, tm, kv_dtype="int8")
    assert got == want
