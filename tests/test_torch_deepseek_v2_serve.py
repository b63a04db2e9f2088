"""DeepSeek-V2 on the single stream against the JAX package, on the tiny
config of ``tests/test_torch_deepseek_v2.py`` (f32) over the compressed
cache: greedy streams through both Generators, dense and packed, and
n-gram speculation against plain greedy. The paged batchers are in
``tests/test_torch_deepseek_v2_batcher.py``, the checkpoints and entry
points in ``tests/test_torch_deepseek_v2_checkpoints.py``."""

import pytest

from tests.test_torch_deepseek_v2 import _pair
from tests.test_torch_families import generator_streams
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=["compressed", "compressed-packed"])
def pair(request):
    return _pair(request.param)


def test_generator_streams_match_jax(pair):
    _, jm, params, tm = pair
    want, got = generator_streams(jm, params, tm)
    assert got == want


def test_ngram_speculation_matches_plain_greedy():
    """``--draft ngram`` on the single stream: the verify's T=K forward
    attends with the latent as values; token-identical to the port's plain
    greedy stream (held to JAX's above), with rounds drafted."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator

    *_, tm = _pair("compressed")
    ids = [5, 6, 7, 8, 9] * 6
    ng = NgramSpeculativeGenerator(tm, spec_window_max=4, max_seq=128, prefill_chunk=128)
    got = [t for t, _ in ng.generate_step(ids, max_tokens=24)]
    plain = [t for t, _ in Generator(tm, max_seq=128, prefill_chunk=128)
             .generate_step(ids, max_tokens=24)]
    assert got == plain
    assert ng.rounds > 0 and ng.draft_tokens > 0
