"""The port's DeepSeek-V2 (``models/deepseek_v2.py``) against the JAX model
on a tiny config (3 layers, hidden 64, 4 heads, MLA rank 16 / rope 8 / nope
16 / v 12, a dense first layer, 8 routed experts top 3 beside 2 shared,
YaRN past 64 positions), the JAX weights carried across by
``convert.params_from_numpy``: the whole forward at every position in f32
in both cache layouts, dense and packed (MLX 4-bit, the router and, in
compressed mode, kv_b dense; the packed cases widen v, the expert width and
the rank to 16, 64 and 64 so that every projection's IN is a multiple of
the group of 64), with q-LoRA and with group-limited gating; prefill
against decode; the compressed layout's attention handed the latent as
values. The ops' own parity (YaRN, the interleaved RoPE, the
routing with ties) is held here too. The served paths are in
``tests/test_torch_deepseek_v2_serve.py``. Tolerances are the harness's
(``tests/test_torch_families.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import moe as jmoe
from mlx_sharding_tpu.ops import rope as jrope
from mlx_sharding_tpu_torch.models.base import QuantizedLinear
from mlx_sharding_tpu_torch.ops import moe, rope
from tests.test_torch_families import (
    F32_TOL,
    FAMILIES,
    jax_pair,
    logits_both,
    port,
    prefill_then_decode,
    prompt,
)
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

FAMILY = "deepseek_v2"
YARN = FAMILIES[FAMILY]["rope_scaling"]
# (cache mode, packed, overrides): both layouts dense and packed, q-LoRA,
# and V2's group-limited gating (4 groups of 2 experts, the top 2 kept)
VARIANTS = {
    "compressed": ("compressed", False, {}),
    "compressed-packed": ("compressed", True, {}),
    "full": ("full", False, {}),
    "full-packed": ("full", True, {}),
    "q_lora": ("compressed", False, dict(q_lora_rank=24)),
    "group_limited": ("compressed", False, dict(topk_method="group_limited_greedy", n_group=4,
                                                topk_group=2, norm_topk_prob=True,
                                                routed_scaling_factor=16.0)),
}


def _pair(name: str, seed: int = 2, dtype=jnp.float32):
    mode, packed, over = VARIANTS[name]
    cfg, jm, params = jax_pair(FAMILY, dtype=dtype, packed=packed, seed=seed,
                               mla_cache_mode=mode, **over)
    return cfg, jm, params, port(cfg, params)


# ------------------------------------------------------------------ ops
def test_yarn_frequencies_and_mscale_match_jax():
    for scaling in (YARN, {**YARN, "attention_factor": 0.5}, {"type": "yarn", "factor": 4}):
        got = rope.yarn_frequencies(8, 10000.0, scaling, 256)
        want = jrope.yarn_frequencies(8, 10000.0, scaling, 256)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for scale, m in ((40.0, 0.707), (1.0, 0.707), (0.5, 1.0)):
        assert rope.yarn_get_mscale(scale, m) == jrope.yarn_get_mscale(scale, m)


@pytest.mark.parametrize("offset", [0, 37, "rows"])
def test_interleaved_rope_matches_jax(offset):
    """Adjacent pairs rotated together, the attention factor on cos and sin;
    a host offset or per-row positions."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 2, 8)).astype(np.float32)
    inv_freq, factor = jrope.yarn_frequencies(8, 10000.0, YARN, 256)
    off = np.asarray([0, 9, 200]) if offset == "rows" else offset
    want = jrope.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(inv_freq), jnp.asarray(off),
                                        factor)
    got = rope.apply_rope_interleaved(torch.from_numpy(x), torch.from_numpy(inv_freq),
                                      torch.from_numpy(off) if offset == "rows" else off, factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method,n_group,topk_group", [("greedy", 1, 1),
                                                       ("group_limited_greedy", 4, 2),
                                                       ("group_limited_greedy", 8, 3)])
@pytest.mark.parametrize("norm", [False, True])
def test_deepseek_routing_matches_jax_with_ties(method, n_group, topk_group, norm):
    """Weights and ids equal to JAX's on random rows and on rows whose
    scores tie (a zero router row, duplicated router rows): both top-k
    steps break ties to the lower index."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 16)).astype(np.float32)
    router = rng.normal(size=(16, 8)).astype(np.float32)
    router[:, 5] = router[:, 2]  # experts 2 and 5 tie on every row
    router[:, 6] = router[:, 7] = router[:, 1]  # 1, 6 and 7 tie
    x[:3] = 0.0  # uniform scores: every expert and group ties
    kw = dict(norm_topk_prob=norm, routed_scaling_factor=2.5, topk_method=method,
              n_group=n_group, topk_group=topk_group)
    jw, ji = jmoe.deepseek_routing(jnp.asarray(x), jnp.asarray(router), 3, **kw)
    tw, ti = moe.deepseek_routing(torch.from_numpy(x), torch.from_numpy(router.T.copy()), 3,
                                  **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_logits_match_jax_f32_and_prefill_equals_decode(name):
    """A 72-token forward (the experts' scan; YaRN's interpolated
    frequencies past position 64) at every position within ``F32_TOL`` of
    JAX's, and the same positions as a 64-token prefill then T=1 steps (the
    gather path). The port's cache takes JAX's per-tensor head dims."""
    cfg, jm, params, tm = _pair(name)
    tokens = prompt(72, seed=1)
    want, got = logits_both(jm, params, tm, tokens, max_seq=128)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    jc, tc = jm.make_cache(1, 16, jnp.float32), tm.make_cache(1, 16)
    assert tuple(tc.k.shape) == jc.k.shape and tuple(tc.v.shape) == jc.v.shape
    np.testing.assert_allclose(prefill_then_decode(tm, tokens, 64, max_seq=128), got,
                               rtol=F32_TOL, atol=F32_TOL)
    if VARIANTS[name][1]:  # packed: the projections and stacks stay packed
        layers = tm.layers
        assert isinstance(layers[0].q_proj, QuantizedLinear)
        assert isinstance(layers[1].w_gate, QuantizedLinear) and layers[1].w_gate.q.dim() == 3
        assert not isinstance(layers[1].router, QuantizedLinear)
        assert isinstance(layers[1].kv_b_proj, QuantizedLinear) == (VARIANTS[name][0] == "full")


def test_compressed_attention_reads_values_from_the_keys(monkeypatch):
    """In compressed mode every layer's attention is handed the cache's K
    with V a view of its first ``kv_lora_rank`` columns (what sends the card
    to the kernels' values_from_k), and the injected ``attn_fn`` of the
    batcher is called with ``values_from_k``."""
    from mlx_sharding_tpu_torch.models import deepseek_v2
    from mlx_sharding_tpu_torch.ops.flash_attention import values_from_k

    _, _, _, tm = _pair("compressed")
    seen = []
    real = deepseek_v2.causal_attention

    def spy(q, k, v, *a, **kw):
        seen.append(values_from_k(k, v) and v.shape[-1] == 16)
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(deepseek_v2, "causal_attention", spy)
    tm(torch.from_numpy(prompt(8)), tm.make_cache(1, 64))
    assert seen == [True] * len(tm.layers)
    assert tm.attn_options(tm.layers[0]) == {"values_from_k": 16}
