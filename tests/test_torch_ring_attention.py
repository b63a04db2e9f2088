"""Ring attention in the port against the JAX package's, on the CPU in f32
(the cases of ``tests/test_ring_attention.py``): over sp = 4, 8 and 2
shards, GQA, against JAX's ``ring_attention`` over ``make_mesh(sp=...)`` and
its dense causal attention; the one-shard ring; and the options JAX's ring
takes inside a model (Gemma-2's softcap and window, MLA's values from the
keys), against JAX's ``causal_attention`` with the same options. The ring
here rotates a list of shards (``parallel.mesh.ppermute``), every shard on
the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.ops import causal_attention as jcausal
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.parallel.ring_attention import ring_attention as jring
from mlx_sharding_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_local
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

CPU = [torch.device("cpu")]


def _qkv(b, t, hq, hkv, d, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, dv or d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sp,hq,hkv", [(4, 4, 4), (8, 8, 2), (2, 4, 2)])
def test_ring_matches_jax(sp, hq, hkv):
    """The ring over sp shards against JAX's dense causal attention (JAX's
    test), and at sp = 2 against JAX's ring over ``make_mesh(sp=2)``."""
    q, k, v = _qkv(1, 32, hq, hkv, 8)
    scale = 8 ** -0.5
    dense = np.asarray(jcausal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(0),
                               scale))
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), scale, CPU * sp).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)
    if sp == 2:
        want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                make_mesh(sp=sp)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ring_single_shard_degenerate():
    q, k, v = _qkv(2, 8, 2, 2, 4, seed=1)
    dense = np.asarray(jcausal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(0),
                               0.5))
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0.5, CPU).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("opts", [dict(logit_softcap=3.0), dict(sliding_window=5),
                                  dict(logit_softcap=3.0, sliding_window=9),
                                  dict(values_from_k=6)],
                         ids=["softcap", "window", "softcap_window", "values_from_k"])
def test_ring_options_match_jax_attention(opts):
    """The ring with a layer's options over 4 shards of 8 rows in sub-tiles
    of 4 (blocks behind the window or in the future skipped) equals JAX's
    dense causal attention with them; with ``values_from_k`` only the key
    blocks rotate and the values are their first columns."""
    q, k, v = _qkv(1, 32, 4, 2, 8, seed=2)
    vfk = opts.get("values_from_k")
    jv = k[..., :vfk] if vfk else v
    jopts = {key: val for key, val in opts.items() if key != "values_from_k"}
    want = np.asarray(jcausal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(jv), jnp.asarray(0),
                              0.3, **jopts))
    split = lambda x: list(torch.from_numpy(x).chunk(4, dim=1))  # noqa: E731
    got = ring_attention_local(split(q), split(k), split(v), 0.3, block_k=4, **opts)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want, rtol=2e-4, atol=2e-4)
