"""The model families beside Llama (Qwen3, Gemma-2, Mixtral, DeepSeek-V2):
the shared harness of ``tests/test_torch_qwen3.py``, ``test_torch_gemma2.py``,
``test_torch_mixtral.py`` and ``test_torch_deepseek_v2.py``, and the
registry's own checks.

A family's JAX model draws its parameters with ``init_params`` (optionally
packed to MLX 4-bit by the JAX packer) and ``convert.params_from_numpy``
carries them into the port, so both packages run the same numbers. Tiny
checkpoints are written by the tests themselves, HF-named, dense or MLX
4-bit, beside the byte-level tokenizer of ``tests/make_tiny_checkpoint.py``.
Each check states its tolerance."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.config import config_from_dict as j_config_from_dict
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.loading import load_model as j_load_model
from mlx_sharding_tpu.models import build_model as j_build_model
from mlx_sharding_tpu.ops.quant import quantize as j_quantize
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.loading import load_model
from mlx_sharding_tpu_torch.models import MODEL_REGISTRY, build_model
from mlx_sharding_tpu_torch.models.base import QuantizedLinear
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

# tiny configurations: narrow widths, 2-3 layers. Gemma-2's window (24) is
# shorter than the tests' sequences, so it cuts, and its caps (3 and 5) bend
# the scores of random weights; head dims 64
COMMON = dict(vocab_size=300, hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
              head_dim=64, max_position_embeddings=1024)
FAMILIES = {
    "qwen3": dict(COMMON, model_type="qwen3", intermediate_size=256, num_hidden_layers=2,
                  rope_theta=1e6, rms_norm_eps=1e-6),
    "gemma2": dict(COMMON, model_type="gemma2", intermediate_size=256, num_hidden_layers=3,
                   query_pre_attn_scalar=64, sliding_window=24, attn_logit_softcapping=3.0,
                   final_logit_softcapping=5.0, rms_norm_eps=1e-6),
    "mixtral": dict(COMMON, model_type="mixtral", intermediate_size=128, num_hidden_layers=2,
                    num_local_experts=4, num_experts_per_tok=2, rope_theta=1e6),
    # MLA (rank 16, rope 8, nope 16, v 12), a dense first layer, then 8
    # routed experts (top 3) beside 2 shared, YaRN past 64 positions
    "deepseek_v2": dict(
        model_type="deepseek_v2", vocab_size=300, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16,
        v_head_dim=12, n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3,
        first_k_dense_replace=1, max_position_embeddings=256, rms_norm_eps=1e-6,
        rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                      "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                      "mscale_all_dim": 0.707}),
}
# a packed DeepSeek-V2 widens what a 64-wide group must divide: every
# projection's IN (o_proj's heads x v, the experts' intermediate, kv_b's
# rank, q_b's q-LoRA rank)
DEEPSEEK_PACKABLE = dict(v_head_dim=16, moe_intermediate_size=64, kv_lora_rank=64)
QUANT = {"group_size": 64, "bits": 4}
# per-layer projections of the JAX trees, packed as (out, in) triples; the
# Mixtral router stays dense, as packed_keep_dense_re keeps it (and the
# DeepSeek-V2 router, and its kv_b in compressed mode)
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
        "q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj", "shared_gate", "shared_up",
        "shared_down")
EXPERTS = ("w_gate", "w_up", "w_down")
# f32 logits of the two packages: summation order only
F32_TOL = 1e-4
# bf16: both run bf16 weights and activations, rounding at other places; the
# relative L2 error of the logits over every position
BF16_REL_L2 = 5e-2
PROMPT = [3, 17, 42, 9, 77, 5, 120, 33, 64, 250, 11, 2, 98, 45, 7, 160, 201, 54, 19, 88, 31,
          140, 6, 71, 222, 13, 39, 190, 8, 101]
# the batcher runs: 3 slots over 10 pages of 8 positions; prompts mid-page,
# on a page edge and over several pages (past Gemma-2's window)
ENGINE = dict(microbatches=3, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)
JOBS = [(3, 10), (8, 12), (13, 14), (30, 16), (9, 18)]


# ------------------------------------------------------------------ trees
def jax_pair(family: str, dtype=jnp.float32, seed: int = 0, packed: bool = False, **overrides):
    """(config, JAX model, JAX params) of a tiny ``family`` model, its
    projections (and experts, and the vocab pair) packed to MLX 4-bit by the
    JAX packer when ``packed``."""
    cfg_dict = {**FAMILIES[family], **overrides}
    if packed:
        if family == "deepseek_v2":
            cfg_dict.update({**DEEPSEEK_PACKABLE, **overrides})
            if cfg_dict.get("q_lora_rank"):
                cfg_dict["q_lora_rank"] = 64
        cfg_dict["quantization"] = QUANT
    jm, cfg = j_build_model(cfg_dict)
    params = jm.init_params(jax.random.PRNGKey(seed), dtype)
    if packed:
        jm.compute_dtype = dtype  # as j_load_model sets it
        compressed = getattr(cfg, "mla_cache_mode", None) == "compressed"
        params = pack_tree(params, dense=("kv_b_proj",) if compressed else ())
    return cfg, jm, params


def _pack(w_out_in):
    q, s, b = j_quantize(np.asarray(w_out_in, np.float32), QUANT["group_size"], QUANT["bits"])
    return {"q": jnp.asarray(q), "scales": jnp.asarray(s), "biases": jnp.asarray(b)}


def _stack(items):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *items)


def _pack_layers(layers: dict, dense=()) -> dict:
    layers = dict(layers)
    for name in PROJ:
        if name in layers and name not in dense:  # (L, in, out) -> L packed (out, in) triples
            layers[name] = _stack([_pack(np.asarray(w).T) for w in layers[name]])
    for name in EXPERTS:
        if name in layers:  # (L, E, in, out) -> (L, E) packed triples
            layers[name] = _stack([_stack([_pack(np.asarray(we).T) for we in w])
                                   for w in layers[name]])
    return layers


def pack_tree(params: dict, dense=()) -> dict:
    """Pack a JAX tree as a ``keep_quantized`` load would; ``dense``: the
    projections that stay dense (DeepSeek-V2's kv_b in compressed mode).
    DeepSeek-V2's layer groups are packed group by group."""
    layers = params["layers"]
    if "input_norm" in layers:
        layers = _pack_layers(layers, dense)
    else:
        layers = {g: _pack_layers(group, dense) for g, group in layers.items()}
    out = {**params, "layers": layers, "embed": {"weight": _pack(params["embed"]["weight"])}}
    if "lm_head" in params:
        out["lm_head"] = {"weight": _pack(np.asarray(params["lm_head"]["weight"]).T)}
    return out


def port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def prompt(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 300, size=(1, n))


def f32(x) -> np.ndarray:
    return np.array(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def logits_both(jm, params, tm, tokens: np.ndarray, max_seq: int = 256):
    """One forward of ``tokens`` (1, T) through both packages from an empty
    cache: (JAX logits, port logits) as f32 numpy (1, T, V)."""
    dtype = jnp.float32 if tm.dtype == torch.float32 else jnp.bfloat16
    jl, _ = jm(params, jnp.asarray(tokens, jnp.int32), jm.make_cache(1, max_seq, dtype))
    tl, _ = tm(torch.from_numpy(tokens), tm.make_cache(1, max_seq))
    return f32(jl), f32(tl)


def prefill_then_decode(tm, tokens: np.ndarray, split: int, max_seq: int = 256):
    """The port's logits of ``tokens`` (1, T): the first ``split`` positions
    as one prefill, then T=1 steps; (1, T, V)."""
    cache = tm.make_cache(1, max_seq)
    t = torch.from_numpy(tokens)
    out, cache = tm(t[:, :split], cache)
    outs = [out]
    for i in range(split, tokens.shape[1]):
        step, cache = tm(t[:, i : i + 1], cache)
        outs.append(step)
    return f32(torch.cat(outs, dim=1))


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- streams
def generator_streams(jm, params, tm, ids=PROMPT, n=32, max_seq=128, chunk=128):
    """Greedy tokens of both single-stream Generators (f32)."""
    jgen = JGenerator(jm, params, max_seq=max_seq, cache_dtype=jnp.float32, prefill_chunk=chunk)
    tgen = Generator(tm, max_seq=max_seq, prefill_chunk=chunk)
    return ([t for t, _ in jgen.generate_step(ids, max_tokens=n)],
            [t for t, _ in tgen.generate_step(ids, max_tokens=n)])


def batch_jobs(seed: int = 7):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, 300, size=n)], dict(max_tokens=m)) for n, m in JOBS]


def _concurrent(batcher, jobs):
    results = [None] * len(jobs)

    def work(i, ids, kw):
        results[i] = [tok for tok, _ in batcher.generate_step(ids, **kw)]

    threads = [threading.Thread(target=work, args=(i, p, kw)) for i, (p, kw) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in results)
    return results


def batcher_streams(jm, params, tm, jobs=None, **engine):
    """Greedy streams of ``jobs`` through the JAX batcher (ragged engine on
    ``pipeline_mesh(1)``) and the port's, f32 pools (``engine``: more engine
    arguments for both, ``kv_dtype="int8"``)."""
    jobs = jobs or batch_jobs()
    jb = jscheduler.ContinuousBatcher(JPipelineEngine(
        jm, params, pipeline_mesh(1), cache_dtype=jnp.float32, paged_attention="ragged",
        **ENGINE, **engine), decode_block=3)
    try:
        want = _concurrent(jb, jobs)
    finally:
        jb.close()
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE, **engine), decode_block=3)
    try:
        got = _concurrent(tb, jobs)
    finally:
        tb.close()
    return want, got


# ------------------------------------------------------------ checkpoints
def hf_tensors(cfg: dict, seed: int = 7) -> dict:
    """HF-named float32 tensors of a tiny ``cfg`` model, (out, in)."""
    rng = np.random.default_rng(seed)
    h, inter, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    d = cfg.get("head_dim", 0)  # DeepSeek-V2's MLA dims are its own
    hq, kv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    family = cfg["model_type"]
    t = {}

    def w(name, *shape, scale=None):
        t[name] = (rng.normal(size=shape) * (scale or shape[-1] ** -0.5)).astype(np.float32)

    def norm(name, n):  # Gemma's (1 + w) norms near 1 too
        t[name] = (rng.normal(size=(n,)) * 0.1 + (0.0 if family == "gemma2" else 1.0)
                   ).astype(np.float32)

    w("model.embed_tokens.weight", v, h, scale=0.02 if family != "gemma2" else 0.05)
    norm("model.norm.weight", h)
    if family != "gemma2" and not cfg.get("tie_word_embeddings"):
        w("lm_head.weight", v, h)
    if family == "deepseek_v2":
        _deepseek_layers(cfg, w, norm)
        return t
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        norm(f"{p}.input_layernorm.weight", h)
        norm(f"{p}.post_attention_layernorm.weight", h)
        for name, (o, n) in {"q_proj": (hq, h), "k_proj": (kv, h), "v_proj": (kv, h),
                             "o_proj": (h, hq)}.items():
            w(f"{p}.self_attn.{name}.weight", o, n)
        if family == "qwen3":
            norm(f"{p}.self_attn.q_norm.weight", d)
            norm(f"{p}.self_attn.k_norm.weight", d)
        if family == "gemma2":
            norm(f"{p}.pre_feedforward_layernorm.weight", h)
            norm(f"{p}.post_feedforward_layernorm.weight", h)
        if family == "mixtral":
            w(f"{p}.block_sparse_moe.gate.weight", cfg["num_local_experts"], h)
            for e in range(cfg["num_local_experts"]):
                q = f"{p}.block_sparse_moe.experts.{e}"
                w(f"{q}.w1.weight", inter, h)
                w(f"{q}.w3.weight", inter, h)
                w(f"{q}.w2.weight", h, inter)
        else:
            w(f"{p}.mlp.gate_proj.weight", inter, h)
            w(f"{p}.mlp.up_proj.weight", inter, h)
            w(f"{p}.mlp.down_proj.weight", h, inter)
    return t


def _deepseek_layers(cfg: dict, w, norm) -> None:
    """DeepSeek-V2's HF layer tensors: MLA (``kv_a_proj_with_mqa``,
    ``kv_a_layernorm``, ``kv_b_proj``; q-LoRA's ``q_a``/``q_b`` when set),
    a dense SwiGLU below ``first_k_dense_replace``, then the router
    (``mlp.gate``), per-expert and shared-expert projections."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope_d, v_d = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, mi = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    si = mi * cfg["n_shared_experts"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        norm(f"{p}.input_layernorm.weight", h)
        norm(f"{p}.post_attention_layernorm.weight", h)
        if cfg.get("q_lora_rank"):
            w(f"{p}.self_attn.q_a_proj.weight", cfg["q_lora_rank"], h)
            norm(f"{p}.self_attn.q_a_layernorm.weight", cfg["q_lora_rank"])
            w(f"{p}.self_attn.q_b_proj.weight", heads * (nope + rope_d), cfg["q_lora_rank"])
        else:
            w(f"{p}.self_attn.q_proj.weight", heads * (nope + rope_d), h)
        w(f"{p}.self_attn.kv_a_proj_with_mqa.weight", rank + rope_d, h)
        norm(f"{p}.self_attn.kv_a_layernorm.weight", rank)
        w(f"{p}.self_attn.kv_b_proj.weight", heads * (nope + v_d), rank)
        w(f"{p}.self_attn.o_proj.weight", h, heads * v_d)
        if i < cfg["first_k_dense_replace"]:
            w(f"{p}.mlp.gate_proj.weight", cfg["intermediate_size"], h)
            w(f"{p}.mlp.up_proj.weight", cfg["intermediate_size"], h)
            w(f"{p}.mlp.down_proj.weight", h, cfg["intermediate_size"])
            continue
        w(f"{p}.mlp.gate.weight", cfg["n_routed_experts"], h)
        for e in range(cfg["n_routed_experts"]):
            w(f"{p}.mlp.experts.{e}.gate_proj.weight", mi, h)
            w(f"{p}.mlp.experts.{e}.up_proj.weight", mi, h)
            w(f"{p}.mlp.experts.{e}.down_proj.weight", h, mi)
        w(f"{p}.mlp.shared_experts.gate_proj.weight", si, h)
        w(f"{p}.mlp.shared_experts.up_proj.weight", si, h)
        w(f"{p}.mlp.shared_experts.down_proj.weight", h, si)


def _packable(name: str) -> bool:
    return name.endswith(".weight") and "norm" not in name and "layernorm" not in name


def write_checkpoint(path, cfg: dict, tensors: dict, quantized: bool = False):
    """``config.json`` and one safetensors file; ``quantized``: every
    projection (the router too, which a packed load dequantizes) and the
    vocab pair as MLX 4-bit triples, norms dense."""
    from safetensors.numpy import save_file

    out, cfg = {}, dict(cfg)
    for name, value in tensors.items():
        if quantized and _packable(name) and value.ndim == 2:
            q, s, b = j_quantize(value, QUANT["group_size"], QUANT["bits"])
            out[name], out[name[:-6] + "scales"], out[name[:-6] + "biases"] = q, s, b
        else:
            out[name] = value
    if quantized:
        cfg["quantization"] = QUANT
    path.mkdir(parents=True, exist_ok=True)
    save_file(out, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(cfg))
    return path


def tokenizer_checkpoint(root, family: str, quantized: bool = False, **overrides):
    """``tests/make_tiny_checkpoint.py``'s tokenizer beside a tiny
    ``family`` checkpoint of its vocabulary (EOS id 0)."""
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    path = make_tiny_checkpoint(root)
    vocab = json.loads((path / "config.json").read_text())["vocab_size"]
    (path / "model.safetensors").unlink()
    cfg = {**FAMILIES[family], "vocab_size": vocab, "eos_token_id": 0, **overrides}
    if quantized and family == "deepseek_v2":
        cfg.update(DEEPSEEK_PACKABLE)
    return write_checkpoint(path, cfg, hf_tensors(cfg), quantized)


def loads_match(path, keep_quantized: bool, n: int = 20):
    """Both loaders on one checkpoint, f32: the prefill logits at every
    position within ``F32_TOL``; returns the port's model."""
    jm, params = j_load_model(str(path), dtype=jnp.float32, keep_quantized=keep_quantized)
    tm, _ = load_model(str(path), dtype=torch.float32, device="cpu",
                       keep_quantized=keep_quantized)
    want, got = logits_both(jm, params, tm, prompt(n, seed=3), max_seq=64)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    return tm


def serve_cli_and_server(path, monkeypatch, capsys, extra=()):
    """The CLI, then the server single-stream and with ``--concurrent 2
    --paged-pool 10``, all with ``--device cpu``: the CLI prints its
    generation, and each server answers a completion through HTTP."""
    from mlx_sharding_tpu_torch.cli.generate import main as cli_main
    from mlx_sharding_tpu_torch.server import openai_api as tapi

    cli_main(["--model", str(path), "--prompt", "the quick brown fox", "--max-tokens", "6",
              "--device", "cpu", "--max-seq", "128", "--prefill-chunk", "64", *extra])
    err = capsys.readouterr().err
    assert "Prompt:" in err and "Generation:" in err and "TTFT:" in err
    real_make_server = tapi.make_server
    for mode in ([], ["--concurrent", "2", "--paged-pool", "10"]):
        built = []

        class NoServe:
            def serve_forever(self):
                pass

        monkeypatch.setattr(tapi, "make_server",
                            lambda prov, host, port, **kw: built.append(prov) or NoServe())
        tapi.main(["--model", str(path), "--device", "cpu", "--max-seq", "128",
                   "--prefill-chunk", "64", *extra, *mode])
        (provider,) = built
        srv = real_make_server(provider, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": "hello world", "max_tokens": 5}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            if hasattr(provider.generator, "close"):
                provider.generator.close()
        assert resp.status == 200 and 0 < body["usage"]["completion_tokens"] <= 5, body
        assert body["choices"][0]["finish_reason"] in ("length", "stop")
    monkeypatch.setattr(tapi, "make_server", real_make_server)


# ------------------------------------------------------- the registry
def test_registry_keys_match_jax():
    """The port's registry holds every JAX family, DeepSeek-V2 included."""
    from mlx_sharding_tpu.models import MODEL_REGISTRY as J_REGISTRY

    assert set(MODEL_REGISTRY) == set(J_REGISTRY)


def test_deepseek_v2_raises_naming_the_roadmap():
    """DeepSeek-V2 no longer raises: ``build_model`` builds its module, a
    dense first layer and MoE layers after it, and its caches take JAX's
    per-tensor head dims."""
    tm, cfg = build_model({"model_type": "deepseek_v2", "vocab_size": 64, "hidden_size": 64,
                           "intermediate_size": 128, "num_hidden_layers": 2,
                           "num_attention_heads": 4, "num_key_value_heads": 4,
                           "kv_lora_rank": 16, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
                           "v_head_dim": 12, "n_routed_experts": 4, "moe_intermediate_size": 32})
    assert type(tm).__name__ == "DeepseekV2Model"
    assert [layer.moe for layer in tm.layers] == [False, True]
    assert (tm.cache_head_dim(), tm.cache_num_heads()) == ((24, 1), 1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_modules_and_hooks(family):
    """Each family builds its own module, with JAX's hooks: Gemma-2 ties its
    head and scales its embedding, Mixtral keeps its router dense under a
    packed load, and every family takes packed weights."""
    tm, cfg = build_model(FAMILIES[family], dtype=torch.float32)
    jm, _ = j_build_model(FAMILIES[family])
    assert type(tm).__name__ == type(jm).__name__
    assert tm.supports_packed and jm.supports_packed
    assert tm.head_is_tied() == jm.head_is_tied()
    assert tm.packed_keep_dense_re() == jm.packed_keep_dense_re()
    assert tm.scale == pytest.approx(jm.scale)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_packed_trees_carry_across_f32(family):
    """A packed JAX tree (projections, experts and the vocab pair at 4 bits,
    the Mixtral router dense) carried across gives the JAX model's logits at
    every position within ``F32_TOL``; the port's stacks stay packed."""
    cfg, jm, params = jax_pair(family, packed=True, seed=1)
    tm = port(cfg, params)
    assert isinstance(tm.embed_tokens, QuantizedLinear)
    layer = tm.layers[0]
    assert isinstance(layer.q_proj, QuantizedLinear)
    if family == "mixtral":
        assert isinstance(layer.w_gate, QuantizedLinear) and layer.w_gate.q.dim() == 3
        assert not isinstance(layer.router, QuantizedLinear)
    want, got = logits_both(jm, params, tm, prompt(20, seed=2))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_configs_round_trip_through_jax():
    """The tiny configurations read the same in both packages."""
    from mlx_sharding_tpu_torch.config import config_from_dict

    for cfg in FAMILIES.values():
        assert config_from_dict(cfg).to_dict() == j_config_from_dict(cfg).to_dict()
