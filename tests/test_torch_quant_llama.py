"""The keep-quantized path of the port against the JAX package on tiny
MLX 4-bit (and 2-bit) checkpoints written here (projections, embedding and head packed,
the recipe of tests/test_quant_matmul.py): both loaders in both modes, the
Generators' greedy streams, fusion, carrying packed trees across, and the
CLI and the server with ``--keep-quantized --device cpu``."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.config import config_from_dict as j_config_from_dict
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.loading import load_model as j_load_model
from mlx_sharding_tpu.models.base import apply_projection_fusion as j_fuse
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.ops.quant import quantize as j_quantize
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.loading import load_model
from mlx_sharding_tpu_torch.models.base import QuantizedLinear

PROMPT = [3, 17, 42, 9, 77]
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def write_mlx_4bit(path, *, group_size=64, bits=4, tie=False, tensors_from=None, config=None):
    """An MLX-style 4-bit checkpoint (or ``bits``): decoder projections and
    the vocab pair as {weight (uint32), scales, biases (fp16)} triples,
    norms dense f32. ``tensors_from`` quantizes an existing dense state dict
    instead of drawing one (the entry-point fixture)."""
    from safetensors.numpy import save_file

    cfg = config or dict(
        model_type="llama", vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
    )
    cfg = {**cfg, "tie_word_embeddings": tie,
           "quantization": {"group_size": group_size, "bits": bits}}
    rng = np.random.default_rng(7)
    h, inter, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    d = h // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * d
    tensors = {}

    def dense(name, shape):
        if tensors_from is not None:
            tensors[name] = tensors_from[name]
        else:
            tensors[name] = (rng.normal(size=shape) * 0.05).astype(np.float32)

    def quant(name, out_d, in_d):
        w = (tensors_from[name] if tensors_from is not None
             else (rng.normal(size=(out_d, in_d)) * 0.05).astype(np.float32))
        q, s, b = j_quantize(w, group_size=group_size, bits=bits)
        tensors[name] = q
        tensors[name.replace(".weight", ".scales")] = s
        tensors[name.replace(".weight", ".biases")] = b

    quant("model.embed_tokens.weight", v, h)
    dense("model.norm.weight", (h,))
    if not tie:
        quant("lm_head.weight", v, h)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        dense(f"{p}.input_layernorm.weight", (h,))
        dense(f"{p}.post_attention_layernorm.weight", (h,))
        for name, (o, n) in {"self_attn.q_proj": (h, h), "self_attn.k_proj": (kv, h),
                             "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, h),
                             "mlp.gate_proj": (inter, h), "mlp.up_proj": (inter, h),
                             "mlp.down_proj": (h, inter)}.items():
            quant(f"{p}.{name}.weight", o, n)
    path.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("mlx4bit")
    return {
        "untied": write_mlx_4bit(root / "untied"),
        "tied": write_mlx_4bit(root / "tied", tie=True),
        "gs32": write_mlx_4bit(root / "gs32", group_size=32),
        "bits2": write_mlx_4bit(root / "bits2", group_size=32, bits=2),
    }


def _loads(path, keep_quantized):
    jm, params = j_load_model(str(path), dtype=jnp.float32, keep_quantized=keep_quantized)
    tm, _ = load_model(str(path), dtype=torch.float32, device="cpu",
                       keep_quantized=keep_quantized)
    return jm, params, tm


def _prefill(jm, params, tm, n=16):
    prompt = np.random.default_rng(n).integers(0, 128, size=(1, n))
    jl, _ = jm(params, jnp.asarray(prompt, jnp.int32), jm.make_cache(1, 64, jnp.float32))
    tl, _ = tm(torch.from_numpy(prompt), tm.make_cache(1, 64))
    return np.asarray(jl), tl.numpy()


def _streams(jm, params, tm, prompt=PROMPT, n=10):
    jgen = JGenerator(jm, params, max_seq=64, cache_dtype=jnp.float32, prefill_chunk=8)
    tgen = Generator(tm, max_seq=64, prefill_chunk=8)
    return ([t for t, _ in jgen.generate_step(prompt, max_tokens=n)],
            [t for t, _ in tgen.generate_step(prompt, max_tokens=n)], tgen)


@pytest.mark.parametrize("keep_quantized", [True, False], ids=["packed", "dequantized"])
@pytest.mark.parametrize("variant", ["untied", "tied", "gs32", "bits2"])
def test_load_matches_jax(ckpts, variant, keep_quantized):
    """Both loaders, f32: prefill logits within 1e-4 at every position, and
    10 greedy tokens identical through both Generators (which fuse the
    packed projections)."""
    jm, params, tm = _loads(ckpts[variant], keep_quantized)
    want, got = _prefill(jm, params, tm)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    j_tokens, t_tokens, tgen = _streams(jm, params, tm)
    assert t_tokens == j_tokens
    assert bool(tgen.fused_projections) == keep_quantized


@pytest.mark.parametrize("variant", ["untied", "tied"])
def test_packed_and_dequantized_loads_agree(ckpts, variant):
    """The two modes of the port on one checkpoint: the same logits (1e-5)
    and the same greedy stream, as in the JAX package's own test."""
    packed, _ = load_model(str(ckpts[variant]), dtype=torch.float32, device="cpu",
                           keep_quantized=True)
    dense, _ = load_model(str(ckpts[variant]), dtype=torch.float32, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 128, size=(1, 12)))
    lp, _ = packed(prompt, packed.make_cache(1, 64))
    ld, _ = dense(prompt, dense.make_cache(1, 64))
    torch.testing.assert_close(lp, ld, rtol=1e-5, atol=1e-5)
    streams = [[t for t, _ in Generator(m, max_seq=64, prefill_chunk=8).generate_step(
        PROMPT, max_tokens=10)] for m in (packed, dense)]
    assert streams[0] == streams[1]


def _layer_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in [*model.layers.parameters(), *model.layers.buffers()])


@pytest.mark.parametrize("variant", ["untied", "tied"])
def test_packed_modules_really_are_packed(ckpts, variant):
    packed, cfg = load_model(str(ckpts[variant]), dtype=torch.float32, device="cpu",
                             keep_quantized=True)
    dense, _ = load_model(str(ckpts[variant]), dtype=torch.float32, device="cpu")
    for layer in packed.layers:
        for name in PROJ:
            mod = getattr(layer, name)
            assert isinstance(mod, QuantizedLinear) and mod.q.dtype == torch.int32
            assert mod.scales.dtype == torch.float16  # the checkpoint's dtype
    assert isinstance(packed.embed_tokens, QuantizedLinear)
    assert hasattr(packed, "lm_head") != cfg.tie_word_embeddings
    if not cfg.tie_word_embeddings:
        assert isinstance(packed.lm_head, QuantizedLinear)
    assert not isinstance(dense.layers[0].q_proj, QuantizedLinear)
    assert _layer_bytes(packed) < _layer_bytes(dense) / 2
    assert packed.compute_dtype == torch.float32


def test_stage_bounded_packed_load(ckpts):
    """[1, 2) of the packed checkpoint: one layer, no embedding, the head;
    its words are those of the full load's layer 1; hidden states from
    the first stage give the full model's logits."""
    path = str(ckpts["untied"])
    full, _ = load_model(path, dtype=torch.float32, device="cpu", keep_quantized=True)
    first, _ = load_model(path, end_layer=1, dtype=torch.float32, device="cpu",
                          keep_quantized=True)
    last, _ = load_model(path, start_layer=1, dtype=torch.float32, device="cpu",
                         keep_quantized=True)
    assert len(last.layers) == 1 and not hasattr(last, "embed_tokens")
    assert not hasattr(first, "lm_head") and isinstance(first.embed_tokens, QuantizedLinear)
    assert torch.equal(last.layers[0].o_proj.q, full.layers[1].o_proj.q)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 128, size=(1, 9)))
    h, _ = first(prompt, first.make_cache(1, 64))
    got, _ = last(h, last.make_cache(1, 64))
    want, _ = full(prompt, full.make_cache(1, 64))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_keep_quantized_on_a_dense_checkpoint_raises(tmp_path):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    path = make_tiny_checkpoint(tmp_path / "dense")
    with pytest.raises(ValueError, match="requires a quantized checkpoint"):
        load_model(str(path), dtype=torch.float32, device="cpu", keep_quantized=True)


def test_keep_quantized_refused_without_packed_support(ckpts, monkeypatch):
    from mlx_sharding_tpu_torch.models.llama import LlamaModel

    monkeypatch.setattr(LlamaModel, "supports_packed", False)
    with pytest.raises(ValueError, match="keep_quantized is not supported"):
        load_model(str(ckpts["untied"]), device="cpu", keep_quantized=True)


def test_generator_fuses_in_place_bit_exactly(ckpts):
    """Generator construction replaces q/k/v and gate/up with the fused
    modules in the caller's model; the fused forward is bit-equal to the
    unfused one; a second Generator finds nothing left to fuse."""
    model, _ = load_model(str(ckpts["untied"]), dtype=torch.float32, device="cpu",
                          keep_quantized=True)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 128, size=(1, 12)))
    before = [model(prompt[:, :t], model.make_cache(1, 64))[0] for t in (12, 1)]
    gen = Generator(model, max_seq=64, prefill_chunk=8)
    assert gen.fused_projections == ["qkv_proj", "gate_up_proj"]
    layer = model.layers[0]
    assert not any(hasattr(layer, n) for n in ("q_proj", "k_proj", "v_proj", "gate_proj"))
    assert layer.qkv_proj.q.shape[0] == 64 + 2 * 32 and layer.gate_up_proj.q.shape[0] == 256
    after = [model(prompt[:, :t], model.make_cache(1, 64))[0] for t in (12, 1)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert Generator(model, max_seq=64, prefill_chunk=8).fused_projections == []


def _packed_jax_tree(cfg_dict, seed, fuse):
    """A JAX Llama's dense params with every projection (and the vocab pair)
    packed by the JAX packer, stacked over layers, optionally fused."""
    cfg = j_config_from_dict(cfg_dict)
    jm = JLlamaModel(cfg)
    jm.compute_dtype = jnp.float32  # as j_load_model sets it for an f32 load
    params = jm.init_params(jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    if cfg.attention_bias:
        for name in ("q_bias", "k_bias", "v_bias"):
            layers[name] = jnp.asarray(rng.normal(size=layers[name].shape), jnp.float32)

    def pack(w_out_in):
        q, s, b = j_quantize(np.asarray(w_out_in), 64, 4)
        return {"q": jnp.asarray(q), "scales": jnp.asarray(s), "biases": jnp.asarray(b)}

    def stack(items):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *items)

    for name in PROJ:  # (L, in, out) -> L packed (out, in) triples
        layers[name] = stack([pack(np.asarray(w).T) for w in layers[name]])
    params = {**params, "layers": layers, "embed": {"weight": pack(params["embed"]["weight"])}}
    if "lm_head" in params:
        params["lm_head"] = {"weight": pack(np.asarray(params["lm_head"]["weight"]).T)}
    if fuse:
        assert j_fuse(jm, params["layers"]) == ["qkv_proj", "gate_up_proj"]
    return cfg, jm, params


@pytest.mark.parametrize("fuse", [False, True], ids=["separate", "fused"])
@pytest.mark.parametrize("variant", ["llama", "qwen2_biases", "tied"])
def test_params_from_numpy_carries_packed_trees(variant, fuse):
    """A packed (and optionally fused) JAX tree carried across gives the JAX
    model's logits within 1e-4 in f32; packed leaves are not transposed."""
    base = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=1, head_dim=64,
                quantization={"group_size": 64, "bits": 4})
    extra = {"llama": {}, "qwen2_biases": {"model_type": "qwen2"},
             "tied": {"tie_word_embeddings": True}}[variant]
    cfg, jm, params = _packed_jax_tree({**base, **extra}, seed=4, fuse=fuse)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    assert hasattr(tm.layers[0], "qkv_proj") == fuse
    assert isinstance(tm.embed_tokens, QuantizedLinear)
    want, got = _prefill(jm, params, tm, n=20)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=[4, 2], ids=["4bit", "2bit"])
def packed_tokenizer_ckpt(tmp_path_factory, request):
    """tests/make_tiny_checkpoint.py's checkpoint and tokenizer, its weights
    rewritten as an MLX 4-bit (or 2-bit) checkpoint."""
    from safetensors.numpy import load_file

    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    path = make_tiny_checkpoint(tmp_path_factory.mktemp("tok") / "ckpt")
    hf_cfg = json.loads((path / "config.json").read_text())
    dense = load_file(str(path / "model.safetensors"))
    (path / "model.safetensors").unlink()
    cfg = {k: hf_cfg[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                  "num_hidden_layers", "num_attention_heads",
                                  "num_key_value_heads", "rms_norm_eps", "rope_theta",
                                  "max_position_embeddings")}
    return write_mlx_4bit(path, tensors_from=dense, bits=request.param,
                          config={**cfg, "model_type": "llama"})


def test_cli_keep_quantized_on_cpu(packed_tokenizer_ckpt, capsys):
    from mlx_sharding_tpu_torch.cli.generate import main

    main(["--model", str(packed_tokenizer_ckpt), "--prompt", "the quick brown fox",
          "--max-tokens", "6", "--device", "cpu", "--max-seq", "256", "--prefill-chunk", "128",
          "--keep-quantized"])
    err = capsys.readouterr().err
    assert "Prompt:" in err and "Generation: 6 tokens" in err and "TTFT:" in err


def test_server_keep_quantized_on_cpu(packed_tokenizer_ckpt, monkeypatch):
    """``main --keep-quantized`` builds a provider over the packed, fused
    model; that provider answers a completion through the real server."""
    from mlx_sharding_tpu_torch.server import openai_api as tapi

    built = []

    class NoServe:
        def serve_forever(self):
            pass

    real_make_server = tapi.make_server
    monkeypatch.setattr(tapi, "make_server", lambda prov, host, port: built.append(prov) or NoServe())
    tapi.main(["--model", str(packed_tokenizer_ckpt), "--device", "cpu", "--max-seq", "256",
               "--prefill-chunk", "128", "--keep-quantized"])
    (provider,) = built
    model = provider.generator.model
    assert isinstance(model.layers[0].qkv_proj, QuantizedLinear)
    assert provider.generator.fused_projections == ["qkv_proj", "gate_up_proj"]
    srv = real_make_server(provider, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        conn.request("POST", "/v1/completions", json.dumps({"prompt": "hello", "max_tokens": 5}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert resp.status == 200 and body["usage"]["completion_tokens"] <= 5
    assert body["choices"][0]["finish_reason"] in ("length", "stop")
