"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed as it runs; any failure exits non-zero without the
final line:

1. device: the card's name and power limit (nvidia-smi);
2. kernels: build every kernel of the main path from ``csrc/`` with nvcc,
   print the ``-Xptxas -v`` lines, and hold each kernel against its plain
   PyTorch version on the card at the main path's shapes (and a few more);
3. timing: each kernel, its plain version and the one PyTorch library call
   that computes the same function, with CUDA events;
4. main path: Llama-3.1-8B at full width (bf16 weights drawn on the card
   from ``--seed``) behind the port's OpenAI server in a thread, with a
   byte-level tokenizer defined here; five requests (a 600-token completion
   with logprobs, a streamed chat, a seeded top-p sample twice, a streamed
   600-token completion for TTFT and decode tok/s), flash launches checked
   against 32 x the prompt chunks, and the kernel path checked against the
   plain attention path of the same model.

The last three lines are the kernel JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import math
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The published meta-llama/Llama-3.1-8B config.json.
LLAMA_31_8B = {
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 128,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "rope_scaling": {
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    "max_position_embeddings": 131072,
    "tie_word_embeddings": False,
}
MAX_SEQ = 4096
CHUNK = 256
# chunk offsets of the main path's 600-token prompt
MAIN_PATH_OFFSETS = (0, 256, 512)
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Kernel against plain version. bf16: the kernel rounds P to bf16 before
# the P V product and the plain version keeps fp32; outputs are rounded to
# bf16 (8 significant bits). An output's scale falls like 1/sqrt(keys it
# sees), so the limit per element follows the reference: a tenth of its rms
# plus 2^-6 of the element (2-4 bf16 ulps). f32: summation order only.
BF16_RMS_FRAC = 0.1
BF16_REL = 2.0**-6
F32_ATOL = 1e-4
REL_L2_TOL = 1e-2
# bf16 weights and activations over 32 random layers, the kernel path (bf16
# P in the kernel) against the plain path (bf16 probs): relative L2 error of
# the last position's logits
LOGITS_RTOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def attention_inputs(gen, b, t, s, hq, hkv, dk, dv, dtype):
    """q (B,T,Hq,Dk) as the projections give it; k, v as one layer of the
    (L, B, S, Hkv, D) cache, sliced from a two-layer buffer so the strides
    are the main path's."""
    dev = "cuda"
    q = torch.randn((b, t, hq, dk), generator=gen, device=dev, dtype=torch.float32).to(dtype)
    kc = torch.randn((2, b, s, hkv, dk), generator=gen, device=dev, dtype=torch.float32).to(dtype)
    vc = torch.randn((2, b, s, hkv, dv), generator=gen, device=dev, dtype=torch.float32).to(dtype)
    return q, kc[1], vc[1]


def kernel_disagreement(got, ref):
    """(max |got - ref|, the worst ratio of |got - ref| to its limit, the
    relative L2 error). The kernel agrees with its plain version iff the
    ratio is <= 1 and the L2 error <= REL_L2_TOL."""
    bf16 = ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    if bf16:
        limit = BF16_RMS_FRAC * ref.pow(2).mean().sqrt() + BF16_REL * ref.abs()
    else:
        limit = torch.full_like(ref, F32_ATOL)
    rel_l2 = ((got - ref).norm() / ref.norm()).item()
    return diff.max().item(), (diff / limit).max().item(), rel_l2


def attention_work(q, k, v, offset):
    """FLOPs and bytes the causal prefill function needs on these inputs:
    each query row i attends to min(S, offset+i+1) keys; q and the output
    are moved once, and K/V rows of the causal prefix once."""
    b, t, hq, dk = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    keys = sum(min(s, offset + i + 1) for i in range(t))
    flops = 2 * b * hq * (dk + dv) * keys
    kv_len = min(s, offset + t)
    el = q.element_size()
    nbytes = el * (b * t * hq * (dk + dv) + b * kv_len * hkv * (dk + dv))
    return flops, nbytes


def bound_ms(q, k, v, offset):
    """(least time, ms at the peak operation rate, ms at the memory rate)"""
    flops, nbytes = attention_work(q, k, v, offset)
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, t_bytes


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, CUDA events around each call. Before
    each: the 50 MB L2 is flushed (the main path finds a layer's K/V cold
    after the other 31 layers ran), then the card sleeps ~1 ms so that the
    host enqueues the events and the call while it is busy, and the events
    time the device alone, not the host's enqueueing."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def sdpa_call(q, k, v, offset, scale):
    """The library yardstick: scaled_dot_product_attention with the same
    causal mask over the keys the function needs (the cache's first
    offset + T rows, as the kernel reads). Timed here only; the port never
    calls it."""
    t = q.shape[1]
    kv_len = min(k.shape[1], offset + t)
    q_pos = offset + torch.arange(t, device=q.device)[:, None]
    mask = torch.arange(kv_len, device=q.device)[None, :] <= q_pos
    qt = q.transpose(1, 2)
    kt, vt = k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True
        ).transpose(1, 2)

    return call


# ---------------------------------------------------------------- phases
def phase_kernels(seed: int) -> float:
    """Returns the largest error at the main path's shapes."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    build_log = fa.build()
    log(f"[kernels] built {fa.SOURCE.name} in {time.perf_counter() - t0:.1f}s")
    for line in build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line or "cached" in line:
            log(f"[kernels]   ptxas: {line.strip()}")
    log(f"[kernels] shared memory per block at D=128 bf16: "
        f"{fa.shared_memory_bytes(torch.bfloat16, 128, 128)} bytes")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [
        # (b, t, s, hq, hkv, dk, dv, offset, dtype): the main path's bf16
        # shapes at the start, middle and end of the cache
        (1, 256, MAX_SEQ, 32, 8, 128, 128, 0, torch.bfloat16),
        (1, 256, MAX_SEQ, 32, 8, 128, 128, 256, torch.bfloat16),
        (1, 256, MAX_SEQ, 32, 8, 128, 128, 3840, torch.bfloat16),
        # f32 small shapes, GQA groups 1, 4 and 8
        (2, 128, 256, 4, 4, 64, 64, 0, torch.float32),
        (1, 128, 384, 8, 2, 64, 64, 100, torch.float32),
        (1, 256, 512, 16, 2, 128, 128, 256, torch.float32),
        # Dk != Dv (DeepSeek MLA full mode), both dtypes
        (1, 128, 256, 8, 8, 192, 128, 64, torch.float32),
        (1, 256, 512, 16, 16, 192, 128, 128, torch.bfloat16),
        # ragged T (the wrapper takes any T; dispatch sends only 128-multiples)
        (1, 1, 256, 8, 2, 128, 128, 200, torch.bfloat16),
        (1, 100, 256, 8, 2, 256, 256, 17, torch.float32),
    ]
    main_err = 0.0
    for b, t, s, hq, hkv, dk, dv, off, dtype in cases:
        q, k, v = attention_inputs(gen, b, t, s, hq, hkv, dk, dv, dtype)
        scale = dk ** -0.5
        got = fa.flash_attention(q, k, v, off, scale)
        ref = fa.flash_attention_reference(q, k, v, off, scale)
        torch.cuda.synchronize()
        err, worst, rel_l2 = kernel_disagreement(got, ref)
        log(f"[kernels] flash_attention b={b} t={t} s={s} hq={hq} hkv={hkv} dk={dk} "
            f"dv={dv} offset={off} {str(dtype)[6:]}: max_abs_err {err:.3e}, rms(ref) "
            f"{ref.float().pow(2).mean().sqrt().item():.3e}, worst err/limit {worst:.3f} "
            f"(tol 1), relative L2 {rel_l2:.3e} (tol {REL_L2_TOL})")
        if not (worst <= 1 and rel_l2 <= REL_L2_TOL):
            raise AssertionError(f"flash_attention disagrees with its plain version: "
                                 f"err/limit {worst}, relative L2 {rel_l2}")
        if (t, s, hq, hkv, dk) == (CHUNK, MAX_SEQ, 32, 8, 128):
            main_err = max(main_err, err)
    return main_err


def phase_timing(seed: int) -> dict:
    """Kernel, plain and SDPA times at the main path's shapes. Returns the
    kernel record: per-launch means over the main path's chunk offsets."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for off in (0, 256, 512, 3840):
        q, k, v = attention_inputs(gen, 1, CHUNK, MAX_SEQ, 32, 8, 128, 128, torch.bfloat16)
        scale = 128 ** -0.5
        kern = time_ms(lambda: fa.flash_attention(q, k, v, off, scale))
        plain = time_ms(lambda: fa.flash_attention_reference(q, k, v, off, scale))
        lib_fn = sdpa_call(q, k, v, off, scale)
        lib = time_ms(lib_fn)
        err = (fa.flash_attention(q, k, v, off, scale).float() - lib_fn().float()).abs().max().item()
        bms, ops_ms, bytes_ms = bound_ms(q, k, v, off)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        flops, nbytes = attention_work(q, k, v, off)
        rows.append(dict(offset=off, ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bms,
                         ops_ms=ops_ms, bytes_ms=bytes_ms))
        log(f"[timing] flash_attention T={CHUNK} S={MAX_SEQ} Hq=32 Hkv=8 D=128 bf16 "
            f"offset={off}: kernel {kern:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"kernel vs sdpa max_abs_err {err:.3e}")
    return rows


class ByteTokenizer:
    """Token id == one UTF-8 byte; ids >= 256 decode to nothing. No EOS, so
    every request runs to its max_tokens and the counts are exact."""

    eos_token_id = None

    def decode(self, ids):
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def encode(self, text):
        return list(text.encode("utf-8"))


def post(port, path, body, stream=False):
    """One request; returns (status, parsed body or SSE events, seconds to
    the response headers, seconds to the end)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    t_head = time.perf_counter() - t0
    data = resp.read()
    t_end = time.perf_counter() - t0
    conn.close()
    if not stream:
        return resp.status, json.loads(data), t_head, t_end
    events = []
    for block in data.decode().split("\n\n"):
        block = block.strip()
        if block.startswith("data: "):
            payload = block[6:]
            events.append(payload if payload == "[DONE]" else json.loads(payload))
    return resp.status, events, t_head, t_end


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def stream_text(events, chat):
    key = "delta" if chat else None
    out = []
    for e in events:
        if isinstance(e, dict):
            c = e["choices"][0]
            out.append(c[key].get("content", "") if chat else c.get("text", ""))
    return "".join(out)


def phase_main_path(seed: int) -> tuple[int, dict]:
    """The port's server over Llama-3.1-8B at full width. Returns the flash
    launches of the counted run and the measured request numbers."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, convert_chat, make_server

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, cfg = build_model(LLAMA_31_8B, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main] Llama-3.1-8B full width, {cfg.num_hidden_layers} layers, {n_params / 1e9:.3f} B "
        f"bf16 parameters drawn on the card in {time.perf_counter() - t0:.1f}s")
    tok = ByteTokenizer()
    gen = Generator(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK)
    server = make_server(ModelProvider(gen, tok, model_name="llama-3.1-8b"), "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    words = ("pipeline stages pass activations over rings while the cache grows; "
             "every chunk of the prompt runs through the flash kernel. ")
    long_prompt = (words * 8)[:600]
    mid_prompt = (words * 4)[:300]
    messages = [{"role": "user", "content": "Name three colours of the sea at dawn."}]
    chat_len = len(tok.encode(convert_chat(messages)))
    force_a = {"65": 100.0}  # byte 'A': makes streamed token counts exact
    chunks = lambda n: -(-n // CHUNK)  # noqa: E731
    stats = {}
    try:
        # warm-up outside the counted run: cuBLAS handles, the kernel library
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"warm-up request failed: {status}")
        fa.flash_attention.launches = 0
        expected_chunks = 0

        status, body, _, t_end = post(port, "/v1/completions", {
            "prompt": long_prompt, "max_tokens": 32, "logprobs": 5})
        check(status == 200, f"completion: status {status}: {body}")
        usage, choice = body["usage"], body["choices"][0]
        check(usage["prompt_tokens"] == 600 and usage["completion_tokens"] == 32,
              f"completion token counts {usage}")
        lp = choice["logprobs"]
        check(len(lp["token_logprobs"]) == 32 and all(len(t) == 5 for t in lp["top_logprobs"]),
              "completion logprobs shape")
        check(all(math.isfinite(x) and x <= 0 for x in lp["token_logprobs"]),
              "completion logprobs not finite and <= 0")
        check(choice["finish_reason"] == "length", "completion finish_reason")
        expected_chunks += chunks(600)
        log(f"[main] /v1/completions 600-token prompt, 32 tokens, logprobs: 200 in {t_end:.3f}s")

        status, events, t_head, t_end = post(port, "/v1/chat/completions", {
            "messages": messages, "max_tokens": 24, "stream": True, "logit_bias": force_a},
            stream=True)
        check(status == 200 and events[-1] == "[DONE]", f"chat stream: status {status}")
        check(events[0]["choices"][0]["delta"].get("role") == "assistant", "chat role chunk")
        check(stream_text(events, chat=True) == "A" * 24, "chat stream text")
        check(events[-2]["choices"][0]["finish_reason"] == "length", "chat finish_reason")
        expected_chunks += chunks(chat_len)
        log(f"[main] /v1/chat/completions stream, {chat_len}-token prompt, 24 tokens: 200, "
            f"{len(events)} events in {t_end:.3f}s")

        sampled = []
        for _ in range(2):
            status, body, _, t_end = post(port, "/v1/completions", {
                "prompt": mid_prompt, "max_tokens": 24, "temperature": 0.8, "top_p": 0.9,
                "seed": 1234})
            check(status == 200 and body["usage"]["completion_tokens"] == 24,
                  f"sampled completion: {status} {body.get('usage')}")
            sampled.append(body["choices"][0]["text"])
            expected_chunks += chunks(300)
        check(sampled[0] == sampled[1], "seeded sampled completions differ")
        log(f"[main] /v1/completions seeded sample (T=0.8, top_p=0.9) twice: 200, equal texts")

        status, events, t_head, t_end = post(port, "/v1/completions", {
            "prompt": long_prompt, "max_tokens": 64, "stream": True, "logit_bias": force_a},
            stream=True)
        check(status == 200 and stream_text(events, chat=False) == "A" * 64,
              f"streamed completion: status {status}")
        expected_chunks += chunks(600)
        stats = {"ttft_s": t_head, "prefill_tok_s": 600 / t_head,
                 "decode_tok_s": 63 / (t_end - t_head)}
        log(f"[main] /v1/completions stream, 600-token prompt, 64 tokens: TTFT {t_head * 1e3:.1f} ms, "
            f"prefill {stats['prefill_tok_s']:.1f} tok/s, decode {stats['decode_tok_s']:.2f} tok/s "
            f"(host clock at the client, one request)")
        launches = fa.flash_attention.launches
        expected = cfg.num_hidden_layers * expected_chunks
        log(f"[main] flash_attention launches {launches}, expected {cfg.num_hidden_layers} "
            f"layers x {expected_chunks} chunks = {expected}")
        check(launches == expected, "flash launch count disagrees with the chunk count")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # the kernel path against the plain attention path of the same model:
    # a 192-token chunk is not a multiple of 128, so it takes the plain path
    prompt = np.asarray([tok.encode(long_prompt)], np.int64)
    out = {}
    for chunk_len in (CHUNK, 192):
        g = Generator(model, max_seq=MAX_SEQ, prefill_chunk=chunk_len)
        out[chunk_len], _ = g.run_prefill(prompt, model.make_cache(1, g.max_seq))
    kern, plain = out[CHUNK].float(), out[192].float()
    check(kern.shape == (1, cfg.vocab_size) and bool(torch.isfinite(kern).all()),
          "prefill logits not finite or of the wrong shape")
    rel = ((kern - plain).norm() / plain.norm()).item()
    same_top = bool((kern.argmax(-1) == plain.argmax(-1)).all())
    log(f"[main] last-position logits, kernel path vs plain path over 32 layers: relative L2 "
        f"error {rel:.3e} (tol {LOGITS_RTOL}), same argmax {same_top}")
    check(rel <= LOGITS_RTOL, "kernel path disagrees with the plain path")
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main] torch.cuda.max_memory_allocated {stats['max_memory_allocated_gb']:.2f} GB")
    return launches, stats


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    max_err = phase_kernels(args.seed)
    rows = phase_timing(args.seed)
    launches, _ = phase_main_path(args.seed)

    # the kernel record: per-launch means over the main path's chunk offsets
    main_rows = [r for r in rows if r["offset"] in MAIN_PATH_OFFSETS]
    mean = lambda key: sum(r[key] for r in main_rows) / len(main_rows)  # noqa: E731
    ops_ms = sum(r["ops_ms"] for r in main_rows)
    bytes_ms = sum(r["bytes_ms"] for r in main_rows)
    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "mlx_sharding_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mlx_sharding_tpu/ops/flash_attention.py:127",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": mean("library_ms"),
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
