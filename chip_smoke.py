"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed as it runs; any failure exits non-zero without the
final line:

1. device: the card's name and power limit (nvidia-smi);
2. kernels: build every kernel library of the main path from ``csrc/`` with
   nvcc (one nvcc per source, started together), print the ``-Xptxas -v``
   lines and the flash variants' registers, shared bytes and resident
   blocks per SM, and hold each kernel against its plain PyTorch version on
   the card at the main path's shapes (and a few more): flash attention
   (bf16 GQA groups 1-16, head dims 64-256, ragged T, offset 3840 with the
   walk as planned, in chunks of 512 keys and whole; f32), the two
   packed-weight kernels at the five Llama-3.1-8B projection shapes (the
   GEMV at M = 1 and 8, the matmul at M = 88 and 256), bit for bit on
   integer-valued operands and within limits on random bf16, at 2, 4 and 8
   bits, group sizes 32-128 and ragged M, OUT and IN, both walks over IN
   planned, whole and forced into splits (two runs bit-identical), and the
   ragged paged decode at the 8B shapes over uneven lengths, bf16 and int8
   pools, and odd pages, groups (3, 7 and 24 among them), Dk != Dv and
   dtypes, each with the walk planned, in blocks of 64 positions and whole;
   then two runs bit-identical, one row merging 22 partials, and one call
   captured in a CUDA graph holding one kernel and no memset;
3. timing: each kernel, its plain version and the one PyTorch library call
   that computes the same function, with CUDA events (and, for the packed
   kernels, ``F.linear`` on the dequantized bf16 weight; for the paged
   decode, SDPA over K/V gathered beforehand, the gather not timed); the
   flash kernel at chunk offsets 0, 256, 512, 1280 and 3840, with the
   achieved TFLOP/s, its share of the bound and the walk split several ways;
   the matmul at M = 88 and 256 with its token tile and split;
   the GEMV's walk over IN split in two against whole at the narrow
   projections of Llama-3.2-1B and Qwen2-1.5B, beside the planner's pick;
   the paged decode at the points of ``PAGED_SWEEP`` (the mix's first
   decode step, 8 x 4096, 32 x 1024, 1 x 4096), planned and whole walks;
4. main path: Llama-3.1-8B at full width (bf16 weights drawn on the card
   from ``--seed``) behind the port's OpenAI server in a thread, with a
   byte-level tokenizer defined here. The Generator captures its CUDA
   graphs first (16 chunk offsets, 4 decode blocks; their seconds and pool
   bytes are printed); five requests (a 600-token completion with
   logprobs, a streamed chat, a seeded top-p sample twice, a streamed
   600-token completion for TTFT and decode tok/s) then run as replays:
   flash launches checked against 32 x the prompt chunks, replays against
   the requests' chunks and decode blocks, no capture and no eager forward;
   the kernel path checked against the plain attention path of the same
   model, and the median of five device-synchronised
   ``Generator.run_prefill`` calls of the 600-token prompt after a warm-up;
   the dense T=1 attention's device time over the whole capacity (what the
   captured step runs) against the prefix alone, outputs within the bf16
   limits. Then where the time goes, eager against graph, in the order eager,
   graph, graph, eager in this process: the prefill median, a greedy
   64-token stream's decode tok/s, and for one decode step and one
   256-token prefill chunk the host ms, wall ms, device ms (torch.profiler)
   and busy share, and the kernels by device time; the streams and a
   seeded top-p sample token-identical both ways;
5. main path, 4-bit (``--keep-quantized``): the same weights packed on the
   card in MLX's layout (group 64, 4 bits, fp16 scales and biases), fused,
   its graphs captured, served by the same server for two 600-token
   requests, every kernel's launches (replays included) checked against
   what the requests imply, replays against their chunks and blocks, the
   last position's logits checked against a dense model holding the
   dequantized weights, the packed prefill's median, and where the time
   goes, as in phase 4.
6. continuous batching (run between 4 and 5, on phase 4's dense model):
   ``--concurrent 8 --paged-pool 16`` with 256-token pages and async ticks,
   once with a bf16 pool (reserve admission) and once with an int8 pool
   (overcommit admission, each request of the mix asked for 256 more
   tokens so that the pool preempts), its prefill graphs (one per chunk
   offset) and decode graphs captured first. A seeded top-p request alone,
   then nine requests (the seeded twin sent first, so that it is the
   oldest) through the port's server: statuses, token counts, the twins'
   token ids, a request that waited for pages, at least one preemption in
   the overcommit run, the launches of both attention kernels against the
   batcher's own count of steps and chunks, its replays against its blocks
   and chunks with no capture and no eager forward, and its ticks (harvest
   wait and host ms per tick, preemptions, the async reason); then six
   requests served on this thread four ways: graphs and eager steps, async
   and sync ticks token-identical; overcommit against reserve
   token-identical for every request not preempted, and for a preempted
   one up to its preemption (the tokens that still agree after its resume
   are printed); then, at the engine level, every slot's logits at its
   first decode step against the single-stream model's.

``--kernels-only`` stops after phase 2 (a short first check of a new
kernel) and prints no result line.

The last three lines are the kernel JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import http.client
import json
import math
import os
import statistics
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
# the flash kernel's timing: those, the last chunk of phase 6's 1,500-token
# prompt and the last chunk of the cache
FLASH_TIMING_OFFSETS = MAIN_PATH_OFFSETS + (1280, 3840)
# keys per block the timing also runs at each offset (0: the whole walk)
FLASH_SPLIT_SWEEP = (0, 512, 1024, 2048)
# (Dk, Dv) of the bf16 flash variants whose registers and occupancy are printed
FLASH_DIMS = ((128, 128), (64, 64), (192, 128), (256, 256))
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
# the last position's logits; the same limit holds the packed model against
# a dense model of its dequantized weights
LOGITS_RTOL = 5e-2
# MLX 4-bit layout of the published mlx-community Llama-3.1-8B-Instruct-4bit
GROUP_SIZE = 64
BITS = 4
# the projections of one Llama-3.1-8B layer as the packed path runs them
# (QKV and gate+up fused), and the LM head: (name, OUT, IN)
QUANT_SHAPES = (
    ("qkv_proj", 6144, 4096),
    ("o_proj", 4096, 4096),
    ("gate_up_proj", 28672, 4096),
    ("down_proj", 4096, 14336),
    ("lm_head", 128256, 4096),
)
LAYER_SHAPES = 4  # the first four run once per layer, the head once per step
PREFILL_M = CHUNK
# the last chunk of the main path's 600-token prompt
TAIL_M = 600 - 2 * CHUNK
# continuous batching (phase 6): slots, page size, and a pool small enough
# that the nine requests below (25 pages in all) cannot all hold pages at once
SLOTS = 8
PAGE = 256
POOL_PAGES = 16
# (prompt tokens, max_tokens); the last is the seeded top-p twin of a request
# sent alone before the mix, the others are forced to one byte
BATCH_MIX = ((40, 64), (200, 48), (255, 32), (256, 32), (257, 96), (600, 64), (900, 96),
             (1500, 64), (600, 64))
# the overcommit run (int8 pool) asks each request of the mix for this many
# more tokens: every one then decodes past the pages it was admitted with,
# so growth outruns the pool and preempts (the mix's own 32-96 tokens rarely
# cross a 256-token page, and an overcommit pool only preempts as it grows)
OVERCOMMIT_EXTRA_TOKENS = 256
# the parity runs (graphs / eager, sync / async, overcommit / reserve) over
# the same pool: five greedy prompts and a seeded top-p one, 128 tokens
# each; prompts close under a page edge grow while the pool is full, so the
# overcommit run preempts (the seeded request, after 57 tokens). Their
# engines stop at 1280 positions: 5 prefill graphs each, not 16
PARITY_PROMPTS = (200, 230, 480, 700, 1000, 450)
PARITY_TOKENS = 128
PARITY_MAX_SEQ = 1280
# the paged kernel's check at the 8B shapes: lengths at and around page
# edges, an empty slot and a full 4096-position slot
PAGED_LENGTHS = (0, 1, 255, 256, 257, 600, 1000, 4096)
# its timing: the first decode step of the mix's first eight requests
PAGED_TIMING_LENGTHS = tuple(n + 1 for n, _ in BATCH_MIX[:SLOTS])
# the timing sweep, each point with a bf16 and an int8 pool: the mix above;
# every slot at max_seq; the same bytes over 32 slots of 1024; one long
# stream (8 (slot, KV head) rows for the whole card)
PAGED_SWEEP = (
    ("mix", PAGED_TIMING_LENGTHS),
    ("long", (MAX_SEQ,) * SLOTS),
    ("wide", (1024,) * 32),
    ("one", (MAX_SEQ,)),
)


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


def quant_operands(gen, m, out_dim, in_dim, *, integer, x_dtype=torch.bfloat16,
                   param_dtype=torch.float16, group_size=GROUP_SIZE, bits=BITS):
    """x (M, IN) and a packed (q, scales, biases) on the card. ``integer``:
    random codes, scale 1, bias -2^(bits-1) and integer x in [-4, 4), so
    every product and partial sum is exact in fp32 and the kernel must equal
    the plain version bit for bit. Else: a random N(0, 1/IN) weight packed
    by ``quantize_torch`` and random x."""
    from mlx_sharding_tpu_torch.ops.quant import quantize_torch

    dev = "cuda"
    groups = in_dim // group_size
    if integer:
        q = torch.randint(-2**31, 2**31, (out_dim, in_dim * bits // 32), generator=gen,
                          device=dev, dtype=torch.int32)
        s = torch.ones((out_dim, groups), dtype=param_dtype, device=dev)
        b = torch.full((out_dim, groups), -float(2 ** (bits - 1)), dtype=param_dtype, device=dev)
        x = torch.randint(-4, 4, (m, in_dim), generator=gen, device=dev).to(x_dtype)
        return x, q, s, b
    w = torch.randn((out_dim, in_dim), generator=gen, device=dev) / math.sqrt(in_dim)
    q, s, b = quantize_torch(w, group_size, bits)
    x = torch.randn((m, in_dim), generator=gen, device=dev).to(x_dtype)
    return x, q, s.to(param_dtype), b.to(param_dtype)


def check_quant(kernel, x, q, s, b, group_size, bits, integer, label) -> float:
    """One kernel call against the plain version; returns max |error|."""
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    got = getattr(qm, kernel)(x, q, s, b, group_size, bits)
    ref = qm.quant_matmul_reference(x, q, s, b, group_size, bits)
    torch.cuda.synchronize()
    if integer:
        err = (got.float() - ref.float()).abs().max().item()
        same = torch.equal(got, ref)
        log(f"[kernels] {kernel} {label} integer-valued: bit-exact {same} (max_abs_err {err:.3e})")
        check(same, f"{kernel} {label} differs from its plain version on exact operands")
        return err
    err, worst, rel_l2 = kernel_disagreement(got, ref)
    log(f"[kernels] {kernel} {label} random: max_abs_err {err:.3e}, rms(ref) "
        f"{ref.float().pow(2).mean().sqrt().item():.3e}, worst err/limit {worst:.3f} (tol 1), "
        f"relative L2 {rel_l2:.3e} (tol {REL_L2_TOL})")
    check(worst <= 1 and rel_l2 <= REL_L2_TOL, f"{kernel} {label} disagrees with its plain version")
    return err


def build_kernels() -> None:
    """Every kernel library of the path, one nvcc per source, all started
    together; prints each build's time and ptxas lines."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    def build(mod):
        t0 = time.perf_counter()
        build_log = mod.build()
        return mod, build_log, time.perf_counter() - t0

    libraries = (fa, qm, pa)
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(build, libraries))
    for mod, build_log, secs in built:
        log(f"[kernels] built {mod.SOURCE.name} in {secs:.1f}s")
        for line in build_log.splitlines():
            if any(k in line for k in ("registers", "smem", "spill", "cached", "Compiling")):
                log(f"[kernels]   ptxas: {line.strip()}")
    for dk, dv in FLASH_DIMS:
        info = fa.kernel_info(dk, dv)
        log(f"[kernels] flash bf16 Dk={dk} Dv={dv}: shared memory per block "
            f"{info['shared_bytes']} bytes, {info['registers']} registers, "
            f"{info['blocks_per_sm']} resident blocks per SM, {info['local_bytes']} local (spill) "
            f"bytes per thread")
    for bits in qm.BITS:
        for m in (1, 8):
            info = qm.gemv_info(bits, m, GROUP_SIZE, torch.float16)
            log(f"[kernels] quant_gemv bf16 x, {bits} bits, M={m}, group {GROUP_SIZE}, fp16 "
                f"scales: shared memory per block {info['shared_bytes']} bytes, "
                f"{info['registers']} registers, {info['blocks_per_sm']} resident blocks per SM, "
                f"{info['local_bytes']} local (spill) bytes per thread")
        for m in (TAIL_M, PREFILL_M):
            tile, _ = qm.plan_matmul(m, 4096, 4096, torch.cuda.get_device_properties(0)
                                     .multi_processor_count)
            info = qm.matmul_info(bits, tile)
            log(f"[kernels] quant_matmul bf16 x, {bits} bits, M={m} (token tile {tile}): shared "
                f"memory per block {info['shared_bytes']} bytes, {info['registers']} registers, "
                f"{info['blocks_per_sm']} resident blocks per SM, {info['local_bytes']} local "
                f"(spill) bytes per thread")
    for pool_dtype in (torch.bfloat16, torch.int8):
        info = pa.kernel_info(pool_dtype, 128, 128)
        log(f"[kernels] paged_attention bf16 q, {str(pool_dtype)[6:]} pool, D=128: shared memory "
            f"per block {info['shared_bytes']} bytes, {info['registers']} registers, "
            f"{info['blocks_per_sm']} resident blocks per SM, {info['local_bytes']} local (spill) "
            f"bytes per thread")


def phase_quant_kernels(seed: int) -> dict:
    """Both packed-weight kernels against the plain version: at the five
    Llama-3.1-8B shapes (the GEMV at M = 1 and 8, the matmul at M = 88 and
    256), bit for bit on integer-valued operands and within limits on random
    bf16 with fp16 scales; the matmul at the four layer shapes again with
    its walk over IN whole and in splits of 512; then small cases for the
    other bits, group sizes, dtypes and ragged edges. Returns the largest
    random-bf16 error at the main path's shapes, per kernel."""
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    main_err = {"quant_gemv": 0.0, "quant_matmul": 0.0}
    for name, out_dim, in_dim in QUANT_SHAPES:
        for integer in (True, False):
            for kernel, m in (("quant_gemv", 1), ("quant_gemv", 8), ("quant_matmul", TAIL_M),
                              ("quant_matmul", PREFILL_M)):
                x, q, s, b = quant_operands(gen, m, out_dim, in_dim, integer=integer)
                err = check_quant(kernel, x, q, s, b, GROUP_SIZE, BITS, integer,
                                  f"{name} M={m} OUT={out_dim} IN={in_dim} bf16")
                if not integer:
                    main_err[kernel] = max(main_err[kernel], err)
            del x, q, s, b
    # the matmul's walk over IN forced whole and into splits of 512 at the
    # layer shapes; two runs of the planned and the forced walks must give
    # the same bits
    default_split = qm.SPLIT_K
    for name, out_dim, in_dim in QUANT_SHAPES[:LAYER_SHAPES]:
        for m in (TAIL_M, PREFILL_M):
            for split in (0, 512):
                qm.SPLIT_K = split
                try:
                    for integer in (True, False):
                        x, q, s, b = quant_operands(gen, m, out_dim, in_dim, integer=integer)
                        check_quant("quant_matmul", x, q, s, b, GROUP_SIZE, BITS, integer,
                                    f"{name} M={m} OUT={out_dim} IN={in_dim} bf16, split {split}")
                finally:
                    qm.SPLIT_K = default_split
            for split in (None, 512):
                qm.SPLIT_K = split
                try:
                    again = [qm.quant_matmul(x, q, s, b, GROUP_SIZE, BITS) for _ in range(2)]
                    check(torch.equal(*again), f"quant_matmul {name} M={m} split {split}: two "
                          "runs differ")
                finally:
                    qm.SPLIT_K = default_split
            del x, q, s, b
    small = [
        # kernel, M, OUT, IN, group size, bits, x dtype, scale/bias dtype
        ("quant_gemv", 3, 200, 512, 32, 8, torch.bfloat16, torch.bfloat16),
        ("quant_gemv", 8, 77, 96, 32, 4, torch.float32, torch.float32),
        ("quant_gemv", 5, 130, 8320, 128, 4, torch.bfloat16, torch.float16),
        ("quant_matmul", 100, 200, 96, 32, 4, torch.bfloat16, torch.float16),
        ("quant_matmul", 70, 130, 512, 128, 8, torch.float32, torch.float32),
        ("quant_matmul", 9, 256, 256, 64, 8, torch.bfloat16, torch.bfloat16),
        # 2-bit weights: a 16-byte load of words spans two groups of 32
        ("quant_gemv", 1, 256, 512, 32, 2, torch.bfloat16, torch.float16),
        ("quant_gemv", 7, 130, 8320, 64, 2, torch.bfloat16, torch.bfloat16),
        ("quant_gemv", 4, 77, 96, 32, 2, torch.float32, torch.float32),
        ("quant_matmul", 100, 200, 512, 32, 2, torch.bfloat16, torch.float16),
        ("quant_matmul", 16, 96, 96, 32, 2, torch.float32, torch.float32),
        # the bf16 matmul at every bits and group size, ragged M, OUT and IN:
        # 2-bit rows of IN 160 are 40 bytes, so their words come by cp.async;
        # M = 300 takes two token tiles
        ("quant_matmul", 37, 77, 160, 32, 2, torch.bfloat16, torch.bfloat16),
        ("quant_matmul", 300, 130, 1088, 64, 2, torch.bfloat16, torch.float16),
        ("quant_matmul", 129, 260, 1152, 128, 2, torch.bfloat16, torch.float32),
        ("quant_matmul", 65, 200, 1184, 32, 4, torch.bfloat16, torch.float32),
        ("quant_matmul", 250, 386, 2176, 128, 4, torch.bfloat16, torch.bfloat16),
        ("quant_matmul", 33, 130, 224, 32, 8, torch.bfloat16, torch.float16),
        ("quant_matmul", 200, 77, 1152, 64, 8, torch.bfloat16, torch.float32),
    ]
    for kernel, m, out_dim, in_dim, gs, bits, xd, pd in small:
        for integer in (True, False):
            x, q, s, b = quant_operands(gen, m, out_dim, in_dim, integer=integer, x_dtype=xd,
                                        param_dtype=pd, group_size=gs, bits=bits)
            check_quant(kernel, x, q, s, b, gs, bits, integer,
                        f"M={m} OUT={out_dim} IN={in_dim} gs={gs} bits={bits} "
                        f"{str(xd)[6:]} x, {str(pd)[6:]} scales")
    # the bf16 GEMV's and matmul's walks over IN forced whole and into
    # splits, at every bits and group size (the matmul's split of 96 ends
    # inside a stage), and the GEMV at the 8B o_proj and down_proj shapes;
    # two runs of a split walk must give the same bits
    default_split, default_k = qm.SPLIT_IN, qm.SPLIT_K
    forced = [("quant_gemv", 3, 130, 1152, gs, bits, split) for bits in qm.BITS
              for gs in qm.GROUP_SIZES for split in (0, 384)]
    forced += [("quant_matmul", 70, 130, 1152, gs, bits, split) for bits in qm.BITS
               for gs in qm.GROUP_SIZES for split in (0, 384, 96 if gs == 32 else 128)]
    forced += [("quant_gemv", m, 4096, in_dim, GROUP_SIZE, BITS, split) for m in (1, 8)
               for in_dim in (4096, 14336) for split in (0, 1024, 512)]
    for kernel, m, out_dim, in_dim, gs, bits, split in forced:
        if kernel == "quant_gemv":
            qm.SPLIT_IN = split
        else:
            qm.SPLIT_K = split
        try:
            for integer in (True, False):
                x, q, s, b = quant_operands(gen, m, out_dim, in_dim, integer=integer,
                                            group_size=gs, bits=bits)
                check_quant(kernel, x, q, s, b, gs, bits, integer,
                            f"M={m} OUT={out_dim} IN={in_dim} gs={gs} bits={bits} bf16 x, "
                            f"split {split}")
            again = [getattr(qm, kernel)(x, q, s, b, gs, bits) for _ in range(2)]
            check(torch.equal(*again), f"{kernel} split {split}: two runs differ")
        finally:
            qm.SPLIT_IN, qm.SPLIT_K = default_split, default_k
    return main_err


def paged_case(gen, lengths, hq, hkv, d, page, spg, pool_dtype, q_dtype, dv=None):
    """One layer's page pool on the card, as the engine lays it out: each
    slot's live pages are distinct pool pages in shuffled order, every table
    entry past them names the scratch page (the last), and the scratch page
    holds large values, so that reading it as a live row shows. An int8 pool
    is quantized with the port's ``quantize_kv_rows``. V's head dim is ``dv``
    (``d`` if None). Returns (q, k pool, v pool, k scales, v scales, tables,
    lengths); scales are None unless int8."""
    from mlx_sharding_tpu_torch.cache import quantize_kv_rows

    dev = "cuda"
    m = len(lengths)
    need = [-(-n // page) for n in lengths]
    pages = sum(need) + 3
    order = torch.randperm(pages, generator=torch.Generator().manual_seed(len(lengths) + page))
    tables = torch.full((m, spg), pages, dtype=torch.int32)
    start = 0
    for i, n in enumerate(need):
        tables[i, :n] = order[start : start + n]
        start += n
    k = torch.randn((pages + 1, page, hkv, d), generator=gen, device=dev)
    v = torch.randn((pages + 1, page, hkv, dv or d), generator=gen, device=dev)
    k[pages] = 30.0
    v[pages] = 30.0
    q = torch.randn((m, hq, d), generator=gen, device=dev).to(q_dtype)
    ks = vs = None
    if pool_dtype == torch.int8:
        kq, vq = quantize_kv_rows(k), quantize_kv_rows(v)
        k, ks, v, vs = kq["d"], kq["s"], vq["d"], vq["s"]
    else:
        k, v = k.to(pool_dtype), v.to(pool_dtype)
    return (q, k, v, ks, vs, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def graph_nodes(fn) -> dict:
    """The CUDA work one call of ``fn`` enqueues, by node type: ``fn`` is
    run once on a side stream (so that per-stream buffers exist), then
    captured into a CUDA graph whose nodes are counted through the CUDA
    runtime. Returns {"kernel": n, "memset": n, "memcpy": n, "other": n}."""
    import ctypes

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    rt = ctypes.CDLL("libcudart.so." + torch.version.cuda.split(".")[0])
    count = ctypes.c_size_t(0)
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    assert rt.cudaGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert rt.cudaGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kinds = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    names = {0: "kernel", 1: "memcpy", 2: "memset"}  # cudaGraphNodeType
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds[names.get(kind.value, "other")] += 1
    del graph
    return kinds


def phase_paged_kernels(seed: int) -> float:
    """The ragged paged decode against its plain version: at the 8B shapes
    (M 8, Hq 32, Hkv 8, D 128, page 256, 16 pages a slot) with bf16 and int8
    pools, then at odd pages, groups, head dims and dtypes, each with the
    walk as planned, in blocks of 64 positions and whole. An empty slot must
    give zeros. Then, at the 8B shapes: two runs give the same bits, one
    long slot merges 64 partials, and one call is one kernel launch (no
    merge kernel, no memset). Returns the largest error at the 8B shapes."""
    from mlx_sharding_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (lengths, hq, hkv, d, page, pages per slot, pool dtype, q dtype[, dv])
        (PAGED_LENGTHS, 32, 8, 128, PAGE, MAX_SEQ // PAGE, bf16, bf16),
        (PAGED_LENGTHS, 32, 8, 128, PAGE, MAX_SEQ // PAGE, torch.int8, bf16),
        ((5, 8, 16, 0, 27, 32), 4, 4, 64, 8, 4, f32, f32),
        ((1, 15, 16, 17, 100, 0), 8, 2, 128, 16, 8, bf16, bf16),
        ((127, 128, 129, 500, 0, 3), 8, 1, 64, 128, 4, torch.int8, f32),
        ((64, 65, 300, 0), 4, 2, 256, 64, 5, bf16, bf16),
        ((33, 200, 1), 16, 1, 128, 32, 8, torch.int8, bf16),
        ((9, 24, 0, 40), 16, 2, 64, 8, 6, f32, f32),
        # groups padded in the mma's 16 rows: G = 7 (Qwen2-7B's 28 / 4
        # heads) and G = 3, and G = 24 in chunks of 16 heads
        ((1, 255, 256, 700, 0, 1500), 28, 4, 128, PAGE, 8, bf16, bf16),
        ((1, 255, 256, 700, 0, 1500), 28, 4, 128, PAGE, 8, torch.int8, bf16),
        ((3, 64, 65, 0), 6, 2, 128, 16, 6, bf16, bf16),
        ((1, 100, 257, 0), 24, 1, 128, 64, 6, bf16, bf16),
        ((1, 100, 257, 0), 24, 1, 128, 64, 6, torch.int8, bf16),
        # Dk != Dv (DeepSeek MLA's full mode, 192 / 128)
        ((1, 77, 300, 0, 513), 16, 16, 192, 64, 12, bf16, bf16, 128),
        ((1, 77, 300, 0, 513), 16, 16, 192, 64, 12, torch.int8, bf16, 128),
        # pages that are not a multiple of 8 (the FMA kernel's)
        ((5, 12, 0, 30), 8, 2, 64, 12, 3, bf16, bf16),
    ]
    main_err = 0.0
    for lengths, hq, hkv, d, page, spg, pool_dtype, q_dtype, *dv in cases:
        dv = dv[0] if dv else d
        q, k, v, ks, vs, tables, lens = paged_case(gen, lengths, hq, hkv, d, page, spg,
                                                    pool_dtype, q_dtype, dv)
        scale = d ** -0.5
        ref = pa.paged_attention_reference(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)
        live = lens > 0
        # the walk as planned, in many short splits, and whole
        for split in (None, 64, 0):
            got = paged_call(pa, q, k, v, ks, vs, tables, lens, scale, split)
            empty_zero = bool((got[~live] == 0).all())
            err, worst, rel_l2 = kernel_disagreement(got[live], ref[live])
            walk = "planned split" if split is None else f"split {split}"
            label = (f"M={len(lengths)} Hq={hq} Hkv={hkv} Dk={d} Dv={dv} page={page} spg={spg} "
                     f"{str(pool_dtype)[6:]} pool, {str(q_dtype)[6:]} q, {walk}, "
                     f"lengths {list(lengths)}")
            log(f"[kernels] paged_attention {label}: max_abs_err {err:.3e}, rms(ref) "
                f"{ref[live].float().pow(2).mean().sqrt().item():.3e}, worst err/limit "
                f"{worst:.3f} (tol 1), relative L2 {rel_l2:.3e} (tol {REL_L2_TOL}), empty slots "
                f"zero {empty_zero}")
            check(worst <= 1 and rel_l2 <= REL_L2_TOL and empty_zero,
                  f"paged_attention {label} disagrees with its plain version")
            if (hq, hkv, d, page) == (32, 8, 128, PAGE) and split is None:
                main_err = max(main_err, err)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for pool_dtype in (bf16, torch.int8):
        name = str(pool_dtype)[6:]
        q, k, v, ks, vs, tables, lens = paged_case(gen, PAGED_LENGTHS, 32, 8, 128, PAGE,
                                                    MAX_SEQ // PAGE, pool_dtype, bf16)
        scale = 128 ** -0.5
        for split in (None, 64):
            runs = [paged_call(pa, q, k, v, ks, vs, tables, lens, scale, split) for _ in range(2)]
            same = torch.equal(*runs)
            log(f"[kernels] paged_attention 8B shapes, {name} pool, "
                f"{'planned split' if split is None else f'split {split}'}: two runs "
                f"bit-identical {same}")
            check(same, f"paged_attention {name} pool: two runs differ")
        # one long slot alone: the planner's walk gives each row many splits
        q1, k1, v1, ks1, vs1, t1, l1 = paged_case(gen, (MAX_SEQ,), 32, 8, 128, PAGE,
                                                  MAX_SEQ // PAGE, pool_dtype, bf16)
        planned = pa.plan_paged_split(1, 8, PAGE, MAX_SEQ // PAGE, sms)
        partials = pa.num_splits(PAGE, MAX_SEQ // PAGE, planned)
        got = paged_call(pa, q1, k1, v1, ks1, vs1, t1, l1, scale, None)
        ref = pa.paged_attention_reference(q1, k1, v1, t1, l1, scale, k_scale=ks1, v_scale=vs1)
        err, worst, rel_l2 = kernel_disagreement(got, ref)
        log(f"[kernels] paged_attention one slot of {MAX_SEQ}, {name} pool: {planned} positions "
            f"a split, one row merges {partials} partials: max_abs_err {err:.3e}, worst "
            f"err/limit {worst:.3f}, relative L2 {rel_l2:.3e}")
        check(partials >= 16 and worst <= 1 and rel_l2 <= REL_L2_TOL,
              f"paged_attention {name} pool: the many-split merge disagrees")
        nodes = graph_nodes(lambda: pa.paged_attention(q, k, v, tables, lens, scale,
                                                       k_scale=ks, v_scale=vs))
        log(f"[kernels] paged_attention 8B shapes, {name} pool: one call enqueues {nodes}")
        check(nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0},
              f"paged_attention {name} pool: one call is not one kernel launch")
    return main_err


def paged_call(pa, q, k, v, ks, vs, tables, lens, scale, split):
    """One synchronised call with ``SPLIT_POSITIONS`` set to ``split``."""
    default = pa.SPLIT_POSITIONS
    pa.SPLIT_POSITIONS = split
    try:
        out = pa.paged_attention(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
    finally:
        pa.SPLIT_POSITIONS = default
    return out


# ---------------------------------------------------------------- phases
def phase_kernels(seed: int) -> float:
    """Returns the largest error at the main path's shapes."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

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
        # bf16 GQA packing: groups 1, 2, 8 and 16 at D = 128
        (1, 256, 1024, 8, 8, 128, 128, 300, torch.bfloat16),
        (1, 256, 2048, 16, 8, 128, 128, 1000, torch.bfloat16),
        (1, 256, 4096, 64, 8, 128, 128, 2000, torch.bfloat16),
        (1, 128, 512, 16, 1, 128, 128, 100, torch.bfloat16),
        # groups 6 (Qwen2-1.5B, 12 / 2 heads) and 7 (Qwen2-7B, 28 / 4 heads)
        (1, 256, 1024, 12, 2, 128, 128, 300, torch.bfloat16),
        (1, 256, 1024, 28, 4, 128, 128, 500, torch.bfloat16),
        # bf16 head dims (64, 64) and (256, 256)
        (2, 256, 512, 8, 2, 64, 64, 100, torch.bfloat16),
        (1, 256, 1024, 8, 2, 256, 256, 500, torch.bfloat16),
        # bf16 ragged T against the packed rows: T = 1, and T = 100 (400
        # rows: the last row tile is partial)
        (1, 1, MAX_SEQ, 32, 8, 128, 128, 3000, torch.bfloat16),
        (1, 100, 512, 32, 8, 128, 128, 37, torch.bfloat16),
    ]
    # the main path's deepest chunk with the walk forced into chunks of 512
    # keys and into one block per row tile (the planner's choice is above)
    cases += [(1, CHUNK, MAX_SEQ, 32, 8, 128, 128, 3840, torch.bfloat16, split)
              for split in (512, 0)]
    main_err = 0.0
    default_split = fa.SPLIT_KEYS
    for b, t, s, hq, hkv, dk, dv, off, dtype, *forced in cases:
        q, k, v = attention_inputs(gen, b, t, s, hq, hkv, dk, dv, dtype)
        scale = dk ** -0.5
        fa.SPLIT_KEYS = forced[0] if forced else default_split
        try:
            got = fa.flash_attention(q, k, v, off, scale)
            torch.cuda.synchronize()
        finally:
            fa.SPLIT_KEYS = default_split
        ref = fa.flash_attention_reference(q, k, v, off, scale)
        err, worst, rel_l2 = kernel_disagreement(got, ref)
        walk = f"split {forced[0]}" if forced else "planned split"
        log(f"[kernels] flash_attention b={b} t={t} s={s} hq={hq} hkv={hkv} dk={dk} "
            f"dv={dv} offset={off} {str(dtype)[6:]} ({walk}): max_abs_err {err:.3e}, rms(ref) "
            f"{ref.float().pow(2).mean().sqrt().item():.3e}, worst err/limit {worst:.3f} "
            f"(tol 1), relative L2 {rel_l2:.3e} (tol {REL_L2_TOL})")
        if not (worst <= 1 and rel_l2 <= REL_L2_TOL):
            raise AssertionError(f"flash_attention disagrees with its plain version: "
                                 f"err/limit {worst}, relative L2 {rel_l2}")
        if (t, s, hq, hkv, dk) == (CHUNK, MAX_SEQ, 32, 8, 128) and not forced:
            main_err = max(main_err, err)
    return main_err


def phase_timing(seed: int) -> list:
    """Kernel, plain and SDPA times at the main path's shapes, at each of
    ``FLASH_TIMING_OFFSETS``, the kernel with the planner's split and at
    each keys-per-block of ``FLASH_SPLIT_SWEEP`` (0: the whole walk). Each
    row prints the achieved TFLOP/s and the share of the bound. Returns
    the rows; the kernel record takes per-launch means over the main
    path's chunk offsets."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    info = fa.kernel_info(128, 128)
    rows = []
    default_split = fa.SPLIT_KEYS
    for off in FLASH_TIMING_OFFSETS:
        q, k, v = attention_inputs(gen, 1, CHUNK, MAX_SEQ, 32, 8, 128, 128, torch.bfloat16)
        scale = 128 ** -0.5
        planned = fa.plan_split(1, CHUNK, MAX_SEQ, 32, 8, off, sms)
        kern = time_ms(lambda: fa.flash_attention(q, k, v, off, scale))
        sweep = {}
        for split in FLASH_SPLIT_SWEEP:
            fa.SPLIT_KEYS = split
            try:
                sweep[split] = time_ms(lambda: fa.flash_attention(q, k, v, off, scale))
            finally:
                fa.SPLIT_KEYS = default_split
        plain = time_ms(lambda: fa.flash_attention_reference(q, k, v, off, scale))
        lib_fn = sdpa_call(q, k, v, off, scale)
        lib = time_ms(lib_fn)
        err = (fa.flash_attention(q, k, v, off, scale).float() - lib_fn().float()).abs().max().item()
        bms, ops_ms, bytes_ms = bound_ms(q, k, v, off)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        flops, nbytes = attention_work(q, k, v, off)
        rows.append(dict(offset=off, ms=kern, whole_ms=sweep[0], plain_ms=plain, library_ms=lib,
                         bound_ms=bms, ops_ms=ops_ms, bytes_ms=bytes_ms, split=planned,
                         tflops=flops / kern / 1e9))
        log(f"[timing] flash_attention T={CHUNK} S={MAX_SEQ} Hq=32 Hkv=8 D=128 bf16 "
            f"offset={off}: kernel {kern:.4f} ms (planned split {planned}: "
            f"{fa.num_splits(CHUNK, MAX_SEQ, off, planned)} blocks along the walk), whole walk "
            f"{sweep[0]:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms (kernel / sdpa "
            f"{kern / lib:.2f}), bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {flops / kern / 1e9:.1f} TFLOP/s, {bms / kern:.1%} of the "
            f"bound; {info['registers']} registers, {info['shared_bytes']} shared bytes, "
            f"{info['blocks_per_sm']} blocks per SM; kernel vs sdpa max_abs_err {err:.3e}")
        log(f"[timing]   keys per block at offset {off}: " + ", ".join(
            f"{split or 'whole'} {ms:.4f} ms" for split, ms in sweep.items()))
    main = [r for r in rows if r["offset"] in MAIN_PATH_OFFSETS]
    kern_mean = sum(r["ms"] for r in main) / len(main)
    lib_mean = sum(r["library_ms"] for r in main) / len(main)
    deep = rows[-1]
    log(f"[timing] flash_attention mean over offsets {'/'.join(map(str, MAIN_PATH_OFFSETS))}: "
        f"kernel {kern_mean:.4f} ms, sdpa {lib_mean:.4f} ms (kernel / sdpa "
        f"{kern_mean / lib_mean:.2f}); offset {deep['offset']}: {deep['ops_ms'] / deep['ms']:.1%} "
        f"of the operations bound, kernel / sdpa {deep['ms'] / deep['library_ms']:.2f}")
    return rows


def paged_work(q, k, v, ks, tables, lens):
    """FLOPs and bytes the ragged decode needs on these inputs: q and the
    output once, each slot's live K/V rows once (with their scales for an
    int8 pool), the table entries of its live pages and the lengths."""
    m, hq, d = q.shape
    page, hkv = k.shape[1], k.shape[2]
    lengths = lens.tolist()
    rows = sum(lengths)
    row_bytes = hkv * 2 * d * k.element_size() + (2 * hkv * 4 if ks is not None else 0)
    live_pages = sum(-(-n // page) for n in lengths)
    nbytes = 2 * m * hq * d * q.element_size() + rows * row_bytes + 4 * (live_pages + m)
    return 2 * hq * 2 * d * rows, nbytes


def sdpa_paged_call(q, k, v, ks, vs, tables, lens, scale):
    """The library yardstick of the paged decode: SDPA over each slot's K/V
    gathered beforehand into a (M, Hkv, S, D) buffer (dequantized for an
    int8 pool) with a length mask. The gather is not timed, so this is not
    the same function: it is what attention costs once the pages are
    contiguous. Timed here only; the port never calls it."""
    from mlx_sharding_tpu_torch.ops.paged_attention import _gathered

    s_max = int(lens.max())
    kg = _gathered(k, ks, tables)[:, :s_max].to(q.dtype).transpose(1, 2).contiguous()
    vg = _gathered(v, vs, tables)[:, :s_max].to(q.dtype).transpose(1, 2).contiguous()
    mask = (torch.arange(s_max, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    qt = q[:, :, None, :]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True)[:, :, 0]

    return call


def phase_paged_timing(seed: int) -> list:
    """Device times of the ragged paged decode at Llama-3.1-8B's attention
    (Hq 32, Hkv 8, D 128, page 256, 16 pages a slot) at each point of
    ``PAGED_SWEEP``, with a bf16 and an int8 pool: the kernel with the
    planner's walk, the same kernel walking each row whole, the plain
    version and the SDPA yardstick, beside the bound, the rate and the share
    of the bound. Returns one row per point and pool; the kernel record
    takes means over the "mix" point's two pools."""
    from mlx_sharding_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scale = 128 ** -0.5
    rows = []
    for point, lengths in PAGED_SWEEP:
        for pool_dtype in (torch.bfloat16, torch.int8):
            name = str(pool_dtype)[6:]
            q, k, v, ks, vs, tables, lens = paged_case(
                gen, lengths, 32, 8, 128, PAGE, MAX_SEQ // PAGE, pool_dtype, torch.bfloat16)

            def call(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, lens=lens):
                return pa.paged_attention(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)

            kern = time_ms(call)
            default, pa.SPLIT_POSITIONS = pa.SPLIT_POSITIONS, 0
            try:
                whole = time_ms(call)
            finally:
                pa.SPLIT_POSITIONS = default
            ref = pa.paged_attention_reference(q, k, v, tables, lens, scale, k_scale=ks,
                                               v_scale=vs)
            plain = time_ms(lambda: pa.paged_attention_reference(
                q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs))
            lib_fn = sdpa_paged_call(q, k, v, ks, vs, tables, lens, scale)
            _, worst, rel_l2 = kernel_disagreement(lib_fn(), ref)
            lib = time_ms(lib_fn) if worst <= 1 and rel_l2 <= REL_L2_TOL else None
            if lib is None:
                log(f"[timing] paged_attention {point}: the SDPA yardstick disagrees with the "
                    f"plain version (err/limit {worst:.3f}, relative L2 {rel_l2:.3e}); "
                    f"library_ms null")
            _, worst, rel_l2 = kernel_disagreement(call(), ref)
            check(worst <= 1 and rel_l2 <= REL_L2_TOL,
                  f"paged_attention {point} {name} pool disagrees with its plain version")
            flops, nbytes = paged_work(q, k, v, ks, tables, lens)
            ops_ms, bytes_ms = flops / PEAK_FLOPS[q.dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
            bound = max(ops_ms, bytes_ms)
            split = pa.plan_paged_split(len(lengths), 8, PAGE, MAX_SEQ // PAGE, sms)
            info = pa.kernel_info(pool_dtype, 128, 128)
            rows.append(dict(point=point, pool=name, ms=kern, whole_ms=whole, plain_ms=plain,
                             library_ms=lib, bound_ms=bound, ops_ms=ops_ms, bytes_ms=bytes_ms,
                             split=split))
            log(f"[timing] paged_attention {point}: M={len(lengths)} Hq=32 Hkv=8 D=128 "
                f"page={PAGE} {name} pool, lengths {list(lengths)[:8]}"
                f"{'...' if len(lengths) > 8 else ''}: kernel {kern:.4f} ms (planned split "
                f"{split}: {pa.num_splits(PAGE, MAX_SEQ // PAGE, split)} items along a full "
                f"walk), whole walk {whole:.4f} ms, plain {plain:.4f} ms, sdpa after a gather "
                f"(gather not timed) {'null' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{bound:.4f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'}; "
                f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB), {nbytes / 1e6 / kern:.0f} GB/s, "
                f"{bound / kern:.1%} of the bound; {info['registers']} registers, "
                f"{info['shared_bytes']} shared bytes, {info['blocks_per_sm']} blocks per SM")
            del q, k, v, ks, vs
    return rows


def int4pack_weight(q, s, b):
    """The same 4-bit codes in the layout of PyTorch's library call
    ``_weight_int4pack_mm``, the yardstick for the packed product (timed
    here only; the port never calls it). It computes (code - 8) * scale +
    zero per group, so zero = bias + 8 * scale; its scales and zeros are
    bf16. Returns (packed words, scales and zeros), or None and the reason
    the call is not available."""
    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, "torch._weight_int4pack_mm is absent"
    shifts = torch.arange(8, device=q.device, dtype=torch.int32) * 4
    codes = ((q[..., None] >> shifts) & 15).reshape(q.shape[0], -1)
    w_u8 = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)  # even index in the high nibble
    del codes
    try:
        packed = torch._convert_weight_to_int4pack(w_u8, 8)
    except RuntimeError as e:
        return None, f"_convert_weight_to_int4pack refused: {str(e).splitlines()[0]}"
    sz = torch.stack([s.float(), b.float() + 8 * s.float()], -1)
    return (packed, sz.to(torch.bfloat16).transpose(0, 1).contiguous()), ""


def quant_work(m, out_dim, in_dim, bits=BITS, group_size=GROUP_SIZE):
    """FLOPs and bytes of one packed product: words, fp16 scales and biases
    and bf16 x read once, the bf16 output written once."""
    groups = in_dim // group_size
    nbytes = out_dim * in_dim * bits // 8 + 2 * 2 * out_dim * groups + 2 * m * in_dim + 2 * m * out_dim
    return 2 * m * in_dim * out_dim, nbytes


def phase_quant_timing(seed: int) -> list:
    """Device times of both packed-weight kernels at the five Llama-3.1-8B
    shapes (the GEMV at M = 1, 2, 4 and 8, the matmul at M = 88 and 256), beside their
    bound, the plain version, F.linear on the dequantized bf16 weight (what
    the dequantize-on-load path spends) and torch._weight_int4pack_mm."""
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm
    from mlx_sharding_tpu_torch.ops.quant import dequantize

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    rows = []
    for name, out_dim, in_dim in QUANT_SHAPES:
        _, q, s, b = quant_operands(gen, 1, out_dim, in_dim, integer=False)
        dense = dequantize(q, s, b, GROUP_SIZE, BITS, torch.bfloat16)
        lib_weight, lib_why = int4pack_weight(q, s, b)
        for m in (1, 2, 4, 8, TAIL_M, PREFILL_M):
            kernel = "quant_gemv" if m <= qm.GEMV_MAX_M else "quant_matmul"
            fn = getattr(qm, kernel)
            x = torch.randn((m, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
            kern = time_ms(lambda: fn(x, q, s, b, GROUP_SIZE, BITS))
            plain = time_ms(lambda: qm.quant_matmul_reference(x, q, s, b, GROUP_SIZE, BITS))
            dense_ms = time_ms(lambda: torch.nn.functional.linear(x, dense))
            lib, why = None, lib_why
            if lib_weight is not None:
                lib_fn = lambda: torch._weight_int4pack_mm(x, lib_weight[0], GROUP_SIZE,  # noqa: E731
                                                           lib_weight[1])
                try:
                    got = lib_fn()
                except RuntimeError as e:
                    got, why = None, f"_weight_int4pack_mm refused: {str(e).splitlines()[0]}"
                if got is not None:
                    ref = qm.quant_matmul_reference(x, q, s, b, GROUP_SIZE, BITS)
                    _, worst, rel_l2 = kernel_disagreement(got, ref)
                    if worst <= 1 and rel_l2 <= REL_L2_TOL:
                        lib = time_ms(lib_fn)
                    else:
                        why = (f"disagrees with the plain version (err/limit {worst:.3f}, "
                               f"rel L2 {rel_l2:.3e})")
            flops, nbytes = quant_work(m, out_dim, in_dim)
            ops_ms, bytes_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3, nbytes / PEAK_BYTES * 1e3
            rows.append(dict(kernel=kernel, name=name, m=m, ms=kern, plain_ms=plain,
                             dense_ms=dense_ms, library_ms=lib, bound_ms=max(ops_ms, bytes_ms),
                             ops_ms=ops_ms, bytes_ms=bytes_ms))
            lib_txt = f"{lib:.4f} ms" if lib is not None else f"null ({why})"
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            if kernel == "quant_gemv":
                walk = f" (IN split {qm.plan_gemv(out_dim, in_dim, sms) or 'whole'})"
            else:
                tile, split = qm.plan_matmul(m, out_dim, in_dim, sms)
                walk = f" (token tile {tile}, IN split {split or 'whole'})"
            log(f"[timing] {kernel} {name} M={m} OUT={out_dim} IN={in_dim} bf16, fp16 scales: "
                f"kernel {kern:.4f} ms{walk}, plain {plain:.4f} ms, dense F.linear "
                f"{dense_ms:.4f} ms, int4pack_mm {lib_txt}, bound {max(ops_ms, bytes_ms):.4f} ms "
                f"({'operations' if ops_ms >= bytes_ms else 'bytes'}; {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB), {nbytes / 1e6 / kern:.0f} GB/s, "
                f"{flops / kern / 1e9:.0f} TFLOP/s, "
                f"{max(ops_ms, bytes_ms) / kern:.1%} of the bound")
        del q, s, b, dense, lib_weight
    return rows


# projections whose row blocks leave half an H100's SMs idle, so that
# plan_gemv weighs splitting their walk over IN: o_proj and down_proj of
# Llama-3.2-1B (hidden 2048, MLP 8192) and Qwen2-1.5B (1536, 8960)
SPLIT_SHAPES = (
    ("llama-1b o_proj", 2048, 2048),
    ("llama-1b down_proj", 2048, 8192),
    ("qwen2-1.5b o_proj", 1536, 1536),
    ("qwen2-1.5b down_proj", 1536, 8960),
)


def phase_gemv_split_timing(seed: int) -> list:
    """The bf16 GEMV at ``SPLIT_SHAPES``, M = 1 and 8: the walk over IN
    split in two against the whole walk, timed in the order split, whole,
    split, whole, beside what ``plan_gemv`` picks."""
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    default_split = qm.SPLIT_IN
    for name, out_dim, in_dim in SPLIT_SHAPES:
        _, q, s, b = quant_operands(gen, 1, out_dim, in_dim, integer=False)
        half = -(-in_dim // (2 * qm.SPLIT_ALIGN)) * qm.SPLIT_ALIGN
        planned = qm.plan_gemv(out_dim, in_dim, sms)
        for m in (1, 8):
            x = torch.randn((m, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
            times = {}
            try:
                for split in (half, 0, half, 0):
                    qm.SPLIT_IN = split
                    times.setdefault(split, []).append(
                        time_ms(lambda: qm.quant_gemv(x, q, s, b, GROUP_SIZE, BITS)))
            finally:
                qm.SPLIT_IN = default_split
            rows.append(dict(name=name, m=m, split=half, planned=planned, split_ms=times[half],
                             whole_ms=times[0]))
            log(f"[timing] quant_gemv {name} M={m} OUT={out_dim} IN={in_dim}: split in two "
                f"({half}) {' / '.join(f'{t:.4f}' for t in times[half])} ms, whole walk "
                f"{' / '.join(f'{t:.4f}' for t in times[0])} ms; plan_gemv picks "
                f"{planned or 'whole'}")
        del q, s, b
    return rows


def quant_record(rows, kernel, launches, max_err):
    """The kernels-line entry of a packed-weight kernel: per-launch means as
    the main path weighs them. The GEMV: a decode step's 129 launches at
    M = 1 (32 of each layer shape and the head), and beside them the same
    mean at M = 8 (``ms_m8``, ``library_ms_m8``); the matmul: a prefill
    chunk's four layer shapes at M = 256, equally, and beside them the same
    mean at the 600-token prompt's last chunk, M = 88 (``ms_m88``,
    ``dense_ms_m88``)."""

    def mean(key, m):
        if kernel == "quant_gemv":
            sel = [r for r in rows if r["kernel"] == kernel and r["m"] == m]
            weights = [1 if r["name"] == "lm_head" else 32 for r in sel]
        else:
            sel = [r for r in rows if r["kernel"] == kernel and r["m"] == m
                   and r["name"] != "lm_head"]
            weights = [1] * len(sel)
        vals = [r[key] for r in sel]
        if any(v is None for v in vals):
            return None
        return sum(w * v for w, v in zip(weights, vals)) / sum(weights)

    if kernel == "quant_gemv":
        m, extra = 1, {"ms_m8": mean("ms", 8), "library_ms_m8": mean("library_ms", 8)}
    else:
        m = PREFILL_M
        extra = {"ms_m88": mean("ms", TAIL_M), "dense_ms_m88": mean("dense_ms", TAIL_M)}
    return {
        "name": kernel,
        "route": "cuda",
        "source": "mlx_sharding_tpu_torch/csrc/quant_matmul.cu",
        "replaces": ("mlx_sharding_tpu/ops/quant_matmul.py:382" if kernel == "quant_gemv"
                     else "mlx_sharding_tpu/ops/quant_matmul.py:163"),
        "launches": launches,
        "max_abs_err": max_err,
        "ms": mean("ms", m),
        "plain_ms": mean("plain_ms", m),
        "bound_ms": mean("bound_ms", m),
        "bound_by": "operations" if mean("ops_ms", m) >= mean("bytes_ms", m) else "bytes",
        "library_ms": mean("library_ms", m),
        "dense_ms": mean("dense_ms", m),
        **extra,
    }


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


def phase_main_path(seed: int):
    """The port's server over Llama-3.1-8B at full width. Returns the flash
    launches of the counted run, the measured request numbers and the
    model."""
    from mlx_sharding_tpu_torch.generate import DEFAULT_DECODE_BLOCK, Generator
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
    graph_line("[main]", gen.warm_up())
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
    blocks = lambda n: -(-(n - 1) // DEFAULT_DECODE_BLOCK)  # noqa: E731  (after the first token)
    stats = {}
    try:
        # warm-up outside the counted run: cuBLAS handles, the kernel library
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"warm-up request failed: {status}")
        fa.flash_attention.launches = 0
        served = ServedRun(gen, model)
        expected_chunks = 0
        expected_blocks = blocks(32) + blocks(24) + 2 * blocks(24) + blocks(64)

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
            # logprobs carry the token ids: random weights sample ids past
            # the 256 bytes, which decode to no text
            status, body, _, t_end = post(port, "/v1/completions", {
                "prompt": mid_prompt, "max_tokens": 24, "temperature": 0.8, "top_p": 0.9,
                "seed": 1234, "logprobs": 1})
            check(status == 200 and body["usage"]["completion_tokens"] == 24,
                  f"sampled completion: {status} {body.get('usage')}")
            sampled.append(body["choices"][0]["logprobs"]["tokens"])
            expected_chunks += chunks(300)
        check(sampled[0] == sampled[1], "seeded sampled completions differ")
        log(f"[main] /v1/completions seeded sample (T=0.8, top_p=0.9) twice: 200, the same "
            f"{len(sampled[0])} token ids")

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
        served.check("[main]", expected_chunks + expected_blocks)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # the kernel path against the plain attention path of the same model:
    # a 192-token chunk is not a multiple of 128, so it takes the plain path
    prompt = np.asarray([tok.encode(long_prompt)], np.int64)
    out = {}
    for chunk_len in (CHUNK, 192):
        g = Generator(model, max_seq=MAX_SEQ, prefill_chunk=chunk_len, cuda_graphs=False)
        out[chunk_len] = g.run_prefill(prompt)
        del g
    kern, plain = out[CHUNK].float(), out[192].float()
    check(kern.shape == (1, cfg.vocab_size) and bool(torch.isfinite(kern).all()),
          "prefill logits not finite or of the wrong shape")
    rel = ((kern - plain).norm() / plain.norm()).item()
    same_top = bool((kern.argmax(-1) == plain.argmax(-1)).all())
    log(f"[main] last-position logits, kernel path vs plain path over 32 layers: relative L2 "
        f"error {rel:.3e} (tol {LOGITS_RTOL}), same argmax {same_top}")
    check(rel <= LOGITS_RTOL, "kernel path disagrees with the plain path")
    stats["prefill_ms"], runs = prefill_median_ms(lambda: gen.run_prefill(prompt))
    log(f"[main] Generator.run_prefill of the 600-token prompt, dense, graphs: median "
        f"{stats['prefill_ms']:.2f} ms of {len(runs)} device-synchronised runs after a warm-up "
        f"({' / '.join(f'{t:.2f}' for t in runs)})")
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main] torch.cuda.max_memory_allocated {stats['max_memory_allocated_gb']:.2f} GB "
        f"(graph pool included)")
    stats["steps"] = phase_step_timing(model, gen, "[main]", prompt)
    del gen
    stats["attention"] = full_capacity_attention_ms(seed, cfg.num_hidden_layers)
    return launches, stats, model


def full_capacity_attention_ms(seed: int, layers: int) -> dict:
    """The dense T=1 decode attention at Llama-3.1-8B's shapes, device ms of
    one layer (``time_ms``: the L2 flushed, as a layer finds its K/V after
    the other layers ran): over the whole 4096-position capacity, masked
    from a device position (what a captured step runs), against the same
    query over the 601-position prefix only (the host-offset plain path the
    port's eager decode ran before), and the two outputs within the
    kernels' bf16 limits of each other."""
    from mlx_sharding_tpu_torch.ops.attention import masked_attention
    from mlx_sharding_tpu_torch.ops.flash_attention import flash_attention_reference

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    q, k, v = attention_inputs(gen, 1, 1, MAX_SEQ, 32, 8, 128, 128, torch.bfloat16)
    pos = torch.tensor([600], dtype=torch.int64, device="cuda")
    scale = 128**-0.5
    full = masked_attention(q, k, v, pos, scale)
    prefix = flash_attention_reference(q, k, v, 600, scale, probs_dtype=torch.bfloat16)
    _, worst, rel_l2 = kernel_disagreement(full, prefix)
    check(worst <= 1 and rel_l2 <= REL_L2_TOL, "full-capacity attention disagrees with the prefix")
    out = {"full_ms": time_ms(lambda: masked_attention(q, k, v, pos, scale)),
           "prefix_ms": time_ms(lambda: flash_attention_reference(
               q, k, v, 600, scale, probs_dtype=torch.bfloat16))}
    log(f"[main] dense T=1 attention, one layer at position 600: over the whole capacity "
        f"{out['full_ms']:.4f} ms, over the prefix {out['prefix_ms']:.4f} ms (device time, L2 "
        f"flushed); {layers} layers: {layers * out['full_ms']:.3f} against "
        f"{layers * out['prefix_ms']:.3f} ms a decode step; outputs agree (worst err/limit "
        f"{worst:.3f}, relative L2 {rel_l2:.2e})")
    return out


class ServedRun:
    """What a served run did to a generator's graphs (a Generator's or a
    batcher's) and to the eager forwards of ``owner`` (the model, or the
    engine for the batcher's prefill chunks and ragged decode steps): taken
    at construction and checked by :meth:`check`."""

    def __init__(self, generator, owner):
        self.graphs, self.owner = generator.graphs, owner
        self.replays, self.captures = self.graphs.replays, self.graphs.captures
        self.forwards = owner.eager_forwards

    def check(self, tag: str, want_replays: int) -> int:
        replays = self.graphs.replays - self.replays
        captures = self.graphs.captures - self.captures
        forwards = self.owner.eager_forwards - self.forwards
        log(f"{tag} served run: {replays} graph replays (the requests need {want_replays}), "
            f"{captures} captures, {forwards} eager forwards on the card")
        check(replays == want_replays, "graph replays disagree with the requests' steps")
        check(captures == 0 and forwards == 0, "a served request ran a step eagerly")
        return replays


def graph_line(tag: str, captured: dict) -> None:
    log(f"{tag} captured {captured['graphs']} CUDA graphs in {captured['seconds']:.2f}s; graph "
        f"pool {captured['pool_bytes'] / 1e6:.1f} MB")


def host_and_wall_ms(fn, calls: int, steps: int):
    """(host ms, wall ms) per step of ``calls`` calls of ``fn``, each
    ``steps`` steps: host, until the last call returns (what the host takes
    to enqueue them); wall, until the card has run them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return host * 1e3 / (calls * steps), wall * 1e3 / (calls * steps)


def kernel_ms(fn, calls: int) -> tuple:
    """Device time by kernel name (ms, summed over the window) of ``calls``
    calls of ``fn`` under ``torch.profiler`` (CPU and CUDA activities), and
    the window's wall ms (profiled, so the host is slower than without)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return by_name, wall


def step_numbers(fn, calls: int, steps: int, profiled: int) -> dict:
    """One step's host ms and wall ms over ``calls`` calls of ``fn`` (each
    ``steps`` steps), its device ms (the profiler's kernel time per step,
    over ``profiled`` more calls), the device's busy share of the
    unprofiled wall time, and the six kernels that take most of the device
    time."""
    fn()
    host, wall = host_and_wall_ms(fn, calls, steps)
    kernels, prof_wall = kernel_ms(fn, profiled)
    device = sum(kernels.values()) / (profiled * steps)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"host_ms": host, "wall_ms": wall, "device_ms": device,
            "busy": device / wall if device else None,
            "profiled_busy": sum(kernels.values()) / prof_wall,
            "kernels": [(name[:70], ms / (profiled * steps)) for name, ms in top]}


def stream_tokens(gen, prompt: list, **kw) -> tuple:
    """The tokens of one request through ``gen.generate_step``, and its
    decode tok/s (tokens after the first over the time after the first)."""
    toks, t_first = [], None
    for t, _ in gen.generate_step(prompt, **kw):
        if t_first is None:
            t_first = time.perf_counter()
        toks.append(t)
    torch.cuda.synchronize()
    return toks, (len(toks) - 1) / (time.perf_counter() - t_first)


def phase_step_timing(model, gen, tag: str, prompt: np.ndarray) -> list:
    """Where the time goes, eager against graph, in one process, in the
    order eager, graph, graph, eager: ``gen`` (the served Generator, its
    graphs captured) and a Generator of the same model that runs the same
    steps eagerly. Each turn: the ``run_prefill`` median of the prompt, one
    greedy 64-token stream (its decode tok/s), one decode step (blocks of
    16 greedy steps) and one 256-token prefill chunk (at offset 256): host
    ms, wall ms, the device's busy share and the kernels by device time.
    The streams must be token-identical both ways, and a seeded top-p
    sample too."""
    from mlx_sharding_tpu_torch.generate import (DEFAULT_DECODE_BLOCK, REPETITION_WINDOW,
                                                 Generator)

    gens = {"graph": gen,
            "eager": Generator(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK, cuda_graphs=False)}
    ids = prompt[0].tolist()
    seeded = dict(max_tokens=24, temperature=0.8, top_p=0.9, seed=1234)
    rows, streams = [], {}
    for mode in ("eager", "graph", "graph", "eager"):
        g = gens[mode]
        row = {"mode": mode}
        row["prefill_ms"], _ = prefill_median_ms(lambda g=g: g.run_prefill(prompt), runs=3)
        toks, row["decode_tok_s"] = stream_tokens(g, ids, max_tokens=64)
        sampled, _ = stream_tokens(g, ids[:300], **seeded)
        streams.setdefault(mode, []).append((toks, sampled))
        list(g.generate_step(ids, max_tokens=1))  # the state of a request at its first token
        row["decode"] = step_numbers(
            lambda g=g: g.decode_block(DEFAULT_DECODE_BLOCK, REPETITION_WINDOW, False, False),
            calls=2, steps=DEFAULT_DECODE_BLOCK, profiled=1)
        row["prefill_chunk"] = step_numbers(lambda g=g: g.run_chunk(CHUNK), calls=4, steps=1,
                                            profiled=2)
        for what in ("decode", "prefill_chunk"):
            r = row[what]
            busy = "not measured" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
            log(f"{tag} {mode} {what.replace('_', ' ')}: host {r['host_ms']:.3f} ms, wall "
                f"{r['wall_ms']:.3f} ms, device {r['device_ms']:.3f} ms per step; device busy "
                f"{busy} of the wall ({100 * r['profiled_busy']:.1f}% under the profiler); "
                + ", ".join(f"{n} {ms:.3f}" for n, ms in r["kernels"]))
        log(f"{tag} {mode}: run_prefill median {row['prefill_ms']:.2f} ms, greedy 64-token stream "
            f"{row['decode_tok_s']:.2f} tok/s")
        rows.append(row)
    check(all(run == streams["eager"][0] for runs in streams.values() for run in runs),
          "the graph path's streams differ from the eager steps'")
    log(f"{tag} greedy 600-token-prompt 64-token streams and a seeded top-p 24-token sample: "
        f"token-identical through graphs and eagerly on the card, twice each")
    del gens["eager"]
    return rows


def prefill_median_ms(prefill, runs=5):
    """Median wall time, in ms, of ``prefill()`` (one ``Generator.run_prefill``
    of a prompt, device-synchronised before and after each call), after one
    warm-up call; and the runs. Prefill alone, without the server and the
    client: it moves less than one TTFT."""
    times = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def mix_prompt(i: int, n: int) -> str:
    """Prompt ``i`` of the mix: ``n`` bytes, so ``n`` tokens."""
    words = (f"request {i} asks the pool for pages; each slot decodes at its own length "
             "while the others prefill. ")
    return (words * (n // len(words) + 1))[:n]


def first_step_logits(model, kv_dtype, prompts):
    """The ragged path at the engine level: ``prompts`` prefilled into
    their own slots of an engine over its own pool, each slot's first token
    the argmax of its prefill logits, then one decode step of all slots.
    Returns (the first tokens, the step's logits (M, V))."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine

    m = len(prompts)
    need = [-(-(len(p) + 1) // PAGE) for p in prompts]
    engine = PipelineEngine(model, microbatches=m, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                            pool_pages=sum(need), page_size=PAGE, kv_dtype=kv_dtype,
                            device=model.device)
    cache, table = engine.init_cache_paged()
    first = []
    start = 0
    for slot, prompt in enumerate(prompts):
        table[slot, : need[slot]] = np.arange(start, start + need[slot])
        start += need[slot]
        for pos in range(0, len(prompt), CHUNK):
            chunk = np.asarray(prompt[pos : pos + CHUNK], np.int64)
            n_valid = chunk.size
            logits = engine.prefill_slot(np.pad(chunk, (0, CHUNK - n_valid)), slot, cache,
                                         n_valid, table)
        first.append(int(logits.argmax(-1)))
    plan = engine.decode_plan(cache, table, [True] * m, 1)
    tokens = torch.tensor(first, dtype=torch.int64, device=model.device)[:, None]
    return first, engine.ragged_logits(tokens, cache, plan, 0).float()


def tick_line(tag: str, batcher) -> None:
    t = batcher.tick_timing_stats()
    log(f"{tag} ticks: {t['path']}, {t['ticks']} harvests, harvest blocked "
        f"{t['device_blocked_ms_avg']:.3f} ms and host {t['host_ms_avg']:.3f} ms per tick "
        f"(means); {batcher.preemptions} preemptions, {batcher.reprefill_tokens} tokens "
        f"re-prefilled; {batcher.async_reason}")


def phase_batching(model, seed: int, kv_dtype: str, single_stream_tok_s: float) -> dict:
    """Continuous batching over the paged pool at full width: the port's
    server in front of a ``ContinuousBatcher`` of ``SLOTS`` slots over
    ``POOL_PAGES`` pages of ``PAGE`` tokens, ``kv_dtype`` pool, async ticks;
    the int8 pool's run admits on overcommit and preempts. Returns the
    launches of the counted run per attention kernel and the numbers."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, make_server

    cfg = model.config
    overcommit = kv_dtype == "int8"
    mix = (tuple((n, m + OVERCOMMIT_EXTRA_TOKENS) for n, m in BATCH_MIX) if overcommit
           else BATCH_MIX)
    tag = f"[batch-{kv_dtype}]"
    gc.collect()  # the earlier phases' servers: their handler classes sit in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"{tag} torch.cuda.memory_allocated at the start {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    engine = PipelineEngine(model, microbatches=SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                            pool_pages=POOL_PAGES, page_size=PAGE, kv_dtype=kv_dtype,
                            device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8, overcommit=overcommit)
    log(f"{tag} engine: {SLOTS} slots, pool {POOL_PAGES} pages of {PAGE} tokens "
        f"({batcher.cache.nbytes / 1e6:.1f} MB of {kv_dtype} K/V), "
        f"{'overcommit' if overcommit else 'reserve'} admission, {batcher.async_reason}")
    captured = batcher.warm_up()
    graph_line(tag, captured)
    tok = ByteTokenizer()
    server = make_server(ModelProvider(batcher, tok, model_name="llama-3.1-8b-cb"), "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    force_a = {"65": 100.0}
    # the seeded twins are not streamed: their logprobs carry the token ids
    # (random weights sample ids past the 256 bytes, which decode to nothing)
    seeded = {"temperature": 0.8, "top_p": 0.9, "seed": 4321, "logprobs": 1}
    jobs = []
    for i, (n, max_tokens) in enumerate(mix):
        body = {"prompt": mix_prompt(i, n), "max_tokens": max_tokens}
        body.update(seeded if i == len(mix) - 1 else {"logit_bias": force_a, "stream": True})
        jobs.append(body)
    results = [None] * len(jobs)
    stats = {}
    try:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"warm-up request failed: {status}")
        pa.paged_attention.launches = fa.flash_attention.launches = 0
        steps0, chunks0, waits0 = batcher.decode_steps, batcher.prefill_chunks, batcher.page_waits
        served = ServedRun(batcher, engine)

        status, alone, _, _ = post(port, "/v1/completions", jobs[-1])
        check(status == 200, f"seeded request alone: status {status}: {alone}")
        batcher.reset_tick_timing()

        def send(i):
            results[i] = post(port, "/v1/completions", jobs[i], stream="stream" in jobs[i])

        decode_s0 = batcher.decode_seconds
        t0 = time.perf_counter()
        # the seeded twin goes first, so that it is the oldest request in
        # the pool: overcommit preempts the newest, never the oldest
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(jobs))]
        threads[-1].start()
        time.sleep(0.3)
        for t in threads[:-1]:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        decode_s = batcher.decode_seconds - decode_s0
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": fa.flash_attention.launches}
        steps = batcher.decode_steps - steps0
        chunks = batcher.prefill_chunks - chunks0
        waits = batcher.page_waits - waits0
        high_water = batcher.pages_high_water
        served.check(tag, steps // batcher.decode_block + chunks)
        tick_line(tag, batcher)
        ticks = batcher.tick_timing_stats()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.close()
    ttfts = []
    for i, ((n, max_tokens), res) in enumerate(zip(mix[:-1], results)):
        check(res is not None, f"request {i} did not return")
        status, events, t_head, t_end = res
        check(status == 200 and events[-1] == "[DONE]", f"request {i}: status {status}")
        text = stream_text(events, chat=False)
        check(text == "A" * max_tokens, f"request {i}: {len(text)} bytes, want {max_tokens}")
        ttfts.append(t_head)
        log(f"{tag} request {i}: {n}-token prompt, {max_tokens} tokens, TTFT {t_head * 1e3:.1f} ms, "
            f"done in {t_end:.3f}s")
    check(results[-1] is not None, "the seeded request among others did not return")
    status, twin, _, t_end = results[-1]
    check(status == 200, f"seeded request among others: status {status}: {twin}")
    ids = [r["choices"][0]["logprobs"]["tokens"] for r in (alone, twin)]
    check(len(ids[0]) == mix[-1][1] and ids[0] == ids[1]
          and alone["choices"][0]["text"] == twin["choices"][0]["text"],
          "the seeded request gave other tokens among others than alone")
    log(f"{tag} request {len(mix) - 1}: the seeded top-p twin (not streamed, sent first), done "
        f"in {t_end:.3f}s: the same {len(ids[0])} token ids as alone")
    want_chunks = sum(-(-n // CHUNK) for n, _ in mix) + -(-mix[-1][0] // CHUNK)
    preemptions = batcher.preemptions
    log(f"{tag} batcher: {chunks} prefill chunks (the requests need {want_chunks} without "
        f"preemption), {steps} decode steps, {waits} requests waited for pages, pool high-water "
        f"{high_water} of {POOL_PAGES} pages, {preemptions} preemptions")
    if overcommit:
        check(preemptions >= 1, "the overcommit run preempted nothing")
        check(chunks >= want_chunks, "fewer prefill chunks than the requests need")
    else:
        check(preemptions == 0 and chunks == want_chunks,
              "prefill chunk count disagrees with the requests")
    check(waits >= 1, "no request waited for pages: the pool is too large for the check")
    layers = cfg.num_hidden_layers
    for name, count in (("paged_attention", steps), ("flash_attention", chunks)):
        log(f"{tag} {name} launches {launches[name]}, expected {layers} layers x {count} = "
            f"{layers * count}")
        check(launches[name] == layers * count, f"{name} launch count disagrees with the batcher")
    decoded = sum(max_tokens - 1 for _, max_tokens in mix)
    stats = {"decode_tok_s": decoded / decode_s, "mix_tok_s": sum(m for _, m in mix) / wall,
             "ttft_ms": [t * 1e3 for t in ttfts], "pool_bytes": batcher.cache.nbytes,
             "graph_pool_bytes": captured["pool_bytes"], "capture_s": captured["seconds"],
             "graphs": captured["graphs"], "preemptions": preemptions, "ticks": ticks,
             "reprefill_tokens": batcher.reprefill_tokens}
    log(f"{tag} aggregate decode {stats['decode_tok_s']:.2f} tok/s over {SLOTS} slots (tokens "
        f"after each request's first / host time in decode blocks) against "
        f"{single_stream_tok_s:.2f} tok/s for one stream (phase 4); the mix's "
        f"{sum(m for _, m in mix)} tokens in {wall:.3f}s = {stats['mix_tok_s']:.2f} tok/s")
    del batcher, engine, server
    batcher_parity(model, kv_dtype, tag)

    # the engine level: each slot's first decode step against the
    # single-stream model's first T=1 step on the same prompt and token
    prompts = [tok.encode(mix_prompt(i, n)) for i, (n, _) in enumerate(BATCH_MIX[:SLOTS])]
    first, got = first_step_logits(model, kv_dtype, prompts)
    gen = Generator(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK, cuda_graphs=False)
    worst = 0.0
    for slot, prompt in enumerate(prompts):
        gen.run_prefill(np.asarray([prompt], np.int64))
        want, _ = model(torch.tensor([[first[slot]]], device=model.device), gen.cache)
        want = want[0, -1].float()
        check(bool(torch.isfinite(got[slot]).all()), f"slot {slot}: logits not finite")
        rel = ((got[slot] - want).norm() / want.norm()).item()
        worst = max(worst, rel)
        log(f"{tag} slot {slot} ({len(prompt)}-token prompt): first decode step logits vs the "
            f"single-stream T=1 step: relative L2 {rel:.3e} (tol {LOGITS_RTOL}), same argmax "
            f"{bool(got[slot].argmax() == want.argmax())}")
        check(rel <= LOGITS_RTOL, f"slot {slot} disagrees with the single-stream path")
    del got, gen
    stats["worst_logits_rel_l2"] = worst
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} torch.cuda.max_memory_allocated {stats['max_memory_allocated_gb']:.2f} GB "
        f"(16.06 GB of weights)")
    return launches, stats


def serve_on_this_thread(batcher, jobs, *, cancel_after=None, tick=None):
    """Serve ``jobs`` ``[(prompt, kwargs)]`` by running the batcher's ticks
    on the calling thread (no scheduler thread), every request submitted
    before the first tick, so that a run's admissions and preemptions
    depend on the jobs alone. ``cancel_after=(i, n)`` closes stream i after
    its n-th token, as a client that walks away. ``tick``: what one
    iteration calls, ``batcher.run_tick`` by default. Returns each stream's
    ``(token, logprobs)`` items and the requests (their ``preempted_at``)."""
    tick = tick or batcher.run_tick
    batcher._ensure_running = lambda: None
    streams = [batcher.generate_step(p, **kw) for p, kw in jobs]
    reqs = list(batcher._submit.queue)
    got = [[] for _ in jobs]
    ended = [False] * len(jobs)
    with torch.no_grad():
        for _ in range(100000):
            for i, (stream, req) in enumerate(zip(streams, reqs)):
                while not ended[i] and not req.out.empty():
                    if cancel_after == (i, len(got[i])):
                        stream.close()  # marks the request cancelled
                        ended[i] = True
                        break
                    try:
                        got[i].append(next(stream))
                    except StopIteration:
                        ended[i] = True
            if all(ended):
                break
            tick()
    check(all(ended), "the batcher wedged")
    return got, reqs


def batcher_parity(model, kv_dtype: str, tag: str) -> None:
    """The batcher's paths against each other on the card, each run served
    on this thread (the same admissions in every run), over ``POOL_PAGES``
    pages: five greedy requests and a seeded top-p one (``PARITY_PROMPTS``,
    ``PARITY_TOKENS`` each). The prefill and decode graphs against the same
    steps run eagerly, and sync ticks against async ones: token-identical.
    Overcommit against reserve: a request never preempted token-identical;
    a preempted one identical up to its preemption, after which it resumes
    from a re-prefill of its folded tokens, whose K/V the prefill path
    computes in bf16 where the reserve run's came from decode steps (the
    tokens that still agree are printed)."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tok = ByteTokenizer()
    jobs = [(tok.encode(mix_prompt(20 + i, n)), dict(max_tokens=PARITY_TOKENS))
            for i, n in enumerate(PARITY_PROMPTS[:-1])]
    jobs.append((tok.encode(mix_prompt(30, PARITY_PROMPTS[-1])),
                 dict(max_tokens=PARITY_TOKENS, temperature=0.8, top_p=0.9, seed=99)))
    runs = {}
    for name, kw in (("graphs", {}), ("eager", dict(cuda_graphs=False)),
                     ("sync", dict(async_sched="off")), ("overcommit", dict(overcommit=True))):
        engine = PipelineEngine(model, microbatches=SLOTS, max_seq=PARITY_MAX_SEQ,
                                prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                                kv_dtype=kv_dtype, device=model.device)
        batcher = ContinuousBatcher(engine, decode_block=8, **kw)
        batcher.warm_up()
        items, reqs = serve_on_this_thread(batcher, jobs)
        streams = [[t for t, _ in s] for s in items]
        check(all(len(s) == PARITY_TOKENS for s in streams),
              f"{tag} parity run ({name}): a request did not finish")
        runs[name] = (streams, [r.preempted_at for r in reqs])
        tick_line(f"{tag} parity run ({name})", batcher)
        batcher.close()
        del batcher, engine
    check(runs["graphs"][0] == runs["eager"][0], f"{tag} the batcher's prefill and decode graphs "
          "and its eager steps give other tokens")
    check(runs["sync"][0] == runs["graphs"][0], f"{tag} async and sync ticks give other tokens")
    reserve, (oc, preempted) = runs["graphs"][0], runs["overcommit"]
    check(any(preempted), f"{tag} the overcommit parity run preempted nothing")
    for i, (want, got, at) in enumerate(zip(reserve, oc, preempted)):
        same = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b), len(want))
        if at:
            log(f"{tag} overcommit request {i}: preempted after {at} tokens, resumed; the first "
                f"{same} of {len(want)} tokens equal the reserve run's")
            check(same >= at[0], f"{tag} request {i} diverged before its preemption")
        else:
            check(same == len(want), f"{tag} request {i}, never preempted, diverged under "
                  "overcommit")
    log(f"{tag} five greedy requests and a seeded top-p one, {PARITY_TOKENS} tokens each: "
        "token-identical through the graphs and the eager steps, through async and sync ticks, "
        "and under overcommit for every request not preempted")


def pack_llama(dense, config: dict, group_size=GROUP_SIZE, bits=BITS, param_dtype=torch.float16):
    """A packed model of the dense model's numbers: every layer projection,
    the embedding and the LM head packed on their device by
    ``quantize_torch`` in MLX's layout (scales and biases in
    ``param_dtype``), as ``loading.load_model(keep_quantized=True)`` keeps
    an MLX 4-bit checkpoint; the norms are shared."""
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.ops.quant import quantize_torch

    model, _ = build_model({**config, "quantization": {"group_size": group_size, "bits": bits}},
                           dtype=dense.dtype)
    sd = {}
    for name, t in dense.state_dict().items():
        path = name.removesuffix(".weight")
        if path != name and isinstance(dense.get_submodule(path),
                                       (torch.nn.Linear, torch.nn.Embedding)):
            q, s, b = quantize_torch(t, group_size, bits)
            sd[name] = {"q": q, "scales": s.to(param_dtype), "biases": b.to(param_dtype)}
        else:
            sd[name] = t
    model.load_weights(sd, dense.device, dense.dtype)
    return model


def phase_main_path_4bit(dense, seed: int):
    """``--keep-quantized`` at full width: the dense model's weights packed
    on the card, its last-position logits against a dense model holding the
    dequantized weights (the dense model itself, overwritten in place), then
    the dense weights freed and the packed, fused model served. Returns the
    launches of the counted run per kernel and the request numbers."""
    from mlx_sharding_tpu_torch.generate import DEFAULT_DECODE_BLOCK, Generator
    from mlx_sharding_tpu_torch.models.base import QuantizedLinear
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, make_server

    cfg = dense.config
    t0 = time.perf_counter()
    packed = pack_llama(dense, LLAMA_31_8B)
    torch.cuda.synchronize()
    mods = {n: m for n, m in packed.named_modules() if isinstance(m, QuantizedLinear)}
    packed_bytes = sum(t.numel() * t.element_size() for m in mods.values() for t in m.buffers())
    log(f"[main-4bit] packed {len(mods)} projections (embedding and LM head included) on the card "
        f"in {time.perf_counter() - t0:.1f}s: group {GROUP_SIZE}, {BITS} bits, fp16 scales and "
        f"biases, {packed_bytes / 1e9:.3f} GB")
    with torch.no_grad():
        for name, mod in mods.items():
            dense.get_submodule(name).weight.copy_(mod.dequantized(dense.dtype))
    del mods  # fusion must be able to release the unfused projections
    tok = ByteTokenizer()
    words = ("pipeline stages pass activations over rings while the cache grows; "
             "every chunk of the prompt runs through the flash kernel. ")
    long_prompt = (words * 8)[:600]
    gen = Generator(packed, max_seq=MAX_SEQ, prefill_chunk=CHUNK)
    log(f"[main-4bit] fused {gen.fused_projections}")
    prompt = np.asarray([tok.encode(long_prompt)], np.int64)
    got = gen.run_prefill(prompt)
    dgen = Generator(dense, max_seq=MAX_SEQ, prefill_chunk=CHUNK, cuda_graphs=False)
    want = dgen.run_prefill(prompt)
    got, want = got.float(), want.float()
    check(got.shape == (1, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          "packed prefill logits not finite or of the wrong shape")
    rel = ((got - want).norm() / want.norm()).item()
    same_top = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"[main-4bit] last-position logits, packed model vs dense model of the dequantized "
        f"weights over 32 layers: relative L2 error {rel:.3e} (tol {LOGITS_RTOL}), same argmax "
        f"{same_top}")
    check(rel <= LOGITS_RTOL and same_top, "packed model disagrees with the dequantized dense model")
    del dgen, got, want
    dense.to("meta")  # frees the dense weights: the packed model serves alone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graph_line("[main-4bit]", gen.warm_up())

    server = make_server(ModelProvider(gen, tok, model_name="llama-3.1-8b-4bit"), "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    force_a = {"65": 100.0}
    stats = {}
    try:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"warm-up request failed: {status}")
        fa.flash_attention.launches = qm.quant_gemv.launches = qm.quant_matmul.launches = 0
        served = ServedRun(gen, packed)
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
        log(f"[main-4bit] /v1/completions 600-token prompt, 32 tokens, logprobs: 200 in {t_end:.3f}s")
        status, events, t_head, t_end = post(port, "/v1/completions", {
            "prompt": long_prompt, "max_tokens": 64, "stream": True, "logit_bias": force_a},
            stream=True)
        check(status == 200 and stream_text(events, chat=False) == "A" * 64,
              f"streamed completion: status {status}")
        stats = {"ttft_s": t_head, "prefill_tok_s": 600 / t_head,
                 "decode_tok_s": 63 / (t_end - t_head)}
        log(f"[main-4bit] /v1/completions stream, 600-token prompt, 64 tokens: TTFT "
            f"{t_head * 1e3:.1f} ms, prefill {stats['prefill_tok_s']:.1f} tok/s, decode "
            f"{stats['decode_tok_s']:.2f} tok/s (host clock at the client, one request)")
        launches = {"flash_attention": fa.flash_attention.launches,
                    "quant_gemv": qm.quant_gemv.launches,
                    "quant_matmul": qm.quant_matmul.launches}
        # whole decode blocks of 16: 31 and 63 tokens after the first
        block_counts = (-(-31 // DEFAULT_DECODE_BLOCK), -(-63 // DEFAULT_DECODE_BLOCK))
        served.check("[main-4bit]", 2 * 3 + sum(block_counts))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    layers, chunks = cfg.num_hidden_layers, 2 * 3
    steps = DEFAULT_DECODE_BLOCK * sum(block_counts)
    expected = {
        "flash_attention": layers * chunks,
        # fused QKV, o_proj, fused gate+up and down_proj per layer and chunk
        "quant_matmul": LAYER_SHAPES * layers * chunks,
        # the same four and the head per decode step; the head once per chunk
        "quant_gemv": (LAYER_SHAPES * layers + 1) * steps + chunks,
    }
    for name, want_n in expected.items():
        log(f"[main-4bit] {name} launches {launches[name]}, expected {want_n}")
        check(launches[name] == want_n, f"{name} launch count disagrees with the requests")
    stats["prefill_ms"], runs = prefill_median_ms(lambda: gen.run_prefill(prompt))
    log(f"[main-4bit] Generator.run_prefill of the 600-token prompt, packed, graphs: median "
        f"{stats['prefill_ms']:.2f} ms of {len(runs)} device-synchronised runs after a warm-up "
        f"({' / '.join(f'{t:.2f}' for t in runs)})")
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main-4bit] torch.cuda.max_memory_allocated while serving packed "
        f"{stats['max_memory_allocated_gb']:.2f} GB (graph pool included)")
    stats["steps"] = phase_step_timing(packed, gen, "[main-4bit]", prompt)
    return launches, stats


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, then stop (no result line)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    t0 = time.perf_counter()

    def lap(what):
        log(f"[time] {what} done {time.perf_counter() - t0:.1f}s into the run")

    build_kernels()
    max_err = phase_kernels(args.seed)
    quant_err = phase_quant_kernels(args.seed)
    paged_err = phase_paged_kernels(args.seed)
    lap("kernel builds and checks")
    if args.kernels_only:
        return 0
    rows = phase_timing(args.seed)
    quant_rows = phase_quant_timing(args.seed)
    phase_gemv_split_timing(args.seed)
    paged_rows = phase_paged_timing(args.seed)
    lap("kernel timing")
    launches, single, model = phase_main_path(args.seed)
    lap("main path")
    paged_launches = 0
    for kv_dtype in ("bf16", "int8"):
        batch_launches, _ = phase_batching(model, args.seed, kv_dtype, single["decode_tok_s"])
        paged_launches += batch_launches["paged_attention"]
        lap(f"continuous batching, {kv_dtype} pool")
    quant_launches, _ = phase_main_path_4bit(model, args.seed)
    lap("main path, 4-bit")
    del model

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
    for kernel in ("quant_gemv", "quant_matmul"):
        record["kernels"].append(
            quant_record(quant_rows, kernel, quant_launches[kernel], quant_err[kernel]))
    # the paged decode: means over the bf16 and int8 pools at the mix's
    # first decode step, which phase 6 serves
    mix_rows = [r for r in paged_rows if r["point"] == "mix"]
    pmean = lambda key: (None if any(r[key] is None for r in mix_rows)  # noqa: E731
                         else sum(r[key] for r in mix_rows) / len(mix_rows))
    record["kernels"].append({
        "name": "paged_attention",
        "route": "cuda",
        "source": "mlx_sharding_tpu_torch/csrc/paged_attention.cu",
        "replaces": "mlx_sharding_tpu/ops/paged_attention.py:153",
        "launches": paged_launches,
        "max_abs_err": paged_err,
        "ms": pmean("ms"),
        "plain_ms": pmean("plain_ms"),
        "bound_ms": pmean("bound_ms"),
        "bound_by": "operations" if pmean("ops_ms") >= pmean("bytes_ms") else "bytes",
        "library_ms": pmean("library_ms"),
        "library": "scaled_dot_product_attention after a gather (gather not timed)",
    })
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
