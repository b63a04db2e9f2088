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
   bits, group sizes 32-128 and ragged M, OUT and IN (and at the 8B shapes
   the speculative verify's M: the GEMV at 2 and 4, the matmul at 16, 32
   and 64), both walks over IN
   planned, whole and forced into splits (two runs bit-identical), and the
   ragged paged decode at the 8B shapes over uneven lengths, bf16 and int8
   pools, and odd pages, groups (3, 7 and 24 among them), Dk != Dv and
   dtypes, each with the walk planned, in blocks of 64 positions and whole;
   then two runs bit-identical, one row merging 22 partials, and one call
   captured in a CUDA graph holding one kernel and no memset; and the flash
   kernel's T=1 route (``flash_decode``: the paged kernel over the dense
   cache seen as pages) at the 8B shapes at positions 0, 600 and 4095 with
   one and two rows, and in f32: two runs bit-identical, one captured call
   one kernel node, and a call captured at 600 and replayed at 4095 equal
   to the call at 4095; then the model families' variants
   (``phase_family_kernels``): kernel 1 and its T=1 route at Gemma-2-9B's
   shapes with softcap 50 and windows 4096, 1000 and 100, chunk offsets 0,
   3840 and 4352 and positions below, at and past the window (and f32);
   kernel 2 with the same options over bf16 and int8 pools at lengths
   below, at and past each window and 0 (and the FMA kernel); the
   routed-expert GEMV at Mixtral's shapes, N = 1, 8 and 16, K = 2, every
   pair on one expert too, bit for bit on integer operands; then
   DeepSeek-V2's routes (``phase_mla_kernels``): kernel 1's MLA build (Dk
   576, v a view of k's first 512 columns, one KV head) at the Lite's group
   of 16 and V2's of 128 (walks planned, in 512s and whole) and in f32, the
   T=1 route and kernel 2 with ``values_from_k`` over bf16, int8 and f32
   (FMA) pools, and kernels 3 and 4 at the packed Lite's shapes (IN 10944,
   1408 and 2816; OUT 576, 3072 and 102400; the routed GEMV at E 64, K 6);
3. timing: each kernel, its plain version and the one PyTorch library call
   that computes the same function, with CUDA events (and, for the packed
   kernels, ``F.linear`` on the dequantized bf16 weight; for the paged
   decode, SDPA over K/V gathered beforehand, the gather not timed); the
   flash kernel at chunk offsets 0, 256, 512, 1280 and 3840, with the
   achieved TFLOP/s, its share of the bound and the walk split several ways;
   the matmul at M = 16, 32, 64, 88 and 256 with its token tile and
   split, the GEMV at M = 1, 2, 4 and 8;
   the GEMV's walk over IN split in two against whole at the narrow
   projections of Llama-3.2-1B and Qwen2-1.5B, beside the planner's pick;
   the paged decode at the points of ``PAGED_SWEEP`` (the mix's first
   decode step, 8 x 4096, 32 x 1024, 1 x 4096), planned and whole walks;
   the T=1 route at positions 600, 700 and 4095 against its plain version,
   ``masked_attention`` over the whole capacity (the plain path the
   captured decode step takes with the route off) and SDPA over the
   prefix with ``enable_gqa``; the families' variants at their served
   shapes (``phase_family_timing``), and DeepSeek-V2's routes at the Lite's
   and V2's shapes (``phase_mla_timing``);
4. main path: Llama-3.1-8B at full width (bf16 weights drawn on the card
   from ``--seed``) behind the port's OpenAI server in a thread, with a
   byte-level tokenizer defined here. The Generator captures its CUDA
   graphs first (16 chunk offsets, 4 decode blocks; their seconds and pool
   bytes are printed); five requests (a 600-token completion with
   logprobs, a streamed chat, a seeded top-p sample twice, a streamed
   600-token completion for TTFT and decode tok/s) then run as replays:
   flash launches checked against 32 x the prompt chunks, the T=1 route's
   against 32 x the decode steps, replays against the requests' chunks and
   decode blocks, no capture and no eager forward;
   the kernel path checked against the plain attention path of the same
   model, and the median of five device-synchronised
   ``Generator.run_prefill`` calls of the 600-token prompt after a warm-up;
   the dense T=1 attention's device time over the whole capacity (what the
   captured step runs) against the prefix alone, outputs within the bf16
   limits. Then where the time goes, eager against graph, in the order graph,
   eager, graph in this process (one eager turn): the prefill median, a greedy
   64-token stream's decode tok/s (16 tokens eagerly), and for one decode
   step and one 256-token prefill chunk the host ms, wall ms, device ms
   (torch.profiler) and busy share, and the kernels by device time; the
   streams' first 16 tokens and a seeded top-p sample token-identical both
   ways; then the two T=1 routes
   (``MST_FLASH_DECODE`` 1 and 0, graphs captured under each) in the order
   kernel, plain, plain, kernel: a greedy 64-token stream's tok/s and a
   decode step's device ms, each route's launches checked, and one T=1
   step's last-position logits on each route within the bf16 limits.
   Then speculation over a 600-token repeated passage, 64 tokens each
   (``phase_speculation``): plain greedy, ``--draft ngram``, the model as
   its own draft at K = 4 and the published Llama-3.2-1B config (random
   bf16 weights from the seed) at K = 4, each verifying on the served
   Generator (its prefill and decode graphs reused), each generator's
   other graphs captured first and its counted request all replays: tok/s, rounds by K, tokens
   a round, accept rate, launches checked against the rounds, and the
   stream against plain greedy decode's (a divergence only where the plain
   run's top-2 gap is under ``NEAR_TIE_GAP``); the n-gram run again with
   its output forced to an 8-byte cycle (whole windows accepted, K up to
   8); the verify's device ms at K = 2, 4, 8, split into
   ``masked_attention``, the products and the small kernels, and each
   draft's K steps' device ms;
5. main path, 4-bit (``--keep-quantized``): the same weights packed on the
   card in MLX's layout (group 64, 4 bits, fp16 scales and biases), fused,
   its graphs captured, served by the same server for two 600-token
   requests, every kernel's launches (replays included) checked against
   what the requests imply, replays against their chunks and blocks, the
   last position's logits checked against a dense model holding the
   dequantized weights, the packed prefill's median, where the time goes
   and the two T=1 routes, as in phase 4; the n-gram runs (natural and
   forced) with the GEMV's launches at each verify width M = K, and the
   packed verify's device ms and split.
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
   are printed); a request with ``"ttft_timeout": 0.001`` answers 504 and
   every page of the pool is free after it; prefix sharing on this thread:
   four greedy requests sharing a 512-token prefix, the first alone, with
   the cache off and on: token-identical, 3 hits, 1536 tokens reused and
   3 x 2 x 32 fewer flash launches; then, at the engine level, every
   slot's logits at its first decode step against the single-stream
   model's. Then the mix again under ``--draft ngram`` (its streamed
   requests forced to the 8-byte cycle): bf16 pool with async and with
   sync ticks, int8 pool with overcommit; the verify rounds replays too,
   ``spec_stats()``, and (bf16, async) the batcher verify's device ms at K
   = 2, 4, 8 split into the gather, ``masked_attention``, the products and
   the small kernels. The parity runs (graphs, eager, sync, overcommit;
   the prefix cache off and on) run on the model's first
   ``BATCH_PARITY_LAYERS`` layers (its tensors shared). Every served run
   (phases 6 and 10) ends with the server's ``/health`` before and after
   the batcher's ``close()``: 200 ``ok``, then 503 ``draining``.
7. speculation in f32 (``phase_spec_f32``, between 6 and 5): Llama-3.1-8B
   widths at 2 layers, 64 tokens: ``--draft ngram``, the self-draft, a
   2-layer Llama-3.2-1B-shaped draft and the batcher's n-gram speculation
   (sync and async ticks) token-identical to plain greedy decode, the
   self-draft accepting every token; then the self-draft at full depth
   (32 layers, f32) accepting every token.
8. the model families (``phase_families``, after 5, the Llama model
   freed): the published Qwen3-8B and Gemma-2-9B (bf16) and Mixtral-8x7B
   (packed on the card at 4 bits, group 64, router dense) configs at full
   width and depth, random weights from ``--seed``, one at a time: the
   Generator's graphs behind the server (a 600-token prompt, Gemma-2's
   4,400 tokens past its window, 64 forced tokens: TTFT, decode tok/s,
   every route's launches against the chunks and steps, no eager forward,
   a decode step's device ms); the paged batcher (4 slots, async ticks,
   four streamed requests and the Generator's greedy prompt, whose stream
   may leave the Generator's only at a near-tie); then f32 at 2 layers of
   the same widths: the Generator and the batcher token-identical for 32
   tokens, the prefill's last-position logits against a forward whose
   kernel entry points this process swaps for their plain versions.
   A ``[time]`` lap per family.
9. DeepSeek-V2 (``phase_deepseek``, after 8): the published
   deepseek-ai/DeepSeek-Coder-V2-Lite-Instruct config at full width and
   depth (27 layers, 64 experts top 6 beside 2 shared, YaRN 40), the
   compressed MLA cache, random weights from ``--seed``: bf16 (31.5 GB),
   then packed on the card in the layout of
   mlx-community/DeepSeek-Coder-V2-Lite-Instruct-4bit (9.1 GB), each served
   as phase 8 serves a family (Generator's graphs behind the server, then
   the 4-slot paged batcher; every route's launches against the chunks and
   steps, a decode step's device ms against the weight bytes it reads);
   then f32 at 2 layers (one dense, one MoE): the Generator and the
   batcher token-identical, the kernels against their plain versions, the
   compressed cache's logits against the full cache's within 1e-4.
10. the dense-slot batcher, the gather path and the draft engine
   (``phase_dense_batching``, between 7 and 5, on phase 4's dense model):
   phase 6's mix through the port's server with ``--concurrent 8`` and no
   pool (dense slot caches, async ticks), with ``--paged-pool 16
   --paged-attention gather``, and with ``--concurrent 8 --draft-model``
   (the model's first 8 layers, tensors shared; K = 4; sync ticks; the
   seeded twin asks for logprobs, so while it is live the ticks fall back
   to plain blocks replayed into the draft): every chunk, block, round and
   replay a graph replay with no capture and no eager forward, kernel 1's
   launches against 32 x the chunks (and the draft's 8 x its chunks), the
   T=1 route's against 32 x the decode steps (and 8 x the draft's steps),
   TTFTs, the mix's tok/s, harvest wait and host ms per tick, and for the
   draft engine tokens a round, the accept rate and the fallback ticks;
   kernel 1 with a device ``kv_index`` on one slot of 9 slot caches and the
   T=1 route at per-slot lengths (one slot idle) against their plain
   versions at the 8B shapes; then in f32 at 2 layers the dense, paged and
   gather batchers token-identical to the Generator, the draft engine to
   plain greedy decode, and the new call sites' logits against the plain
   versions'.
11. the server's single-host surfaces (``phase_surfaces``, between 10 and
   5, on phase 4's dense model): a ``prompt_cache=True`` Generator
   (capacity ``SURFACE_MAX_SEQ``) behind the server serves a three-turn
   chat, each turn re-sending the history (forced replies): each turn's
   TTFT, ``last_prefix_hit`` and prefill chunks, which start at the chunk
   boundary at or below the hit; the hit turn unforced against a cold run
   of the same prompt (the first token where the bf16 streams part); no
   graph captured after ``warm_up`` and no eager forward; kernel 1's and
   the T=1 route's launches against the chunks and steps; ``/metrics``
   counters against the requests served; ``GET /`` the port's
   ``index.html``. Kernel 1 at chunk starts 300 and 1000 (a full chunk)
   over a cache whose later rows hold garbage, against its plain version
   and bit-identical to the same call with those rows zero. A traced
   batcher (``--trace on --trace-profile``, 2 slots): one streamed
   request's spans from ``/admin/trace/<id>``, their ``decode_tick`` sum
   against its wall time, and under ``--profile-dir`` the
   ``mst.decode_block`` ranges in its ``torch.profiler`` trace against the
   blocks it dispatched. Hot-swap: a 2-layer checkpoint of the 8B config
   written to a temporary directory and a second over the same weights
   file (a hard link) with another RoPE base, a request naming the second
   swaps it in and one naming the first swaps it back (each load's
   seconds and ``torch.cuda.memory_allocated``). Then in f32 at 2 layers
   the hit request's greedy stream against a cold Generator's.
12. KV movement (``phase_kv_movement``, after 11): page-block round trips,
   the spill tier against reserve admission and the discard path, a cold
   slot, the prefix store.
13. layer-wise KV sharing and replicas (``phase_share_and_replicas``, after
   12, on phase 4's model and phase 6's geometry): a share map calibrated
   by ``cli/kv_share_calibrate.calibrate_model`` (8 pairs: 32 layers in 24
   groups; random weights, so it measures the mechanism, not quality); the
   pool's bytes unshared, under the identity map and under the map
   (``torch.cuda.memory_allocated`` and ``kv_share_stats()``); phase 6's
   greedy request under the identity map bit-identical to the unshared
   engine's; kernel 2 over a group buffer and kernel 1's chunk over a view
   gathered from it (bf16 and int8) against their plain versions; one
   captured decode block under the map (bf16 and int8) checked bitwise
   against a snapshot of the pool: nothing changed but the rows the owners
   wrote, each row a non-owner wrote holding its owner's bytes again, and
   the replay equal to the eager block; a block exported under the map
   imported bit-identically under it and refused by an unshared pool. Then
   ``--concurrent 8 --paged-pool 16 --replicas 2`` through
   ``build_generator`` behind the server: card memory after the load (one
   copy of the weights) and the weight store's trees and refs; phase 6's
   streamed requests at once (tok/s against phase 6's single batcher,
   TTFTs, routes per replica; replica 0 captures two prefill graphs again
   while replica 1 replays, and no dispatch fails); ``replica.dispatch``
   armed on replica 1 (its breaker opens, replica 0 serves every request,
   a probe closes it again); four long greedy streams, then the same four
   with ``POST /admin/drain`` of replica 0 while they decode: each
   migrates with its block, every stream equals its undrained run, the
   drain's seconds and block bytes, the refs back to 1 and card memory
   lower after it.
14. disaggregated serving and the fleet controller (``phase_disagg``,
   after 13, on phase 4's model and phase 6's geometry): ``--concurrent 8
   --paged-pool 16 --disagg --autoscale --autoscale-interval 0.5
   --autoscale-cooldown 0`` through ``build_generator`` behind the server,
   one prefill and one decode replica over one copy of the weights (card
   memory, the weight store's trees and refs); with the controllers
   stopped through ``POST /admin/autoscaler``, phase 6's streamed mix
   (tok/s against phase 6's batcher and phase 13's replicas, TTFTs, every
   request handed off with its block: handoffs, bytes, the handoff's ms
   p50/p99, ``handoffs_out`` and ``migrations_in``, kernels 1 and 2
   launched); phase 6's unforced greedy request equal to its run there,
   again with ``disagg.handoff`` armed (served in place, equal) and with
   ``cache.export`` armed (blockless, its full length); a prefill storm
   (long prompts at max_tokens 1-2 for longer than the 5 s sustain) with
   the controllers running: the prefill pool's spawns one replica
   (``last_spawn_s``, the memory it added, 3 refs) and the decode pool's
   none; ``drain_one()`` on the prefill controller gives the spawn's pool
   and graph pool back; the decode pool's ladder at levels 1, 2 and 3
   (its replica's level, not the prefill replica's), a request capped to
   96 tokens with both headers, ``mst_brownout_level`` and the
   ``brownout_level_*`` events in ``/metrics``.
15. pipeline parallelism on one card (``phase_pipeline``, after 14, on
   phase 4's model; every stage on ``cuda:0``): the fused engine's single
   stream at pp = 1 and, built by ``build_generator(num_stages=2)`` (the
   server's ``--num-stages 2``), split 0-16 / 16-32: 64 greedy tokens after
   a 600-token prompt each, token-identical, the card memory the pp = 2
   engine adds against its caches and graph pool (no second copy of the
   weights), one streamed HTTP completion through ``ModelProvider`` over
   it, and the device ms of each stage's layers in one decode step; the
   chained pipeline over the same tensors, split 0-20 / 20-32, against the
   pp = 1 ``Generator``; the batcher over a pool on the ``gather`` path at
   pp = 1 and pp = 2, a subset of phase 6's mix, token-identical, tok/s
   and the ticks' host ms against their harvest wait; the engine and the
   chain again with each stage's share of a step a graph of its own (what
   stages on distinct cards take), each token-identical. Then the mix at
   pp = 2 with KV movement (``pipe_movement``: one batcher over 7 pages
   with overcommit, the spill tier, a cold slot and the prefix store, the
   600-token request repeated once it has ended: a preemption spill, a
   cold spill and a store host hit, each a block of both stages), as two
   replicas with shared weights and a drain of replica 0 in the middle,
   and as a disagg pair (``pipe_fleet``, both through
   ``build_generator(num_stages=2)``): every stream equal to the gather
   batcher's, the movement counters > 0, the fleets' card memory their
   pools and graphs (one resident tree). After phase 5 the
   packed model at pp = 1 and pp = 2 (32 greedy tokens, kernels 3 and 4),
   and in phase 9 DeepSeek-Coder-V2-Lite bf16 at pp = 1 and split 0-14 /
   14-27 (32 tokens; kernel 1's MLA build and its T=1 route). Each run's
   launches are counted from zero and checked against its chunks and steps.
16. the pod over its in-process transport (``phase_pod``, after 15, on
   phase 4's model): two ``LoopbackHub`` hosts in this process over one
   resident copy of the weights, each running its heartbeat loop. Host 0
   a disagg coordinator with a prefix store, its decode pool priced as
   saturated; host 1 a paged batcher (the ragged path, kernel 2) with a
   store of its own. Three greedy requests handed off across the hosts
   (bytes on the wire, the first relayed token's ms), a prefix served on
   host 0 and continued on host 1 through one federated fetch of host 0's
   block, and host 1 going silent after 2 relayed tokens, host 0 finishing
   the stream (``relay_timeout``): every stream equal to a monolithic
   batcher's (the drained one to its stream of the request with the
   delivered tokens folded into the prompt, which the resume prefills
   again), the fallbacks ``{}`` but the death's.
17. the mesh axes in one process (``phase_mesh``, after 16, on phase 4's
   model; every shard on ``cuda:0``): the fused engine's single stream and
   the gather batcher at tp = 1 and 2 (the weights held once, two
   reductions a layer, bf16 streams held to the near-tie rule), the
   server's ``--tp 2 --concurrent 4``; over tp = 2 engines, against the tp
   = 2 batcher's streams, KV movement (``pipe_movement``, each block with
   every KV head), two replicas with a drain and a disagg pair
   (``pipe_fleet`` through ``build_generator(tp=2)``, one resident tree),
   n-gram speculation (``mesh_ngram``, phase 6's rule); sequence
   parallelism over two sp shards; f32 at 4 layers (tp = 2 and sp = 2
   token-identical to tp = 1, and blocks moved between tp = 1 and tp = 2
   pools, ``mesh_cross_tp``). After phase 5 the packed 8B at tp = 1 and 2
   and as two tp = 2 replicas against one packed tp = 2 batcher
   (``mesh_packed_fleet``, kernels 3 and 4 at the shard shapes); in phases
   8-9 Mixtral at tp = 2 and the Lite at tp = 2 and ep = 2.

Phase 6's parity runs take the model's first ``BATCH_PARITY_LAYERS``
layers, the eager turn of phases 4-5's step timing an
``EAGER_STREAM_TOKENS``-token stream, and the Generators of phases 8-9
capture only the decode block they serve (greedy, no logprobs; the warm-up
request captures it), the prefill graphs at load. Their batchers, phase
11's traced batcher and phase 12's store batcher capture only that decode
block too (``GREEDY_ONLY``), phases 6 and 10's no sampled block without
logprobs (``MIX_BLOCKS``), and phases 4-5's speculating generators only
their greedy rounds. DeepSeek-V2 is served at
a capacity of 768 (its prompt and tokens need 3 chunks: each of its
prefill graphs takes seconds to capture), and phases 4-5's speculating
generators verify on the served Generator, whose prefill and decode graphs
are captured already. Phases 4-5's served Generators decode in blocks of
``MAIN_DECODE_BLOCK`` and capture the main prompt's prefill chunks alone,
phase 15's single streams in blocks of ``PIPE_DECODE_BLOCK``, phase 17's
in blocks of ``MESH_DECODE_BLOCK`` and its fleets of
``MESH_FLEET_DECODE_BLOCK`` (a capture runs its block's steps eagerly
first).

``--kernels-only`` stops after phase 2 (a short first check of a new
kernel) and prints no result line.

The last three lines are the kernel JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import dataclasses
import functools
import gc
import glob
import http.client
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from typing import Optional

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
# The published meta-llama/Llama-3.2-1B config.json: the draft model of the
# draft-model speculation run (random bf16 weights from the seed)
LLAMA_32_1B = {
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 2048,
    "intermediate_size": 8192,
    "num_hidden_layers": 16,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 64,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "rope_scaling": {
        "factor": 32.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    "max_position_embeddings": 131072,
    "tie_word_embeddings": True,
}
MAX_SEQ = 4096
CHUNK = 256
# chunk offsets of the main path's 600-token prompt
MAIN_PATH_OFFSETS = (0, 256, 512)
MAIN_PROMPT = 600
# phases 4-5's served Generators (and their step timing's) decode in blocks
# of 8: a block's capture runs its steps eagerly first, and they capture the
# prefill chunks of the main path's prompt alone (its served requests' are
# no longer)
MAIN_DECODE_BLOCK = 8
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
# more tokens: all but the shortest then decode past the pages they were
# admitted with, so growth outruns the pool and preempts (the mix's own
# 32-96 tokens rarely cross a 256-token page, and an overcommit pool only
# preempts as it grows)
OVERCOMMIT_EXTRA_TOKENS = 128
# phase 6's engines (and phases 10 and 14's, on its geometry) stop at 2048
# positions: the mix's longest request (1500 + 64, and the overcommit run's
# 128 more) and phase 14's storm prompts fit, and a batcher captures 8
# prefill graphs, not 16
BATCH_MAX_SEQ = 2048
# one more request of every mix, unforced greedy and sent second (after the
# seeded twin: the older, the later it is preempted), its tokens read from
# the batcher: it crosses a page edge as it decodes, and under speculation
# its tokens are held against its run with draft="off" on the same pool
GREEDY_PROMPT = 240
GREEDY_TOKENS = 96
# the parity runs (graphs / eager, sync / async, overcommit / reserve) over
# the same pool: five greedy prompts and a seeded top-p one, 128 tokens
# each; prompts close under a page edge grow while the pool is full, so the
# overcommit run preempts (the seeded request, after 57 tokens). Their
# engines stop at 1280 positions: 5 prefill graphs each, not 16
PARITY_PROMPTS = (200, 230, 480, 700, 1000, 450)
PARITY_TOKENS = 128
PARITY_MAX_SEQ = 1280
# the eager pass of those runs: the first three greedy requests, 48 tokens
PARITY_EAGER_JOBS = 3
PARITY_EAGER_TOKENS = 48
# the parity runs hold the batcher's paths to each other (graphs, eager,
# sync, overcommit; the prefix cache off and on), which the depth does not
# change: they run on the model's first layers, its tensors shared
BATCH_PARITY_LAYERS = 4
# phases 4-5's eager turn (``phase_step_timing``): its greedy stream, held
# to the graph turns' first tokens, and its seeded sample (an eager step
# costs ~80-100 ms of host)
EAGER_STREAM_TOKENS = 16
EAGER_SAMPLE_TOKENS = 12
# prefix sharing's parity run: four prompts of a shared 512-token prefix (two
# pages) and their own 100 tokens
PREFIX_TOKENS = 512
PREFIX_SUFFIX = 100
# the T=1 route's check at the 8B shapes (the first decode position, one
# inside the main path's streams and the last), and its timing
DECODE_POSITIONS = (0, 600, 4095)
DECODE_TIMING_POSITIONS = (600, 700, 4095)
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


# speculation (phases 4-6 and the f32 check): tokens per run, the draft
# model's window, the verify widths timed, and the near-tie limit: at full
# depth in bf16 a speculating stream may leave plain greedy decode only where
# the plain run's top two log-probabilities lie within this many nats, and
# only for a token within it of the plain run's best (the T=K verify and the
# T=1 step sum in other orders, and their bf16 logits can reorder candidates
# tied or a rounding step apart: 1/32 between 4 and 8, 1/16 between 8 and
# 16). Each plain run prints the share of its positions at or under the
# limit, and at a few other limits
SPEC_TOKENS = 64
SPEC_K = 4
VERIFY_KS = (2, 4, 8)
NEAR_TIE_GAP = 0.0625
GAP_READINGS = (0.03125, 0.0625, 0.125, 0.25)
# the f32 check: 8B widths at this depth, 64 tokens, every speculating path
# token-identical to plain greedy; and the self-draft at full depth
F32_LAYERS = 2
F32_TOKENS = 64
F32_MAX_SEQ = 1024
# the packed GEMV's and matmul's extra M: the single-stream verify's K and
# the batcher verify's 8 slots x K rows
VERIFY_GEMV_M = (2, 4)
VERIFY_MATMUL_M = (16, 32, 64)


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
            if any(k in line for k in ("registers", "smem", "spill", "cached", "Compiling",
                                       "part ")):
                log(f"[kernels]   ptxas: {line.strip()}")
    for (dk, dv), options in [*((d, False) for d in FLASH_DIMS), ((256, 256), True),
                              (fa.MLA_HEAD_DIMS, False)]:
        info = fa.kernel_info(dk, dv, options)
        log(f"[kernels] flash bf16 Dk={dk} Dv={dv}{' with softcap and window' if options else ''}"
            f"{' (MLA: v from k, 4 blocks of 128 value columns)' if dk == 576 else ''}: "
            f"shared memory per block {info['shared_bytes']} bytes, {info['registers']} registers, "
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
        for mla in (False, True):
            info = pa.kernel_info(pool_dtype, 128, 128, mla=mla)
            what = "values_from_k, Dk 576, Dv 512 in items of 128" if mla else "D=128"
            log(f"[kernels] paged_attention bf16 q, {str(pool_dtype)[6:]} pool, {what}: shared "
                f"memory per block {info['shared_bytes']} bytes, {info['registers']} registers, "
                f"{info['blocks_per_sm']} resident blocks per SM, {info['local_bytes']} local "
                f"(spill) bytes per thread")


def phase_quant_kernels(seed: int) -> dict:
    """Both packed-weight kernels against the plain version: at the five
    Llama-3.1-8B shapes (the GEMV at M = 1 and 8, and 2 and 4 for the
    single-stream verify; the matmul at M = 88 and 256, and 16, 32 and 64
    for the batcher verify), bit for bit on integer-valued operands and within limits on random
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
                              ("quant_matmul", PREFILL_M),
                              *(("quant_gemv", m) for m in VERIFY_GEMV_M),
                              *(("quant_matmul", m) for m in VERIFY_MATMUL_M)):
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


def decode_case(gen, b, position, s=MAX_SEQ, dtype=torch.bfloat16):
    """The T=1 route's operands at Llama-3.1-8B's attention: q (B, 1, 32,
    128), one layer of a dense (L, B, S, 8, 128) cache, the (1,) device
    position and its lengths."""
    from mlx_sharding_tpu_torch.ops.flash_attention import decode_lengths

    q, k, v = attention_inputs(gen, b, 1, s, 32, 8, 128, 128, dtype)
    pos = torch.tensor([position], dtype=torch.int64, device="cuda")
    return q, k, v, pos, decode_lengths(pos, b, s)


def phase_decode_kernels(seed: int) -> float:
    """The T=1 route (the paged kernel over the dense cache seen as pages)
    against its plain version at the 8B shapes, at ``DECODE_POSITIONS``
    with one and two rows, and f32 at a short capacity; two runs
    bit-identical; one call captured in a CUDA graph is one kernel node;
    and a captured call replayed after its device position moved gives the
    call at the new position, bit for bit. Returns the largest error at
    the 8B shapes."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    scale = 128 ** -0.5
    main_err = 0.0
    cases = [(b, p, MAX_SEQ, torch.bfloat16) for p in DECODE_POSITIONS for b in (1, 2)]
    cases += [(2, p, 256, torch.float32) for p in (0, 63, 64, 255)]
    for b, position, s, dtype in cases:
        q, k, v, pos, lengths = decode_case(gen, b, position, s, dtype)
        got = fa.flash_decode(q, k, v, pos, scale, lengths=lengths)
        ref = fa.flash_decode_reference(q, k, v, lengths, scale)
        torch.cuda.synchronize()
        err, worst, rel_l2 = kernel_disagreement(got, ref)
        log(f"[kernels] flash_decode B={b} S={s} Hq=32 Hkv=8 D=128 {str(dtype)[6:]} position "
            f"{position}: max_abs_err {err:.3e}, rms(ref) "
            f"{ref.float().pow(2).mean().sqrt().item():.3e}, worst err/limit {worst:.3f} (tol 1), "
            f"relative L2 {rel_l2:.3e} (tol {REL_L2_TOL})")
        check(worst <= 1 and rel_l2 <= REL_L2_TOL,
              f"flash_decode B={b} position {position} disagrees with its plain version")
        if s == MAX_SEQ and b == 1:
            main_err = max(main_err, err)
    q, k, v, pos, lengths = decode_case(gen, 1, DECODE_POSITIONS[-1])
    runs = [fa.flash_decode(q, k, v, pos, scale, lengths=lengths) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(*runs), "flash_decode: two runs differ")
    nodes = graph_nodes(lambda: fa.flash_decode(q, k, v, pos, scale, lengths=lengths))
    log(f"[kernels] flash_decode 8B shapes, position {DECODE_POSITIONS[-1]}: two runs "
        f"bit-identical; one call enqueues {nodes}")
    check(nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0},
          "flash_decode: one call is not one kernel launch")
    # the position is read on the device: a call captured at 600 and
    # replayed at 4095 is the call at 4095
    pos.fill_(DECODE_POSITIONS[1])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fa.flash_decode(q, k, v, pos, scale)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fa.flash_decode(q, k, v, pos, scale)
    pos.fill_(DECODE_POSITIONS[-1])
    graph.replay()
    want = fa.flash_decode(q, k, v, pos, scale)
    torch.cuda.synchronize()
    log(f"[kernels] flash_decode captured at position {DECODE_POSITIONS[1]}, replayed at "
        f"{DECODE_POSITIONS[-1]}: bit-identical to the call there {torch.equal(out, want)}")
    check(torch.equal(out, want), "flash_decode: a replay does not read the device position")
    del graph
    return main_err


def decode_work(q, k, v, position):
    """FLOPs and bytes of the T=1 route at ``position``: q and the output
    once, the prefix's K/V rows once, the table entries of its pages and
    the lengths."""
    from mlx_sharding_tpu_torch.ops.flash_attention import DECODE_PAGE

    b, _, hq, dk = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    rows = min(k.shape[1], position + 1)
    el = q.element_size()
    nbytes = (el * b * hq * (dk + dv) + el * b * rows * hkv * (dk + dv)
              + 4 * b * (-(-rows // DECODE_PAGE) + 1))
    return 2 * b * hq * (dk + dv) * rows, nbytes


def phase_decode_timing(seed: int) -> list:
    """Device times of the T=1 route at Llama-3.1-8B's attention (B 1,
    Hq 32, Hkv 8, D 128, bf16, capacity 4096) at ``DECODE_TIMING_POSITIONS``:
    the kernel, its plain version, the plain path the captured step ran
    before (``masked_attention`` over the whole capacity) and SDPA over the
    prefix with ``enable_gqa``, beside the bound. Returns one row per
    position; the kernel record takes the first."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops.attention import masked_attention

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    scale = 128 ** -0.5
    rows = []
    for position in DECODE_TIMING_POSITIONS:
        q, k, v, pos, lengths = decode_case(gen, 1, position)
        kern = time_ms(lambda: fa.flash_decode(q, k, v, pos, scale, lengths=lengths))
        plain = time_ms(lambda: fa.flash_decode_reference(q, k, v, lengths, scale))
        masked = time_ms(lambda: masked_attention(q, k, v, pos, scale))
        lib_fn = sdpa_call(q, k, v, position, scale)
        lib = time_ms(lib_fn)
        ref = fa.flash_decode_reference(q, k, v, lengths, scale)
        for name, out in (("SDPA over the prefix", lib_fn()),
                          ("masked_attention", masked_attention(q, k, v, pos, scale))):
            _, worst, rel_l2 = kernel_disagreement(out, ref)
            check(worst <= 1 and rel_l2 <= REL_L2_TOL, f"{name} disagrees with the plain version")
        flops, nbytes = decode_work(q, k, v, position)
        ops_ms, bytes_ms = flops / PEAK_FLOPS[q.dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        rows.append(dict(position=position, ms=kern, plain_ms=plain, masked_ms=masked,
                         library_ms=lib, bound_ms=bound, ops_ms=ops_ms, bytes_ms=bytes_ms))
        log(f"[timing] flash_decode B=1 S={MAX_SEQ} Hq=32 Hkv=8 D=128 bf16 position {position}: "
            f"kernel {kern:.4f} ms, plain version {plain:.4f} ms, masked_attention over the "
            f"capacity {masked:.4f} ms, sdpa over the prefix {lib:.4f} ms, bound {bound:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'}; {flops / 1e6:.2f} MFLOP, "
            f"{nbytes / 1e6:.3f} MB), {nbytes / 1e6 / kern:.0f} GB/s, {bound / kern:.1%} of the "
            f"bound; 32 layers: kernel {32 * kern:.3f} ms against masked {32 * masked:.3f} ms")
    return rows


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
    shapes (the GEMV at M = 1, 2, 4 and 8, the matmul at M = 16, 32, 64, 88
    and 256), beside their
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
        for m in (1, 2, 4, 8, *VERIFY_MATMUL_M, TAIL_M, PREFILL_M):
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


def quant_record(rows, kernel, launches, max_err, tp2_rows=()):
    """The kernels-line entry of a packed-weight kernel: per-launch means as
    the main path weighs them. The GEMV: a decode step's 129 launches at
    M = 1 (32 of each layer shape and the head), and beside them the same
    mean at M = 8 (``ms_m8``, ``library_ms_m8``) and at the single-stream
    verify's M = 2 and 4; the matmul: a prefill chunk's four layer shapes at
    M = 256, equally, and beside them the same mean at the 600-token
    prompt's last chunk, M = 88 (``ms_m88``, ``dense_ms_m88``), and at the
    batcher verify's M = 16, 32 and 64."""

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
        m, extra = 1, {"ms_m8": mean("ms", 8), "library_ms_m8": mean("library_ms", 8),
                       **{f"ms_m{k}": mean("ms", k) for k in VERIFY_GEMV_M}}
    else:
        m = PREFILL_M
        extra = {"ms_m88": mean("ms", TAIL_M), "dense_ms_m88": mean("dense_ms", TAIL_M),
                 **{f"ms_m{k}": mean("ms", k) for k in VERIFY_MATMUL_M}}
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
        # phase 17's points: each tp = 2 shard shape of the 8B (M = 1 for
        # the GEMV, 256 for the matmul)
        "tp2_points": [{k: r[k] for k in ("name", "m", "out", "inp", "ms", "plain_ms",
                                          "bound_ms")}
                       for r in tp2_rows if r["kernel"] == kernel],
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
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops.attention import flash_decode_on
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
    gen = Generator(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK, decode_block=MAIN_DECODE_BLOCK)
    graph_line("[main]", gen.warm_up(prefill_upto=MAIN_PROMPT))
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
    blocks = lambda n: -(-(n - 1) // MAIN_DECODE_BLOCK)  # noqa: E731  (after the first token)
    stats = {}
    try:
        # warm-up outside the counted run: cuBLAS handles, the kernel library
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"warm-up request failed: {status}")
        fa.flash_attention.launches = fa.flash_decode.launches = 0
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
        launches = {"flash_attention": fa.flash_attention.launches,
                    "flash_decode": fa.flash_decode.launches}
        expected = cfg.num_hidden_layers * expected_chunks
        log(f"[main] flash_attention launches {launches['flash_attention']}, expected "
            f"{cfg.num_hidden_layers} layers x {expected_chunks} chunks = {expected}")
        check(launches["flash_attention"] == expected,
              "flash launch count disagrees with the chunk count")
        route = flash_decode_on()
        expected = cfg.num_hidden_layers * MAIN_DECODE_BLOCK * expected_blocks if route else 0
        log(f"[main] T=1 route {'on' if route else 'off'} (MST_FLASH_DECODE); flash_decode "
            f"launches {launches['flash_decode']}, expected {expected} ({cfg.num_hidden_layers} "
            f"layers x {MAIN_DECODE_BLOCK * expected_blocks} decode steps)")
        check(launches["flash_decode"] == expected,
              "flash_decode launch count disagrees with the decode steps")
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
    stats["routes"] = phase_decode_routes(model, gen, "[main]", prompt)
    stats["spec"] = phase_speculation(model, gen, "[spec]", seed)
    del gen
    return launches, stats, model


class decode_route:
    """Within the block, ``MST_FLASH_DECODE`` is "1" (``on``) or "0": the T=1
    route the steps captured or run there take."""

    def __init__(self, on: bool):
        self.value = "1" if on else "0"

    def __enter__(self):
        self.saved = os.environ.get("MST_FLASH_DECODE")
        os.environ["MST_FLASH_DECODE"] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("MST_FLASH_DECODE", None)
        else:
            os.environ["MST_FLASH_DECODE"] = self.saved


def phase_decode_routes(model, gen, tag: str, prompt: np.ndarray) -> list:
    """The single-stream decode on each T=1 route, in one process, turns in
    the order kernel, plain, plain, kernel: ``gen`` (the served Generator)
    when the route is on by default, and a Generator of the same model
    whose graphs are captured with the other route. Each turn: a greedy
    64-token stream's decode tok/s and one decode step's device ms (blocks
    of the Generator's, ``step_numbers``), with the T=1 route's launches
    checked (32 a step on the kernel route, none on the plain one). Then the last
    position's logits of one T=1 step on each route, eagerly from the same
    cache, within ``LOGITS_RTOL`` of each other."""
    from mlx_sharding_tpu_torch.generate import REPETITION_WINDOW, Generator
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops.attention import flash_decode_on

    layers, block = model.config.num_hidden_layers, gen.decode_block
    default_on = flash_decode_on()
    ids = prompt[0].tolist()
    t_other = time.perf_counter()
    with decode_route(not default_on):
        other = Generator(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK, decode_block=block)
        stream_tokens(other, ids, max_tokens=64)  # captures the graphs the turns replay
    gens = {default_on: gen, not default_on: other}
    rows, streams = [], []
    log(f"[time] {tag} T=1 routes, the other route's Generator: "
        f"{time.perf_counter() - t_other:.1f} s")
    for on in (True, False, False, True):
        g, name = gens[on], "kernel" if on else "plain"
        with decode_route(on):
            marks = [time.perf_counter()]
            fa.flash_decode.launches = 0
            toks, tok_s = stream_tokens(g, ids, max_tokens=64)
            stream_launches = fa.flash_decode.launches
            list(g.generate_step(ids, max_tokens=1))
            marks.append(time.perf_counter())
            fa.flash_decode.launches = 0
            step = step_numbers(
                lambda g=g: g.run_block(block, REPETITION_WINDOW, False, False),
                calls=2, steps=block, profiled=1)
            step_launches = fa.flash_decode.launches
            marks.append(time.perf_counter())
            log(f"[time] {tag} T=1 routes, {name} turn: stream, decode step "
                + " / ".join(f"{b - a:.1f}" for a, b in zip(marks, marks[1:])) + " s")
        streams.append(toks)
        # the stream's 63 tokens after the first in whole blocks; the step's
        # four calls of a block (``step_numbers``)
        steps = (block * -(-63 // block), 4 * block)
        want = (layers * steps[0], layers * steps[1]) if on else (0, 0)
        check((stream_launches, step_launches) == want,
              f"{tag} {name} route: flash_decode launches {stream_launches}, {step_launches}, "
              f"want {want}")
        rows.append({"route": name, "decode_tok_s": tok_s, **step})
        log(f"{tag} T=1 {name} route: greedy 64-token stream {tok_s:.2f} tok/s; decode step "
            f"host {step['host_ms']:.3f} ms, wall {step['wall_ms']:.3f} ms, device "
            f"{step['device_ms']:.3f} ms; flash_decode launches {stream_launches} (stream) and "
            f"{step_launches} (4 blocks of {block}); "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in step["kernels"]))
    same = [next((j for j, (a, b) in enumerate(zip(streams[0], s)) if a != b), len(s))
            for s in streams[1:]]
    log(f"{tag} T=1 routes: the streams agree with the first turn's for {same} of 64 tokens")
    del gens[not default_on], other
    t_logits = time.perf_counter()
    eager = Generator(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK, cuda_graphs=False)
    first = eager.run_prefill(prompt).argmax(-1)
    logits = {}
    for on in (True, False):
        with decode_route(on):
            out, _ = model(first[:, None], eager.cache)
        logits[on] = out[0, -1].float()
    check(bool(torch.isfinite(logits[True]).all()), f"{tag} T=1 route logits not finite")
    rel = ((logits[True] - logits[False]).norm() / logits[False].norm()).item()
    log(f"{tag} last-position logits of a T=1 step at position {prompt.shape[1]}, kernel route "
        f"vs plain route over {layers} layers: relative L2 {rel:.3e} (tol {LOGITS_RTOL}), same "
        f"argmax {bool(logits[True].argmax() == logits[False].argmax())}")
    check(rel <= LOGITS_RTOL, f"{tag} the T=1 kernel route disagrees with the plain route")
    del eager
    log(f"[time] {tag} T=1 routes, the logits check: {time.perf_counter() - t_logits:.1f} s")
    return rows


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
    the window's wall ms (profiled, so the host is slower than without).
    The profile's raw device events are summed by name: ``key_averages()``
    first builds a Python record of every event, CPU ops included (2 s for
    a graph decode block of the 8B, 11 s for an eager one, on the H100)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) / 1e6
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
    order graph, eager, graph (one eager turn): ``gen`` (the served Generator, its
    graphs captured) and a Generator of the same model that runs the same
    steps eagerly. Each turn: the ``run_prefill`` median of the prompt, one
    greedy 64-token stream (``EAGER_STREAM_TOKENS`` on the eager turn; its
    decode tok/s), one decode step (blocks of the Generator's greedy steps) and one
    256-token prefill chunk (at offset 256): host ms, wall ms, the device's
    busy share and the kernels by device time. The streams' first
    ``EAGER_STREAM_TOKENS`` tokens must be token-identical both ways, and a
    seeded top-p sample too."""
    from mlx_sharding_tpu_torch.generate import REPETITION_WINDOW, Generator

    block = gen.decode_block
    gens = {"graph": gen,
            "eager": Generator(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK, decode_block=block,
                               cuda_graphs=False)}
    ids = prompt[0].tolist()
    seeded = dict(temperature=0.8, top_p=0.9, seed=1234)
    rows, streams = [], {}
    for mode in ("graph", "eager", "graph"):
        g = gens[mode]
        eager = mode == "eager"
        row = {"mode": mode}
        marks = [time.perf_counter()]
        row["prefill_ms"], _ = prefill_median_ms(lambda g=g: g.run_prefill(prompt), runs=3)
        marks.append(time.perf_counter())
        toks, row["decode_tok_s"] = stream_tokens(
            g, ids, max_tokens=EAGER_STREAM_TOKENS if eager else 64)
        sampled, _ = stream_tokens(g, ids[:300], max_tokens=EAGER_SAMPLE_TOKENS, **seeded)
        streams.setdefault(mode, []).append((toks[:EAGER_STREAM_TOKENS], sampled))
        list(g.generate_step(ids, max_tokens=1))  # the state of a request at its first token
        marks.append(time.perf_counter())
        row["decode"] = step_numbers(
            lambda g=g: g.run_block(block, REPETITION_WINDOW, False, False),
            calls=1 if eager else 2, steps=block, profiled=1)
        marks.append(time.perf_counter())
        row["prefill_chunk"] = step_numbers(lambda g=g: g.run_chunk(CHUNK), calls=4, steps=1,
                                            profiled=2)
        marks.append(time.perf_counter())
        log(f"[time] {tag} step timing, {mode} turn: prefill median, streams, decode step, "
            f"prefill chunk " + " / ".join(f"{b - a:.1f}" for a, b in zip(marks, marks[1:]))
            + " s")
        for what in ("decode", "prefill_chunk"):
            r = row[what]
            busy = "not measured" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
            log(f"{tag} {mode} {what.replace('_', ' ')}: host {r['host_ms']:.3f} ms, wall "
                f"{r['wall_ms']:.3f} ms, device {r['device_ms']:.3f} ms per step; device busy "
                f"{busy} of the wall ({100 * r['profiled_busy']:.1f}% under the profiler); "
                + ", ".join(f"{n} {ms:.3f}" for n, ms in r["kernels"]))
        log(f"{tag} {mode}: run_prefill median {row['prefill_ms']:.2f} ms, greedy "
            f"{EAGER_STREAM_TOKENS if eager else 64}-token stream {row['decode_tok_s']:.2f} tok/s")
        rows.append(row)
    check(all(run == streams["eager"][0] for runs in streams.values() for run in runs),
          "the graph path's streams differ from the eager steps'")
    log(f"{tag} greedy 600-token-prompt streams (their first {EAGER_STREAM_TOKENS} tokens) and "
        f"a seeded top-p {EAGER_SAMPLE_TOKENS}-token sample: token-identical through graphs and "
        f"eagerly on the card, twice each")
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


def first_layers(model, layers: int):
    """``model`` cut to its first ``layers`` decoder layers, sharing every
    tensor with it (the embedding, the final norm and the head too): no
    weight is copied."""
    cut = copy.copy(model)
    cut._modules = dict(model._modules)  # nn.Module's children, not shared with the model
    cut._modules["layers"] = torch.nn.ModuleList(list(model.layers)[:layers])
    cut.config = dataclasses.replace(model.config, num_hidden_layers=layers, end_layer=layers)
    cut.__dict__.pop("_graph_pool", None)  # its captured steps get a pool of their own
    return cut


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
    inputs = engine.device_inputs(("decode", 1), table, [True] * m, cache.offsets, True)
    plan = engine.device_plan(inputs.offsets.long(), inputs, 1)
    tokens = torch.tensor(first, dtype=torch.int64, device=model.device)[:, None]
    return first, engine.decode_logits(tokens, cache, plan, 0).float()


def tick_line(tag: str, batcher) -> None:
    t = batcher.tick_timing_stats()
    log(f"{tag} ticks: {t['path']}, {t['ticks']} harvests, harvest blocked "
        f"{t['device_blocked_ms_avg']:.3f} ms and host {t['host_ms_avg']:.3f} ms per tick "
        f"(means); {batcher.preemptions} preemptions, {batcher.reprefill_tokens} tokens "
        f"re-prefilled; {batcher.async_reason}")


def phase_batching(model, seed: int, kv_dtype: str, single_stream_tok_s: float,
                   draft: str = "off", async_sched: str = "auto", split: bool = False,
                   reference=None, pool: Optional[int] = POOL_PAGES,
                   paged_attention: str = "auto", draft_model=None,
                   parity: bool = True) -> tuple:
    """Continuous batching at full width: the port's server in front of a
    ``ContinuousBatcher`` of ``SLOTS`` slots over ``pool`` pages of
    ``PAGE`` tokens (``kv_dtype`` pool, decode attention ``paged_attention``)
    or, with ``pool`` None, over dense slot caches; async ticks; the int8
    pool's run admits on overcommit and preempts. With ``draft="ngram"``
    the batcher speculates (``async_sched`` ticks), its verify rounds are
    replays too, and the run ends with its ``spec_stats()`` (and, with
    ``split``, the verify's device ms and its split) instead of the parity
    runs; its seeded twin is not held to its run alone (a round's width,
    and so its draws, follow the other slots), but its unforced greedy
    request is held to ``reference``, the same request's tokens, near-ties
    and preemptions from the run with draft="off" (``agreement``, up to
    the first preemption of either). ``draft_model``: speculation with a
    draft engine of that model (``SPEC_K`` tokens a round; sync ticks as
    ``auto`` resolves them), its prefill chunks, proposals and replays
    replays of its own graphs too; its seeded twin asks for logprobs, so
    while it is live the ticks fall back to plain blocks replayed into the
    draft. ``parity``: the parity runs and the first step's logits after a
    run with draft="off". Returns the launches of the counted run per
    attention kernel and the numbers (``stats["greedy"]``: that request's
    tokens, near-ties and preemptions)."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, make_server

    cfg = model.config
    overcommit = kv_dtype == "int8"
    if draft_model is not None:
        draft = "engine"
    mix = (tuple((n, m + OVERCOMMIT_EXTRA_TOKENS) for n, m in BATCH_MIX) if overcommit
           else BATCH_MIX)
    layout = (f"{kv_dtype}{'-gather' if paged_attention == 'gather' else ''}" if pool
              else "dense")
    tag = (f"[batch-{layout}{'-' + draft if draft != 'off' else ''}"
           f"{'-sync' if async_sched == 'off' else ''}]")
    gc.collect()  # the earlier phases' servers: their handler classes sit in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"{tag} torch.cuda.memory_allocated at the start {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    engine = PipelineEngine(model, microbatches=SLOTS, max_seq=BATCH_MAX_SEQ,
                            prefill_chunk=CHUNK, pool_pages=pool,
                            page_size=PAGE if pool else None,
                            paged_attention=paged_attention,
                            kv_dtype=kv_dtype if pool else None, device=model.device)
    draft_engine = None
    if draft_model is not None:
        draft_engine = PipelineEngine(draft_model, microbatches=SLOTS, max_seq=BATCH_MAX_SEQ,
                                      prefill_chunk=CHUNK, device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8, overcommit=overcommit, draft=draft,
                                async_sched=async_sched, draft_engine=draft_engine,
                                spec_k=SPEC_K)
    kv = (f"pool {pool} pages of {PAGE} tokens, {engine.decode_path} decode attention" if pool
          else f"dense slot caches of {BATCH_MAX_SEQ} positions")
    log(f"{tag} engine: {SLOTS} slots, {kv} ({batcher.cache.nbytes / 1e6:.1f} MB of "
        f"{kv_dtype if pool else 'bf16'} K/V), {'overcommit' if overcommit else 'reserve'} "
        f"admission, {batcher.async_reason}"
        + (f"; draft engine of {draft_model.config.num_hidden_layers} layers, "
           f"{batcher.dcache.nbytes / 1e6:.1f} MB of K/V, K = {SPEC_K}" if draft_engine else ""))
    captured = batcher.warm_up(**MIX_BLOCKS)
    graph_line(tag, captured)
    tok = ByteTokenizer()
    server = make_server(ModelProvider(batcher, tok, model_name="llama-3.1-8b-cb"), "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    force_a = {"65": 100.0}
    # under n-gram speculation the streamed requests are forced to ``CYCLE``
    # and their prompts end with it, so that their n-gram proposals match
    cycle = draft == "ngram"
    force = {"logit_bias": force_a} if not cycle else {
        **FORCE_CYCLE, "logit_bias": {str(k): v for k, v in FORCE_CYCLE["logit_bias"].items()}}
    expected_text = (lambda n: "A" * n) if not cycle else forced_text
    # the seeded twins are not streamed: their logprobs carry the token ids
    # (random weights sample ids past the 256 bytes, which decode to nothing)
    seeded = {"temperature": 0.8, "top_p": 0.9, "seed": 4321, "logprobs": 1}
    jobs = []
    for i, (n, max_tokens) in enumerate(mix):
        forced = cycle and i < len(mix) - 1
        body = {"prompt": mix_prompt(i, n - 16) + 2 * CYCLE if forced else mix_prompt(i, n),
                "max_tokens": max_tokens}
        body.update(seeded if i == len(mix) - 1 else {**force, "stream": True})
        jobs.append(body)
    results = [None] * len(jobs)
    greedy_ids = tok.encode(mix_prompt(len(mix), GREEDY_PROMPT))
    greedy_out = []
    stats = {}
    try:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"warm-up request failed: {status}")
        pa.paged_attention.launches = fa.flash_attention.launches = fa.flash_decode.launches = 0
        steps0, chunks0, waits0 = batcher.decode_steps, batcher.prefill_chunks, batcher.page_waits
        verify0, dchunks0 = batcher.verify_ticks, batcher.draft_prefill_chunks
        fallback0 = batcher.fallback_ticks
        served = ServedRun(batcher, engine)
        if draft_engine is not None:
            served_draft = ServedRun(types.SimpleNamespace(graphs=batcher.dgraphs), draft_engine)

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
        # the unforced greedy request, enqueued here (second oldest); with
        # draft="off" it asks for logprobs, which a speculating batcher
        # would answer with plain blocks
        greedy_stream = batcher.generate_step(greedy_ids, max_tokens=GREEDY_TOKENS,
                                              want_logprobs=draft == "off")
        greedy_req = greedy_stream.gi_frame.f_locals["req"]
        threads.append(threading.Thread(target=lambda: greedy_out.extend(greedy_stream)))
        for t in threads[:-2] + threads[-1:]:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        decode_s = batcher.decode_seconds - decode_s0
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": fa.flash_attention.launches,
                    "flash_decode": fa.flash_decode.launches}
        steps = batcher.decode_steps - steps0
        chunks = batcher.prefill_chunks - chunks0
        waits = batcher.page_waits - waits0
        high_water = batcher.pages_high_water
        verify_ticks = batcher.verify_ticks - verify0
        draft_chunks = batcher.draft_prefill_chunks - dchunks0
        fallbacks = batcher.fallback_ticks - fallback0
        served.check(tag, steps // batcher.decode_block + chunks + verify_ticks)
        if draft_engine is not None:
            # the draft's chunks, its proposals (one a round) and its
            # replays of the plain blocks
            served_draft.check(tag + " draft", draft_chunks + verify_ticks + fallbacks)
        tick_line(tag, batcher)
        ticks = batcher.tick_timing_stats()
        deadline_check(port, batcher, tag)
        health = [get(port, "/health")]
        batcher.close()
        health.append(get(port, "/health"))
        log(f"{tag} /health before close(): {health[0][0]} {health[0][1].decode()}; after: "
            f"{health[1][0]} {health[1][1].decode()}")
        check([(status, json.loads(body)["status"]) for status, body, _ in health]
              == [(200, "ok"), (503, "draining")], "the batcher's /health around close()")
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
        check(text == expected_text(max_tokens),
              f"request {i}: {len(text)} bytes, want {max_tokens} of the forced text")
        ttfts.append(t_head)
        log(f"{tag} request {i}: {n}-token prompt, {max_tokens} tokens, TTFT {t_head * 1e3:.1f} ms, "
            f"done in {t_end:.3f}s")
    check(results[-1] is not None, "the seeded request among others did not return")
    status, twin, _, t_end = results[-1]
    check(status == 200, f"seeded request among others: status {status}: {twin}")
    ids = [r["choices"][0]["logprobs"]["tokens"] for r in (alone, twin)]
    check(len(ids[0]) == len(ids[1]) == mix[-1][1], "the seeded request's token count")
    if draft != "ngram":  # with a draft engine its logprobs make every tick plain
        check(ids[0] == ids[1] and alone["choices"][0]["text"] == twin["choices"][0]["text"],
              "the seeded request gave other tokens among others than alone")
    log(f"{tag} request {len(mix) - 1}: the seeded top-p twin (not streamed, sent first), done "
        f"in {t_end:.3f}s: {'the same' if ids[0] == ids[1] else 'other'} {len(ids[0])} token "
        f"ids as alone")
    check(len(greedy_out) == GREEDY_TOKENS, f"{tag} the unforced greedy request gave "
          f"{len(greedy_out)} tokens, want {GREEDY_TOKENS}")
    greedy = [t for t, _ in greedy_out]
    if draft == "off":
        ties = near_ties(tag, "the unforced greedy request", [lp for _, lp in greedy_out])
        stats["greedy"] = (greedy, ties, list(greedy_req.preempted_at))
    else:
        want, ties, want_at = reference
        at = [a[0] for a in (want_at, greedy_req.preempted_at) if a]
        n = min(at, default=GREEDY_TOKENS)
        same = agreement(tag, "the unforced greedy request against its draft=off run",
                         greedy[:n], want[:n], ties)
        log(f"{tag} the unforced greedy request: {same} of its first {n} tokens equal its "
            f"draft=off run's (preempted after {want_at} tokens there, after "
            f"{greedy_req.preempted_at} here; the tokens after a preemption are not compared)")
        stats["greedy_agree"] = (same, n)
    want_chunks = (sum(-(-n // CHUNK) for n, _ in mix) + -(-mix[-1][0] // CHUNK)
                   + -(-GREEDY_PROMPT // CHUNK))
    preemptions = batcher.preemptions
    log(f"{tag} batcher: {chunks} prefill chunks (the requests need {want_chunks} without "
        f"preemption), {steps} decode steps, {waits} requests waited for pages, pool high-water "
        f"{high_water} of {pool} pages, {preemptions} preemptions")
    if draft == "off":
        # what planning a block on the device costs the card: the plan of
        # its steps from the slot offsets, captured and replayed alone
        inputs = engine.device_inputs(("decode", batcher.decode_block), batcher.table,
                                      [True] * SLOTS, batcher.cache.offsets, True)
        stats["plan_ms"] = graph_ms(lambda: engine.device_plan(inputs.offsets.long(), inputs,
                                                               batcher.decode_block))
        log(f"{tag} a decode block's plan on the device ({batcher.decode_block} steps of "
            f"{SLOTS} slots): {stats['plan_ms']:.4f} ms of device time")
    if overcommit:
        check(preemptions >= 1, "the overcommit run preempted nothing")
        check(chunks >= want_chunks, "fewer prefill chunks than the requests need")
    else:
        check(preemptions == 0 and chunks == want_chunks,
              "prefill chunk count disagrees with the requests")
    if pool:
        check(waits >= 1, "no request waited for pages: the pool is too large for the check")
    layers = cfg.num_hidden_layers
    # the T=1 attention: kernel 2 over the pool (ragged), or kernel 1's T=1
    # route over contiguous caches (dense slots, the gather path's views);
    # a draft engine's K steps a round and its replays take the route too
    ragged = engine.decode_path == "ragged"
    want_launches = {"paged_attention": (layers * steps if ragged else 0, f"{layers} x {steps}"),
                     "flash_attention": (layers * chunks, f"{layers} x {chunks}"),
                     "flash_decode": (0 if ragged else layers * steps, f"{layers} x {steps}")}
    if draft_engine is not None:
        dl = draft_model.config.num_hidden_layers
        draft_steps = SPEC_K * verify_ticks + batcher.decode_block * fallbacks
        want_launches["flash_attention"] = (
            layers * chunks + dl * draft_chunks, f"{layers} x {chunks} + {dl} x {draft_chunks}")
        want_launches["flash_decode"] = (
            layers * steps + dl * draft_steps, f"{layers} x {steps} + {dl} x {draft_steps}")
    for name, (want, how) in want_launches.items():
        log(f"{tag} {name} launches {launches[name]}, expected {how} = {want}")
        check(launches[name] == want, f"{name} launch count disagrees with the batcher")
    decoded = sum(max_tokens - 1 for _, max_tokens in mix) + GREEDY_TOKENS - 1
    mixed = sum(m for _, m in mix) + GREEDY_TOKENS
    stats = {**stats, "decode_tok_s": decoded / decode_s, "mix_tok_s": mixed / wall,
             "ttft_ms": [t * 1e3 for t in ttfts], "pool_bytes": batcher.cache.nbytes,
             "graph_pool_bytes": captured["pool_bytes"], "capture_s": captured["seconds"],
             "graphs": captured["graphs"], "preemptions": preemptions, "ticks": ticks,
             "reprefill_tokens": batcher.reprefill_tokens}
    log(f"{tag} aggregate decode {stats['decode_tok_s']:.2f} tok/s over {SLOTS} slots (tokens "
        f"after each request's first / host time in decode blocks) against "
        f"{single_stream_tok_s:.2f} tok/s for one stream (phase 4); the mix's "
        f"{mixed} tokens in {wall:.3f}s = {stats['mix_tok_s']:.2f} tok/s")
    if draft != "off":
        spec = batcher.spec_stats()
        check(spec["rounds"] > 0 and spec["accepted_tokens"] > 0,
              f"{tag} the batcher speculated nothing: {spec}")
        log(f"{tag} {verify_ticks} verify rounds and {steps // batcher.decode_block} decode "
            f"blocks; spec_stats {spec}")
        stats["spec"] = spec
        if draft_engine is not None:
            check(fallbacks >= 1 and spec["fallback_ticks"] == batcher.fallback_ticks,
                  f"{tag} no tick fell back to a plain block: {spec}")
            stats["tokens_per_round"] = spec["accepted_tokens"] / spec["rounds"]
            log(f"{tag} draft engine: {stats['mix_tok_s']:.2f} tok/s over the mix, "
                f"{stats['tokens_per_round']:.3f} tokens a slot and round, accept rate "
                f"{spec['accept_rate']:.3f}, {spec['fallback_ticks']} fallback ticks "
                f"({spec['replayed_tokens']} tokens replayed into the draft), draft prefill "
                f"chunks {draft_chunks}")
        if split:
            stats["verify"] = batch_verify_numbers(tag, batcher)
        del batcher, engine, server, draft_engine
        return launches, stats
    del batcher, engine, server
    if not parity:
        return launches, stats
    parity_model = first_layers(model, BATCH_PARITY_LAYERS)
    batcher_parity(parity_model, kv_dtype, tag)
    prefix_parity(parity_model, kv_dtype, tag)
    del parity_model

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


def deadline_check(port, batcher, tag: str) -> None:
    """Fault 4's request: ``"ttft_timeout": 0.001`` to the batcher's server
    answers 504 with a timeout error, and once the scheduler has reaped it
    every page of the pool (every slot, over dense slot caches) is free."""
    status, body, _, t_end = post(port, "/v1/completions", {
        "prompt": mix_prompt(50, 300), "max_tokens": 16, "ttft_timeout": 0.001})
    check(status == 504 and body["error"]["type"] == "timeout_error",
          f"{tag} a ttft_timeout of 1 ms: status {status}: {body}")

    def held():  # (what is held, of how many, what)
        pages = batcher.page_stats()
        if pages is None:
            return sum(r is not None for r in batcher._slots), batcher.M, "slots"
        return pages[1], pages[0], "pages"

    deadline = time.monotonic() + 10
    while held()[0] and time.monotonic() < deadline:
        time.sleep(0.05)
    in_use, total, what = held()
    stats = batcher.resilience_stats()
    log(f"{tag} ttft_timeout 0.001: 504 in {t_end * 1e3:.1f} ms ({body['error']['message']}); "
        f"then {in_use} of {total} {what} in use; {stats}")
    check(in_use == 0, f"{tag} the timed-out request's {what} were not freed")
    check(stats["timeouts"] + stats["shed_deadline"] >= 1, f"{tag} deadline counters {stats}")


def prefix_parity(model, kv_dtype: str, tag: str) -> None:
    """Prefix sharing on the card, served on this thread: four greedy
    requests whose prompts share ``PREFIX_TOKENS`` (two 256-token pages),
    the first served alone, then the other three, with the prefix cache
    off and on. The streams must be token-identical, the cache must count
    3 hits and 3 x 512 tokens reused, and skip 32 flash launches for each
    of the 3 x 2 chunks it did not prefill."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tok = ByteTokenizer()
    shared = tok.encode(mix_prompt(40, PREFIX_TOKENS))
    jobs = [(shared + tok.encode(mix_prompt(41 + i, PREFIX_SUFFIX)), dict(max_tokens=64))
            for i in range(4)]
    runs = {}
    for cache_on in (False, True):
        engine = PipelineEngine(model, microbatches=SLOTS, max_seq=PARITY_MAX_SEQ,
                                prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                                kv_dtype=kv_dtype, device=model.device)
        batcher = ContinuousBatcher(engine, decode_block=8, prefix_cache=cache_on)
        batcher.warm_up()
        fa.flash_attention.launches = 0
        first, _ = serve_on_this_thread(batcher, jobs[:1])
        rest, _ = serve_on_this_thread(batcher, jobs[1:])
        runs[cache_on] = ([[t for t, _ in s] for s in first + rest], fa.flash_attention.launches,
                          batcher.prefill_chunks, batcher.prefix_stats())
        batcher.close()
        del batcher, engine
    (off, off_flash, off_chunks, _), (on, on_flash, on_chunks, stats) = runs[False], runs[True]
    layers = model.config.num_hidden_layers
    log(f"{tag} prefix sharing: four {len(jobs[0][0])}-token prompts sharing {PREFIX_TOKENS} "
        f"tokens, 64 tokens each: cache off {off_chunks} prefill chunks, {off_flash} flash "
        f"launches; cache on {on_chunks} chunks, {on_flash} launches, prefix_stats (queries, "
        f"hits, tokens reused, evictions, cached pages) {stats}; streams token-identical "
        f"{on == off}")
    check(on == off, f"{tag} prefix sharing changed a stream")
    check(stats[:3] == (4, 3, 3 * PREFIX_TOKENS), f"{tag} prefix_stats {stats}")
    check(off_flash - on_flash == 3 * (PREFIX_TOKENS // CHUNK) * layers,
          f"{tag} prefix sharing skipped {off_flash - on_flash} flash launches")


# the decode blocks a batcher captures at load, (sampled, logprobs) kinds:
# one that serves only greedy requests without logprobs needs that block
# alone, and phase 6's mixes, whose only sampled request asks for logprobs,
# never run a sampled block without them (each block is an eager 8-step
# warm-up of about a second)
GREEDY_ONLY = {"blocks": ((False, False),)}
MIX_BLOCKS = {"blocks": ((False, False), (False, True), (True, True))}


def serve_on_this_thread(batcher, jobs, *, cancel_after=None, tick=None, start_after=None,
                         hold=None):
    """Serve ``jobs`` ``[(prompt, kwargs)]`` by running the batcher's ticks
    on the calling thread (no scheduler thread), every request submitted
    before the first tick, so that a run's admissions and preemptions
    depend on the jobs alone. ``cancel_after=(i, n)`` closes stream i after
    its n-th token, as a client that walks away. ``start_after={i: (j,
    n)}`` submits job i only once stream j has n tokens (or has ended).
    ``hold=(i, n, ticks)`` stops reading stream i after its n-th token for
    that many ticks, as a client that stops reading and comes back.
    ``tick``: what one iteration calls, ``batcher.run_tick`` by default.
    Returns each stream's ``(token, logprobs)`` items and the requests
    (their ``preempted_at``)."""
    tick = tick or batcher.run_tick
    batcher._ensure_running = lambda: None
    start_after = start_after or {}
    streams, reqs = [None] * len(jobs), [None] * len(jobs)

    def submit(i):
        streams[i] = batcher.generate_step(jobs[i][0], **jobs[i][1])
        reqs[i] = batcher._submit.queue[-1]

    for i in range(len(jobs)):
        if i not in start_after:
            submit(i)
    got = [[] for _ in jobs]
    ended = [False] * len(jobs)
    held = 0
    with torch.no_grad():
        for _ in range(100000):
            for i, (stream, req) in enumerate(zip(streams, reqs)):
                if stream is None:
                    j, n = start_after[i]
                    if len(got[j]) < n and not ended[j]:
                        continue
                    submit(i)
                    stream, req = streams[i], reqs[i]
                if hold is not None and i == hold[0] and len(got[i]) >= hold[1] \
                        and held < hold[2]:
                    continue
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
            if hold is not None and len(got[hold[0]]) >= hold[1]:
                held += 1
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
        # the eager pass serves the first PARITY_EAGER_JOBS greedy requests
        # for PARITY_EAGER_TOKENS tokens: a slot's tokens do not depend on
        # the others', and the step shapes are the M slots' whatever runs
        eager = name == "eager"
        run_jobs = ([(p, dict(max_tokens=PARITY_EAGER_TOKENS)) for p, _ in jobs[:PARITY_EAGER_JOBS]]
                    if eager else jobs)
        items, reqs = serve_on_this_thread(batcher, run_jobs)
        streams = [[t for t, _ in s] for s in items]
        check(all(len(s) == kw_["max_tokens"] for s, (_, kw_) in zip(streams, run_jobs)),
              f"{tag} parity run ({name}): a request did not finish")
        runs[name] = (streams, [r.preempted_at for r in reqs])
        tick_line(f"{tag} parity run ({name})", batcher)
        batcher.close()
        del batcher, engine
    check([s[:PARITY_EAGER_TOKENS] for s in runs["graphs"][0][:PARITY_EAGER_JOBS]]
          == runs["eager"][0], f"{tag} the batcher's prefill and decode graphs and its eager "
          "steps give other tokens")
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
        f"token-identical through async and sync ticks, and under overcommit for every request "
        f"not preempted; the first {PARITY_EAGER_JOBS} for {PARITY_EAGER_TOKENS} tokens through "
        "the graphs and the eager steps")


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


def phase_main_path_4bit(dense, seed: int, lap=None):
    """``--keep-quantized`` at full width: the dense model's weights packed
    on the card, its last-position logits against a dense model holding the
    dequantized weights (the dense model itself, overwritten in place), then
    the dense weights freed and the packed, fused model served; then, with
    ``lap``, phase 15's packed run (``pipe_packed``). Returns the launches
    of the counted run per kernel (and phase 15's) and the request
    numbers."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.models.base import QuantizedLinear
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm
    from mlx_sharding_tpu_torch.ops.attention import flash_decode_on
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, make_server

    cfg = dense.config
    t0 = time.perf_counter()
    marks = [t0]

    def sub(what):
        # phase 5's sub-steps, each one's seconds
        marks.append(time.perf_counter())
        log(f"[time] phase 5, {what}: {marks[-1] - marks[-2]:.1f}s")

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
    gen = Generator(packed, max_seq=MAX_SEQ, prefill_chunk=CHUNK, decode_block=MAIN_DECODE_BLOCK)
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
    sub("packing and the logits check")
    graph_line("[main-4bit]", gen.warm_up(prefill_upto=MAIN_PROMPT))
    sub("captures")

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
        fa.flash_decode.launches = 0
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
                    "flash_decode": fa.flash_decode.launches,
                    "quant_gemv": qm.quant_gemv.launches,
                    "quant_matmul": qm.quant_matmul.launches}
        # whole decode blocks: 31 and 63 tokens after the first
        block_counts = (-(-31 // MAIN_DECODE_BLOCK), -(-63 // MAIN_DECODE_BLOCK))
        served.check("[main-4bit]", 2 * 3 + sum(block_counts))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    layers, chunks = cfg.num_hidden_layers, 2 * 3
    steps = MAIN_DECODE_BLOCK * sum(block_counts)
    expected = {
        "flash_attention": layers * chunks,
        # fused QKV, o_proj, fused gate+up and down_proj per layer and chunk
        "quant_matmul": LAYER_SHAPES * layers * chunks,
        # the same four and the head per decode step; the head once per chunk
        "quant_gemv": (LAYER_SHAPES * layers + 1) * steps + chunks,
        # the T=1 route, once a layer per decode step when it is on
        "flash_decode": layers * steps if flash_decode_on() else 0,
    }
    for name, want_n in expected.items():
        log(f"[main-4bit] {name} launches {launches[name]}, expected {want_n}")
        check(launches[name] == want_n, f"{name} launch count disagrees with the requests")
    sub("the served requests")
    stats["prefill_ms"], runs = prefill_median_ms(lambda: gen.run_prefill(prompt))
    log(f"[main-4bit] Generator.run_prefill of the 600-token prompt, packed, graphs: median "
        f"{stats['prefill_ms']:.2f} ms of {len(runs)} device-synchronised runs after a warm-up "
        f"({' / '.join(f'{t:.2f}' for t in runs)})")
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main-4bit] torch.cuda.max_memory_allocated while serving packed "
        f"{stats['max_memory_allocated_gb']:.2f} GB (graph pool included)")
    sub("the prefill median")
    stats["steps"] = phase_step_timing(packed, gen, "[main-4bit]", prompt)
    sub("step timing, eager and graphs")
    stats["routes"] = phase_decode_routes(packed, gen, "[main-4bit]", prompt)
    sub("the two T=1 routes")
    stats["spec"] = phase_speculation_packed(packed, gen, "[spec-4bit]")
    sub("speculation")
    if lap is not None:
        lap("main path, 4-bit")
        del gen
        stats["pipeline"] = pipe_packed(packed)
        for run in (stats["pipeline"]["pp1"], stats["pipeline"]["pp2"]):
            for name in ("quant_gemv", "quant_matmul", "flash_attention", "flash_decode"):
                launches[name] += run["launches"][name]
        lap("phase 15, the packed model at pp = 1 and 2")
        stats["mesh"] = mesh_packed(packed)
        stats["mesh_fleet"] = mesh_packed_fleet(packed)
        for run in [*stats["mesh"].values(), *stats["mesh_fleet"].values()]:
            for name in ("quant_gemv", "quant_matmul", "flash_attention", "flash_decode"):
                launches[name] += run["launches"][name]
        lap("phase 17, the packed model at tp = 1 and 2, and as two tp = 2 replicas")
    return launches, stats


# ------------------------------------------------------------ speculation
def repeated_passage(n: int = 600) -> str:
    """The speculation runs' prompt: ``n`` bytes of one repeated passage."""
    words = ("pipeline stages pass activations over rings while the cache grows; "
             "every chunk of the prompt runs through the flash kernel. ")
    return (words * (n // len(words) + 1))[:n]


# The forced runs' output: the eight bytes of CYCLE over and over. A bias
# of 100 - i on byte i and a penalty of 2 over the last 7 tokens leave one
# biased byte unpenalized at each step, the one that left the window, and
# it wins; the prompt ends with the cycle twice, so that the window starts
# from it. Prompt lookup then proposes the next 8 bytes, which the verify
# accepts whole (a single forced byte would not do: its most recent match
# is the stream's own tail, which continues for one token).
CYCLE = "ABCDEFGH"
FORCE_CYCLE = {"logit_bias": {ord(c): 100.0 - i for i, c in enumerate(CYCLE)},
               "repetition_penalty": 2.0, "repetition_context_size": len(CYCLE) - 1}


def forced_passage(n: int = 600) -> str:
    """The forced runs' prompt: ``n`` bytes of the repeated passage that end
    with ``CYCLE`` twice."""
    return repeated_passage(n - 2 * len(CYCLE)) + 2 * CYCLE


def forced_text(n: int) -> str:
    return (CYCLE * (n // len(CYCLE) + 1))[:n]


def near_ties(tag: str, name: str, lps: list) -> list:
    """Each position's top-2 log-probability gap and near-tied tokens (those
    of its top log-probabilities within ``NEAR_TIE_GAP`` of the best) from
    a plain run's ``TokenLogprobs``; prints the share of positions at or
    under ``NEAR_TIE_GAP`` and at ``GAP_READINGS``."""
    ties = [(float(lp.top_values[0] - lp.top_values[1]),
             [int(i) for i, v in zip(lp.top_indices, lp.top_values)
              if lp.top_values[0] - v <= NEAR_TIE_GAP]) for lp in lps]
    gaps = np.asarray([g for g, _ in ties])
    log(f"{tag} {name}: top-2 gaps of its {gaps.size} positions: share at or under "
        + ", ".join(f"{x:g} nats {np.mean(gaps <= x):.3f}" for x in GAP_READINGS)
        + f" (the limit is {NEAR_TIE_GAP}); smallest {np.sort(gaps)[:4].round(4).tolist()}, "
        f"median {np.median(gaps):.4f}")
    return ties


def plain_reference(tag: str, gen, ids: list, max_tokens: int, timed: bool = True,
                    **kw) -> tuple:
    """Plain greedy decode of ``ids`` through the Generator ``gen``: its
    tokens, its decode tok/s (None unless ``timed``: a run without
    logprobs), and the top-2 gap and near-tied tokens at every position
    (``near_ties`` of a logprobs run of the same steps, which must give the
    same tokens)."""
    lps = list(gen.generate_step(ids, max_tokens=max_tokens, want_logprobs=True, **kw))
    toks, tok_s = [t for t, _ in lps], None
    if timed:
        timed_toks, tok_s = stream_tokens(gen, ids, max_tokens=max_tokens, **kw)
        check(timed_toks == toks, "plain greedy: the logprobs run gave other tokens")
    return toks, tok_s, near_ties(tag, "plain greedy", [lp for _, lp in lps])


def agreement(tag: str, name: str, got: list, want: list, ties) -> int:
    """How many leading tokens of ``got`` equal plain greedy's ``want``;
    with ``ties`` (the plain run's top-2 gaps and near-tied tokens) a
    divergence must sit at a near-tie (``NEAR_TIE_GAP``) and take one of
    its near-tied tokens, without them there must be none."""
    same = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), len(want))
    check(len(got) == len(want), f"{tag} {name}: {len(got)} tokens, want {len(want)}")
    if same < len(want):
        check(ties is not None, f"{tag} {name}: leaves plain greedy decode at token {same}")
        gap, near = ties[same]
        log(f"{tag} {name}: the first {same} of {len(want)} tokens equal plain greedy decode's; "
            f"at token {same} the plain run's top-2 gap is {gap:.4f} nats (limit "
            f"{NEAR_TIE_GAP}); it took {got[same]} where plain took {want[same]}, the plain "
            f"run's tokens within the limit of its best being {near}")
        check(gap <= NEAR_TIE_GAP and got[same] in near,
              f"{tag} {name}: diverges from plain greedy decode away from a near-tie")
    return same


def reset_spec_counters(gen) -> None:
    gen.rounds = gen.accepted_tokens = gen.draft_tokens = gen.tail_steps = 0
    gen.round_tokens = 0
    gen.rounds_by_k = {}


def replay_ms(graphs, key) -> float:
    """Device ms of one replay of the captured step ``key``."""
    entry = graphs._graphs[key]
    return time_ms(entry.graph.replay, iters=10, warmup=2)


def graph_ms(fn) -> float:
    """Device ms of ``fn`` captured as one CUDA graph and replayed, so that
    its many launches time the card, not the host enqueueing them (the
    wrappers' launch counts that the capture bumps are put back)."""
    from mlx_sharding_tpu_torch.graphs import counted_wrappers

    before = [w.launches for w in counted_wrappers()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up: libraries and workspaces come to exist here
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for w, b in zip(counted_wrappers(), before):
        w.launches = b
    ms = time_ms(graph.replay, iters=10, warmup=2)
    del graph
    return ms


def layer_products(model):
    """Every projection module of the model's layers, with its IN."""
    from mlx_sharding_tpu_torch.models.base import QuantizedLinear

    out = []
    for layer in model.layers:
        for mod in layer.children():
            if isinstance(mod, torch.nn.Linear):
                out.append((mod, mod.in_features))
            elif isinstance(mod, QuantizedLinear):
                out.append((mod, mod.q.shape[1] * 32 // mod.bits))
    return out


def products_ms(model, rows: int) -> float:
    """Device ms of one T=K forward's products: every layer projection and
    the head at ``rows`` rows (M x K), the kernels the step runs."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    mods = layer_products(model)
    dt = model.compute_dtype
    xs = {d: torch.randn((rows, d), generator=gen, device="cuda").to(dt)
          for d in {d for _, d in mods} | {model.config.hidden_size}}
    h = xs[model.config.hidden_size][:, None]

    def products():
        for mod, d in mods:
            model._linear(xs[d], mod)
        model.apply_head(h)

    return graph_ms(products)


def attention_ms(model, q_rows: int, k, v, position) -> float:
    """Device ms of one T=K forward's ``masked_attention``: every layer, q
    of ``q_rows`` positions over the full-capacity K/V ``k``, ``v``."""
    from mlx_sharding_tpu_torch.ops.attention import masked_attention

    cfg = model.config
    b = k.shape[0]
    q = torch.randn((b, q_rows, cfg.num_attention_heads, cfg.head_dim), device="cuda").to(k.dtype)
    scale = cfg.head_dim ** -0.5

    def attention():
        for _ in range(cfg.num_hidden_layers):
            masked_attention(q, k, v, position, scale)

    return graph_ms(attention)


def split_line(tag: str, what: str, total: float, parts: dict) -> dict:
    rest = total - sum(parts.values())
    parts = {**parts, "small kernels": rest}
    log(f"{tag} {what}: {total:.3f} ms of device time a round; by part, each captured and "
        f"replayed alone at the round's shapes: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + " (small kernels: the round less the other parts)")
    return {"total_ms": total, **parts}


def single_verify_numbers(tag: str, ng, model) -> dict:
    """The n-gram generator's verify at K = 2, 4, 8 after a request: the
    device ms of one replay, and its split into masked_attention, the
    products and the small kernels (a single stream gathers nothing)."""
    from mlx_sharding_tpu_torch.device import upload_into
    from mlx_sharding_tpu_torch.generate import REPETITION_WINDOW

    t = ng.target
    out = {}
    for k in VERIFY_KS:
        upload_into(ng._inputs, np.asarray([k] + [65] * k, np.int64))
        ng._verify(k, REPETITION_WINDOW, False)
        total = replay_ms(t.graphs, ("verify", ng._key, k, False, REPETITION_WINDOW))
        parts = {"masked_attention": attention_ms(model, k, t.cache.k[0], t.cache.v[0],
                                                  t.cache.pos),
                 "products": products_ms(model, k)}
        out[k] = split_line(tag, f"single-stream verify, K = {k}", total, parts)
    return out


def spec_run(tag: str, name: str, gen, models: list, ids: list, want: list, ties,
             counters: dict, **kw) -> dict:
    """One counted greedy request of ``SPEC_TOKENS`` tokens through a
    speculating generator whose graphs are captured: every step a replay
    (no capture, no eager forward of ``models``), the stream against plain
    greedy decode's (``agreement``), and its numbers: decode tok/s, rounds,
    tokens a round, accept rate and each kernel's launches."""
    graphs = [g.graphs for g in (gen.target, gen.draft) if g is not None]
    captures = sum(g.captures for g in graphs)
    forwards = [m.eager_forwards for m in models]
    reset_spec_counters(gen)
    for c in counters.values():
        c.launches = 0
    toks, tok_s = stream_tokens(gen, ids, max_tokens=SPEC_TOKENS, **kw)
    launches = {n: c.launches for n, c in counters.items()}
    check(sum(g.captures for g in graphs) == captures
          and [m.eager_forwards for m in models] == forwards,
          f"{tag} {name}: a round ran eagerly")
    same = agreement(tag, name, toks, want, ties)
    st = gen.spec_stats()
    row = {"name": name, "decode_tok_s": tok_s, "rounds": gen.rounds,
           "rounds_by_k": dict(sorted(gen.rounds_by_k.items())), "tail_steps": gen.tail_steps,
           "tokens_per_round": gen.round_tokens / max(1, gen.rounds),
           "accept_rate": st["accept_rate"], "agree": same, "launches": launches}
    log(f"{tag} {name}: {SPEC_TOKENS} tokens at {tok_s:.2f} tok/s decode; {gen.rounds} verify "
        f"rounds (by K: {row['rounds_by_k']}), {row['tokens_per_round']:.2f} tokens a round, "
        f"accept rate {st['accept_rate']:.3f} ({gen.accepted_tokens} of {gen.draft_tokens} "
        f"draft tokens), {gen.tail_steps} tail decode steps; launches {launches}; "
        f"{same} of {SPEC_TOKENS} tokens equal plain greedy decode's")
    return row


def forced_ngram_run(tag: str, ng, gen, models: list, counters: dict) -> dict:
    """The n-gram generator ``ng`` on ``forced_passage`` with
    ``FORCE_CYCLE``: proposals match from the first round, the window
    climbs to 8 and the verify accepts whole windows (speculation's upper
    bound); against plain greedy decode of the same request through
    ``gen``. Its window of 7 is a new graph key for both: a first request
    of each captures them, untimed and uncounted."""
    ids = ByteTokenizer().encode(forced_passage())
    stream_tokens(gen, ids, max_tokens=SPEC_TOKENS, **FORCE_CYCLE)
    want, tok_s, _ = plain_reference(tag + " forced cycle", gen, ids, SPEC_TOKENS,
                                     **FORCE_CYCLE)
    check(bytes(want).decode() == forced_text(SPEC_TOKENS), f"{tag} the forced output "
          f"is not the cycle: {bytes(t for t in want if t < 256)[:40]!r}")
    log(f"{tag} plain greedy, forced cycle: {SPEC_TOKENS} tokens at {tok_s:.2f} tok/s decode")
    stream_tokens(ng, ids, max_tokens=SPEC_TOKENS, **FORCE_CYCLE)
    row = spec_run(tag, "--draft ngram, forced cycle", ng, models, ids, want, None, counters,
                   **FORCE_CYCLE)
    check(row["rounds_by_k"].get(8, 0) > 0, f"{tag} the forced run never reached K = 8")
    row["plain_tok_s"] = tok_s
    return row


def phase_speculation(model, gen, tag: str, seed: int) -> dict:
    """Speculative decoding at full depth in bf16 on the repeated passage
    (600 tokens, ``SPEC_TOKENS`` each): plain greedy through the served
    Generator ``gen``, ``--draft ngram``, the model as its own draft at K =
    4, and the published Llama-3.2-1B config at K = 4 with random bf16
    weights from the seed, each over a target Generator of its own. Each
    speculating generator captures its graphs first; its counted run is
    replays only, its launches are checked
    against its rounds, and its stream against plain greedy decode's (a
    divergence only at a near-tie). Then the n-gram verify's device ms at K
    = 2, 4 and 8 and its split, and each draft's K steps' device ms. The
    n-gram generator also runs ``forced_ngram_run``."""
    from mlx_sharding_tpu_torch.generate import REPETITION_WINDOW
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator, SpeculativeGenerator

    ids = ByteTokenizer().encode(repeated_passage())
    chunks = -(-len(ids) // CHUNK)
    layers = model.config.num_hidden_layers
    want, plain_tok_s, ties = plain_reference(tag, gen, ids, SPEC_TOKENS)
    log(f"{tag} plain greedy: {SPEC_TOKENS} tokens at {plain_tok_s:.2f} tok/s decode")
    counters = {"flash_attention": fa.flash_attention, "flash_decode": fa.flash_decode}
    stats = {"plain_tok_s": plain_tok_s, "runs": []}

    # each speculating generator verifies on the served Generator, whose
    # prefill and decode graphs are captured already
    ng = NgramSpeculativeGenerator(model, target=gen)
    graph_line(f"{tag} ngram", ng.warm_up(prefill_upto=len(ids), sampled=(False,)))
    row = spec_run(tag, "--draft ngram", ng, [model], ids, want, ties, counters)
    expect = {"flash_attention": layers * chunks,
              "flash_decode": layers * (row["rounds_by_k"].get(1, 0) + row["tail_steps"])}
    check(row["launches"] == expect, f"{tag} ngram launches {row['launches']}, want {expect}")
    stats["runs"].append(row)
    row = forced_ngram_run(tag, ng, gen, [model], counters)
    expect = {"flash_attention": layers * chunks,
              "flash_decode": layers * (row["rounds_by_k"].get(1, 0) + row["tail_steps"])}
    check(row["launches"] == expect, f"{tag} forced launches {row['launches']}, want {expect}")
    stats["runs"].append(row)
    stats["verify"] = single_verify_numbers(tag, ng, model)
    del ng

    t0 = time.perf_counter()
    draft, _ = build_model(LLAMA_32_1B, dtype=torch.bfloat16)
    draft.init_params(torch.Generator(device="cuda").manual_seed(seed + 3), "cuda")
    torch.cuda.synchronize()
    log(f"{tag} Llama-3.2-1B draft: {sum(p.numel() for p in draft.parameters()) / 1e9:.3f} B "
        f"bf16 parameters drawn on the card in {time.perf_counter() - t0:.1f}s")
    stats["draft_ms"] = {}
    for name, dmodel in (("self-draft K=4", model), ("llama-3.2-1b draft K=4", draft)):
        sg = SpeculativeGenerator(model, dmodel, spec_k=SPEC_K, target=gen)
        # the prompts' chunks alone: every run here prefills a 600-token prompt
        graph_line(f"{tag} {name}", sg.warm_up(prefill_upto=len(ids), sampled=(False,)))
        models = [model] if dmodel is model else [model, dmodel]
        row = spec_run(tag, name, sg, models, ids, want, ties, counters)
        dl = dmodel.config.num_hidden_layers
        expect = {"flash_attention": (layers + dl) * chunks,
                  "flash_decode": layers * row["tail_steps"] + dl * SPEC_K * row["rounds"]}
        check(row["launches"] == expect, f"{tag} {name} launches {row['launches']}, want {expect}")
        stats["runs"].append(row)
        stats["draft_ms"][name] = replay_ms(sg.draft.graphs,
                                            ("draft", SPEC_K, False, REPETITION_WINDOW))
        stats[name + " verify_ms"] = replay_ms(
            sg.target.graphs, ("verify", sg._key, SPEC_K, False, REPETITION_WINDOW))
        log(f"{tag} {name}: the draft's {SPEC_K} steps {stats['draft_ms'][name]:.3f} ms of device "
            f"time a round, the verify {stats[name + ' verify_ms']:.3f} ms")
        del sg
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_speculation_packed(packed, gen, tag: str) -> dict:
    """``--draft ngram`` over the packed model: the counted runs as in
    ``phase_speculation`` (the repeated passage and the forced run), with
    the GEMV's launches at each verify width M = K (4 layer products a layer
    and the head; the forced run reaches M = 2, 4 and 8) and the matmul's
    counted."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm
    from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator

    ids = ByteTokenizer().encode(repeated_passage())
    chunks = -(-len(ids) // CHUNK)
    layers = packed.config.num_hidden_layers
    want, plain_tok_s, ties = plain_reference(tag, gen, ids, SPEC_TOKENS)
    log(f"{tag} plain greedy: {SPEC_TOKENS} tokens at {plain_tok_s:.2f} tok/s decode")
    counters = {"flash_attention": fa.flash_attention, "flash_decode": fa.flash_decode,
                "quant_gemv": qm.quant_gemv, "quant_matmul": qm.quant_matmul}
    ng = NgramSpeculativeGenerator(packed, target=gen)
    graph_line(f"{tag} ngram", ng.warm_up(prefill_upto=len(ids), sampled=(False,)))
    row = spec_run(tag, "--draft ngram", ng, [packed], ids, want, ties, counters)
    per_step = LAYER_SHAPES * layers + 1
    row["plain_tok_s"] = plain_tok_s
    forced = forced_ngram_run(tag, ng, gen, [packed], counters)
    for r in (row, forced):
        rounds = r["rounds_by_k"]
        expect = {"flash_attention": layers * chunks,
                  "flash_decode": layers * (rounds.get(1, 0) + r["tail_steps"]),
                  "quant_gemv": per_step * (sum(rounds.values()) + r["tail_steps"]) + chunks,
                  "quant_matmul": LAYER_SHAPES * layers * chunks}
        check(r["launches"] == expect, f"{tag} {r['name']} launches {r['launches']}, want {expect}")
        r["gemv_launches_by_m"] = {k: per_step * n for k, n in rounds.items()}
        log(f"{tag} {r['name']}: quant_gemv launches at the verify's M = K: "
            + ", ".join(f"M={k}: {n}" for k, n in r["gemv_launches_by_m"].items())
            + f"; at M = 1 in the tail: {per_step * r['tail_steps']}")
    check(all(forced["gemv_launches_by_m"].get(k, 0) > 0 for k in (2, 4, 8)),
          f"{tag} the forced run launched the GEMV at M = 2, 4 and 8: "
          f"{forced['gemv_launches_by_m']}")
    stats = {"runs": [row, forced], "verify": single_verify_numbers(tag, ng, packed)}
    del ng
    return stats


def batch_verify_numbers(tag: str, batcher) -> dict:
    """The batcher's verify at K = 2, 4, 8 (every slot in the graph): the
    device ms of one replay, and its split into the gather of every slot's
    pages, masked_attention, the products and the small kernels."""
    from mlx_sharding_tpu_torch.cache import layer_pool

    eng, m = batcher.engine, batcher.M
    model = eng.model
    out = {}
    for k in VERIFY_KS:
        inputs = eng.device_inputs(("split", k), batcher.table, batcher.active,
                                   batcher.cache.offsets, True)
        plan = eng.device_plan(inputs.offsets.long(), inputs, k)
        # the verify graph's own inputs, exact: every replay then starts from
        # the host's offsets (with the last served round's, inexact, each
        # replay moved the device offsets on, and in one call a K = 8 replay
        # indexed out of bounds)
        eng.device_inputs(("verify", k), batcher.table, batcher.active, batcher.cache.offsets,
                          True, np.zeros((k, m), np.int64), np.full(m, k, np.int64))
        total = replay_ms(batcher.graphs, ("verify", k, False))
        pools = [(layer_pool(batcher.cache.k, i), layer_pool(batcher.cache.v, i))
                 for i in range(model.config.num_hidden_layers)]
        def gather():
            for kp, vp in pools:
                eng._slot_view(kp, plan.tables)
                eng._slot_view(vp, plan.tables)

        gather = graph_ms(gather)
        view_k, view_v = eng._slot_view(pools[0][0], plan.tables), eng._slot_view(pools[0][1],
                                                                                   plan.tables)
        parts = {"gather": gather,
                 "masked_attention": attention_ms(model, k, view_k, view_v, plan.positions[0]),
                 "products": products_ms(model, m * k)}
        del view_k, view_v
        out[k] = split_line(tag, f"batcher verify of {m} slots, K = {k}", total, parts)
    return out


def phase_spec_f32(seed: int) -> dict:
    """The speculating paths in f32 at the 8B widths and ``F32_LAYERS``
    layers, ``F32_TOKENS`` tokens of the repeated passage: ``--draft
    ngram``, the self-draft and a ``F32_LAYERS``-layer Llama-3.2-1B-shaped
    draft at K = 4, and the batcher's n-gram speculation (sync and async
    ticks, two requests) are token-identical to plain greedy decode, and the self-draft
    accepts every token; then the self-draft at full depth in f32 (32 GB of
    weights) accepts every token of plain greedy decode's stream."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
    from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator, SpeculativeGenerator

    tag = "[spec-f32]"
    tok = ByteTokenizer()
    ids = tok.encode(repeated_passage())
    other = tok.encode(mix_prompt(7, 300))
    common = dict(max_seq=F32_MAX_SEQ, prefill_chunk=CHUNK)

    def build(config, layers, s):
        m, _ = build_model({**config, "num_hidden_layers": layers}, dtype=torch.float32)
        return m.init_params(torch.Generator(device="cuda").manual_seed(s), "cuda")

    model = build(LLAMA_31_8B, F32_LAYERS, seed + 7)
    draft = build(LLAMA_32_1B, F32_LAYERS, seed + 8)
    plain = Generator(model, **common)
    want = {p: [t for t, _ in plain.generate_step(ids if p == "a" else other,
                                                  max_tokens=F32_TOKENS)] for p in "ab"}
    stats = {}
    for name, gen in (("--draft ngram", NgramSpeculativeGenerator(model, **common)),
                      ("self-draft K=4", SpeculativeGenerator(model, model, spec_k=SPEC_K,
                                                              **common)),
                      ("2-layer 1B-shaped draft K=4", SpeculativeGenerator(
                          model, draft, spec_k=SPEC_K, **common))):
        got = [t for t, _ in gen.generate_step(ids, max_tokens=F32_TOKENS)]
        agreement(tag, name, got, want["a"], None)
        stats[name] = (gen.rounds, gen.accepted_tokens, gen.draft_tokens)
        log(f"{tag} {name}: {F32_TOKENS} tokens token-identical to plain greedy decode; "
            f"{gen.rounds} rounds, {gen.accepted_tokens} of {gen.draft_tokens} draft tokens "
            f"accepted")
        check(gen.rounds > 0, f"{tag} {name}: no verify round ran")
        if name.startswith("self"):
            check(gen.accepted_tokens == SPEC_K * gen.rounds,
                  f"{tag} the self-draft rejected a token")
        del gen
    for sched in ("off", "on"):
        engine = PipelineEngine(model, microbatches=2, max_seq=F32_MAX_SEQ, prefill_chunk=CHUNK,
                                pool_pages=8, page_size=PAGE, device=model.device)
        batcher = ContinuousBatcher(engine, decode_block=8, draft="ngram", async_sched=sched)
        items, _ = serve_on_this_thread(batcher, [(ids, dict(max_tokens=F32_TOKENS)),
                                                  (other, dict(max_tokens=F32_TOKENS))])
        name = f"batcher ngram ({'async' if batcher._async else 'sync'} ticks)"
        for s_, p in zip(items, "ab"):
            agreement(tag, name, [t for t, _ in s_], want[p], None)
        st = batcher.spec_stats()
        check(st["rounds"] > 0, f"{tag} {name} ran no verify round")
        log(f"{tag} {name}, two requests: token-identical to plain greedy decode; spec_stats "
            f"{st}")
        stats[name] = st
        batcher.close()
        del batcher, engine
    del plain, model, draft
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    full, _ = build_model(LLAMA_31_8B, dtype=torch.float32)
    full.init_params(torch.Generator(device="cuda").manual_seed(seed + 9), "cuda")
    plain = Generator(full, **common)
    want = [t for t, _ in plain.generate_step(ids, max_tokens=F32_TOKENS)]
    sg = SpeculativeGenerator(full, full, spec_k=SPEC_K, **common)
    got = [t for t, _ in sg.generate_step(ids, max_tokens=F32_TOKENS)]
    agreement(tag, "self-draft K=4, 32 layers", got, want, None)
    check(sg.rounds > 0 and sg.accepted_tokens == SPEC_K * sg.rounds,
          f"{tag} the full-depth self-draft rejected a token: {sg.accepted_tokens} of "
          f"{SPEC_K * sg.rounds}")
    log(f"{tag} self-draft K=4 at full depth (32 layers, f32): {F32_TOKENS} tokens "
        f"token-identical to plain greedy decode, {sg.accepted_tokens} of {sg.draft_tokens} "
        f"draft tokens accepted in {sg.rounds} rounds ({time.perf_counter() - t0:.1f}s with the "
        f"weights drawn)")
    stats["full_depth_self_draft"] = (sg.rounds, sg.accepted_tokens)
    del sg, plain, full
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# ------------------------------------------- phase 10: dense slots, gather, draft
#: the draft engine of phase 10: the target cut to its first layers (tensors
#: shared, ``first_layers``), as a same-family small draft is served
DRAFT_LAYERS = 8
#: the f32 check's slots and prompts (tokens) at the 8B widths, F32_LAYERS
DENSE_F32_PROMPTS = (600, 250, 40)


def phase_slot_kernels(seed: int) -> dict:
    """The kernels at phase 10's new call sites against their plain versions
    at the 8B shapes (bf16; ``kernel_disagreement``'s limits): kernel 1 on
    one slot of ``SLOTS + 1`` dense slot caches through a device
    ``kv_index`` (slots 0 and ``SLOTS`` - 1 at the mix's chunk offsets; the
    bits of the same call on the slot's row alone), and the T=1 route over
    ``SLOTS`` caches at their own positions (``slot_lengths``: the mix's
    first decode step, one slot idle, whose rows are zeros). Returns each
    route's largest error."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    scale = 128 ** -0.5
    errs = {"flash_attention": 0.0, "flash_decode": 0.0}
    q, k, v = attention_inputs(gen, SLOTS + 1, CHUNK, MAX_SEQ, 32, 8, 128, 128, torch.bfloat16)
    q = q[:1]
    for slot, offset in ((0, 0), (SLOTS - 1, 512), (SLOTS - 1, 3840)):
        index = torch.tensor([slot], device="cuda")
        got = fa.flash_attention(q, k, v, offset, scale, kv_index=index)
        alone = fa.flash_attention(q, k[slot : slot + 1], v[slot : slot + 1], offset, scale)
        ref = fa.flash_attention_reference(q, k[slot : slot + 1], v[slot : slot + 1], offset,
                                           scale)
        torch.cuda.synchronize()
        err, worst, rel_l2 = kernel_disagreement(got, ref)
        log(f"[kernels] flash_attention kv_index: slot {slot} of {SLOTS + 1} slot caches, offset "
            f"{offset}: max_abs_err {err:.3e}, worst err/limit {worst:.3f} (tol 1), relative L2 "
            f"{rel_l2:.3e}; the bits of the call on the slot's row alone {torch.equal(got, alone)}")
        check(worst <= 1 and rel_l2 <= REL_L2_TOL and torch.equal(got, alone),
              f"flash_attention kv_index slot {slot} offset {offset} disagrees")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    q = torch.randn((SLOTS, 1, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = k[:SLOTS].contiguous(), v[:SLOTS].contiguous()
    positions = torch.tensor([n for n, _ in BATCH_MIX[:SLOTS]], device="cuda")
    active = torch.ones(SLOTS, dtype=torch.bool, device="cuda")
    active[3] = False
    lengths = fa.slot_lengths(positions, active, MAX_SEQ)
    got = fa.flash_decode(q, k, v, positions, scale, lengths=lengths)
    ref = fa.flash_decode_reference(q, k, v, lengths, scale)
    torch.cuda.synchronize()
    err, worst, rel_l2 = kernel_disagreement(got, ref)
    log(f"[kernels] flash_decode over {SLOTS} slot caches at per-slot lengths "
        f"{lengths.tolist()}: max_abs_err {err:.3e}, worst err/limit {worst:.3f} (tol 1), "
        f"relative L2 {rel_l2:.3e}; the idle slot's rows zero {not got[3].any().item()}")
    check(worst <= 1 and rel_l2 <= REL_L2_TOL and not got[3].any().item(),
          "flash_decode at per-slot lengths disagrees with its plain version")
    errs["flash_decode"] = err
    return errs


def phase_dense_f32(seed: int) -> dict:
    """Phase 10's exactness in f32 at the 8B widths and ``F32_LAYERS``
    layers, ``F32_TOKENS`` greedy tokens of ``DENSE_F32_PROMPTS``, every
    batcher through its graphs on this thread: the dense-slot batcher, the
    paged batcher (ragged) and the gather path each token-identical to the
    Generator; the draft engine (the target's first layer, K = ``SPEC_K``)
    token-identical to plain greedy decode, with a logprobs request beside
    it so that ticks fall back and replay into the draft. Then the new call
    sites' kernels against their plain versions in one forward each: the
    dense prefill chunk of a slot (kernel 1 with ``kv_index``) and one T=1
    step of the dense and gather engines (the T=1 route at per-slot
    lengths), their logits within ``F32_LOGITS_RTOL`` of the same steps
    with the kernel entry points swapped for their plain versions."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tag = "[dense-f32]"
    tok = ByteTokenizer()
    prompts = [tok.encode(mix_prompt(60 + i, n)) for i, n in enumerate(DENSE_F32_PROMPTS)]
    model, _ = build_model({**LLAMA_31_8B, "num_hidden_layers": F32_LAYERS}, dtype=torch.float32)
    model.init_params(torch.Generator(device="cuda").manual_seed(seed + 11), "cuda")
    plain = Generator(model, max_seq=F32_MAX_SEQ, prefill_chunk=CHUNK)
    want = [[t for t, _ in plain.generate_step(p, max_tokens=F32_TOKENS)] for p in prompts]
    del plain
    m = len(prompts)
    geometry = dict(microbatches=m, max_seq=F32_MAX_SEQ, prefill_chunk=CHUNK, device=model.device)
    pages = sum(-(-(len(p) + F32_TOKENS) // PAGE) for p in prompts)
    jobs = [(p, dict(max_tokens=F32_TOKENS)) for p in prompts]
    engines = {"dense": PipelineEngine(model, **geometry),
               "ragged": PipelineEngine(model, pool_pages=pages, page_size=PAGE, **geometry),
               "gather": PipelineEngine(model, pool_pages=pages, page_size=PAGE,
                                        paged_attention="gather", **geometry)}
    streams = {}
    for name, engine in engines.items():
        batcher = ContinuousBatcher(engine, decode_block=8)
        batcher.warm_up()
        items, _ = serve_on_this_thread(batcher, jobs)
        streams[name] = [[t for t, _ in s_] for s_ in items]
        batcher.close()
        same = streams[name] == want
        log(f"{tag} {name} batcher ({engine.decode_path} T=1 attention), {m} requests of "
            f"{F32_TOKENS} tokens: token-identical to the Generator {same}")
        check(same, f"{tag} the {name} batcher's greedy streams differ from the Generator's")
    draft = first_layers(model, 1)
    batcher = ContinuousBatcher(engines["dense"], decode_block=8, spec_k=SPEC_K,
                                draft_engine=PipelineEngine(draft, **geometry))
    batcher.warm_up()
    items, _ = serve_on_this_thread(batcher, jobs + [(prompts[2], dict(max_tokens=16,
                                                                        want_logprobs=True))])
    got = [[t for t, _ in s_] for s_ in items]
    spec = batcher.spec_stats()
    batcher.close()
    log(f"{tag} draft engine (the first layer, K = {SPEC_K}) beside a logprobs request: "
        f"token-identical to plain greedy decode {got[:m] == want}; spec_stats {spec}")
    check(got[:m] == want and got[m] == want[2][:16],
          f"{tag} the draft engine's greedy streams differ from plain greedy decode's")
    check(spec["rounds"] > 0 and spec["fallback_ticks"] > 0,
          f"{tag} the draft engine ran no round or no fallback tick: {spec}")
    del draft, batcher

    # the new call sites against their plain versions
    def forwards():
        out = {}
        for name in ("dense", "gather"):
            engine = engines[name]
            if name == "dense":
                cache, table = engine.init_cache(), np.arange(m + 1, dtype=np.int32)[:, None]
            else:
                cache, table = engine.init_cache_paged()
                first = 0
                for slot, p in enumerate(prompts):  # the pages of the prompt and one step
                    n = -(-(len(p) + 1) // PAGE)
                    table[slot, :n] = np.arange(first, first + n)
                    first += n
            for slot, p in enumerate(prompts):
                for pos in range(0, len(p), CHUNK):
                    chunk = np.asarray(p[pos : pos + CHUNK], np.int64)
                    logits = engine.prefill_slot(np.pad(chunk, (0, CHUNK - chunk.size)), slot,
                                                 cache, chunk.size, table)
                out[name, "prefill", slot] = logits.float()
            active = [True, False, True]
            inputs = engine.device_inputs(("f32", name), table, active, cache.offsets, True)
            plan = engine.device_plan(inputs.offsets.long(), inputs, 1)
            tokens = torch.tensor([[65], [66], [67]], device=model.device)
            out[name, "decode"] = engine.decode_logits(tokens, cache, plan, 0).float()[[0, 2]]
        return out

    kern = forwards()
    with plain_entry_points():
        ref = forwards()
    worst = 0.0
    for key, value in kern.items():
        rel = ((value - ref[key]).norm() / ref[key].norm()).item()
        worst = max(worst, rel)
        check(bool(torch.isfinite(value).all()) and rel <= F32_LOGITS_RTOL,
              f"{tag} {key}: kernels against plain versions, relative L2 {rel:.3e}")
    log(f"{tag} the dense prefill chunks (kernel 1, kv_index) and one T=1 step of the dense and "
        f"gather engines (the T=1 route at per-slot lengths, one slot idle): logits against the "
        f"plain versions' within relative L2 {worst:.3e} (tol {F32_LOGITS_RTOL})")
    del engines, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"worst_rel_l2": worst, "spec": spec}


def phase_dense_batching(model, seed: int, single_stream_tok_s: float, lap) -> tuple:
    """Phase 10: the mix of phase 6 served through the port's server by the
    dense-slot batcher (``--concurrent 8``, no pool, async ticks), by the
    gather path (``--paged-pool 16 --paged-attention gather``) and by the
    dense batcher with a draft engine (the model's first ``DRAFT_LAYERS``
    layers, tensors shared; ``SPEC_K`` tokens a round; sync ticks), each
    as ``phase_batching`` serves a run (replays only, launches against the
    batcher's chunks, steps, rounds and replays); then the new call sites'
    kernels at the 8B shapes (``phase_slot_kernels``) and the f32 check
    (``phase_dense_f32``). Returns the served runs' launches of kernel 1 and
    its T=1 route, and the numbers."""
    launches = {"flash_attention": 0, "flash_decode": 0}
    stats = {}
    runs = (("dense", dict(pool=None)), ("gather", dict(paged_attention="gather")),
            ("draft engine", dict(pool=None, draft_model=first_layers(model, DRAFT_LAYERS))))
    for name, kw in runs:
        if name == "draft engine":
            kw["reference"] = stats["dense"]["greedy"]
        got, stats[name] = phase_batching(model, seed, "bf16", single_stream_tok_s,
                                          parity=False, **kw)
        for key in launches:
            launches[key] += got[key]
        lap(f"phase 10, {name}")
    stats["kernels"] = phase_slot_kernels(seed)
    stats["f32"] = phase_dense_f32(seed)
    lap("phase 10, kernels at the new call sites and the f32 check")
    return launches, stats


# ---------------------------------------- phase 11: the server's surfaces
# the prompt cache's Generator (8 prefill graphs, decode blocks of 8 as the
# server's --decode-block 8 makes them), its chat (a first user message of
# this many bytes, then two follow-ups, each turn's reply forced to this
# many 'A's), and the unforced hit and cold runs' tokens
SURFACE_MAX_SEQ = 2048
SURFACE_DECODE_BLOCK = 8
CHAT_FIRST = 1200
CHAT_REPLY = 32
CHAT_FOLLOW_UPS = ("Now say it again, shorter.", "Once more, and slower.")
HIT_TOKENS = 48
# kernel 1 at chunk starts off the chunk grid, over a cache whose rows past
# the chunk hold garbage of this scale
UNALIGNED_OFFSETS = (300, 1000)
STALE_SCALE = 64.0
# the traced batcher: 2 slots over the pages of 2 requests of this capacity;
# the traced request, and the shorter profiled one (its trace holds every
# kernel of its graphs' replays)
TRACE_MAX_SEQ = 1024
TRACE_PROMPT = 600
TRACE_TOKENS = 64
PROFILE_PROMPT = 200
PROFILE_TOKENS = 17
# the hot-swap checkpoints: the 8B config cut to this depth
SWAP_LAYERS = 2
SWAP_MAX_SEQ = 512
SWAP_ROPE_THETA = 10000.0  # the second checkpoint's RoPE base (the 8B's is 500000)


def get(port, path):
    """One GET: (status, body bytes, content type)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data, resp.getheader("Content-Type")


def metric_values(text: str) -> dict:
    """The samples of a ``/metrics`` scrape, keyed by name and labels."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            key, value = ln.rsplit(" ", 1)
            out[key] = float(value)
    return out


class served:
    """The port's server over ``provider`` on a thread for a ``with``
    block, which gets its port."""

    def __init__(self, provider, **kw):
        from mlx_sharding_tpu_torch.server.openai_api import make_server

        self.server = make_server(provider, "127.0.0.1", 0, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self.server.server_address[1]

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def chat_turns(port, gen, messages, force, prompt_len) -> tuple:
    """The three-turn chat through the prompt-cache server, each turn
    re-sending the history with the last turn's forced reply: per turn its
    TTFT, ``last_prefix_hit`` and prefill chunks (from the chunk boundary
    at or below the hit). Returns the rows and the messages so far."""
    rows = []
    for turn in range(1 + len(CHAT_FOLLOW_UPS)):
        if turn:
            messages = messages + [{"role": "assistant", "content": "A" * CHAT_REPLY},
                                   {"role": "user", "content": CHAT_FOLLOW_UPS[turn - 1]}]
        status, events, t_head, t_end = post(port, "/v1/chat/completions", {
            "messages": messages, "max_tokens": CHAT_REPLY, "stream": True,
            "logit_bias": force}, stream=True)
        check(status == 200 and stream_text(events, chat=True) == "A" * CHAT_REPLY,
              f"chat turn {turn + 1}: status {status}")
        n, hit = prompt_len(messages), gen.last_prefix_hit
        chunks = -(-(n - hit // CHUNK * CHUNK) // CHUNK)
        rows.append({"turn": turn + 1, "prompt": n, "hit": hit, "chunks": chunks,
                     "ttft_ms": t_head * 1e3})
        log(f"[surfaces] chat turn {turn + 1}: {n}-token prompt, last_prefix_hit {hit}, "
            f"{chunks} prefill chunks from position {hit // CHUNK * CHUNK}, TTFT "
            f"{t_head * 1e3:.1f} ms, {CHAT_REPLY} forced tokens in {t_end:.3f}s")
    check(rows[0]["hit"] == 0 and all(r["hit"] >= p["prompt"] for p, r in zip(rows, rows[1:])),
          "a chat turn did not reuse the previous turn's prompt")
    return rows, messages


def surface_prompt_cache(model) -> tuple:
    """The prompt-cache Generator behind the server: the chat, the hit turn
    against a cold run of the same prompt (unforced greedy, bf16: the first
    token where they part), no graph captured after ``warm_up`` and no
    eager forward, every replay and launch against the requests' chunks and
    blocks; then ``/metrics`` against the requests served, and the static
    UI. Returns the numbers and the served launches."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops.attention import flash_decode_on
    from mlx_sharding_tpu_torch.server.openai_api import STATIC_DIR, ModelProvider, convert_chat

    tag = "[surfaces]"
    tok = ByteTokenizer()
    gen = Generator(model, max_seq=SURFACE_MAX_SEQ, prefill_chunk=CHUNK, prompt_cache=True,
                    decode_block=SURFACE_DECODE_BLOCK)
    graph_line(tag, gen.warm_up())
    provider = ModelProvider(gen, tok, model_name="llama-3.1-8b-chat")
    words = ("pipeline stages pass activations over rings while the cache grows; "
             "every chunk of the prompt runs through the flash kernel. ")
    messages = [{"role": "user", "content": (words * 20)[:CHAT_FIRST]}]
    prompt_len = lambda msgs: len(tok.encode(convert_chat(msgs)))  # noqa: E731
    blocks = lambda n: -(-(n - 1) // SURFACE_DECODE_BLOCK)  # noqa: E731
    stats = {}
    with served(provider) as port:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"warm-up request failed: {status}")
        fa.flash_attention.launches = fa.flash_decode.launches = 0
        run = ServedRun(gen, model)
        turns, messages = chat_turns(port, gen, messages, {"65": 100.0}, prompt_len)
        chunks = sum(r["chunks"] for r in turns)
        steps = len(turns) * blocks(CHAT_REPLY)
        # the hit turn unforced, then the same prompt cold (a request of
        # another first byte between them empties the match)
        messages = messages + [{"role": "assistant", "content": "A" * CHAT_REPLY},
                               {"role": "user", "content": "And a last word?"}]
        ids, hits = {}, {}
        for name, first in (("hit", None), ("cold", "x")):
            if first is not None:
                status, _, _, _ = post(port, "/v1/completions", {"prompt": first,
                                                                  "max_tokens": 2})
                check(status == 200, f"the reset request: {status}")
                chunks, steps = chunks + 1, steps + blocks(2)
            status, body, _, t_end = post(port, "/v1/chat/completions", {
                "messages": messages, "max_tokens": HIT_TOKENS, "logprobs": 1})
            check(status == 200, f"the {name} run: status {status}: {body}")
            ids[name] = body["choices"][0]["logprobs"]["tokens"]
            hits[name] = gen.last_prefix_hit
            n = prompt_len(messages)
            chunks += -(-(n - hits[name] // CHUNK * CHUNK) // CHUNK)
            steps += blocks(HIT_TOKENS)
            log(f"{tag} the {name} run: {n}-token prompt, last_prefix_hit {hits[name]}, "
                f"{HIT_TOKENS} greedy tokens in {t_end:.3f}s")
        check(hits["hit"] >= turns[-1]["prompt"] and hits["cold"] == 0,
              f"hit / cold prefix hits {hits}")
        part = next((i for i, (a, b) in enumerate(zip(ids["hit"], ids["cold"])) if a != b), None)
        check(len(ids["hit"]) == len(ids["cold"]) == HIT_TOKENS, "hit / cold token counts")
        log(f"{tag} the hit turn against the cold run of the same prompt (bf16, greedy): "
            + ("token-identical for all {} tokens".format(HIT_TOKENS) if part is None else
               f"the first {part} tokens equal, then they part (a recomputed row's bf16 "
               "rounding)"))
        stats["first_divergence"] = part
        launches = {"flash_attention": fa.flash_attention.launches,
                    "flash_decode": fa.flash_decode.launches}
        layers = model.config.num_hidden_layers
        log(f"{tag} flash_attention launches {launches['flash_attention']}, expected {layers} x "
            f"{chunks} chunks = {layers * chunks}")
        check(launches["flash_attention"] == layers * chunks,
              "flash launches disagree with the prefill chunks from the hits")
        want = layers * SURFACE_DECODE_BLOCK * steps if flash_decode_on() else 0
        log(f"{tag} flash_decode launches {launches['flash_decode']}, expected {want}")
        check(launches["flash_decode"] == want, "flash_decode launches disagree with the steps")
        run.check(tag, chunks + steps)  # replays only: no capture after warm_up
        # /metrics against the requests served (the warm-up among them)
        status, text, ctype = get(port, "/metrics")
        values = metric_values(text.decode())
        served_prompts = ([len(tok.encode("warm up")), *(r["prompt"] for r in turns), 1,
                           2 * prompt_len(messages)])
        want = {"mst_requests_total": 2 + len(turns) + 2,
                "mst_prompt_tokens_total": sum(served_prompts),
                "mst_generation_tokens_total": 2 + len(turns) * CHAT_REPLY + 2 + 2 * HIT_TOKENS,
                "mst_requests_failed_total": 0}
        got = {k: int(values[k]) for k in want}
        log(f"{tag} /metrics ({ctype}): {got}; mst_ttft_seconds_count "
            f"{int(values['mst_ttft_seconds_count'])}, sum {values['mst_ttft_seconds_sum']:.3f} s")
        check(status == 200 and got == want, f"/metrics counters {got}, want {want}")
        status, body, ctype = get(port, "/")
        check(status == 200 and ctype == "text/html"
              and body == (STATIC_DIR / "index.html").read_bytes(), "GET / is not index.html")
        log(f"{tag} GET /: 200 {ctype}, the port's index.html ({len(body)} bytes)")
    stats["turns"] = turns
    del gen, provider
    return stats, launches


def unaligned_flash_check(seed: int) -> float:
    """Kernel 1 at chunk starts off the chunk grid (``UNALIGNED_OFFSETS``,
    a full chunk) at the 8B shapes, over a cache whose rows past the chunk
    hold garbage (``STALE_SCALE`` x normal): within ``kernel_disagreement``'s
    limits of its plain version, and bit-identical to the same call with
    those rows zero (they are never read). Returns the largest error."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    q, k, v = attention_inputs(gen, 1, CHUNK, MAX_SEQ, 32, 8, 128, 128, torch.bfloat16)
    scale = 128 ** -0.5
    worst_err = 0.0
    for offset in UNALIGNED_OFFSETS:
        end = offset + CHUNK
        for t in (k, v):
            t[:, end:] = (torch.randn(t[:, end:].shape, generator=gen, device="cuda")
                          * STALE_SCALE).to(t.dtype)
        got = fa.flash_attention(q, k, v, offset, scale)
        ref = fa.flash_attention_reference(q, k, v, offset, scale)
        k[:, end:] = 0
        v[:, end:] = 0
        clean = fa.flash_attention(q, k, v, offset, scale)
        torch.cuda.synchronize()
        err, worst, rel_l2 = kernel_disagreement(got, ref)
        same = torch.equal(got, clean)
        log(f"[kernels] flash_attention at the unaligned chunk start {offset} (T {CHUNK}), rows "
            f"past {end} stale: max_abs_err {err:.3e}, worst err/limit {worst:.3f} (tol 1), "
            f"relative L2 {rel_l2:.3e}; bit-identical with those rows zero {same}")
        check(worst <= 1 and rel_l2 <= REL_L2_TOL and same,
              f"flash_attention at offset {offset} over stale rows disagrees")
        worst_err = max(worst_err, err)
    return worst_err


def surface_tracing(model) -> tuple:
    """A traced batcher (``--trace on --trace-profile``; 2 slots, a pool of
    ``PAGE``-token pages) behind the server: one streamed request's spans
    from ``/admin/trace/<id>`` and their ``decode_tick`` sum against its
    wall time, its replays and launches against its chunks and steps, the
    batcher's ``/metrics`` and ``/health``; then the same request under
    ``--profile-dir``: the ``mst.decode_block`` ranges of the
    ``torch.profiler`` trace against the blocks dispatched (a shorter
    request: the trace holds every kernel its graphs replay). Returns the
    numbers and the traced request's launches."""
    from mlx_sharding_tpu_torch import tracing
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider

    tag = "[trace]"
    tracing.configure("on", profile=True)
    engine = PipelineEngine(model, microbatches=2, max_seq=TRACE_MAX_SEQ, prefill_chunk=CHUNK,
                            pool_pages=2 * TRACE_MAX_SEQ // PAGE, page_size=PAGE,
                            device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8)
    stats = {}
    try:
        graph_line(tag, batcher.warm_up(**GREEDY_ONLY))
        provider = ModelProvider(batcher, ByteTokenizer(), model_name="llama-3.1-8b-traced")
        body = {"prompt": mix_prompt(0, TRACE_PROMPT), "max_tokens": TRACE_TOKENS,
                "stream": True, "logit_bias": {"65": 100.0}}
        with served(provider) as port:
            status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up",
                                                             "max_tokens": 2})
            check(status == 200, f"warm-up request failed: {status}")
            pa.paged_attention.launches = fa.flash_attention.launches = 0
            fa.flash_decode.launches = 0
            run = ServedRun(batcher, engine)
            steps0, chunks0 = batcher.decode_steps, batcher.prefill_chunks
            status, events, t_head, t_end = post(port, "/v1/completions", body, stream=True)
            check(status == 200 and stream_text(events, chat=False) == "A" * TRACE_TOKENS,
                  f"traced request: status {status}")
            rid = events[0]["id"]
            launches = {"paged_attention": pa.paged_attention.launches,
                        "flash_attention": fa.flash_attention.launches,
                        "flash_decode": fa.flash_decode.launches}
            steps = batcher.decode_steps - steps0
            chunks = batcher.prefill_chunks - chunks0
            run.check(tag, chunks + steps // batcher.decode_block)
            layers = model.config.num_hidden_layers
            want = {"paged_attention": layers * steps, "flash_attention": layers * chunks,
                    "flash_decode": 0}
            log(f"{tag} launches {launches}, expected {want} ({layers} layers x {chunks} chunks "
                f"and {steps} decode steps)")
            check(launches == want, "launches disagree with the batcher's chunks and steps")
            status, data, _ = get(port, f"/admin/trace/{rid}")
            check(status == 200, f"/admin/trace/{rid}: {status}")
            spans = [e for e in json.loads(data)["traceEvents"] if e["ph"] == "X"]
            names = [e["name"] for e in spans]
            runs = []
            for name in names:
                if runs and runs[-1][0] == name:
                    runs[-1][1] += 1
                else:
                    runs.append([name, 1])
            tick_ms = sum(e["dur"] for e in spans if e["name"] == "decode_tick") / 1e3
            marks = [e["name"] for e in json.loads(data)["traceEvents"] if e["ph"] == "i"]
            log(f"{tag} /admin/trace/{rid}: spans "
                + ", ".join(f"{n} x{c}" if c > 1 else n for n, c in runs)
                + f"; marks {marks}; decode_tick spans sum {tick_ms:.1f} ms of the request's "
                f"{t_end * 1e3:.1f} ms wall (TTFT {t_head * 1e3:.1f} ms)")
            check({"queue_wait", "prefill", "decode_tick", "sse_write"} == set(names)
                  and marks == ["submit", "first_token", "finish"], "the request's timeline")
            stats.update(spans=runs, decode_tick_ms=tick_ms, wall_ms=t_end * 1e3)
            status, text, _ = get(port, "/metrics")
            values = metric_values(text.decode())
            keys = ("mst_batch_slots", "mst_scheduler_thread_live", "mst_itl_seconds_count",
                    "mst_queue_wait_seconds_count", "mst_kv_bytes_read_total",
                    'mst_decode_hbm_bytes_per_token{kind="weights"}',
                    'mst_tick_device_blocked_ms{path="async"}')
            log(f"{tag} /metrics: " + ", ".join(f"{k} {values[k]:g}" for k in keys))
            check(values["mst_requests_total"] == 2 and values["mst_scheduler_thread_live"] == 1,
                  "the batcher's /metrics")
        prof_dir = tempfile.mkdtemp(prefix="mst-profile-")
        with served(provider, profile_dir=prof_dir) as port:
            steps0 = batcher.decode_steps
            status, events, _, t_end = post(port, "/v1/completions", {
                **body, "prompt": mix_prompt(1, PROFILE_PROMPT), "max_tokens": PROFILE_TOKENS},
                stream=True)
            check(status == 200, f"profiled request: status {status}")
            blocks = (batcher.decode_steps - steps0) // batcher.decode_block
        (path,) = glob.glob(os.path.join(prof_dir, "trace-*.json"))
        with open(path) as f:
            trace_events = json.load(f)["traceEvents"]
        ranges = sum(1 for e in trace_events
                     if e.get("name") == "mst.decode_block" and e.get("cat") == "user_annotation")
        kernels = sum(1 for e in trace_events if e.get("cat") == "kernel")
        log(f"{tag} --profile-dir --trace-profile: the request's torch.profiler trace "
            f"({os.path.getsize(path) / 1e6:.1f} MB, {kernels} kernels) holds {ranges} "
            f"mst.decode_block ranges for the {blocks} decode blocks it dispatched "
            f"({t_end:.3f}s under the profiler)")
        check(ranges == blocks > 0, "mst.decode_block ranges disagree with the blocks")
        stats["profile_ranges"] = ranges
        shutil.rmtree(prof_dir)
    finally:
        tracing.configure("off")
        batcher.close()
    return stats, launches


def write_llama_checkpoint(model, config: dict, path: str) -> None:
    """``model``'s weights under their Hugging Face names, with ``config``,
    as a checkpoint directory that the port's loader reads."""
    from mlx_sharding_tpu_torch.loading import write_safetensors

    os.makedirs(path)
    layer_names = {ours: hf for hf, ours in type(model).HF_LAYER_MAP.items()}
    other = {"embed_tokens.weight": "model.embed_tokens.weight", "final_norm": "model.norm.weight",
             "lm_head.weight": "lm_head.weight"}
    tensors = {}
    for name, t in model.state_dict().items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            tensors[f"model.layers.{i}.{layer_names[rest]}"] = t
        else:
            tensors[other[name]] = t
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)


def surface_hot_swap(seed: int) -> dict:
    """Model hot-swap by request name: a ``SWAP_LAYERS``-layer checkpoint of
    the 8B config (another seed) written to a temporary directory, and a
    second checkpoint beside it that hard-links its weights file under
    another RoPE base (``SWAP_ROPE_THETA``), so it answers otherwise without
    a second write; a provider loads the first as from its ``--model``, a
    request naming the second swaps it in, one naming the first swaps it
    back and answers as before. Each load's seconds and
    ``torch.cuda.memory_allocated`` after it: the replaced generator is
    released."""
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider

    tag = "[swap]"
    config = {**LLAMA_31_8B, "num_hidden_layers": SWAP_LAYERS}
    tmp = tempfile.mkdtemp(prefix="mst-swap-")
    stats = {"loads": []}
    try:
        t0 = time.perf_counter()
        paths = [os.path.join(tmp, f"llama-3.1-8b-{SWAP_LAYERS}-layers-{i}") for i in range(2)]
        m, _ = build_model(config, dtype=torch.bfloat16)
        m.init_params(torch.Generator(device="cuda").manual_seed(seed + 41), "cuda")
        write_llama_checkpoint(m, config, paths[0])
        del m
        os.makedirs(paths[1])
        weights = [os.path.join(p, "model.safetensors") for p in paths]
        try:
            os.link(*weights)
        except OSError:  # a file system without hard links: a copy
            shutil.copyfile(*weights)
        with open(os.path.join(paths[1], "config.json"), "w") as f:
            json.dump({**config, "rope_theta": SWAP_ROPE_THETA}, f)
        size = os.path.getsize(os.path.join(paths[0], "model.safetensors"))
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        log(f"{tag} a {SWAP_LAYERS}-layer checkpoint of the 8B config written ({size / 1e9:.2f} "
            f"GB) and a second over the same weights file with rope_theta {SWAP_ROPE_THETA} in "
            f"{time.perf_counter() - t0:.1f}s; memory_allocated before loading "
            f"{base / 1e9:.2f} GB")
        provider = ModelProvider.from_checkpoint(
            paths[0], trust_remote_paths=True, tokenizer_loader=lambda _: ByteTokenizer(),
            device="cuda", max_seq=SWAP_MAX_SEQ, prefill_chunk=CHUNK)

        def loaded(what):
            gc.collect()
            mem = torch.cuda.memory_allocated()
            stats["loads"].append((what, provider.load_seconds, mem))
            log(f"{tag} {what}: loaded in {provider.load_seconds:.2f}s (weights, generator, "
                f"graphs); memory_allocated {mem / 1e9:.2f} GB ({(mem - base) / 1e9:.2f} GB "
                "over the rest of the run)")

        loaded(f"load of {os.path.basename(paths[0])} (--model)")
        answers = []
        with served(provider) as port:
            for i, name in enumerate((paths[0], paths[1], paths[0])):
                status, body, _, t_end = post(port, "/v1/completions", {
                    "prompt": "swap the model", "max_tokens": 8, "logprobs": 1, "model": name})
                check(status == 200, f"request naming {name}: {status}: {body}")
                answers.append(body["choices"][0]["logprobs"]["tokens"])
                if i:
                    loaded(f"swap to {os.path.basename(name)} by a request ({t_end:.2f}s "
                           "with its answer)")
        check(answers[0] == answers[2], "the swap back answers otherwise")
        check(answers[0] != answers[1], "both checkpoints answer alike: no swap happened")
        mems = [m for _, _, m in stats["loads"]]
        check(max(mems) - min(mems) <= 0.05 * (max(mems) - base),
              "memory grew across swaps: a replaced generator was kept")
        del provider
    finally:
        shutil.rmtree(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def prompt_cache_f32(seed: int) -> dict:
    """The prompt cache in f32 at the 8B widths and ``F32_LAYERS`` layers: a
    first request, then one that re-sends it with its reply and more; the
    hit request's greedy stream token-identical to a cold Generator's."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.models import build_model

    tok = ByteTokenizer()
    model, _ = build_model({**LLAMA_31_8B, "num_hidden_layers": F32_LAYERS},
                           dtype=torch.float32)
    model.init_params(torch.Generator(device="cuda").manual_seed(seed + 51), "cuda")
    cached = Generator(model, max_seq=F32_MAX_SEQ, prefill_chunk=CHUNK, prompt_cache=True)
    cached.warm_up()
    cold = Generator(model, max_seq=F32_MAX_SEQ, prefill_chunk=CHUNK)
    first = tok.encode(mix_prompt(3, 500))
    reply = [t for t, _ in cached.generate_step(first, max_tokens=F32_TOKENS)]
    prompt = first + reply + tok.encode(" and then?")
    got = [t for t, _ in cached.generate_step(prompt, max_tokens=F32_TOKENS)]
    want = [t for t, _ in cold.generate_step(prompt, max_tokens=F32_TOKENS)]
    hit = cached.last_prefix_hit
    log(f"[surfaces-f32] {F32_LAYERS} layers at the 8B widths: the hit request "
        f"({len(prompt)}-token prompt, last_prefix_hit {hit}, prefill from {hit // CHUNK * CHUNK}) "
        f"{'token-identical to' if got == want else 'differs from'} a cold Generator over "
        f"{F32_TOKENS} greedy tokens")
    check(hit >= len(first) and got == want, "the f32 hit stream differs from the cold one")
    return {"hit": hit, "prompt": len(prompt)}


def phase_surfaces(model, seed: int, lap) -> tuple:
    """Phase 11: the server's single-host surfaces on phase 4's model
    (``surface_prompt_cache``, ``unaligned_flash_check``,
    ``surface_tracing``, ``surface_hot_swap``, ``prompt_cache_f32``).
    Returns the served runs' launches per kernel, and the numbers."""
    stats, launches = surface_prompt_cache(model)
    lap("phase 11, the prompt cache, /metrics and the static UI")
    stats["unaligned_err"] = unaligned_flash_check(seed)
    stats["trace"], traced = surface_tracing(model)
    for key, n in traced.items():
        launches[key] = launches.get(key, 0) + n
    lap("phase 11, kernel 1 at unaligned starts, tracing and profiling")
    stats["swap"] = surface_hot_swap(seed)
    stats["f32"] = prompt_cache_f32(seed)
    lap("phase 11, hot-swap and the f32 check")
    return launches, stats


# ------------------------------------------------------------- KV movement
KV_POOL = 12  # pages of the round trips' pools (and the scratch)
KV_EXPORT = (1, 5, 7, 9)  # the pages exported ...
KV_IMPORT = (0, 2, 3, 11)  # ... and the pages they are imported into
KV_LENGTHS = (1024, 700, 513, 1)  # kernel 2's slots over the 4 pages
SPILL_LAYERS = 8  # the int8 spill runs' and the cold slot's depth cut (full width)
SPILL_TOKENS = 96  # each parity prompt's tokens in the spill runs
SPILL_BYTES = 4 << 30
COLD_AFTER = 4
COLD_JOB = (600, 64)  # its prompt and tokens; its reader stops after 8 for 10 ticks
STORE_SLOTS = 4
STORE_PREFIX = 1024  # the shared system prompt: four 256-token pages
STORE_SUFFIX = 100
STORE_TOKENS = 32
STORE_BYTES = 160 << 20  # holds one 4-page block of the 8B (128 MiB), not two
# the spill runs' decode blocks: greedy, and the seeded request's (sampled,
# no logprobs)
SPILL_BLOCKS = {"blocks": ((False, False), (True, False))}


def fill_pool(cache, gen, kv_dtype) -> None:
    """Random K/V in every page of a pool (an MLA pool's dummy V stays
    zero); an int8 pool quantized with the port's ``quantize_kv_rows``."""
    from mlx_sharding_tpu_torch.cache import quantize_kv_rows

    for name in ("k", "v"):
        buf = getattr(cache, name)
        data = buf["d"] if kv_dtype == "int8" else buf
        if name == "v" and data.shape[-1] == 1:
            continue  # the compressed MLA cache's dummy values
        rows = torch.randn(data.shape, generator=gen, device="cuda")
        if kv_dtype == "int8":
            q = quantize_kv_rows(rows)
            buf["d"].copy_(q["d"])
            buf["s"].copy_(q["s"])
        else:
            buf.copy_(rows)
        del rows


def kv_roundtrip(tag: str, gen, layers: int, heads: int, dims, kv_dtype: str, hq: int,
                 scale: float, codec=None, values_from_k=None) -> dict:
    """One page-block round trip at full width: export ``KV_EXPORT`` (the
    gather), flush it to pinned host memory (compressed by ``codec``),
    stage it back (the prefetch), import it into ``KV_IMPORT`` (the
    scatter); the imported pages bit-identical to the originals, and
    kernel 2 over them bit-identical to kernel 2 over the originals. Each
    copy timed on its own: a first block warms the pinned and device
    allocations, the second is timed."""
    from mlx_sharding_tpu_torch import kv_transfer as kvt
    from mlx_sharding_tpu_torch.cache import export_pool_pages, import_pool_pages
    from mlx_sharding_tpu_torch.cache import init_cache_paged, is_quantized_kv, layer_pool
    from mlx_sharding_tpu_torch.kv_compress import tree_leaves
    from mlx_sharding_tpu_torch.ops import paged_attention as pa

    cache = init_cache_paged(layers, KV_POOL, PAGE, heads, dims, len(KV_LENGTHS),
                             torch.bfloat16, "cuda", quantized=kv_dtype == "int8")
    fill_pool(cache, gen, kv_dtype)
    src = torch.tensor(KV_EXPORT, device="cuda")
    dst = torch.tensor(KV_IMPORT, device="cuda")
    gather_ms = time_ms(lambda: export_pool_pages(cache, src))

    def export():
        return kvt.export_block(cache, KV_EXPORT, page_size=PAGE, n_tokens=len(KV_EXPORT) * PAGE,
                                prompt=[0], history=[1], produced=1, resume_gen=None,
                                resume_recent=None, codec=codec)

    export().to_host().prefetch()  # the warm-up block
    block = export()
    raw = block.nbytes
    # the copies alone, device time on the current stream: the exported
    # pages into pinned host tensors, and back
    dev_leaves = tree_leaves((block.k_pages, block.v_pages))
    host_leaves = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in dev_leaves]
    d2h_ms = time_ms(lambda: [h.copy_(t, non_blocking=True)
                              for h, t in zip(host_leaves, dev_leaves)], iters=5)
    h2d_ms = time_ms(lambda: [t.copy_(h, non_blocking=True)
                              for h, t in zip(host_leaves, dev_leaves)], iters=5)
    del host_leaves, dev_leaves
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block.to_host()  # the copy, the compression, the checksum
    flush_s = time.perf_counter() - t0
    wire = block.nbytes
    t0 = time.perf_counter()
    block.prefetch(codec=codec)
    block._staged_event.synchronize()
    stage_s = time.perf_counter() - t0
    k_pages, v_pages, _ = block.payload()
    scatter_ms = time_ms(lambda: import_pool_pages(cache, k_pages, v_pages, dst))
    torch.cuda.synchronize()
    for leaf in tree_leaves((cache.k, cache.v)):
        leaf[:, dst] = 0  # the import must write every byte back
    kvt.import_block(cache, block, KV_IMPORT, codec=codec)
    torch.cuda.synchronize()
    same = all(torch.equal(leaf[:, src], leaf[:, dst]) for leaf in tree_leaves((cache.k, cache.v)))
    # kernel 2 over the originals and over the imported pages, per layer
    # 0 and the last: four slots of lengths KV_LENGTHS over the four pages
    m = len(KV_LENGTHS)
    lengths = torch.tensor(KV_LENGTHS, dtype=torch.int32, device="cuda")
    dk = tree_leaves(cache.k)[0].shape[-1]
    q = torch.randn((m, hq, dk), generator=gen, device="cuda").to(torch.bfloat16)
    equal_out = True
    for layer in (0, layers - 1):
        kl, vl = layer_pool(cache.k, layer), layer_pool(cache.v, layer)
        quant = is_quantized_kv(kl)
        outs = []
        for pages in (KV_EXPORT, KV_IMPORT):
            tables = torch.tensor([pages] * m, dtype=torch.int32, device="cuda")
            outs.append(pa.paged_attention(
                q, kl["d"] if quant else kl, vl["d"] if quant else vl, tables, lengths, scale,
                values_from_k=values_from_k, k_scale=kl["s"] if quant else None,
                v_scale=vl["s"] if quant else None))
        torch.cuda.synchronize()
        equal_out &= torch.equal(*outs) and bool(torch.isfinite(outs[0]).all())
    pages = len(KV_EXPORT)
    out = {"bytes_per_page": raw / pages, "wire_bytes_per_page": wire / pages,
           "gather_ms": gather_ms, "scatter_ms": scatter_ms, "d2h_ms": d2h_ms,
           "h2d_ms": h2d_ms, "d2h_gb_s": raw / d2h_ms / 1e6, "h2d_gb_s": raw / h2d_ms / 1e6,
           "flush_ms": flush_s * 1e3, "stage_ms": stage_s * 1e3, "kind": block.compress_kind}
    log(f"{tag} {kv_dtype} pool, {layers} layers x {heads} KV heads x {dims}: "
        f"{out['bytes_per_page']:.0f} bytes a page ({out['wire_bytes_per_page']:.0f} on the "
        f"wire{', ' + block.compress_kind + ' codec' if block.compress_kind else ''}); "
        f"{pages} pages: gather {gather_ms:.4f} ms, device-to-host copy into pinned memory "
        f"{d2h_ms:.3f} ms ({out['d2h_gb_s']:.2f} GB/s), host-to-device copy "
        f"{h2d_ms:.3f} ms ({out['h2d_gb_s']:.2f} GB/s), scatter {scatter_ms:.4f} ms (device "
        f"time, L2 flushed); to_host (copy, codec, checksum) {out['flush_ms']:.3f} ms and the "
        f"prefetch's stage {out['stage_ms']:.3f} ms of wall time; {card_line()}")
    log(f"{tag} imported pages bit-identical to the exported ones: {same}; kernel 2 "
        f"(values_from_k {values_from_k}) over them bit-identical to over the originals "
        f"(layers 0 and {layers - 1}, lengths {KV_LENGTHS}): {equal_out}")
    check(same, f"{tag} the imported pages differ from the exported ones")
    check(equal_out, f"{tag} kernel 2 over the imported pages differs")
    del cache, block, k_pages, v_pages
    return out


def first_divergence(got: list, want: list):
    """The index of the first token where two streams part, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def spill_runs(model, kv_dtype: str, tag: str) -> dict:
    """Phase 6's parity mix (``PARITY_PROMPTS``, ``SPILL_TOKENS`` each, five
    greedy and a seeded one) served on this thread over ``POOL_PAGES`` pages
    four ways: reserve admission (no preemption), overcommit that discards
    and re-prefills (bf16 only), and overcommit that spills with prefetch on
    and off (bf16; on only for int8). Each preempted stream's first
    divergence from its reserve run, the spill counters, and the resume's
    host wait per import with prefetch on and off."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tok = ByteTokenizer()
    jobs = [(tok.encode(mix_prompt(60 + i, n)), dict(max_tokens=SPILL_TOKENS))
            for i, n in enumerate(PARITY_PROMPTS[:-1])]
    jobs.append((tok.encode(mix_prompt(70, PARITY_PROMPTS[-1])),
                 dict(max_tokens=SPILL_TOKENS, temperature=0.8, top_p=0.9, seed=77)))
    ways = [("reserve", {})]
    if kv_dtype == "bf16":
        ways.append(("discard", dict(overcommit=True)))
    ways.append(("spill", dict(overcommit=True, spill_bytes=SPILL_BYTES, kv_prefetch="on")))
    if kv_dtype == "bf16":
        ways.append(("spill-demand", dict(overcommit=True, spill_bytes=SPILL_BYTES,
                                          kv_prefetch="off")))
    runs, out = {}, {}
    for name, kw in ways:
        engine = PipelineEngine(model, microbatches=SLOTS, max_seq=PARITY_MAX_SEQ,
                                prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                                kv_dtype=kv_dtype, device=model.device)
        batcher = ContinuousBatcher(engine, decode_block=8, **kw)
        if batcher.spill is not None:
            # the flush at the preemption, on this thread: every resume then
            # finds its block on the host (a request that waits longer than
            # a flush, ~0.3 s here, does), so that prefetch on and off
            # compare a stage against a demand copy
            batcher.spill._flush_async = False
        batcher.warm_up(**SPILL_BLOCKS)
        items, reqs = serve_on_this_thread(batcher, jobs)
        runs[name] = [[t for t, _ in s] for s in items]
        s = batcher.spill_stats()
        t = batcher.tick_timing_stats()
        imports = s["spill_hits"]
        blocked = t["kv_import_s_total"] * 1e3 / imports if imports else 0.0
        preempted = [i for i, r in enumerate(reqs) if r.preempted_at]
        div = {i: first_divergence(runs[name][i], runs["reserve"][i]) for i in preempted}
        log(f"{tag} {name}: {s['preemptions']} preemptions (streams {preempted}, at tokens "
            f"{[reqs[i].preempted_at for i in preempted]}), {s['spills']} spills, "
            f"{s['spill_hits']} spill hits, {s['spill_fallbacks']} fallbacks, "
            f"{s['reprefill_tokens']} tokens re-prefilled; prefetches {s['prefetches']}, "
            f"staged imports {s['prefetch_hits']}, demand imports {s['demand_imports']}; the "
            f"resume's host wait in import_block {blocked:.3f} ms an import "
            f"({imports} imports); first divergence from the reserve run per preempted "
            f"stream {div} (None: equal)")
        out[name] = {"stats": s, "blocked_ms": blocked, "divergence": div,
                     "streams_equal": runs[name] == runs["reserve"]}
        batcher.close()
        del batcher, engine
        if name != "reserve":
            check(s["preemptions"] >= 1, f"{tag} {name}: nothing was preempted")
        if name.startswith("spill"):
            check(s["spills"] >= 1 and s["spill_hits"] == s["spills"]
                  and s["spill_fallbacks"] == 0 and s["reprefill_tokens"] == 0,
                  f"{tag} {name}: {s}")
            # greedy streams resumed from their own K/V are the uninterrupted
            # ones, bf16 and int8 alike (the seeded one draws as alone too)
            check(runs[name] == runs["reserve"], f"{tag} {name}: a resumed stream differs "
                  f"from its reserve run: {div}")
    if kv_dtype == "bf16":
        on, off = out["spill"]["stats"], out["spill-demand"]["stats"]
        check(on["prefetch_hits"] >= 1 and off["demand_imports"] >= 1,
              f"{tag} prefetch on {on}, off {off}")
    return out


def cold_spill_run(model, tag: str) -> dict:
    """One stream whose reader stops after 8 tokens for 10 ticks, with
    ``--spill-cold-after 4``: its slot spills and parks, wakes when the
    reader comes back, and the stream equals the same request unheld."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tok = ByteTokenizer()
    job = (tok.encode(mix_prompt(80, COLD_JOB[0])), dict(max_tokens=COLD_JOB[1]))
    engine = PipelineEngine(model, microbatches=2, max_seq=PARITY_MAX_SEQ, prefill_chunk=CHUNK,
                            pool_pages=POOL_PAGES, page_size=PAGE, device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8, spill_bytes=SPILL_BYTES,
                                spill_cold_after=COLD_AFTER)
    batcher.warm_up(**GREEDY_ONLY)
    plain = [t for t, _ in serve_on_this_thread(batcher, [job])[0][0]]
    held = [t for t, _ in serve_on_this_thread(batcher, [job], hold=(0, 8, 10))[0][0]]
    s = batcher.spill_stats()
    log(f"{tag} cold slot: reader stops after 8 tokens for 10 ticks, spill_cold_after "
        f"{COLD_AFTER}: {s['cold_spills']} cold spills, {s['cold_wakes']} wakes, "
        f"{s['spill_hits']} imports ({s['prefetch_hits']} staged); the resumed stream equals "
        f"the unheld one: {held == plain}")
    check(s["cold_spills"] >= 1 and s["cold_wakes"] == s["cold_spills"] and held == plain,
          f"{tag} cold-slot spill: {s}")
    batcher.close()
    return {"cold_spills": s["cold_spills"], "wakes": s["cold_wakes"]}


def store_runs(model, tag: str, seed: int) -> dict:
    """The prefix store at full depth: requests sharing a 1,024-token system
    prompt, one at a time (but two at once), through a ``STORE_SLOTS``-slot
    batcher whose host tier holds one demoted prefix. A cold request
    registers the prefix, its finish demotes it; the same request again
    imports it (host hit) and equals the cold stream; two more lease it
    (host hit, then a device hit while the first decodes); another prefix
    evicts it from the tier; the first request once more runs cold and
    equals itself. Each request's TTFT, the hits by kind; then kernel 1 at
    the chunk after the hit (offset 1024) over the imported pages' rows
    against its plain version."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.prefix_store import PrefixStore
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tok = ByteTokenizer()
    system = tok.encode(mix_prompt(90, STORE_PREFIX))
    other = tok.encode(mix_prompt(91, STORE_PREFIX))
    ask = lambda i: tok.encode(mix_prompt(92 + i, STORE_SUFFIX))  # noqa: E731
    store = PrefixStore(host_bytes=STORE_BYTES)
    engine = PipelineEngine(model, microbatches=STORE_SLOTS, max_seq=PARITY_MAX_SEQ,
                            prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                            device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8, prefix_store=store)
    batcher.warm_up(**GREEDY_ONLY)
    ttfts, streams = [], []

    def start(prompt, tokens=STORE_TOKENS):
        t0 = time.perf_counter()
        stream = batcher.generate_step(prompt, max_tokens=tokens)
        first = next(stream)[0]
        ttfts.append((time.perf_counter() - t0) * 1e3)
        return first, stream

    def settle():
        # the demotion's copy to the host runs on the tier's flusher
        deadline = time.monotonic() + 10
        while store._host.stats()["blocks_host"] < store._host.stats()["blocks"] \
                and time.monotonic() < deadline:
            time.sleep(0.005)

    def one(prompt, tokens=STORE_TOKENS):
        first, stream = start(prompt, tokens)
        streams.append([first] + [t for t, _ in stream])
        settle()

    try:
        one(system + ask(0))  # cold: registers, then demotes
        one(system + ask(0))  # host hit: imported, equals the cold stream
        first, long_stream = start(system + ask(1), tokens=4 * STORE_TOKENS)  # host hit
        one(system + ask(2))  # device hit: leases the pages the first still holds
        streams.append([first] + [t for t, _ in long_stream])
        settle()
        one(other + ask(3))  # another prefix: its demotion evicts the first
        one(system + ask(0))  # cold again
        s = store.stats()
    finally:
        batcher.close()
    log(f"{tag} prefix store ({STORE_PREFIX}-token system prompt, host tier "
        f"{STORE_BYTES >> 20} MiB: one 4-page block): TTFT by request "
        f"{[round(t, 1) for t in ttfts]} ms (cold, host hit, host hit, device hit, other "
        f"prefix cold, cold after eviction); hits device {s['hits_device']}, host "
        f"{s['hits_host']}, misses {s['misses']}; demotions {s['demotions']}, evictions by "
        f"budget {s['evictions_budget']}; imports staged {s['imports_staged']}, demand "
        f"{s['imports_demand']}; tokens reused {s['tokens_reused']}; the host hit's stream "
        f"equals the cold one: {streams[1] == streams[0]}; the cold run after eviction too: "
        f"{streams[5] == streams[0]}; {card_line()}")
    check(streams[1] == streams[0] and streams[5] == streams[0],
          f"{tag} a store hit's stream differs from the cold run's")
    check(s["hits_host"] >= 2 and s["hits_device"] >= 1 and s["demotions"] >= 2
          and s["evictions_budget"] >= 1, f"{tag} store stats {s}")
    # kernel 1 at the chunk after a hit: its keys 0..1023 are the imported
    # rows of layer 0 (the pages of the last demoted block, staged)
    digest = store.digests_for(system + ask(0))[-1]
    block = store.host_block(digest)
    block.prefetch(device="cuda")
    k_pages, v_pages, event = block.payload()
    event.synchronize()
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    cfg = model.config
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // hq
    s_len = STORE_PREFIX + CHUNK
    k = torch.randn((1, s_len, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((1, s_len, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    k[0, :STORE_PREFIX] = k_pages[0].reshape(STORE_PREFIX, hkv, d)
    v[0, :STORE_PREFIX] = v_pages[0].reshape(STORE_PREFIX, hkv, d)
    q = torch.randn((1, CHUNK, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    scale = d ** -0.5
    err = family_check(f"flash_attention after a store hit, offset {STORE_PREFIX}, keys from "
                       f"the imported pages", fa.flash_attention(q, k, v, STORE_PREFIX, scale),
                       fa.flash_attention_reference(q, k, v, STORE_PREFIX, scale))
    store.close()
    return {**s, "ttft_ms": ttfts, "flash_err": err}


def phase_kv_movement(model, seed: int, lap) -> dict:
    """Phase 12: KV movement on phase 4's model. Page-block round trips at
    full width (bf16 and int8 pools of the 8B, and DeepSeek-Coder-V2-Lite's
    compressed MLA pool through the latent codec); the spill tier under
    overcommit against reserve admission (bf16 at full depth, with the
    discard path and prefetch off beside it; int8 cut to ``SPILL_LAYERS``
    layers); a cold slot's spill and wake (cut); the prefix store at full
    depth."""
    from mlx_sharding_tpu_torch.kv_compress import build_codec
    from mlx_sharding_tpu_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(seed + 120)
    cfg = model.config
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // hq
    stats = {"roundtrip": {}}
    for kv_dtype in ("bf16", "int8"):
        stats["roundtrip"][kv_dtype] = kv_roundtrip("[kv-move]", gen, cfg.num_hidden_layers,
                                                    hkv, d, kv_dtype, hq, d ** -0.5)
    lite, lite_cfg = build_model(DSV2_LITE)  # on the meta device: its geometry alone
    codec = build_codec(lite, paged=True, kv_quant=False, num_stages=1,
                        pool_layers=lite_cfg.num_hidden_layers)
    check(codec is not None and codec.mode == "latent", "the Lite's pool got no latent codec")
    stats["roundtrip"]["mla"] = kv_roundtrip(
        "[kv-move]", gen, lite_cfg.num_hidden_layers, lite.cache_num_heads(),
        lite.cache_head_dim(), "bf16", lite_cfg.num_attention_heads, lite.scale, codec=codec,
        values_from_k=MLA_DV)
    del lite
    lap("phase 12, page-block round trips")
    # bf16 at full depth (the discard path parts from the reserve run at
    # full depth; cut, it may not); int8 and the cold slot cut to
    # SPILL_LAYERS
    stats["spill_bf16"] = spill_runs(model, "bf16", "[kv-spill-bf16]")
    cut = first_layers(model, SPILL_LAYERS)
    stats["spill_int8"] = spill_runs(cut, "int8", f"[kv-spill-int8-{SPILL_LAYERS}L]")
    stats["cold"] = cold_spill_run(cut, f"[kv-cold-{SPILL_LAYERS}L]")
    del cut
    lap("phase 12, spill, prefetch and cold slots")
    stats["store"] = store_runs(model, "[kv-store]", seed)
    lap("phase 12, the prefix store")
    return stats


# ----------------------------------------------------------------- phase 13
SHARE_NUM = 8  # layer pairs merged by the calibration: 32 layers -> 24 groups
SHARE_MAX_GROUP = 2
SHARE_CALIB = (300, 200, 100)  # the calibration prompts' tokens
SHARE_PARITY_TOKENS = 24  # phase 6's greedy request under the identity map, eagerly
SHARE_BLOCK_JOBS = ((200, 64), (150, 64), (100, 64))  # decoding when the block is checked
REPLICAS = 2
DRAIN_STREAMS = 4
DRAIN_PROMPT = 300
DRAIN_TOKENS = 160  # each long greedy stream's tokens
DRAIN_AFTER = 16  # the drain is posted once every stream has this many
BREAKER_FAILS = 3  # the ReplicaSet's default breaker threshold
PROBE_S = 1.0  # the breaker's probe interval in this phase (5 s by default)


def share_pool_bytes(model, share) -> dict:
    """The pool of phase 6's geometry unshared, under the identity map and
    under ``share``: its bytes from ``torch.cuda.memory_allocated`` around
    the allocation, the pool's own count, and ``kv_share_stats()``."""
    from mlx_sharding_tpu_torch.kv_share import KVShareMap
    from mlx_sharding_tpu_torch.parallel import PipelineEngine

    out = {}
    layers = model.config.num_hidden_layers
    for name, m in (("unshared", None), ("identity", KVShareMap.identity(layers)),
                    ("map", share)):
        eng = PipelineEngine(model, microbatches=SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                             pool_pages=POOL_PAGES, page_size=PAGE, kv_share_map=m,
                             device=model.device)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        cache, _ = eng.init_cache_paged()
        torch.cuda.synchronize()
        out[name] = {"allocated": torch.cuda.memory_allocated() - before, "nbytes": cache.nbytes,
                     "stats": eng.kv_share_stats()}
        del cache, eng
        log(f"[share] pool of {POOL_PAGES} + 1 pages of {PAGE} tokens, {name}: "
            f"{out[name]['allocated']} bytes allocated ({out[name]['nbytes']} in the pool's "
            f"tensors); kv_share_stats {out[name]['stats']}")
    ratio = out["map"]["nbytes"] / out["unshared"]["nbytes"]
    want = share.num_groups / layers
    log(f"[share] pool bytes under the map / unshared = {ratio:.4f} (groups / layers = "
        f"{share.num_groups}/{layers} = {want:.4f}); bytes saved by the map "
        f"{out['map']['stats']['bytes_saved']}")
    check(out["identity"]["nbytes"] == out["unshared"]["nbytes"]
          and out["identity"]["allocated"] == out["unshared"]["allocated"],
          "the identity map's pool differs from the unshared one")
    check(abs(ratio - want) < 1e-9 and out["map"]["allocated"] < out["unshared"]["allocated"],
          "the pool under the map is not groups / layers of the unshared one")
    check(out["map"]["stats"]["bytes_saved"]
          == out["unshared"]["nbytes"] - out["map"]["nbytes"], "kv_share_stats' bytes_saved")
    return out


def share_identity_parity(model, identity) -> int:
    """Phase 6's greedy request and the mix's first prompt, eagerly through
    an unshared batcher and one under the identity map: their streams
    bit-identical."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tok = ByteTokenizer()
    jobs = [(tok.encode(mix_prompt(len(BATCH_MIX), GREEDY_PROMPT)),
             {"max_tokens": SHARE_PARITY_TOKENS}),
            (tok.encode(mix_prompt(0, BATCH_MIX[0][0])), {"max_tokens": SHARE_PARITY_TOKENS})]
    streams = []
    for m in (None, identity):
        eng = PipelineEngine(model, microbatches=SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                             pool_pages=POOL_PAGES, page_size=PAGE, kv_share_map=m,
                             device=model.device)
        batcher = ContinuousBatcher(eng, decode_block=8, cuda_graphs=False, async_sched="off")
        items, _ = serve_on_this_thread(batcher, jobs)
        streams.append([[t for t, _ in s] for s in items])
        batcher.close()
        del batcher, eng
    same = streams[0] == streams[1]
    log(f"[share] identity map: phase 6's greedy request and a 40-token prompt, "
        f"{SHARE_PARITY_TOKENS} tokens each, eagerly: bit-identical to the unshared engine's "
        f"{same}")
    check(same, "the identity map's streams differ from the unshared engine's")
    return len(jobs) * SHARE_PARITY_TOKENS


def share_kernel_checks(gen, share, model) -> dict:
    """Kernels 1 and 2 over a share-group pool of phase 6's geometry (bf16
    and int8): kernel 2 over the group buffer of a non-owner layer at the
    mix's first decode step, kernel 1's chunk at offset 256 over a view
    gathered from that buffer, each held to its plain version."""
    from mlx_sharding_tpu_torch.cache import init_cache_paged, kv_data, layer_pool
    from mlx_sharding_tpu_torch.ops.flash_attention import flash_attention, \
        flash_attention_reference
    from mlx_sharding_tpu_torch.ops.paged_attention import paged_attention, \
        paged_attention_reference
    from mlx_sharding_tpu_torch.parallel import PipelineEngine

    cfg = model.config
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // hq
    layer = share.owner_mask.index(False)  # the first non-owner layer
    g = share.group_of[layer]
    errs = {}
    for kv_dtype in ("bf16", "int8"):
        cache = init_cache_paged(share.num_groups, POOL_PAGES, PAGE, hkv, d, SLOTS,
                                 torch.bfloat16, "cuda", quantized=kv_dtype == "int8")
        fill_pool(cache, gen, kv_dtype)
        kp, vp = layer_pool(cache.k, g), layer_pool(cache.v, g)
        quant = kv_dtype == "int8"
        lengths = PAGED_TIMING_LENGTHS
        spg = MAX_SEQ // PAGE
        tables = torch.full((SLOTS, spg), POOL_PAGES, dtype=torch.int32)
        order = torch.randperm(POOL_PAGES, generator=torch.Generator().manual_seed(13))
        at = 0
        for i, n in enumerate(lengths):
            need = -(-n // PAGE)
            # the mix overflows the pool: later slots reuse earlier pages
            tables[i, :need] = order[[(at + j) % POOL_PAGES for j in range(need)]]
            at += need
        tables = tables.cuda()
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((SLOTS, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        scales = dict(k_scale=kp["s"] if quant else None, v_scale=vp["s"] if quant else None)
        got = paged_attention(q, kv_data(kp), kv_data(vp), tables, lens, d ** -0.5, **scales)
        ref = paged_attention_reference(q, kv_data(kp), kv_data(vp), tables, lens, d ** -0.5,
                                        **scales)
        err, ratio, rel = kernel_disagreement(got, ref)
        log(f"[share] kernel 2 over group {g}'s buffer (layer {layer}, a non-owner), "
            f"{kv_dtype} pool, the mix's first step: max |err| {err:.3e}, worst err/limit "
            f"{ratio:.3f}, relative L2 {rel:.3e}")
        check(ratio <= 1 and rel <= REL_L2_TOL, f"kernel 2 over the group pool ({kv_dtype})")
        errs[f"paged_{kv_dtype}"] = err
        eng = PipelineEngine(model, microbatches=SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                             pool_pages=POOL_PAGES, page_size=PAGE, kv_share_map=share,
                             kv_dtype=kv_dtype, device=model.device)
        off = CHUNK
        pages = tables[5, : -(-(off + CHUNK) // PAGE)].long()
        k_view, v_view = eng._slot_view(kp, pages), eng._slot_view(vp, pages)
        qc = torch.randn((1, CHUNK, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        got = flash_attention(qc, k_view, v_view, off, d ** -0.5)
        ref = flash_attention_reference(qc, k_view, v_view, off, d ** -0.5)
        err, ratio, rel = kernel_disagreement(got, ref)
        log(f"[share] kernel 1 at offset {off} over a view gathered from group {g}'s "
            f"{kv_dtype} buffer: max |err| {err:.3e}, worst err/limit {ratio:.3f}, relative L2 "
            f"{rel:.3e}")
        check(ratio <= 1 and rel <= REL_L2_TOL, f"kernel 1 over a group view ({kv_dtype})")
        errs[f"flash_{kv_dtype}"] = err
        del cache, eng
    return errs


def _pool_leaves(cache) -> list:
    return [t for buf in (cache.k, cache.v)
            for t in (buf.values() if isinstance(buf, dict) else (buf,))]


def share_block_check(model, share, kv_dtype: str) -> dict:
    """One captured decode block under the map, checked bitwise against a
    snapshot of the pool taken before it: three requests decoding, the
    block's graph captured, the pool and the carries put back, the block
    replayed; then the same block run eagerly from the snapshot with every
    pool write recorded. Outside the rows the block wrote (the scratch page
    aside) the pool equals the snapshot; each written row holds what its
    group's owner (the group's first writer of that row) wrote, so every
    row a non-owner wrote holds its owner's bytes again; the replay equals
    the eager run. Returns the batcher (its pool is the export check's)."""
    from mlx_sharding_tpu_torch.cache import read_pool_rows
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.parallel import pipeline as pipeline_mod
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    tag = f"[share-{kv_dtype}]"
    eng = PipelineEngine(model, microbatches=SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                         pool_pages=POOL_PAGES, page_size=PAGE, kv_share_map=share,
                         kv_dtype=kv_dtype, device=model.device)
    b = ContinuousBatcher(eng, decode_block=8, async_sched="off")
    b._ensure_running = lambda: None
    tok = ByteTokenizer()
    for i, (n, m) in enumerate(SHARE_BLOCK_JOBS):
        b.generate_step(tok.encode(mix_prompt(i, n)), max_tokens=m)
    with torch.no_grad():
        while not (b._decoding() and not b._prefilling() and not b._waiting
                   and b._submit.empty()):
            b.run_tick()
        carries = (b.last_tok, b.recent, b._dev_off)

        def snapshot():
            return ([t.clone() for t in _pool_leaves(b.cache)], [c.clone() for c in carries],
                    [g.get_state() for g in b.generators])

        def restore(snap):
            for t, s in zip(_pool_leaves(b.cache), snap[0]):
                t.copy_(s)
            for c, s in zip(carries, snap[1]):
                c.copy_(s)
            for g, s in zip(b.generators, snap[2]):
                g.set_state(s)

        s0 = snapshot()
        b._run_block(False, False)  # captures the block's graph (and replays it)
        restore(s0)
        b._run_block(False, False)  # the captured block, replayed from the snapshot
        torch.cuda.synchronize()
        s1g = [t.clone() for t in _pool_leaves(b.cache)]
        restore(s0)
        records = []
        write = pipeline_mod.write_pool_rows

        def recording(pool, page_ids, row_pos, rows):
            write(pool, page_ids, row_pos, rows)
            leaf = pool["d"] if isinstance(pool, dict) else pool
            records.append((leaf.data_ptr(), page_ids.clone(), row_pos.clone(),
                            read_pool_rows(pool, page_ids, row_pos)))

        graphs, b.graphs = b.graphs, None
        pipeline_mod.write_pool_rows = recording
        try:
            b._run_block(False, False)  # the same block, eagerly
        finally:
            pipeline_mod.write_pool_rows = write
            b.graphs = graphs
        torch.cuda.synchronize()
        s1e = [t.clone() for t in _pool_leaves(b.cache)]
    # the expected pool: the snapshot with each written row set to its
    # group's first write of it (the owner's; the scratch page aside)
    scratch = POOL_PAGES
    leaves = _pool_leaves(b.cache)
    data = [lf for lf in leaves if lf.dtype != torch.float32] if kv_dtype == "int8" else leaves
    expected = [t.clone() for t in s0[0]]
    seen, nonowner_rows = set(), 0
    for ptr, pages, rows, vals in records:
        for i, leaf in enumerate(data):
            stride = leaf[0].numel() * leaf.element_size()
            g = (ptr - leaf.data_ptr()) // stride
            if 0 <= g < leaf.shape[0] and (ptr - leaf.data_ptr()) % stride == 0:
                break
        else:
            raise AssertionError(f"{tag} a write outside the pool")
        for j, (p, r) in enumerate(zip(pages.tolist(), rows.tolist())):
            if p == scratch:
                continue
            key = (i, g, p, r)
            if key in seen:
                nonowner_rows += 1
                continue
            seen.add(key)
            if kv_dtype == "int8":
                expected[2 * i][g, p, r] = vals["d"][j]
                expected[2 * i + 1][g, p, r] = vals["s"][j]
            else:
                expected[i][g, p, r] = vals[j]
    written = {(g, p, r) for _, g, p, r in seen}

    def differs(a, b_):
        out = set()
        for x, y in zip(a, b_):
            diff = (x != y).reshape(x.shape[0], x.shape[1], x.shape[2], -1).any(-1)
            diff[:, scratch] = False
            out |= {tuple(ix) for ix in diff.nonzero().tolist()}
        return out

    changed = differs(s1g, s0[0])
    check(changed <= written, f"{tag} the block changed pool rows it did not write: "
          f"{sorted(changed - written)[:4]}")
    bad_eager = differs(s1e, expected)
    bad_graph = differs(s1g, s1e)
    log(f"{tag} one captured decode block of 8 steps, 3 slots decoding, under the map "
        f"({share.num_groups} groups of {share.num_layers} layers): {len(written)} (group, "
        f"page, row) rows written by the owners, {nonowner_rows} rows written by non-owner "
        f"layers and put back, {len(changed)} rows changed against the snapshot; rows not "
        f"holding the owner's bytes after the eager block: {len(bad_eager)}; rows where the "
        f"replay differs from the eager block: {len(bad_graph)}")
    check(nonowner_rows > 0, f"{tag} no non-owner layer wrote a row")
    check(not bad_eager, f"{tag} rows a non-owner wrote do not hold the owner's bytes")
    check(not bad_graph, f"{tag} the captured block differs from the eager one")
    return b


def share_block_transfer(b, share, model) -> None:
    """A block exported under the map imports bit-identically into another
    pool under the same map, and an unshared pool refuses it."""
    from mlx_sharding_tpu_torch.kv_transfer import export_block, import_block
    from mlx_sharding_tpu_torch.parallel import PipelineEngine

    slot = next(s for s, r in enumerate(b._slots) if r is not None)
    req = b._slots[slot]
    n_tokens = req.prompt.size + len(req.history) - 1
    pages = b._pages_of[slot][: -(-n_tokens // PAGE)]
    block = export_block(b.cache, pages, page_size=PAGE, n_tokens=n_tokens, prompt=req.prompt,
                         history=req.history, produced=req.produced,
                         resume_gen=b.generators[slot].get_state(),
                         resume_recent=b.recent[slot].cpu(), share_hash=b._share_hash,
                         codec=b._kv_codec)
    block.to_host()
    twin = PipelineEngine(model, microbatches=SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                          pool_pages=POOL_PAGES, page_size=PAGE, kv_share_map=share,
                          device=model.device)
    cache, _ = twin.init_cache_paged()
    dst = list(range(POOL_PAGES - len(pages), POOL_PAGES))
    import_block(cache, block, dst, share_hash=twin.kv_share_hash, codec=twin.kv_codec)
    src_i = torch.tensor(pages, device=model.device)
    dst_i = torch.tensor(dst, device=model.device)
    same = all(torch.equal(a.index_select(1, src_i), c.index_select(1, dst_i))
               for a, c in zip(_pool_leaves(b.cache), _pool_leaves(cache)))
    plain = PipelineEngine(model, microbatches=SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                           pool_pages=POOL_PAGES, page_size=PAGE, device=model.device)
    refused = None
    try:
        import_block(plain.init_cache_paged()[0], block, dst, share_hash=None,
                     codec=plain.kv_codec)
    except Exception as e:  # noqa: BLE001 — the refusal under test
        refused = f"{type(e).__name__}: {e}"
    log(f"[share] a block of {len(pages)} pages ({block.nbytes} bytes) exported under the map: "
        f"imported into a pool under the same map bit-identical {same}; an unshared pool "
        f"refused it: {refused}")
    check(same, "the block under the map did not import bit-identically")
    check(refused is not None, "an unshared pool imported a block of a shared layout")
    del cache, twin, plain


def replica_mix(port, rs) -> dict:
    """Phase 6's mix through the replica set's server (:func:`served_mix`)
    and its routes per replica."""
    served0 = list(rs.served)
    out = served_mix(port, "[replicas]")
    out["routes"] = [a - b for a, b in zip(rs.served, served0)]
    return out


def served_mix(port, tag: str) -> dict:
    """Phase 6's mix of streamed forced requests through a server, all at
    once: each request's TTFT and the mix's tok/s."""
    jobs = [{"prompt": mix_prompt(i, n), "max_tokens": m, "stream": True,
             "logit_bias": {"65": 100.0}} for i, (n, m) in enumerate(BATCH_MIX[:SLOTS])]
    results = [None] * len(jobs)

    def send(i):
        results[i] = post(port, "/v1/completions", jobs[i], stream=True)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    tokens = 0
    ttfts = []
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"{tag} mix request {i}: {r and r[0]}")
        check(stream_text(r[1], chat=False) == "A" * jobs[i]["max_tokens"],
              f"{tag} mix request {i}'s text")
        tokens += jobs[i]["max_tokens"]
        ttfts.append(r[2] * 1e3)
    return {"tok_s": tokens / wall, "ttft_ms": ttfts, "tokens": tokens, "wall": wall}


def drain_streams(rs, ids: list, port=None, drain: Optional[int] = None) -> dict:
    """``DRAIN_STREAMS`` long greedy streams through the replica set, each
    consumed on a thread; with ``drain``, ``POST /admin/drain`` of that
    replica once every stream has ``DRAIN_AFTER`` tokens."""
    got = [[] for _ in ids]
    errors = []

    def consume(i):
        try:
            for t, _ in rs.generate_step(ids[i], max_tokens=DRAIN_TOKENS):
                got[i].append(t)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"stream {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(ids))]
    for t in threads:
        t.start()
        time.sleep(0.05)  # least-loaded routing alternates the replicas
    out = {}
    if drain is not None:
        t_wait = time.perf_counter()
        while min(len(g) for g in got) < DRAIN_AFTER and time.perf_counter() - t_wait < 120:
            time.sleep(0.005)
        out["tokens_at_drain"] = [len(g) for g in got]
        t0 = time.perf_counter()
        status, body, _, _ = post(port, "/admin/drain", {"replica": drain, "deadline": 60})
        out["drain_s"] = time.perf_counter() - t0
        out["drain"] = (status, body)
    for t in threads:
        t.join(timeout=600)
    check(not errors, f"[replicas] streams failed: {errors}")
    out["streams"] = got
    return out


def phase_share_and_replicas(model, seed: int, single_batch_tok_s: float, lap) -> tuple:
    """Phase 13 on phase 4's model and phase 6's geometry: layer-wise KV
    sharing (a map calibrated with the port's ``calibrate_model``, its pool
    bytes, the identity map's parity, kernels 1 and 2 over the group pool,
    one captured decode block's pool bitwise, a block's export and import)
    and two replicas on the card behind the server (one copy of the
    weights, phase 6's mix, the breaker, a drain with migration). Returns
    the launches of the replica set's served runs and the numbers."""
    from mlx_sharding_tpu_torch.cli.kv_share_calibrate import calibrate_model
    from mlx_sharding_tpu_torch.kv_share import KVShareMap
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, build_generator, \
        make_server
    from mlx_sharding_tpu_torch.testing import faults
    from mlx_sharding_tpu_torch.weights import weight_store

    gen = torch.Generator(device="cuda").manual_seed(seed + 130)
    tok = ByteTokenizer()
    layers = model.config.num_hidden_layers
    stats = {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    share = calibrate_model(model, [tok.encode(mix_prompt(i, n)) for i, n in
                                    enumerate(SHARE_CALIB)],
                            num_share=SHARE_NUM, max_group=SHARE_MAX_GROUP)
    log(f"[share] calibrated with calibrate_model over {len(SHARE_CALIB)} prompts "
        f"({sum(SHARE_CALIB)} tokens) in {time.perf_counter() - t0:.2f}s: {layers} layers -> "
        f"{share.num_groups} groups, pairs {share.meta['calibration']['pairs']}, share_hash "
        f"{share.share_hash} (random weights: the map exercises the mechanism, not quality)")
    check(share.num_groups == layers - SHARE_NUM, "the calibrated map's group count")
    stats["pool"] = share_pool_bytes(model, share)
    share_identity_parity(model, KVShareMap.identity(layers))
    stats["kernel_errs"] = share_kernel_checks(gen, share, model)
    lap("phase 13, the share map, its pool and kernels")
    for kv_dtype in ("bf16", "int8"):
        b = share_block_check(model, share, kv_dtype)
        if kv_dtype == "bf16":
            share_block_transfer(b, share, model)
        b.close()
        del b
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 13, a captured block under the map and its export")

    # two replicas on the card behind the server
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rs = build_generator("llama-3.1-8b-random", model=model, device=model.device,
                         max_seq=MAX_SEQ, prefill_chunk=CHUNK, concurrent=SLOTS,
                         paged_pool=POOL_PAGES, page_size=PAGE, decode_block=8,
                         replicas=REPLICAS)
    rs.probe_interval = PROBE_S
    torch.cuda.synchronize()
    after_load = torch.cuda.memory_allocated()
    store = weight_store().stats()
    w_bytes = sum(e["bytes"] for e in store["entries"])
    log(f"[replicas] --concurrent {SLOTS} --paged-pool {POOL_PAGES} --replicas {REPLICAS}: "
        f"torch.cuda.memory_allocated {before / 1e9:.3f} GB before (the model's weights "
        f"{w_bytes / 1e9:.3f} GB among it), {after_load / 1e9:.3f} GB after the replicas' pools "
        f"and graphs (+{(after_load - before) / 1e9:.3f} GB, less than one more copy of the "
        f"weights); weight store: {store['trees']} tree, {store['refs']} refs, "
        f"{store['bytes']} bytes; shared {rs.shared_weights_active}")
    check(store["trees"] == 1 and store["refs"] == REPLICAS, "the weight store's trees and refs")
    check(after_load - before < w_bytes, "the replicas hold a second copy of the weights")
    server = make_server(ModelProvider(rs, tok, model_name="llama-3.1-8b-replicas"),
                         "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    launches = {}
    try:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"[replicas] warm-up request: {status}")
        # a capture on replica 0 while replica 1 replays: replica 0 has
        # to capture its first prefill chunks again during the mix
        rep0, rep1 = rs.replicas
        for off in (0, CHUNK):
            rep0.graphs._graphs.pop(("prefill", off))
        caps0 = rep0.graphs.captures
        fails0 = sum(rs.failures)
        pa.paged_attention.launches = fa.flash_attention.launches = 0
        mix = replica_mix(port, rs)
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": fa.flash_attention.launches}
        recaptured = rep0.graphs.captures - caps0
        log(f"[replicas] phase 6's {SLOTS} streamed forced requests at once: {mix['tokens']} "
            f"tokens in {mix['wall']:.3f}s = {mix['tok_s']:.2f} tok/s (phase 6's single batcher: "
            f"{single_batch_tok_s:.2f}); TTFTs "
            + ", ".join(f"{t:.1f}" for t in mix["ttft_ms"])
            + f" ms; routes per replica {mix['routes']}; replica 0 captured {recaptured} "
            f"prefill graphs while replica 1 served; launches {launches}; replays by replica "
            f"{[r.graphs.replays for r in rs.replicas]}")
        check(recaptured == 2, "replica 0 did not capture its chunks during the mix")
        check(sum(rs.failures) == fails0, f"a replica failed a dispatch during the mix: "
              f"{rs.failures}")
        check(all(n > 0 for n in mix["routes"]), "a replica served no request of the mix")
        check(launches["paged_attention"] > 0 and launches["flash_attention"] > 0,
              "the replicas' served mix launched no attention kernel")
        stats["mix"] = mix
        # the breaker: replica 1 fails its dispatches while replica 0 is busy
        holder = threading.Thread(target=lambda: list(rs.generate_step(
            tok.encode(mix_prompt(20, 400)), max_tokens=200)))
        holder.start()
        time.sleep(0.5)
        faults.arm("replica.dispatch", exc=RuntimeError("injected dispatch failure"),
                   match={"replica": 1})
        served0 = list(rs.served)
        breaker_ok = 0
        try:
            for i in range(BREAKER_FAILS + 2):
                status, body, _, _ = post(port, "/v1/completions",
                                          {"prompt": mix_prompt(30 + i, 64), "max_tokens": 4})
                breaker_ok += status == 200
        finally:
            faults.disarm("replica.dispatch")
        health = rs.health()
        routes = [a - b for a, b in zip(rs.served, served0)]
        log(f"[replicas] replica.dispatch armed on replica 1: {breaker_ok} of "
            f"{BREAKER_FAILS + 2} requests answered 200; dispatches per replica {routes}; "
            f"replica 1's breaker {health['replicas'][1]['breaker']} after "
            f"{health['replicas'][1]['consecutive_failures']} failures; /health "
            f"{health['status']}, serving {health['serving']}")
        check(breaker_ok == BREAKER_FAILS + 2, "a request failed while replica 0 served")
        check(health["replicas"][1]["breaker"] == "open", "replica 1's breaker did not open")
        holder.join(timeout=600)
        time.sleep(PROBE_S)
        # replica 1 recovers: the half-open probe closes its breaker
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "probe", "max_tokens": 2})
        check(status == 200 and rs.health()["replicas"][1]["breaker"] == "closed",
              "replica 1's breaker did not close after the probe")
        lap("phase 13, two replicas: load, the mix and the breaker")

        # the drain: four long greedy streams, run once undrained, then
        # again with replica 0 drained while they decode
        ids = [tok.encode(mix_prompt(40 + i, DRAIN_PROMPT)) for i in range(DRAIN_STREAMS)]
        want = drain_streams(rs, ids)["streams"]
        exported = []
        export = rep0._export_resume_state

        def recorded(req, slot):
            state = export(req, slot)
            exported.append(state.block.nbytes if state.block is not None else None)
            return state

        rep0._export_resume_state = recorded
        # what replica 0 holds on the card: its pool and its graphs' pool
        pool_id, graph_bytes = tuple(rep0.graphs.pool), rep0.graphs.pool_bytes()
        kv_bytes = rep0.cache.nbytes
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        res_before = torch.cuda.memory_reserved()
        drained = drain_streams(rs, ids, port=port, drain=0)
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        res_after = torch.cuda.memory_reserved()
        graph_left = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg["segment_pool_id"]) == pool_id)
        status, body = drained["drain"]
        rs1 = rep1.spill_stats()
        same = drained["streams"] == want
        store = weight_store().stats()
        log(f"[replicas] drain of replica 0 with {DRAIN_STREAMS} greedy {DRAIN_TOKENS}-token "
            f"streams decoding (tokens each at the drain {drained['tokens_at_drain']}): POST "
            f"/admin/drain {status} {body} in {drained['drain_s']:.3f}s; blocks exported "
            f"{exported} bytes; replica 1 imported {rs1['spill_hits']} blocks, "
            f"migrations in {rs1['migrations_in']}; every stream equal to its undrained run "
            f"{same}, lengths {[len(s) for s in drained['streams']]}")
        log(f"[replicas] after the drain: weight store {store['trees']} tree, {store['refs']} "
            f"refs; replica 0 held a pool of {kv_bytes} bytes and a graph pool of "
            f"{graph_bytes} bytes, {graph_left} left of it; torch.cuda.memory_allocated "
            f"{mem_before / 1e9:.3f} -> {mem_after / 1e9:.3f} GB, reserved "
            f"{res_before / 1e9:.3f} -> {res_after / 1e9:.3f} GB (replica 1 decoded on "
            f"meanwhile); /health {rs.health()['status']}")
        check(status == 200 and body["closed"] and body["migrated"] >= 1,
              "the drain did not migrate and close replica 0")
        check(all(n is not None for n in exported) and len(exported) == body["migrated"],
              "a migrated stream left without its block")
        check(same and all(len(s) == DRAIN_TOKENS for s in drained["streams"]),
              "a drained stream differs from its undrained run or was cut")
        check(store["refs"] == 1 and store["trees"] == 1, "the drain did not release its ref")
        check(mem_before - mem_after >= kv_bytes and graph_left == 0,
              "the retired replica's pool or graph memory stayed on the card")
        stats["drain"] = {"seconds": drained["drain_s"], "blocks": exported,
                          "memory": (mem_before, mem_after), "reserved": (res_before, res_after),
                          "freed": (kv_bytes, graph_bytes, graph_left)}
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": fa.flash_attention.launches}
    finally:
        faults.disarm()
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        rs.close()
    del rs
    gc.collect()
    torch.cuda.empty_cache()
    check(weight_store().stats()["refs"] == 0, "the replicas' close left a weight ref")
    lap("phase 13, the drain")
    return launches, stats


# ------------------------------------------- phase 14: disaggregated serving
AUTOSCALE_INTERVAL = 0.5  # the controllers' tick (the default sustain is 5 s)
STORM_CLIENTS = 12  # clients posting long prompts back to back
STORM_PROMPT = 2000  # tokens: 8 chunks, 8 of the 16 pages a request
STORM_S = 7.5  # longer than the scale-up sustain window (5 s) and two ticks
BROWNOUT_STEPS = ((0.9, 1), (1.3, 2), (2.0, 3))  # (pressure observed, level)
BROWNOUT_ASK = 200  # max_tokens of the request the top rung caps (to 96)


def post_headers(port, body) -> tuple:
    """``POST /v1/completions``: (status, body, the X-MST-* headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    headers = {k: v for k, v in resp.getheaders() if k.startswith("X-MST-") and "Id" not in k}
    conn.close()
    return resp.status, data, headers


def autoscalers(port, enabled: bool) -> dict:
    status, body, _, _ = post(port, "/admin/autoscaler", {"enabled": enabled})
    check(status == 200 and [p["running"] for p in body["pools"]] == [enabled] * 2,
          f"[disagg] POST /admin/autoscaler {{enabled: {enabled}}}: {status} {body}")
    return body


def prefill_storm(port, co, ctrl) -> dict:
    """``STORM_CLIENTS`` clients post ``STORM_PROMPT``-token prompts back to
    back for ``STORM_S`` seconds at max_tokens 1 (one client at 2, so a few
    streams hand off): the prefill pool's pressure stays over the scale-up
    threshold past the sustain window. Waits for the prefill controller's
    spawn to finish; returns what the clients saw."""
    stop = threading.Event()
    answered, failed = [0], []

    def client(i):
        n = 0
        while not stop.is_set():
            body = {"prompt": mix_prompt(200 + 100 * i + n, STORM_PROMPT),
                    "max_tokens": 2 if i == 0 else 1}
            status, out, _, _ = post(port, "/v1/completions", body)
            n += 1
            if status == 200 and out["usage"]["completion_tokens"] == body["max_tokens"]:
                answered[0] += 1
            else:
                failed.append((status, out))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(STORM_CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(STORM_S)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    storm_s = time.perf_counter() - t0
    deadline = time.perf_counter() + 120
    while ctrl.state()["spawns"] + ctrl.state()["spawn_failures"] < 1 \
            and time.perf_counter() < deadline:
        time.sleep(0.05)
    check(not failed, f"[disagg] storm requests failed: {failed[:3]}")
    return {"answered": answered[0], "seconds": storm_s, "size": len(co.prefill.replicas)}


def phase_disagg(model, seed: int, single_batch_tok_s: float, replicas_tok_s: float,
                 greedy_ref, lap) -> tuple:
    """Phase 14 on phase 4's model and phase 6's geometry: ``--concurrent 8
    --paged-pool 16 --disagg --autoscale`` through ``build_generator``
    behind the server, one prefill and one decode replica over one copy of
    the weights. Phase 6's streamed mix (tok/s against phase 6's batcher
    and phase 13's replicas, TTFTs, handoffs, their bytes and ms); phase
    6's unforced greedy request equal to its run there; the ladder
    (``disagg.handoff`` serves in place, ``cache.export`` hands off
    blockless); a prefill storm that spawns a prefill replica and no decode
    replica, then ``drain_one()`` giving its memory back; the decode pool's
    brownout ladder at levels 1-3 capping a request with both headers and
    rendered in /metrics. Returns the mix's launches of kernels 1 and 2 and
    the numbers."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, build_generator, \
        make_server
    from mlx_sharding_tpu_torch.testing import faults
    from mlx_sharding_tpu_torch.weights import weight_store

    del seed  # the weights are phase 4's; nothing here draws
    tok = ByteTokenizer()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    co = build_generator("llama-3.1-8b-random", model=model, device=model.device,
                         max_seq=BATCH_MAX_SEQ, prefill_chunk=CHUNK, concurrent=SLOTS,
                         paged_pool=POOL_PAGES, page_size=PAGE, decode_block=8, disagg=True,
                         autoscale=True, autoscale_interval=AUTOSCALE_INTERVAL,
                         autoscale_cooldown=0.0)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after_load = torch.cuda.memory_allocated()
    store = weight_store().stats()
    w_bytes = sum(e["bytes"] for e in store["entries"])
    log(f"[disagg] --concurrent {SLOTS} --paged-pool {POOL_PAGES} --disagg --autoscale "
        f"--autoscale-interval {AUTOSCALE_INTERVAL} --autoscale-cooldown 0: loaded in "
        f"{load_s:.2f}s; torch.cuda.memory_allocated {before / 1e9:.3f} GB before (the model's "
        f"weights {w_bytes / 1e9:.3f} GB among it), {after_load / 1e9:.3f} GB after both pools "
        f"and their graphs (+{(after_load - before) / 1e9:.3f} GB); weight store: "
        f"{store['trees']} tree, {store['refs']} refs")
    check(store["trees"] == 1 and store["refs"] == 2, "the weight store's trees and refs")
    check(after_load - before < w_bytes, "the pools hold a second copy of the weights")
    provider = ModelProvider(co, tok, model_name="llama-3.1-8b-disagg")
    pctrl, dctrl = provider.fleet
    server = make_server(provider, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    prefill, decode = co.prefill.replicas[0], co.decode.replicas[0]
    spawned = None
    stats = {"load_s": load_s, "memory": (before, after_load)}
    try:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"[disagg] warm-up request: {status}")
        # the mix and the ladder are measured with the controllers' loops
        # stopped (a 96-token mix would lift the decode pool's ladder)
        autoscalers(port, False)
        h0, out0, in0 = co.handoff_stats(), prefill.handoffs_out, decode.migrations_in
        pa.paged_attention.launches = fa.flash_attention.launches = 0
        mix = served_mix(port, "[disagg]")
        launches = {"paged_attention": pa.paged_attention.launches,
                    "flash_attention": fa.flash_attention.launches}
        h = co.handoff_stats()
        n_hand = h["handoffs"] - h0["handoffs"]
        log(f"[disagg] phase 6's {SLOTS} streamed forced requests at once: {mix['tokens']} "
            f"tokens in {mix['wall']:.3f}s = {mix['tok_s']:.2f} tok/s (phase 6's single batcher "
            f"{single_batch_tok_s:.2f}, phase 13's two replicas {replicas_tok_s:.2f}); TTFTs "
            + ", ".join(f"{t:.1f}" for t in mix["ttft_ms"])
            + f" ms; {n_hand} handoffs, {h['bytes_total'] - h0['bytes_total']} bytes, handoff "
            f"ms p50 {h['ms_p50']:.3f} p99 {h['ms_p99']:.3f} (control + device-to-host copy); "
            f"handoffs_out on the prefill replica {prefill.handoffs_out - out0}, migrations_in on "
            f"the decode replica {decode.migrations_in - in0}; launches {launches}")
        check(n_hand == SLOTS and prefill.handoffs_out - out0 == SLOTS
              and decode.migrations_in - in0 == SLOTS and not h["fallbacks"],
              "a mix request was not handed off with its block")
        check(launches["paged_attention"] > 0 and launches["flash_attention"] > 0,
              "the disagg mix launched no attention kernel")
        stats.update(mix=mix, handoff=h)
        lap("phase 14, load and the mix")

        # phase 6's unforced greedy request, clean and down the ladder
        ids = tok.encode(mix_prompt(len(BATCH_MIX), GREEDY_PROMPT))
        want = greedy_ref[0]
        runs = {}
        for case, site in (("clean", None), ("handoff_fault", "disagg.handoff"),
                           ("export_fault", "cache.export")):
            h0, fb0 = co.handoff_stats(), prefill.spill_fallbacks
            if site is not None:
                faults.arm(site, exc=faults.FaultError, times=1)
            got = [t for t, _ in co.generate_step(ids, max_tokens=GREEDY_TOKENS,
                                                  want_logprobs=True)]
            faults.disarm()
            h = co.handoff_stats()
            runs[case] = {"tokens": got, "handoffs": h["handoffs"] - h0["handoffs"],
                          "bytes": h["bytes_total"] - h0["bytes_total"],
                          "fallbacks": {k: v - h0["fallbacks"].get(k, 0)
                                        for k, v in h["fallbacks"].items()
                                        if v != h0["fallbacks"].get(k, 0)},
                          "export_failures": prefill.spill_fallbacks - fb0}
            r = runs[case]
            same = sum(1 for _ in itertools.takewhile(lambda ab: ab[0] == ab[1],
                                                      zip(got, want)))
            log(f"[disagg] phase 6's greedy request ({len(ids)}-token prompt, {GREEDY_TOKENS} "
                f"tokens), {case}: {len(got)} tokens, the first {same} equal phase 6's "
                f"monolithic run; handoffs {r['handoffs']}, {r['bytes']} bytes, fallbacks "
                f"{r['fallbacks']}, export failures on the prefill replica "
                f"{r['export_failures']}")
            check(len(got) == GREEDY_TOKENS, f"[disagg] {case}: the stream was cut")
        check(runs["clean"]["tokens"] == want and runs["clean"]["handoffs"] == 1
              and runs["clean"]["bytes"] > 0, "the handed-off greedy stream differs from phase 6's")
        check(runs["handoff_fault"]["fallbacks"] == {"handoff_fault": 1}
              and runs["handoff_fault"]["handoffs"] == 0
              and runs["handoff_fault"]["tokens"] == want,
              "disagg.handoff did not serve in place, exactly")
        check(runs["export_fault"]["handoffs"] == 1 and runs["export_fault"]["bytes"] == 0
              and runs["export_fault"]["export_failures"] == 1,
              "cache.export did not hand off blockless")
        stats["ladder"] = runs
        lap("phase 14, the greedy stream and the ladder")

        # the prefill storm: the prefill pool's controller spawns, the
        # decode pool's does not
        autoscalers(port, True)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        storm = prefill_storm(port, co, pctrl)
        autoscalers(port, False)
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        ps, ds = pctrl.state(), dctrl.state()
        store = weight_store().stats()
        log(f"[disagg] prefill storm: {STORM_CLIENTS} clients, {STORM_PROMPT}-token prompts at "
            f"max_tokens 1-2 for {storm['seconds']:.1f}s, {storm['answered']} answered; prefill "
            f"controller spawns {ps['spawns']} (failures {ps['spawn_failures']}), last_spawn_s "
            f"{ps['last_spawn_s']:.3f} (an aliased spawn: pool and graph captures, no weight "
            f"upload); decode controller spawns {ds['spawns']}; pools "
            f"{len(co.prefill.replicas)} prefill, {len(co.decode.replicas)} decode; "
            f"torch.cuda.memory_allocated +{(mem1 - mem0) / 1e9:.3f} GB; weight store "
            f"{store['trees']} tree, {store['refs']} refs")
        check(ps["spawns"] == 1 and ds["spawns"] == 0 and len(co.prefill.replicas) == 2
              and len(co.decode.replicas) == 1, "the storm did not spawn exactly one prefill replica")
        check(store["refs"] == 3 and store["trees"] == 1, "the spawn did not alias the weights")
        spawned = co.prefill.replicas[1]
        pool_id, graph_bytes = tuple(spawned.graphs.pool), spawned.graphs.pool_bytes()
        kv_bytes = spawned.cache.nbytes
        torch.cuda.synchronize()
        mem_before, res_before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        action = pctrl.drain_one()
        drain_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem_after, res_after = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        graph_left = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg["segment_pool_id"]) == pool_id)
        store = weight_store().stats()
        log(f"[disagg] drain_one() on the prefill controller: {action} in {drain_s:.3f}s; the "
            f"spawned replica held a pool of {kv_bytes} bytes and a graph pool of {graph_bytes} "
            f"bytes, {graph_left} left of it; torch.cuda.memory_allocated {mem_before / 1e9:.3f} "
            f"-> {mem_after / 1e9:.3f} GB, reserved {res_before / 1e9:.3f} -> "
            f"{res_after / 1e9:.3f} GB; weight store {store['refs']} refs")
        check(action == "drain" and store["refs"] == 2, "drain_one did not retire the spawn")
        check(mem_before - mem_after >= kv_bytes and graph_left == 0,
              "the drained replica's pool or graph memory stayed on the card")
        stats["storm"] = {**storm, "last_spawn_s": ps["last_spawn_s"], "added": mem1 - mem0,
                          "drain_s": drain_s, "freed": (kv_bytes, graph_bytes, graph_left),
                          "memory": (mem_before, mem_after)}
        lap("phase 14, the storm, the spawn and drain_one")

        # brownout: the decode pool's ladder, level by level
        levels = []
        for pressure, level in BROWNOUT_STEPS:
            dctrl.brownout.observe(pressure)
            dctrl.tick()  # publishes the level to the decode pool's batchers
            levels.append((dctrl.brownout.level(), decode.resilience_stats()["brownout_level"],
                           prefill.resilience_stats()["brownout_level"]))
        # the prefill replica keeps its own pool's level (the storm's)
        check([lv[:2] for lv in levels] == [(lvl, lvl) for _, lvl in BROWNOUT_STEPS]
              and len({lv[2] for lv in levels}) == 1,
              f"[disagg] the ladder's levels (ladder, decode, prefill): {levels}")
        status, body, headers = post_headers(port, {"prompt": mix_prompt(7, 64),
                                                    "max_tokens": BROWNOUT_ASK})
        cap = dctrl.brownout.max_tokens_cap()
        status_m, text, _ = get(port, "/metrics")
        values = metric_values(text.decode())
        events = {k: v for k, v in values.items() if k.startswith("mst_autoscale_events_total")}
        log(f"[disagg] brownout through the decode pool's ladder: levels (ladder, decode replica, "
            f"prefill replica) {levels}; a request for {BROWNOUT_ASK} tokens: {status}, "
            f"{body.get('usage', {}).get('completion_tokens', body)} tokens, headers {headers}; "
            f"/metrics "
            f"mst_brownout_level {values.get('mst_brownout_level')}, events {events}")
        check(status == 200 and body.get("usage", {}).get("completion_tokens") == cap == 96
              and headers == {"X-MST-Brownout-Level": "3", "X-MST-Max-Tokens-Capped": "96"},
              "the brownout cap or its headers")
        check(status_m == 200 and values.get("mst_brownout_level") == 3
              and all(events.get(f'mst_autoscale_events_total{{kind="brownout_level_{lvl}"}}', 0)
                      >= 1 for _, lvl in BROWNOUT_STEPS), "/metrics' brownout families")
        stats["brownout"] = {"levels": levels, "headers": headers, "events": events}
    finally:
        faults.disarm()
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        co.close()
    del co, provider, prefill, decode, spawned, pctrl, dctrl
    gc.collect()
    torch.cuda.empty_cache()
    check(weight_store().stats()["refs"] == 0, "the disagg pools' close left a weight ref")
    lap("phase 14, brownout")
    return launches, stats


# ----------------------------------------------------------------- phase 15
PIPE_MAX_SEQ = 768  # the 600-token prompt and its 64 tokens: 3 chunk offsets to capture
PIPE_PROMPT = 600
PIPE_TOKENS = 64
PIPE_SPLIT = ((0, 16), (16, 32))  # the fused engine's (balanced for 2 stages)
PIPE_CHAINED = ((0, 20), (20, 32))  # uneven, through the chained pipeline
# the batcher's subset of phase 6's mix, greedy: its first request, its
# unforced greedy one (which grows into a second page as it decodes) and
# two whose prompts hold whole pages (which the prefix store registers)
PIPE_BATCH = (BATCH_MIX[0], (GREEDY_PROMPT, GREEDY_TOKENS), BATCH_MIX[4], BATCH_MIX[5])
PIPE_SLOTS = 4
PIPE_PACKED_TOKENS = 32
PIPE_STAGE_TOKENS = 32  # the runs with each stage's programs captured on their own
# the single streams' decode blocks (engines, the Generator, the chain): a
# capture runs its block's steps eagerly first
PIPE_DECODE_BLOCK = 8
DSV2_SPLIT = ((0, 14), (14, 27))  # the JAX package's headline split
DSV2_PIPE_PROMPT = 200  # one chunk: each of the Lite's prefill graphs takes seconds
DSV2_PIPE_TOKENS = 32
GREEDY_BLOCK = ((False, False),)
# what a pp = 2 engine may add to the card's memory beyond its caches and
# graph pool: plans, sampler rows, the stream's carries
PIPE_SLACK_BYTES = 64 << 20


# pages: overcommit admits the mix on 7 (1 + 1 + 2 + 3); the greedy request's
# growth into its second page then preempts the newest
PIPE_MOVE_POOL = 7
PIPE_HOLD = (2, 8, 10)  # request 2's reader stops after 8 tokens for 10 ticks
PIPE_DRAIN_AFTER = 8  # the drain is called once every stream has this many tokens


def pipe_ids(n: int) -> list:
    return ByteTokenizer().encode(mix_prompt(150, n))


def stream_launches(layers: int, prompt: int, tokens: int,
                    block: int = PIPE_DECODE_BLOCK) -> dict:
    """Kernel 1 and its T=1 route over one greedy stream of a dense model:
    a launch a layer for every prefill chunk and for every step of the
    whole decode blocks after the first token."""
    return {"flash_attention": layers * -(-prompt // CHUNK),
            "flash_decode": layers * block * -(-(tokens - 1) // block),
            "paged_attention": 0}


def pipe_stream(tag: str, gen, ids: list, tokens: int, counts, want: dict,
                warm: bool = False) -> dict:
    """One greedy stream through ``gen`` (an engine's single stream, a
    chain or a Generator), its prompt's chunks and the greedy block
    captured first; the counters zeroed just before it and read just after,
    each kernel of ``want`` launched exactly that often. ``warm``: the same
    stream once before, untimed (the first stream after captures reads
    slower on the card) and held equal. Returns its tokens, decode tok/s
    and launches."""
    graph_line(tag, gen.warm_up(prefill_upto=len(ids), blocks=GREEDY_BLOCK))
    first = stream_tokens(gen, ids, max_tokens=tokens)[0] if warm else None
    counts.reset()
    toks, tok_s = stream_tokens(gen, ids, max_tokens=tokens)
    got = counts.read()
    check(first is None or first == toks, f"{tag} a second run of the stream differs")
    log(f"{tag} {len(toks)} greedy tokens after a {len(ids)}-token prompt at {tok_s:.2f} tok/s; "
        f"launches {got}")
    for name, n in want.items():
        check(got[name] == n, f"{tag} {name} launched {got[name]} times, the stream needs {n}")
    return {"tokens": toks, "tok_s": tok_s, "launches": got}


def stage_step_ms(engine) -> list:
    """Device ms of each stage's layers in one T=1 step of the engine's
    single stream, captured and replayed (``graph_ms``); the step writes
    its K/V rows at the stream's next position (the stream has ended)."""
    from mlx_sharding_tpu_torch.ops.flash_attention import slot_lengths

    gen = engine.stream()
    st, m = gen.model, engine.microbatches
    plan = engine.device_plan(gen.cache.pos.expand(m), st.inputs, 1)
    lengths = slot_lengths(plan.positions[0], plan.lengths[0] > 0, engine.max_seq)
    h0 = engine.model.embed(gen._tok[:, None].expand(m, 1))

    def stage(s):
        return engine._decode_layers(st.cache, s, engine._attend_dense, h0, plan.positions[0],
                                     lengths, plan.page_ids[0], plan.row_pos[0], plan.tables)

    return [graph_ms(functools.partial(stage, s)) for s in range(engine.num_stages)]


def engine_pair(tag: str, model, split, ids: list, tokens: int, counts, want: dict,
                build=None) -> dict:
    """The fused engine's single stream at pp = 1, then at the stages
    ``split`` (built by ``build`` when given), each with its graphs, over
    ``model``: token-identical streams, and the card memory the pp = 2
    engine adds no more than its caches, graph pool and
    ``PIPE_SLACK_BYTES`` (no second copy of the weights). Returns both
    runs, the bytes, and each stage's device ms in one decode step."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.weights import model_weight_bytes

    kw = dict(max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK, device=model.device,
              decode_block=PIPE_DECODE_BLOCK)
    one = PipelineEngine(model, stages=1, **kw)
    out = {"pp1": pipe_stream(f"{tag}[pp=1]", one, ids, tokens, counts, want, warm=True)}
    out["pp1"]["stage_ms"] = stage_step_ms(one)
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    two = (build() if build is not None else
           PipelineEngine(model, stage_bounds=split, **kw))
    check(two.stage_bounds == list(split) and two.num_stages == 2,
          f"{tag} the engine's stages are {two.stage_bounds}")
    run = pipe_stream(f"{tag}[pp=2 {split}]", two, ids, tokens, counts, want, warm=True)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    stream = two.stream()
    caches = stream.model.cache.nbytes
    pool = stream.graphs.pool_bytes() if stream.graphs is not None else 0
    weights = model_weight_bytes(model)
    log(f"{tag} the pp = 2 engine added {grown / 1e6:.1f} MB of card memory: its caches "
        f"{caches / 1e6:.1f} MB (two stages of {[c.k.shape[0] for c in stream.model.cache.stages]}"
        f" layers), graph pool {pool / 1e6:.1f} MB; the weights {weights / 1e9:.3f} GB once")
    check(grown <= caches + pool + PIPE_SLACK_BYTES and grown < weights / 4,
          f"{tag} the pp = 2 engine grew the card's memory by {grown} bytes")
    check(run["tokens"] == out["pp1"]["tokens"],
          f"{tag} the pp = 2 stream parts from pp = 1 at token "
          f"{first_divergence(run['tokens'], out['pp1']['tokens'])}")
    run["stage_ms"] = stage_step_ms(two)
    log(f"{tag} token-identical at pp = 1 and 2; decode {out['pp1']['tok_s']:.2f} / "
        f"{run['tok_s']:.2f} tok/s; device ms of one decode step by stage: pp = 1 "
        f"{out['pp1']['stage_ms'][0]:.3f}, pp = 2 "
        f"{' + '.join(f'{x:.3f}' for x in run['stage_ms'])}")
    out.update(pp2=run, grown_bytes=grown, cache_bytes=caches, pool_bytes=pool, engine=two)
    return out


def pipe_batch(tag: str, model, stages: int, counts) -> dict:
    """A subset of phase 6's mix, greedy, through the batcher over a pool
    on the ``gather`` path (which pp > 1 takes) at ``stages`` stages,
    served on this thread after its graphs are captured: streams, tok/s,
    the ticks, and kernel 1 and the T=1 route launched once a layer for
    every prefill chunk and decode step (kernel 2 never)."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    jobs = pipe_jobs()
    engine = PipelineEngine(model, stages=stages, microbatches=PIPE_SLOTS, max_seq=PIPE_MAX_SEQ,
                            prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                            paged_attention="gather", device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8)
    graph_line(tag, batcher.warm_up(blocks=GREEDY_BLOCK))
    counts.reset()
    batcher.reset_tick_timing()
    t0 = time.perf_counter()
    items, _ = serve_on_this_thread(batcher, jobs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts.read()
    streams = [[t for t, _ in s] for s in items]
    n = sum(len(s) for s in streams)
    layers = model.config.num_hidden_layers
    log(f"{tag} {len(jobs)} requests, {n} tokens in {secs:.2f}s: {n / secs:.2f} tok/s; "
        f"{batcher.prefill_chunks} prefill chunks, {batcher.decode_steps} decode steps; "
        f"launches {got}")
    tick_line(tag, batcher)
    check(got["flash_attention"] == layers * batcher.prefill_chunks
          and got["flash_decode"] == layers * batcher.decode_steps
          and got["paged_attention"] == 0, f"{tag} launches {got}")
    ticks = batcher.tick_timing_stats()
    batcher.close()
    return {"streams": streams, "tok_s": n / secs, "ticks": ticks, "launches": got}


def pipe_jobs(tok=None) -> list:
    """Phase 15's batcher mix, ``PIPE_BATCH``, as ``(prompt ids, kwargs)``."""
    tok = tok or ByteTokenizer()
    return [(tok.encode(mix_prompt(i, n)), dict(max_tokens=m))
            for i, (n, m) in enumerate(PIPE_BATCH)]


def pipe_movement(tag: str, model, counts, want: list, mesh=None, decode_block: int = 8) -> dict:
    """KV movement over an engine of ``mesh`` (by default pp = 2: the 8B
    split 0-16 / 16-32; phase 17 passes ``tp=2``), every stage and shard
    on the card: phase 15's mix and its 600-token request once more after
    it has ended, through one batcher over a pool of ``PIPE_MOVE_POOL``
    pages with overcommit, the spill tier (prefetch on), a cold slot
    (request 0's reader stops, ``PIPE_HOLD``) and the prefix store, served
    on this thread: preemption spills a block (one payload a stage, each
    with every KV head) and imports it back, the cold slot spills and
    wakes, the finished 600-token request's pages are demoted into the
    store's host tier and the repeat imports them. Every stream equals
    ``want`` (the gather batcher of the same mesh without movement, the
    repeat equal to the first 600-token stream); spills, prefetch hits, the
    cold spill and the store's host hit are counted, and kernel 1 and its
    T=1 route launched once a layer and shard for every prefill chunk and
    decode step."""
    from mlx_sharding_tpu_torch.cache import stage_layers
    from mlx_sharding_tpu_torch.kv_compress import tree_leaves
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.prefix_store import PrefixStore
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    jobs = pipe_jobs()
    jobs.append(jobs[-1])  # the same prompt again, once the first has ended
    store = PrefixStore(host_bytes=SPILL_BYTES)
    store._host._flush_async = False  # the demotion's copy at the release, on this thread
    engine = PipelineEngine(model, **(mesh or dict(stage_bounds=PIPE_SPLIT)),
                            microbatches=PIPE_SLOTS, max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK,
                            pool_pages=PIPE_MOVE_POOL, page_size=PAGE, device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=decode_block, overcommit=True,
                                spill_bytes=SPILL_BYTES, spill_cold_after=COLD_AFTER,
                                kv_prefetch="on", prefix_store=store)
    batcher.spill._flush_async = False
    graph_line(tag, batcher.warm_up(blocks=GREEDY_BLOCK))
    counts.reset()
    t0 = time.perf_counter()
    items, reqs = serve_on_this_thread(batcher, jobs, hold=PIPE_HOLD,
                                       start_after={len(jobs) - 1: (len(jobs) - 2, 10 ** 9)})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts.read()
    streams = [[t for t, _ in s] for s in items]
    sp, st, spilled = batcher.spill_stats(), store.stats(), batcher.spill.stats()
    sp["bytes_spilled_total"] = spilled["bytes_spilled_total"]
    blocks = [store._host.peek(k) for k in store._host.keys()]
    layouts = {b.stage_layers for b in blocks}
    heads = {leaf.shape[3] for b in blocks for leaf in tree_leaves((b.k_pages, b.v_pages))}
    log(f"{tag} {len(jobs)} requests over {PIPE_MOVE_POOL} pages in {secs:.2f}s: "
        f"{sp['preemptions']} preemptions, {sp['spills']} spills, {sp['spill_hits']} spill hits "
        f"({sp['prefetch_hits']} staged, {sp['demand_imports']} demand), {sp['cold_spills']} "
        f"cold spills, {sp['cold_wakes']} wakes, {sp['spill_fallbacks']} fallbacks, "
        f"{sp['reprefill_tokens']} tokens re-prefilled, {sp['bytes_spilled_total'] / 1e6:.1f} MB "
        f"spilled; store: {st['demotions']} demotions, host hits {st['hits_host']}, device hits "
        f"{st['hits_device']}, {st['tokens_reused']} tokens reused, host blocks' stage layers "
        f"{layouts}, KV heads {heads}; launches {got}")
    check(streams == want, f"{tag} streams part from the gather batcher's at "
          f"{[first_divergence(a, b) for a, b in zip(streams, want)]}")
    check(sp["preemptions"] >= 1 and sp["spills"] >= 1 and sp["spill_hits"] >= 1
          and sp["prefetch_hits"] >= 1 and sp["cold_spills"] >= 1
          and sp["cold_wakes"] == sp["cold_spills"] and sp["spill_fallbacks"] == 0,
          f"{tag} spill counters {sp}")
    check(st["demotions"] >= 1 and st["hits_host"] >= 1
          and layouts <= {stage_layers(batcher.cache)}
          and heads == {model.cache_num_heads()},
          f"{tag} store counters {st}, layouts {layouts}, KV heads {heads}")
    layers = model.config.num_hidden_layers * engine.shards
    check(got["flash_attention"] == layers * batcher.prefill_chunks
          and got["flash_decode"] == layers * batcher.decode_steps
          and got["paged_attention"] == 0, f"{tag} launches {got}")
    batcher.close()
    store.close()
    return {"spill": sp, "store": st, "launches": got, "secs": secs}


def pipe_fleet(tag: str, model, counts, want: list, mesh=None, decode_block: int = 8,
               drain: bool = True, **fleet) -> dict:
    """Phase 15's mix over a fleet that ``build_generator`` builds as the
    server's ``--num-stages 2`` (or, ``mesh``, ``--tp 2``) with ``fleet``
    (two replicas with shared weights and, with ``drain``, a drain of
    replica 0 once every stream has ``PIPE_DRAIN_AFTER`` tokens, or a
    disagg pair), each request consumed on a thread: every stream equals
    ``want``; the card memory the fleet adds is its pools and graphs (one
    resident tree, no second copy of the weights)."""
    from mlx_sharding_tpu_torch.server.openai_api import build_generator
    from mlx_sharding_tpu_torch.weights import weight_store

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mesh = mesh or dict(num_stages=2)
    gen = build_generator("llama-3.1-8b-random", model=model, device=model.device,
                          max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK,
                          concurrent=PIPE_SLOTS, paged_pool=POOL_PAGES, page_size=PAGE,
                          decode_block=decode_block, **mesh, **fleet)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    store = weight_store().stats()
    w_bytes = sum(e["bytes"] for e in store["entries"])
    reps = ([*gen.prefill.replicas, *gen.decode.replicas] if fleet.get("disagg")
            else gen.replicas)
    log(f"{tag} built in {load_s:.2f}s: {len(reps)} engines of stages "
        f"{[r.engine.stage_bounds for r in reps][0]}, tp {reps[0].engine.tp}, on "
        f"{model.device}; card memory "
        f"+{grown / 1e9:.3f} GB (pools and graphs; the weights {w_bytes / 1e9:.3f} GB once); "
        f"weight store: {store['trees']} tree, {store['refs']} refs")
    check(all(r.engine.num_stages == mesh.get("num_stages", 1)
              and r.engine.tp == mesh.get("tp", 1) for r in reps), f"{tag} the engines' mesh")
    check(store["trees"] == 1 and store["refs"] == len(reps) and grown < w_bytes,
          f"{tag} a second copy of the weights: {store}, +{grown} bytes")
    jobs = pipe_jobs()
    got = [[] for _ in jobs]
    errors = []

    def consume(i):
        try:
            for t, _ in gen.generate_step(jobs[i][0], **jobs[i][1]):
                got[i].append(t)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"stream {i}: {type(e).__name__}: {e}")

    counts.reset()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
        time.sleep(0.05)  # least-loaded routing alternates the replicas
    out = {"load_s": load_s, "grown_bytes": grown}
    drain = drain and not fleet.get("disagg")
    if drain:
        t_wait = time.perf_counter()
        while min(len(g) for g in got) < PIPE_DRAIN_AFTER and time.perf_counter() - t_wait < 120:
            time.sleep(0.002)
        at = [len(g) for g in got]
        t_drain = time.perf_counter()
        out["drain"] = gen.drain(0)
        out["drain_s"] = time.perf_counter() - t_drain
        log(f"{tag} drained replica 0 at tokens {at} in {out['drain_s']:.3f}s: {out['drain']}")
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    out["launches"] = counts.read()
    check(not errors, f"{tag} streams failed: {errors}")
    check(got == want, f"{tag} streams part from the gather batcher's at "
          f"{[first_divergence(a, b) for a, b in zip(got, want)]}")
    n = sum(len(g) for g in got)
    if fleet.get("disagg"):
        h = gen.handoff_stats()
        log(f"{tag} {len(jobs)} requests, {n} tokens in {secs:.2f}s ({n / secs:.2f} tok/s): "
            f"{h['handoffs']} handoffs, {h['bytes_total'] / 1e6:.1f} MB, ms p50 {h['ms_p50']}, "
            f"fallbacks {h['fallbacks']}; launches {out['launches']}")
        check(h["handoffs"] == len(jobs) and h["bytes_total"] > 0 and h["fallbacks"] == {},
              f"{tag} handoffs {h}")
        out["handoff"] = h
    elif drain:
        r1 = gen.replicas[1]
        moved = r1.resilience_stats()["migrations_in"], r1.spill_stats()["spill_hits"]
        log(f"{tag} {len(jobs)} requests, {n} tokens in {secs:.2f}s ({n / secs:.2f} tok/s): "
            f"{gen.migrated_streams} streams migrated, replica 1 took {moved[0]} in and imported "
            f"{moved[1]} blocks; launches {out['launches']}")
        check(out["drain"]["migrated"] >= 1 and moved[1] >= 1,
              f"{tag} the drain moved nothing: {out['drain']}, {moved}")
        out["migrated"] = out["drain"]["migrated"]
    else:
        log(f"{tag} {len(jobs)} requests, {n} tokens in {secs:.2f}s ({n / secs:.2f} tok/s) over "
            f"{len(reps)} replicas; launches {out['launches']}")
    check(out["launches"]["flash_attention"] > 0 and out["launches"]["flash_decode"] > 0,
          f"{tag} launches {out['launches']}")
    gen.close()
    del gen, reps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pipeline(model, seed: int, lap) -> tuple:
    """Phase 15 on phase 4's model: the fused engine at pp = 1 and pp = 2
    (the latter built as the server builds ``--num-stages 2``, then serving
    a streamed completion), the chained pipeline against the pp = 1
    Generator, the batcher on the gather path at pp = 1 and 2, then the
    engine and the chain with each stage's programs captured on their own.
    Returns the launches of its runs per kernel and the numbers."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.parallel.chained import chained_from_model
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, build_generator

    counts = kernel_counts()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    layers = model.config.num_hidden_layers
    ids = pipe_ids(PIPE_PROMPT)
    want = stream_launches(layers, PIPE_PROMPT, PIPE_TOKENS)
    stats = engine_pair("[pipe]", model, PIPE_SPLIT, ids, PIPE_TOKENS, counts, want,
                        build=lambda: build_generator(
                            "llama-3.1-8b-random", model=model, device=model.device,
                            num_stages=2, max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK,
                            decode_block=PIPE_DECODE_BLOCK))
    add(stats["pp1"]["launches"])
    add(stats["pp2"]["launches"])
    two = stats.pop("engine")
    # one streamed completion through the provider over the pp = 2 engine
    counts.reset()
    with served(ModelProvider(two, ByteTokenizer(), model_name="llama-3.1-8b-pp2")) as port:
        status, events, t_head, t_end = post(port, "/v1/completions", {
            "prompt": mix_prompt(151, 300), "max_tokens": 32, "stream": True,
            "logit_bias": {"65": 100.0}}, stream=True)
    got = counts.read()
    add(got)
    text = stream_text(events, chat=False)
    log(f"[pipe] a streamed completion through ModelProvider at pp = 2: status {status}, "
        f"{len(text)} characters in {t_end * 1e3:.1f} ms, launches {got}")
    check(status == 200 and events[-1] == "[DONE]" and text == "A" * 32,
          f"[pipe] the streamed completion: {status} {text!r}")
    check(got["flash_attention"] > 0 and got["flash_decode"] > 0, "[pipe] HTTP launches")
    two.close()
    del two
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 15, the fused engine at pp = 1 and 2")
    gen = Generator(model, max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK,
                    decode_block=PIPE_DECODE_BLOCK)
    ref = pipe_stream("[pipe-gen][pp=1]", gen, ids, PIPE_TOKENS, counts, want)
    add(ref["launches"])
    del gen
    chain = chained_from_model(model, PIPE_CHAINED, max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK,
                               decode_block=PIPE_DECODE_BLOCK)
    run = pipe_stream(f"[pipe-chained][{PIPE_CHAINED}]", chain, ids, PIPE_TOKENS, counts, want)
    add(run["launches"])
    check(run["tokens"] == ref["tokens"], f"[pipe-chained] the chain parts from the Generator at "
          f"token {first_divergence(run['tokens'], ref['tokens'])}")
    agree = first_divergence(ref["tokens"], stats["pp1"]["tokens"])
    log(f"[pipe-chained] token-identical to the pp = 1 Generator ({ref['tok_s']:.2f} / "
        f"{run['tok_s']:.2f} tok/s); the Generator against the engine's single stream: "
        f"{'equal' if agree is None else f'parts at token {agree}'} (other kernels' shapes)")
    stats["chained"], stats["generator"] = run, ref
    del chain
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 15, the chained pipeline")
    batch = {s: pipe_batch(f"[pipe-batch][pp={s}]", model, s, counts) for s in (1, 2)}
    for b in batch.values():
        add(b["launches"])
    check(batch[2]["streams"] == batch[1]["streams"], "[pipe-batch] pp = 2 parts from pp = 1")
    log(f"[pipe-batch] token-identical at pp = 1 and 2: {batch[1]['tok_s']:.2f} / "
        f"{batch[2]['tok_s']:.2f} tok/s")
    stats["batch"] = batch
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 15, the batcher at pp = 1 and 2")
    # KV movement and the fleet over the stages, each against the pp = 2
    # gather batcher's streams
    want = batch[2]["streams"]
    stats["movement"] = pipe_movement("[pipe-move]", model, counts, want + [want[-1]])
    add(stats["movement"]["launches"])
    lap("phase 15, spill, a cold slot and the prefix store at pp = 2")
    stats["replicas"] = pipe_fleet("[pipe-replicas]", model, counts, want, replicas=2,
                                   shared_weights="on")
    add(stats["replicas"]["launches"])
    lap("phase 15, two replicas at pp = 2 and a drain")
    stats["disagg"] = pipe_fleet("[pipe-disagg]", model, counts, want, disagg=True)
    add(stats["disagg"]["launches"])
    lap("phase 15, a disagg pair at pp = 2")
    # each stage's share of a step as a graph of its own (what stages on
    # distinct cards take), forced on one card: the fused engine and the
    # chain, each against the first PIPE_STAGE_TOKENS of its pp = 1 stream
    kw = dict(max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK, stage_graphs=True,
              decode_block=PIPE_DECODE_BLOCK)
    want = stream_launches(layers, PIPE_PROMPT, PIPE_STAGE_TOKENS)
    for tag, gen, want_toks in (
            ("[pipe-stage-graphs][fused]",
             PipelineEngine(model, stage_bounds=PIPE_SPLIT, device=model.device, **kw),
             stats["pp1"]["tokens"][:PIPE_STAGE_TOKENS]),
            ("[pipe-stage-graphs][chained]", chained_from_model(model, PIPE_CHAINED, **kw),
             ref["tokens"][:PIPE_STAGE_TOKENS])):
        run = pipe_stream(tag, gen, ids, PIPE_STAGE_TOKENS, counts, want)
        add(run["launches"])
        check(run["tokens"] == want_toks, f"{tag} parts from its pp = 1 stream at token "
              f"{first_divergence(run['tokens'], want_toks)}")
        log(f"{tag} token-identical to its pp = 1 stream")
        stats[tag] = run
        if hasattr(gen, "close"):
            gen.close()
        del gen
        gc.collect()
        torch.cuda.empty_cache()
    lap("phase 15, each stage's programs on their own")
    return launches, stats


# ----------------------------------------------------------------- phase 16
POD_JOBS = BATCH_MIX[3:6]  # the handed-off requests: (256, 32), (257, 96), (600, 64)
POD_PREFIX = 600  # the federated prefix: host 0 serves it, host 1 continues it
POD_SUFFIX = 40
POD_TOKENS = 32
POD_RELAY_TIMEOUT_S = 2.0  # the origin's wait for the next relayed token after the death
POD_DEATH_AFTER = 2  # relayed tokens before host 1 goes silent


def pod_batcher(model, store=None):
    """A plain pp = 1 paged batcher of phase 15's geometry (the ragged
    path, kernel 2), its greedy decode block captured."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    engine = PipelineEngine(model, microbatches=PIPE_SLOTS, max_seq=PIPE_MAX_SEQ,
                            prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                            device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8, prefix_store=store)
    batcher.warm_up(blocks=GREEDY_BLOCK)
    return batcher


def phase_pod(model, lap) -> tuple:
    """Phase 16, the pod over its in-process transport on phase 4's model:
    two loopback hosts in this process over one resident copy of the
    weights. Host 0 is a disagg coordinator (``build_generator(disagg=True,
    prefix_store=True)``) whose decode pool is priced as saturated, host 1
    a plain paged batcher (ragged, kernel 2) with a prefix store of its own.
    Greedy requests cross from host 0's prefill pool to host 1's batcher
    (``PodHandoff``: the block's bytes on the wire, host 1 stages and
    imports it, relays the tokens); host 0 serves a prefix locally, which
    its store demotes, and host 1 continues it through one federated fetch
    of host 0's block; then host 1 goes silent after ``POD_DEATH_AFTER``
    relayed tokens and host 0 finishes the stream itself. Every stream
    equals a monolithic batcher's; the fallbacks are ``{}`` but the death's
    ``relay_timeout``, and the drained stream, resumed by refolding the
    tokens delivered into the prompt, equals the monolithic batcher's
    stream of that folded request. Returns the launches and the numbers."""
    from mlx_sharding_tpu_torch.pod import LoopbackHub, PodFleet
    from mlx_sharding_tpu_torch.prefix_store import PrefixStore
    from mlx_sharding_tpu_torch.server.openai_api import build_generator
    from mlx_sharding_tpu_torch.weights import weight_store

    tok = ByteTokenizer()
    counts = kernel_counts()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    co = build_generator("llama-3.1-8b-random", model=model, device=model.device,
                         max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK, concurrent=PIPE_SLOTS,
                         paged_pool=POOL_PAGES, page_size=PAGE, decode_block=8, disagg=True,
                         prefix_store=True)
    store0 = co.prefix_store
    store0._host._flush_async = False
    store1 = PrefixStore(host_bytes=SPILL_BYTES)
    host1, mono = pod_batcher(model, store1), pod_batcher(model)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    w = weight_store().stats()
    w_bytes = sum(e["bytes"] for e in w["entries"])
    log(f"[pod] host 0: a disagg coordinator (its pools {w['refs']} refs on {w['trees']} "
        f"resident tree), host 1: a paged batcher over the same tensors, and the monolithic "
        f"reference: card memory +{grown / 1e9:.3f} GB (the weights {w_bytes / 1e9:.3f} GB "
        f"once)")
    check(w["trees"] == 1 and grown < w_bytes, f"[pod] a second copy of the weights: {w}")
    hub = LoopbackHub()
    f0 = PodFleet(0, hub.register(0), co, prefix_store=store0)
    f1 = PodFleet(1, hub.register(1), host1, prefix_store=store1)
    launches = {}
    out = {"grown_bytes": grown}

    def served(gen, prompt, tokens):
        return [t for t, _ in gen.generate_step(prompt, max_tokens=tokens)]

    try:
        f0.tick()
        f1.tick()
        for f in (f0, f1):
            f.start()  # each host's heartbeat loop, as a serving pod runs it
        f0.handoff.local_pressure = lambda: 1.0  # host 0's decode pool: saturated
        jobs = [(tok.encode(mix_prompt(160 + i, n)), m) for i, (n, m) in enumerate(POD_JOBS)]
        want = [served(mono, p, m) for p, m in jobs]
        counts.reset()
        got = [served(co, p, m) for p, m in jobs]
        c = counts.read()
        h, r1 = f0.handoff.stats(), f1.handoff.stats()
        log(f"[pod] {len(jobs)} greedy requests handed off from host 0 to host 1: "
            f"{h['shipped']} shipped, {h['bytes_shipped'] / 1e6:.1f} MB on the wire, "
            f"{h['relayed_tokens']} tokens relayed, first relayed token p50 {h['ms_p50']:.1f} "
            f"ms (p99 {h['ms_p99']:.1f}), host 1 received {r1['received']}; fallbacks "
            f"{h['fallbacks']}; launches {c}; {card_line()}")
        check(got == want, f"[pod] a handed-off stream parts from the monolithic batcher's at "
              f"{[first_divergence(a, b) for a, b in zip(got, want)]}")
        check(h["shipped"] == len(jobs) and r1["received"] == len(jobs)
              and h["fallbacks"] == {} and c["paged_attention"] > 0,
              f"[pod] handoff {h}, launches {c}")
        out["handoff"] = h
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        lap("phase 16, cross-host handoffs")
        # the federated prefix: host 0 serves it locally, its store demotes it
        f0.handoff.local_pressure = lambda: 0.0
        prefix = tok.encode(mix_prompt(170, POD_PREFIX))
        first = prefix + tok.encode(mix_prompt(171, POD_SUFFIX))
        second = prefix + tok.encode(mix_prompt(172, POD_SUFFIX))
        check(served(co, first, POD_TOKENS) == served(mono, first, POD_TOKENS),
              "[pod] host 0's local stream")
        # the stream ends before the scheduler releases its slot: the
        # prefix joins host 0's tier (and its gossip) at that release
        digest = store0.digests_for(first)[-1]
        deadline = time.monotonic() + 30
        while not store0.host_contains(digest) and time.monotonic() < deadline:
            time.sleep(0.005)
        check(store0.host_contains(digest), f"[pod] host 0 demoted nothing: {store0.stats()}")
        f0.tick()
        f1.tick()
        want = served(mono, second, POD_TOKENS)
        counts.reset()
        t0 = time.perf_counter()
        got = served(host1, second, POD_TOKENS)
        secs = time.perf_counter() - t0
        c = counts.read()
        p1, p0 = f1.prefix.stats(), f0.prefix.stats()
        log(f"[pod] host 1 continued host 0's {POD_PREFIX}-token prefix: {p1['fetches']} "
            f"federated fetch, {p1['fetch_bytes'] / 1e6:.1f} MB, fetch {p1['fetch_ms_p50']:.1f} "
            f"ms; host 0 served {p0['blobs_served']} blob; host 1's store reused "
            f"{store1.stats()['tokens_reused']} tokens; the request took {secs * 1e3:.1f} ms; "
            f"fallbacks {p1['fallbacks']}; launches {c}")
        check(got == want, f"[pod] the federated stream parts from the monolithic batcher's at "
              f"{first_divergence(got, want)}")
        check(p1["fetches"] == 1 and p0["blobs_served"] == 1 and p1["fallbacks"] == {}
              and store1.stats()["tokens_reused"] >= 2 * PAGE, f"[pod] federation {p1}")
        out["fetch"] = p1
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        lap("phase 16, a federated prefix fetch")
        # host 1 dies in the middle of a relay: host 0 resumes after the
        # relayed tokens
        f0.handoff.local_pressure = lambda: 1.0
        orig, seen = hub._handlers[0], [0]

        def silent_death(src, kind, payload):
            if kind == "pod.tok":
                seen[0] += 1
                if seen[0] > POD_DEATH_AFTER:
                    return
            elif kind == "pod.end":
                return
            orig(src, kind, payload)

        hub._handlers[0] = silent_death
        f0.handoff.relay_timeout_s = POD_RELAY_TIMEOUT_S
        # a prompt host 0's store has not seen: a covered one skips the
        # prefill pool, and with it the handoff
        p, m = tok.encode(mix_prompt(175, POD_JOBS[1][0])), POD_JOBS[1][1]
        want = served(mono, p, m)
        got = served(co, p, m)
        h = f0.handoff.stats()
        # host 0 resumes blockless after the tokens its client has (the
        # prefill's first and the relayed ones): it folds them into the
        # prompt and prefills it again, as the monolithic batcher serves
        # that folded request; in bf16 a prefilled row is not bit-equal to
        # the decoded one, so the rest may part from the unfolded stream
        k = 1 + POD_DEATH_AFTER
        folded = want[:k] + served(mono, p + want[:k], m - k)
        log(f"[pod] host 1 went silent after {POD_DEATH_AFTER} relayed tokens: fallbacks "
            f"{h['fallbacks']}, host 0 finished the stream ({len(got)} tokens): equal to the "
            f"monolithic batcher's stream of the folded request (the prompt and the {k} "
            f"tokens delivered): {got == folded}; against the unfolded stream it parts at "
            f"token {first_divergence(got, want)} (None: equal)")
        check(got == folded, f"[pod] the drained stream parts from the monolithic batcher's "
              f"at {first_divergence(got, folded)}")
        check(h["fallbacks"] == {"relay_timeout": 1}, f"[pod] fallbacks {h['fallbacks']}")
        out["death"] = h["fallbacks"]
        lap("phase 16, a host death in the middle of a relay")
    finally:
        f0.close(close_local=False)
        f1.close(close_local=False)
        for b in (co, host1, mono):
            b.close()
        store1.close()
    return launches, out


def pipe_packed(packed) -> dict:
    """Phase 15's packed run after phase 5: the packed model's single
    stream at pp = 1 and pp = 2, 32 greedy tokens each, token-identical;
    kernels 3 and 4 launched once a layer shape for every chunk and step."""
    t0 = time.perf_counter()
    layers = packed.config.num_hidden_layers
    ids = pipe_ids(PIPE_PROMPT)
    want = stream_launches(layers, PIPE_PROMPT, PIPE_PACKED_TOKENS)
    block = PIPE_DECODE_BLOCK
    chunks, steps = -(-PIPE_PROMPT // CHUNK), block * -(-(PIPE_PACKED_TOKENS - 1) // block)
    want.update(quant_matmul=LAYER_SHAPES * layers * chunks,
                quant_gemv=(LAYER_SHAPES * layers + 1) * steps + chunks)
    out = engine_pair("[pipe-4bit]", packed, PIPE_SPLIT, ids, PIPE_PACKED_TOKENS, kernel_counts(),
                      want)
    out.pop("engine").close()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[pipe-4bit] phase 15's packed runs took {time.perf_counter() - t0:.1f}s")
    return out


def pipe_deepseek(model) -> dict:
    """Phase 15's DeepSeek run in phase 9: the Lite's single stream at pp =
    1 and split 0-14 / 14-27 (its dense first layer and 13 MoE layers, then
    13 MoE layers), 32 greedy tokens each, token-identical; kernel 1's MLA
    build and its T=1 route launched once a layer for every chunk and
    step."""
    t0 = time.perf_counter()
    layers = model.config.num_hidden_layers
    ids = pipe_ids(DSV2_PIPE_PROMPT)
    want = stream_launches(layers, DSV2_PIPE_PROMPT, DSV2_PIPE_TOKENS)
    out = engine_pair("[pipe-deepseek]", model, DSV2_SPLIT, ids, DSV2_PIPE_TOKENS,
                      kernel_counts(), want)
    out.pop("engine").close()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[pipe-deepseek] phase 15's Lite runs took {time.perf_counter() - t0:.1f}s")
    return out


# ----------------------------------------------------------------- phase 17
# The mesh axes that run in one process, every shard on the one card:
# tensor parallelism (Llama-3.1-8B bf16 and 4-bit, Mixtral-8x7B 4-bit, the
# Lite), expert parallelism (the Lite), sequence parallelism (the 8B), and
# f32 runs at the 8B's widths. Streams in bf16 may part from the tp = 1 /
# sp = 1 stream only from the first step whose top-2 gap in the reference's
# logits is under MESH_GAP nats (the sums over the shards round otherwise).
MESH_TP = 2
MESH_GAP = 0.1
MESH_LOGITS_REL_L2 = 5e-2  # bf16 first-step logits against tp = 1 / sp = 1
# the same for a model whose experts are routed: a token's top-k choice can
# flip on one rounding step in a layer, and the flipped expert's output is
# another (Mixtral at tp = 2 read 0.025 after a 600-token prompt and 0.248
# after a 256-token one, its argmax equal, on an NVIDIA H100 80GB HBM3 at
# 700 W)
MESH_MOE_LOGITS_REL_L2 = 0.5
MESH_BYTES_TOL = 0.01  # the tp = 2 placement's weight bytes against tp = 1's
MESH_TOKENS = 64  # the 8B's streams after PIPE_PROMPT tokens
MESH_SHORT_TOKENS = 32  # the packed 8B's, Mixtral's and the Lite's streams
MESH_SP_PROMPT = 1500  # pads to 1536: the quantum is sp x CHUNK = 512
MESH_SP_MAX_SEQ = 2048
MESH_F32_LAYERS = 4
MESH_F32_SP_PROMPT = 700
# f32 K/V of the same request at tp = 2 and tp = 1 (summation order only)
MESH_BLOCK_REL_L2 = 1e-5
# the engines' and batchers' decode blocks: a capture's seconds are mostly
# the eager warm-up of a block's steps, and the ep scan's steps are long
MESH_DECODE_BLOCK = 4
# the tp = 2 fleets' decode blocks: ``build_generator`` captures every
# block kind of every replica at load, each block's steps run eagerly
# first, and an eager step at tp = 2 is long
MESH_FLEET_DECODE_BLOCK = 1
# the families' streams (Mixtral, the Lite): a prompt of one chunk
MESH_FAMILY_PROMPT = CHUNK
# Llama-3.1-8B's projections at tp = 2, one shard's (OUT, IN), unfused
TP2_SHAPES = (("q_proj", 2048, 4096), ("k_proj/v_proj", 512, 4096), ("o_proj", 4096, 2048),
              ("gate_proj/up_proj", 7168, 4096), ("down_proj", 4096, 7168))
# Mixtral-8x7B's experts at tp = 2: the intermediate split in two
TP2_EXPERT_SHAPES = (("gate/up", 7168, 4096), ("down", 4096, 7168))


def lp_run(gen, ids: list, tokens: int, **kw) -> tuple:
    """One greedy stream with its logprobs: ``(tokens, TokenLogprobs,
    decode tok/s)`` (tokens after the first over the time after it)."""
    out, t_first = [], None
    for item in gen.generate_step(ids, max_tokens=tokens, want_logprobs=True, **kw):
        if t_first is None:
            t_first = time.perf_counter()
        out.append(item)
    torch.cuda.synchronize()
    tok_s = (len(out) - 1) / (time.perf_counter() - t_first)
    return [t for t, _ in out], [lp for _, lp in out], tok_s


def near_tie_rule(tag: str, got: list, want: list, want_lps: list):
    """The bf16 rule: ``got`` equals the reference ``want`` up to the first
    step whose top-2 gap in the reference's logits is under ``MESH_GAP``;
    prints where, if anywhere, the streams part. Returns that token."""
    gaps = [float(lp.top_values[0] - lp.top_values[1]) for lp in want_lps]
    tie = next((i for i, g in enumerate(gaps) if g < MESH_GAP), len(want))
    at = first_divergence(got, want)
    log(f"{tag} against the reference: "
        + ("token-identical" if at is None else
           f"parts at token {at} (top-2 gap there {gaps[at]:.4f} nats)")
        + f" over {len(want)} tokens; its first step under {MESH_GAP} nats is "
        + (f"{tie}" if tie < len(want) else "none"))
    check(at is None or at >= tie, f"{tag} parts at token {at}, before the first near tie {tie}")
    return at


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def mesh_engine_stream(tag: str, model, tokens: int, counts, want: dict, ids=None, tp=1,
                       ep=1, reference=None) -> dict:
    """The fused engine's single stream at tp x ep on the model's card,
    its graphs captured first: the greedy stream with logprobs (the
    counters zeroed before it and read after it, each kernel of ``want``
    launched exactly that often) and its decode tok/s, its first-step
    logits, the placement's weight bytes and, at tp > 1, the
    in-process reductions of one decode step. ``reference``: a tp = 1 run's
    numbers, which the stream is held to (``near_tie_rule``), the logits
    within ``MESH_LOGITS_REL_L2`` (``MESH_MOE_LOGITS_REL_L2`` with routed
    experts) and the weight bytes within ``MESH_BYTES_TOL``."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.parallel import mesh as pmesh

    ids = ids if ids is not None else pipe_ids(PIPE_PROMPT)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = PipelineEngine(model, tp=tp, ep=ep, max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK,
                         decode_block=MESH_DECODE_BLOCK, device=model.device)
    graph_line(tag, eng.warm_up(prefill_upto=len(ids), blocks=((False, True),)))
    counts.reset()
    toks, lps, tok_s = lp_run(eng, ids, tokens)
    got = counts.read()
    for name, n in want.items():
        check(got[name] == n, f"{tag} {name} launched {got[name]} times, the stream needs {n}")
    stream = eng.stream()
    logits = stream.run_prefill(np.asarray([ids], np.int64)).float()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    out = {"tokens": toks, "lps": lps, "tok_s": tok_s, "launches": got, "logits": logits,
           "weight_bytes": eng.weight_stream_bytes, "cache_bytes": stream.model.cache.nbytes,
           "grown": grown}
    if tp > 1:
        red = pmesh.reductions()
        stream.model(stream._tok[:, None], stream.cache)
        torch.cuda.synchronize()
        out["reductions"] = pmesh.reductions() - red
    log(f"{tag} {len(toks)} greedy tokens after a {len(ids)}-token prompt at {tok_s:.2f} tok/s; "
        f"launches {got}; weights {eng.weight_stream_bytes / 1e9:.4f} GB, KV caches "
        f"{out['cache_bytes'] / 1e6:.1f} MB, card memory grown {grown / 1e6:.1f} MB"
        + (f"; {out['reductions']} in-process reductions a decode step" if tp > 1 else ""))
    if reference is not None:
        err = rel_l2(logits, reference["logits"])
        tol = (MESH_MOE_LOGITS_REL_L2 if hasattr(model.layers[-1], "w_gate")
               else MESH_LOGITS_REL_L2)
        ratio = eng.weight_stream_bytes / reference["weight_bytes"]
        same = bool(logits.argmax() == reference["logits"].argmax())
        log(f"{tag} first-step logits against tp = 1: relative L2 {err:.3e} (tol {tol}), "
            f"argmax {'equal' if same else 'other'}; weight bytes {ratio:.4f} x tp = 1's; "
            f"decode {tok_s:.2f} against {reference['tok_s']:.2f} tok/s at tp = 1")
        check(err <= tol, f"{tag} first-step logits disagree with tp = 1's")
        check(abs(ratio - 1) <= MESH_BYTES_TOL, f"{tag} the weights are not held once")
        check(grown < reference["weight_bytes"] / 4,
              f"{tag} the engine grew the card's memory by {grown} bytes")
        out["parts_at"] = near_tie_rule(tag, toks, reference["tokens"], reference["lps"])
    eng.close()
    del eng, stream
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_batch(tag: str, model, counts, tp: int, want_streams=None) -> dict:
    """Phase 15's batcher mix with logprobs through the batcher over a
    ``MESH`` engine of ``PIPE_SLOTS`` slots and a pool on the gather path,
    overcommit admission, served on this thread after its captures: kernel
    1 and the T=1 route launched once a layer and shard for every prefill
    chunk and decode step, kernel 2 never. ``want_streams``: the tp = 1
    run's (tokens, logprobs) per request, held to the near-tie rule."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    jobs = [(p, dict(kw, want_logprobs=True)) for p, kw in pipe_jobs()]
    engine = PipelineEngine(model, tp=tp, microbatches=PIPE_SLOTS, max_seq=PIPE_MAX_SEQ,
                            prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                            paged_attention="gather", device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=MESH_DECODE_BLOCK, overcommit=True)
    graph_line(tag, batcher.warm_up(blocks=((False, True),)))
    counts.reset()
    t0 = time.perf_counter()
    items, _ = serve_on_this_thread(batcher, jobs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts.read()
    streams = [([t for t, _ in s], [lp for _, lp in s]) for s in items]
    n = sum(len(t) for t, _ in streams)
    layers = model.config.num_hidden_layers * tp
    log(f"{tag} {len(jobs)} requests, {n} tokens in {secs:.2f}s: {n / secs:.2f} tok/s; "
        f"{batcher.prefill_chunks} prefill chunks, {batcher.decode_steps} decode steps, "
        f"{batcher.preemptions} preemptions; launches {got}")
    check(got["flash_attention"] == layers * batcher.prefill_chunks
          and got["flash_decode"] == layers * batcher.decode_steps
          and got["paged_attention"] == 0, f"{tag} launches {got}")
    if want_streams is not None:
        for i, ((toks, _), (want, lps)) in enumerate(zip(streams, want_streams)):
            near_tie_rule(f"{tag} request {i}", toks, want, lps)
    batcher.close()
    return {"streams": streams, "tok_s": n / secs, "launches": got}


def mesh_attention_checks(seed: int) -> dict:
    """Kernel 1 and its T=1 route at the tp = 2 shard shapes against their
    plain versions: the 8B's 16 query heads over 4 KV heads (a prefill
    chunk at the main path's offsets, one row at positions 0, 600 and the
    last), and the Lite's MLA build over 8 heads a shard (Dk 576, v from
    k). Returns the largest error of each."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops.flash_attention import decode_lengths

    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    bf16, errs = torch.bfloat16, {"flash": 0.0, "decode": 0.0}
    q, k, v = attention_inputs(gen, 1, CHUNK, PIPE_MAX_SEQ, 16, 4, 128, 128, bf16)
    for off in MAIN_PATH_OFFSETS:
        errs["flash"] = max(errs["flash"], family_check(
            f"flash_attention tp=2 Hq=16 Hkv=4 D=128 T={CHUNK} offset {off} bf16",
            fa.flash_attention(q, k, v, off, 128 ** -0.5),
            fa.flash_attention_reference(q, k, v, off, 128 ** -0.5)))
    for position in (0, PIPE_PROMPT, PIPE_MAX_SEQ - 1):
        qd = torch.randn((1, 1, 16, 128), generator=gen, device="cuda").to(bf16)
        pos = torch.tensor([position], dtype=torch.int64, device="cuda")
        lengths = decode_lengths(pos, 1, PIPE_MAX_SEQ)
        errs["decode"] = max(errs["decode"], family_check(
            f"flash_decode tp=2 Hq=16 Hkv=4 D=128 position {position} bf16",
            fa.flash_decode(qd, k, v, pos, 128 ** -0.5, lengths=lengths),
            fa.flash_decode_reference(qd, k, v, lengths, 128 ** -0.5)))
    km, vm = mla_cache(gen, 1, PIPE_MAX_SEQ, bf16)
    qm = torch.randn((1, CHUNK, 8, MLA_DK), generator=gen, device="cuda").to(bf16)
    for off in MAIN_PATH_OFFSETS:
        errs["flash"] = max(errs["flash"], family_check(
            f"flash_attention MLA tp=2 Hq=8 (v from k) T={CHUNK} offset {off} bf16",
            fa.flash_attention(qm, km, vm, off, mla_scale()),
            fa.flash_attention_reference(qm, km, vm, off, mla_scale())))
    qd = torch.randn((1, 1, 8, MLA_DK), generator=gen, device="cuda").to(bf16)
    pos = torch.tensor([PIPE_PROMPT], dtype=torch.int64, device="cuda")
    lengths = decode_lengths(pos, 1, PIPE_MAX_SEQ)
    errs["decode"] = max(errs["decode"], family_check(
        f"flash_decode MLA tp=2 Hq=8 position {PIPE_PROMPT}",
        fa.flash_decode(qd, km, vm, pos, mla_scale(), lengths=lengths),
        fa.flash_decode_reference(qd, km, vm, lengths, mla_scale())))
    return errs


def mesh_quant_points(seed: int) -> list:
    """Kernels 3 and 4 at the 8B's tp = 2 shard shapes against their plain
    versions (bit for bit on integer-valued operands, within limits on
    random bf16), and their device times beside bound and plain version:
    the decode GEMV at M = 1, the prefill matmul at M = 256."""
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, out_dim, in_dim in TP2_SHAPES:
        for kernel, m in (("quant_gemv", 1), ("quant_matmul", PREFILL_M)):
            label = f"tp=2 {name} M={m} OUT={out_dim} IN={in_dim}"
            check_quant(kernel, *quant_operands(gen, m, out_dim, in_dim, integer=True),
                        GROUP_SIZE, BITS, True, label)
            x, q, s, b = quant_operands(gen, m, out_dim, in_dim, integer=False)
            err = check_quant(kernel, x, q, s, b, GROUP_SIZE, BITS, False, label)
            fn = getattr(qm, kernel)
            kern = time_ms(lambda: fn(x, q, s, b, GROUP_SIZE, BITS))
            plain = time_ms(lambda: qm.quant_matmul_reference(x, q, s, b, GROUP_SIZE, BITS))
            flops, nbytes = quant_work(m, out_dim, in_dim)
            ops_ms, bytes_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3, nbytes / PEAK_BYTES * 1e3
            walk = (f"IN split {qm.plan_gemv(out_dim, in_dim, sms) or 'whole'}"
                    if kernel == "quant_gemv" else
                    "token tile {}, IN split {}".format(*qm.plan_matmul(m, out_dim, in_dim, sms)))
            rows.append(dict(kernel=kernel, name=name, m=m, out=out_dim, inp=in_dim, ms=kern,
                             plain_ms=plain, bound_ms=max(ops_ms, bytes_ms), max_abs_err=err))
            log(f"[timing] {kernel} {label} ({walk}): kernel {kern:.4f} ms, plain {plain:.4f} "
                f"ms, bound {max(ops_ms, bytes_ms):.4f} ms "
                f"({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
                f"{max(ops_ms, bytes_ms) / kern:.1%} of it")
            del x, q, s, b
    return rows


def mesh_expert_points(seed: int) -> list:
    """The routed GEMV at Mixtral's tp = 2 expert shapes (the intermediate
    7168 a shard) against its plain version, and its device time."""
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    rows = []
    for name, out_dim, in_dim in TP2_EXPERT_SHAPES:
        per_pair = name == "down"
        for integer in (True, False):
            stack = expert_stack(gen, MIXTRAL_EXPERTS, out_dim, in_dim, integer)
            x, idx = expert_inputs(gen, 1, in_dim, integer, per_pair)
            got = qm.quant_gemv_experts(x, idx, *stack, GROUP_SIZE, BITS)
            ref = qm.quant_gemv_experts_reference(x, idx, *stack, GROUP_SIZE, BITS)
            label = f"quant_gemv_experts tp=2 {name} OUT={out_dim} IN={in_dim} N=1"
            if integer:
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"{label} differs from its plain version")
                log(f"[kernels] {label} integer-valued: bit-exact True")
                continue
            err = family_check(label, got, ref)
            kern = time_ms(lambda: qm.quant_gemv_experts(x, idx, *stack, GROUP_SIZE, BITS))
            plain = time_ms(lambda: qm.quant_gemv_experts_reference(x, idx, *stack, GROUP_SIZE,
                                                                    BITS), iters=5)
            _, w_bytes = quant_work(0, out_dim, in_dim)
            nbytes = MIXTRAL_TOP_K * w_bytes + x.numel() * 2 + MIXTRAL_TOP_K * out_dim * 2
            bound = nbytes / PEAK_BYTES * 1e3
            rows.append(dict(name=name, ms=kern, plain_ms=plain, bound_ms=bound, max_abs_err=err))
            log(f"[timing] {label}: kernel {kern:.4f} ms, plain {plain:.4f} ms, bound "
                f"{bound:.4f} ms (bytes), {bound / kern:.1%} of it")
            del stack
    return rows


def mesh_ngram(tag: str, model, counts, want: list) -> dict:
    """n-gram speculation in the tp = 2 batcher (phase 17's geometry, the
    gather path, overcommit): phase 15's mix, greedy, served on this thread
    after its captures. Each stream is held by phase 6's rule to ``want``,
    the tp = 2 batcher's run without speculation (tokens and logprobs):
    equal, or parting only at a near tie (``NEAR_TIE_GAP``) to a near-tied
    token; kernel 1 and the T=1 route launched once a layer and shard for
    every prefill chunk and plain decode step (the verify attends through
    ``masked_attention``, as JAX's does). Prints ``spec_stats``."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    engine = PipelineEngine(model, tp=MESH_TP, microbatches=PIPE_SLOTS, max_seq=PIPE_MAX_SEQ,
                            prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                            paged_attention="gather", device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=MESH_DECODE_BLOCK, overcommit=True,
                                draft="ngram")
    graph_line(tag, batcher.warm_up(blocks=GREEDY_BLOCK))
    counts.reset()
    t0 = time.perf_counter()
    items, _ = serve_on_this_thread(batcher, pipe_jobs())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts.read()
    streams = [[t for t, _ in s] for s in items]
    spec = batcher.spec_stats()
    n = sum(len(s) for s in streams)
    log(f"{tag} {len(streams)} requests, {n} tokens in {secs:.2f}s: {n / secs:.2f} tok/s; "
        f"{batcher.prefill_chunks} prefill chunks, {batcher.decode_steps} plain decode steps, "
        f"{batcher.verify_ticks} verify ticks; spec_stats {spec}; launches {got}")
    for i, (toks, (want_toks, lps)) in enumerate(zip(streams, want)):
        same = agreement(f"{tag} request {i}", "against the tp = 2 batcher without speculation",
                         toks, want_toks, near_ties(tag, f"request {i}", lps))
        log(f"{tag} request {i}: {same} of {len(want_toks)} tokens equal the run without "
            f"speculation")
    check(spec["rounds"] > 0 and batcher.verify_ticks > 0, f"{tag} no verify round: {spec}")
    layers = model.config.num_hidden_layers * MESH_TP
    check(got["flash_attention"] == layers * batcher.prefill_chunks
          and got["flash_decode"] == layers * batcher.decode_steps
          and got["paged_attention"] == 0, f"{tag} launches {got}")
    batcher.close()
    return {"spec": spec, "tok_s": n / secs, "launches": got}


def handed_off(batcher, ids: list, tokens: int) -> tuple:
    """A prefill-only stream on ``batcher`` (the disagg protocol): its
    first token and its state, the block flushed to the host."""
    from mlx_sharding_tpu_torch.resilience import HandoffReadyError

    first = []
    try:
        for t, _ in batcher.generate_step(ids, max_tokens=tokens, _prefill_only=True):
            first.append(t)
    except HandoffReadyError as ready:
        ready.state.block.to_host()
        return first, ready.state
    raise RuntimeError("the prefill-only stream ended without a handoff")


def mesh_cross_tp(tag: str, f32) -> dict:
    """f32 at 4 layers of the 8B's widths: a block exported from a tp = 2
    pool after the first token imports into a tp = 1 pool (and a tp = 1
    block into a tp = 2 pool), and each resumed stream is token-identical
    to the uninterrupted tp = 1 stream; the tp = 2 block's whole-head
    payload is within ``MESH_BLOCK_REL_L2`` of the tp = 1 block's for the
    same request, layer by layer."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    ids = pipe_ids(PIPE_PROMPT)
    tokens = MESH_SHORT_TOKENS
    kw = dict(microbatches=2, max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK, pool_pages=8,
              page_size=PAGE, device=f32.device)

    def batcher(tp):
        return ContinuousBatcher(PipelineEngine(f32, tp=tp, **kw), decode_block=MESH_DECODE_BLOCK)

    ref = batcher(1)
    want = [t for t, _ in ref.generate_step(ids, max_tokens=tokens)]
    states, errs = {}, []
    for tp in (MESH_TP, 1):
        src = batcher(tp)
        states[tp] = handed_off(src, ids, tokens)
        src.close()
    b2, b1 = states[MESH_TP][1].block, states[1][1].block
    for name in ("k_pages", "v_pages"):
        a, b = getattr(b2, name), getattr(b1, name)
        check(a.shape == b.shape, f"{tag} {name}: tp = 2 {tuple(a.shape)}, tp = 1 "
              f"{tuple(b.shape)}")
        errs += [rel_l2(a[layer], b[layer]) for layer in range(a.shape[0])]
    log(f"{tag} the tp = 2 block against the tp = 1 block of the same request: leaves "
        f"{tuple(b2.k_pages.shape)} both, {b2.nbytes / 1e6:.1f} MB both; relative L2 by layer "
        f"(K then V) {[f'{e:.2e}' for e in errs]} (tol {MESH_BLOCK_REL_L2})")
    check(max(errs) <= MESH_BLOCK_REL_L2, f"{tag} the tp = 2 block is not the tp = 1 block")
    out = {"block_rel_l2": max(errs)}
    for src_tp, dst in ((MESH_TP, ref), (1, batcher(MESH_TP))):
        first, state = states[src_tp]
        got = first + [t for t, _ in dst.generate_step(ids, max_tokens=tokens, _resume=state)]
        stats = dst.spill_stats()
        name = f"tp = {src_tp} into tp = {dst.engine.tp}"
        log(f"{tag} {name}: the resumed stream "
            f"{'equals' if got == want else 'parts from'} the uninterrupted tp = 1 stream over "
            f"{len(want)} tokens; imports {stats['demand_imports']}, fallbacks "
            f"{stats['spill_fallbacks']}")
        check(got == want and stats["spill_fallbacks"] == 0 and stats["demand_imports"] >= 1,
              f"{tag} {name}: parts at token {first_divergence(got, want)}, {stats}")
        dst.close()
    return out


def phase_mesh(model, seed: int, lap) -> tuple:
    """Phase 17 on the 8B in bf16, every shard on its card: the fused
    engine's single stream at tp = 1 and 2 (weights held once, decode tok/s,
    two reductions a layer, the near-tie rule), the gather batcher at tp =
    1 and 2 over a paged pool with overcommit, a streamed request through
    the server built as ``--tp 2 --concurrent 4`` builds it, then over tp
    = 2 engines KV movement (``pipe_movement``), two replicas with a drain
    and a disagg pair (``pipe_fleet``) and n-gram speculation
    (``mesh_ngram``), each against the tp = 2 batcher's streams, sequence
    parallelism (a 1,500-token prompt over two sp shards, decoded over the
    sharded cache, against the sp = 1 Generator), then f32 at 4 layers of
    the 8B's widths (tp = 2 and sp = 2 token-identical to tp = 1, and page
    blocks moved between tp = 1 and tp = 2 pools, ``mesh_cross_tp``).
    Returns the launches per kernel and the numbers."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.models import build_model
    from mlx_sharding_tpu_torch.parallel.mesh import device_grid
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, build_generator

    counts = kernel_counts()
    launches: dict = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    layers = model.config.num_hidden_layers
    stats = {}
    one = mesh_engine_stream("[mesh][tp=1]", model, MESH_TOKENS, counts,
                             stream_launches(layers, PIPE_PROMPT, MESH_TOKENS,
                                             MESH_DECODE_BLOCK))
    two = mesh_engine_stream("[mesh][tp=2]", model, MESH_TOKENS, counts,
                             stream_launches(MESH_TP * layers, PIPE_PROMPT, MESH_TOKENS,
                                             MESH_DECODE_BLOCK),
                             tp=MESH_TP, reference=one)
    check(two["reductions"] == 2 * layers, f"[mesh][tp=2] {two['reductions']} reductions a "
          f"step, want {2 * layers}")
    add(one["launches"])
    add(two["launches"])
    stats["stream"] = {"tp1": one, "tp2": two}
    lap("phase 17, the 8B's single stream at tp = 1 and 2")
    b1 = mesh_batch("[mesh-batch][tp=1]", model, counts, 1)
    b2 = mesh_batch("[mesh-batch][tp=2]", model, counts, MESH_TP, want_streams=b1["streams"])
    add(b1["launches"])
    add(b2["launches"])
    stats["batch"] = {"tp1": b1["tok_s"], "tp2": b2["tok_s"]}
    gen = build_generator("llama-3.1-8b-random", model=model, device=model.device, tp=MESH_TP,
                          concurrent=4, paged_pool=POOL_PAGES, page_size=PAGE,
                          max_seq=PIPE_MAX_SEQ, prefill_chunk=CHUNK, overcommit=True,
                          decode_block=MESH_DECODE_BLOCK)
    check(gen.engine.tp == MESH_TP and gen.engine.decode_path == "gather",
          "[mesh-http] the server's engine")
    counts.reset()
    with served(ModelProvider(gen, ByteTokenizer(), model_name="llama-3.1-8b-tp2")) as port:
        status, events, _, t_end = post(port, "/v1/completions", {
            "prompt": mix_prompt(152, 300), "max_tokens": 32, "stream": True,
            "logit_bias": {"65": 100.0}}, stream=True)
    got = counts.read()
    add(got)
    text = stream_text(events, chat=False)
    log(f"[mesh-http] a streamed completion through the server's --tp 2 --concurrent 4 batcher: "
        f"status {status}, {len(text)} characters in {t_end * 1e3:.1f} ms, launches {got}")
    check(status == 200 and events[-1] == "[DONE]" and text == "A" * 32,
          f"[mesh-http] the streamed completion: {status} {text!r}")
    check(got["flash_attention"] > 0 and got["flash_decode"] > 0, "[mesh-http] launches")
    gen.close()
    del gen
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 17, the batcher at tp = 1 and 2 and the server")
    # KV movement, the fleet and speculation over tp = 2 engines, each
    # against the tp = 2 gather batcher's streams without them
    want = [t for t, _ in b2["streams"]]
    stats["movement"] = pipe_movement("[mesh-move]", model, counts, want + [want[-1]],
                                      mesh=dict(tp=MESH_TP), decode_block=MESH_DECODE_BLOCK)
    add(stats["movement"]["launches"])
    lap("phase 17, spill, a cold slot and the prefix store at tp = 2")
    mesh = dict(mesh=dict(tp=MESH_TP), decode_block=MESH_FLEET_DECODE_BLOCK)
    stats["replicas"] = pipe_fleet("[mesh-replicas]", model, counts, want, replicas=2,
                                   shared_weights="on", **mesh)
    add(stats["replicas"]["launches"])
    stats["disagg"] = pipe_fleet("[mesh-disagg]", model, counts, want, disagg=True, **mesh)
    add(stats["disagg"]["launches"])
    lap("phase 17, two replicas with a drain and a disagg pair at tp = 2")
    stats["ngram"] = mesh_ngram("[mesh-ngram]", model, counts, b2["streams"])
    add(stats["ngram"]["launches"])
    lap("phase 17, n-gram speculation in the tp = 2 batcher")
    ids = pipe_ids(MESH_SP_PROMPT)
    plain = Generator(model, max_seq=MESH_SP_MAX_SEQ, prefill_chunk=CHUNK,
                      decode_block=MESH_DECODE_BLOCK)
    plain.warm_up(prefill_upto=len(ids), blocks=((False, True),))
    want_logits = plain.run_prefill(np.asarray([ids], np.int64)).float()
    want, want_lps, _ = lp_run(plain, ids, MESH_TOKENS)
    del plain
    sp = Generator(model, max_seq=MESH_SP_MAX_SEQ, prefill_chunk=CHUNK,
                   decode_block=MESH_DECODE_BLOCK,
                   sp_mesh=device_grid(sp=2, device=model.device), sp_decode=True)
    graph_line("[mesh-sp]", sp.warm_up(blocks=((False, True),)))
    t0 = time.perf_counter()
    logits, ks, vs = sp._sp_prefill.prefill_sharded(np.asarray([ids], np.int64))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    err = rel_l2(logits, want_logits)
    log(f"[mesh-sp] a {len(ids)}-token prompt over 2 sp shards (padded to "
        f"{sp._sp_prefill.padded_len(len(ids))}) in {prefill_s * 1e3:.1f} ms; first-step logits "
        f"against sp = 1: relative L2 {err:.3e} (tol {MESH_LOGITS_REL_L2})")
    check(err <= MESH_LOGITS_REL_L2, "[mesh-sp] first-step logits disagree with sp = 1's")
    toks, _, sp_tok_s = lp_run(sp, ids, MESH_TOKENS)
    shapes = [tuple(k.shape) for k in sp._sp_decode.k]
    log(f"[mesh-sp] {len(toks)} tokens over the sharded cache ({shapes} a shard) at "
        f"{sp_tok_s:.2f} tok/s")
    stats["sp"] = {"prefill_ms": prefill_s * 1e3, "tok_s": sp_tok_s, "logits_rel_l2": err,
                   "parts_at": near_tie_rule("[mesh-sp]", toks, want, want_lps)}
    del sp, ks, vs
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 17, sequence parallelism")
    f32, _ = build_model({**LLAMA_31_8B, "num_hidden_layers": MESH_F32_LAYERS},
                         dtype=torch.float32)
    f32.init_params(torch.Generator(device=model.device).manual_seed(seed + 17), model.device)
    ids = pipe_ids(PIPE_PROMPT)
    ref = mesh_engine_stream("[mesh-f32][tp=1]", f32, MESH_SHORT_TOKENS, counts, {})
    tp2 = mesh_engine_stream("[mesh-f32][tp=2]", f32, MESH_SHORT_TOKENS, counts, {},
                             tp=MESH_TP)
    check(tp2["tokens"] == ref["tokens"], f"[mesh-f32] tp = 2 parts from tp = 1 at token "
          f"{first_divergence(tp2['tokens'], ref['tokens'])}")
    sp_ids = pipe_ids(MESH_F32_SP_PROMPT)
    plain = Generator(f32, max_seq=MESH_SP_MAX_SEQ, prefill_chunk=CHUNK, cuda_graphs=False)
    want = [t for t, _ in plain.generate_step(sp_ids, max_tokens=MESH_SHORT_TOKENS)]
    sp = Generator(f32, max_seq=MESH_SP_MAX_SEQ, prefill_chunk=CHUNK, cuda_graphs=False,
                   sp_mesh=device_grid(sp=2, device=f32.device), sp_decode=True)
    got = [t for t, _ in sp.generate_step(sp_ids, max_tokens=MESH_SHORT_TOKENS)]
    check(got == want, f"[mesh-f32] sp = 2 parts from sp = 1 at token "
          f"{first_divergence(got, want)}")
    log(f"[mesh-f32] {MESH_F32_LAYERS} layers at the 8B's widths in f32: tp = 2 token-identical "
        f"to tp = 1 over {len(ref['tokens'])} tokens, sp = 2 (sp_decode) to sp = 1 over "
        f"{len(want)} tokens after a {len(sp_ids)}-token prompt")
    del plain, sp
    stats["cross_tp"] = mesh_cross_tp("[mesh-f32-blocks]", f32)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 17, f32 at 4 layers")
    return launches, stats


def mesh_packed(packed) -> dict:
    """Phase 17's packed run after phase 5: the packed 8B's single stream
    at tp = 1 and 2, 32 greedy tokens (the fused groups split back: tp > 1
    takes them apart), kernels 3 and 4 launched once a projection and shard
    for every chunk and step; the weight bytes held once (the row splits'
    copies, the wholes dropped)."""
    from mlx_sharding_tpu_torch.models.base import undo_projection_fusion

    t0 = time.perf_counter()
    undo_projection_fusion(packed)
    layers = packed.config.num_hidden_layers
    block = MESH_DECODE_BLOCK
    chunks, steps = -(-PIPE_PROMPT // CHUNK), block * -(-(MESH_SHORT_TOKENS - 1) // block)
    counts = kernel_counts()
    runs = {}
    for tp in (1, MESH_TP):
        want = stream_launches(tp * layers, PIPE_PROMPT, MESH_SHORT_TOKENS, block)
        # unfused: seven projections a layer and shard, and the head
        want.update(quant_matmul=7 * tp * layers * chunks,
                    quant_gemv=(7 * tp * layers + 1) * steps + chunks)
        if tp == 1:
            # tp = 1 fuses QKV and gate+up again: five launches a layer
            want.update(quant_matmul=LAYER_SHAPES * layers * chunks,
                        quant_gemv=(LAYER_SHAPES * layers + 1) * steps + chunks)
        runs[tp] = mesh_engine_stream(f"[mesh-4bit][tp={tp}]", packed, MESH_SHORT_TOKENS, counts,
                                      want, tp=tp, reference=runs.get(1))
    log(f"[mesh-4bit] phase 17's packed runs took {time.perf_counter() - t0:.1f}s")
    return runs


def mesh_packed_fleet(packed) -> dict:
    """Phase 17's packed fleet after ``mesh_packed``: phase 15's mix,
    greedy, through one packed tp = 2 batcher (the gather path, served on
    this thread after its captures), then through two packed tp = 2
    replicas that ``build_generator`` builds as the server's ``--tp 2
    --replicas 2 --keep-quantized`` does (``pipe_fleet``, no drain: the
    bf16 fleet drains): stream for stream equal, kernels 3 and 4 launched at
    the shard shapes, and one resident tree (the model's tp = 2 placement,
    which every engine aliases: no second copy of the packed row
    splits)."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    t0 = time.perf_counter()
    counts = kernel_counts()
    engine = PipelineEngine(packed, tp=MESH_TP, microbatches=PIPE_SLOTS, max_seq=PIPE_MAX_SEQ,
                            prefill_chunk=CHUNK, pool_pages=POOL_PAGES, page_size=PAGE,
                            paged_attention="gather", device=packed.device)
    batcher = ContinuousBatcher(engine, decode_block=MESH_DECODE_BLOCK)
    graph_line("[mesh-4bit-batch]", batcher.warm_up(blocks=GREEDY_BLOCK))
    counts.reset()
    items, _ = serve_on_this_thread(batcher, pipe_jobs())
    torch.cuda.synchronize()
    one = {"launches": counts.read()}
    want = [[t for t, _ in s] for s in items]
    log(f"[mesh-4bit-batch] {len(want)} requests through one packed tp = 2 batcher: "
        f"{batcher.prefill_chunks} prefill chunks, {batcher.decode_steps} decode steps; "
        f"launches {one['launches']}")
    batcher.close()
    del batcher, engine
    fleet = pipe_fleet("[mesh-4bit-replicas]", packed, counts, want, mesh=dict(tp=MESH_TP),
                       decode_block=MESH_FLEET_DECODE_BLOCK, drain=False, replicas=2,
                       shared_weights="on")
    for run, tag in ((one, "batcher"), (fleet, "replicas")):
        check(all(run["launches"][k] > 0 for k in ("quant_matmul", "quant_gemv",
                                                   "flash_attention", "flash_decode")),
              f"[mesh-4bit-{tag}] launches {run['launches']}")
    log(f"[mesh-4bit-replicas] phase 17's packed fleet took {time.perf_counter() - t0:.1f}s")
    return {"batcher": one, "replicas": fleet}


def mesh_family(tag: str, model, runs=(("tp", MESH_TP, 1),)) -> dict:
    """Phase 17's runs of a family model while its phase has it loaded:
    its single stream at tp = 1 (the reference), then at each (name, tp,
    ep) of ``runs``, 32 greedy tokens after a one-chunk prompt each, held
    to the near-tie rule."""
    t0 = time.perf_counter()
    counts = kernel_counts()
    ids = pipe_ids(MESH_FAMILY_PROMPT)
    out = {"tp1": mesh_engine_stream(f"{tag}[tp=1]", model, MESH_SHORT_TOKENS, counts, {},
                                     ids=ids)}
    for name, tp, ep in runs:
        out[name] = mesh_engine_stream(f"{tag}[tp={tp} ep={ep}]", model, MESH_SHORT_TOKENS,
                                       counts, {}, ids=ids, tp=tp, ep=ep, reference=out["tp1"])
        check(all(n > 0 for k, n in out[name]["launches"].items()
                  if k in ("flash_attention", "flash_decode")), f"{tag} {name} launches")
    log(f"{tag} phase 17's runs took {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ main

# ------------------------------------------------ the families' kernel paths
# Gemma-2-9B's attention (google/gemma-2-9b config.json): 16 query heads over
# 8 KV heads of 256, window 4096 on even layers, attention softcap 50
GEMMA_HEADS = (16, 8, 256)
GEMMA_WINDOW = 4096
GEMMA_CAP = 50.0
GEMMA_MAX_SEQ = 8192
# kernel 1's checks: windows and chunk offsets (a chunk before the window
# cuts, one that straddles it, one past it); the T=1 route's positions
FLASH_WINDOWS = (4096, 1000, 100)
FLASH_OFFSETS = (0, 3840, 4352)
FAMILY_DECODE_POSITIONS = (0, 100, 4095, 4096, 4400, 8191)
# kernel 2's: lengths below, at and past each window, and 0
FAMILY_PAGED_LENGTHS = (0, 1, 100, 101, 999, 1000, 1001, 4095, 4096, 4097, 6000, 8192)
# Mixtral-8x7B's experts (mistralai/Mixtral-8x7B-v0.1): 8 experts, top 2,
# gate/up (14336 x 4096) and down (4096 x 14336)
MIXTRAL_EXPERTS = 8
MIXTRAL_TOP_K = 2
EXPERT_SHAPES = (("gate/up", 14336, 4096), ("down", 4096, 14336))
EXPERT_TOKENS = (1, 8, 16)
# q is scaled so that scores spread over a few units and a cap of 50 (or
# 5) bends them
SCORE_SPREAD = 4.0


def windowed_attention_work(q, k, v, offset, window):
    """FLOPs and bytes of a causal prefill chunk with a sliding window: row
    i sees min(offset + i + 1, window) keys; the K/V rows of [first, end)
    are read once (first: the first row's window start)."""
    b, t, hq, dk = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    keys = sum(min(s, offset + i + 1) - max(0, offset + i + 1 - window if window else 0)
               for i in range(t))
    first = max(0, offset + 1 - window) if window else 0
    rows = min(s, offset + t) - first
    el = q.element_size()
    return (2 * b * hq * (dk + dv) * keys,
            el * (b * t * hq * (dk + dv) + b * rows * hkv * (dk + dv)))


def family_check(label, got, ref, live=None) -> float:
    """One kernel call against its plain version; returns max |error|."""
    torch.cuda.synchronize()
    if live is not None:
        empty_zero = bool((got[~live] == 0).all())
        check(empty_zero, f"{label}: an empty slot is not zeros")
        got, ref = got[live], ref[live]
    err, worst, rel_l2 = kernel_disagreement(got, ref)
    log(f"[kernels] {label}: max_abs_err {err:.3e}, rms(ref) "
        f"{ref.float().pow(2).mean().sqrt().item():.3e}, worst err/limit {worst:.3f} (tol 1), "
        f"relative L2 {rel_l2:.3e} (tol {REL_L2_TOL})")
    check(worst <= 1 and rel_l2 <= REL_L2_TOL, f"{label} disagrees with its plain version")
    return err


def expert_stack(gen, experts, out_dim, in_dim, integer, param_dtype=torch.float16):
    """A packed (E, OUT, IN/8) 4-bit stack on the card, drawn expert by
    expert (``quant_operands``' recipe: random codes with scale 1 and bias
    -8, or a random N(0, 1/IN) weight packed)."""
    parts = [quant_operands(gen, 1, out_dim, in_dim, integer=integer,
                            param_dtype=param_dtype)[1:] for _ in range(experts)]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(3))


def expert_inputs(gen, n, in_dim, integer, per_pair=False, one_expert=None):
    """x (N, IN) or (N, K, IN), bf16, and the (N, K) int32 routed ids:
    random distinct experts per token, or every pair on ``one_expert``."""
    shape = (n, MIXTRAL_TOP_K, in_dim) if per_pair else (n, in_dim)
    if integer:
        x = torch.randint(-4, 4, shape, generator=gen, device="cuda").to(torch.bfloat16)
    else:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    if one_expert is not None:
        idx = torch.full((n, MIXTRAL_TOP_K), one_expert, dtype=torch.int32, device="cuda")
    else:
        idx = torch.stack([torch.randperm(MIXTRAL_EXPERTS, generator=gen, device="cuda")
                           [:MIXTRAL_TOP_K] for _ in range(n)]).to(torch.int32)
    return x, idx


def phase_family_kernels(seed: int) -> dict:
    """The kernels' paths of Qwen3, Gemma-2 and Mixtral against their plain
    versions on the card. Kernel 1 at Gemma-2-9B's shapes (Hq 16, Hkv 8,
    D 256, T 256 over an 8192-row cache): softcap 50 with windows 4096, 1000
    and 100 at chunk offsets 0, 3840 and 4352, the walk as planned, in
    chunks of 512 keys and whole; a cap of 5 and a window of 1; the f32
    kernel. The T=1 route at positions below, at and past the window. Kernel
    2 at the same heads over 256-row pages, bf16 and int8 pools, lengths
    below, at and past each window and 0, the walk as planned, in 64s and
    whole; the FMA kernel (f32). ``quant_gemv_experts`` at Mixtral's
    gate/up and down shapes, N = 1, 8 and 16, K = 2, routed ids random and
    every pair on one expert, bit for bit on integer-valued operands and
    within limits on random bf16. Returns the largest error of each."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm
    from mlx_sharding_tpu_torch.ops.flash_attention import decode_lengths

    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    hq, hkv, d = GEMMA_HEADS
    scale = 256 ** -0.5
    errs = {"flash": 0.0, "decode": 0.0, "paged": 0.0, "experts": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32

    q, k, v = attention_inputs(gen, 1, CHUNK, GEMMA_MAX_SEQ, hq, hkv, d, d, bf16)
    q = q * SCORE_SPREAD
    cases = [(off, w, GEMMA_CAP, None) for w in FLASH_WINDOWS for off in FLASH_OFFSETS]
    cases += [(4352, None, GEMMA_CAP, None), (4352, 1000, GEMMA_CAP, 512),
              (4352, 1000, GEMMA_CAP, 0), (3840, 4096, GEMMA_CAP, 1024), (3840, 1, 5.0, None),
              (4352, 100, 5.0, 0)]
    default = fa.SPLIT_KEYS
    try:
        for off, window, cap, split in cases:
            fa.SPLIT_KEYS = split
            got = fa.flash_attention(q, k, v, off, scale, logit_softcap=cap,
                                     sliding_window=window)
            ref = fa.flash_attention_reference(q, k, v, off, scale, logit_softcap=cap,
                                               sliding_window=window)
            walk = "planned" if split is None else f"split {split}"
            errs["flash"] = max(errs["flash"], family_check(
                f"flash_attention Gemma-2 shapes T={CHUNK} offset {off} softcap {cap} window "
                f"{window} bf16, walk {walk}", got, ref))
    finally:
        fa.SPLIT_KEYS = default
    qf, kf, vf = attention_inputs(gen, 2, 128, 512, 4, 2, 64, 64, f32)
    for off, window in ((0, 50), (256, 100), (384, 1)):
        got = fa.flash_attention(qf * SCORE_SPREAD, kf, vf, off, 0.125, logit_softcap=5.0,
                                 sliding_window=window)
        ref = fa.flash_attention_reference(qf * SCORE_SPREAD, kf, vf, off, 0.125,
                                           logit_softcap=5.0, sliding_window=window)
        family_check(f"flash_attention f32 B=2 T=128 Hq=4 Hkv=2 D=64 offset {off} softcap 5 "
                     f"window {window}", got, ref)

    # the T=1 route over the dense cache's paged view
    qd = (torch.randn((1, 1, hq, d), generator=gen, device="cuda") * SCORE_SPREAD).to(bf16)
    for position in FAMILY_DECODE_POSITIONS:
        pos = torch.tensor([position], dtype=torch.int64, device="cuda")
        lengths = decode_lengths(pos, 1, GEMMA_MAX_SEQ)
        for window in (GEMMA_WINDOW, None):
            got = fa.flash_decode(qd, k, v, pos, scale, lengths=lengths,
                                  logit_softcap=GEMMA_CAP, sliding_window=window)
            ref = fa.flash_decode_reference(qd, k, v, lengths, scale, logit_softcap=GEMMA_CAP,
                                            sliding_window=window)
            errs["decode"] = max(errs["decode"], family_check(
                f"flash_decode Gemma-2 shapes S={GEMMA_MAX_SEQ} position {position} softcap "
                f"{GEMMA_CAP} window {window}", got, ref))
    del q, k, v, qd

    # kernel 2 over the pool
    for pool_dtype in (bf16, torch.int8):
        qp, kp, vp, ks, vs, tables, lens = paged_case(
            gen, FAMILY_PAGED_LENGTHS, hq, hkv, d, PAGE, GEMMA_MAX_SEQ // PAGE, pool_dtype, bf16)
        qp = qp * SCORE_SPREAD
        live = lens > 0
        for window in FLASH_WINDOWS:
            ref = pa.paged_attention_reference(qp, kp, vp, tables, lens, scale,
                                               logit_softcap=GEMMA_CAP, sliding_window=window,
                                               k_scale=ks, v_scale=vs)
            for split in (None, 64, 0):
                default = pa.SPLIT_POSITIONS
                pa.SPLIT_POSITIONS = split
                try:
                    got = pa.paged_attention(qp, kp, vp, tables, lens, scale,
                                             logit_softcap=GEMMA_CAP, sliding_window=window,
                                             k_scale=ks, v_scale=vs)
                finally:
                    pa.SPLIT_POSITIONS = default
                walk = "planned" if split is None else f"split {split}"
                errs["paged"] = max(errs["paged"], family_check(
                    f"paged_attention Gemma-2 shapes M={len(FAMILY_PAGED_LENGTHS)} "
                    f"{str(pool_dtype)[6:]} pool softcap {GEMMA_CAP} window {window}, walk {walk}",
                    got, ref, live))
        del qp, kp, vp, ks, vs
    qp, kp, vp, ks, vs, tables, lens = paged_case(gen, (0, 5, 70, 130, 200), 4, 2, 64, 16, 16,
                                                  f32, f32)
    got = pa.paged_attention(qp * SCORE_SPREAD, kp, vp, tables, lens, 0.125, logit_softcap=5.0,
                             sliding_window=64)
    ref = pa.paged_attention_reference(qp * SCORE_SPREAD, kp, vp, tables, lens, 0.125,
                                       logit_softcap=5.0, sliding_window=64)
    family_check("paged_attention FMA kernel (f32) M=5 page 16 softcap 5 window 64", got, ref,
                 lens > 0)

    # the routed-expert GEMV
    for name, out_dim, in_dim in EXPERT_SHAPES:
        per_pair = name == "down"
        for integer in (True, False):
            stack = expert_stack(gen, MIXTRAL_EXPERTS, out_dim, in_dim, integer)
            for n in EXPERT_TOKENS:
                for one in (None, 5):
                    x, idx = expert_inputs(gen, n, in_dim, integer, per_pair, one)
                    got = qm.quant_gemv_experts(x, idx, *stack, GROUP_SIZE, BITS)
                    ref = qm.quant_gemv_experts_reference(x, idx, *stack, GROUP_SIZE, BITS)
                    label = (f"quant_gemv_experts {name} OUT={out_dim} IN={in_dim} N={n} "
                             f"K={MIXTRAL_TOP_K} {'every pair on expert 5' if one else 'routed'}")
                    if integer:
                        torch.cuda.synchronize()
                        same = torch.equal(got, ref)
                        log(f"[kernels] {label} integer-valued: bit-exact {same}")
                        check(same, f"{label} differs from its plain version on exact operands")
                    else:
                        errs["experts"] = max(errs["experts"], family_check(label, got, ref))
            del stack
    runs = []
    stack = expert_stack(gen, MIXTRAL_EXPERTS, 4096, 14336, False)
    x, idx = expert_inputs(gen, 4, 14336, False, per_pair=True)
    runs = [qm.quant_gemv_experts(x, idx, *stack, GROUP_SIZE, BITS) for _ in range(2)]
    nodes = graph_nodes(lambda: qm.quant_gemv_experts(x, idx, *stack, GROUP_SIZE, BITS))
    torch.cuda.synchronize()
    log(f"[kernels] quant_gemv_experts: two runs bit-identical {torch.equal(*runs)}; one call "
        f"enqueues {nodes}")
    check(torch.equal(*runs), "quant_gemv_experts: two runs differ")
    check(nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0},
          "quant_gemv_experts: one call is not one kernel launch")
    return errs



def sdpa_window_call(q, k, v, offset, scale, window):
    """SDPA over the keys a chunk's rows see with a sliding window (the
    rows of [first, end), the band mask), ``enable_gqa``: a floor only, as
    SDPA takes no logit softcap, so it is not the same function. Timed
    here only; the port never calls it."""
    t = q.shape[1]
    first = max(0, offset + 1 - window) if window else 0
    end = min(k.shape[1], offset + t)
    q_pos = offset + torch.arange(t, device=q.device)[:, None]
    keys = torch.arange(first, end, device=q.device)[None, :]
    mask = (keys <= q_pos) & ((keys > q_pos - window) if window else True)
    qt, kt, vt = q.transpose(1, 2), k[:, first:end].transpose(1, 2), v[:, first:end].transpose(1, 2)

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True).transpose(1, 2)

    return call


def timing_row(label, kern, plain, flops, nbytes, dtype, library=None, floor=None, **extra):
    """One variant's times beside its bound; logs the line."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(ops_ms, bytes_ms)
    lib = "null (no PyTorch call computes it)" if library is None else f"{library:.4f} ms"
    flo = "" if floor is None else f", SDPA without the softcap (a floor, not the function) {floor:.4f} ms"
    log(f"[timing] {label}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library {lib}{flo}, "
        f"bound {bound:.4f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'}; "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), {bound / kern:.1%} of the bound")
    return dict(ms=kern, plain_ms=plain, library_ms=library, floor_ms=floor, bound_ms=bound,
                ops_ms=ops_ms, bytes_ms=bytes_ms, **extra)


def phase_family_timing(seed: int) -> dict:
    """Device times of the new variants at the shapes the families' served
    runs give them, beside bound, plain version and library call: kernel 1
    at Gemma-2-9B's shapes, the 4,400-token prompt's last chunk (offset
    4352) with softcap 50 and window 4096 (even layers) and without the
    window (odd); the T=1 route at position 4400, both ways; kernel 2 over
    the Gemma-2 batcher's four slots (bf16 and int8 pools), both ways; the
    routed-expert GEMV at Mixtral's shapes, N = 1 (the Generator), 4 (the
    batcher's slots) and 16 (the gather path's largest), K = 2, with
    ``_weight_int4pack_mm`` on one expert, times K, as its library call."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm
    from mlx_sharding_tpu_torch.ops.flash_attention import decode_lengths

    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    hq, hkv, d = GEMMA_HEADS
    scale = d ** -0.5
    bf16 = torch.bfloat16
    rows = {"flash": [], "decode": [], "paged": [], "experts": []}
    q, k, v = attention_inputs(gen, 1, CHUNK, GEMMA_MAX_SEQ, hq, hkv, d, d, bf16)
    off = GEMMA_PROMPT // CHUNK * CHUNK
    for window in (GEMMA_WINDOW, None):
        opts = dict(logit_softcap=GEMMA_CAP, sliding_window=window)
        kern = time_ms(lambda: fa.flash_attention(q, k, v, off, scale, **opts))
        plain = time_ms(lambda: fa.flash_attention_reference(q, k, v, off, scale, **opts))
        floor = time_ms(sdpa_window_call(q, k, v, off, scale, window))
        flops, nbytes = windowed_attention_work(q, k, v, off, window)
        rows["flash"].append(timing_row(
            f"flash_attention Gemma-2 shapes T={CHUNK} offset {off} softcap {GEMMA_CAP} window "
            f"{window} bf16 (walk split {fa.plan_split(1, CHUNK, GEMMA_MAX_SEQ, hq, hkv, off, 132, window) or 'whole'})",
            kern, plain, flops, nbytes, bf16, floor=floor, window=window))
    qd = torch.randn((1, 1, hq, d), generator=gen, device="cuda").to(bf16)
    position = GEMMA_PROMPT
    pos = torch.tensor([position], dtype=torch.int64, device="cuda")
    lengths = decode_lengths(pos, 1, GEMMA_MAX_SEQ)
    for window in (GEMMA_WINDOW, None):
        opts = dict(logit_softcap=GEMMA_CAP, sliding_window=window)
        kern = time_ms(lambda: fa.flash_decode(qd, k, v, pos, scale, lengths=lengths, **opts))
        plain = time_ms(lambda: fa.flash_decode_reference(qd, k, v, lengths, scale, **opts))
        floor = time_ms(sdpa_window_call(qd, k, v, position, scale, window))
        flops, nbytes = windowed_attention_work(qd, k, v, position, window)
        rows["decode"].append(timing_row(
            f"flash_decode Gemma-2 shapes S={GEMMA_MAX_SEQ} position {position} softcap "
            f"{GEMMA_CAP} window {window}", kern, plain, flops, nbytes, bf16, floor=floor,
            window=window))
    del q, k, v
    lens_host = tuple(n + 1 for n in GEMMA_BATCH_PROMPTS)
    for pool_dtype in (bf16, torch.int8):
        qp, kp, vp, ks, vs, tables, lens = paged_case(
            gen, lens_host, hq, hkv, d, PAGE, GEMMA_MAX_SEQ // PAGE, pool_dtype, bf16)
        for window in (GEMMA_WINDOW, None):
            opts = dict(logit_softcap=GEMMA_CAP, sliding_window=window, k_scale=ks, v_scale=vs)
            kern = time_ms(lambda: pa.paged_attention(qp, kp, vp, tables, lens, scale, **opts))
            plain = time_ms(lambda: pa.paged_attention_reference(qp, kp, vp, tables, lens, scale,
                                                                 **opts))
            seen = torch.clamp(lens, max=window) if window else lens
            flops, nbytes = paged_work(qp, kp, vp, ks, tables, seen)
            rows["paged"].append(timing_row(
                f"paged_attention Gemma-2 shapes M={len(lens_host)} lengths {list(lens_host)} "
                f"{str(pool_dtype)[6:]} pool softcap {GEMMA_CAP} window {window}",
                kern, plain, flops, nbytes, bf16, window=window, pool=str(pool_dtype)[6:]))
        del qp, kp, vp, ks, vs
    for name, out_dim, in_dim in EXPERT_SHAPES:
        per_pair = name == "down"
        stack = expert_stack(gen, MIXTRAL_EXPERTS, out_dim, in_dim, False)
        lib_weight, why = int4pack_weight(*(t[0] for t in stack))
        for n in (1, 4, 16):
            x, idx = expert_inputs(gen, n, in_dim, False, per_pair)
            kern = time_ms(lambda: qm.quant_gemv_experts(x, idx, *stack, GROUP_SIZE, BITS))
            plain = time_ms(lambda: qm.quant_gemv_experts_reference(x, idx, *stack, GROUP_SIZE,
                                                                    BITS), iters=5)
            lib = None
            if lib_weight is not None:
                x2 = x.reshape(-1, in_dim)[:n]
                lib = MIXTRAL_TOP_K * time_ms(lambda: torch._weight_int4pack_mm(
                    x2, lib_weight[0], GROUP_SIZE, lib_weight[1]))
            # the bytes this run's routing needs: each routed expert's
            # packed rows once, x and the output once
            experts = len(set(idx.flatten().tolist()))
            _, w_bytes = quant_work(0, out_dim, in_dim)
            nbytes = experts * w_bytes + x.numel() * 2 + n * MIXTRAL_TOP_K * out_dim * 2
            flops = 2 * n * MIXTRAL_TOP_K * out_dim * in_dim
            rows["experts"].append(timing_row(
                f"quant_gemv_experts {name} OUT={out_dim} IN={in_dim} N={n} K={MIXTRAL_TOP_K} "
                f"({experts} experts routed; int4pack_mm on one expert x K: "
                f"{'timed' if lib is not None else why})", kern, plain, flops, nbytes, bf16,
                library=lib, shape=name, n=n))
        del stack, lib_weight
    return rows



# ------------------------------------------------------- the model families
# The published config.json of Qwen/Qwen3-8B, google/gemma-2-9b and
# mistralai/Mixtral-8x7B-v0.1, at full width; Mixtral packed in the layout
# of mlx-community/Mixtral-8x7B-Instruct-v0.1-4bit (4 bits, group 64, the
# router dense): its bf16 weights (~93 GB) do not fit the card.
QWEN3_8B = {
    "model_type": "qwen3", "vocab_size": 151936, "hidden_size": 4096,
    "intermediate_size": 12288, "num_hidden_layers": 36, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "max_position_embeddings": 40960, "attention_bias": False, "tie_word_embeddings": False,
}
GEMMA2_9B = {
    "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 3584,
    "intermediate_size": 14336, "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "max_position_embeddings": 8192, "query_pre_attn_scalar": 256, "sliding_window": 4096,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "tie_word_embeddings": True,
}
MIXTRAL_8X7B = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "rms_norm_eps": 1e-5, "rope_theta": 1000000.0,
    "max_position_embeddings": 32768, "num_local_experts": 8, "num_experts_per_tok": 2,
    "sliding_window": None, "tie_word_embeddings": False,
    "quantization": {"group_size": GROUP_SIZE, "bits": BITS},
}
# (key, config, name); each family's single-stream prompt and capacity, and
# the batcher's four prompts: Gemma-2's past its window (4096), so that the
# even layers' window excludes positions in the late prefill chunks and in
# every decode step
FAMILY_RUNS = (("qwen3", QWEN3_8B, "Qwen3-8B"), ("gemma2", GEMMA2_9B, "Gemma-2-9B"),
               ("mixtral", MIXTRAL_8X7B, "Mixtral-8x7B 4-bit"))
GEMMA_PROMPT = 4400
FAMILY_PROMPTS = {"qwen3": 600, "gemma2": GEMMA_PROMPT, "mixtral": 600, "deepseek_v2": 600}
# the served capacity: what the prompt and its tokens need, in whole chunks
# (each chunk offset is one prefill graph to capture: DeepSeek-V2's hold
# ~13k kernels each, the experts' scan, ~2 s of capture apiece). Gemma-2's
# 4,400-token prompt and 64 tokens fit 4,608 (18 chunks); its kernel checks
# run at GEMMA_MAX_SEQ.
FAMILY_MAX_SEQ = {"qwen3": 1024, "gemma2": 18 * CHUNK, "mixtral": 1024,
                  "deepseek_v2": 3 * CHUNK}
FAMILY_TOKENS = 64
# the served Generator's decode blocks (the server's --decode-block 8): a
# capture runs its block's steps eagerly first, so a block of 16 took twice
# the seconds of one of 8 (5-6.5 s a family on an NVIDIA H100 80GB HBM3,
# `scripts/smoke_phases.py families`)
FAMILY_DECODE_BLOCK = 8
GEMMA_BATCH_PROMPTS = (GEMMA_PROMPT, 600, 1000, 2000)
FAMILY_BATCH_PROMPTS = {"qwen3": (600, 300, 200, 100), "gemma2": GEMMA_BATCH_PROMPTS,
                        "mixtral": (600, 300, 200, 100), "deepseek_v2": (600, 300, 200, 100)}
FAMILY_SLOTS = 4
# the f32 parity: 2 layers of the same widths, 32 greedy tokens; the
# kernel path's last-position logits against the plain versions' (fp32
# summation order only)
PARITY_LAYERS = 2
PARITY_FAMILY_TOKENS = 32
F32_LOGITS_RTOL = 1e-4
# DeepSeek-V2's two cache layouts in f32 (tests/test_mla_compressed.py's)
MLA_MODES_TOL = 1e-4


def packed_mixtral(config: dict, seed: int, dtype=torch.bfloat16):
    """A Mixtral model whose projections, expert stacks and vocab pair are
    drawn packed on the card, layer by layer (no dense copy ever exists):
    random 4-bit codes with fp16 scales of a 1/sqrt(IN) weight (the
    embedding's of 0.02) and biases that centre the codes, dense bf16 norms
    and router. ``load_weights`` takes them as a ``keep_quantized`` load."""
    from mlx_sharding_tpu_torch.models import build_model

    model, cfg = build_model(config, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, inter, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    hq, kv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    code_std = math.sqrt((16 ** 2 - 1) / 12)  # of a code uniform on 0..15

    def packed(*shape, std=None):
        *lead, out_dim, in_dim = shape
        words = torch.randint(-2 ** 31, 2 ** 31, (*lead, out_dim, in_dim // 8), generator=gen,
                              device="cuda", dtype=torch.int32)
        base = (std or in_dim ** -0.5) / code_std
        s = (base * (0.5 + torch.rand((*lead, out_dim, in_dim // GROUP_SIZE), generator=gen,
                                      device="cuda"))).to(torch.float16)
        return {"q": words, "scales": s, "biases": (-7.5 * s.float()).to(torch.float16)}

    def dense(*shape, value=None):
        if value is not None:
            return torch.full(shape, value, device="cuda", dtype=dtype)
        return (torch.randn(shape, generator=gen, device="cuda") * shape[-1] ** -0.5).to(dtype)

    sd = {"embed_tokens.weight": packed(cfg.vocab_size, h, std=0.02),
          "final_norm": dense(h, value=1.0), "lm_head.weight": packed(cfg.vocab_size, h)}
    for i in range(cfg.num_local_layers):
        p = f"layers.{i}."
        sd.update({p + "input_norm": dense(h, value=1.0), p + "post_norm": dense(h, value=1.0),
                   p + "q_proj.weight": packed(hq, h), p + "k_proj.weight": packed(kv, h),
                   p + "v_proj.weight": packed(kv, h), p + "o_proj.weight": packed(h, hq),
                   p + "router.weight": dense(e, h), p + "w_gate.weight": packed(e, inter, h),
                   p + "w_up.weight": packed(e, inter, h), p + "w_down.weight": packed(e, h, inter)})
    model.load_weights(sd, "cuda", dtype)
    return model, cfg


def packed_deepseek(config: dict, seed: int, dtype=torch.bfloat16):
    """A DeepSeek-V2 model packed on the card as ``packed_mixtral`` packs
    Mixtral: its projections, expert stacks, shared experts and vocab pair
    at 4 bits, the norms, the router and (compressed mode) ``kv_b_proj``
    dense, as a ``keep_quantized`` load of the MLX checkpoint keeps them."""
    from mlx_sharding_tpu_torch.models import build_model

    model, cfg = build_model(config, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, heads = cfg.hidden_size, cfg.num_attention_heads
    nope, rope_d, v_d, rank = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                               cfg.kv_lora_rank)
    e, mi = cfg.n_routed_experts, cfg.moe_intermediate_size
    si = mi * cfg.n_shared_experts
    code_std = math.sqrt((16 ** 2 - 1) / 12)  # of a code uniform on 0..15

    def packed(*shape, std=None):
        *lead, out_dim, in_dim = shape
        words = torch.randint(-2 ** 31, 2 ** 31, (*lead, out_dim, in_dim // 8), generator=gen,
                              device="cuda", dtype=torch.int32)
        base = (std or in_dim ** -0.5) / code_std
        s = (base * (0.5 + torch.rand((*lead, out_dim, in_dim // GROUP_SIZE), generator=gen,
                                      device="cuda"))).to(torch.float16)
        return {"q": words, "scales": s, "biases": (-7.5 * s.float()).to(torch.float16)}

    def dense(*shape, value=None):
        if value is not None:
            return torch.full(shape, value, device="cuda", dtype=dtype)
        return (torch.randn(shape, generator=gen, device="cuda") * shape[-1] ** -0.5).to(dtype)

    kv_b = dense if model.compressed else packed
    sd = {"embed_tokens.weight": packed(cfg.vocab_size, h, std=0.02),
          "final_norm": dense(h, value=1.0), "lm_head.weight": packed(cfg.vocab_size, h)}
    for i, layer in enumerate(model.layers):
        p = f"layers.{i}."
        sd.update({p + "input_norm": dense(h, value=1.0), p + "post_norm": dense(h, value=1.0),
                   p + "kv_a_norm": dense(rank, value=1.0),
                   p + "q_proj.weight": packed(heads * (nope + rope_d), h),
                   p + "kv_a_proj.weight": packed(rank + rope_d, h),
                   p + "kv_b_proj.weight": kv_b(heads * (nope + v_d), rank),
                   p + "o_proj.weight": packed(h, heads * v_d)})
        if layer.moe:
            sd.update({p + "router.weight": dense(e, h), p + "w_gate.weight": packed(e, mi, h),
                       p + "w_up.weight": packed(e, mi, h), p + "w_down.weight": packed(e, h, mi),
                       p + "shared_gate.weight": packed(si, h),
                       p + "shared_up.weight": packed(si, h),
                       p + "shared_down.weight": packed(h, si)})
        else:
            inter = cfg.intermediate_size
            sd.update({p + "gate_proj.weight": packed(inter, h), p + "up_proj.weight": packed(inter, h),
                       p + "down_proj.weight": packed(h, inter)})
    model.load_weights(sd, "cuda", dtype)
    return model, cfg


def family_model(key: str, config: dict, seed: int, dtype=torch.bfloat16, layers=None):
    """The family's model at full width (``layers`` cuts its depth), random
    weights from ``seed`` drawn on the card; Mixtral packed, DeepSeek-V2
    packed when its config has ``quantization``."""
    from mlx_sharding_tpu_torch.models import build_model

    if layers is not None:
        config = {**config, "num_hidden_layers": layers}
    if key == "mixtral":
        return packed_mixtral(config, seed, dtype)
    if config.get("quantization"):
        return packed_deepseek(config, seed, dtype)
    model, cfg = build_model(config, dtype=dtype)
    model.init_params(torch.Generator(device="cuda").manual_seed(seed), "cuda")
    return model, cfg


def served_quant_launches(model, chunks: int, steps: int) -> dict:
    """The packed kernels' launches that ``chunks`` prefill chunks and
    ``steps`` decode steps imply, from the model's modules as fused: a
    chunk runs every packed projection of a layer through the matmul once
    and every packed expert stack once per expert (the scan), the head on
    its one row through the GEMV; a decode step runs each packed projection
    and the head through the GEMV and each stack through the routed GEMV.
    A dense model launches none."""
    from mlx_sharding_tpu_torch.models.base import QuantizedLinear

    proj = stacks = experts = 0
    for layer in model.layers:
        for m in layer.children():
            if isinstance(m, QuantizedLinear):
                if m.q.dim() == 3:
                    stacks += 1
                    experts += m.q.shape[0]
                else:
                    proj += 1
    head = model.embed_tokens if model.head_is_tied() else model.lm_head
    heads = int(isinstance(head, QuantizedLinear))
    return {"quant_matmul": chunks * (proj + experts), "quant_gemv": (chunks + steps) * heads
            + steps * proj, "quant_gemv_experts": steps * stacks}


def step_weight_bytes(model) -> int:
    """The weight bytes one decode step of one stream reads: every
    parameter and buffer once, the embedding table but its one row (unless
    it is the head), and of each expert stack the ``num_experts_per_tok``
    experts a token routes to."""
    top_k = getattr(model.config, "num_experts_per_tok", None)
    total = 0
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        n = t.numel() * t.element_size()
        if name.startswith("embed_tokens") and not model.head_is_tied():
            n //= t.shape[0]
        elif any(f".{s}." in name for s in ("w_gate", "w_up", "w_down")):
            n = n * top_k // t.shape[0]
        total += n
    return total


def family_pages(prompts, tokens: int) -> int:
    """Pages a batcher's pool needs to hold every request at once."""
    return sum(-(-(n + tokens) // PAGE) for n in prompts) + 1


class kernel_counts:
    """The launch counters of every kernel entry point (those a graph replay
    bumps): zeroed by :meth:`reset`, read by :meth:`read`."""

    def __init__(self):
        from mlx_sharding_tpu_torch.graphs import counted_wrappers

        self.fns = {fn.__name__: fn for fn in counted_wrappers()}

    def reset(self) -> None:
        for fn in self.fns.values():
            fn.launches = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}


class plain_entry_points:
    """Within the block, every kernel entry point the models' forwards call
    is swapped, in this process only, for its plain version: the reference
    forward of the f32 parity run. No entry point of the package has a
    switch for this."""

    def __enter__(self):
        from mlx_sharding_tpu_torch.ops import attention as attention_mod
        from mlx_sharding_tpu_torch.ops import flash_attention as fa
        from mlx_sharding_tpu_torch.ops import moe as moe_mod
        from mlx_sharding_tpu_torch.ops import quant as quant_mod
        from mlx_sharding_tpu_torch.ops import quant_matmul as qm

        def prefill(q, k, v, offset, scale, *, kv_index=None, **opts):
            if kv_index is not None:
                k, v = fa.select_kv_rows(k, v, kv_index)
            return fa.flash_attention_reference(q, k, v, offset, scale, **opts)

        def decode(q, k, v, position, scale, *, lengths=None, **opts):
            if lengths is None:
                lengths = fa.decode_lengths(position, q.shape[0], k.shape[1])
            return fa.flash_decode_reference(q, k, v, lengths, scale, **opts)

        self.swaps = [(attention_mod, "flash_attention", prefill),
                      (attention_mod, "flash_decode", decode),
                      (quant_mod, "quant_gemv", qm.quant_matmul_reference),
                      (quant_mod, "quant_matmul", qm.quant_matmul_reference),
                      (moe_mod, "quant_gemv_experts", qm.quant_gemv_experts_reference)]
        self.saved = [getattr(mod, name) for mod, name, _ in self.swaps]
        for mod, name, fn in self.swaps:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.swaps, self.saved):
            setattr(mod, name, fn)


def family_serve(tag: str, key: str, model, cfg, counts) -> dict:
    """The Generator through its graphs behind the port's server: one
    streamed request of the family's prompt and ``FAMILY_TOKENS`` forced
    tokens (TTFT, decode tok/s), every route's launches checked against the
    chunks and steps, no eager forward; one decode step's device ms; then
    plain greedy decode of the prompt (tokens and near-ties) for the
    batcher's comparison."""
    from mlx_sharding_tpu_torch.generate import REPETITION_WINDOW, Generator
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, make_server

    tok = ByteTokenizer()
    n = FAMILY_PROMPTS[key]
    block = FAMILY_DECODE_BLOCK
    gen = Generator(model, max_seq=FAMILY_MAX_SEQ[key], prefill_chunk=CHUNK, decode_block=block)
    # the prefill graphs and the one decode block served (greedy, no
    # logprobs) at load: captured on the warm-up request instead, on the
    # server's thread, a block of 16 steps took 8.8-14.3 s against 5-7 s
    # here (an NVIDIA H100 80GB HBM3)
    graph_line(tag, gen.warm_up(blocks=GREEDY_BLOCK))
    server = make_server(ModelProvider(gen, tok, model_name=key), "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    layers, chunks = cfg.num_hidden_layers, -(-n // CHUNK)
    steps = block * -(-(FAMILY_TOKENS - 1) // block)
    try:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"{tag} warm-up request failed: {status}")
        counts.reset()
        served = ServedRun(gen, model)
        status, events, t_head, t_end = post(port, "/v1/completions", {
            "prompt": mix_prompt(0, n), "max_tokens": FAMILY_TOKENS, "stream": True,
            "logit_bias": {"65": 100.0}}, stream=True)
        check(status == 200 and stream_text(events, chat=False) == "A" * FAMILY_TOKENS,
              f"{tag} streamed completion: status {status}")
        launches = counts.read()
        served.check(tag, chunks + steps // block)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    stats = {"ttft_s": t_head, "decode_tok_s": (FAMILY_TOKENS - 1) / (t_end - t_head)}
    log(f"{tag} /v1/completions stream, {n}-token prompt, {FAMILY_TOKENS} tokens: TTFT "
        f"{t_head * 1e3:.1f} ms, decode {stats['decode_tok_s']:.2f} tok/s (host clock at the "
        f"client); launches {launches}")
    want = {"flash_attention": layers * chunks, "flash_decode": layers * steps,
            "paged_attention": 0, **served_quant_launches(model, chunks, steps)}
    log(f"{tag} launches expected from {chunks} chunks and {steps} decode steps of {layers} "
        f"layers: {want}")
    check(launches == want, f"{tag} a route's launches disagree with the chunks and steps")
    list(gen.generate_step(tok.encode(mix_prompt(0, n)), max_tokens=1))
    step = step_numbers(lambda: gen.run_block(block, REPETITION_WINDOW, False, False),
                        calls=2, steps=block,
                        profiled=1)
    stats["step"] = step
    busy = "not measured" if step["busy"] is None else f"{100 * step['busy']:.1f}%"
    w_bytes = step_weight_bytes(model)
    log(f"{tag} graph decode step: host {step['host_ms']:.3f} ms, wall {step['wall_ms']:.3f} ms, "
        f"device {step['device_ms']:.3f} ms; device busy {busy} of the wall; weight bytes a "
        f"step reads {w_bytes / 1e9:.3f} GB, {w_bytes / PEAK_BYTES * 1e3:.3f} ms at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s ({step['device_ms'] / (w_bytes / PEAK_BYTES * 1e3):.2f}x); "
        + ", ".join(f"{nm} {ms:.3f}" for nm, ms in step["kernels"]))
    ids = tok.encode(mix_prompt(1, n))
    # the tokens and near-ties alone: the decode rate is the streamed request's
    toks, _, ties = plain_reference(tag, gen, ids, FAMILY_TOKENS, timed=False)
    stats.update(greedy=(ids, toks, ties), launches=launches)
    del gen
    return stats


def family_batch(tag: str, key: str, model, cfg, counts, greedy) -> dict:
    """The paged batcher: ``--concurrent 4 --paged-pool P --page-size 256``
    with async ticks behind the port's server, four streamed forced
    requests and the Generator's greedy prompt beside them; TTFTs, the
    mix's tok/s, the launches against the batcher's own chunks and steps,
    no eager forward; the greedy stream against the Generator's (a
    divergence only at a near-tie)."""
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
    from mlx_sharding_tpu_torch.server.openai_api import ModelProvider, make_server

    prompts = FAMILY_BATCH_PROMPTS[key]
    ids, want, ties = greedy
    pages = family_pages((*prompts, len(ids)), FAMILY_TOKENS)
    engine = PipelineEngine(model, microbatches=FAMILY_SLOTS, max_seq=FAMILY_MAX_SEQ[key],
                            prefill_chunk=CHUNK, pool_pages=pages, page_size=PAGE,
                            device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8, draft="off")
    log(f"{tag} batcher: {FAMILY_SLOTS} slots, pool {pages} pages of {PAGE} tokens "
        f"({batcher.cache.nbytes / 1e6:.1f} MB of K/V), {batcher.async_reason}")
    # the decode block its greedy requests run, and no other
    graph_line(tag, batcher.warm_up(**GREEDY_ONLY))
    tok = ByteTokenizer()
    server = make_server(ModelProvider(batcher, tok, model_name=key), "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results = [None] * len(prompts)
    greedy_out = []
    try:
        status, _, _, _ = post(port, "/v1/completions", {"prompt": "warm up", "max_tokens": 2})
        check(status == 200, f"{tag} warm-up request failed: {status}")
        counts.reset()
        steps0, chunks0 = batcher.decode_steps, batcher.prefill_chunks
        served = ServedRun(batcher, engine)

        def send(i):
            results[i] = post(port, "/v1/completions", {
                "prompt": mix_prompt(10 + i, prompts[i]), "max_tokens": FAMILY_TOKENS,
                "stream": True, "logit_bias": {"65": 100.0}}, stream=True)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
        stream = batcher.generate_step(ids, max_tokens=FAMILY_TOKENS)
        threads.append(threading.Thread(target=lambda: greedy_out.extend(stream)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = counts.read()
        steps = batcher.decode_steps - steps0
        chunks = batcher.prefill_chunks - chunks0
        served.check(tag, steps // batcher.decode_block + chunks)
        tick_line(tag, batcher)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.close()
    ttfts = []
    for i, res in enumerate(results):
        check(res is not None, f"{tag} request {i} did not return")
        status, events, t_head, t_end = res
        check(status == 200 and stream_text(events, chat=False) == "A" * FAMILY_TOKENS,
              f"{tag} request {i}: status {status}")
        ttfts.append(t_head)
    tokens = FAMILY_TOKENS * (len(prompts) + 1)
    log(f"{tag} four streamed requests of {list(prompts)}-token prompts and the greedy one, "
        f"{FAMILY_TOKENS} tokens each: TTFTs "
        + ", ".join(f"{t * 1e3:.1f}" for t in ttfts)
        + f" ms; {tokens} tokens in {wall:.3f}s, {tokens / wall:.1f} tok/s for the mix")
    layers = cfg.num_hidden_layers
    log(f"{tag} batcher: {chunks} prefill chunks, {steps} decode steps; launches {launches}")
    check(launches["paged_attention"] == layers * steps,
          f"{tag} paged launches disagree with {layers} layers x {steps} decode steps")
    check(launches["flash_attention"] == layers * chunks,
          f"{tag} flash launches disagree with {layers} layers x {chunks} prefill chunks")
    experts = served_quant_launches(model, chunks, steps)["quant_gemv_experts"]
    check(launches["quant_gemv_experts"] == experts,
          f"{tag} routed-expert launches {launches['quant_gemv_experts']} disagree with the "
          f"{experts} that {steps} steps imply")
    got = [t for t, _ in greedy_out]
    same = agreement(tag, "the batcher's greedy stream against the Generator's", got, want, ties)
    log(f"{tag} greedy: the first {same} of {len(want)} tokens equal the Generator's")
    return {"ttfts": ttfts, "tok_s": tokens / wall, "launches": launches}


def family_parity(tag: str, key: str, config: dict, seed: int) -> None:
    """f32 at ``PARITY_LAYERS`` layers of the same widths (Mixtral packed):
    ``PARITY_FAMILY_TOKENS`` greedy tokens through the Generator's graphs
    and through the paged batcher, token-identical; the last-position
    logits of one prefill against the forward whose kernel entry points are
    swapped for their plain versions."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.parallel import PipelineEngine
    from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

    model, cfg = family_model(key, config, seed + 1, torch.float32, layers=PARITY_LAYERS)
    n = FAMILY_PROMPTS[key]
    ids = ByteTokenizer().encode(mix_prompt(2, n))
    max_seq = FAMILY_MAX_SEQ[key]
    gen = Generator(model, max_seq=max_seq, prefill_chunk=CHUNK)
    graph_line(tag, gen.warm_up(decode_blocks=False))
    kern = gen.run_prefill(np.asarray([ids], np.int64)).float()
    want = [t for t, _ in gen.generate_step(ids, max_tokens=PARITY_FAMILY_TOKENS)]
    del gen
    with plain_entry_points():
        plain_gen = Generator(model, max_seq=max_seq, prefill_chunk=CHUNK, cuda_graphs=False)
        plain = plain_gen.run_prefill(np.asarray([ids], np.int64)).float()
        del plain_gen
    rel = ((kern - plain).norm() / plain.norm()).item()
    log(f"{tag} f32 {PARITY_LAYERS} layers, {n}-token prompt: last-position logits, kernels "
        f"against plain versions: relative L2 {rel:.3e} (tol {F32_LOGITS_RTOL}), same argmax "
        f"{bool((kern.argmax(-1) == plain.argmax(-1)).all())}")
    check(bool(torch.isfinite(kern).all()) and kern.shape == (1, cfg.vocab_size),
          f"{tag} f32 logits not finite or of the wrong shape")
    check(rel <= F32_LOGITS_RTOL, f"{tag} the kernel path disagrees with the plain versions")
    if key == "deepseek_v2":
        mla_modes_parity(tag, config, seed, ids, kern)
    engine = PipelineEngine(model, microbatches=FAMILY_SLOTS, max_seq=max_seq,
                            prefill_chunk=CHUNK, pool_pages=family_pages([n], PARITY_FAMILY_TOKENS),
                            page_size=PAGE, device=model.device)
    batcher = ContinuousBatcher(engine, decode_block=8, draft="off")
    batcher.warm_up()
    items, _ = serve_on_this_thread(batcher, [(ids, dict(max_tokens=PARITY_FAMILY_TOKENS))])
    batcher.close()
    got = [t for t, _ in items[0]]
    log(f"{tag} f32 {PARITY_LAYERS} layers: {PARITY_FAMILY_TOKENS} greedy tokens through the "
        f"Generator's graphs and through the paged batcher: token-identical {got == want}")
    check(got == want, f"{tag} the batcher's f32 greedy stream differs from the Generator's")
    del batcher, engine, model


def mla_modes_parity(tag: str, config: dict, seed: int, ids: list, compressed) -> None:
    """The same f32 weights with ``mla_cache_mode="full"`` (per-head K of
    192 and V of 128; kernel 1 at 192 / 128, the T=1 route without
    values_from_k): its last-position logits within ``MLA_MODES_TOL`` of the
    compressed cache's (``compressed``), as JAX's test holds them."""
    from mlx_sharding_tpu_torch.generate import Generator

    model, _ = family_model("deepseek_v2", {**config, "mla_cache_mode": "full"}, seed + 1,
                            torch.float32, layers=PARITY_LAYERS)
    gen = Generator(model, max_seq=FAMILY_MAX_SEQ["deepseek_v2"], prefill_chunk=CHUNK)
    graph_line(tag, gen.warm_up(decode_blocks=False))
    full = gen.run_prefill(np.asarray([ids], np.int64)).float()
    diff = (compressed - full).abs()
    worst = (diff / (MLA_MODES_TOL + MLA_MODES_TOL * full.abs())).max().item()
    log(f"{tag} f32 {PARITY_LAYERS} layers: last-position logits, compressed cache against full: "
        f"max |diff| {diff.max().item():.3e}, worst |diff| / (atol + rtol |full|) {worst:.3f} "
        f"(tol 1 at rtol = atol = {MLA_MODES_TOL})")
    check(worst <= 1, f"{tag} the compressed cache's logits disagree with the full cache's")
    del gen, model


def phase_families(seed: int, lap, runs=FAMILY_RUNS, parity=True, after=None,
                   after_what: str = "phase 15 at pp = 1 and 2") -> dict:
    """Qwen3-8B, Gemma-2-9B and Mixtral-8x7B (4-bit) at full width (or
    ``runs``), one at a time, each freed before the next: served through the
    Generator's graphs and through the paged batcher, then ``after(name,
    model)`` if given (its result under ``"after"`` when not None), then,
    with ``parity``, the f32 parity at 2 layers. Returns each run's
    numbers."""
    counts = kernel_counts()
    out = {}
    for key, config, name in runs:
        tag = f"[{key}]"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, cfg = family_model(key, config, seed)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in (*model.parameters(), *model.buffers()))
        log(f"{tag} {name} full width, {cfg.num_hidden_layers} layers, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights drawn on the card in "
            f"{time.perf_counter() - t0:.1f}s ({n_params / 1e9:.3f} B stored elements)")
        stats = family_serve(tag, key, model, cfg, counts)
        stats["batch"] = family_batch(tag, key, model, cfg, counts, stats.pop("greedy"))
        log(f"{tag} torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        extra = after(name, model) if after is not None else None
        if extra is not None:
            stats["after"] = extra
            lap(f"{name}, {after_what}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if parity:
            family_parity(tag, key, config, seed)
        out[name] = stats
        lap(f"{name}")
    return out




def family_records(rows: dict, errs: dict, families: dict) -> list:
    """The kernels-line entries of the families' variants: kernel 1 and its
    T=1 route with Gemma-2's softcap and window (its even layers' launches
    and times; the odd layers' softcap-only times beside them), kernel 2
    likewise over the batcher's slots (bf16 pool), and the routed-expert
    GEMV at N = 1 (a decode step's mean: gate and up, then down). Their
    launches are the families' served runs'."""
    gemma, mixtral = families["Gemma-2-9B"], families["Mixtral-8x7B 4-bit"]

    def entry(name, source, replaces, launches, err, row, **extra):
        return {"name": name, "route": "cuda", "source": f"mlx_sharding_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes",
                "library_ms": row["library_ms"], **extra}

    def pick(kind, **want):
        return next(r for r in rows[kind] if all(r[k] == v for k, v in want.items()))

    flash, flash_odd = pick("flash", window=GEMMA_WINDOW), pick("flash", window=None)
    dec, dec_odd = pick("decode", window=GEMMA_WINDOW), pick("decode", window=None)
    paged = pick("paged", window=GEMMA_WINDOW, pool="bfloat16")
    paged_odd = pick("paged", window=None, pool="bfloat16")
    n1 = [r for r in rows["experts"] if r["n"] == 1]
    weights = [2 if r["shape"] == "gate/up" else 1 for r in n1]
    expert_row = {key: (None if any(r[key] is None for r in n1)
                        else sum(w * r[key] for w, r in zip(weights, n1)) / sum(weights))
                  for key in ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms")}
    return [
        entry("flash_attention_softcap_window", "flash_attention.cu",
              "mlx_sharding_tpu/ops/flash_attention.py:127",
              gemma["launches"]["flash_attention"] + gemma["batch"]["launches"]["flash_attention"],
              errs["flash"], flash, floor_ms=flash["floor_ms"], ms_no_window=flash_odd["ms"]),
        entry("flash_decode_softcap_window", "paged_attention.cu",
              "mlx_sharding_tpu/ops/flash_attention.py:127", gemma["launches"]["flash_decode"],
              errs["decode"], dec, floor_ms=dec["floor_ms"], ms_no_window=dec_odd["ms"]),
        entry("paged_attention_softcap_window", "paged_attention.cu",
              "mlx_sharding_tpu/ops/paged_attention.py:153",
              gemma["batch"]["launches"]["paged_attention"], errs["paged"], paged,
              ms_no_window=paged_odd["ms"]),
        entry("quant_gemv_experts", "quant_matmul.cu", "mlx_sharding_tpu/ops/quant_matmul.py:382",
              mixtral["launches"]["quant_gemv_experts"]
              + mixtral["batch"]["launches"]["quant_gemv_experts"], errs["experts"], expert_row,
              library="_weight_int4pack_mm on one expert, times K"),
    ]


# ------------------------------------------------------------- DeepSeek-V2
# The published config.json of deepseek-ai/DeepSeek-Coder-V2-Lite-Instruct
# (the repo's headline model, bench.py's DSV2_LITE), at full width and
# depth; packed in the layout of
# mlx-community/DeepSeek-Coder-V2-Lite-Instruct-4bit (group 64, 4 bits, the
# router and kv_b dense) by adding ``quantization``. DeepSeek-V2's own
# head count (deepseek-ai/DeepSeek-V2: 128 heads, q-LoRA 1536) sets the
# kernels' GQA group of 128 in the kernel checks.
DSV2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_rope_head_dim": 64, "qk_nope_head_dim": 128, "v_head_dim": 128,
    "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
    "first_k_dense_replace": 1, "norm_topk_prob": False, "routed_scaling_factor": 1.0,
    "topk_method": "greedy", "rope_theta": 10000.0,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
    "max_position_embeddings": 163840, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
}
DSV2_HEADS = 128  # deepseek-ai/DeepSeek-V2's num_attention_heads
MLA_DK, MLA_DV = 576, 512  # kv_lora_rank + qk_rope_head_dim, kv_lora_rank
MLA_OFFSETS = (0, 256, 512)  # the 600-token prompt's chunks
MLA_DECODE_POSITION = 600
MLA_BATCH_LENGTHS = (601, 301, 201, 101)  # the batcher's four prompts' first decode step
# the packed Lite's projection shapes (name, OUT, IN): q, kv_a, o, layer 0's
# gate/up and down, the experts' and the shared experts' gate/up and down,
# the head
DSV2_QUANT_SHAPES = (("q_proj", 3072, 2048), ("kv_a_proj", 576, 2048), ("o_proj", 2048, 2048),
                     ("dense gate/up", 10944, 2048), ("dense down", 2048, 10944),
                     ("expert gate/up", 1408, 2048), ("expert down", 2048, 1408),
                     ("shared gate/up", 2816, 2048), ("shared down", 2048, 2816),
                     ("lm_head", 102400, 2048))
DSV2_EXPERT_SHAPES = (("gate/up", 1408, 2048), ("down", 2048, 1408))


def mla_scale() -> float:
    """The Lite model's softmax scale (YaRN's mscale_all_dim included)."""
    from mlx_sharding_tpu_torch.models import build_model

    return build_model(DSV2_LITE)[0].scale


def mla_cache(gen, b, s, dtype):
    """One layer of a two-layer compressed cache (B, S, 1, 576) and its
    values, a view of its first 512 columns (what the model passes)."""
    kc = torch.randn((2, b, s, 1, MLA_DK), generator=gen, device="cuda").to(dtype)
    return kc[1], kc[1][..., :MLA_DV]


def mla_attention_work(q, k, offset):
    """FLOPs and bytes of a causal MLA chunk: each row's keys as in
    ``attention_work``; the K rows of the causal prefix read once (the
    values are their first columns), q and the output once."""
    b, t, hq, dk = q.shape
    s = k.shape[1]
    keys = sum(min(s, offset + i + 1) for i in range(t))
    el = q.element_size()
    kv_len = min(s, offset + t)
    return (2 * b * hq * (dk + MLA_DV) * keys,
            el * (b * t * hq * (dk + MLA_DV) + b * kv_len * dk))


def mla_paged_work(q, k, ks, tables, lens):
    """FLOPs and bytes of the paged decode with ``values_from_k``: each
    slot's live K rows once (the values are their first columns; an int8
    pool's scale with them), q, the output, the live table entries and the
    lengths once."""
    m, hq, dk = q.shape
    page = k.shape[1]
    lengths = lens.tolist()
    rows = sum(lengths)
    row_bytes = dk * k.element_size() + (4 if ks is not None else 0)
    live_pages = sum(-(-n // page) for n in lengths)
    nbytes = m * hq * (dk + MLA_DV) * q.element_size() + rows * row_bytes + 4 * (live_pages + m)
    return 2 * hq * (dk + MLA_DV) * rows, nbytes


def mla_paged_case(gen, lengths, hq, page, spg, pool_dtype, q_dtype):
    """``paged_case`` with MLA's compressed pool: one latent head of 576,
    a dummy V pool of width 1."""
    return paged_case(gen, lengths, hq, 1, MLA_DK, page, spg, pool_dtype, q_dtype, dv=1)


def phase_mla_kernels(seed: int) -> dict:
    """DeepSeek-V2's routes against their plain versions on the card. Kernel
    1's MLA build (Dk 576, v a view of k's first 512 columns, one KV head)
    at the Lite's group of 16 (chunk offsets 0, 256 and 3840; at 3840 the
    walk planned, in chunks of 512 keys and whole) and V2's group of 128
    (offsets 0 and 3840), and its f32 build; the T=1 route's
    ``values_from_k`` at positions 0, 600 and 4095 (both groups, and f32);
    kernel 2's ``values_from_k`` over bf16 and int8 pools of 256-row pages
    (lengths 0 to 4096, the walk planned, in 64s and whole; V2's group; the
    FMA kernel in f32), two runs bit-identical, one captured call one kernel
    node, and a softcap refused with it. Then kernels 3 and 4 at the packed
    Lite's shapes (M = 1, 4, 88, 256; the routed GEMV at E 64, K 6), bit for
    bit on integer-valued operands and within limits on random bf16.
    Returns the largest error of each route."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.ops import quant_matmul as qm
    from mlx_sharding_tpu_torch.ops.flash_attention import decode_lengths

    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    scale = mla_scale()
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {"flash": 0.0, "decode": 0.0, "paged": 0.0}
    k, v = mla_cache(gen, 1, MAX_SEQ, bf16)
    default = fa.SPLIT_KEYS
    try:
        for hq, cases in ((16, ((0, None), (256, None), (3840, None), (3840, 512), (3840, 0))),
                          (DSV2_HEADS, ((0, None), (3840, None)))):
            q = torch.randn((1, CHUNK, hq, MLA_DK), generator=gen, device="cuda").to(bf16)
            for off, split in cases:
                fa.SPLIT_KEYS = split
                got = fa.flash_attention(q, k, v, off, scale)
                ref = fa.flash_attention_reference(q, k, v, off, scale)
                walk = "planned" if split is None else f"split {split}"
                errs["flash"] = max(errs["flash"], family_check(
                    f"flash_attention MLA Dk {MLA_DK} Dv {MLA_DV} (v from k) Hq={hq} Hkv=1 "
                    f"T={CHUNK} offset {off} bf16, walk {walk}", got, ref))
    finally:
        fa.SPLIT_KEYS = default
    kf, vf = mla_cache(gen, 1, 512, f32)
    qf = torch.randn((1, 128, 16, MLA_DK), generator=gen, device="cuda")
    for off in (0, 256):
        family_check(f"flash_attention MLA f32 Hq=16 T=128 S=512 offset {off}",
                     fa.flash_attention(qf, kf, vf, off, scale),
                     fa.flash_attention_reference(qf, kf, vf, off, scale))
    for hq in (16, DSV2_HEADS):
        qd = torch.randn((1, 1, hq, MLA_DK), generator=gen, device="cuda").to(bf16)
        for position in DECODE_POSITIONS:
            pos = torch.tensor([position], dtype=torch.int64, device="cuda")
            lengths = decode_lengths(pos, 1, MAX_SEQ)
            errs["decode"] = max(errs["decode"], family_check(
                f"flash_decode MLA (values_from_k {MLA_DV}) Hq={hq} position {position}",
                fa.flash_decode(qd, k, v, pos, scale, lengths=lengths),
                fa.flash_decode_reference(qd, k, v, lengths, scale)))
    pos = torch.tensor([300], dtype=torch.int64, device="cuda")
    qd = torch.randn((1, 1, 16, MLA_DK), generator=gen, device="cuda")
    family_check("flash_decode MLA f32 (FMA kernel) position 300",
                 fa.flash_decode(qd, kf, vf, pos, scale),
                 fa.flash_decode_reference(qd, kf, vf, decode_lengths(pos, 1, 512), scale))
    del k, v, q, kf, vf, qf

    for pool_dtype in (bf16, torch.int8):
        for hq, lengths, splits in ((16, PAGED_LENGTHS, (None, 64, 0)),
                                    (DSV2_HEADS, MLA_BATCH_LENGTHS, (None, 0))):
            qp, kp, vp, ks, vs, tables, lens = mla_paged_case(gen, lengths, hq, PAGE,
                                                             MAX_SEQ // PAGE, pool_dtype, bf16)
            ref = pa.paged_attention_reference(qp, kp, vp, tables, lens, scale,
                                               values_from_k=MLA_DV, k_scale=ks, v_scale=vs)
            for split in splits:
                default = pa.SPLIT_POSITIONS
                pa.SPLIT_POSITIONS = split
                try:
                    got = pa.paged_attention(qp, kp, vp, tables, lens, scale,
                                             values_from_k=MLA_DV, k_scale=ks, v_scale=vs)
                finally:
                    pa.SPLIT_POSITIONS = default
                walk = "planned" if split is None else f"split {split}"
                errs["paged"] = max(errs["paged"], family_check(
                    f"paged_attention values_from_k {MLA_DV} Dk {MLA_DK} Hq={hq} "
                    f"M={len(lengths)} {str(pool_dtype)[6:]} pool, walk {walk}", got, ref,
                    lens > 0))
            if hq == 16 and pool_dtype == bf16:
                call = lambda: pa.paged_attention(qp, kp, vp, tables, lens, scale,  # noqa: E731
                                                  values_from_k=MLA_DV)
                runs = [call() for _ in range(2)]
                nodes = graph_nodes(call)
                torch.cuda.synchronize()
                log(f"[kernels] paged_attention values_from_k: two runs bit-identical "
                    f"{torch.equal(*runs)}; one call enqueues {nodes}")
                check(torch.equal(*runs), "paged_attention values_from_k: two runs differ")
                check(nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0},
                      "paged_attention values_from_k: one call is not one kernel launch")
                try:
                    pa.paged_attention(qp, kp, vp, tables, lens, scale, values_from_k=MLA_DV,
                                       logit_softcap=30.0)
                    refused = False
                except ValueError:
                    refused = True
                log(f"[kernels] paged_attention values_from_k with a softcap refused: {refused}")
                check(refused, "paged_attention took values_from_k with a softcap")
            del qp, kp, vp, ks, vs
    qp, kp, vp, ks, vs, tables, lens = mla_paged_case(gen, (0, 5, 70, 130, 200), 16, 16, 16,
                                                      f32, f32)
    family_check("paged_attention values_from_k FMA kernel (f32) M=5 page 16",
                 pa.paged_attention(qp, kp, vp, tables, lens, scale, values_from_k=MLA_DV),
                 pa.paged_attention_reference(qp, kp, vp, tables, lens, scale,
                                              values_from_k=MLA_DV), lens > 0)

    # kernels 3 and 4 at the packed Lite's shapes
    for name, out_dim, in_dim in DSV2_QUANT_SHAPES:
        for integer in (True, False):
            x, q, s, b = quant_operands(gen, PREFILL_M, out_dim, in_dim, integer=integer)
            for kernel, m in (("quant_gemv", 1), ("quant_gemv", 4), ("quant_matmul", 88),
                              ("quant_matmul", PREFILL_M)):
                if name == "lm_head" and m == PREFILL_M:
                    continue  # the head runs on one row of a chunk
                check_quant(kernel, x[:m], q, s, b, GROUP_SIZE, BITS, integer,
                            f"DeepSeek-V2-Lite {name} OUT={out_dim} IN={in_dim} M={m}")
            del x, q, s, b
    for name, out_dim, in_dim in DSV2_EXPERT_SHAPES:
        per_pair = name == "down"
        for integer in (True, False):
            stack = expert_stack(gen, DSV2_LITE["n_routed_experts"], out_dim, in_dim, integer)
            for n in (1, 4):
                shape = (n, 6, in_dim) if per_pair else (n, in_dim)
                x = (torch.randint(-4, 4, shape, generator=gen, device="cuda") if integer
                     else torch.randn(shape, generator=gen, device="cuda")).to(bf16)
                idx = torch.stack([torch.randperm(64, generator=gen, device="cuda")[:6]
                                   for _ in range(n)]).to(torch.int32)
                got = qm.quant_gemv_experts(x, idx, *stack, GROUP_SIZE, BITS)
                ref = qm.quant_gemv_experts_reference(x, idx, *stack, GROUP_SIZE, BITS)
                label = f"quant_gemv_experts DeepSeek-V2-Lite {name} OUT={out_dim} IN={in_dim} N={n} K=6"
                if integer:
                    torch.cuda.synchronize()
                    same = torch.equal(got, ref)
                    log(f"[kernels] {label} integer-valued: bit-exact {same}")
                    check(same, f"{label} differs from its plain version on exact operands")
                else:
                    family_check(label, got, ref)
            del stack
    return errs


def sdpa_mla_paged_call(q, k, ks, tables, lens, scale):
    """``sdpa_paged_call`` with the values the K rows' first 512 columns
    (gathered, and dequantized, beforehand; not timed)."""
    from mlx_sharding_tpu_torch.ops.paged_attention import _gathered

    s_max = int(lens.max())
    kg = _gathered(k, ks, tables)[:, :s_max].to(q.dtype).transpose(1, 2).contiguous()
    vg = kg[..., :MLA_DV]
    mask = (torch.arange(s_max, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    qt = q[:, :, None, :]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True)[:, :, 0]

    return call


def phase_mla_timing(seed: int) -> dict:
    """Device times of DeepSeek-V2's routes beside bound, plain version and
    SDPA (v the view of k): kernel 1's MLA build at the Lite's shapes over
    the 600-token prompt's chunk offsets 0, 256, 512 and at 3840, and at
    V2's group of 128 (offsets 0 and 512); the T=1 route at position 600
    (both groups); kernel 2's ``values_from_k`` over the batcher's four
    slots (bf16 and int8 pools; V2's group, bf16)."""
    from mlx_sharding_tpu_torch.ops import flash_attention as fa
    from mlx_sharding_tpu_torch.ops import paged_attention as pa
    from mlx_sharding_tpu_torch.ops.flash_attention import decode_lengths

    gen = torch.Generator(device="cuda").manual_seed(seed + 32)
    scale = mla_scale()
    bf16 = torch.bfloat16
    rows = {"flash": [], "decode": [], "paged": []}
    k, v = mla_cache(gen, 1, MAX_SEQ, bf16)
    for hq, offsets in ((16, (*MLA_OFFSETS, 3840)), (DSV2_HEADS, (0, 512))):
        q = torch.randn((1, CHUNK, hq, MLA_DK), generator=gen, device="cuda").to(bf16)
        for off in offsets:
            kern = time_ms(lambda: fa.flash_attention(q, k, v, off, scale))
            plain = time_ms(lambda: fa.flash_attention_reference(q, k, v, off, scale), iters=5)
            lib = time_ms(sdpa_call(q, k, v, off, scale))
            flops, nbytes = mla_attention_work(q, k, off)
            rows["flash"].append(timing_row(
                f"flash_attention MLA Hq={hq} T={CHUNK} offset {off} bf16", kern, plain, flops,
                nbytes, bf16, library=lib, hq=hq, offset=off))
        del q
    pos = torch.tensor([MLA_DECODE_POSITION], dtype=torch.int64, device="cuda")
    lengths = decode_lengths(pos, 1, MAX_SEQ)
    for hq in (16, DSV2_HEADS):
        qd = torch.randn((1, 1, hq, MLA_DK), generator=gen, device="cuda").to(bf16)
        kern = time_ms(lambda: fa.flash_decode(qd, k, v, pos, scale, lengths=lengths))
        plain = time_ms(lambda: fa.flash_decode_reference(qd, k, v, lengths, scale))
        lib = time_ms(sdpa_call(qd, k, v, MLA_DECODE_POSITION, scale))
        flops, nbytes = mla_attention_work(qd, k, MLA_DECODE_POSITION)
        rows["decode"].append(timing_row(
            f"flash_decode MLA Hq={hq} position {MLA_DECODE_POSITION}", kern, plain, flops,
            nbytes, bf16, library=lib, hq=hq))
    del k, v
    for hq, pool_dtype in ((16, bf16), (16, torch.int8), (DSV2_HEADS, bf16)):
        qp, kp, vp, ks, vs, tables, lens = mla_paged_case(gen, MLA_BATCH_LENGTHS, hq, PAGE,
                                                          MAX_SEQ // PAGE, pool_dtype, bf16)
        opts = dict(values_from_k=MLA_DV, k_scale=ks, v_scale=vs)
        kern = time_ms(lambda: pa.paged_attention(qp, kp, vp, tables, lens, scale, **opts))
        plain = time_ms(lambda: pa.paged_attention_reference(qp, kp, vp, tables, lens, scale,
                                                             **opts))
        lib = time_ms(sdpa_mla_paged_call(qp, kp, ks, tables, lens, scale))
        flops, nbytes = mla_paged_work(qp, kp, ks, tables, lens)
        rows["paged"].append(timing_row(
            f"paged_attention values_from_k Hq={hq} M={len(MLA_BATCH_LENGTHS)} lengths "
            f"{list(MLA_BATCH_LENGTHS)} {str(pool_dtype)[6:]} pool", kern, plain, flops, nbytes,
            bf16, library=lib, hq=hq, pool=str(pool_dtype)[6:]))
        del qp, kp, vp, ks, vs
    return rows


def mla_records(rows: dict, errs: dict, served: dict) -> list:
    """The kernels-line entries of DeepSeek-V2's routes at the Lite's
    shapes: kernel 1's MLA build (mean over the 600-token prompt's chunk
    offsets 0, 256, 512), the T=1 route's values_from_k at position 600, and
    kernel 2's values_from_k over the batcher's four slots (mean over the
    bf16 and int8 pools); their launches are phase 9's served runs', dense
    and packed, phase 15's at pp = 1 and 2, and phase 17's at tp = 1, tp = 2
    and ep = 2."""
    runs = list(served.values())
    # phase 15's runs of the bf16 Lite at pp = 1 and 2, and phase 17's at
    # tp = 1, tp = 2 and ep = 2
    pipeline = [r["after"]["pipeline"][pp]["launches"] for r in runs if "after" in r
                for pp in ("pp1", "pp2")]
    pipeline += [run["launches"] for r in runs if "after" in r
                 for run in r["after"]["mesh"].values()]

    def launched(name, batch=True):
        return (sum(r["launches"][name] + (r["batch"]["launches"][name] if batch else 0)
                    for r in runs) + sum(p[name] for p in pipeline))

    def mean(picked):
        return {key: (None if any(r[key] is None for r in picked)
                      else sum(r[key] for r in picked) / len(picked))
                for key in ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms")}

    def entry(name, source, replaces, launches, err, row, **extra):
        return {"name": name, "route": "cuda", "source": f"mlx_sharding_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes",
                "library_ms": row["library_ms"], **extra}

    flash = mean([r for r in rows["flash"] if r["hq"] == 16 and r["offset"] in MLA_OFFSETS])
    decode = mean([r for r in rows["decode"] if r["hq"] == 16])
    paged = mean([r for r in rows["paged"] if r["hq"] == 16])
    return [
        entry("flash_attention_mla", "flash_attention.cu",
              "mlx_sharding_tpu/ops/flash_attention.py:127", launched("flash_attention"),
              errs["flash"], flash, library="scaled_dot_product_attention, v a view of k"),
        entry("flash_decode_mla", "paged_attention.cu",
              "mlx_sharding_tpu/ops/flash_attention.py:127", launched("flash_decode", False),
              errs["decode"], decode, position=MLA_DECODE_POSITION),
        entry("paged_attention_values_from_k", "paged_attention.cu",
              "mlx_sharding_tpu/ops/paged_attention.py:153", launched("paged_attention"),
              errs["paged"], paged,
              library="scaled_dot_product_attention after a gather (gather not timed)"),
    ]


# phase 9: the Lite served dense then packed; then its f32 parity (2 layers,
# the Generator against the batcher, the kernels against their plain
# versions, the compressed cache against the full one)
DSV2_RUNS = (("deepseek_v2", DSV2_LITE, "DeepSeek-Coder-V2-Lite bf16"),
             ("deepseek_v2", {**DSV2_LITE, "quantization": {"group_size": GROUP_SIZE, "bits": BITS}},
              "DeepSeek-Coder-V2-Lite 4-bit"))


def phase_deepseek(seed: int, lap) -> dict:
    """Phase 9: DeepSeek-Coder-V2-Lite at full width and depth, compressed
    MLA cache, bf16 and packed, through the Generator's graphs behind the
    server and the paged batcher, the bf16 model also through the fused
    engine at pp = 1 and split 0-14 / 14-27 (phase 15) and at tp = 2 and ep
    = 2 (phase 17); then f32 at 2 layers."""
    def after(name, model):
        if "bf16" not in name:
            return None
        return {"pipeline": pipe_deepseek(model),
                "mesh": mesh_family("[mesh-deepseek]", model,
                                    runs=(("tp", MESH_TP, 1), ("ep", 1, 2)))}

    out = phase_families(seed, lap, runs=DSV2_RUNS, parity=False, after=after,
                         after_what="phase 15 at pp = 1 and 2, phase 17 at tp = 2 and ep = 2")
    gc.collect()
    torch.cuda.empty_cache()
    family_parity("[deepseek_v2]", "deepseek_v2", DSV2_LITE, seed)
    lap("DeepSeek-V2 f32 parity")
    return out


def phase_batching_runs(model, seed: int, single_stream_tok_s: float, lap) -> tuple:
    """Phase 6: ``phase_batching``'s runs, bf16 and int8 pools, plain and
    speculating, async and sync ticks. Returns kernel 2's launches over
    them, each pool's unforced greedy request with draft="off", and the
    bf16 plain run's mix tok/s."""
    paged_launches = 0
    greedy = {}  # each pool's unforced greedy request with draft="off"
    for kv_dtype, draft, sched in (("bf16", "off", "auto"), ("bf16", "ngram", "auto"),
                                   ("bf16", "ngram", "off"), ("int8", "off", "auto"),
                                   ("int8", "ngram", "auto")):
        batch_launches, batch = phase_batching(
            model, seed, kv_dtype, single_stream_tok_s, draft=draft, async_sched=sched,
            split=(kv_dtype, draft, sched) == ("bf16", "ngram", "auto"),
            reference=greedy.get(kv_dtype))
        if draft == "off":
            greedy[kv_dtype] = batch["greedy"]
        if (kv_dtype, draft, sched) == ("bf16", "off", "auto"):
            single_batch_tok_s = batch["mix_tok_s"]
        paged_launches += batch_launches["paged_attention"]
        lap(f"continuous batching, {kv_dtype} pool, draft {draft}, async_sched {sched}")
    return paged_launches, greedy, single_batch_tok_s


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

    ends = [0.0]

    def lap(what):
        end = time.perf_counter() - t0
        log(f"[time] {what} done {end:.1f}s into the run ({end - ends[-1]:.1f}s for it)")
        ends.append(end)

    build_kernels()
    max_err = phase_kernels(args.seed)
    quant_err = phase_quant_kernels(args.seed)
    paged_err = phase_paged_kernels(args.seed)
    decode_err = phase_decode_kernels(args.seed)
    family_err = phase_family_kernels(args.seed)
    mla_err = phase_mla_kernels(args.seed)
    lap("kernel builds and checks")
    if args.kernels_only:
        return 0
    rows = phase_timing(args.seed)
    quant_rows = phase_quant_timing(args.seed)
    phase_gemv_split_timing(args.seed)
    paged_rows = phase_paged_timing(args.seed)
    decode_rows = phase_decode_timing(args.seed)
    family_rows = phase_family_timing(args.seed)
    mla_rows = phase_mla_timing(args.seed)
    mesh_err = mesh_attention_checks(args.seed)
    tp2_rows = mesh_quant_points(args.seed)
    tp2_expert_rows = mesh_expert_points(args.seed)
    lap("kernel timing")
    launches, single, model = phase_main_path(args.seed)
    lap("main path")
    paged_launches, greedy, single_batch_tok_s = phase_batching_runs(
        model, args.seed, single["decode_tok_s"], lap)
    phase_spec_f32(args.seed)
    lap("speculation in f32")
    dense_launches, dense = phase_dense_batching(model, args.seed, single["decode_tok_s"], lap)
    surface_launches, surfaces = phase_surfaces(model, args.seed, lap)
    phase_kv_movement(model, args.seed, lap)
    share_launches, share = phase_share_and_replicas(model, args.seed, single_batch_tok_s, lap)
    disagg_launches, _ = phase_disagg(model, args.seed, single_batch_tok_s,
                                      share["mix"]["tok_s"], greedy["bf16"], lap)
    pipe_launches, _ = phase_pipeline(model, args.seed, lap)
    pod_launches, _ = phase_pod(model, lap)
    mesh_launches, _ = phase_mesh(model, args.seed, lap)
    quant_launches, quant_stats = phase_main_path_4bit(model, args.seed, lap)
    del model
    families = phase_families(
        args.seed, lap, after_what="phase 17 at tp = 2",
        after=lambda name, m: mesh_family("[mesh-mixtral]", m) if name.startswith("Mixtral")
        else None)
    deepseek = phase_deepseek(args.seed, lap)

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
        "launches": (launches["flash_attention"] + dense_launches["flash_attention"]
                     + surface_launches["flash_attention"] + share_launches["flash_attention"]
                     + disagg_launches["flash_attention"] + pipe_launches["flash_attention"]
                     + pod_launches["flash_attention"] + quant_launches["flash_attention"]
                     + mesh_launches["flash_attention"]),
        "max_abs_err": max(max_err, dense["kernels"]["flash_attention"], mesh_err["flash"],
                           surfaces["unaligned_err"]),
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": mean("library_ms"),
    }]}
    for kernel in ("quant_gemv", "quant_matmul"):
        record["kernels"].append(
            quant_record(quant_rows, kernel, quant_launches[kernel], quant_err[kernel],
                         tp2_rows))
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
        "launches": (paged_launches + surface_launches["paged_attention"]
                     + share_launches["paged_attention"]
                     + disagg_launches["paged_attention"] + pod_launches["paged_attention"]),
        "max_abs_err": paged_err,
        "ms": pmean("ms"),
        "plain_ms": pmean("plain_ms"),
        "bound_ms": pmean("bound_ms"),
        "bound_by": "operations" if pmean("ops_ms") >= pmean("bytes_ms") else "bytes",
        "library_ms": pmean("library_ms"),
        "library": "scaled_dot_product_attention after a gather (gather not timed)",
    })
    # the T=1 route at the main path's first decode position (600); its
    # launches are phases 4 and 5's served runs
    row = decode_rows[0]
    record["kernels"].append({
        "name": "flash_decode",
        "route": "cuda",
        "source": "mlx_sharding_tpu_torch/csrc/paged_attention.cu",
        "replaces": "mlx_sharding_tpu/ops/flash_attention.py:127",
        "launches": (launches["flash_decode"] + quant_launches["flash_decode"]
                     + dense_launches["flash_decode"] + surface_launches["flash_decode"]
                     + pipe_launches["flash_decode"] + mesh_launches["flash_decode"]),
        "max_abs_err": max(decode_err, dense["kernels"]["flash_decode"], mesh_err["decode"]),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes",
        "library_ms": row["library_ms"],
        "position": row["position"],
    })
    record["kernels"] += family_records(family_rows, family_err, families)
    record["kernels"] += mla_records(mla_rows, mla_err, deepseek)
    # phase 17's Mixtral runs (the routed GEMV at tp = 2) and its points
    experts = next(r for r in record["kernels"] if r["name"] == "quant_gemv_experts")
    mixtral = families["Mixtral-8x7B 4-bit"]["after"]
    experts["launches"] += sum(run["launches"]["quant_gemv_experts"] for run in mixtral.values())
    experts["max_abs_err"] = max([experts["max_abs_err"]]
                                 + [r["max_abs_err"] for r in tp2_expert_rows])
    experts["tp2_points"] = [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms")}
                             for r in tp2_expert_rows]
    log(f"[mesh] phase 17's launches: 8B bf16 {mesh_launches}; packed "
        + "; ".join(f"tp={tp} {run['launches']}" for tp, run in quant_stats["mesh"].items())
        + "; Mixtral " + "; ".join(f"{k} {run['launches']}" for k, run in mixtral.items()))
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
