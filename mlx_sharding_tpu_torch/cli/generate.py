"""CLI text generation (port of ``mlx_sharding_tpu/cli/generate.py`` at tp =
ep = 1 without sequence parallelism).

    python -m mlx_sharding_tpu_torch.cli.generate --model DIR --prompt "..." \
        [--keep-quantized] [--device cpu] [--start-layer A] [--end-layer B] \
        [--num-stages S | --stage-bounds 0-14,14-27 [--engine fused|chained]] \
        [--draft ngram [--spec-window-max W] | --draft-model DIR [--spec-k K]] \
        [--paged-attention auto|ragged|gather] [--async-sched auto] [--kv-dtype bf16] \
        [--no-chat-template]

``--num-stages S`` or ``--stage-bounds`` runs the model as a pipeline of
stages (``parallel.pipeline.PipelineEngine``; with ``--engine chained`` and
bounds, ``parallel.chained.load_chained_pipeline``): without ``--device``
stage s goes on the s-th card, with ``--device cuda:0`` (or ``cpu``) every
stage on that device.

The CLI runs one stream, which ``--paged-attention``, ``--async-sched`` and
``--kv-dtype bf16`` leave as it is, as in the JAX CLI (they mirror the
server's flags; ``--kv-dtype int8`` is refused: it needs a paged pool); the
batcher's paths are the server's (``--concurrent N [--paged-pool P]``).
``--no-chat-template`` encodes the prompt as it is.

Streams the text and reports prompt/generation tok/s and TTFT on stderr
(and, when speculating, the rounds and the accept rate). On a card the
prefill chunks, decode blocks and speculative rounds are captured as CUDA
graphs at load (their count, capture seconds and pool bytes go to stderr).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate text with mlx_sharding_tpu_torch")
    parser.add_argument("--model", required=True, help="local checkpoint directory")
    parser.add_argument("--prompt", default="hello")
    parser.add_argument("--max-tokens", type=int, default=100)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--repetition-penalty", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max-seq", type=int, default=4096)
    parser.add_argument("--prefill-chunk", type=int, default=256)
    parser.add_argument("--device", default=None,
                        help="torch device of every stage (default: cuda, stage s on the "
                        "s-th card; 'cpu' runs without a card)")
    parser.add_argument("--start-layer", type=int, default=None)
    parser.add_argument("--end-layer", type=int, default=None)
    parser.add_argument("--num-stages", type=int, default=None,
                        help="run the model as an N-stage fused pipeline")
    parser.add_argument("--stage-bounds", default=None,
                        help="pipeline stage bounds, e.g. '0-14,14-27' "
                        "(uneven splits and MoE/dense mixes allowed)")
    parser.add_argument("--engine", choices=("fused", "chained"), default="fused",
                        help="pipeline engine for --stage-bounds: 'fused' runs every "
                        "stage in one engine (default); 'chained' runs one model per "
                        "stage and hands the hidden state on")
    parser.add_argument("--keep-quantized", action="store_true",
                        help="keep 4-bit decoder weights packed in HBM "
                        "(fused dequant-matmul) instead of dequantizing at "
                        "load")
    parser.add_argument("--draft-model", default=None,
                        help="speculative decoding: a small draft model "
                        "proposes --spec-k tokens per round, the target "
                        "verifies them in one forward — greedy streams are "
                        "token-exact; sampled requests use rejection "
                        "sampling (distribution-exact)")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="speculation window (with --draft-model)")
    parser.add_argument("--draft",
                        choices=("auto", "off", "ngram", "engine"),
                        default="auto",
                        help="draft source for speculative decoding: "
                        "'engine' is the two-model path (--draft-model), "
                        "'ngram' drafts by prompt-lookup — n-gram matches "
                        "against the prompt+history propose the window, no "
                        "second checkpoint and no draft KV; 'auto' picks "
                        "'engine' when --draft-model is given, else 'off'")
    parser.add_argument("--spec-window-max", type=int, default=None,
                        help="adaptive speculation ceiling (>= 2): per-round "
                        "acceptance (EWMA) resizes the window in {0,2,4,8} "
                        "up to this cap and disables drafting when it never "
                        "pays; with --draft ngram defaults to 8")
    parser.add_argument("--paged-attention",
                        choices=("auto", "ragged", "gather"), default="auto",
                        help="decode-attention path for paged pipeline "
                        "engines: 'ragged' attends over the KV page pool in "
                        "place (needs a pool — the engine validates), "
                        "'gather' keeps the contiguous per-slot view, 'auto' "
                        "picks ragged where supported; forwarded to the "
                        "engine, a no-op on dense single-stream runs")
    parser.add_argument("--async-sched",
                        choices=("on", "off", "auto"), default="auto",
                        help="tick pipelining for the continuous batcher: "
                        "dispatch decode block t+1 before harvesting block "
                        "t's tokens so host scheduling overlaps device "
                        "compute ('auto' enables it for plain decode, "
                        "disables it when a draft engine is attached); "
                        "accepted here for flag parity with the server — "
                        "the single-stream CLI path always harvests "
                        "synchronously, so this is a no-op")
    parser.add_argument("--kv-dtype", choices=("bf16", "int8"), default=None,
                        help="KV-pool storage dtype; accepted for flag "
                        "parity with the server. 'int8' needs a paged pool "
                        "(server --concurrent/--paged-pool) — the "
                        "single-stream CLI allocates dense caches, so only "
                        "'bf16' is valid here")
    parser.add_argument("--no-chat-template", action="store_true")
    # JAX's flags of the collectives, which come with slice 9b.3
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel width within each pipeline stage (not yet ported)")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel width within each pipeline stage (not yet ported)")
    parser.add_argument("--sp", type=int, default=None,
                        help="sequence-parallel prefill over N devices (not yet ported)")
    parser.add_argument("--sp-decode", action="store_true",
                        help="with --sp: a sequence-sharded KV cache (not yet ported)")
    args = parser.parse_args(argv)
    if args.tp > 1 or args.ep > 1 or args.sp or args.sp_decode:
        parser.error("--tp, --ep, --sp and --sp-decode are not yet ported (ROADMAP queue 1, "
                     "slice 9b.3)")
    if args.engine == "chained" and not args.stage_bounds:
        parser.error("--engine chained requires --stage-bounds")
    if args.draft_model and (args.stage_bounds or args.num_stages):
        parser.error("--draft-model applies to the single-chip generator")
    if args.draft == "engine" and not args.draft_model:
        parser.error("--draft engine requires --draft-model")
    if args.draft in ("off", "ngram") and args.draft_model:
        parser.error(f"--draft {args.draft} conflicts with --draft-model "
                     "(drop one: 'engine' is the two-model path)")
    if args.draft == "ngram" and (args.stage_bounds or args.num_stages):
        parser.error("--draft ngram applies to the single-chip generator")
    if args.spec_window_max is not None:
        if args.spec_window_max < 2:
            parser.error("--spec-window-max must be >= 2 (a 1-token window "
                         "is plain decode; use --draft off)")
        if args.draft not in ("ngram", "engine") and not args.draft_model:
            parser.error("--spec-window-max needs a draft source "
                         "(--draft ngram or --draft-model)")
    if args.kv_dtype == "int8":
        parser.error("--kv-dtype int8 requires a paged KV pool; serve with "
                     "--concurrent N --paged-pool P instead")

    from mlx_sharding_tpu_torch.parallel.mesh import stage_devices

    bounds = None
    if args.stage_bounds:
        bounds = [tuple(int(x) for x in part.split("-")) for part in args.stage_bounds.split(",")]
    stages = len(bounds) if bounds else (args.num_stages or 1)
    try:
        device = stage_devices(stages, args.device)[0]
    except (RuntimeError, ValueError) as e:
        parser.error(str(e))

    from mlx_sharding_tpu_torch.loading import load_model

    if bounds and args.engine == "chained":
        from mlx_sharding_tpu_torch.parallel.chained import load_chained_pipeline

        generator = load_chained_pipeline(args.model, bounds, device=args.device,
                                          max_seq=args.max_seq, prefill_chunk=args.prefill_chunk,
                                          keep_quantized=args.keep_quantized)
    elif stages > 1 or bounds:
        from mlx_sharding_tpu_torch.parallel import PipelineEngine

        model, _ = load_model(args.model, args.start_layer, args.end_layer, device=device,
                              keep_quantized=args.keep_quantized)
        generator = PipelineEngine(model, stages=stages, stage_bounds=bounds,
                                   max_seq=args.max_seq, prefill_chunk=args.prefill_chunk,
                                   paged_attention=args.paged_attention, kv_dtype=args.kv_dtype,
                                   device=args.device)
    else:
        generator = _single_chip(args, load_model(args.model, args.start_layer, args.end_layer,
                                                  device=device,
                                                  keep_quantized=args.keep_quantized)[0], device)
    captured = generator.warm_up()  # on a card: every step as a graph
    if captured:
        print(f"captured {captured['graphs']} CUDA graphs in {captured['seconds']:.2f}s, "
              f"graph pool {captured['pool_bytes'] / 1e6:.1f} MB", file=sys.stderr)
    _generate(args, generator)


def _single_chip(args, model, device):
    """The single-chip generator: n-gram or draft-model speculation, or the
    plain ``Generator``."""
    from mlx_sharding_tpu_torch.generate import Generator
    from mlx_sharding_tpu_torch.loading import load_model

    if args.draft == "ngram":
        from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator

        return NgramSpeculativeGenerator(model, spec_window_max=args.spec_window_max or 8,
                                         max_seq=args.max_seq, prefill_chunk=args.prefill_chunk)
    if args.draft_model:
        from mlx_sharding_tpu_torch.speculative import SpeculativeGenerator

        draft_model, _ = load_model(args.draft_model, device=device)
        return SpeculativeGenerator(model, draft_model, spec_k=args.spec_k,
                                    max_seq=args.max_seq, prefill_chunk=args.prefill_chunk)
    return Generator(model, max_seq=args.max_seq, prefill_chunk=args.prefill_chunk)


def _generate(args, generator) -> None:
    """Stream the prompt's completion and report the rates on stderr."""
    from mlx_sharding_tpu_torch.generate import stream_generate
    from mlx_sharding_tpu_torch.loading import load_tokenizer

    tokenizer = load_tokenizer(args.model)
    if getattr(tokenizer, "chat_template", None) and not args.no_chat_template:
        prompt_ids = tokenizer.apply_chat_template(
            [{"role": "user", "content": args.prompt}], tokenize=True, add_generation_prompt=True
        )
    else:
        prompt_ids = tokenizer.encode(args.prompt)

    stats = None
    for chunk in stream_generate(
        generator, tokenizer, list(prompt_ids),
        max_tokens=args.max_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        seed=args.seed,
    ):
        if chunk.text:
            print(chunk.text, end="", flush=True)
        if chunk.finish_reason is not None:
            stats = chunk
    print()
    print("=" * 10, file=sys.stderr)
    print(f"Prompt: {stats.prompt_tokens} tokens, {stats.prompt_tps:.3f} tokens-per-sec",
          file=sys.stderr)
    print(f"Generation: {stats.generation_tokens} tokens, "
          f"{stats.generation_tps:.3f} tokens-per-sec", file=sys.stderr)
    print(f"TTFT: {stats.ttft * 1000:.1f} ms", file=sys.stderr)
    if hasattr(generator, "spec_stats"):
        spec = generator.spec_stats()
        print(f"Speculation ({spec['mode']}): {spec['rounds']} rounds, "
              f"{spec['accepted_tokens']} of {spec['draft_tokens']} draft tokens accepted "
              f"({spec['accept_rate']:.3f})", file=sys.stderr)


if __name__ == "__main__":
    main()
