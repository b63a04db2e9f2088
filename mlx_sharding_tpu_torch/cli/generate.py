"""CLI text generation (port of the single-generator path of
``mlx_sharding_tpu/cli/generate.py``).

    python -m mlx_sharding_tpu_torch.cli.generate --model DIR --prompt "..." \
        [--keep-quantized] [--device cpu]

Streams the text and reports prompt/generation tok/s and TTFT on stderr. On
a card the prefill chunks and decode blocks are captured as CUDA graphs at
load (their count, capture seconds and pool bytes go to stderr).
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
                        help="torch device (default cuda; 'cpu' runs without a card)")
    parser.add_argument("--keep-quantized", action="store_true",
                        help="keep 4-bit decoder weights packed in HBM "
                        "(fused dequant-matmul) instead of dequantizing at "
                        "load")
    args = parser.parse_args(argv)

    from mlx_sharding_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))

    from mlx_sharding_tpu_torch.generate import Generator, stream_generate
    from mlx_sharding_tpu_torch.loading import load_model, load_tokenizer

    model, _ = load_model(args.model, device=device, keep_quantized=args.keep_quantized)
    generator = Generator(model, max_seq=args.max_seq, prefill_chunk=args.prefill_chunk)
    captured = generator.warm_up()  # on a card: every chunk offset and decode block as a graph
    if captured:
        print(f"captured {captured['graphs']} CUDA graphs in {captured['seconds']:.2f}s, "
              f"graph pool {captured['pool_bytes'] / 1e6:.1f} MB", file=sys.stderr)
    tokenizer = load_tokenizer(args.model)
    if getattr(tokenizer, "chat_template", None):
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


if __name__ == "__main__":
    main()
