"""Time the prefill of the smoke's 600-token prompt through one tree's port,
dense and packed to 4 bits, on one card.

    python3 scripts/prefill_timing.py [--tree DIR] [--runs 5] [--seed 0] [--out FILE]

``DIR`` is a tree of this repository (default: this one), for example an
earlier commit unpacked with ``git archive <commit> | tar -x -C
.scratch/parent``; its ``mlx_sharding_tpu_torch`` package is imported in
place of this tree's, and its kernels are built from its own ``csrc/``. The
model is ``chip_smoke.LLAMA_31_8B`` at full width and depth with random bf16
weights from ``--seed``; the packed model holds the same weights packed as
``chip_smoke.pack_llama`` packs them (group 64, 4 bits, fp16 scales and
biases). Each is timed by ``chip_smoke.prefill_median_ms``: the median of
``--runs`` device-synchronised ``Generator.run_prefill`` calls after one
warm-up. A tree whose Generator owns its cache and captures CUDA graphs
(``warm_up``) is timed through its graphs, captured first; an earlier
tree's gets a fresh cache per call, made inside the timed span (a 0.5 GB
memset). To compare two trees, run the script once per tree in the order
earlier, this, this, earlier, in one call of the card.

Prints one line per model and, as the last line of its standard output, a
JSON object with both medians and every run; appends that object to
``--out`` (default ``chiprun_out/prefill_timing.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def median_ms(model, prompt, runs):
    """``chip_smoke.prefill_median_ms`` of the prompt through the imported
    tree's Generator."""
    from mlx_sharding_tpu_torch.generate import Generator

    gen = Generator(model, max_seq=smoke.MAX_SEQ, prefill_chunk=smoke.CHUNK)
    if hasattr(gen, "warm_up"):
        gen.warm_up()
        return smoke.prefill_median_ms(lambda: gen.run_prefill(prompt), runs)
    return smoke.prefill_median_ms(
        lambda: gen.run_prefill(prompt, model.make_cache(1, gen.max_seq)), runs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="the tree whose mlx_sharding_tpu_torch package is timed")
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "prefill_timing.jsonl")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("prefill_timing: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))  # before the package is first imported
    from mlx_sharding_tpu_torch.models import build_model

    import mlx_sharding_tpu_torch

    if Path(mlx_sharding_tpu_torch.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {mlx_sharding_tpu_torch.__file__}, not the package of {tree}")
    card = smoke.card_line()
    print(f"[device] {card}; tree {tree}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = build_model(smoke.LLAMA_31_8B, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(args.seed), "cuda")
    words = ("pipeline stages pass activations over rings while the cache grows; "
             "every chunk of the prompt runs through the flash kernel. ")
    prompt = np.asarray([list((words * 8)[:600].encode())], np.int64)
    result = {"tree": str(tree), "card": card}
    result["dense_ms"], result["dense_runs"] = median_ms(model, prompt, args.runs)
    print(f"[prefill] dense: median {result['dense_ms']:.2f} ms "
          f"({' / '.join(f'{t:.2f}' for t in result['dense_runs'])})", flush=True)
    packed = smoke.pack_llama(model, smoke.LLAMA_31_8B)
    model.to("meta")
    torch.cuda.empty_cache()
    result["packed_ms"], result["packed_runs"] = median_ms(packed, prompt, args.runs)
    print(f"[prefill] packed 4-bit: median {result['packed_ms']:.2f} ms "
          f"({' / '.join(f'{t:.2f}' for t in result['packed_runs'])})", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
