"""Time the flash-prefill kernel against an earlier tree's, in one process
on one card.

    python3 scripts/flash_kernel_timing.py --parent DIR [--out FILE]

``DIR`` is a tree of this repository unpacked from an earlier commit (for
example ``git archive <commit> | tar -x -C .scratch/parent``). Its wrapper,
``mlx_sharding_tpu_torch/ops/flash_attention.py``, is loaded as a module of
its own and its library built from its ``csrc/flash_attention.cu``. Both
kernels run at Llama-3.1-8B's attention (T 256, Hq 32, Hkv 8, D 128, bf16,
a 4096-row cache) at the chunk offsets of ``chip_smoke.FLASH_TIMING_OFFSETS``
in the order earlier, this tree, this tree, earlier; their outputs must be
the same bits. Times are device times per call (``chip_smoke.time_ms``).
Then every other build the tree has is held to the earlier tree's bits at
a chunk of each (``BIT_CASES``: the bf16 head dims, the softcap and window,
the MLA build, fp32 and a batch of two). Prints a line per offset and per
case and writes the rows as JSON to ``--out`` (default
``chiprun_out/flash_kernel_timing.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from mlx_sharding_tpu_torch.ops import flash_attention as fa  # noqa: E402
from scripts.paged_kernel_timing import load_wrapper  # noqa: E402

WRAPPER = "mlx_sharding_tpu_torch/ops/flash_attention.py"
SOURCE = "mlx_sharding_tpu_torch/csrc/flash_attention.cu"


# (label, b, hq, hkv, dk, dv, dtype, offset, options): the builds beside
# the timed one; dk 576 takes v as a view of k's first 512 columns
BIT_CASES = (
    ("bf16 D64", 1, 16, 4, 64, 64, torch.bfloat16, 512, {}),
    ("bf16 Dk192 Dv128", 1, 16, 16, 192, 128, torch.bfloat16, 256, {}),
    ("bf16 D256 softcap window", 1, 16, 8, 256, 256, torch.bfloat16, 768,
     dict(logit_softcap=50.0, sliding_window=300)),
    ("bf16 MLA", 1, 16, 1, 576, 512, torch.bfloat16, 256, {}),
    ("bf16 D128 batch 2", 2, 32, 8, 128, 128, torch.bfloat16, 256, {}),
    ("f32 D128", 1, 8, 2, 128, 128, torch.float32, 128, {}),
    ("f32 MLA", 1, 16, 1, 576, 512, torch.float32, 128, {}),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="an unpacked earlier tree of this repository")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "flash_kernel_timing.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_kernel_timing: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    print(f"[device] {smoke.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    parent = load_wrapper(args.parent, (args.parent / SOURCE).resolve(), "parent_flash_attention",
                          wrapper=WRAPPER)
    for mod in (fa, parent):
        mod.build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for offset in smoke.FLASH_TIMING_OFFSETS:
        q, k, v = smoke.attention_inputs(gen, 1, smoke.CHUNK, smoke.MAX_SEQ, 32, 8, 128, 128,
                                         torch.bfloat16)
        outs = {name: mod.flash_attention(q, k, v, offset, 128 ** -0.5)
                for name, mod in (("parent", parent), ("this", fa))}
        torch.cuda.synchronize()
        same = torch.equal(outs["parent"], outs["this"])
        times = {"parent": [], "this": []}
        for name in ("parent", "this", "this", "parent"):
            mod = parent if name == "parent" else fa
            times[name].append(smoke.time_ms(lambda: mod.flash_attention(q, k, v, offset,
                                                                         128 ** -0.5)))
        row = {"offset": offset, "same_bits": same,
               **{f"{n}_ms": sum(t) / len(t) for n, t in times.items()}}
        rows.append(row)
        print(f"[flash] offset {offset}: earlier tree {times['parent']} ms, this tree "
              f"{times['this']} ms (this / earlier {row['this_ms'] / row['parent_ms']:.3f}); "
              f"outputs bit-identical {same}", flush=True)
    for label, b, hq, hkv, dk, dv, dtype, offset, opts in BIT_CASES:
        q, k, v = smoke.attention_inputs(gen, b, smoke.CHUNK, 1024, hq, hkv, dk, dv, dtype)
        if dk == 576:
            v = k[..., :dv]
        outs = [mod.flash_attention(q, k, v, offset, dk ** -0.5, **opts) for mod in (parent, fa)]
        same = torch.equal(*outs)
        rows.append({"case": label, "offset": offset, "same_bits": same})
        print(f"[flash] {label} at offset {offset}: outputs bit-identical {same}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    return 0 if all(r["same_bits"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
