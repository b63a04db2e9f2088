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
Prints a line per offset and writes the rows as JSON to ``--out`` (default
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
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    return 0 if all(r["same_bits"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
