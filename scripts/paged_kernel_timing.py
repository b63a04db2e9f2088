"""Time the ragged paged-decode kernel against an earlier tree's kernel and
against ablated copies of that kernel, in one process on one card.

    python3 scripts/paged_kernel_timing.py [--parent DIR] [--ablate] [--ablate-tree]
                                           [--splits 64,256,0] [--out FILE]

``DIR`` is a tree of this repository unpacked from an earlier commit (for
example ``git archive <commit> | tar -x -C .scratch/parent``). Its wrapper,
``mlx_sharding_tpu_torch/ops/paged_attention.py``, is loaded as a module of
its own and its library built from its ``csrc/paged_attention.cu``, so the
two kernels run side by side at the points of ``chip_smoke.PAGED_SWEEP``
(Llama-3.1-8B's attention: Hq 32, Hkv 8, D 128, page 256, 16 pages a slot),
each with a bf16 and an int8 pool, in the order earlier, this tree, this
tree, earlier.

``--ablate`` also builds two copies of the earlier tree's kernel, written to
``.scratch/paged_ablation/``: ``loads_only`` keeps the page walk's copies and
removes the math of each tile; ``no_merge`` skips the merge launch after a
split walk. They apply to the kernel of PR 3 and PR 6. ``--ablate-tree``
builds copies of this tree's kernel: ``tree_copies_only`` waits for each
tile's copies and skips its math; ``tree_no_merge`` takes the tickets but
skips the last block's merge. Ablated copies give wrong outputs and are
timed only; the text they change must be found, or the script stops.

Times are device times per call (``chip_smoke.time_ms``: L2 flushed, the
card kept busy while the host enqueues); an empty kernel timed the same way
is printed first. Prints a line per point and pool
and writes all rows as JSON to ``--out`` (default
``chiprun_out/paged_kernel_timing.json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from mlx_sharding_tpu_torch.ops import paged_attention as pa  # noqa: E402

WRAPPER = "mlx_sharding_tpu_torch/ops/paged_attention.py"
SOURCE = "mlx_sharding_tpu_torch/csrc/paged_attention.cu"

# name: (the tree it changes, text that must be found, what replaces it);
# a replacement of None cuts from the first text to the second
ABLATIONS = {
    "loads_only": (
        "parent",
        "    __syncthreads();  // this tile (and, the first time, sQ) visible\n",
        None,
        "    __syncthreads();  // every thread is done with this stage before it is refilled\n",
    ),
    "no_merge": (
        "parent",
        "  paged_merge_kernel<TQ><<<M * p.Hq, THREADS, 0, stream>>>(p, splits);\n"
        "  return cudaGetLastError();\n",
        "  return cudaSuccess;\n",
        None,
    ),
    "tree_copies_only": (
        "tree",
        "        mbar_wait(bars + 8 * s, (T / stages) & 1);\n",
        "        mbar_wait(bars + 8 * s, (T / stages) & 1);\n      }\n      if (false) {\n",
        None,
    ),
    "tree_no_merge": (
        "tree",
        "  if (!*sFlag) return;\n",
        "  if (*sFlag && tid == 0) *counter = 0;\n  return;\n",
        None,
    ),
}


def load_wrapper(tree: Path, source: Path, name: str):
    """The wrapper module of ``tree`` as module ``name``, its library built
    from ``source``."""
    spec = importlib.util.spec_from_file_location(name, tree / WRAPPER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._LIBRARY.source = source
    return mod


def ablated_source(source: Path, name: str, out_dir: Path) -> Path:
    text = source.read_text()
    _, first, replacement, until = ABLATIONS[name]
    if first not in text or (until is not None and until not in text):
        raise SystemExit(f"{name}: the text to change is not in {source}")
    if replacement is None:  # cut everything between the two texts
        a = text.index(first) + len(first)
        text = text[:a] + text[text.index(until, a):]
    else:
        text = text.replace(first, replacement)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"paged_attention_{name}.cu"
    path.write_text(text)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="an unpacked earlier tree of this repository")
    parser.add_argument("--ablate", action="store_true",
                        help="also time the earlier kernel's loads alone and without its merge")
    parser.add_argument("--ablate-tree", action="store_true",
                        help="also time this tree's kernel without its math and without its merge")
    parser.add_argument("--splits", default="",
                        help="comma-separated SPLIT_POSITIONS values (0: whole walk) to time "
                             "this tree's kernel at besides the planned walk")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "paged_kernel_timing.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_kernel_timing: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.ablate and args.parent is None:
        raise SystemExit("--ablate needs --parent")
    out_dir = ROOT / ".scratch" / "paged_ablation"
    variants = {}
    if args.parent is not None:
        parent_source = (args.parent / SOURCE).resolve()
        variants["parent"] = load_wrapper(args.parent, parent_source, "parent_paged_attention")
    for name, (tree, *_) in ABLATIONS.items():
        if (tree == "parent" and args.ablate) or (tree == "tree" and args.ablate_tree):
            base = (args.parent, parent_source) if tree == "parent" else (ROOT, ROOT / SOURCE)
            variants[name] = load_wrapper(base[0], ablated_source(base[1], name, out_dir),
                                          f"{name}_paged_attention")
    for name, mod in [("this tree", pa), *variants.items()]:
        log = mod.build()
        print(f"[build] {name}: {mod._LIBRARY.source}", flush=True)
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "cached")):
                print(f"[build]   {line.strip()}", flush=True)

    # what the timing itself shows for a kernel that does nothing
    floor = smoke.time_ms(lambda: torch.cuda._sleep(0))
    print(f"[paged] an empty kernel, timed the same way: {floor:.4f} ms", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 4)
    scale = 128 ** -0.5
    rows = []
    for point, lengths in smoke.PAGED_SWEEP:
        for pool_dtype in (torch.bfloat16, torch.int8):
            q, k, v, ks, vs, tables, lens = smoke.paged_case(
                gen, lengths, 32, 8, 128, smoke.PAGE, smoke.MAX_SEQ // smoke.PAGE, pool_dtype,
                torch.bfloat16)

            def call(mod, q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, lens=lens):
                return lambda: mod.paged_attention(q, k, v, tables, lens, scale,
                                                   k_scale=ks, v_scale=vs)

            ref = pa.paged_attention_reference(q, k, v, tables, lens, scale,
                                               k_scale=ks, v_scale=vs)
            _, worst, rel_l2 = smoke.kernel_disagreement(call(pa)(), ref)
            times = {}
            if "parent" in variants:  # earlier, this tree, this tree, earlier
                first = smoke.time_ms(call(variants["parent"]))
                kern = [smoke.time_ms(call(pa)), smoke.time_ms(call(pa))]
                last = smoke.time_ms(call(variants["parent"]))
                times["kernel"] = sum(kern) / 2
                times["parent"] = (first + last) / 2
                runs = dict(parent=[first, last], kernel=kern)
            else:
                kern = [smoke.time_ms(call(pa)), smoke.time_ms(call(pa))]
                times["kernel"] = sum(kern) / 2
                runs = dict(kernel=kern)
            for name in variants:
                if name != "parent":
                    times[name] = smoke.time_ms(call(variants[name]))
            for split in (int(x) for x in args.splits.split(",") if x):
                default, pa.SPLIT_POSITIONS = pa.SPLIT_POSITIONS, split
                try:
                    times[f"split_{split}"] = smoke.time_ms(call(pa))
                finally:
                    pa.SPLIT_POSITIONS = default
            times["plain"] = smoke.time_ms(lambda: pa.paged_attention_reference(
                q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs))
            times["sdpa"] = smoke.time_ms(
                smoke.sdpa_paged_call(q, k, v, ks, vs, tables, lens, scale))
            flops, nbytes = smoke.paged_work(q, k, v, ks, tables, lens)
            bound = max(flops / smoke.PEAK_FLOPS[q.dtype], nbytes / smoke.PEAK_BYTES) * 1e3
            row = dict(point=point, pool=str(pool_dtype)[6:], slots=len(lengths),
                       lengths=list(lengths), bound_ms=bound, mbytes=nbytes / 1e6,
                       worst_err_over_limit=worst, rel_l2=rel_l2, card=card,
                       runs=runs, **times)
            rows.append(row)
            print(f"[paged] {point} {row['pool']} pool ({len(lengths)} slots): " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in times.items())
                + f"; bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB), kernel "
                f"{nbytes / 1e6 / times['kernel']:.0f} GB/s = {bound / times['kernel']:.1%} of "
                f"the bound; kernel vs plain "
                f"err/limit {worst:.3f}, relative L2 {rel_l2:.2e}", flush=True)
            del q, k, v, ks, vs
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
