"""Time the prefill dequant-matmul against an earlier tree's kernel, and
this tree's kernel against its forced splits and ablated copies, in one
process on one card.

    python3 scripts/quant_matmul_timing.py [--parent DIR] [--splits 0,512] [--ablate]
                                           [--variant DIR ...] [--out FILE]

``DIR`` is a tree of this repository unpacked from an earlier commit (for
example ``git archive <commit> | tar -x -C .scratch/parent``). Its wrapper,
``mlx_sharding_tpu_torch/ops/quant_matmul.py``, is loaded as a module of its
own and its library built from its ``csrc/quant_matmul.cu``, so the two
kernels run side by side at the four Llama-3.1-8B layer shapes of
``chip_smoke.QUANT_SHAPES`` (4 bits, group 64, fp16 scales and biases) at
M = ``chip_smoke.TAIL_M`` and ``PREFILL_M`` (the 600-token prompt's last
chunk and a full one), in the order earlier, this tree, this tree, earlier.

Beside them: ``F.linear`` on the dequantized bf16 weight (``dense_ms``), the
bound and the achieved TFLOP/s, this tree's kernel with ``SPLIT_K`` forced
to each value of ``--splits`` (0: the whole walk), and with ``--ablate``
three copies of this tree's kernel written to ``.scratch/matmul_ablation/``:
``no_dequant`` puts the raw words in each A fragment in place of the
dequantized codes (the math of the dequantization removed, its loads
kept); ``no_mma`` dequantizes and issues no product; ``no_x`` copies no x
(the products read whatever the ring holds). Ablated copies give wrong
outputs and are timed only; the text they change must be found, or the
script stops.
``--variant DIR`` (repeatable) times another tree's kernel beside this one,
as ``--parent`` does, once after this tree's.

Times are device times per call (``chip_smoke.time_ms``: L2 flushed, the
card kept busy while the host enqueues). Prints a line per shape and M and
writes all rows as JSON to ``--out`` (default
``chiprun_out/quant_matmul_timing.json``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from mlx_sharding_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from mlx_sharding_tpu_torch.ops.quant import dequantize  # noqa: E402

WRAPPER = "mlx_sharding_tpu_torch/ops/quant_matmul.py"
SOURCE = "mlx_sharding_tpu_torch/csrc/quant_matmul.cu"

# name: [(text that must be found, what replaces it), ...]
ABLATIONS = {
    "no_dequant": [
        ("f[2 * j] = dequant_pair<BITS>(w_lo[wi] >> sh, sc[kk / 2][0], bi[kk / 2][0]);",
         "f[2 * j] = w_lo[wi] >> sh;"),
        ("f[2 * j + 1] = dequant_pair<BITS>(w_hi[wi] >> sh, sc[kk / 2][1], bi[kk / 2][1]);",
         "f[2 * j + 1] = w_hi[wi] >> sh;"),
    ],
    "no_mma": [
        ("Wgmma<N>::mma(acc, f, desc_sw128(x_addr + kk * 32));", "(void)x_addr;"),
    ],
    "no_x": [
        ("mbar_expect_tx(full, L::X_BYTES + (p.words_tma", "mbar_expect_tx(full, 0 + (p.words_tma"),
        ("tma_load_2d(smem_u32(st), &xmap, k0, m0, full);", ""),
    ],
}


def load_wrapper(tree: Path, source: Path, name: str):
    """The wrapper module of ``tree`` as module ``name``, its library built
    from ``source``."""
    spec = importlib.util.spec_from_file_location(name, tree / WRAPPER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._LIBRARY.source = source
    return mod


def ablated_source(name: str, out_dir: Path) -> Path:
    text = (ROOT / SOURCE).read_text()
    for old, new in ABLATIONS[name]:
        if old not in text:
            raise SystemExit(f"{name}: the text to change is not in {SOURCE}")
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"quant_matmul_{name}.cu"
    path.write_text(text)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="an unpacked earlier tree of this repository")
    parser.add_argument("--variant", type=Path, action="append", default=[],
                        help="another unpacked tree whose kernel is timed beside this one")
    parser.add_argument("--splits", default="0,512",
                        help="comma-separated SPLIT_K values (0: whole walk) to time this "
                             "tree's kernel at besides the planned walk")
    parser.add_argument("--ablate", action="store_true",
                        help="also time this tree's kernel without its dequantization math, "
                             "without its products and without its copies of x")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path,
                        default=ROOT / "chiprun_out" / "quant_matmul_timing.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_matmul_timing: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    variants = {}
    if args.parent is not None:
        variants["parent"] = load_wrapper(args.parent, (args.parent / SOURCE).resolve(),
                                          "parent_quant_matmul")
    for tree in args.variant:
        variants[tree.name] = load_wrapper(tree, (tree / SOURCE).resolve(),
                                           f"{tree.name}_quant_matmul")
    if args.ablate:
        for name in ABLATIONS:
            variants[name] = load_wrapper(ROOT, ablated_source(name, ROOT / ".scratch" /
                                                               "matmul_ablation"),
                                          f"{name}_quant_matmul")
    libraries = [("this tree", qm), *variants.items()]
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc each
        logs = list(pool.map(lambda lib: lib[1].build(), libraries))
    for (name, mod), log in zip(libraries, logs):
        print(f"[build] {name}: {mod._LIBRARY.source}", flush=True)
        for line in log.splitlines():
            if "quant_matmul" in line or "registers" in line or "warning" in line.lower():
                print(f"[build]   {line.strip()}", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 6)
    gs, bits = smoke.GROUP_SIZE, smoke.BITS
    rows = []
    for name, out_dim, in_dim in smoke.QUANT_SHAPES[:smoke.LAYER_SHAPES]:
        _, q, s, b = smoke.quant_operands(gen, 1, out_dim, in_dim, integer=False)
        dense = dequantize(q, s, b, gs, bits, torch.bfloat16)
        for m in (smoke.TAIL_M, smoke.PREFILL_M):
            x = torch.randn((m, in_dim), generator=gen, device="cuda").to(torch.bfloat16)

            def call(mod, x=x, q=q, s=s, b=b):
                return lambda: mod.quant_matmul(x, q, s, b, gs, bits)

            ref = qm.quant_matmul_reference(x, q, s, b, gs, bits)
            _, worst, rel_l2 = smoke.kernel_disagreement(call(qm)(), ref)
            times = {}
            if "parent" in variants:  # earlier, this tree, this tree, earlier
                first = smoke.time_ms(call(variants["parent"]))
                kern = [smoke.time_ms(call(qm)), smoke.time_ms(call(qm))]
                last = smoke.time_ms(call(variants["parent"]))
                times["kernel"] = sum(kern) / 2
                times["parent"] = (first + last) / 2
                runs = dict(parent=[first, last], kernel=kern)
            else:
                kern = [smoke.time_ms(call(qm)), smoke.time_ms(call(qm))]
                times["kernel"] = sum(kern) / 2
                runs = dict(kernel=kern)
            for split in (int(v) for v in args.splits.split(",") if v):
                default, qm.SPLIT_K = qm.SPLIT_K, split
                try:
                    times[f"split_{split}"] = smoke.time_ms(call(qm))
                finally:
                    qm.SPLIT_K = default
            for vname, mod in variants.items():
                if vname != "parent":
                    times[vname] = smoke.time_ms(call(mod))
            times["dense"] = smoke.time_ms(lambda: torch.nn.functional.linear(x, dense))
            flops, nbytes = smoke.quant_work(m, out_dim, in_dim)
            ops_ms = flops / smoke.PEAK_FLOPS[torch.bfloat16] * 1e3
            bytes_ms = nbytes / smoke.PEAK_BYTES * 1e3
            bound = max(ops_ms, bytes_ms)
            tile, split = qm.plan_matmul(m, out_dim, in_dim, sms)
            row = dict(name=name, m=m, out=out_dim, inp=in_dim, tile=tile, planned_split=split,
                       bound_ms=bound, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       tflops=flops / times["kernel"] / 1e9, worst_err_over_limit=worst,
                       rel_l2=rel_l2, card=card, runs=runs, **times)
            rows.append(row)
            print(f"[matmul] {name} M={m} OUT={out_dim} IN={in_dim} (tile {tile}, split "
                  f"{split or 'whole'}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                  + f"; bound {bound:.4f} ms ({row['bound_by']}), kernel "
                  f"{row['tflops']:.0f} TFLOP/s = {bound / times['kernel']:.1%} of the bound, "
                  f"{times['kernel'] / times['dense']:.2f}x dense; kernel vs plain err/limit "
                  f"{worst:.3f}, relative L2 {rel_l2:.2e}", flush=True)
            del x
        del q, s, b, dense
    for m in (smoke.TAIL_M, smoke.PREFILL_M):
        sel = [r for r in rows if r["m"] == m]
        mean = {k: sum(r[k] for r in sel) / len(sel) for k in sel[0]
                if isinstance(sel[0][k], float) and k.endswith(("kernel", "parent", "dense"))}
        print(f"[matmul] M={m} mean over the four shapes: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in mean.items()), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
