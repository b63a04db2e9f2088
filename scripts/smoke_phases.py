"""Some of ``chip_smoke.py``'s phases alone on the card: the kernel builds,
the Llama-3.1-8B model with random bf16 weights from seed 0 (for the
phases that take it), then the phases named, each with its ``[time]``
laps.

    python3 scripts/smoke_phases.py [--stamp] [--keep-going] [--no-mesh] batching mesh 4bit families

``main`` is phase 4 (``phase_main_path``, which builds the 8B itself and
serves the later phases), ``batching`` phase 6 (``phase_batching_runs``;
its single-stream rate is a stand-in), ``pipeline`` phase 15
(``phase_pipeline``), ``pod`` phase 16 (``phase_pod``), ``mesh`` phase 17
on the 8B (``phase_mesh``, with its kernel checks at the shard shapes),
``multihost`` phase 18 (``phase_multihost``: the server over two
processes, the pod over its collective transport), ``timing`` the families'
kernel timing (``phase_family_timing``, the options rows' library times),
``4bit`` phase 5 (``phase_main_path_4bit``, with phase 15's and 17's packed
runs; it frees the dense weights, so it runs after the others that take
them), ``families`` phase 8 (``phase_families``, with phase 17's Mixtral
run) and ``deepseek`` phase 9 (``phase_deepseek``). ``--stamp`` prefixes
every line with the seconds since the start; ``--keep-going`` logs a
phase's failure and goes on to the next (the exit code is then 1).
``chip_smoke`` is imported from ``sys.path``, so an earlier tree's phases
run with that tree's root on it (``cd .scratch/parent && PYTHONPATH=.
python3 ../../scripts/smoke_phases.py 4bit``), one process a run, for an
A/B on one card; a phase the earlier tree lacks is skipped there."""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from mlx_sharding_tpu_torch.models import build_model  # noqa: E402

PHASES = ("main", "batching", "pipeline", "pod", "mesh", "multihost", "4bit", "families",
          "deepseek", "timing")
NEEDS_8B = ("batching", "pipeline", "pod", "mesh", "multihost", "4bit")
# phase 6's runs, for a tree from before ``chip_smoke.phase_batching_runs``
BATCH_RUNS = (("bf16", "off", "auto"), ("bf16", "ngram", "auto"), ("bf16", "ngram", "off"),
              ("int8", "off", "auto"), ("int8", "ngram", "auto"))


def batching(model, lap) -> None:
    """Phase 6 with a stand-in single-stream rate (phase 4 is not run)."""
    runs = getattr(c, "phase_batching_runs", None)
    if runs is not None:
        runs(model, 0, 100.0, lap)
        return
    greedy = {}
    for kv_dtype, draft, sched in BATCH_RUNS:
        _, batch = c.phase_batching(model, 0, kv_dtype, 100.0, draft=draft, async_sched=sched,
                                    split=(kv_dtype, draft, sched) == BATCH_RUNS[1],
                                    reference=greedy.get(kv_dtype))
        if draft == "off":
            greedy[kv_dtype] = batch["greedy"]
        lap(f"continuous batching, {kv_dtype} pool, draft {draft}, async_sched {sched}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="+", choices=PHASES)
    parser.add_argument("--stamp", action="store_true")
    parser.add_argument("--keep-going", action="store_true")
    parser.add_argument("--no-mesh", dest="mesh", action="store_false",
                        help="phase 8 without phase 17's Mixtral run (an A/B of phase 8)")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    if args.stamp:
        c.log = lambda msg: print(f"{time.perf_counter() - t0:8.1f} {msg}", flush=True)
    c.log(f"[device] {c.card_line()}")
    ends = [0.0]

    def lap(what):
        end = time.perf_counter() - t0
        c.log(f"[time] {what} done {end:.1f}s into the run ({end - ends[-1]:.1f}s for it)")
        ends.append(end)

    c.build_kernels()
    lap("builds")
    model = None
    if "main" in args.phases:
        model = c.phase_main_path(0)[2]
        lap("main path")
    elif any(p in NEEDS_8B for p in args.phases):
        model, _ = build_model(c.LLAMA_31_8B, dtype=torch.bfloat16)
        model.init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        lap("the 8B")
    failed = False
    for phase in sorted(args.phases, key=PHASES.index):
        if phase == "main":
            continue
        if phase in ("mesh", "multihost") and not hasattr(c, f"phase_{phase}"):
            c.log(f"[{phase}] this tree has no such phase")
            continue
        try:
            if phase == "batching":
                batching(model, lap)
            elif phase == "pipeline":
                c.phase_pipeline(model, 0, lap)
            elif phase == "pod":
                c.phase_pod(model, lap)
            elif phase == "mesh":
                c.mesh_attention_checks(0)
                c.mesh_quant_points(0)
                c.mesh_expert_points(0)
                lap("phase 17's kernel checks at the shard shapes")
                c.phase_mesh(model, 0, lap)
            elif phase == "multihost":
                c.phase_multihost(model, 0, lap)
            elif phase == "timing":
                c.phase_family_timing(0)
                lap("the families' kernel timing")
            elif phase == "4bit":
                c.phase_main_path_4bit(model, 0, lap)
                model = None
            elif phase == "families":
                after = getattr(c, "mesh_family", None) if args.mesh else None
                kw = {} if after is None else dict(
                    after_what="phase 17 at tp = 2",
                    after=lambda name, m: after("[mesh-mixtral]", m)
                    if name.startswith("Mixtral") else None)
                c.phase_families(0, lap, **kw)
            else:
                c.phase_deepseek(0, lap)
            c.log(f"[{phase}] done")
        except Exception:  # noqa: BLE001 — reported, and the run goes on when asked
            failed = True
            c.log(f"[{phase}] FAILED:\n{traceback.format_exc()}")
            if not args.keep_going:
                raise
            torch.cuda.empty_cache()
    c.log(f"[device] {c.card_line()}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
