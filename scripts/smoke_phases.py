"""Some of ``chip_smoke.py``'s phases alone on the card: the kernel builds,
the Llama-3.1-8B model with random bf16 weights from seed 0, then the
phases named, each with its ``[time]`` laps.

    python3 scripts/smoke_phases.py pipeline pod 4bit

``pipeline`` is phase 15 on the 8B (``phase_pipeline``), ``pod`` phase 16
(``phase_pod``), ``4bit`` phase 5 (``phase_main_path_4bit``, last: it
frees the dense weights). ``chip_smoke`` is imported from ``sys.path``,
so an earlier tree's phases run with that tree's root on it (``cd
.scratch/parent && PYTHONPATH=. python3 ../../scripts/smoke_phases.py
4bit``), one process a run, for an A/B on one card."""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from mlx_sharding_tpu_torch.models import build_model  # noqa: E402

PHASES = ("pipeline", "pod", "4bit")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="+", choices=PHASES)
    args = parser.parse_args(argv)
    c.log(f"[device] {c.card_line()}")
    t0 = time.perf_counter()
    ends = [0.0]

    def lap(what):
        end = time.perf_counter() - t0
        c.log(f"[time] {what} done {end:.1f}s into the run ({end - ends[-1]:.1f}s for it)")
        ends.append(end)

    c.build_kernels()
    lap("builds")
    model, _ = build_model(c.LLAMA_31_8B, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    lap("the 8B")
    for phase in sorted(args.phases, key=PHASES.index):
        if phase == "pipeline":
            launches, _ = c.phase_pipeline(model, 0, lap)
        elif phase == "pod":
            launches, _ = c.phase_pod(model, lap)
        else:
            launches, _ = c.phase_main_path_4bit(model, 0)
            lap("phase 5")
        c.log(f"[{phase}] launches {launches}")
    c.log(f"[device] {c.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
