"""Cold builds of every kernel library of the port, an earlier tree's
against this one's, on the card's machine (nvcc and its host's cores).

    python3 scripts/build_timing.py --parent .scratch/parent [--rounds 2]

Unpack the earlier commit first (``git archive <commit> | tar -x -C
.scratch/parent``). Each round builds parent, this, this, parent (so that
neither side always builds first), each in a fresh process with its
``_build/`` removed, through that tree's ``chip_smoke.build_kernels``
(one nvcc per source or part, all started together), and prints the
card's name and power limit, each build's wall seconds and each library's
and part's lines; the last line is a JSON summary."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

BUILD = ("import sys, time; sys.path.insert(0, '.'); import chip_smoke as c; "
         "t0 = time.perf_counter(); c.build_kernels(); "
         "print('BUILD_S', round(time.perf_counter() - t0, 2))")


def build(tree: str) -> float:
    """One cold build of ``tree``'s kernel libraries; its wall seconds."""
    shutil.rmtree(os.path.join(tree, "mlx_sharding_tpu_torch", "_build"), ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", BUILD], cwd=tree, capture_output=True,
                          text=True, check=False)
    secs = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"the build of {tree} failed")
    for line in proc.stdout.splitlines():
        if "built" in line or "compiled in" in line or line.startswith("BUILD_S"):
            print("   ", line.strip(), flush=True)
    return secs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="an earlier tree, unpacked")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(f"{card}; {os.cpu_count()} CPUs", flush=True)
    trees = {"parent": os.path.abspath(args.parent),
             "this": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}
    walls = {"parent": [], "this": []}
    for _ in range(args.rounds):
        for name in ("parent", "this", "this", "parent"):
            secs = build(trees[name])
            walls[name].append(round(secs, 2))
            print(f"{name}: {secs:.2f} s", flush=True)
    print(json.dumps({"card": card, "wall_s": walls,
                      "median_s": {k: statistics.median(v) for k, v in walls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
