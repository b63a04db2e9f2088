"""Where a ``torch.profiler`` window's seconds go on the card: one
16-step decode block of Llama-3.1-8B (random bf16 weights, a 600-token
prompt), through CUDA graphs and eagerly, profiled with and without CPU
activity, twice each: the window's entry, the block, the session's exit,
``key_averages()`` and, beside it, the sum of the profile's raw device
events (``kineto_results.events()``), each device total in ms.

    python3 scripts/profiler_cost.py"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as c  # noqa: E402
from mlx_sharding_tpu_torch.generate import (  # noqa: E402
    DEFAULT_DECODE_BLOCK,
    REPETITION_WINDOW,
    Generator,
)
from mlx_sharding_tpu_torch.models import build_model  # noqa: E402


def main() -> int:
    c.log(f"[device] {c.card_line()}")
    c.build_kernels()
    model, _ = build_model(c.LLAMA_31_8B, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
    ids = c.ByteTokenizer().encode(c.mix_prompt(1, 600))
    for mode in ("graph", "eager"):
        gen = Generator(model, max_seq=c.MAX_SEQ, prefill_chunk=c.CHUNK,
                        cuda_graphs=mode == "graph")
        list(gen.generate_step(ids, max_tokens=1))

        def block(gen=gen):
            gen.run_block(DEFAULT_DECODE_BLOCK, REPETITION_WINDOW, False, False)

        block()
        torch.cuda.synchronize()
        for acts in (("cpu", "cuda"), ("cuda",)) * 2:
            activities = [ProfilerActivity.CPU] * ("cpu" in acts) + [ProfilerActivity.CUDA]
            t0 = time.perf_counter()
            with profile(activities=activities) as prof:
                t1 = time.perf_counter()
                block()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            t3 = time.perf_counter()
            raw = sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
            t4 = time.perf_counter()
            averaged = sum(e.self_device_time_total for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            t5 = time.perf_counter()
            c.log(f"[prof] {mode} {'+'.join(acts)}: enter {t1 - t0:.2f}s, block {t2 - t1:.2f}s, "
                  f"exit {t3 - t2:.2f}s, raw events {t4 - t3:.2f}s ({raw:.2f} ms of device), "
                  f"key_averages {t5 - t4:.2f}s ({averaged:.2f} ms) for {DEFAULT_DECODE_BLOCK} "
                  f"steps")
        del gen
    c.log(f"[device] {c.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
