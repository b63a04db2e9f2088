"""The chained pipeline (port of ``mlx_sharding_tpu/parallel/chained.py``):
one model per stage, each on its own device, driven in order by the host,
the hidden state handed from stage to stage.

Where the fused engine (``parallel/pipeline.py``) runs one program over
every stage, the chained pipeline runs each stage's own model
(``load_model(path, start, end)``): uneven splits and DeepSeek-V2's dense
prefix with its MoE suffix need nothing special. :class:`ChainedPipeline`
keeps ``Generator.generate_step``'s contract: chunked prefill, then decode
in whole blocks with sampling on the device and the same sampler
transforms, through the stages in order. Each stage keeps its own KV cache
over its own layers on its device. On one device a prefill chunk and a
decode block through every stage are each one CUDA graph, as at pp = 1; on
distinct devices (or with ``stage_graphs=True``) each stage's forward is a
graph of its own on its device (``graphs.StageGraphs``) and sampling runs
eagerly between them (not yet run on more than one card).

``pipeline.stage_model`` makes a stage of a model that is already loaded,
over its tensors (no copy): the smoke chains the model it serves at pp = 1.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch

from mlx_sharding_tpu_torch.cache import KVCache
from mlx_sharding_tpu_torch.generate import DEFAULT_PREFILL_CHUNK
from mlx_sharding_tpu_torch.graphs import StageGraphs
from mlx_sharding_tpu_torch.parallel.mesh import stage_devices
from mlx_sharding_tpu_torch.parallel.pipeline import (
    StagedGenerator,
    StageStack,
    check_stage_bounds,
    hop,
    stage_model,
)


class _Chain(StageStack):
    """The stages as the one model a ``Generator`` steps: a call runs every
    stage over its own cache at the position of the Generator's cache,
    handing the hidden state on, and returns the last stage's logits on
    stage 0's device."""

    def __init__(self, stages: list, devices: list, max_seq: int, graphs: StageGraphs):
        self.stages, self.devices, self.graphs = stages, devices, graphs
        self.device = devices[0]
        self.layers = [layer for st in stages for layer in st.layers]
        self.caches = [st.make_cache(1, max_seq) for st in stages]

    def fused_projection_groups(self) -> dict:
        return self.stages[0].fused_projection_groups()

    def place_constants(self, device) -> None:
        for st, dev in zip(self.stages, self.devices):
            st.place_constants(dev)

    def _stage(self, s: int, offset: int, h, pos, logits_at=None):
        """Stage s's forward over its cache at the host ``offset`` and the
        device position ``pos``."""
        kv = dataclasses.replace(self.caches[s], offset=offset, pos=pos)
        return self.stages[s](h, kv, logits_at=logits_at)[0]

    def __call__(self, x, cache: KVCache, n_valid=None, logits_at=None):
        """The Generator's steps call it with its cache, whose device
        position ``pos`` every stage reads, and a prefill chunk's last
        valid row as a (1,) tensor ``logits_at``."""
        h, last = x, len(self.stages) - 1
        # a decode step reads the device position; a chunk's kernel bakes
        # the host offset into its launch
        key = ("decode",) if x.shape[1] == 1 else ("prefill", cache.offset)
        for s, dev in enumerate(self.devices):
            inputs = [hop(h, dev), hop(cache.pos, dev)]
            if s == last and logits_at is not None:
                inputs.append(hop(logits_at, dev))
            h = self.graphs.run(s, key, functools.partial(self._stage, s, cache.offset), *inputs)
        return hop(h, self.devices[0]), cache


class ChainedPipeline(StagedGenerator):
    """A ``Generator`` over a list of stage models, one a device (JAX's
    ``ChainedPipeline``). Stage 0 must start at layer 0 and the last stage
    end at the model's last; the bounds may be uneven. ``devices``: each
    stage's (default: where each stage's weights are). ``stage_graphs``:
    capture each stage's forward on its own rather than whole steps; by
    default iff the stages are on distinct devices."""

    def __init__(self, stage_models: Sequence, *, devices: Optional[Sequence] = None,
                 max_seq: int = 4096, prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
                 cuda_graphs: bool = True, stage_graphs: Optional[bool] = None, **kwargs):
        models = list(stage_models)
        if not models or not models[0].config.is_first_stage:
            raise ValueError("stage 0 must start at layer 0")
        if not models[-1].config.is_last_stage:
            raise ValueError("last stage must end at num_hidden_layers")
        n = len(models)
        if devices is None:
            devices = [m.device for m in models]
        if len(devices) < n:
            raise ValueError(f"{n} stages need {n} devices, have {len(devices)}")
        devices = [torch.device(d) for d in devices[:n]]
        for m, dev in zip(models, devices):
            if m.device != dev:
                m.to(dev)
        self.models, self.num_stages, self.devices = models, n, devices
        self.stage_bounds = [(m.config.start_layer, m.config.end_layer) for m in models]
        capacity = -(-max_seq // prefill_chunk) * prefill_chunk
        per_stage = len(set(devices)) > 1 if stage_graphs is None else stage_graphs
        graphs = StageGraphs(devices, per_stage and cuda_graphs and devices[0].type == "cuda")
        super().__init__(_Chain(models, devices, capacity, graphs), max_seq=max_seq,
                         prefill_chunk=prefill_chunk, cuda_graphs=cuda_graphs, **kwargs)


def chained_from_model(model, stage_bounds, **kwargs) -> ChainedPipeline:
    """A chained pipeline over the stages ``stage_bounds`` of a loaded full
    model, on its device, sharing its tensors."""
    bounds = check_stage_bounds(stage_bounds, model.config.num_hidden_layers)
    return ChainedPipeline([stage_model(model, a, b) for a, b in bounds], **kwargs)


def load_chained_pipeline(model_path: str, stage_bounds, *, dtype=torch.bfloat16,
                          keep_quantized: bool = False, device=None,
                          **kwargs) -> ChainedPipeline:
    """Load each stage of the checkpoint at ``model_path`` with its bounds
    (``[(0, 14), (14, 27)]``, JAX's DeepSeek split), stage s on its device
    (``parallel.mesh.stage_devices``: the s-th CUDA device, or every stage on
    ``device``), and chain them."""
    from mlx_sharding_tpu_torch.loading import load_model

    bounds = [tuple(int(x) for x in b) for b in stage_bounds]
    models = [load_model(model_path, a, b, dtype=dtype, device=dev,
                         keep_quantized=keep_quantized)[0]
              for (a, b), dev in zip(bounds, stage_devices(len(bounds), device))]
    return ChainedPipeline(models, **kwargs)
