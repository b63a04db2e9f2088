"""Checkpoint loading (port of ``mlx_sharding_tpu/loading.py``).

Read ``config.json`` (with the pipeline bounds ``start_layer``/``end_layer``
injected), read every ``*.safetensors`` with the small reader below,
dequantize MLX grouped-quant triples when ``config.quantization`` is present
(or keep them packed, ``keep_quantized``), drop weights outside the stage,
and hand the rest to the model's ``map_weights``. The reader is the port's
own (8-byte header length, a JSON header, then the raw little-endian data),
so loading needs neither ``safetensors`` nor ``transformers``; packed
``U32`` words are read as an ``int32`` view of the same bits. Local
directories only: no hub downloads.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Optional

import torch

from mlx_sharding_tpu_torch.device import resolve_device
from mlx_sharding_tpu_torch.models import build_model
from mlx_sharding_tpu_torch.ops.quant import dequantize

LAYER_RE = re.compile(r"(?:model\.)?layers\.(\d+)\.")
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    # packed quant words: the bits of each uint32, as int32 (see ops/quant.py)
    "U32": torch.int32,
}


def get_model_path(path: str) -> Path:
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"model directory {path!r} not found (the port loads local checkpoints only)")
    return p


def checkpoint_signature(path: str, *, keep_quantized: bool = False) -> str:
    """Stable content identity of a checkpoint for ``weights.WeightKey``
    (JAX ``loading.checkpoint_signature``): the resolved path plus the
    quantization config and whether the load keeps packed triples
    resident. Two replicas may alias one resident model only when this
    string matches — same files, same dequant decisions, same layout."""
    model_path = get_model_path(path)
    quant = None
    cfg = model_path / "config.json"
    if cfg.exists():
        with open(cfg) as f:
            quant = json.load(f).get("quantization")
    if quant:
        qsig = f"gs{int(quant.get('group_size', 64))}b{int(quant.get('bits', 4))}"
        packed = "packed" if keep_quantized else "dense"
    else:
        qsig, packed = "dense", "dense"
    return f"{model_path.resolve()}::{qsig}::{packed}"


def load_config(model_path: Path, start_layer: Optional[int] = None,
                end_layer: Optional[int] = None) -> dict:
    with open(model_path / "config.json") as f:
        config = json.load(f)
    # CLI stage bounds override whatever the checkpoint baked in
    if start_layer is not None:
        config["start_layer"] = start_layer
    if end_layer is not None:
        config["end_layer"] = end_layer
    return config


def read_safetensors(path: Path, keep=None) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors sharing one
    buffer that holds the file's data once; with ``keep`` (a predicate on
    the names) only the tensors it keeps, each read on its own."""
    path = Path(path)
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        if keep is not None:
            return _read_kept(f, 8 + header_len, header, keep, path)
        buf = bytearray(path.stat().st_size - 8 - header_len)
        f.readinto(buf)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        if count == 0:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        flat = torch.frombuffer(buf, dtype=dtype, count=count, offset=start)
        out[name] = flat.reshape(info["shape"])
    return out


def _read_kept(f, base: int, header: dict, keep, path: Path) -> dict[str, torch.Tensor]:
    """The tensors of an open ``.safetensors`` file whose names ``keep``
    keeps, each read from its own byte range."""
    out = {}
    for name, info in header.items():
        if name == "__metadata__" or not keep(name):
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        buf = bytearray(end - start)
        f.seek(base + start)
        f.readinto(buf)
        out[name] = torch.frombuffer(buf, dtype=dtype).reshape(info["shape"])
    return out


def write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` as one ``.safetensors`` file that
    :func:`read_safetensors` reads back (the same layout: 8-byte header
    length, a JSON header, the raw little-endian data; ``int32`` as
    ``I32``), one tensor's bytes on the host at a time."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items() if k != "U32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)


def load_raw_weights(model_path: Path, keep=None) -> dict[str, torch.Tensor]:
    files = sorted(model_path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No safetensors found in {model_path}")
    weights: dict[str, torch.Tensor] = {}
    for file in files:
        weights.update(read_safetensors(file, keep))
    return weights


def dequantize_weights(weights: dict, quantization: dict, dtype=torch.bfloat16,
                       keep_packed_layers: bool = False,
                       keep_dense_re: Optional[str] = None) -> dict:
    """Process every MLX ``{weight, scales, biases}`` triple: a weight is
    quantized iff its ``.scales`` sibling exists. By default it becomes a
    dense ``dtype`` weight. With ``keep_packed_layers``, decoder-layer
    projections and the vocab pair (``embed_tokens``, ``lm_head``) stay
    packed as ``{q, scales, biases}`` for the quant kernels, scales and
    biases in the checkpoint's dtype, except the names ``keep_dense_re``
    matches (``model.packed_keep_dense_re``: a MoE router); anything else
    still dequantizes."""
    group_size = int(quantization.get("group_size", 64))
    bits = int(quantization.get("bits", 4))
    dense_re = re.compile(keep_dense_re) if keep_dense_re else None
    out = {}
    for name, value in weights.items():
        base, _, leaf = name.rpartition(".")
        if leaf in ("scales", "biases"):
            continue  # consumed with their .weight
        if leaf == "weight" and f"{base}.scales" in weights:
            scales, biases = weights[f"{base}.scales"], weights[f"{base}.biases"]
            if keep_packed_layers and (
                LAYER_RE.search(name) or "embed_tokens" in name or "lm_head" in name
            ) and not (dense_re and dense_re.search(name)):
                out[name] = {"q": value, "scales": scales, "biases": biases}
                continue
            value = dequantize(value, scales, biases, group_size, bits, dtype)
        out[name] = value
    return out


def stage_keeps(name: str, config) -> bool:
    """Whether the stage of ``config`` keeps the checkpoint tensor ``name``:
    its layers in [start, end), the embedding where the stage needs it, the
    final norm and the head on the last stage; never a rotary inv_freq
    buffer."""
    if "rotary_emb.inv_freq" in name:
        return False
    m = LAYER_RE.search(name)
    if m:
        return config.start_layer <= int(m.group(1)) < config.end_layer
    if "embed_tokens" in name:
        return config.needs_embed
    if name.startswith(("model.norm", "norm.")) or "lm_head" in name:
        return config.needs_head
    return True


def filter_stage_weights(weights: dict, config) -> dict:
    """Keep layers in [start, end); the embedding only where the stage needs
    it; the final norm and head only on the last stage. Rotary inv_freq
    buffers are dropped."""
    return {name: value for name, value in weights.items() if stage_keeps(name, config)}


def load_model(path: str, start_layer: Optional[int] = None, end_layer: Optional[int] = None,
               dtype=torch.bfloat16, device=None, keep_quantized: bool = False):
    """Full load path. Returns ``(model, config)`` with the weights on
    ``device`` (default cuda) in ``dtype``. ``keep_quantized`` keeps an MLX
    4-bit checkpoint's projections and vocab pair packed in device memory
    (the quant kernels read them); without it they are dequantized on
    load."""
    dev = resolve_device(device)
    model_path = get_model_path(path)
    model, config = build_model(load_config(model_path, start_layer, end_layer), dtype=dtype)
    if keep_quantized and not getattr(model, "supports_packed", False):
        raise ValueError(f"keep_quantized is not supported for {type(model).__name__}")
    if keep_quantized and config.quantization is None:
        # a silent dense load would quietly cost 4x the expected memory
        raise ValueError(
            "keep_quantized requires a quantized checkpoint "
            "(no 'quantization' key in config.json)"
        )
    # a stage reads only its own tensors' bytes
    whole = config.is_first_stage and config.is_last_stage
    weights = load_raw_weights(model_path, None if whole else
                               (lambda name: stage_keeps(name, config)))
    if config.quantization is not None:
        weights = dequantize_weights(weights, config.quantization, dtype,
                                     keep_packed_layers=keep_quantized,
                                     keep_dense_re=model.packed_keep_dense_re())
    weights = filter_stage_weights(weights, config)
    model.load_weights(model.map_weights(weights), dev, dtype)
    return model, config


def rank_model(part):
    """A model of the whole layer range over ``part``, a stage's model
    (``load_model`` with a layer range): its layers keep their global
    indices, the layers of other processes are empty placeholders that
    nothing runs, and the embedding, final norm and head are ``part``'s
    (present where the stage needs them). A ``PipelineEngine`` over
    several processes takes it with the stages of this rank."""
    import copy
    import dataclasses

    from torch import nn

    cfg = part.config
    full = copy.copy(part)
    full._modules = dict(part._modules)
    full._parameters = dict(part._parameters)
    full._buffers = dict(part._buffers)
    full.config = dataclasses.replace(cfg, start_layer=0, end_layer=cfg.num_hidden_layers)
    full._modules["layers"] = nn.ModuleList(
        [nn.Module() for _ in range(cfg.start_layer)] + list(part.layers)
        + [nn.Module() for _ in range(cfg.num_hidden_layers - cfg.end_layer)])
    return full


def load_rank_model(path: str, stage_bounds, processes, dtype=torch.bfloat16, device=None,
                    keep_quantized: bool = False):
    """This rank's share of a checkpoint for an engine over several
    processes (``processes``, a ``parallel.mesh.ProcessLayout`` over the
    stages of ``stage_bounds``): the layers of its stages, the embedding
    where it runs stage 0 (or the last stage of a tied model) and the final
    norm and head where it runs the last stage, as a :func:`rank_model`.
    Only those tensors are read and placed on ``device``. Returns ``(model,
    config of the whole range)``."""
    local = processes.local_stages
    start, end = stage_bounds[local[0]][0], stage_bounds[local[-1]][1]
    part, _ = load_model(path, start, end, dtype=dtype, device=device,
                         keep_quantized=keep_quantized)
    full = rank_model(part)
    return full, full.config


def load_tokenizer(path: str):
    """The checkpoint's tokenizer, through ``transformers``."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(get_model_path(path)))
