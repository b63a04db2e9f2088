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


def read_safetensors(path: Path) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors sharing one
    buffer that holds the file's data once."""
    path = Path(path)
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
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


def write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` as one ``.safetensors`` file that
    :func:`read_safetensors` reads back (the same layout: 8-byte header
    length, a JSON header, the raw little-endian data; ``int32`` as
    ``I32``)."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items() if k != "U32"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def load_raw_weights(model_path: Path) -> dict[str, torch.Tensor]:
    files = sorted(model_path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No safetensors found in {model_path}")
    weights: dict[str, torch.Tensor] = {}
    for file in files:
        weights.update(read_safetensors(file))
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


def filter_stage_weights(weights: dict, config) -> dict:
    """Keep layers in [start, end); the embedding only where the stage needs
    it; the final norm and head only on the last stage. Rotary inv_freq
    buffers are dropped."""
    kept = {}
    for name, value in weights.items():
        if "rotary_emb.inv_freq" in name:
            continue
        m = LAYER_RE.search(name)
        if m:
            if config.start_layer <= int(m.group(1)) < config.end_layer:
                kept[name] = value
            continue
        if "embed_tokens" in name:
            if config.needs_embed:
                kept[name] = value
            continue
        if name.startswith(("model.norm", "norm.")) or "lm_head" in name:
            if config.needs_head:
                kept[name] = value
            continue
        kept[name] = value
    return kept


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
    weights = load_raw_weights(model_path)
    if config.quantization is not None:
        weights = dequantize_weights(weights, config.quantization, dtype,
                                     keep_packed_layers=keep_quantized,
                                     keep_dense_re=model.packed_keep_dense_re())
    weights = filter_stage_weights(weights, config)
    model.load_weights(model.map_weights(weights), dev, dtype)
    return model, config


def load_tokenizer(path: str):
    """The checkpoint's tokenizer, through ``transformers``."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(get_model_path(path)))
