"""Checkpoint loading (port of the dense path of ``mlx_sharding_tpu/loading.py``).

Read ``config.json`` (with the pipeline bounds ``start_layer``/``end_layer``
injected), read every ``*.safetensors`` with the small reader below, drop
weights outside the stage, and hand the rest to the model's
``map_weights``. The reader is the port's own (8-byte header length, a
JSON header, then the raw little-endian data), so loading needs neither
``safetensors`` nor ``transformers``. MLX 4-bit checkpoints come with the
keep-quantized slice. Local directories only: no hub downloads.
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

LAYER_RE = re.compile(r"(?:model\.)?layers\.(\d+)\.")
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def get_model_path(path: str) -> Path:
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"model directory {path!r} not found (the port loads local checkpoints only)")
    return p


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


def load_raw_weights(model_path: Path) -> dict[str, torch.Tensor]:
    files = sorted(model_path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No safetensors found in {model_path}")
    weights: dict[str, torch.Tensor] = {}
    for file in files:
        weights.update(read_safetensors(file))
    return weights


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
               dtype=torch.bfloat16, device=None):
    """Full load path. Returns ``(model, config)`` with the weights on
    ``device`` (default cuda) in ``dtype``."""
    dev = resolve_device(device)
    model_path = get_model_path(path)
    model, config = build_model(load_config(model_path, start_layer, end_layer), dtype=dtype)
    if config.quantization is not None:
        raise NotImplementedError(
            "MLX 4-bit checkpoints are not yet ported to PyTorch: see ROADMAP.md "
            "queue 1, item 2 (the keep-quantized slice)"
        )
    weights = filter_stage_weights(load_raw_weights(model_path), config)
    sd = {k: v.to(device=dev, dtype=dtype) for k, v in model.map_weights(weights).items()}
    model.load_state_dict(sd, assign=True)
    return model, config


def load_tokenizer(path: str):
    """The checkpoint's tokenizer, through ``transformers``."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(get_model_path(path)))
