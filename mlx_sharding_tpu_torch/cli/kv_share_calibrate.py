"""Offline KVSharer calibration (arXiv:2410.18517): emit a share-map
artifact for ``--kv-share-map`` (port of
``mlx_sharding_tpu/cli/kv_share_calibrate.py``).

One dense prefill per calibration prompt through the port's model, the
K/V of every layer to numpy in f32, every layer pair ranked by
dissimilarity (1 − cosine; KVSharer's finding is that the MOST dissimilar
pairs are the safe ones to share), then a greedy merge of the top
``--num-share`` pairs under the ``--max-group`` cap. The resulting
``mst-kv-share-map-v1`` JSON (``kv_share.py``) is what the server loads
with ``--kv-share-map PATH``, in either package; its ``share_hash`` joins
the ``KVPageBlock`` export/import fingerprint so a pool can never scatter
a block laid out under a different map.

Calibration is offline: it runs dense prefills and copies whole KV
buffers to the host, which the serving tick never does.

Usage::

    python -m mlx_sharding_tpu_torch.cli.kv_share_calibrate \\
        --model DIR --num-share 8 [--prompts-file calib.txt] \\
        --output share_map.json [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

DEFAULT_PROMPTS = [
    "The quick brown fox jumps over the lazy dog.",
    "In a distant galaxy, explorers charted unknown worlds.",
    "Summarize the quarterly report in three bullet points.",
]


def prefill_kv(model, prompts_ids, error) -> tuple:
    """One dense prefill of each prompt through ``model``; its K and V of
    every layer as f32 numpy ``(L, 1, S, H, D)``, concatenated over the
    prompts along the sequence axis, and the token count. ``error``: the
    exception class for a prompt of fewer than 2 tokens."""
    import numpy as np
    import torch

    ks, vs, total = [], [], 0
    with torch.no_grad():
        for ids in prompts_ids:
            ids = np.asarray(ids, np.int64)
            if ids.ndim != 1 or ids.size < 2:
                raise error("calibration prompts need >= 2 tokens each")
            n = int(ids.size)
            cache = model.make_cache(1, n)
            model(torch.as_tensor(ids, device=model.device)[None, :], cache, n_valid=n)
            ks.append(cache.k[:, :, :n].float().cpu().numpy())
            vs.append(cache.v[:, :, :n].float().cpu().numpy())
            total += n
    return np.concatenate(ks, axis=2), np.concatenate(vs, axis=2), total


def calibrate_model(model, prompts_ids, *, num_share: int, max_group: int = 2, meta=None):
    """Calibration over already-tokenized prompts (JAX ``calibrate_model``,
    without its params argument: the port's model holds its weights): one
    dense prefill each, signatures over the prompts' concatenated K/V, one
    greedy share map out."""
    from mlx_sharding_tpu_torch.kv_share import ShareMapError, calibrate_share_map

    k, v, total = prefill_kv(model, prompts_ids, ShareMapError)
    info = dict(meta or {})
    info.update({"calibration_prompts": len(prompts_ids), "calibration_tokens": total})
    return calibrate_share_map(k, v, num_share=num_share, max_group=max_group, meta=info)


def read_prompts(path) -> list:
    """The calibration prompts, one per line, or the built-in mix."""
    if not path:
        return list(DEFAULT_PROMPTS)
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Calibrate a layer-wise KV share map (KVSharer)")
    parser.add_argument("--model", required=True, help="local checkpoint directory")
    parser.add_argument("--num-share", type=int, required=True,
                        help="how many layer pairs to merge; each merged pair removes one "
                             "layer's KV pool bytes")
    parser.add_argument("--max-group", type=int, default=2,
                        help="cap on layers per shared group (the paper shares pairs; >2 "
                             "compounds quality loss)")
    parser.add_argument("--prompts-file", default=None,
                        help="calibration prompts, one per line (default: a small built-in "
                             "English mix)")
    parser.add_argument("--max-prompt-tokens", type=int, default=512)
    parser.add_argument("--output", required=True,
                        help="where to write the share-map JSON artifact")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs without a card)")
    args = parser.parse_args(argv)

    from mlx_sharding_tpu_torch.device import resolve_device
    from mlx_sharding_tpu_torch.loading import load_model, load_tokenizer

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    prompts = read_prompts(args.prompts_file)
    if not prompts:
        print("no calibration prompts", file=sys.stderr)
        return 2
    model, _ = load_model(args.model, device=device)
    tokenizer = load_tokenizer(args.model)
    ids = [tokenizer.encode(p)[: args.max_prompt_tokens] for p in prompts]
    m = calibrate_model(model, [i for i in ids if len(i) >= 2], num_share=args.num_share,
                        max_group=args.max_group, meta={"model": str(args.model)})
    m.save(args.output)
    print(f"wrote {args.output}: {m.num_layers} layers -> {m.num_groups} groups "
          f"({m.bytes_saved_fraction():.1%} KV pool bytes saved), share_hash={m.share_hash}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
