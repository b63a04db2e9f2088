"""Offline low-rank KV calibration (TPLA-style, arXiv:2508.15881): emit a
compress-map artifact for ``--kv-compress-map`` (port of
``mlx_sharding_tpu/cli/kv_compress_calibrate.py``).

One dense prefill per calibration prompt through the port's model, the
KV buffers flattened to per-layer row matrices ``(tokens, H*D)``, and a
truncated SVD per layer (``kv_compress.calibrate_compress_map``): the
top-``r`` right-singular vectors become the down/up projection pair the
serving codec applies where KV leaves the card (spill flushes, prefix-store
demotions). The artifact stamps the per-layer relative reconstruction
error over the calibration set: the documented tolerance of the lossy
path (MLA-native models need no artifact; their latent export is exact).

When the serving pool runs under a KV share map (``--kv-share-map``),
pass the SAME artifact here: the pool stores one buffer per share group
(written by the group's owner layer), so calibration fits one projection
per group over the owner layers' rows and stamps the share map's hash —
``kv_compress.build_codec`` refuses a compress map whose ``share_hash``
does not match the live pool, so the two calibrations compose or neither
loads.

Usage::

    python -m mlx_sharding_tpu_torch.cli.kv_compress_calibrate \\
        --model DIR --rank 32 [--kv-share-map share_map.json] \\
        [--prompts-file calib.txt] --output compress_map.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from mlx_sharding_tpu_torch.cli.kv_share_calibrate import prefill_kv, read_prompts


def calibrate_model(model, prompts_ids, *, rank: int, share_map=None, meta=None):
    """Calibration over already-tokenized prompts (JAX ``calibrate_model``,
    without its params argument): one dense prefill each, KV rows
    concatenated along the sequence axis, one per-layer SVD map out.
    ``share_map`` (a ``kv_share.KVShareMap``) reduces the layer axis to the
    groups' owners and stamps its ``share_hash``."""
    from mlx_sharding_tpu_torch.kv_compress import CompressError, calibrate_compress_map

    k, v, total = prefill_kv(model, prompts_ids, CompressError)
    share_hash = None
    if share_map is not None and not share_map.is_identity:
        share_map.validate_for(k.shape[0])
        # the grouped pool holds the owner layer's KV for every member of
        # its group: fit the projection on what the pool will contain
        owners = list(share_map.owner_layers)
        k, v = k[owners], v[owners]
        share_hash = share_map.share_hash
    info = dict(meta or {})
    info.update({"calibration_prompts": len(prompts_ids), "calibration_tokens": total})
    return calibrate_compress_map(k, v, rank=rank, share_hash=share_hash, meta=info)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Calibrate a low-rank KV compress map "
                                                 "(kv_compress)")
    parser.add_argument("--model", required=True, help="local checkpoint directory")
    parser.add_argument("--rank", type=int, required=True,
                        help="latent rank r: exported blocks ship (tokens, r) coefficients "
                             "instead of (tokens, H*D) rows — bytes scale ~ r/(H*D)")
    parser.add_argument("--kv-share-map", default=None, metavar="PATH",
                        help="the share-map artifact the serving pool runs under, if any: "
                             "calibrates per share GROUP and stamps its hash so the artifacts "
                             "compose")
    parser.add_argument("--prompts-file", default=None,
                        help="calibration prompts, one per line (default: a small built-in "
                             "English mix)")
    parser.add_argument("--max-prompt-tokens", type=int, default=512)
    parser.add_argument("--output", required=True,
                        help="where to write the compress-map .npz artifact")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs without a card)")
    args = parser.parse_args(argv)

    from mlx_sharding_tpu_torch.device import resolve_device
    from mlx_sharding_tpu_torch.kv_share import load_share_map
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
    m = calibrate_model(model, [i for i in ids if len(i) >= 2], rank=args.rank,
                        share_map=load_share_map(args.kv_share_map),
                        meta={"model": str(args.model)})
    m.save(args.output)
    cal = m.meta["calibration"]
    print(f"wrote {args.output}: {m.num_layers} layers, rank {m.rank} over "
          f"{m.num_heads}x({m.head_dim_k},{m.head_dim_v}) rows, "
          f"max_rel_err={cal['max_rel_err']:.2e}, compress_hash={m.compress_hash}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
