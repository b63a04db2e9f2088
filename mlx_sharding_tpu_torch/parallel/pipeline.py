"""The continuous-batching engine over the paged KV pool (port of the pp=1
paged subset of ``mlx_sharding_tpu/parallel/pipeline.py::PipelineEngine``).

One model on one device drives M slots that share a pool of KV pages:

- :meth:`PipelineEngine.prefill_slot` runs one prefill chunk of one slot
  (JAX ``_build_prefill_slot``). It gathers the slot's pages below
  ``offset + chunk`` into a contiguous view (dequantized for an int8 pool),
  writes the chunk's K/V rows into the view unquantized, attends over it
  through ``causal_attention`` (the flash kernel on the card), and writes
  the chunk's rows into their page, quantized for an int8 pool. A chunk
  never straddles a page (``page_size % prefill_chunk == 0``). The host
  fills the engine's persistent prefill inputs (the slot's page row, the
  tokens, the last valid row) in one upload, and :meth:`prefill_step` reads
  them on the device: at a fixed offset the step is one program whatever
  the slot, its pages and ``n_valid``, so the batcher captures one CUDA
  graph per chunk offset (the flash kernel bakes the offset and its split
  plan into its launch).
- :meth:`PipelineEngine.decode_cb` is one ragged T=1 step of all M slots
  (JAX ``_build_decode_cb`` over ``_build_smapped_ragged``): the M new K/V
  rows are written into their pool pages (quantized first for an int8
  pool) and ``paged_attention`` reads the pool in place; an inactive slot
  writes to the scratch page and attends at length 0. Per-slot sampling
  follows. It touches no host state, so the batcher can capture a block of
  them as one CUDA graph; :meth:`PipelineEngine.advance_offsets` moves the
  host offsets after it.
- :meth:`PipelineEngine.decode_plan` builds, on the host, every slot's
  page ids, row positions and lengths for all K steps of a decode block,
  and copies them in one upload into the engine's persistent plan buffer
  for K, which a captured block reads: slot offsets are host ints, so
  nothing is read back from the card inside a block.

Pipeline, tensor and expert parallelism, the dense (unpaged) engine, the
``gather`` decode path and speculation are not yet ported: they raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from mlx_sharding_tpu_torch.cache import (
    PagedKV,
    dequantize_kv,
    init_cache_paged,
    init_page_table,
    is_quantized_kv,
    kv_data,
    layer_pool,
    write_pool_rows,
    write_pool_span,
)
from mlx_sharding_tpu_torch.device import resolve_device, upload
from mlx_sharding_tpu_torch.graphs import note_eager_forward
from mlx_sharding_tpu_torch.models.base import apply_projection_fusion
from mlx_sharding_tpu_torch.ops.attention import causal_attention
from mlx_sharding_tpu_torch.ops.paged_attention import paged_attention
from mlx_sharding_tpu_torch.sample import sample_token_batched, update_recent_tokens


@dataclasses.dataclass
class DecodePlan:
    """The device-side inputs of a decode block's K steps, uploaded once
    into one persistent buffer per K: row j of each (K, M) tensor is step
    j."""

    page_ids: torch.Tensor  # (K, M) int32: pool page of each slot's write position
    row_pos: torch.Tensor  # (K, M) int32: row of that position in its page
    lengths: torch.Tensor  # (K, M) int32: valid positions with the new one; 0 if inactive
    positions: torch.Tensor  # (K, M) int32: RoPE position of the new token
    tables: torch.Tensor  # (M, SPG) int32: slot table rows, all scratch if inactive


class PipelineEngine:
    """M continuous-batching slots of one model over one shared KV page
    pool, on one device (the JAX engine at pp = tp = ep = 1, batch 1 per
    slot, ``pool_pages`` set).

    At construction the model's packed projection groups are fused in
    place, as ``Generator`` does (``models.base.apply_projection_fusion``);
    at M <= 8 a packed decode step then runs the GEMV kernel."""

    def __init__(
        self,
        model,
        *,
        stages: int = 1,
        tp: int = 1,
        ep: int = 1,
        microbatches: int = 1,
        max_seq: int = 4096,
        prefill_chunk: int = 256,
        pool_pages: Optional[int] = None,
        page_size: Optional[int] = None,
        paged_attention: str = "auto",
        kv_dtype: Optional[str] = None,
        device=None,
    ):
        for name, n in (("pipeline stages", stages), ("tp", tp), ("ep", ep)):
            if n != 1:
                raise NotImplementedError(
                    f"{name}={n}: only the pp=1 engine is ported so far; pipeline, tensor and "
                    "expert parallelism are not yet ported (ROADMAP queue 1, item 9)"
                )
        cfg = model.config
        if not (cfg.is_first_stage and cfg.is_last_stage):
            raise ValueError("PipelineEngine wants the full model config")
        if pool_pages is None:
            raise NotImplementedError(
                "the dense continuous-batching engine (no pool_pages) is not yet ported: "
                "pass --paged-pool"
            )
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        self.model = model
        apply_projection_fusion(model)
        self.microbatches = microbatches
        # chunk-multiple capacity: padded prefill writes stay in bounds
        self.max_seq = -(-max_seq // prefill_chunk) * prefill_chunk
        self.prefill_chunk = prefill_chunk
        self.cache_dtype = model.dtype

        # Paged KV: slots address up to max_seq/page_size pages out of a
        # shared pool of ``pool_pages`` physical pages; the batcher reserves
        # pages at admission
        self.page_size = page_size or prefill_chunk
        self.pool_pages = pool_pages
        if self.page_size % prefill_chunk:
            raise ValueError(
                f"page_size {self.page_size} must be a multiple of the prefill chunk "
                f"{prefill_chunk} (chunk writes must stay inside one page)"
            )
        if self.max_seq % self.page_size:
            raise ValueError(f"page_size {self.page_size} must divide max_seq {self.max_seq}")
        self.slot_pages = self.max_seq // self.page_size  # table width

        if kv_dtype is None:
            # a checkpoint may pin it (config.kv_cache_dtype)
            kv_dtype = getattr(cfg, "kv_cache_dtype", None)
        if kv_dtype not in (None, "bf16", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r}: want int8 or bf16")
        self.kv_quant = kv_dtype == "int8"

        if paged_attention not in ("auto", "ragged", "gather"):
            raise ValueError(f"paged_attention={paged_attention!r}: want auto|ragged|gather")
        if paged_attention == "gather":
            raise NotImplementedError(
                "paged_attention='gather' (the contiguous per-slot view) is not yet ported: "
                "use 'ragged' or 'auto'"
            )
        self.paged_attention = "ragged"
        model.place_constants(self.device)
        self._plans: dict[int, tuple] = {}  # K -> (buffer, DecodePlan over it)
        # (buffer, tokens (1, chunk), page row (SPG,), last valid row (1,))
        self._prefill_buf: Optional[tuple] = None
        # forwards (prefill chunks, ragged decode steps) run eagerly on the
        # card: warm-ups of captured steps, or ``cuda_graphs=False``
        self.eager_forwards = 0

    # ------------------------------------------------------------------
    def init_cache_paged(self) -> tuple[PagedKV, np.ndarray]:
        """The shared page pool (last page scratch) and the host page table
        (M+1, slot_pages), row M all scratch."""
        cfg = self.model.config
        cache = init_cache_paged(
            cfg.num_local_layers, self.pool_pages, self.page_size, cfg.num_key_value_heads,
            cfg.head_dim, self.microbatches, self.cache_dtype, self.device,
            quantized=self.kv_quant,
        )
        return cache, init_page_table(self.microbatches, self.slot_pages, self.pool_pages)

    def _slot_view(self, pool, page_ids: torch.Tensor) -> torch.Tensor:
        """The slot's pages ``page_ids`` gathered into a contiguous (1,
        n·page, H_kv, D) copy in the model's dtype (an int8 pool is
        dequantized after the gather)."""
        if is_quantized_kv(pool):
            x = dequantize_kv({"d": pool["d"][page_ids], "s": pool["s"][page_ids]},
                              self.cache_dtype)
        else:
            x = pool[page_ids]
        return x.reshape(1, -1, *x.shape[2:])

    def prefill_inputs(self, tokens, slot: int, n_valid: int, table: np.ndarray) -> None:
        """Copy one chunk's inputs into the engine's persistent prefill
        buffer, in one upload: the chunk ``tokens`` (chunk,), the slot's
        page row and ``n_valid - 1``, the row whose logits the step
        returns. A captured :meth:`prefill_step` reads them at its replay
        (the copy is ordered before it on the stream)."""
        c = self.prefill_chunk
        if len(tokens) != c or not 0 < n_valid <= c:
            raise ValueError(f"a prefill chunk is {c} tokens; got {len(tokens)} tokens, "
                             f"{n_valid} valid")
        host = np.concatenate([np.asarray(tokens, np.int64), table[slot].astype(np.int64),
                               np.asarray([n_valid - 1], np.int64)])
        if self._prefill_buf is None:
            buf = torch.empty(host.shape, dtype=torch.int64, device=self.device)
            self._prefill_buf = (buf, buf[:c].view(1, c), buf[c:-1], buf[-1:])
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            self._prefill_buf[0].copy_(src.pin_memory(), non_blocking=True)
        else:
            self._prefill_buf[0].copy_(src)

    def prefill_step(self, cache: PagedKV, off: int) -> torch.Tensor:
        """One prefill chunk at offset ``off`` from the persistent inputs
        (:meth:`prefill_inputs`): the page view, the write page (indexed on
        the device from the slot's row) and the last valid row are read on
        the device, so the step has one program at each offset. Writes the
        chunk's K/V rows into the pool and returns the logits (1, V) at the
        last valid row. Device work only: the slot's offset is the
        caller's."""
        model, c, page = self.model, self.prefill_chunk, self.page_size
        _, tokens, row, last = self._prefill_buf
        page_ids = row[: -(-(off + c) // page)]
        write_page, start = row[off // page : off // page + 1], off % page
        note_eager_forward(self, tokens)
        h = model.embed(tokens)
        for i, layer in enumerate(model.layers):
            kp, vp = layer_pool(cache.k, i), layer_pool(cache.v, i)

            def attn_fn(q, k_new, v_new, kp=kp, vp=vp):
                # the chunk's own rows are attended as computed (unquantized);
                # the pool keeps them quantized for an int8 pool
                k_view, v_view = self._slot_view(kp, page_ids), self._slot_view(vp, page_ids)
                k_view[:, off : off + c] = k_new
                v_view[:, off : off + c] = v_new
                write_pool_span(kp, write_page, start, k_new[0])
                write_pool_span(vp, write_page, start, v_new[0])
                return causal_attention(q, k_view, v_view, off, model.scale)

            h, _, _ = model.sp_layer(layer, h, off, attn_fn)
        return model.apply_head(h.index_select(1, last))[:, 0]

    def prefill_slot(self, tokens, slot: int, cache: PagedKV, n_valid: int,
                     table: np.ndarray, graphs=None) -> torch.Tensor:
        """Prefill one right-padded chunk ``tokens`` (chunk,) of ``slot`` at
        its offset, leaving every other slot untouched; advances the slot's
        offset by ``n_valid``. ``graphs`` (a ``StepGraphs``) replays the
        step's graph for that offset, capturing it on first use; without
        it the step runs eagerly. Returns the logits (1, V) at the last
        valid row."""
        off = cache.offsets[slot]
        if off % self.prefill_chunk:
            raise ValueError(f"slot {slot}: a prefill chunk starts at a chunk-aligned offset, "
                             f"not {off}")
        if off + self.prefill_chunk > self.max_seq:
            raise ValueError(f"slot {slot}: prefill at {off} overflows capacity {self.max_seq}")
        self.prefill_inputs(tokens, slot, n_valid, table)
        step = functools.partial(self.prefill_step, cache, off)
        logits = step() if graphs is None else graphs.run(("prefill", off), step).clone()
        cache.offsets[slot] = off + n_valid
        return logits

    def decode_plan(self, cache: PagedKV, table: np.ndarray, active: list,
                    steps: int) -> DecodePlan:
        """Every slot's write page, row and attention length for ``steps``
        decode steps from its current offset, built on the host and copied
        in one upload into the persistent plan of ``steps`` steps, which is
        returned (the same tensors at every call, so a captured block reads
        each new plan). An inactive slot routes to the table's scratch row M
        at length 0. A position past the slot's mapped pages (a finished
        slot decoding to the end of its block) writes to the scratch
        page."""
        m, page, spg = self.microbatches, self.page_size, self.slot_pages
        act = np.asarray(active, bool)
        pos = np.asarray(cache.offsets, np.int64)[None, :] + np.arange(steps)[:, None]
        pos = np.where(act[None, :], pos, 0)  # (K, M)
        rows = np.where(act[:, None], table[:m], table[m][None, :])  # (M, SPG)
        pidx = pos // page
        page_ids = rows[np.arange(m)[None, :], np.minimum(pidx, spg - 1)]
        page_ids = np.where(pidx < spg, page_ids, self.pool_pages)
        lengths = np.where(act[None, :], pos + 1, 0)
        host = np.concatenate(
            [page_ids.ravel(), (pos % page).ravel(), lengths.ravel(), pos.ravel(), rows.ravel()]
        ).astype(np.int32)
        if steps not in self._plans:
            buf = torch.empty(host.shape, dtype=torch.int32, device=self.device)
            n = steps * m
            per_step = [buf[i * n : (i + 1) * n].view(steps, m) for i in range(4)]
            self._plans[steps] = (buf, DecodePlan(*per_step, tables=buf[4 * n :].view(m, spg)))
        buf, plan = self._plans[steps]
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            buf.copy_(src.pin_memory(), non_blocking=True)
        else:
            buf.copy_(src)
        return plan

    def ragged_logits(self, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan,
                      j: int) -> torch.Tensor:
        """The ragged forward of step j of the plan for all M slots: the new
        K/V rows land in the pool, ``tokens`` (M, 1) give logits (M, V).
        Offsets are not advanced (:meth:`advance_offsets` does that)."""
        model = self.model
        note_eager_forward(self, tokens)
        page_ids, row_pos = plan.page_ids[j], plan.row_pos[j]
        lengths, positions = plan.lengths[j], plan.positions[j]
        h = model.embed(tokens)  # (M, 1, hidden): the slot axis is the batch axis
        for i, layer in enumerate(model.layers):
            kp, vp = layer_pool(cache.k, i), layer_pool(cache.v, i)

            def attn_fn(q, k_new, v_new, kp=kp, vp=vp):
                write_pool_rows(kp, page_ids, row_pos, k_new[:, 0])
                write_pool_rows(vp, page_ids, row_pos, v_new[:, 0])
                quant = is_quantized_kv(kp)
                out = paged_attention(
                    q[:, 0], kv_data(kp), kv_data(vp), plan.tables, lengths, model.scale,
                    k_scale=kp["s"] if quant else None, v_scale=vp["s"] if quant else None,
                )
                return out[:, None]  # (M, T=1, Hq, Dv)

            h, _, _ = model.sp_layer(layer, h, positions, attn_fn)
        h = torch.where((lengths > 0)[:, None, None], h, torch.zeros((), dtype=h.dtype,
                                                                     device=h.device))
        return model.apply_head(h)[:, 0]

    def decode_cb(self, tokens: torch.Tensor, cache: PagedKV, plan: DecodePlan, step: int, *,
                  recent: torch.Tensor, generators: list, sp, rep_mask: torch.Tensor,
                  sampled: bool):
        """One continuous-batching decode step (step ``step`` of ``plan``):
        the ragged forward of all M slots, then per-slot sampling with each
        slot's settings, generator and repetition window (``rep_mask``
        keeps the last ``rep_context`` entries of slot m's window), and the
        window updated in place. ``sampled``: some slot may sample (every
        row then draws from its generator). Device work only: offsets are
        the caller's (:meth:`advance_offsets`). Returns ``(tokens (M, 1),
        logprobs (M, V))``."""
        logits = self.ragged_logits(tokens, cache, plan, step)
        masked = torch.where(rep_mask, recent, torch.full_like(recent, -1))
        tok, logprobs = sample_token_batched(generators, logits, sp, masked, sampled=sampled)
        recent.copy_(update_recent_tokens(recent, tok))
        return tok[:, None], logprobs

    @staticmethod
    def advance_offsets(cache: PagedKV, active: list, steps: int) -> None:
        """The host side of ``steps`` decode steps: every active slot's
        offset moves by ``steps``."""
        for m, a in enumerate(active):
            if a:
                cache.offsets[m] += steps
