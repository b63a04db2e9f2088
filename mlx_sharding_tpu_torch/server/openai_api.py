"""OpenAI-compatible HTTP server (port of the single-``Generator`` path of
``mlx_sharding_tpu/server/openai_api.py``).

``POST /v1/completions`` and ``POST /v1/chat/completions`` (non-streamed,
or SSE that holds back text that could still grow into a stop sequence),
logprobs, ``logit_bias``, the JAX server's parameter validation, the plain
chat prompt for tokenizers without a template, and ``GET /health``. One
:class:`ModelProvider` holds one generator and its tokenizer. A single-stream
``Generator`` is serialized by a lock; with ``--concurrent N --paged-pool P``
the generator is a :class:`~mlx_sharding_tpu_torch.scheduler.ContinuousBatcher`
(``concurrent = True``), which interleaves requests itself and is served
without the lock. Fleet, replica, trace, metrics and static-UI serving come
with later slices.

    python -m mlx_sharding_tpu_torch.server.openai_api --model DIR [--device cpu]
        [--concurrent 8 --paged-pool 64 [--kv-dtype int8]]
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from mlx_sharding_tpu_torch.tokenizer_utils import (
    StreamingDetokenizer,
    sequence_overlap,
    stopping_criteria,
)

logger = logging.getLogger(__name__)


class RequestTimeoutError(Exception):
    """Generation ran past the request's ``request_timeout``."""


def _encode_plain(tokenizer, text: str) -> list[int]:
    """Encode without special tokens (stop sequences must match raw ids)."""
    try:
        return list(tokenizer.encode(text, add_special_tokens=False))
    except TypeError:
        return list(tokenizer.encode(text))


def convert_chat(messages: list, role_mapping: Optional[dict] = None) -> str:
    """Plain-text prompt for a tokenizer without a chat template."""
    default = {
        "system_prompt": "A chat between a curious user and an artificial "
        "intelligence assistant. The assistant follows the given rules no "
        "matter what.",
        "system": "ASSISTANT's RULE: ",
        "user": "USER: ",
        "assistant": "ASSISTANT: ",
        "stop": "\n",
    }
    role_mapping = role_mapping or default
    prompt = role_mapping.get("system_prompt", "")
    for m in messages:
        prefix = role_mapping.get(m["role"], "")
        stop = role_mapping.get("stop", "")
        prompt += f"{prefix}{m['content']}{stop}"
    prompt += role_mapping.get("assistant", "")
    return prompt.rstrip()


class ModelProvider:
    """One generator and its tokenizer, served under ``model_name``."""

    def __init__(self, generator, tokenizer, *, model_name: str = "default_model"):
        self.generator = generator
        self.tokenizer = tokenizer
        self.model_name = model_name

    @classmethod
    def from_checkpoint(cls, path: str, *, device=None, max_seq: int = 4096,
                        prefill_chunk: int = 256, keep_quantized: bool = False,
                        concurrent: int = 1, paged_pool: Optional[int] = None,
                        page_size: Optional[int] = None, paged_attention: str = "auto",
                        kv_dtype: Optional[str] = None, admission_policy: str = "fifo",
                        overcommit: bool = False, async_sched: str = "auto",
                        ) -> "ModelProvider":
        """A single-stream ``Generator``, or with ``concurrent > 1`` a
        ``ContinuousBatcher`` of that many slots over a pool of
        ``paged_pool`` KV pages (the JAX server's pp=1 paged engine), with
        ``overcommit`` admission and ``async_sched`` ticks. On a card its
        step graphs are captured here, before the first request."""
        from mlx_sharding_tpu_torch.generate import DEFAULT_DECODE_BLOCK, Generator
        from mlx_sharding_tpu_torch.loading import load_model, load_tokenizer

        model, _ = load_model(path, device=device, keep_quantized=keep_quantized)
        if concurrent <= 1:
            generator = Generator(model, max_seq=max_seq, prefill_chunk=prefill_chunk)
        else:
            from mlx_sharding_tpu_torch.parallel import PipelineEngine
            from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

            engine = PipelineEngine(
                model, microbatches=concurrent, max_seq=max_seq, prefill_chunk=prefill_chunk,
                pool_pages=paged_pool, page_size=page_size, paged_attention=paged_attention,
                kv_dtype=kv_dtype, device=device,
            )
            generator = ContinuousBatcher(engine, decode_block=min(8, DEFAULT_DECODE_BLOCK),
                                          policy=admission_policy, overcommit=overcommit,
                                          async_sched=async_sched)
        captured = generator.warm_up()  # on a card: the step graphs, before any request
        if captured:
            logger.info("captured %d CUDA graphs in %.2f s, graph pool %.1f MB",
                        captured["graphs"], captured["seconds"], captured["pool_bytes"] / 1e6)
        return cls(generator, load_tokenizer(path), model_name=path)

    def load(self, name: str):
        """The generator and tokenizer for a request naming ``name``."""
        if name not in ("default_model", self.model_name):
            raise ValueError(f"model {name!r} is not served here; this server serves "
                             f"{self.model_name!r}")
        return self.generator, self.tokenizer


class APIHandler(BaseHTTPRequestHandler):
    """Bound to its provider by :func:`make_server` (class attributes, as
    the standard library requires)."""

    provider: ModelProvider = None
    gen_lock: threading.Lock = None
    protocol_version = "HTTP/1.1"
    # request bodies above this are rejected before being read
    MAX_BODY = 8 << 20

    # ------------------------------------------------------------- helpers
    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _cors(self):
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "Content-Type, Authorization")

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self._cors()
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str):
        kind = (
            "invalid_request_error" if code == 400
            else "not_found_error" if code == 404
            else "timeout_error" if code == 504
            else "server_error"
        )
        self._json(code, {"error": {"message": message, "type": kind, "code": code}})

    # ------------------------------------------------------------- routing
    def do_OPTIONS(self):
        self.send_response(204)
        self._cors()
        self.end_headers()

    def do_GET(self):
        if self.path.split("?")[0] == "/health":
            return self._json(200, {"status": "ok"})
        return self._error(404, f"not found: {self.path}")

    def do_POST(self):
        route = self.path.split("?")[0]
        handlers = {
            "/v1/completions": self._handle_text_completion,
            "/v1/chat/completions": self._handle_chat_completion,
        }
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if not 0 <= length <= self.MAX_BODY:
            self.close_connection = True  # can't safely drain; don't reuse
            return self._error(413, "invalid or oversized request body")
        try:
            # always drain before any reply, or keep-alive desyncs
            raw = self.rfile.read(length)
        except OSError:
            return self._error(400, "unreadable request body")
        if route not in handlers:
            return self._error(404, f"unknown route {route}")
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return self._error(400, "invalid JSON body")
        try:
            params = self._validate_params(body)
            generator, tokenizer = self.provider.load(body.get("model", "default_model"))
        except ValueError as e:
            return self._error(400, str(e))
        try:
            handlers[route](body, params, generator, tokenizer)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away
        except RequestTimeoutError as e:
            self._error(504, str(e))
        except ValueError as e:  # bad request discovered late (e.g. KV capacity)
            self._error(400, str(e))
        except Exception as e:  # a structured error, not a dropped connection
            logger.exception("request failed")
            self._error(500, f"{type(e).__name__}: {e}")

    # ---------------------------------------------------------- validation
    def _validate_params(self, body: dict) -> dict:
        """Parameter extraction and validation, the JAX server's bounds."""
        p = {}
        p["stream"] = bool(body.get("stream", False))
        p["max_tokens"] = body.get("max_tokens", 100)
        if not isinstance(p["max_tokens"], int) or p["max_tokens"] < 0:
            raise ValueError("max_tokens must be a non-negative integer")
        p["temperature"] = body.get("temperature", 0.0)
        if not isinstance(p["temperature"], (int, float)) or p["temperature"] < 0:
            raise ValueError("temperature must be a non-negative float")
        p["top_p"] = body.get("top_p", 1.0)
        if not isinstance(p["top_p"], (int, float)) or not 0 < p["top_p"] <= 1:
            raise ValueError("top_p must be in (0, 1]")
        rp = body.get("repetition_penalty")
        if rp is not None and (not isinstance(rp, (int, float)) or rp <= 0):
            raise ValueError("repetition_penalty must be a positive float")
        p["repetition_penalty"] = rp
        rcs = body.get("repetition_context_size", 20)
        if not isinstance(rcs, int) or rcs < 1:
            raise ValueError("repetition_context_size must be a positive integer")
        p["repetition_context_size"] = rcs
        logprobs = body.get("logprobs", -1)
        if logprobs != -1 and not (0 < logprobs <= 10):
            raise ValueError("logprobs must be between 1 and 10")
        p["logprobs"] = logprobs
        bias = body.get("logit_bias")
        if bias is not None:
            if not isinstance(bias, dict):
                raise ValueError("logit_bias must be a token_id -> bias map")
            try:
                bias = {int(k): float(v) for k, v in bias.items()}
            except (ValueError, TypeError):
                raise ValueError("logit_bias keys must be token ids")
            if len(bias) > 512:
                raise ValueError("logit_bias supports at most 512 entries")
        p["logit_bias"] = bias
        stop = body.get("stop", [])
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
            raise ValueError("stop must be a string or list of strings")
        p["stop_words"] = stop
        p["seed"] = body.get("seed")
        for key in ("request_timeout", "ttft_timeout"):
            v = body.get(key)
            if v is not None and (
                isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0
            ):
                raise ValueError(f"{key} must be a positive number of seconds")
            p[key] = v
        return p

    # ------------------------------------------------------------- prompts
    def _chat_prompt(self, body: dict, tokenizer) -> list[int]:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        if getattr(tokenizer, "chat_template", None):
            return tokenizer.apply_chat_template(messages, tokenize=True,
                                                 add_generation_prompt=True)
        return tokenizer.encode(convert_chat(messages, body.get("role_mapping")))

    # ----------------------------------------------------------- responses
    @staticmethod
    def _response_id() -> str:
        return f"cmpl-{uuid.uuid4().hex[:24]}"

    def _make_response(self, *, rid, object_type, model, text=None, delta=None,
                       finish_reason=None, usage=None, logprobs=None) -> dict:
        choice = {"index": 0, "finish_reason": finish_reason, "logprobs": logprobs}
        if object_type.startswith("chat"):
            if delta is not None:
                choice["delta"] = delta
            else:
                choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text if text is not None else ""
        resp = {
            "id": rid,
            "object": object_type,
            "created": int(time.time()),
            "model": model,
            "system_fingerprint": f"fp_{uuid.uuid4().hex[:10]}",
            "choices": [choice],
        }
        if usage:
            resp["usage"] = usage
        return resp

    # ----------------------------------------------------------- execution
    def _run(self, body, params, generator, tokenizer, prompt_ids, chat: bool):
        rid = self._response_id()
        model_name = body.get("model", "default_model")
        stop_id_sequences = [_encode_plain(tokenizer, s) for s in params["stop_words"]]
        eos = getattr(tokenizer, "eos_token_id", None)
        obj = "chat.completion" if chat else "text_completion"
        gen_kwargs = dict(
            temperature=params["temperature"],
            top_p=params["top_p"],
            repetition_penalty=params["repetition_penalty"],
            repetition_context_size=params["repetition_context_size"],
            logit_bias=params["logit_bias"],
            seed=params["seed"],
            max_tokens=params["max_tokens"],
        )
        if not params["stream"] and params["logprobs"] > 0:
            # streaming discards logprobs, so only this path computes them
            gen_kwargs["want_logprobs"] = True
        # the total-generation bound is checked between tokens; the ttft
        # bound needs a scheduler and is accepted but not enforced here
        timeout = params["request_timeout"]
        # a continuous batcher interleaves requests itself; a single-stream
        # generator is serialized by the lock
        lock = (contextlib.nullcontext() if getattr(generator, "concurrent", False)
                else self.gen_lock)
        with lock:
            if params["stream"]:
                self._stream(rid, obj + ".chunk", model_name, generator, tokenizer,
                             prompt_ids, stop_id_sequences, eos, chat, gen_kwargs, timeout)
            else:
                self._complete(rid, obj, model_name, generator, tokenizer, prompt_ids,
                               stop_id_sequences, eos, params["logprobs"], gen_kwargs, timeout)

    def _complete(self, rid, obj, model_name, generator, tokenizer, prompt_ids,
                  stop_id_sequences, eos, want_logprobs, gen_kwargs, timeout):
        tokens: list[int] = []
        token_logprobs: list[float] = []
        top_logprobs: list[dict] = []
        finish_reason = "length"
        t_start = time.perf_counter()
        t_first = None
        it = self._generate(generator, prompt_ids, gen_kwargs, timeout)
        try:
            for token, logprobs in it:
                if t_first is None:
                    t_first = time.perf_counter()
                if eos is not None and token == eos:
                    finish_reason = "stop"
                    break
                tokens.append(token)
                if want_logprobs > 0:
                    token_logprobs.append(logprobs.chosen)
                    top_logprobs.append({
                        int(i): float(v)
                        for i, v in zip(logprobs.top_indices[:want_logprobs],
                                        logprobs.top_values[:want_logprobs])
                    })
                stop = stopping_criteria(tokens, stop_id_sequences, None)
                if stop.stop_met:
                    if stop.trim_length:
                        tokens = tokens[: -stop.trim_length]
                        if want_logprobs > 0:
                            token_logprobs = token_logprobs[: -stop.trim_length]
                            top_logprobs = top_logprobs[: -stop.trim_length]
                    finish_reason = "stop"
                    break
        finally:
            it.close()
        self._record(len(prompt_ids), len(tokens), t_start, t_first)
        logprobs_payload = None
        if want_logprobs > 0:
            logprobs_payload = {
                "token_logprobs": token_logprobs,
                "top_logprobs": top_logprobs,
                "tokens": tokens,
            }
        usage = {
            "prompt_tokens": len(prompt_ids),
            "completion_tokens": len(tokens),
            "total_tokens": len(prompt_ids) + len(tokens),
        }
        self._json(200, self._make_response(
            rid=rid, object_type=obj, model=model_name, text=tokenizer.decode(tokens),
            finish_reason=finish_reason, usage=usage, logprobs=logprobs_payload,
        ))

    def _stream(self, rid, obj, model_name, generator, tokenizer, prompt_ids,
                stop_id_sequences, eos, chat, gen_kwargs, timeout):
        """SSE; text whose token tail could still grow into a stop sequence
        is held back."""
        t_start = time.perf_counter()
        it = self._generate(generator, prompt_ids, gen_kwargs, timeout)
        # prime the first token before committing to a 200, so a request
        # that fails at once gets a proper status code
        try:
            head = next(it)
        except StopIteration:
            head = None
        except BaseException:
            it.close()
            raise
        t_first = time.perf_counter() if head is not None else None

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # SSE has no Content-Length: the stream ends with the connection
        self.send_header("Connection", "close")
        self._cors()
        self.end_headers()

        def emit(payload: dict):
            self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
            self.wfile.flush()

        def chunk(text):
            return self._make_response(
                rid=rid, object_type=obj, model=model_name,
                **({"delta": {"content": text}} if chat else {"text": text}),
            )

        if chat:
            emit(self._make_response(rid=rid, object_type=obj, model=model_name,
                                     delta={"role": "assistant", "content": ""}))

        def token_stream():
            if head is not None:
                yield head
            yield from it

        detok = StreamingDetokenizer(tokenizer)
        tokens: list[int] = []
        in_flight: list[int] = []  # tokens withheld for a possible stop sequence
        finish_reason = "length"
        timed_out: Optional[RequestTimeoutError] = None
        try:
            for token, _ in token_stream():
                if eos is not None and token == eos:
                    finish_reason = "stop"
                    break
                tokens.append(token)
                if stopping_criteria(tokens, stop_id_sequences, None).stop_met:
                    finish_reason = "stop"
                    in_flight.clear()
                    break
                if any(sequence_overlap(tokens, s) for s in stop_id_sequences):
                    in_flight.append(token)
                    continue
                for t in in_flight:
                    detok.add_token(t)
                in_flight.clear()
                detok.add_token(token)
                if detok.last_segment:
                    emit(chunk(detok.last_segment))
        except RequestTimeoutError as e:
            # headers are gone: close the stream with an error event
            timed_out = e
            in_flight.clear()
        finally:
            it.close()
        self._record(len(prompt_ids), len(tokens), t_start, t_first)
        if timed_out is not None:
            emit({"error": {"message": str(timed_out), "type": "timeout_error", "code": 504}})
        else:
            # a length-finished run that was still buffering emits the
            # buffered tokens: they never completed a stop sequence
            for t in in_flight:
                detok.add_token(t)
            detok.finalize()
            if detok.last_segment:
                emit(chunk(detok.last_segment))
            emit(self._make_response(
                rid=rid, object_type=obj, model=model_name,
                **({"delta": {}} if chat else {"text": ""}),
                finish_reason=finish_reason,
            ))
        self.wfile.write(b"data: [DONE]\n\n")
        self.wfile.flush()
        self.close_connection = True

    def _generate(self, generator, prompt_ids, gen_kwargs, timeout=None):
        it = generator.generate_step(prompt_ids, **gen_kwargs)
        t0 = time.monotonic()
        try:
            for item in it:
                yield item
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise RequestTimeoutError(
                        f"generation exceeded request_timeout {timeout}s"
                    )
        finally:
            it.close()

    def _record(self, n_prompt, n_gen, t_start, t_first):
        end = time.perf_counter()
        ttft = (t_first - t_start) if t_first else 0.0
        decode_time = (end - t_first) if t_first else 0.0
        logger.info(
            "request: %d prompt tokens, %d generated, TTFT %.1f ms, decode %.1f tok/s",
            n_prompt, n_gen, ttft * 1e3,
            max(n_gen - 1, 0) / decode_time if decode_time > 0 else 0.0,
        )

    # ------------------------------------------------------------ handlers
    def _handle_chat_completion(self, body, params, generator, tokenizer):
        prompt_ids = self._chat_prompt(body, tokenizer)
        self._run(body, params, generator, tokenizer, list(prompt_ids), chat=True)

    def _handle_text_completion(self, body, params, generator, tokenizer):
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            return self._error(400, "prompt must be a non-empty string")
        self._run(body, params, generator, tokenizer, list(tokenizer.encode(prompt)), chat=False)


def make_server(provider: ModelProvider, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    handler = type(
        "BoundAPIHandler", (APIHandler,), {"provider": provider, "gen_lock": threading.Lock()}
    )
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="OpenAI-compatible API server (PyTorch port)")
    parser.add_argument("--model", required=True, help="local checkpoint directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-seq", type=int, default=4096)
    parser.add_argument("--prefill-chunk", type=int, default=256)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs without a card)")
    parser.add_argument("--keep-quantized", action="store_true",
                        help="keep 4-bit checkpoint weights packed in HBM "
                        "(fused dequant-matmul) instead of dequantizing on "
                        "load — 4x decode weight bandwidth")
    parser.add_argument("--concurrent", type=int, default=1,
                        help="continuous-batching slots: serve up to N requests "
                        "interleaved (N > 1 needs --paged-pool and replaces the "
                        "generation lock)")
    parser.add_argument("--paged-pool", type=int, default=None,
                        help="with --concurrent: share a KV pool of N pages across "
                        "slots (reservation admission)")
    parser.add_argument("--page-size", type=int, default=None,
                        help="KV page size in tokens (default: the prefill chunk); "
                        "must be a chunk multiple")
    parser.add_argument("--paged-attention", choices=("auto", "ragged"), default="auto",
                        help="with --paged-pool: decode attention over the page pool; "
                        "'ragged' attends in place through the slot page tables "
                        "(the contiguous 'gather' view is not yet ported)")
    parser.add_argument("--kv-dtype", choices=("bf16", "int8"), default=None,
                        help="with --paged-pool: KV-pool storage. 'int8' stores codes "
                        "plus a per-row-per-head float32 scale; default keeps the "
                        "model dtype")
    parser.add_argument("--admission-policy", choices=("fifo", "first_fit"), default="fifo",
                        help="with --paged-pool: waiting-line policy when a request "
                        "does not fit the pool: strict order, or let smaller "
                        "requests pass a blocked head")
    parser.add_argument("--overcommit", action="store_true",
                        help="with --paged-pool: admit on current page need (prompt + "
                        "one decode block) and grow per block, preempting the "
                        "newest-admitted request on pool exhaustion (token-exact "
                        "resume) — higher slot occupancy than reserving every "
                        "request's full prompt+max_tokens need")
    parser.add_argument("--async-sched", choices=("on", "off", "auto"), default="auto",
                        help="with --concurrent: async tick pipelining — dispatch decode "
                        "block t+1 before harvesting block t, overlapping host-side "
                        "emit/stop/admission work with device compute (token streams "
                        "stay bit-identical to sync). 'auto' (default) enables it: "
                        "the port has no draft engine and one host")
    args = parser.parse_args(argv)
    if args.concurrent > 1 and not args.paged_pool:
        parser.error("--concurrent N (N > 1) without --paged-pool (dense slots) is not yet "
                     "ported: pass --paged-pool")
    if args.paged_pool and args.concurrent <= 1:
        parser.error("--paged-pool requires --concurrent N (N > 1)")
    if args.page_size and not args.paged_pool:
        parser.error("--page-size requires --paged-pool")
    if args.paged_attention != "auto" and not args.paged_pool:
        parser.error("--paged-attention requires --paged-pool")
    if args.kv_dtype and not args.paged_pool:
        parser.error("--kv-dtype requires --paged-pool")
    if args.admission_policy != "fifo" and not args.paged_pool:
        parser.error("--admission-policy requires --paged-pool")
    if args.overcommit and not args.paged_pool:
        parser.error("--overcommit requires --paged-pool")
    if args.async_sched != "auto" and args.concurrent <= 1:
        parser.error("--async-sched requires --concurrent N (N > 1): only the continuous "
                     "batcher has a tick loop to pipeline")

    from mlx_sharding_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    logging.basicConfig(level=logging.INFO)
    provider = ModelProvider.from_checkpoint(
        args.model, device=device, max_seq=args.max_seq, prefill_chunk=args.prefill_chunk,
        keep_quantized=args.keep_quantized, concurrent=args.concurrent,
        paged_pool=args.paged_pool, page_size=args.page_size,
        paged_attention=args.paged_attention, kv_dtype=args.kv_dtype,
        admission_policy=args.admission_policy, overcommit=args.overcommit,
        async_sched=args.async_sched,
    )
    server = make_server(provider, args.host, args.port)
    logger.info("serving on http://%s:%d", args.host, args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
