"""Copied from ``mlx_sharding_tpu/resilience.py``: the serving-resilience
error types and the deadline bookkeeping, standard library only.

- :class:`RequestTimeoutError`: a per-request deadline (TTFT, total
  generation, or the inter-token stall watchdog) expired; HTTP 504.
- :class:`QueueFullError`: admission control rejected the request because
  the submit queue is at ``--max-queue``; HTTP 429 + ``Retry-After``.
- :class:`ReplicasUnavailableError`: every replica is circuit-broken;
  HTTP 503. :class:`ReplicaDrainingError`: a draining replica refuses new
  work (a ``QueueFullError``, so the dispatcher retries elsewhere).
- :class:`ResumeState`, :class:`RequestMigratedError`: a stream ended on one
  replica so that it continues on another (drain), with what the target
  needs to resume it exactly; :class:`HandoffReadyError`: a prefill-only
  stream's handoff (``disagg.DisaggCoordinator`` catches it).

Deadline semantics (enforced by ``ContinuousBatcher``):

- ``ttft_timeout`` bounds submit -> first token (queue wait + prefill).
  Requests still *queued* past this budget are shed by the scheduler
  before any prefill work is spent on them.
- ``request_timeout`` bounds submit -> last token (total generation).
- ``stall_timeout`` is the inter-token watchdog: the longest the consumer
  will wait between consecutive token deliveries once the stream has
  started. It defaults to ``ttft_timeout`` when unset.

Expiry cancels the request through the ``cancelled`` path, so the
scheduler reclaims its slot and KV pages on its next tick; the waiting
thread is released at once with the structured error.

``ResumeState.resume_keys`` carries the source slot's sampler state: in the
JAX package its PRNG key row, here its ``torch.Generator`` state (the
batcher's ``resume_gen``), with the repetition window in ``resume_recent``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional


class RequestTimeoutError(RuntimeError):
    """A per-request deadline expired. ``kind`` says which budget:

    - ``"ttft"``   — no first token within ``ttft_timeout`` of submission
    - ``"total"``  — generation exceeded ``request_timeout``
    - ``"stall"``  — the inter-token watchdog tripped mid-stream
    - ``"queue"``  — shed by the scheduler while still queued: its wait
      already exceeded the TTFT budget, so prefill would be wasted work
    """

    def __init__(self, kind: str, elapsed_s: float, budget_s: float):
        self.kind = kind
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s
        super().__init__(
            f"request deadline expired ({kind}): {elapsed_s:.2f}s elapsed "
            f"against a {budget_s:.2f}s budget"
        )


class QueueFullError(RuntimeError):
    """Admission control rejected the request: the submit queue is at its
    ``--max-queue`` bound. Maps to HTTP 429 with ``Retry-After``."""

    def __init__(self, depth: int, max_queue: int, retry_after_s: float = 1.0):
        self.depth = depth
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s
        super().__init__(
            f"server overloaded: {depth} requests already queued "
            f"(--max-queue {max_queue}); retry after {retry_after_s:.0f}s"
        )


class ReplicasUnavailableError(RuntimeError):
    """Every replica is circuit-broken (or excluded by failed retries) —
    there is nowhere to route the request. Maps to HTTP 503; when the
    dispatcher knows the earliest half-open retry ETA (the soonest any
    breaker re-admits a probe), ``retry_after_s`` carries it so the server
    can emit ``Retry-After`` instead of leaving the client to guess."""

    def __init__(self, message: str = "no replica available",
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ReplicaDrainingError(QueueFullError):
    """The replica is draining (``ReplicaSet.drain`` / ``migrate_out``) and
    rejects new work. Subtype of :class:`QueueFullError` so the dispatcher's
    saturation handling applies unchanged: retry on another replica, no
    breaker strike, 429 + ``Retry-After`` if nothing else is available."""

    def __init__(self, retry_after_s: float = 1.0):
        self.depth = 0
        self.max_queue = 0
        self.retry_after_s = retry_after_s
        RuntimeError.__init__(
            self, "replica is draining and not accepting new requests"
        )


@dataclass
class ResumeState:
    """Everything needed to continue a partially-generated request on a
    different engine, captured when its stream is migrated off a replica.

    ``prompt`` and the sampler fields hold what the producing batcher
    recorded (the prompt as numpy, the generator state and the window as
    CPU tensors); ``block`` is an optional host-materialized
    ``kv_transfer.KVPageBlock`` whose pages the target can import instead of
    re-prefilling. When ``block`` is ``None`` the target folds ``history``
    back into the prompt and re-prefills — slower, but token-exact
    (``resume_keys`` / ``resume_recent`` carry the sampler state and the
    repetition window across the fold when the source captured them)."""

    prompt: object                 # original prompt token ids (pre-fold)
    history: list                  # tokens emitted since the last fold
    produced: int = 0              # tokens already delivered to the client
    block: object = None           # optional KVPageBlock (host-resident)
    resume_keys: object = None     # the slot's torch.Generator state
    resume_recent: object = None   # repetition-penalty recent-token window


class RequestMigratedError(RuntimeError):
    """A replica ended this stream mid-flight so it can resume elsewhere
    (graceful drain). Carries the :class:`ResumeState`; the dispatcher
    re-places it and the client never observes the hop."""

    def __init__(self, state: ResumeState, reason: str = "replica draining"):
        self.state = state
        super().__init__(f"request migrated: {reason}")


class HandoffReadyError(RuntimeError):
    """A prefill-only stream completed its phase: the first token was
    delivered and the request's :class:`ResumeState` (KV page block +
    sampler rows) is ready to move to a decode replica. NOT a failure —
    the disaggregation coordinator catches it to run the handoff, and the
    dispatcher treats it as a successful prefill-replica exit (no breaker
    strike, no in-pool re-placement)."""

    def __init__(self, state: ResumeState):
        self.state = state
        super().__init__("prefill complete: ready for decode handoff")


@dataclass
class Deadlines:
    """Absolute-monotonic per-request deadlines, computed once at submit.

    ``None`` fields mean "unbounded", the default when no flags or
    overrides are set."""

    submitted_at: float
    ttft_deadline: Optional[float] = None   # absolute: submit + ttft_timeout
    total_deadline: Optional[float] = None  # absolute: submit + request_timeout
    stall_timeout: Optional[float] = None   # relative: per-token watchdog

    @classmethod
    def start(
        cls,
        *,
        ttft_timeout: Optional[float] = None,
        request_timeout: Optional[float] = None,
        stall_timeout: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> "Deadlines":
        for name, v in (
            ("ttft_timeout", ttft_timeout),
            ("request_timeout", request_timeout),
            ("stall_timeout", stall_timeout),
        ):
            if v is not None and (
                isinstance(v, bool)  # bool is an int; a JSON `true` is not
                or not isinstance(v, (int, float))
                or v <= 0
            ):
                raise ValueError(f"{name} must be a positive number of seconds")
        # the absolute stamps come from the clock the consumer compares
        # them against (the batcher's)
        now = time.monotonic() if clock is None else clock()
        if stall_timeout is None:
            stall_timeout = ttft_timeout  # see module docstring
        return cls(
            submitted_at=now,
            ttft_deadline=None if ttft_timeout is None else now + ttft_timeout,
            total_deadline=(
                None if request_timeout is None else now + request_timeout
            ),
            stall_timeout=stall_timeout,
        )
