"""Copied from ``mlx_sharding_tpu/resilience.py``: the serving-resilience
error types and the deadline bookkeeping, standard library only.

- :class:`RequestTimeoutError`: a per-request deadline (TTFT, total
  generation, or the inter-token stall watchdog) expired; HTTP 504.
- :class:`QueueFullError`: admission control rejected the request because
  the submit queue is at ``--max-queue``; HTTP 429 + ``Retry-After``.

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

The replica, drain and migration types of the source module come with the
fleet slice, which is their only user.
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
