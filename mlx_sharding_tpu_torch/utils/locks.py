"""Named locks: the port's stand-in for the JAX package's
``analysis.runtime.make_lock`` (whose lock-order and lockset recorders are
not ported). The name documents which lock a site takes; the lock is a
plain ``threading.Lock``."""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A plain lock; ``name`` (``"Class.attribute"``) marks the site."""
    del name
    return threading.Lock()
