"""Named locks: the port's stand-in for the JAX package's
``analysis.runtime.make_lock`` (whose lock-order and lockset recorders are
not ported). The name documents which lock a site takes; the lock is a
plain ``threading.Lock``. ``note_acquire`` / ``note_release`` mark where
the JAX package records a resource in its ledger; here they do nothing."""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A plain lock; ``name`` (``"Class.attribute"``) marks the site."""
    del name
    return threading.Lock()


def note_acquire(kind: str, key, **info) -> None:
    """A resource taken (the JAX ledger's note; nothing is recorded)."""
    del kind, key, info


def note_release(kind: str, key) -> None:
    """A resource given back (the JAX ledger's note; nothing is recorded)."""
    del kind, key
