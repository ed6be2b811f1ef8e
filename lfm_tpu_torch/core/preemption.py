"""Preemption-signal handling (the port's copy of lfm_tpu/core/preemption.py).

A scheduler that reclaims the machine sends SIGTERM ahead of time; the
training loop then saves ``content.pth`` at the current epoch and returns,
so the next run resumes mid-training.

    with PreemptionGuard() as guard:
        for step in ...:
            ...
            if guard.preempted:
                save_content(...); return

The handler only sets a flag (async-signal-safe); the loop decides when to
act, so a checkpoint is never written from inside a handler.
"""

from __future__ import annotations

import signal
from typing import Iterable


class PreemptionGuard:
    """Installs handlers for the given signals; restores previous handlers
    on exit. ``preempted`` flips to True when any signal arrives."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous = {}
        self._preempted = False

    @property
    def preempted(self) -> bool:
        return self._preempted

    def _handler(self, signum, frame):
        self._preempted = True

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return False
