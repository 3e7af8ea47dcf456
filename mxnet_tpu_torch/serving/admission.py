"""Bounded admission queue with priority-aware load shedding.

The queue is the backpressure point of the serving runtime: it holds at
most ``depth`` requests, ever.  When a request arrives at a full queue
the cheapest victim — lowest priority, then oldest — is compared against
the newcomer:

* newcomer priority > victim priority: the victim is EVICTED (failed
  with :class:`Overloaded`) and the newcomer admitted;
* otherwise the newcomer itself is rejected with :class:`Overloaded`.

Either way exactly one request pays, immediately and with a typed error
— the alternative (unbounded queueing) converts overload into latency
for *every* caller and eventually into OOM.  Expired requests are
dropped at pop time, before any device dispatch.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from .errors import DeadlineExceeded, Overloaded
from .request import Request

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """Bounded FIFO with priority shedding (see module docstring)."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("queue depth must be >= 1, got %d" % depth)
        self.depth = int(depth)
        self._items: List[Request] = []
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self.shed_overload = 0        # rejected or evicted at admission
        self.shed_expired = 0         # expired in queue, dropped pre-dispatch

    def __len__(self):
        with self._lock:
            return len(self._items)

    def offer(self, req: Request):
        """Admit ``req`` or shed — never blocks, never grows past depth."""
        from .. import telemetry
        victim = None
        with self._lock:
            if len(self._items) >= self.depth:
                victim = min(self._items,
                             key=lambda r: (r.priority, r.enqueued_at))
                if req.priority <= victim.priority:
                    self.shed_overload += 1
                    telemetry.count("serve.shed", cause="overload")
                    raise Overloaded(
                        "queue full (depth %d) and request priority %d "
                        "does not beat the cheapest queued priority %d"
                        % (self.depth, req.priority, victim.priority))
                self._items.remove(victim)
                self.shed_overload += 1
                telemetry.count("serve.shed", cause="evicted")
            self._items.append(req)
            self._nonempty.notify()
        if victim is not None:
            victim._fail(Overloaded(
                "evicted from a full queue (depth %d) by a priority-%d "
                "arrival" % (self.depth, req.priority)))

    def pop_live(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Oldest non-expired request, or None after ``timeout``.
        Expired requests are failed with :class:`DeadlineExceeded` here —
        before device dispatch — and never returned."""
        from .. import telemetry
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                while self._items:
                    req = self._items.pop(0)
                    if req.done:
                        # completed while queued (a fleet hedge raced it
                        # and won, or the router cancelled the dispatch):
                        # drop silently — its outcome is already settled
                        continue
                    if not req.expired():
                        req.t_popped = time.monotonic()
                        return req
                    self.shed_expired += 1
                    telemetry.count("serve.shed", cause="expired")
                    req._fail(DeadlineExceeded(
                        "deadline passed while queued; dropped before "
                        "dispatch"))
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                if not self._nonempty.wait(remaining):
                    return None

    def push_front(self, req: Request):
        """Return a popped request to the head of the queue (it did not
        fit the closing batch); its FIFO position is preserved."""
        with self._lock:
            self._items.insert(0, req)
            self._nonempty.notify()

    def drain(self) -> List[Request]:
        """Remove and return everything queued (shutdown path)."""
        with self._lock:
            items, self._items = self._items, []
            return items
