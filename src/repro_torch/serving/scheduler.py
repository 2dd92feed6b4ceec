"""Continuous-batching admission scheduler.

FIFO by (arrival tick, submission order).  The scheduler owns only the
waiting queue — slot occupancy lives in the engine.  Arrival times are in
engine ticks (one decode step = one tick), which keeps traces
deterministic and replayable; wall-clock readiness is stamped the first
time the engine observes a request as eligible, so latency metrics
include queueing-for-capacity but not simulated future arrivals.

Deadline-aware admission: a queued request whose TTFT budget is already
blown (it could not emit a first token in time even if admitted *right
now*) is surfaced through `pop_expired` so the engine can shed it
instead of wasting prefill compute on a reply that is late by
construction.
"""

from __future__ import annotations

import heapq

from repro_torch.serving.types import Request


class Scheduler:
    def __init__(self):
        self._heap: list[tuple[float, int, Request]] = []
        self._order = 0
        self._ready_wall: dict[str, float] = {}

    def submit(self, request: Request) -> int:
        """Queue a request; returns its submission index."""
        idx = self._order
        heapq.heappush(self._heap, (float(request.arrival), idx, request))
        self._order += 1
        return idx

    def restore(self, request: Request, ready_wall: float | None = None
                ) -> None:
        """Put a popped request back at its original queue position —
        the exception-safety path for a crash mid-admission (the request
        must stay drainable, never lost with the dying engine)."""
        self.submit(request)
        if ready_wall is not None:
            self._ready_wall.setdefault(request.request_id, ready_wall)

    def note_ready(self, now: float, wall: float) -> None:
        """Stamp wall-clock readiness for requests whose arrival has
        passed (first observation wins)."""
        for arrival, _, req in self._heap:
            if arrival <= now and req.request_id not in self._ready_wall:
                self._ready_wall[req.request_id] = wall

    def ready_wall(self, request_id: str) -> float:
        return self._ready_wall.pop(request_id)

    @staticmethod
    def _admit_deadline(req: Request) -> float | None:
        """Latest tick at which admitting `req` can still meet its
        budgets: first token at tick t means TTFT = t - arrival + 1."""
        budgets = [b for b in (req.ttft_deadline_ticks, req.deadline_ticks)
                   if b is not None]
        if not budgets:
            return None
        return req.arrival + min(budgets) - 1.0

    def pop_expired(self, now: float) -> list[Request]:
        """Remove and return due requests whose deadline can no longer
        be met even if admitted this tick (FIFO order) — the engine
        sheds these."""
        expired, keep = [], []
        for item in self._heap:
            arrival, _, req = item
            latest = self._admit_deadline(req)
            if arrival <= now and latest is not None and now > latest:
                expired.append(item)
            else:
                keep.append(item)
        if expired:
            self._heap = keep
            heapq.heapify(self._heap)
        return [req for _, _, req in sorted(expired)]

    def pop_ready(self, now: float) -> Request | None:
        """Next request with arrival <= now, FIFO; None if none is due."""
        if self._heap and self._heap[0][0] <= now:
            return heapq.heappop(self._heap)[2]
        return None

    def peek_ready(self, now: float) -> Request | None:
        """Like `pop_ready` but non-destructive — the paged engine uses
        it to gate admission on page availability without reordering the
        FIFO (head-of-queue blocks until its pages fit)."""
        if self._heap and self._heap[0][0] <= now:
            return self._heap[0][2]
        return None

    def next_arrival(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def pending(self) -> list[Request]:
        """Waiting requests in admission (arrival, submission) order —
        read-only drain surface for fleet failover."""
        return [req for _, _, req in sorted(self._heap)]

    def __len__(self) -> int:
        return len(self._heap)
