"""Admission queue: FIFO of submitted-but-not-yet-scheduled requests.

Deliberately minimal — ordering policy (FIFO) is the only decision made
here; *when* to pop is the scheduler's call.  ``max_pending`` gives the
engine backpressure: ``submit`` on a full queue raises instead of letting
an open-ended producer grow host memory without bound.
"""
from __future__ import annotations

from collections import deque

from repro_torch.serve.request import Request


class AdmissionQueue:
    def __init__(self, max_pending: int = 0):
        """``max_pending = 0`` means unbounded."""
        self.max_pending = max_pending
        self._q: deque[Request] = deque()

    def push(self, request: Request) -> None:
        if self.max_pending and len(self._q) >= self.max_pending:
            raise RuntimeError(
                f"admission queue full ({self.max_pending} pending)")
        self._q.append(request)

    def push_front(self, request: Request) -> None:
        """Requeue at the head (preempted sequences re-admit first; no
        backpressure check — the request was already admitted once)."""
        self._q.appendleft(request)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
