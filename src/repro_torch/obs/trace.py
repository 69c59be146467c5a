"""Span tracer: bounded ring buffer -> Chrome-trace / Perfetto JSON.

Usage::

    tr = Tracer(enabled=True)
    with tr.span("decode.step", step=i) as sp:
        ...
        sp.set(tokens=n)            # args may be added before close
    tr.instant("preempt", request=rid)
    tr.complete("queue.wait", start=req.arrival_time, dur=wait_s)
    tr.save("out.json")             # chrome://tracing / ui.perfetto.dev

Design constraints (the serve loop calls this per decode step):

- **near-zero cost when disabled**: ``span()`` returns one shared
  no-op context manager (no allocation), ``instant``/``complete``
  return immediately — the only per-call cost is an attribute check.
  The serve bench gates tracing-enabled throughput at <= 3% of
  disabled.
- **bounded**: events live in a ``deque(maxlen=capacity)`` — a
  long-lived engine can trace forever and keep the newest ``capacity``
  events; ``dropped`` counts what the ring discarded.
- **balanced by construction**: spans are recorded as Chrome *complete*
  events (``ph: "X"`` with ``ts`` + ``dur``) emitted at ``__exit__``,
  which runs on exceptions too — preemption, spec-window rejection, and
  admission failure can never leave a dangling open span (property the
  tests pin).  ``depth()`` exposes the live per-thread nesting for
  those tests.
- **thread-aware**: events carry the recording thread (evaluator-pool
  workers show up as their own Perfetto tracks); ``deque.append`` is
  atomic under the GIL, so recording never takes a lock.

Timestamps are ``time.perf_counter()`` microseconds relative to the
tracer's construction, matching the engine's latency clocks.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque


class _NullSpan:
    """Shared do-nothing span for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_tid")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        tr = self._tracer
        self._tid = threading.get_ident()
        tr._depth[self._tid] = tr._depth.get(self._tid, 0) + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        tr = self._tracer
        tr._depth[self._tid] -= 1
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        tr._push(self.name, "X", self._t0, t1 - self._t0, self._tid,
                 self.args)
        return False

    def set(self, **args) -> None:
        """Attach/overwrite args before the span closes."""
        self.args.update(args)


class Tracer:
    """Bounded ring-buffer tracer with Chrome-trace export."""

    def __init__(self, capacity: int = 1 << 16, enabled: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.enabled = bool(enabled)
        self._epoch = time.perf_counter()
        self._events: deque = deque(maxlen=capacity)
        self._pushed = 0
        self._depth: dict[int, int] = {}     # thread id -> open spans
        self._tid_names: dict[int, str] = {}

    # ------------------------------------------------------------- control
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def name_thread(self, name: str) -> None:
        """Label the calling thread's track in the exported trace."""
        self._tid_names[threading.get_ident()] = str(name)

    # ------------------------------------------------------------ recording
    def _push(self, name, ph, t0, dur, tid, args) -> None:
        # (name, ph, ts_s, dur_s, tid, args) — converted at export time
        self._events.append((name, ph, t0 - self._epoch, dur, tid, args))
        self._pushed += 1

    def span(self, name: str, **args):
        """Context manager timing one operation.  Nested spans render as
        Perfetto stack frames on the recording thread's track."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        self._push(name, "i", time.perf_counter(), 0.0,
                   threading.get_ident(), args)

    def complete(self, name: str, start: float, dur: float, **args) -> None:
        """Retro-dated span from explicit ``perf_counter`` seconds — e.g.
        queue wait recorded at admission, dated back to arrival."""
        if not self.enabled:
            return
        self._push(name, "X", start, max(dur, 0.0),
                   threading.get_ident(), args)

    # ----------------------------------------------------------- inspection
    @property
    def num_events(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events discarded by the ring (recorded - retained)."""
        return self._pushed - len(self._events)

    def depth(self, thread_id: int | None = None) -> int:
        """Open (entered, not yet exited) spans on one thread."""
        tid = thread_id if thread_id is not None else threading.get_ident()
        return self._depth.get(tid, 0)

    def events(self, name: str | None = None) -> list[dict]:
        """Raw events (newest-last), optionally filtered by name."""
        out = []
        for ev_name, ph, ts, dur, tid, args in list(self._events):
            if name is not None and ev_name != name:
                continue
            out.append({"name": ev_name, "ph": ph, "ts_s": ts,
                        "dur_s": dur, "tid": tid, "args": dict(args)})
        return out

    def clear(self) -> None:
        self._events.clear()
        self._pushed = 0

    # --------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome-trace JSON object (the format Perfetto's UI ingests):
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with
        microsecond ``ts``/``dur``, ``ph: "X"`` complete spans and
        ``ph: "i"`` thread-scoped instants, plus thread-name metadata
        for every labeled track."""
        events = []
        tids = set()
        for name, ph, ts, dur, tid, args in list(self._events):
            tids.add(tid)
            ev = {
                "name": name,
                "ph": ph,
                "ts": round(ts * 1e6, 3),
                "pid": 1,
                "tid": tid,
                "args": {k: _jsonable(v) for k, v in args.items()},
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["s"] = "t"  # instant scope: thread
            events.append(ev)
        for tid in sorted(tids):
            label = self._tid_names.get(tid)
            if label:
                events.append({
                    "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                    "args": {"name": label},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def _jsonable(v):
    """Coerce numpy scalars etc. into JSON-safe values."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if hasattr(v, "item"):
        return v.item()
    return str(v)


# shared disabled tracer: the default for every instrumented component,
# so hot paths guard on one attribute instead of a None check
NULL_TRACER = Tracer(capacity=1, enabled=False)
