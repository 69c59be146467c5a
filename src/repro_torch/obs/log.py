"""Structured, rate-limited logging for long-running services.

Replaces the ad-hoc ``print`` progress lines in the autotune service and
the lockstep search with loggers that

- emit one *event* with typed fields (``log.event("episode", reward=r,
  acc=a)``) instead of a pre-formatted string,
- render either human text (default) or one JSON object per line
  (``configure(json_mode=True)`` — the launchers' ``--log-json`` flag),
- rate-limit per event name (``min_interval_s``): a tight serve loop can
  call ``event()`` every step and the sink sees at most one line per
  interval, with a ``suppressed`` count carried on the next emitted line
  so nothing disappears silently.

Zero-dependency by design: the sink is a writable stream (stdout), not a
logging framework — services stay importable anywhere the repo runs.
"""
from __future__ import annotations

import json
import sys
import threading
import time

_config_lock = threading.Lock()
_json_mode = False
_loggers: dict[str, "StructuredLogger"] = {}


def configure(json_mode: bool = False) -> None:
    """Process-wide output format: human text or JSON lines."""
    global _json_mode
    with _config_lock:
        _json_mode = bool(json_mode)


def json_mode() -> bool:
    with _config_lock:
        return _json_mode


def get_logger(name: str, *, min_interval_s: float = 0.0,
               stream=None) -> "StructuredLogger":
    """Process-shared logger per name (same-name call sites interleave
    into one rate-limit budget)."""
    with _config_lock:
        lg = _loggers.get(name)
        if lg is None:
            lg = _loggers[name] = StructuredLogger(
                name, min_interval_s=min_interval_s, stream=stream)
        return lg


class StructuredLogger:
    def __init__(self, name: str, *, min_interval_s: float = 0.0,
                 stream=None):
        self.name = name
        self.min_interval_s = float(min_interval_s)
        self.stream = stream
        self._lock = threading.Lock()
        self._last_emit: dict[str, float] = {}
        self._suppressed: dict[str, int] = {}
        self.emitted = 0

    def _out(self):
        return self.stream if self.stream is not None else sys.stdout

    def event(self, event: str, *, force: bool = False, **fields) -> bool:
        """Log one event.  Returns True iff a line was written (False =
        rate-limited; the drop is counted and reported on the next
        emitted line of the same event as ``suppressed=N``)."""
        now = time.monotonic()
        with self._lock:
            last = self._last_emit.get(event)
            if (not force and self.min_interval_s > 0 and last is not None
                    and now - last < self.min_interval_s):
                self._suppressed[event] = self._suppressed.get(event, 0) + 1
                return False
            self._last_emit[event] = now
            suppressed = self._suppressed.pop(event, 0)
            self.emitted += 1
        if suppressed:
            fields = {**fields, "suppressed": suppressed}
        if json_mode():
            rec = {"ts": round(time.time(), 3), "logger": self.name,
                   "event": event, **fields}
            line = json.dumps(rec, default=str)
        else:
            body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            line = f"[{self.name}] {event} {body}".rstrip()
        print(line, file=self._out(), flush=True)
        return True


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)
