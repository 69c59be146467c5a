"""Metrics registry: typed, thread-safe instruments + JSON snapshots.

Three instrument kinds cover everything the pipeline reports:

- :class:`Counter` — monotone float/int accumulator (``inc``).  Tokens
  emitted, prefill launches, COW copies, recompiles, preemptions.
- :class:`Gauge` — last-write-wins level (``set``).  Queue depth,
  running rows, free blocks, archive size.
- :class:`Histogram` — fixed-boundary bucket counts plus, when
  ``window=N`` is given, an exact bounded sample window whose
  ``percentile()`` reproduces ``np.percentile`` over the last ``N``
  observations — the same ``metrics_window`` semantics the serve
  engine's latency deques always had, so rebuilding
  ``ServeEngine.metrics()`` on the registry is value-identical, not
  just key-compatible.

Every instrument carries its own lock (observations are a few
nanoseconds of lock + float add, far below the 3% tracing-overhead gate
in ``benchmarks/serve_bench.py``), and :meth:`Registry.snapshot` walks a
consistent copy of the instrument table so concurrent evaluator threads
never tear a read (property-tested in ``tests/test_obs.py``).

:func:`run_provenance` is the benchmark-record stamp: git sha,
UTC timestamp, torch and CUDA versions, device count and name —
what makes a ``BENCH_*.json`` perf number interpretable across PRs.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np

# log-spaced latency boundaries (seconds): 10us .. 10s covers a chunked
# prefill on a smoke model through a cold multi-second drive
DEFAULT_TIME_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


class _Instrument:
    """Shared name/unit/desc plumbing; one lock per instrument."""

    kind = "instrument"

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        self.name = name
        self.unit = unit
        self.desc = desc
        self._lock = threading.Lock()

    def _meta(self) -> dict:
        out: dict = {"type": self.kind}
        if self.unit:
            out["unit"] = self.unit
        if self.desc:
            out["desc"] = self.desc
        return out


class Counter(_Instrument):
    """Monotone accumulator.  ``inc`` rejects negative deltas — a counter
    that can go down is a :class:`Gauge` wearing the wrong type."""

    kind = "counter"

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        super().__init__(name, unit, desc)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {**self._meta(), "value": self.value}


class Gauge(_Instrument):
    """Last-write-wins level; ``add`` for +/- deltas on shared levels."""

    kind = "gauge"

    def __init__(self, name: str, unit: str = "", desc: str = ""):
        super().__init__(name, unit, desc)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {**self._meta(), "value": self.value}


class Histogram(_Instrument):
    """Fixed-boundary bucket counts + count/sum/min/max, and optionally
    an exact sample window.

    ``buckets`` are upper boundaries (``le``); an implicit +inf bucket
    catches the tail.  With ``window=N`` the last ``N`` raw samples are
    kept in a ring and :meth:`percentile` is exact over them
    (``np.percentile``); without a window, percentiles interpolate
    linearly inside the matching bucket — cheap and bounded-memory for
    unbounded streams.
    """

    kind = "histogram"

    def __init__(self, name: str, unit: str = "", desc: str = "",
                 buckets=DEFAULT_TIME_BUCKETS, window: int | None = None):
        super().__init__(name, unit, desc)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {self.name}: empty buckets")
        if window is not None and window < 1:
            raise ValueError(f"histogram {self.name}: window must be >= 1")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # + the +inf tail bucket
        self._count = 0
        self._sum = 0.0
        self._min = np.inf
        self._max = -np.inf
        self.window = window
        self._samples: deque | None = (deque(maxlen=window)
                                       if window is not None else None)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            self._counts[np.searchsorted(self.bounds, v, side="left")] += 1
            if self._samples is not None:
                self._samples.append(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def samples(self) -> list[float]:
        """The current window (empty list when windowless)."""
        with self._lock:
            return list(self._samples) if self._samples is not None else []

    def window_sum(self) -> float:
        with self._lock:
            return float(sum(self._samples)) if self._samples else 0.0

    def window_mean(self) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            return float(sum(self._samples) / len(self._samples))

    def percentile(self, q: float) -> float:
        """Exact over the sample window; bucket-interpolated otherwise."""
        with self._lock:
            if self._samples:
                return float(np.percentile(np.asarray(self._samples), q))
            if not self._count:
                return 0.0
            # cumulative walk to the q-th observation, linear inside the
            # bucket; the open tail bucket reports the observed max
            target = self._count * q / 100.0
            cum = 0
            for i, n in enumerate(self._counts):
                if cum + n >= target and n:
                    if i == len(self.bounds):
                        return float(self._max)
                    lo = self.bounds[i - 1] if i else min(self._min, self.bounds[i])
                    hi = self.bounds[i]
                    frac = (target - cum) / n
                    return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
                cum += n
            return float(self._max)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                **self._meta(),
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": {
                    **{str(b): c for b, c in zip(self.bounds, self._counts)},
                    "+inf": self._counts[-1],
                },
            }
            if self.window is not None:
                out["window"] = self.window
        if self._count:
            out["p50"] = self.percentile(50)
            out["p99"] = self.percentile(99)
        return out


class Registry:
    """Thread-safe name -> instrument table with get-or-create access.

    ``counter`` / ``gauge`` / ``histogram`` return the existing
    instrument when the name is taken (so independent call sites share
    one series) and raise on a *kind* collision — silently returning a
    Counter where a Histogram was requested would corrupt both series.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name!r} is a {inst.kind}, not a "
                    f"{cls.kind}")
            return inst

    def counter(self, name: str, unit: str = "", desc: str = "") -> Counter:
        return self._get_or_create(Counter, name, unit=unit, desc=desc)

    def gauge(self, name: str, unit: str = "", desc: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, unit=unit, desc=desc)

    def histogram(self, name: str, unit: str = "", desc: str = "",
                  buckets=DEFAULT_TIME_BUCKETS,
                  window: int | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, unit=unit, desc=desc,
                                   buckets=buckets, window=window)

    def get(self, name: str) -> _Instrument | None:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        """One JSON-safe dict of every instrument.  The instrument table
        is copied under the registry lock, then each instrument
        snapshots under its own lock — concurrent observers can keep
        writing and every individual value read is consistent."""
        with self._lock:
            table = dict(self._instruments)
        return {name: inst.snapshot() for name, inst in sorted(table.items())}


def run_provenance() -> dict:
    """Provenance stamp for benchmark records: everything needed to
    interpret a perf number months later.  Never raises — a missing git
    binary or a detached workdir yields ``None`` fields, not a dead
    benchmark."""
    import datetime
    import platform
    import subprocess

    import torch

    def _git(*args):
        try:
            out = subprocess.run(
                ("git",) + args, capture_output=True, text=True, timeout=5)
            return out.stdout.strip() or None if out.returncode == 0 else None
        except (OSError, subprocess.SubprocessError):
            return None

    cuda = torch.cuda.is_available()
    return {
        "git_sha": _git("rev-parse", "HEAD"),
        "git_dirty": bool(_git("status", "--porcelain")),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "python": platform.python_version(),
        "hostname": platform.node(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
    }
