"""repro_torch.obs: zero-dependency observability for the search->serve pipeline.

Three small, composable layers (stdlib + numpy only):

- :mod:`repro_torch.obs.core` — a thread-safe :class:`Registry` of typed
  instruments (:class:`Counter`, :class:`Gauge`, :class:`Histogram` with
  fixed buckets + optional exact sliding window for p50/p99) whose
  ``snapshot()`` is one JSON-safe dict, plus :func:`run_provenance`
  (git sha / timestamp / torch and CUDA versions / device name) for benchmark
  records;
- :mod:`repro_torch.obs.trace` — a bounded ring-buffer span :class:`Tracer`
  (``span()`` context manager, ``instant()`` events, ``complete()`` for
  retro-dated durations) that is near-zero cost when disabled and
  exports Chrome-trace / Perfetto JSON;
- :mod:`repro_torch.obs.log` — rate-limited structured logging
  (:func:`get_logger`, ``--log-json`` on the launchers switches every
  logger to one-JSON-object-per-line via :func:`configure`).

The serving engine (``serve/engine.py``), scheduler, paged pool, and the
autotune service all take ``registry=`` / ``tracer=`` and default to
private, disabled instances — instrumentation costs nothing unless a
caller opts in (gated at <= 3% tokens/s in ``benchmarks/serve_bench.py``).
See ``docs/metrics.md`` for the full metric / trace-event reference.
"""
from repro_torch.obs.core import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    run_provenance,
)
from repro_torch.obs.log import StructuredLogger, configure, get_logger
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "run_provenance",
    "Tracer",
    "NULL_TRACER",
    "StructuredLogger",
    "configure",
    "get_logger",
]
