"""repro_torch.serve — continuous batching over a paged KV cache for
ReLeQ-quantized models (torch port of ``repro.serve``).

- ``request.py``, ``queue.py``, ``scheduler.py``: copies of the
  reference's numpy-only modules (requests, host token selection from
  per-request ``SeedSequence`` streams, FIFO admission, block-aware
  continuous scheduling with preempt-and-requeue).
- ``cache.py``: ``PagedCachePool`` with fp blocks.
- ``engine.py``: ``ServeEngine`` — chunked prefill and the one-token
  decode step, host sampling.

Use::

    from repro_torch.serve import ServeEngine
    engine = ServeEngine.from_params(model, params, policy, num_slots=4,
                                     max_len=256, device="cuda")
    rid = engine.submit(prompt_ids, max_new_tokens=32)
    engine.run_until_drained()
    tokens, stats = engine.output(rid), engine.metrics()
"""
from repro_torch.serve.cache import PagedCachePool
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.queue import AdmissionQueue
from repro_torch.serve.request import Request, RequestState, SamplingParams
from repro_torch.serve.scheduler import ContinuousScheduler

__all__ = [
    "AdmissionQueue", "ContinuousScheduler", "PagedCachePool", "Request",
    "RequestState", "SamplingParams", "ServeEngine",
]
