"""repro_torch.dist -- the distribution layer on ``torch.distributed``:
specs, collectives, elasticity (torch port of ``repro.dist``).

- ``sharding.py``    partition specs for every leaf of every arch --
  params, optimizer state, batches, decode caches -- profile-aware
  (tp / tp_sp / fsdp) and divisibility-guarded, computed from mesh sizes
  alone; ``to_placements`` turns them into DTensor placements over a
  ``DeviceMesh``.
- ``collectives.py`` ``compressed_allreduce``: a gradient all-reduce whose
  wire format is fp8 planes (uint8 on the wire) with error feedback.
- ``elastic.py``     restore a checkpoint written under any rank count onto
  the current mesh (``place``, ``restore_elastic``).
- ``tp.py``          tensor- and expert-parallel execution: Megatron's two
  operators on ``all_reduce``, each leaf's compute shard, the
  vocab-parallel embed and cross-entropy, the gradients' reductions.

Consumers: ``train.train_step.make_dp_train_step`` / ``init_dp_state`` /
``make_tp_train_step``, the models (``dist.tp.current``),
``train.trainer.Trainer(mesh=)`` and ``launch/train.py --mesh``.
"""
from repro_torch.dist.collectives import compressed_allreduce, compressed_allreduce_tree
from repro_torch.dist.elastic import restore_elastic
from repro_torch.dist.sharding import (
    batch_specs,
    cache_specs,
    param_specs,
    state_specs,
    to_placements,
)

__all__ = [
    "batch_specs",
    "cache_specs",
    "compressed_allreduce",
    "compressed_allreduce_tree",
    "param_specs",
    "restore_elastic",
    "state_specs",
    "to_placements",
]
