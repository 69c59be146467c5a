"""ReLeQ core (torch port of ``repro.core``): the paper's contribution.

- env.py        layer-stepping quantization environment (copy)
- reward.py     asymmetric shaped reward + the two Fig 3 alternatives (copy)
- agent.py      shared-LSTM actor-critic (policy 128-128-|A|, value 128-64-1)
- ppo.py        PPO from scratch (clip 0.1, Adam 1e-4, GAE 0.99, 3 epochs)
- search.py     episode loop
- evalcache.py  thread-safe evaluate() memo (copy)
- costmodel.py  State-of-Quantization + Stripes / TVM-CPU models (copy)
- pareto.py     design-space enumeration + Pareto frontier (Fig 6; copy,
                ``as_archive`` waits for ``autotune``)
- admm_baseline.py  the ADMM bitwidth-selection baseline (Table 4)
"""
from repro_torch.core.env import STATE_DIM, QuantEnv  # noqa: F401
from repro_torch.core.evalcache import EvalCache  # noqa: F401
from repro_torch.core.ppo import PPO, PPOConfig  # noqa: F401
from repro_torch.core.search import ReLeQSearch, SearchResult, make_lm_env_factory  # noqa: F401
