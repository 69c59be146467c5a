"""repro_torch.train — the QAT train/eval steps, the fault-tolerant loop
and the serving transform (torch port of ``repro.train``)."""
from repro_torch.train.serve import quantize_for_serving  # noqa: F401
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: F401
