"""repro_torch.optim — AdamW with fp32 or 8-bit moments and its learning-rate
schedules (torch port of ``repro.optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamW,
    cosine_schedule,
    global_norm,
    linear_schedule,
)
