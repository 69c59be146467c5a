"""repro_torch.optim — AdamW with fp32 moments (torch port of
``repro.optim``; the int8 moments are not ported)."""
from repro_torch.optim.adamw import AdamW  # noqa: F401
