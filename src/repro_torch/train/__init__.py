"""repro_torch.train — the serving transform (torch port of the serving
half of ``repro.train``; the training loop waits for ROADMAP slice B)."""
from repro_torch.train.serve import quantize_for_serving  # noqa: F401
