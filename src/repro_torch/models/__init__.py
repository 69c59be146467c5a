"""repro_torch.models — the dense transformer family (torch port of
``repro.models``)."""
from repro_torch.models.model import QuantGroup, build_model  # noqa: F401
