"""repro_torch.models — the dense and hybrid transformer families and
RWKV6 (torch port of ``repro.models``)."""
from repro_torch.models.model import QuantGroup, build_model  # noqa: F401
