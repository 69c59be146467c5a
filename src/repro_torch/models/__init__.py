"""repro_torch.models — the transformer families (dense, moe, vlm, audio,
hybrid) and RWKV6 (torch port of ``repro.models``)."""
from repro_torch.models.model import QuantGroup, build_model  # noqa: F401
