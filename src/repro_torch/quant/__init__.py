"""repro_torch.quant — WRPN quantizer, bitplane packing and the ReLeQ
per-layer bit policy (torch port of ``repro.quant``)."""
from repro_torch.quant.pack import (  # noqa: F401
    QDQ,
    Packed,
    dequant_packed,
    pack_bitplanes,
    pack_weight,
    unpack_bitplanes,
)
from repro_torch.quant.policy import BITWIDTH_CHOICES, QuantPolicy  # noqa: F401
from repro_torch.quant.wrpn import (  # noqa: F401
    FP_BITS,
    dequantize_from_int,
    fake_quant,
    quantize_to_int,
    tensor_scale,
)
