"""repro_torch.kernels — hand-written Hopper kernels (``csrc/``), their
plain torch versions (``ref``), and the device-dispatched entry points
(``ops``).  Importing builds nothing; see ``build``."""
from repro_torch.kernels import ops, ref  # noqa: F401
