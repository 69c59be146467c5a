"""The paper's CNN benchmark family of Table 2 (torch port of
``repro.cnn``): synthetic-but-learnable datasets with the original input
geometry, the seven networks (ResNet-20, LeNet, SimpleNet and SVHN-10 at
full structure; AlexNet, VGG-11 and MobileNet at the reference's reduced
widths), and the QAT task that serves as the ReLeQ environment's
accuracy oracle.  Quantization is per-tensor WRPN through the fake-quant
kernel."""
from repro_torch.cnn.data import make_dataset  # noqa: F401
from repro_torch.cnn.models import CNN_ZOO, build_cnn  # noqa: F401
from repro_torch.cnn.train import CNNTask  # noqa: F401
