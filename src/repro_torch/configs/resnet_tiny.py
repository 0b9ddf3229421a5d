"""resnet-tiny: the MetaFed paper's own client model (4,696,394 parameters
on 32x32x3 inputs)."""
from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig(name="resnet-tiny", widths=(64, 128, 256), depths=(4, 4, 3),
                      in_channels=3, num_classes=10)