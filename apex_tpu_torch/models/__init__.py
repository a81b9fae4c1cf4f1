"""Models of the port."""
from .resnet import (ARCHS, Bottleneck, ResNet, ResNet50, ResNet101,
                     ResNet152, resnet_state_from_numpy, resnet_tiny)

__all__ = ["ARCHS", "Bottleneck", "ResNet", "ResNet50", "ResNet101",
           "ResNet152", "resnet_tiny", "resnet_state_from_numpy"]
