"""The ImageNet ResNet training script (synthetic data)."""
