"""Vision models (ResNet / WideResNet) over parameter dicts."""
