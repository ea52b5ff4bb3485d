from .core import conv1x1, group_norm, linear

__all__ = ["conv1x1", "group_norm", "linear"]
