from .core import conv1x1, count_params, group_norm, linear

__all__ = ["conv1x1", "count_params", "group_norm", "linear"]
