from .caspr import CaSPRConfig, CaSPRModel, caspr_param_shapes

__all__ = ["CaSPRConfig", "CaSPRModel", "caspr_param_shapes"]
