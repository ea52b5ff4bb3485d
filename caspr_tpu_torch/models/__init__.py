from .caspr import CaSPRConfig, CaSPRModel, caspr_init, caspr_param_shapes

__all__ = ["CaSPRConfig", "CaSPRModel", "caspr_init", "caspr_param_shapes"]
