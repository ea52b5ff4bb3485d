"""Reference PyTorch checkpoints (.pth) as the port's parameter trees
(counterpart of caspr_tpu/compat)."""

from .torch_convert import convert_torch_checkpoint, convert_torch_state_dict

__all__ = ["convert_torch_checkpoint", "convert_torch_state_dict"]
