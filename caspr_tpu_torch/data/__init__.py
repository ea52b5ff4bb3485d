"""The dataset of point-cloud sequences, its loader and a synthetic tree in
its format (counterpart of caspr_tpu/data)."""

from .dataset import (
    BAD_MODELS,
    DynamicPCLDataset,
    SequenceLoader,
    load_seq_path,
    load_time_data,
    parse_dataset_cfg,
)
from .synthetic import write_synthetic_tree

__all__ = ["BAD_MODELS", "DynamicPCLDataset", "SequenceLoader", "load_seq_path",
           "load_time_data", "parse_dataset_cfg", "write_synthetic_tree"]
