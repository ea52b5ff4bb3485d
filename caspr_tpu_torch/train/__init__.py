"""The optimizer, the train and evaluation steps, the epoch runner, the
trackers and checkpoints (counterpart of caspr_tpu/train)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .loop import compute_losses, make_eval_step, make_optimizer, make_train_step, run_one_epoch
from .trackers import TestStatTracker, TrainLossTracker, log, print_stats

__all__ = ["TestStatTracker", "TrainLossTracker", "compute_losses", "load_checkpoint", "log",
           "make_eval_step", "make_optimizer", "make_train_step", "print_stats", "run_one_epoch",
           "save_checkpoint"]
