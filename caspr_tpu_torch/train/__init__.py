"""Evaluation steps, the epoch runner and the stat trackers (counterpart of
caspr_tpu/train; the training branch waits for the training slice)."""

from .loop import compute_losses, make_eval_step, run_one_epoch
from .trackers import TestStatTracker, log, print_stats

__all__ = ["TestStatTracker", "compute_losses", "log", "make_eval_step", "print_stats",
           "run_one_epoch"]
