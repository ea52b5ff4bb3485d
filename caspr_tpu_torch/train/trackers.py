"""Logging and the evaluation stat tracker (the port's own copy of
caspr_tpu/train/trackers.py: numpy only; the training-curve tracker waits
for the training slice)."""

from __future__ import annotations

import numpy as np


def log(log_out, write_str):
    """Append to the run log and echo to stdout."""
    with open(log_out, "a") as f:
        f.write(str(write_str) + "\n")
    print(write_str)


def print_stats(log_out, epoch, cur_batch, num_batches, total_loss, cnf_err, tnocs_pos_err,
                tnocs_time_err, type_id="TRAIN", nfe=None):
    log(log_out, "[Epoch %d: Batch %d/%d] %s Mean loss: %f"
        % (epoch, cur_batch, num_batches, type_id, total_loss))
    log(log_out, "                    %s Mean CNF NLL: %f" % (type_id, cnf_err))
    log(log_out, "                    %s Mean TNOCS Pos (m): %f, Mean TNOCS time: %f"
        % (type_id, tnocs_pos_err, tnocs_time_err))
    if nfe is not None:
        log(log_out, "                    %s Mean NFE (latent-ode, decoder): (%f, %f)"
            % (type_id, nfe[0], nfe[1]))


class TestStatTracker:
    """Streaming mean accumulator of the evaluation statistics."""

    __test__ = False  # not a pytest class, whatever its name

    def __init__(self):
        self.loss_sum = 0.0
        self.total_loss_count = 0
        self.cnf_err_sum = 0.0
        self.cnf_err_count = 0
        self.tnocs_pos_err_sum = 0.0
        self.tnocs_pos_err_count = 0
        self.tnocs_time_err_sum = 0.0
        self.tnocs_time_err_count = 0
        self.nfe_sum = np.array([0.0, 0.0])

    def record_stats(self, loss_scalar, cnf_err, tnocs_pos_err, tnocs_time_err, nfe):
        self.loss_sum += loss_scalar
        self.total_loss_count += 1
        self.cnf_err_sum += np.sum(cnf_err)
        self.cnf_err_count += int(np.prod(cnf_err.shape))
        self.tnocs_pos_err_sum += np.sum(tnocs_pos_err)
        self.tnocs_pos_err_count += tnocs_pos_err.shape[0]
        self.tnocs_time_err_sum += np.sum(tnocs_time_err)
        self.tnocs_time_err_count += tnocs_time_err.shape[0]
        self.nfe_sum = self.nfe_sum + np.asarray(nfe)

    def get_mean_stats(self):
        """(loss, CNF NLL, T-NOCS position error, T-NOCS time error, NFE pair)."""
        return (
            self.loss_sum / max(1, self.total_loss_count),
            self.cnf_err_sum / max(1, self.cnf_err_count),
            self.tnocs_pos_err_sum / max(1, self.tnocs_pos_err_count),
            self.tnocs_time_err_sum / max(1, self.tnocs_time_err_count),
            self.nfe_sum / max(1, self.total_loss_count),
        )
