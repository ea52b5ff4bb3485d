"""Logging and the loss and stat trackers (the port's own copy of
caspr_tpu/train/trackers.py)."""

from __future__ import annotations

import os

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


class TrainLossTracker:
    """Train and validation loss curves."""

    def __init__(self):
        self.train_losses = []
        self.train_steps = []
        self.cnf_losses = []
        self.tnocs_losses = []
        self.val_losses = []
        self.val_steps = []
        self._no_plot_said = False

    def record_train_step(self, train_loss, cnf_loss, tnocs_loss, step_idx):
        self.train_losses.append(train_loss)
        self.cnf_losses.append(cnf_loss)
        self.tnocs_losses.append(tnocs_loss)
        self.train_steps.append(step_idx)

    def record_val_step(self, val_loss, step_idx):
        self.val_losses.append(val_loss)
        self.val_steps.append(step_idx)

    def plot_cur_loss_curves(self, out_dir, log_out=None):
        """Write the curves' numbers to ``train_curve.npz`` and, where
        matplotlib imports, their plot to ``train_curve.png``; without
        matplotlib one line says so, the first time, in ``log_out`` (and on
        stdout)."""
        curves = {name: np.asarray(getattr(self, name), np.float64)
                  for name in ("train_steps", "train_losses", "cnf_losses", "tnocs_losses",
                               "val_steps", "val_losses")}
        np.savez(os.path.join(out_dir, "train_curve.npz"), **curves)
        try:
            import matplotlib
        except ImportError:
            if not self._no_plot_said:
                msg = ("matplotlib is not installed: train_curve.png not written "
                       "(the curves are in train_curve.npz)")
                if log_out:
                    log(log_out, msg)
                else:
                    print(msg)
                self._no_plot_said = True
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(12, 8))
        plt.plot(curves["train_steps"], curves["train_losses"], "-", label="train loss")
        plt.plot(curves["train_steps"], curves["cnf_losses"], "--", label="NLL loss")
        plt.plot(curves["train_steps"], curves["tnocs_losses"], "--", label="TNOCS loss")
        plt.plot(curves["val_steps"], curves["val_losses"], "-", label="val loss")
        plt.xlabel("optim steps")
        plt.legend()
        plt.title("Training Curves")
        plt.savefig(os.path.join(out_dir, "train_curve.png"))
        plt.close(fig)


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
