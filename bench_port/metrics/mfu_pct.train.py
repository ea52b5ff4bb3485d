"""The whole step's share of the card's peak: the model's training products
for the window's sequences at their measured forward and backward NFE
(harness/flops.py) over the window's time, against the dense bf16 rate."""

from harness import flops, peaks


def read(r):
    m, t = r.cell.model, r.cell.traffic
    work = sum(info["seqs"] * flops.train_flops(m, t["seq_len"], t["points"], info["nfe"],
                                                info["nfe_bwd"]) for info in r.infos)
    return 100.0 * work / r.window_s / peaks.DENSE_FLOPS
