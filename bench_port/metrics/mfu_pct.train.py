"""The whole step's share of the cards' peak: the model's training products
for the window's sequences at their measured forward and backward NFE
(harness/flops.py) over the window's time, against the dense bf16 rate of
the cell's cards (a step on several cards counts its global batch)."""

from harness import flops, peaks


def read(r):
    m, t = r.cell.model, r.cell.traffic
    work = sum(info["seqs"] * flops.train_flops(m, t["seq_len"], t["points"], info["nfe"],
                                                info["nfe_bwd"]) for info in r.infos)
    return 100.0 * work / r.window_s / (r.cell.chips * peaks.DENSE_FLOPS)
