"""Entry: ``CaSPRModel.encode`` of caspr_tpu_torch, as the T-NOCS regression
evaluation calls it: TPointNet++ over a batch of observed sequences, giving
the latent code and the per-point T-NOCS prediction.

One call is one batch of the pool, synchronised.  The check recomputes the
sampled calls with the plain reference's encoder and compares the T-NOCS
prediction and the latent code by their widest gap.
"""

from __future__ import annotations

import torch

from harness import core, program, sequences
from reference import caspr as ref


class Driver:
    entry, output_index = "encode", 1  # the T-NOCS prediction
    spans = {"encode_ms": "encode"}

    def __init__(self, cell, device, pool_seed, weight_seed):
        self.cell, self.device, self.traffic = cell, device, cell.traffic
        program.precision(cell)
        self.model = program.model(cell, device)
        self.weight_seed = weight_seed
        self.params, _ = program.weights(cell, self.model.cfg, device, weight_seed)
        self.pool = sequences.make_pool(program.generator(device, pool_seed), self.traffic, device)

    def warm(self):
        for i in range(self.traffic["warmup_calls"]):
            self.call(i)

    def call(self, i):
        entry = self.pool[i % len(self.pool)]
        with torch.no_grad():
            z0, tnocs = self.model.encode(self.params, entry["input"])
        if self.device == "cuda":
            torch.cuda.synchronize()
        return {"seqs": entry["input"].shape[0], "entry": i % len(self.pool),
                "outputs": (tnocs, z0)}

    def release(self):
        self.model = self.params = None
        self.ref_params = program.reference_weights(self.cell, self.device, self.weight_seed)[0]

    def reference(self, entry_index, tf32=False):
        program.precision(self.cell, tf32)
        with torch.no_grad():
            z0, tnocs = ref.encode(self.ref_params, self.cell.model,
                                   self.pool[entry_index]["input"])
        program.precision(self.cell)
        return (tnocs, z0), None

    @staticmethod
    def compare(outputs, nfe, ref_outputs, ref_nfe):
        return {"tnocs_gap": float((outputs[0] - ref_outputs[0]).abs().max()),
                "latent_gap": float((outputs[1] - ref_outputs[1]).abs().max()
                                    / ref_outputs[1].abs().max())}

    def check(self, sample):
        return core.sample_checks(self, sample, self.traffic["limits"])
