"""Entry: the train step of caspr_tpu_torch under data parallelism, one rank
a card (``harness/ranks.py``): ``train/loop.py::make_train_step(mesh=)`` on
the ``(dp,)`` mesh over every rank (``parallel.make_mesh``), the port's path
for training on several cards.

Every rank makes the traffic's pool of global batches from the seed, as one
process would, and keeps its rows of each (``parallel.shard_batch``), the
Hutchinson noise's with them; it starts from rank 0's weights
(``parallel.replicate``).  The model makes its reductions global (the
solvers' error norms, the adjoint's parameter VJPs, the normalisation's
statistics) and the gradient is summed over the ranks before each rank's
Adam step, so every rank takes the one-process step: its loss is its share
of the global batch's, and the step returns the sum of the shares.

The check is ``train_step.py``'s on rank 0: the plain reference follows the
first ``check_steps`` global batches in one process on rank 0's card once
every rank has freed its state, and is held to the global loss, the
gradient as Adam got it (global after the all-reduce) and each leaf's
change.  Besides, ``ranks_gap``: the largest absolute difference of any
rank's parameters from rank 0's after the window, which must be 0, since
every rank takes the same step from the same numbers.
"""

from __future__ import annotations

from pathlib import Path

import torch

from harness import core, program, sequences

single = core.load_module(Path(__file__).resolve().parent / "train_step.py",
                          "bench_driver_train_step")
group_of = single.group_of


class Driver(single.Driver):
    def __init__(self, cell, device, pool_seed, weight_seed):
        import torch.distributed as dist

        from caspr_tpu_torch.parallel import make_mesh, replicate, shard_batch
        from caspr_tpu_torch.train.loop import make_optimizer, make_train_step

        self.cell, self.device, self.traffic = cell, device, cell.traffic
        self.rank = dist.get_rank()
        self.restore = []  # undoes what a fault planted, on release
        program.precision(cell)
        self.model = program.model(cell, device)
        self.weight_seed = weight_seed
        self.params, self.state = program.weights(cell, self.model.cfg, device, weight_seed)
        self.mesh = make_mesh(1)
        replicate(self.mesh, (self.params, self.state))
        recipe = cell.config["train"]
        tx = make_optimizer(recipe["lr"], tuple(recipe["betas"]), recipe["eps"])
        self.opt = tx.init(self.params)
        self.step = make_train_step(self.model, tx, recipe["cnf_loss_weight"],
                                    recipe["tnocs_loss_weight"], mesh=self.mesh)
        # the global batches, for the reference, and this rank's rows of each
        self.pool = sequences.make_pool(program.generator(device, pool_seed), self.traffic, device)
        self.shards = []
        for entry in self.pool:
            x, target = entry["input"], entry["target"]
            noise = entry["noise"].reshape(*x.shape[:3], 3)  # (B T, N, 3) as (B, T, N, 3)
            x, target, noise = shard_batch(self.mesh, (x, target, noise))
            self.shards.append({"input": x.contiguous(), "target": target.contiguous(),
                                "noise": noise.reshape(-1, *noise.shape[2:]).contiguous(),
                                "seqs": entry["input"].shape[0]})

    def _step(self, k):
        entry = self.shards[k % len(self.shards)]
        self.params, self.opt, self.state, m = self.step(
            self.params, self.opt, self.state, entry["input"], entry["target"], None,
            e=entry["noise"])
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        # the global batch's sequences and loss (the sum of the ranks' shares)
        return {"seqs": entry["seqs"], "loss": m["loss"], "nfe": m["nfe_forward"],
                "nfe_bwd": tuple(a - b for a, b in zip(m["nfe"], m["nfe_forward"]))}

    def close_window(self):
        """On every rank after the window: the largest absolute difference of
        any rank's parameters from rank 0's (``ranks_gap``)."""
        import torch.distributed as dist

        with torch.no_grad():
            flat = torch.cat([p.detach().reshape(-1) for p in program.leaves(self.params)])
            lead = flat.clone()
            dist.broadcast(lead, 0)
            gap = (flat - lead).abs().max().reshape(1).double()
            del flat, lead
            dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        self.ranks_gap = gap.item()

    def reset_counters(self):
        from caspr_tpu_torch.parallel import reset_collectives

        reset_collectives()

    def counters(self):
        """The program's counts of its collectives by kind since the reset:
        {"collectives": {kind: {"calls", "bytes"}}}."""
        from caspr_tpu_torch.parallel import collectives

        return {"collectives": {k: dict(v) for k, v in collectives.items()}}

    def release(self):
        for undo in self.restore:
            undo()
        self.restore = []
        self.model = self.params = self.state = self.opt = self.step = self.shards = None
        if self.rank != 0:
            self.pool = None

    def reference(self, tf32=False):
        """The plain reference's first steps over the global batches, in one
        process: (losses, nfe pairs, first gradient norms, change norms),
        each norm by leaf name."""
        ref = self.cell.reference
        program.precision(self.cell, tf32)
        recipe = self.cell.config["train"]
        params, state = program.reference_weights(self.cell, self.device, self.weight_seed)
        leaves = single.named_leaves(params)
        start = {k: v.clone() for k, v in leaves.items()}
        opt = torch.optim.Adam(list(leaves.values()), lr=recipe["lr"],
                               betas=tuple(recipe["betas"]), eps=recipe["eps"])
        steps, grads = [], {}
        for k in range(self.traffic["check_steps"]):
            entry = self.pool[k % len(self.pool)]
            state, m = ref.train_step(params, opt, state, self.cell.model, entry["input"],
                                      entry["target"], entry["noise"],
                                      recipe["cnf_loss_weight"], recipe["tnocs_loss_weight"])
            steps.append({"loss": m["loss"], "nfe": m["nfe_forward"], "nfe_bwd": m["nfe_backward"]})
            if k == 0:
                grads = {n: (opt.state[p]["exp_avg"] / (1.0 - recipe["betas"][0])).norm().item()
                         for n, p in leaves.items()}
        change = {n: (p.detach() - start[n]).norm().item() for n, p in leaves.items()}
        program.precision(self.cell)
        return steps, grads, change

    def check(self, sample):
        numbers = self.compare(self.first, self.grads, self.change, *self.reference())
        numbers["ranks_gap"] = self.ranks_gap
        limits = self.traffic["limits"]
        return [(k, numbers[k], limits[k]) for k in limits]
