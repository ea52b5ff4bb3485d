"""Faults planted under a driver's timed path, before its first call: the
check has to come out false for each that its cell can have.  Each takes
the driver and returns nothing; the program itself is not edited."""

from __future__ import annotations

from reference import caspr as ref


def _wrap_entry(driver, change):
    """Replace the program's entry method (the driver's ``entry``) by
    ``change(inner, *args, **kwargs)``."""
    name = driver.entry
    inner = getattr(driver.model, name)
    setattr(driver.model, name, lambda *a, **k: change(inner, *a, **k))


def answer_altered(driver):
    """One number of the first output altered where it is produced."""
    def change(inner, *args, **kwargs):
        out = inner(*args, **kwargs)
        altered = out[driver.output_index].clone()
        altered.view(-1)[0] += 0.05
        return (*out[:driver.output_index], altered, *out[driver.output_index + 1:])
    _wrap_entry(driver, change)


def half_batch(driver):
    """Half of each batch left out: an evaluation answers the first half
    and repeats it; a train step's loss is the mean over the first half."""
    if driver.entry == "train_step":
        inner = driver.step

        def step(params, opt, state, x, target, generator=None, e=None):
            h = x.shape[0] // 2
            rows = e.shape[0] * h // x.shape[0]
            return inner(params, opt, state, x[:h], target[:h], generator, e=e[:rows])

        driver.step = step
        return

    def change(inner, params, *args, **kwargs):
        x = args[-1] if driver.entry == "encode" else args[1]
        h = x.shape[0] // 2
        args = list(args)
        if driver.entry == "encode":
            args[-1] = x[:h]
        else:
            args[1] = x[:h]
            kwargs["base_samples"] = kwargs["base_samples"][:h]
        out = inner(params, *args, **kwargs)
        return tuple(o.repeat(2, *([1] * (o.dim() - 1))) if hasattr(o, "repeat") else o
                     for o in out)
    _wrap_entry(driver, change)


def cnf_grad_zeroed(driver):
    """The CNF's field weights (the ODE net's layers) get a zero gradient,
    as from a VJP whose weight-gradient kernels wrote nothing; every other
    gradient is sound."""
    field = ref.leaves(driver.params["point_cnf"][1]["odenet"])
    inner = driver.opt.step

    def step(*args, **kwargs):
        for leaf in field:
            if leaf.grad is not None:
                leaf.grad.zero_()
        return inner(*args, **kwargs)

    driver.opt.step = step


def state_unchanged(driver):
    """The train step returns the parameters unchanged: no optimizer update."""
    driver.opt.step = lambda *a, **k: None


def gradient_not_reduced(driver):
    """Data parallelism: the last rank's gradient skips the all-reduce over
    the ranks.  It still takes part in the collective, so that the ranks
    keep in step, and keeps its own share of the gradient."""
    import torch.distributed as dist
    from caspr_tpu_torch.train import loop

    if dist.get_rank() != dist.get_world_size() - 1:
        return
    inner = loop.all_reduce_sum_leaves

    def local(leaves, group, kind):
        if kind != "grad":
            return inner(leaves, group, kind)
        inner([t.clone() for t in leaves], group, kind)
        return leaves

    loop.all_reduce_sum_leaves = local
    driver.restore.append(lambda: setattr(loop, "all_reduce_sum_leaves", inner))


def rank_exits(driver):
    """A cell on several cards: the last rank ends its process, with status
    0, at its first timed call (the run has to fail, not hang)."""
    import os

    import torch.distributed as dist

    if dist.get_rank() == dist.get_world_size() - 1:
        driver.call = lambda i: os._exit(0)


FAULTS = {"answer_altered": answer_altered, "half_batch": half_batch,
          "state_unchanged": state_unchanged, "cnf_grad_zeroed": cnf_grad_zeroed,
          "gradient_not_reduced": gradient_not_reduced, "rank_exits": rank_exits}
