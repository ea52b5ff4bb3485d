"""The one generator of the benchmark's inputs: seeded sequences of partial
point clouds of objects in rigid motion, made on the device in bulk.

Each sequence is an ellipsoid's surface in the unit cube (its NOCS, the
T-NOCS target's space), seen over ``frames`` frames under a turn about the
vertical axis that grows from frame to frame and a drift, in the format of
the CaSPR datasets (and of the port's ``data/synthetic.py``, whose
generator this is, vectorised):

    input  (B, T, N, 4): R_i (nocs - 0.5) + t_i, world time max_timestamp * i / (F - 1)
    target (B, T, N, 4): nocs, normalised time i / (F - 1)

A traffic file gives the shapes and the motion's ranges; every number drawn
comes from one ``torch.Generator`` on the device seeded by the caller.
Training batches take ``seq_len`` of a sequence's frames, sorted, and shift
both times to start at zero, as the dataset's training loader does.
"""

from __future__ import annotations

import math

import torch


def uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def make_sequences(gen, traffic, count: int, device):
    """``count`` sequences of the traffic's ``frames`` x ``points``:
    (input (count, F, N, 4), target (count, F, N, 4))."""
    motion = traffic["motion"]
    f, n = traffic["frames"], traffic["points"]
    axes = uniform(gen, (count, 1, 1, 3), *motion["axes"], device)
    turn = uniform(gen, (count, 1), *motion["turn"], device)
    start = uniform(gen, (count, 1), 0.0, 2.0 * math.pi, device)
    drift = uniform(gen, (count, 1, 3), -motion["drift"], motion["drift"], device)
    d = torch.randn((count, f, n, 3), generator=gen, device=device)
    nocs = 0.5 + axes * d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    step = torch.arange(f, device=device, dtype=torch.float32)
    a = start + turn * step  # (count, F)
    cos, sin = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    rot = torch.stack([torch.stack([cos, zero, sin], -1), torch.stack([zero, one, zero], -1),
                       torch.stack([-sin, zero, cos], -1)], -2)  # (count, F, 3, 3)
    shift = torch.tensor([0.0, 0.0, motion["distance"]], device=device) + drift * step[:, None]
    world = torch.einsum("cfij,cfnj->cfni", rot, nocs - 0.5) + shift[:, :, None, :]
    frac = (step / max(f - 1, 1))[None, :, None, None].expand(count, f, n, 1)
    inputs = torch.cat([world, traffic["max_timestamp"] * frac], dim=-1)
    targets = torch.cat([nocs, frac], dim=-1)
    return inputs.contiguous(), targets.contiguous()


def take_frames(gen, inputs, targets, seq_len: int):
    """``seq_len`` frames of each sequence, sorted, times shifted to zero."""
    count, f = inputs.shape[:2]
    keys = torch.rand((count, f), generator=gen, device=inputs.device)
    steps = torch.sort(torch.argsort(keys, dim=1)[:, :seq_len], dim=1).values
    idx = steps[:, :, None, None].expand(-1, -1, *inputs.shape[2:])
    x, y = torch.gather(inputs, 1, idx), torch.gather(targets, 1, idx)
    x[..., 3] -= x[:, :1, :1, 3].clone()
    y[..., 3] -= y[:, :1, :1, 3].clone()
    return x.contiguous(), y.contiguous()


def make_pool(gen, traffic, device):
    """The traffic's pool of distinct batches: a list of dicts with "input",
    "target" and, per the traffic's entry, "base" (decode base samples) or
    "noise" (the CNF's Hutchinson noise)."""
    batch, pool = traffic["batch"], []
    for _ in range(traffic["pool"]):
        x, y = make_sequences(gen, traffic, batch, device)
        if "seq_len" in traffic:
            x, y = take_frames(gen, x, y, traffic["seq_len"])
        entry = {"input": x, "target": y}
        b, t, n, _ = y.shape
        if traffic.get("base_samples"):
            entry["base"] = torch.randn((b, t, n, 3), generator=gen, device=device)
        if traffic.get("hutchinson_noise"):
            entry["noise"] = torch.randn((b * t, n, 3), generator=gen, device=device)
        pool.append(entry)
    return pool
