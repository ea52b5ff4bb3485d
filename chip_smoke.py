#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (caspr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. print the card's name and power limit; build the six CUDA kernels
     from caspr_tpu_torch/csrc and print the build time;
  2. hold every kernel against its plain PyTorch version on the card, at
     the shapes of the batch-4 reconstruct path, and time kernel, plain
     version and (where one PyTorch call computes the same function) the
     library call with CUDA events;
  3. run full-width CaSPRModel.reconstruct (B=4, T=10, N=2048, trained
     weights from artifacts/demo_trained.pkl) with every launch count set
     to 0 just before, and check that each kernel ran and the output is
     finite and of the right shape; time three more runs, and profile one
     (device time by kernel, the card's idle share);
  4. run one small reconstruct (B=1, T=2, N=2048, 512 decoded points) on
     the card and on the CPU with the same base samples: equal NFE and
     points within 1e-3.

Then it prints one JSON line listing every kernel and, last, the verdict
line {"ok": true, "device": {...}}.  Without a CUDA device, or outside
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): device memory rate and float32 rate
# outside the tensor cores.  A card below its 700 W limit runs slower.
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

BATCH, FRAMES, POINTS = 4, 10, 2048
BT = BATCH * FRAMES
SEED = 0

# per kernel: its source and the TPU kernel it replaces (file:line of the
# pallas_call)
KERNEL_INFO = {
    "fps": ("caspr_tpu_torch/csrc/fps.cu",
            "caspr_tpu/ops/pallas_kernels.py:1367"),
    "ball_query": ("caspr_tpu_torch/csrc/ball_query.cu",
                   "caspr_tpu/ops/pallas_kernels.py:1181"),
    "gather": ("caspr_tpu_torch/csrc/gather.cu",
               "caspr_tpu/ops/pallas_kernels.py:788"),
    "three_nn": ("caspr_tpu_torch/csrc/three_nn.cu",
                 "caspr_tpu/ops/pallas_kernels.py:1279"),
    "three_interpolate": ("caspr_tpu_torch/csrc/three_interpolate.cu",
                          "caspr_tpu/ops/pallas_kernels.py:601"),
    "cnf_primal": ("caspr_tpu_torch/csrc/cnf_primal.cu",
                   "caspr_tpu/ops/cnf_fused.py:283"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, ops: float):
    """Least time on the card for the work: (ms, what bounds it)."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def scanned_pairs(torch, xyz, centers, r2s, ks):
    """(centroid, source) pairs the ball-query scan visits on this data: up
    to the hit that fills the last of the lists, or all N sources."""
    from caspr_tpu_torch.ops.pointops import pairwise_sqdist

    d2 = pairwise_sqdist(centers, xyz)
    n = xyz.shape[1]
    stop = torch.zeros(d2.shape[:2], dtype=torch.long, device=d2.device)
    for r2, k in zip(r2s, ks):
        count = torch.cumsum((d2 < r2).int(), dim=-1)
        full = count[..., -1] >= k
        at = torch.argmax((count >= k).int(), dim=-1) + 1
        stop = torch.maximum(stop, torch.where(full, at, torch.full_like(at, n)))
    return int(stop.sum())


def check_kernels(torch, gen):
    """Phase 2: every kernel against its plain version at path shapes."""
    from caspr_tpu_torch.ops import cnf_fused, kernels, pointops
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    f4 = 4.0
    rows = {}

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    # FPS: the one real FPS of the path (hier collapse), 2048 -> 1024
    xyz = rand(BT, POINTS, 3)
    m = 1024
    got = kernels.farthest_point_sampling(xyz, m)
    want = pointops.farthest_point_sampling(xyz, m)
    if not torch.equal(got, want):
        raise AssertionError(f"fps: {int((got != want).sum())} indices differ")
    rows["fps"] = dict(
        max_abs_err=0.0, tolerance="indices identical",
        ms=time_ms(torch, lambda: kernels.farthest_point_sampling(xyz, m)),
        plain_ms=time_ms(torch, lambda: pointops.farthest_point_sampling(xyz, m)),
        library_ms=None,
        work=(BT * POINTS * 3 * f4 + BT * m * f4, BT * (m - 1) * POINTS * 10.0),
        shape=f"xyz ({BT}, {POINTS}, 3) -> ({BT}, {m})",
    )

    # ball query: SA level 1 (2048 sources, 1024 centroids, r .02/.05) and
    # level 5 (64 sources, 16 centroids, r .4/.8); 16 and 32 per ball
    ball = {}
    for name, (n, mc, r1, r2) in {"level1": (2048, 1024, 0.02, 0.05),
                                  "level5": (64, 16, 0.4, 0.8)}.items():
        src = xyz[:, :n].contiguous()
        cen = xyz[:, :mc].contiguous()
        g1, g2 = kernels.ball_query_pair(src, cen, r1, 16, r2, 32)
        w1, w2 = pointops.ball_query_pair(src, cen, r1, 16, r2, 32)
        if not (torch.equal(g1, w1) and torch.equal(g2, w2)):
            raise AssertionError(f"ball query {name}: indices differ")
        pairs = scanned_pairs(torch, src, cen,
                              [pointops.radius_sq(r1), pointops.radius_sq(r2)], [16, 32])
        ball[name] = dict(
            ms=time_ms(torch, lambda: kernels.ball_query_pair(src, cen, r1, 16, r2, 32)),
            plain_ms=time_ms(torch, lambda: pointops.ball_query_pair(src, cen, r1, 16, r2, 32)),
            work=((BT * n * 3 + BT * mc * 3 + BT * mc * 48) * f4, pairs * 10.0),
        )
    rows["ball_query"] = dict(
        max_abs_err=0.0, tolerance="indices identical",
        ms=ball["level1"]["ms"], plain_ms=ball["level1"]["plain_ms"], library_ms=None,
        work=ball["level1"]["work"],
        shape=f"level 1: ({BT}, 2048, 3) x ({BT}, 1024, 3) -> 16 + 32; "
              f"level 5 ms {ball['level5']['ms']:.4f}, plain {ball['level5']['plain_ms']:.4f}",
    )

    # gather: the largest site, SA level 1 scale 2 ([xyz | 6 features],
    # 1024 centroids x 32 neighbours)
    pts = rand(BT, POINTS, 9)
    idx = torch.randint(0, POINTS, (BT, 1024, 32), generator=gen, device=dev, dtype=torch.int32)
    got = kernels.gather_points(pts, idx)
    want = pointops.gather_points(pts, idx)
    if not torch.equal(got, want):
        raise AssertionError("gather: not bit-exact")
    idx64 = idx.reshape(BT, -1, 1).long()
    r = idx.numel() // BT
    rows["gather"] = dict(
        max_abs_err=0.0, tolerance="bit-exact",
        ms=time_ms(torch, lambda: kernels.gather_points(pts, idx)),
        plain_ms=time_ms(torch, lambda: pointops.gather_points(pts, idx)),
        library_ms=time_ms(torch, lambda: torch.take_along_dim(pts, idx64, dim=1)),
        work=((BT * POINTS * 9 + BT * r + BT * r * 9) * f4, 0.0),
        shape=f"({BT}, {POINTS}, 9) x ({BT}, {r}) -> ({BT}, {r}, 9)",
    )

    # three-NN: the finest FP level, 2048 queries against 1024 sources
    q = xyz
    s = xyz[:, :1024].contiguous()
    gd, gi = kernels.three_nn(q, s)
    wd, wi = pointops.three_nn(q, s)
    if not torch.equal(gi, wi):
        raise AssertionError(f"three_nn: {int((gi != wi).sum())} indices differ")
    err = float((gd - wd).abs().max())
    if err != 0.0:
        raise AssertionError(f"three_nn: distances differ by {err}")
    rows["three_nn"] = dict(
        max_abs_err=err, tolerance="indices identical, distances exact",
        ms=time_ms(torch, lambda: kernels.three_nn(q, s)),
        plain_ms=time_ms(torch, lambda: pointops.three_nn(q, s)),
        library_ms=None,
        work=((BT * POINTS * 3 + BT * 1024 * 3 + BT * POINTS * 6) * f4,
              BT * POINTS * 1024 * 9.0),
        shape=f"({BT}, {POINTS}, 3) x ({BT}, 1024, 3) -> ({BT}, {POINTS}, 3)",
    )

    # three-interpolate: the finest FP level moves 512 conv channels from
    # 1024 source points to 2048 queries
    feats = rand(BT, 1024, 512) - 0.5
    inv = 1.0 / (wd + 1e-8)
    w = (inv / inv.sum(-1, keepdim=True)).contiguous()
    got = kernels.three_interpolate(feats, wi, w)
    want = pointops.three_interpolate(feats, wi, w)
    err = float((got - want).abs().max())
    if err > 1e-6:
        raise AssertionError(f"three_interpolate: max abs err {err} > 1e-6")
    rows["three_interpolate"] = dict(
        max_abs_err=err, tolerance="1e-6 abs (same rounding order: expect 0)",
        ms=time_ms(torch, lambda: kernels.three_interpolate(feats, wi, w)),
        plain_ms=time_ms(torch, lambda: pointops.three_interpolate(feats, wi, w)),
        library_ms=None,
        work=((BT * 1024 * 512 + BT * POINTS * 6 + BT * POINTS * 512) * f4,
              BT * POINTS * 512 * 5.0),
        shape=f"({BT}, 1024, 512) -> ({BT}, {POINTS}, 512)",
    )

    # CNF primal: the trained decoder at one dynamics evaluation
    params, _ = load_demo(device=dev)
    odenet = params["point_cnf"][1]["odenet"]
    tc = torch.cat([torch.full((BT, 1), 0.25, device=dev),
                    torch.randn((BT, 1600), generator=gen, device=dev)], dim=1)
    y = torch.randn((BT, POINTS, 3), generator=gen, device=dev)
    gb = cnf_fused.context_gb(odenet, tc)
    wf, wh, wl = cnf_fused.pack_weights(odenet)
    got = kernels.cnf_primal(y, gb, wf, wh, wl)
    want = cnf_fused.primal_packed(y, gb, wf, wh, wl)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not rel <= 1e-4:
        raise AssertionError(f"cnf_primal: relative err {rel} > 1e-4")
    h = wf.shape[0]
    rows["cnf_primal"] = dict(
        max_abs_err=err, tolerance="1e-4 relative to max |dx|",
        ms=time_ms(torch, lambda: kernels.cnf_primal(y, gb, wf, wh, wl)),
        plain_ms=time_ms(torch, lambda: cnf_fused.primal_packed(y, gb, wf, wh, wl)),
        library_ms=None,
        work=((y.numel() * 2 + gb.numel() + wf.numel() + wh.numel() + wl.numel()) * f4,
              2.0 * BT * POINTS * (3 * h + wh.shape[0] * h * h + h * 3)),
        shape=f"y ({BT}, {POINTS}, 3), H {h}",
    )
    for name, row in rows.items():
        print(json.dumps({"kernel": name, **{k: v for k, v in row.items() if k != "work"}}),
              flush=True)
    return rows


def run_path(torch, kernels):
    """Phase 3: full-width reconstruct through the kernels."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    cfg = CaSPRConfig()
    model = CaSPRModel(cfg, device="cuda")
    params, state = load_demo(device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((BATCH, FRAMES, POINTS, 4), generator=gen, device=dev)
    x[..., 3] = torch.linspace(0.0, 5.0, FRAMES, device=dev)[None, :, None]
    timestamps = torch.linspace(0.0, 1.0, FRAMES, device=dev)

    def recon():
        return model.reconstruct(params, state, x, gen, num_points=POINTS,
                                 timestamps=timestamps)

    recon()  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    kernels.reset_launches()
    start = time.perf_counter()
    _, _, x_rec, tnocs, (nfe_ode, nfe_cnf) = recon()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = dict(kernels.launches)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"path ran without kernels {missing}: {counts}")
    if tuple(x_rec.shape) != (BATCH, FRAMES, POINTS, 3) or not bool(torch.isfinite(x_rec).all()):
        raise AssertionError(f"reconstruct output bad: shape {tuple(x_rec.shape)}")
    if not bool(torch.isfinite(tnocs).all()):
        raise AssertionError("T-NOCS output not finite")
    repeats = []
    for _ in range(3):
        start = time.perf_counter()
        recon()
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - start)
    median = float(np.median(repeats))
    print(json.dumps({"path": "reconstruct", "batch": BATCH, "frames": FRAMES,
                      "points": POINTS, "nfe_ode": nfe_ode, "nfe_cnf": nfe_cnf,
                      "seconds": seconds, "repeat_seconds": repeats,
                      "seqs_per_s": BATCH / median, "launches": counts}), flush=True)
    profile_path(torch, recon, median * 1e3)
    return counts


def profile_path(torch, recon, wall_ms):
    """One more reconstruct under torch.profiler: device time by kernel, and
    the share of the unprofiled wall time ``wall_ms`` in which the card ran
    no kernel (the profiler's own host overhead would inflate its wall)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        recon()
        torch.cuda.synchronize()
    device_ms = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:  # kernels and copies only
            continue
        ms = getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            device_ms[evt.key[:80]] = (ms, evt.count)
    busy = sum(ms for ms, _ in device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "profile": "reconstruct B=4 T=10 N=2048 under torch.profiler",
        "unprofiled_wall_ms": wall_ms,
        "device_busy_ms": busy if busy else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if busy else "not measured",
        "top": [{"name": k, "ms": ms, "calls": n} for k, (ms, n) in top],
    }), flush=True)


def cross_device(torch):
    """Phase 4: the same small reconstruct on the card and on the CPU."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    cfg = CaSPRConfig()
    rng = np.random.default_rng(SEED)
    x = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    x[..., 3] = np.array([0.0, 5.0], np.float32)[None, :, None]
    base = rng.standard_normal((1, 2, 512, 3)).astype(np.float32)
    ts = np.array([0.0, 1.0], np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = CaSPRModel(cfg, device=dev)
        params, state = load_demo(device=dev)
        _, _, rec, _, nfe = model.reconstruct(
            params, state, torch.from_numpy(x).to(dev), None, num_points=512,
            timestamps=torch.from_numpy(ts).to(dev),
            base_samples=torch.from_numpy(base).to(dev))
        out[dev] = (rec.cpu(), nfe)
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    if out["cuda"][1] != out["cpu"][1] or not err <= 1e-3:
        raise AssertionError(f"card vs CPU: nfe {out['cuda'][1]} vs {out['cpu'][1]}, max abs err {err}")
    print(json.dumps({"cross_device": "reconstruct B=1 T=2 N=2048 -> 512",
                      "nfe": out["cuda"][1], "max_abs_err": err, "tolerance": 1e-3}),
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from caspr_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    start = time.perf_counter()
    lib = kernels.build()
    print(json.dumps({"build_seconds": time.perf_counter() - start, "library": lib.name}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_kernels(torch, gen)
    counts = run_path(torch, kernels)
    cross_device(torch)

    listing = []
    for name, row in rows.items():
        bound_ms, bound_by = bound(*row["work"])
        source, replaces = KERNEL_INFO[name]
        listing.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": row["library_ms"],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
