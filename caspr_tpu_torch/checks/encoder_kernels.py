"""The encoder's point-op kernels at every shape one reconstruct launches.

    python3 -m caspr_tpu_torch.checks.encoder_kernels      (needs a CUDA card)

``capture_calls`` records the arguments of every call one encode makes to
the wrappers of fps, ball_query, gather, three_nn and three_interpolate
(the batch-4 reconstruct: 1, 5, 11, 5 and 5 launches), and the five FPS
calls the encoder makes with ``fps="level"``.  ``measure`` holds each call's
kernel to its plain version (indices identical, gathered and interpolated
values bit-exact) and times kernel and plain version with CUDA
events, summed per reconstruct beside the summed bound.
``capture_sa_calls`` records the ten sa_fused calls of an
``sa_impl="fused"`` encode, and ``measure_sa`` holds each to its plain
version in float64 (1e-4 of each output's largest magnitude, two launches
bit-equal) and times it the same way, beside its tensor-core and float32
bounds.  A wrapper's host
work (checks, allocation, the ctypes call: tens of microseconds) is longer
than many of these kernels, so timing one call between two events times the
host; ``queued_ms`` queues the calls behind a spin kernel, so that the card
runs them back to back, and times the kernels alone.

Run from the root of a checkout (it takes chip_smoke.py's reconstruct input
and bound), it prints one JSON line per kernel with the per-call times and
the sums, one with fps past what a block holds in registers (chip_smoke.py
phase 2's (4, 16384, 3) -> 1024), one with sa_fused's ten calls, one with
the encode's milliseconds by SA mode, and one with one reconstruct under
torch.profiler: its NFE, unprofiled wall, device busy time and idle share
(chip_smoke.py's profile_path) and the device time of these kernels.  To
compare two commits, run it from both checkouts in one call, in the order
parent, change, change, parent.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ..models import pointnet2
from ..ops import kernels, pointops

KERNELS = ("fps", "ball_query", "gather", "three_nn", "three_interpolate")
# substrings of these kernels' names in a profile
FOCUS = ("fps_kernel", "ball_query", "gather_rows", "three_nn", "three_interp", "sa_fused")
# the wrapper names pointnet2 calls, by kernel
_WRAPPERS = {"farthest_point_sampling": "fps", "ball_query_pair": "ball_query",
             "gather_points": "gather", "three_nn": "three_nn",
             "three_interpolate": "three_interpolate"}
_PLAIN = {"fps": pointops.farthest_point_sampling, "ball_query": pointops.ball_query_pair,
          "gather": pointops.gather_points, "three_nn": pointops.three_nn,
          "three_interpolate": pointops.three_interpolate}
_KERNEL = {"fps": kernels.farthest_point_sampling, "ball_query": kernels.ball_query_pair,
           "gather": kernels.gather_points, "three_nn": kernels.three_nn,
           "three_interpolate": kernels.three_interpolate}


def queued_ms(fn, reps: int = 20, spin_cycles: int = 10_000_000) -> float:
    """Device milliseconds of one fn() call: the median over three rounds of
    ``reps`` calls enqueued while the card runs a spin kernel of
    ``spin_cycles`` clocks (about 5 ms, longer than the host takes to
    enqueue the calls), timed by CUDA events recorded after the spin and
    after the last call, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def wall_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of one fn() call, after one
    warm-up: the host's enqueue and the card's work, whichever is longer."""
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
    return sorted(times)[reps // 2]


def capture_calls(model, params, x):
    """{kernel: [args of each call]} of one encode of x (the wrappers
    pointnet2 calls), and under "fps_level" the five FPS calls of
    ``fps="level"``: each level's FPS on the previous level's centroids."""
    calls = {k: [] for k in KERNELS}
    saved = {name: getattr(pointnet2, name) for name in _WRAPPERS}

    def recorder(name):
        real = saved[name]

        def record(*args):
            calls[_WRAPPERS[name]].append(args)
            return real(*args)
        return record

    try:
        for name in _WRAPPERS:
            setattr(pointnet2, name, recorder(name))
        with torch.no_grad():
            model.encode(params, x)
    finally:
        for name, fn in saved.items():
            setattr(pointnet2, name, fn)
    xyz = calls["fps"][0][0]
    calls["fps_level"] = []
    with torch.no_grad():
        for m in model.cfg.sa_points:
            calls["fps_level"].append((xyz, m))
            xyz = kernels.gather_points(xyz, kernels.farthest_point_sampling(xyz, m))
    return calls


def scanned_pairs(xyz, centers, r2s, ks):
    """(centroid, source) pairs the ball-query scan visits on this data: up
    to the hit that fills the last of the lists, or all N sources."""
    d2 = pointops.pairwise_sqdist(centers, xyz)
    n = xyz.shape[1]
    stop = torch.zeros(d2.shape[:2], dtype=torch.long, device=d2.device)
    for r2, k in zip(r2s, ks):
        count = torch.cumsum((d2 < r2).int(), dim=-1)
        full = count[..., -1] >= k
        at = torch.argmax((count >= k).int(), dim=-1) + 1
        stop = torch.maximum(stop, torch.where(full, at, torch.full_like(at, n)))
    return int(stop.sum())


def work(kernel, args):
    """(bytes, float32 operations) of one call: each input read once, each
    output written once; the ball query's and FPS's operations on this
    data."""
    f4 = 4.0
    if kernel in ("fps", "fps_level"):
        xyz, m = args
        b, n, _ = xyz.shape
        return b * n * 3 * f4 + b * m * f4, b * (m - 1) * n * 10.0
    if kernel == "gather":
        points, idx = args
        b, n, c = points.shape
        r = idx.numel() // b
        return (b * n * c + b * r + b * r * c) * f4, 0.0
    if kernel == "ball_query":
        xyz, cen, r1, k1, r2, k2 = args
        b, n, _ = xyz.shape
        m = cen.shape[1]
        pairs = scanned_pairs(xyz, cen, [pointops.radius_sq(r1), pointops.radius_sq(r2)],
                              [k1, k2])
        return (b * n * 3 + b * m * 3 + b * m * (k1 + k2)) * f4, pairs * 10.0
    if kernel == "three_nn":
        q, s = args
        b, nq, _ = q.shape
        return (b * nq * 3 + b * s.shape[1] * 3 + b * nq * 6) * f4, b * nq * s.shape[1] * 9.0
    if kernel == "three_interpolate":
        feats, idx, w = args
        b, ns, c = feats.shape
        nq = idx.shape[1]
        return (b * ns * c + b * nq * 6 + b * nq * c) * f4, b * nq * c * 5.0
    raise ValueError(kernel)


def shape_of(kernel, args):
    if kernel in ("fps", "fps_level"):
        return f"{tuple(args[0].shape)} -> {args[1]}"
    if kernel == "ball_query":
        return f"{tuple(args[0].shape)} x {tuple(args[1].shape)}, K {args[3]} + {args[5]}"
    return " x ".join(str(tuple(a.shape)) for a in args)


def _leaves(result):
    return result if isinstance(result, tuple) else (result,)


def check_call(kernel, args):
    """The kernel's result against the plain version's on the same args:
    indices identical, gathered and interpolated values bit-exact
    (torch.equal).  Returns the largest absolute difference (0)."""
    name = "fps" if kernel == "fps_level" else kernel
    with torch.no_grad():
        got = _leaves(_KERNEL[name](*args))
        want = _leaves(_PLAIN[name](*args))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        err = max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        raise AssertionError(f"{kernel} at {shape_of(kernel, args)}: differs from its plain "
                             f"version by {err} (bar: identical)")
    return 0.0


def measure(calls, bound, kernel_ms=queued_ms, plain_ms=lambda fn: wall_ms(fn, reps=1)):
    """Per kernel (and "fps_level"): each call checked, the kernel timed by
    kernel_ms(fn) and the plain version by plain_ms(fn) (one call after a
    warm-up: the plain FPS takes about 0.15 s), with the sums per
    reconstruct; bound(bytes, ops) is chip_smoke.py's."""
    out = {}
    for kernel, arg_list in calls.items():
        name = "fps" if kernel == "fps_level" else kernel
        rows = []
        for args in arg_list:
            err = check_call(kernel, args)
            with torch.no_grad():
                ms = kernel_ms(lambda: _KERNEL[name](*args))
                plain = plain_ms(lambda: _PLAIN[name](*args))
            bound_ms, bound_by = bound(*work(kernel, args))
            row = dict(shape=shape_of(kernel, args), ms=ms, plain_ms=plain,
                       bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            if name == "fps":
                steps = args[1] - 1
                row.update(ns_per_step=ms * 1e6 / steps, bound_ns_per_step=bound_ms * 1e6 / steps)
            rows.append(row)
        out[kernel] = dict(
            launches=len(rows), calls=rows,
            ms_per_reconstruct=sum(r["ms"] for r in rows),
            plain_ms_per_reconstruct=sum(r["plain_ms"] for r in rows),
            bound_ms_per_reconstruct=sum(r["bound_ms"] for r in rows),
            max_abs_err=max(r["max_abs_err"] for r in rows))
    return out


def capture_sa_calls(params, x):
    """The arguments (t, u, gidx, sp) of the ten sa_fused calls of an
    ``sa_impl="fused"`` encode of x (the default config otherwise)."""
    from ..models.caspr import CaSPRConfig, CaSPRModel

    model = CaSPRModel(CaSPRConfig(sa_impl="fused"), device=x.device.type)
    calls = []
    real = kernels.sa_fused

    def record(*args):
        calls.append(args)
        return real(*args)

    kernels.sa_fused = record
    try:
        with torch.no_grad():
            model.encode(params, x)
    finally:
        kernels.sa_fused = real
    return calls


def sa_work(args):
    """(bytes, conv operations, elementwise operations) of one sa_fused
    call: t, u, the indices, the weights after conv1 and the (B, M, d3)
    maxima each moved once; conv2 and conv3 at 2 operations a multiply-add;
    about 8 operations an activation for the subtraction, the GroupNorms
    and the ReLUs."""
    t, u, gidx, sp = args
    b, m, k = gidx.shape
    d1, d2, d3 = (c["weight"].shape[0] for c in sp["convs"])
    rows = b * m * k
    weights = sum(v.numel() for part in ("convs", "norms") for layer in sp[part][1:]
                  for v in layer.values()) + 2 * d1
    moved = (t.numel() + u.numel() + gidx.numel() + weights + b * m * d3) * 4.0
    return moved, 2.0 * rows * (d1 * d2 + d2 * d3), 8.0 * rows * (d1 + d2 + d3)


def check_sa_call(args):
    """sa_fused against its plain version in float64: each output within
    1e-4 of its largest magnitude, and two launches give the same bits.
    Returns (kernel's, float32 plain version's) relative error and the
    kernel's largest absolute error."""
    from ..ops.sa_fused import sa_stack_plain

    t, u, gidx, sp = args
    with torch.no_grad():
        got = kernels.sa_fused(*args)
        if not torch.equal(got, kernels.sa_fused(*args)):
            raise AssertionError(f"sa_fused {tuple(gidx.shape)}: two launches differ")
        sp64 = {part: [{k: v.double() for k, v in layer.items()} for layer in sp[part]]
                for part in ("convs", "norms")}
        exact = sa_stack_plain(t.double(), u.double(), gidx, sp64)
        plain = sa_stack_plain(t, u, gidx, sp)
    largest = float(exact.abs().max())
    err = float((got.double() - exact).abs().max())
    rel = err / largest
    if not rel <= 1e-4:
        raise AssertionError(f"sa_fused {tuple(gidx.shape)}: relative error against float64 "
                             f"{rel} > 1e-4")
    return rel, float((plain.double() - exact).abs().max()) / largest, err


def measure_sa(calls, bound, kernel_ms=queued_ms, plain_ms=lambda fn: wall_ms(fn, reps=3)):
    """Each sa_fused call checked (check_sa_call) and timed, with its
    bounds: bound(bytes, ops, 0, tensor_ops) is chip_smoke.py's, the convs
    counted as three TF32 passes on the tensor cores, and beside it the
    float32 bound (the convs on CUDA cores); the sums over the calls."""
    from ..ops.sa_fused import sa_stack_plain

    rows = []
    for args in calls:
        rel, plain_rel, err = check_sa_call(args)
        t, u, gidx, sp = args
        moved, conv, elementwise = sa_work(args)
        d1, d2, d3 = (c["weight"].shape[0] for c in sp["convs"])
        with torch.no_grad():
            ms = kernel_ms(lambda: kernels.sa_fused(*args))
            plain = plain_ms(lambda: sa_stack_plain(t, u, gidx, sp))
        bound_ms, bound_by = bound(moved, elementwise, 0.0, 3.0 * conv)
        rows.append(dict(shape=f"B {gidx.shape[0]}, N {t.shape[1]}, M {gidx.shape[1]}, "
                               f"K {gidx.shape[2]}, widths {(d1, d2, d3)}",
                         ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                         f32_bound_ms=bound(moved, elementwise + conv)[0],
                         rel_err_vs_float64=rel, plain_rel_err_vs_float64=plain_rel,
                         max_abs_err=err))
    return dict(launches=len(rows), calls=rows,
                **{f"{key}_sum": sum(r[key] for r in rows)
                   for key in ("ms", "plain_ms", "bound_ms", "f32_bound_ms")},
                rel_err_vs_float64=max(r["rel_err_vs_float64"] for r in rows),
                plain_rel_err_vs_float64=max(r["plain_rel_err_vs_float64"] for r in rows),
                max_abs_err=max(r["max_abs_err"] for r in rows))


def encode_ms(params, x, modes=("xla", "fused")):
    """Milliseconds of one encode of x by SA mode: the median of five
    CUDA-event timings after a warm-up (host and card, whichever is
    longer)."""
    from ..models.caspr import CaSPRConfig, CaSPRModel

    out = {}
    for mode in modes:
        model = CaSPRModel(CaSPRConfig(sa_impl=mode), device="cuda")
        with torch.no_grad():
            out[mode] = wall_ms(lambda: model.encode(params, x), reps=5)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("encoder_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    from ..models.caspr import CaSPRConfig, CaSPRModel
    from ..weights import load_demo

    kernels.build()
    print(chip_smoke.card_line(), flush=True)
    model = CaSPRModel(CaSPRConfig(), device="cuda")
    params, state = load_demo(device=model.device)
    x, timestamps, gen = chip_smoke.reconstruct_input(torch)
    for kernel, row in measure(capture_calls(model, params, x), chip_smoke.bound).items():
        print(json.dumps({"kernel": kernel, **row}), flush=True)

    big = torch.rand((4, 16384, 3), generator=torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    print(json.dumps({"kernel": "fps", "shape": "(4, 16384, 3) -> 1024",
                      "ms": queued_ms(lambda: kernels.farthest_point_sampling(big, 1024))}),
          flush=True)

    sa = measure_sa(capture_sa_calls(params, x), chip_smoke.bound)
    print(json.dumps({"kernel": "sa_fused", **sa}), flush=True)
    print(json.dumps({"encode_ms_by_sa_impl": encode_ms(params, x)}), flush=True)

    def recon():
        return model.reconstruct(params, state, x, gen, num_points=chip_smoke.POINTS,
                                 timestamps=timestamps)

    recon()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        start = time.perf_counter()
        nfe = recon()[-1]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    chip_smoke.profile_path(torch, recon, sorted(walls)[1] * 1e3, "reconstruct B=4 T=10 N=2048",
                            nfe=list(nfe), focus=FOCUS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
