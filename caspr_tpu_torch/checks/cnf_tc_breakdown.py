"""Where the tensor-core CNF kernels' time goes, by taking their parts away.

    python3 -m caspr_tpu_torch.checks.cnf_tc_breakdown [--parent DIR]   (needs a CUDA card and nvcc)

A kernel cannot be split by a profiler, so this builds variants of
``csrc/cnf_primal.cu`` and ``csrc/cnf_dynamics.cu`` (with ``csrc/cnf_tc.cuh``),
each with one part of the work removed or changed, into
``caspr_tpu_torch/_build/breakdown/``, and times each in the matmul modes it
concerns (the 3xTF32 "f32" and the one-pass "bf16") at ``chip_smoke.py``'s
phase-2 shape (the trained decoder, 40 clouds of 2048 points, H 512; median
of 20 CUDA-event timings):

  - ``kernel``: the kernels as they are;
  - ``no_loads``: the weight slices are copied into each ring buffer once
    and then no more (the rings' barriers still turn): what the L2 weight
    stream costs;
  - ``no_products``: no wgmma is issued: what the tensor cores cost;
  - ``no_softplus``: softplus (and in bf16 the tangent's sigmoid) is the
    identity in the hidden epilogues and the first layer (the float32
    ``cnf_dynamics`` keeps its inline softplus: f32 ``cnf_primal`` only);
  - ``no_promotion`` (f32, ``cnf_primal``): the per-slice partial sums are
    not added to the float32 accumulators (cnf_tc.cuh: layer_product);
  - ``exact_softplus`` (bf16): softplus and the sigmoid at float32 accuracy
    (expf, log1pf, a division) instead of on the special-function units.
    With it the bf16 kernels compute what a float32 tile rounded on every
    read computed: its outputs are compared bit for bit with the parent's
    bf16 kernels where ``--parent`` is given;
  - ``pingpong`` (bf16): the two warpgroups issue their products in turn,
    each running a chunk's epilogue while the other's products run, instead
    of side by side (two named barriers pass the turn; cnf_tc.cuh:
    layer_bf16 says why the kernel does not).

The variants compute wrong values (each line prints its distance from the
kernel's); they exist only to be timed.  Prints one JSON line per variant,
kernel and mode.

With ``--phases`` it builds the bf16 kernels with clock64 stamps at their
phase boundaries instead and prints, for one block of the phase-2 launch
(block 5 of cloud 20), each warpgroup's cycles in the ring's start,
the first layer (with the inputs' and the last layer's weights' loads),
each hidden layer and the last layer.

With ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked with
``git archive``) it also builds that checkout's ``cnf_primal.cu``,
``cnf_dynamics.cu`` and ``cnf_dynamics_vjp.cu`` and, on the same inputs,
holds the float32 kernels bit for bit to the parent's, the bf16 kernels'
``exact_softplus`` variant bit for bit to the parent's bf16 kernels, and
times parent and change in turns (parent, change, change, parent): both
forward kernels in both modes, and the VJP's bf16 variant at its training
shape (25 clouds of 1024 points).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import kernels
from .tf32x3_arithmetic import phase2_inputs

_LOAD = """  mbar_expect_tx(sm.full + 8 * stage, bytes);
  bulk_load(sm.stages + stage * bytes,
            static_cast<const unsigned char*>(w) + static_cast<size_t>(slice) * bytes, bytes,
            sm.full + 8 * stage);"""
# the bfloat16 forward tile's rings (cnf_tc.cuh: load_tslice)
_LOAD_T = """  mbar_expect_tx(rg.full + 8 * stage, kStageT);
  bulk_load(dst, src + static_cast<size_t>(kk) * kSliceT, head * kSliceT, rg.full + 8 * stage);
  if (head < kSubT) bulk_load(dst + head * kSliceT, src, (kSubT - head) * kSliceT, rg.full + 8 * stage);"""
_PRODUCTS = (("""      mma_m64n64k8(p, lo, b_hi, 0);
      mma_m64n64k8(p, hi, b_lo, 1);
      mma_m64n64k8(p, hi, b_hi, 1);""", ""),
             ("    mma_m64n64k16_bf16(acc[c], cur, b_desc(base + c * (kChunkN / 8) * 256), k > 0);",
              "    (void)base;"),
             ("""        mma_m64n64k16_bf16_ss(acc, a_desc(a_base + kk * 2 * kTileLbo),
                              b_desc(b_base + j * kSliceT), m > 0 || j > 0);""",
              "        (void)kk; (void)b_base;"))
_SOFTPLUS = "  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));"
_SOFTPLUS_SFU = """  const float u = ex2_sfu(fabsf(x) * -1.44269502f);
  return fmaxf(x, 0.f) + log1p_sfu(u, 1.f + u);"""
_SOFTPLUS_SIGMOID_SFU = """  const float u = ex2_sfu(fabsf(x) * -1.44269502f);
  const float w = 1.f + u;
  const float r = rcp_sfu(w);
  sig = x >= 0.f ? r : u * r;
  sp = fmaxf(x, 0.f) + log1p_sfu(u, w);"""
# the float32-accurate forms: softplus, and the sigmoid as the float32
# kernel forms it (cnf_dynamics.cu)
_SOFTPLUS_SIGMOID_EXACT = """  const float ex = expf(-fabsf(x));
  sig = x >= 0.f ? 1.f / (1.f + ex) : ex / (1.f + ex);
  sp = fmaxf(x, 0.f) + log1pf(ex);"""
_PROMOTION = ("          acc[c][i] += p[i];",
              "          acc[c - 1][i] += part[(c - 1) % kParts][i];",
              "        acc[NCH - 1][i] += part[(NCH - 1) % kParts][i];")
# the ping-pong: the turn of warpgroup wg to issue products is named barrier
# 2 + wg (its 128 threads wait, the other warpgroup's 128 arrive)
_TURNS = ("""template <int NCH, class Epi>
__device__ __forceinline__ void layer_bf16(""", """__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(3 - wg) : "memory");
}

""")
_CHUNK_START = ("""  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int m = 0; m < spc; ++m) {""", """  for (int c = 0; c < NCH; ++c) {
    if (wg == 1 || c > 0) wait_turn(wg);
#pragma unroll
    for (int m = 0; m < spc; ++m) {""")
_CHUNK_END = ("""    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(rg.empty + 8 * (((layer * NCH + c) * spc + spc - 1) % kStagesT));""",
              """    if (wg == 0 || c < NCH - 1) pass_turn(wg);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(rg.empty + 8 * (((layer * NCH + c) * spc + spc - 1) % kStagesT));""")

SOURCES = ("cnf_primal.cu", "cnf_dynamics.cu")
KERNELS = ("cnf_primal", "cnf_dynamics")
MODES = ("f32", "bf16")


def variants(header: str) -> dict:
    """name -> (the header's text with that part changed, the (kernel, mode)
    pairs it is timed for)."""
    pieces = (_LOAD, _LOAD_T, *(p for p, _ in _PRODUCTS), _SOFTPLUS, _SOFTPLUS_SFU, _SOFTPLUS_SIGMOID_SFU,
              *_PROMOTION, _TURNS[0], _CHUNK_START[0], _CHUNK_END[0])
    for piece in pieces:
        if piece not in header:
            raise RuntimeError(f"cnf_tc.cuh no longer holds {piece!r}: update this check")
    every = [(k, m) for k in KERNELS for m in MODES]
    bf16 = [(k, "bf16") for k in KERNELS]
    no_products = header
    for piece, stub in _PRODUCTS:
        no_products = no_products.replace(piece, stub)
    no_promotion = header
    for piece in _PROMOTION:
        no_promotion = no_promotion.replace(piece, "")
    return {
        "kernel": (header, every),
        # each ring buffer is filled once (finite values for the math), then
        # the copies stop
        "no_loads": (header.replace(
            _LOAD, "  if (s >= kS) { (void)slice; mbar_arrive(sm.full + 8 * stage); return; }\n" + _LOAD)
            .replace(_LOAD_T, "  if (s >= kStagesT) { (void)src; (void)dst; (void)head; "
                              "mbar_arrive(rg.full + 8 * stage); return; }\n" + _LOAD_T), every),
        "no_products": (no_products, every),
        "no_softplus": (header.replace(_SOFTPLUS, "  return x;")
                        .replace(_SOFTPLUS_SFU, "  return x;")
                        .replace(_SOFTPLUS_SIGMOID_SFU, "  sp = x;\n  sig = 1.f;"),
                        [("cnf_primal", "f32"), *bf16]),
        "no_promotion": (no_promotion, [("cnf_primal", "f32")]),
        "exact_softplus": (header.replace(_SOFTPLUS_SFU, _SOFTPLUS)
                           .replace(_SOFTPLUS_SIGMOID_SFU, _SOFTPLUS_SIGMOID_EXACT), bf16),
        "pingpong": (header.replace(_TURNS[0], _TURNS[1] + _TURNS[0])
                     .replace(*_CHUNK_START).replace(*_CHUNK_END), bf16),
    }


def _ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def build(out_dir: Path, parent: Path | None = None) -> dict:
    """Compile every (variant, source), one nvcc process each, all at once ->
    {(variant, source): library}; with ``parent`` also ("parent", source) for
    the parent checkout's three CNF sources, and ("kernel",
    "cnf_dynamics_vjp.cu") for this one's VJP."""
    header = (kernels.CSRC / "cnf_tc.cuh").read_text()
    jobs = {}
    for name, (text, _) in variants(header).items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "cnf_tc.cuh").write_text(text)
        for src in SOURCES:
            (d / src).write_text((kernels.CSRC / src).read_text())
            jobs[name, src] = d / src
    if parent is not None:
        d = out_dir / "kernel"
        for f in ("cnf_dynamics_vjp.cu", "common.cuh"):
            (d / f).write_text((kernels.CSRC / f).read_text())
        jobs["kernel", "cnf_dynamics_vjp.cu"] = d / "cnf_dynamics_vjp.cu"
        for src in (*SOURCES, "cnf_dynamics_vjp.cu"):
            jobs["parent", src] = parent / "caspr_tpu_torch" / "csrc" / src
    procs = {}
    for (name, src), path in jobs.items():
        lib = out_dir / name / f"{Path(src).stem}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(path)]
        procs[name, src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = lib
        if key[0] == "kernel":
            _print_registers(key[1], log)
    return libs


def _print_registers(src, log):
    """ptxas's registers and spills of each CNF kernel in ``src``'s log."""
    function = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            function = m.group(1) if "kernel" in m.group(1) else None
        elif function and "registers" in line:
            name = re.search(r"\d+(cnf_\w+?_kernel|vjp_tile_kernel|wgrad_tc_kernel)I?(\w*)", function)
            print(json.dumps({"ptxas": src, "function": name.group(0) if name else function,
                              "registers": int(re.search(r"Used (\d+) registers", line).group(1))}),
                  flush=True)
        elif function and "spill" in line:
            print(json.dumps({"ptxas": src, "spills": line.strip()}), flush=True)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _entry(lib_path, kernel, mode):
    fn = getattr(ctypes.CDLL(str(lib_path)), kernels._cnf_route(kernel, mode)[1])
    fn.argtypes = kernels._SIGNATURES[kernels._cnf_route(kernel, mode)[1]]
    fn.restype = ctypes.c_int
    return fn


def forward_call(lib_path, kernel, mode, inputs):
    """A function that launches ``kernel`` in ``mode`` from ``lib_path`` on
    ``inputs`` (phase2_inputs's) and returns its outputs."""
    y, e, gb, wf, wh, wl = inputs
    fn = _entry(lib_path, kernel, mode)
    scratch = kernels._weights_scratch(wh, mode)
    dx = torch.empty_like(y)
    div = torch.empty(y.shape[:2], dtype=torch.float32, device=y.device)
    dims = (y.shape[0], y.shape[1], wf.shape[0], y.shape[2], wh.shape[0], gb.shape[1])

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "cnf_primal":
            args = (y, gb, wf, wh, wl, scratch, dx)
        else:
            args = (y, e, gb, wf, wh, wl, scratch, dx, div)
        err = fn(*(a.data_ptr() for a in args), *dims, stream)
        if err:
            raise RuntimeError(f"{lib_path} {kernel} {mode}: launch failed with cudaError_t {err}")
        return (dx,) if kernel == "cnf_primal" else (dx, div)
    return run


def vjp_call(lib_path, mode, args):
    """ops.kernels.cnf_dynamics_vjp's launch, from ``lib_path``."""
    y, e, gb, wf, wh, wl, ct_dx, ct_div = args
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, kernels._cnf_route("cnf_dynamics_vjp", mode)[1])
    fn.argtypes = kernels._SIGNATURES[kernels._cnf_route("cnf_dynamics_vjp", mode)[1]]
    fn.restype = ctypes.c_int
    lib.caspr_cnf_dynamics_vjp_workspace.argtypes = [_I] * 5
    lib.caspr_cnf_dynamics_vjp_workspace.restype = ctypes.c_longlong
    bt, n, d = y.shape
    h, num_hidden = wf.shape[0], wh.shape[0]
    wh_t = wh.transpose(1, 2).contiguous()
    dy, dgb = torch.empty_like(y), torch.empty_like(gb)
    dw = torch.empty(2 * h * d + num_hidden * h * h, dtype=torch.float32, device=y.device)
    ws = torch.empty(lib.caspr_cnf_dynamics_vjp_workspace(bt, n, h, d, num_hidden),
                     dtype=torch.float32, device=y.device)

    def run():
        err = fn(*(a.data_ptr() for a in (y, e, gb, wf, wh_t, wh, wl, ct_dx, ct_div, dy, dgb,
                                          dw, ws)),
                 bt, n, h, d, num_hidden, gb.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path} vjp {mode}: launch failed with cudaError_t {err}")
        return dy, dgb, dw
    return run


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), z.view(torch.int32)) for x, z in zip(a, b))


def _max_diff(a, b) -> float:
    return max(float((x - z).abs().max()) for x, z in zip(a, b))


def ab(libs, inputs, reps):
    """Parent against change: bits and times in turns."""
    y, e, gb, wf, wh, wl = inputs
    rows = []
    for kernel in KERNELS:
        src = f"{kernel}.cu"
        for mode in MODES:
            parent = forward_call(libs["parent", src], kernel, mode, inputs)
            change = forward_call(libs["kernel", src], kernel, mode, inputs)
            same_as = "kernel"
            if mode == "bf16":  # the parent's bf16 kernel is the exact-softplus one
                same_as = "exact_softplus"
            twin = forward_call(libs[same_as, src], kernel, mode, inputs)
            want = [t.clone() for t in parent()]
            got = [t.clone() for t in twin()]
            times = [_ms(fn, reps) for fn in (parent, change, change, parent)]
            rows.append({"ab": kernel, "matmul_dtype": mode, "bit_equal_to_parent": same_as,
                         "bit_equal": _bits_equal(got, want),
                         "max_abs_diff": _max_diff(got, want),
                         "ms_parent_change_change_parent": times})
    gen = torch.Generator(device=y.device).manual_seed(1)
    bt, n = 25, 1024
    draw = lambda *shape: torch.randn(shape, generator=gen, device=y.device)
    vjp_args = (draw(bt, n, 3), draw(bt, n, 3), gb[:bt].contiguous(), wf, wh, wl,
                draw(bt, n, 3), draw(bt, n))
    parent = vjp_call(libs["parent", "cnf_dynamics_vjp.cu"], "bf16", vjp_args)
    change = vjp_call(libs["kernel", "cnf_dynamics_vjp.cu"], "bf16", vjp_args)
    want = [t.clone() for t in parent()]
    got = [t.clone() for t in change()]
    rows.append({"ab": "cnf_dynamics_vjp", "matmul_dtype": "bf16",
                 "shape": f"y, e, ct ({bt}, {n}, 3), H {wf.shape[0]}",
                 "bit_equal": _bits_equal(got, want), "max_abs_diff": _max_diff(got, want),
                 "ms_parent_change_change_parent": [_ms(fn, reps) for fn in
                                                    (parent, change, change, parent)]})
    return rows


# --phases: clock64 stamps in the bf16 kernels (text inserted at these
# places), read back through an extra C entry
_STAMP = ("__device__ long long caspr_clk[32];\n"
          "#define STAMP(i) if ((threadIdx.x & 127) == 0 && blockIdx.x == 5 && blockIdx.y == 20) "
          "caspr_clk[(threadIdx.x >> 7) * 16 + (i)] = clock64();\n")
_STAMPS = (("  start_tile_ring(sm, w_tiled, ks, stages);\n",
            "  STAMP(0)\n  start_tile_ring(sm, w_tiled, ks, stages);\n  STAMP(1)\n"),
           ("  fence_async_smem();\n  consumer_sync();\n\n  // hidden layers",
            "  fence_async_smem();\n  consumer_sync();\n  STAMP(2)\n\n  // hidden layers"),
           ("    layer_bf16<NCH>(sm, w_tiled, l, stages, n_wg, epi);\n  }\n",
            "    layer_bf16<NCH>(sm, w_tiled, l, stages, n_wg, epi);\n    STAMP(3 + l)\n  }\n"),
           ("\n}\n\ntemplate <int NCH, bool kBf16>\ncudaError_t launch",
            "\n  STAMP(15)\n}\n\ntemplate <int NCH, bool kBf16>\ncudaError_t launch"))
_READ = ('\nextern "C" int caspr_read_clk(long long* dst) {\n'
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, caspr_clk, sizeof(caspr_clk)));\n}\n")


def phases(out_dir, inputs):
    """Build the stamped kernels and print each warpgroup's cycles a phase."""
    header = (kernels.CSRC / "cnf_tc.cuh").read_text()
    d = out_dir / "phases"
    d.mkdir(parents=True, exist_ok=True)
    (d / "cnf_tc.cuh").write_text(header)
    procs = {}
    for src in SOURCES:
        text = _STAMP + (kernels.CSRC / src).read_text()
        for old, new in _STAMPS:
            if old not in text:
                raise RuntimeError(f"{src} no longer holds {old!r}: update this check")
            text = text.replace(old, new)
        (d / src).write_text(text + _READ)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(d / f"{src}.so"),
               str(d / src)]
        procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for src, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the stamped {src}:\n{log}")
    num_hidden = inputs[4].shape[0]
    for kernel, src, rows in zip(KERNELS, SOURCES, (64, 32)):  # points a block
        run = forward_call(d / f"{src}.so", kernel, "bf16", inputs)
        ms = _ms(run, 10)
        run()
        torch.cuda.synchronize()
        lib = ctypes.CDLL(str(d / f"{src}.so"))
        lib.caspr_read_clk.argtypes = [_P]
        clk = np.zeros(32, np.int64)
        lib.caspr_read_clk(clk.ctypes.data)
        names = ["start", "first_layer", *(f"hidden_{l}" for l in range(num_hidden)), "last_layer"]
        marks = [0, 1, 2, *(3 + l for l in range(num_hidden)), 15]
        for wg in range(2):
            t = clk[wg * 16: wg * 16 + 16]
            cycles = {name: int(t[b] - t[a]) for name, a, b in zip(names, marks, marks[1:])}
            print(json.dumps({"phases": kernel, "matmul_dtype": "bf16", "warpgroup": wg,
                              "ms_stamped": ms, "cycles": cycles,
                              "block": f"cloud 20, points {5 * rows} on"}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of the parent commit to hold the kernels against")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--phases", action="store_true",
                        help="time the bf16 kernels' phases in one block instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("cnf_tc_breakdown: no CUDA device", file=sys.stderr)
        return 2
    inputs = phase2_inputs(torch.device("cuda"))
    if args.phases:
        phases(kernels.BUILD_DIR / "breakdown", inputs)
        return 0
    libs = build(kernels.BUILD_DIR / "breakdown", args.parent)
    header = (kernels.CSRC / "cnf_tc.cuh").read_text()
    shape = f"({inputs[0].shape[0]}, {inputs[0].shape[1]}, 3), H {inputs[3].shape[0]}"
    for kernel in KERNELS:
        for mode in MODES:
            reference = [t.clone() for t in
                         forward_call(libs["kernel", f"{kernel}.cu"], kernel, mode, inputs)()]
            for name, (_, pairs) in variants(header).items():
                if (kernel, mode) not in pairs:
                    continue
                run = forward_call(libs[name, f"{kernel}.cu"], kernel, mode, inputs)
                ms = _ms(run, args.reps)
                print(json.dumps({"variant": name, "kernel": kernel, "matmul_dtype": mode,
                                  "ms": ms, "max_abs_diff_from_kernel":
                                  _max_diff(run(), reference), "shape": shape}), flush=True)
    if args.parent is not None:
        for row in ab(libs, inputs, args.reps):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
