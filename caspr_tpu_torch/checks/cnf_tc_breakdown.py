"""Where the tensor-core CNF kernels' time goes, by taking their parts away.

    python3 -m caspr_tpu_torch.checks.cnf_tc_breakdown [--parent DIR]   (needs a CUDA card and nvcc)
    python3 -m caspr_tpu_torch.checks.cnf_tc_breakdown --phases [--source CSRC]
    python3 -m caspr_tpu_torch.checks.cnf_tc_breakdown --launches [--parent DIR]

A kernel cannot be split by a profiler, so this builds variants of
``csrc/cnf_primal.cu``, ``csrc/cnf_dynamics.cu`` and
``csrc/cnf_dynamics_vjp.cu`` (with ``csrc/cnf_tc.cuh``), each with one part
of the work removed or changed, into ``caspr_tpu_torch/_build/breakdown/``,
and times each (median of 20 CUDA-event timings): the forward kernels in the
matmul modes each variant concerns (the 3xTF32 "f32" and the one-pass
"bf16") at ``chip_smoke.py``'s phase-2 shape (the trained decoder, 40 clouds
of 2048 points, H 512), the bf16 VJP at its training shape (25 clouds of
1024 points, the same weights), each of its launches alone:

  - ``kernel``: the kernels as they are;
  - ``no_loads``: the weight slices are copied into each ring buffer once
    and then no more (the rings' barriers still turn): what the L2 weight
    stream costs;
  - ``no_products``: no wgmma is issued (in the VJP neither the tile
    kernel's nor the weight-gradient product's): what the tensor cores cost;
  - ``no_softplus``: softplus (and in bf16 the tangent's sigmoid) is the
    identity in the hidden epilogues and the first layer (the float32
    ``cnf_dynamics`` keeps its inline softplus: f32 ``cnf_primal`` only);
  - ``no_promotion`` (f32, ``cnf_primal``): the per-slice partial sums are
    not added to the float32 accumulators (cnf_tc.cuh: layer_product);
  - ``exact_softplus`` (bf16): softplus and the sigmoids at float32
    accuracy (expf, log1pf, a division) instead of on the special-function
    units.  With it the bf16 kernels compute what a float32 tile rounded on
    every read computed (the bfloat16 mode's first design): the VJP's outputs are
    compared bit for bit with the parent's bf16 VJP where ``--parent`` is
    given;
  - ``pingpong`` (bf16 forward): the two warpgroups issue their products in
    turn, each running a chunk's epilogue while the other's products run,
    instead of side by side (two named barriers pass the turn; cnf_tc.cuh:
    layer_bf16 says why the kernel does not);
  - ``no_workspace_writes`` (the VJP): the tile kernel copies no tile to
    the workspace and stores no pre-gate product; the reverse sweep and the
    weight gradients read what the workspace held.

The variants compute wrong values (each line prints its distance from the
kernel's); they exist only to be timed.  Prints one JSON line per variant,
kernel and mode.

With ``--phases`` it builds the bf16 kernels with clock64 stamps at their
phase boundaries instead and prints, for one block (block 5 of cloud 20),
each warpgroup's cycles in each phase: of the forward kernels (phase 2's
launch) the ring's start, the first layer (with the inputs' and the last
layer's weights' loads), each hidden layer and the last layer; of the VJP's
tile kernel (its training launch) the first layer, each layer of the
forward recompute and of the reverse sweep (with the cycles of its
products), the last layer and dy -- for this checkout's design or, with
``--source`` a parent's csrc, for the parent's (the float32-tile design:
its products and epilogues apart).

With ``--launches`` it prints each kernel of one VJP call alone in both
matmul modes (torch.profiler's device time a launch), and the parent's with
``--parent``.

With ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked with
``git archive``) it also builds that checkout's ``cnf_primal.cu``,
``cnf_dynamics.cu`` and ``cnf_dynamics_vjp.cu`` and, on the same inputs,
holds the kernels bit for bit to the parent's (the bf16 VJP's
``exact_softplus`` variant to the parent's bf16 VJP), and
times parent and change in turns (parent, change, change, parent): both
forward kernels and the VJP in both modes.
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
             ("""      mma_m64n64k16_bf16_ss(acc, a_desc(a_base + kk * 2 * kTileLbo),
                            b_desc(b_base + j * kSliceT), m > 0 || j > 0);""",
              "      (void)kk; (void)b_base;"))
# the bfloat16 VJP's weight-gradient products (cnf_dynamics_vjp.cu)
_GEMM_PRODUCTS = ("""      mma_m64n128k16_tt(part[half], mn_desc(a0 + 512 * half), mn_desc(b0 + 512 * half), 0);
      mma_m64n128k16_tt(part[half], mn_desc(a0 + 512 * half + 256), mn_desc(b0 + 512 * half + 256),
                        1);""", "      (void)a0; (void)b0;")
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
_TURNS = ("""template <int NCH>
__device__ __forceinline__ void chunk_products(""", """__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(3 - wg) : "memory");
}

""")
_CHUNK_START = ("""    chunk_products<NCH>(acc, rg, w, a_base, layer, c, stages);
    epilogue_chunk(""", """    if ((threadIdx.x >> 7) == 1 || c > 0) wait_turn(threadIdx.x >> 7);
    chunk_products<NCH>(acc, rg, w, a_base, layer, c, stages);
    epilogue_chunk(""")
_CHUNK_END = ("""  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(rg.empty + 8 * (((layer * NCH + c) * spc + spc - 1) % kStagesT));""",
              """  if (wg == 0 || c < NCH - 1) pass_turn(wg);
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(rg.empty + 8 * (((layer * NCH + c) * spc + spc - 1) % kStagesT));""")
# the VJP's reverse sigmoid on the special-function units, and its exact form
_SIGMOID_SFU = """  const float u = ex2_sfu(fabsf(x) * -1.44269502f);
  const float r = rcp_sfu(1.f + u);
  return x >= 0.f ? r : u * r;"""
_SIGMOID_EXACT = """  const float ex = expf(-fabsf(x));
  return x >= 0.f ? 1.f / (1.f + ex) : ex / (1.f + ex);"""
# the bfloat16 VJP's workspace writes: the tile copies and the pre-gate products
_BULK_STORE = """  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");"""
_M_STORES = (("      if (m) m[(c >> 3) * 128", "      if (false) m[(c >> 3) * 128"),
             ("    m[(ch >> 3) * 128] = make_float4(a0, a1, a2, a3);\n", ""))

SOURCES = ("cnf_primal.cu", "cnf_dynamics.cu")
KERNELS = ("cnf_primal", "cnf_dynamics")
MODES = ("f32", "bf16")


def variants(header: str) -> dict:
    """name -> (the header's text with that part changed, the (kernel, mode)
    pairs it is timed for)."""
    pieces = (_LOAD, _LOAD_T, *(p for p, _ in _PRODUCTS), _SOFTPLUS, _SOFTPLUS_SFU, _SOFTPLUS_SIGMOID_SFU,
              *_PROMOTION, _TURNS[0], _CHUNK_START[0], _CHUNK_END[0], _SIGMOID_SFU, _BULK_STORE,
              _M_STORES[0][0])
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


def vjp_variants(header: str, source: str) -> dict:
    """The bfloat16 VJP's variants: name -> (cnf_tc.cuh's text, the VJP
    source's text).  ``exact_softplus`` also takes the reverse sweep's
    sigmoid exact: with both the variant computes what the parent's bfloat16
    VJP computed, bit for bit."""
    for piece in (_GEMM_PRODUCTS[0], _M_STORES[1][0]):
        if piece not in source:
            raise RuntimeError(f"cnf_dynamics_vjp.cu no longer holds {piece!r}: update this check")
    no_products = header
    for piece, stub in _PRODUCTS:
        no_products = no_products.replace(piece, stub)
    return {
        "kernel": (header, source),
        "exact_softplus": (header.replace(_SOFTPLUS_SIGMOID_SFU, _SOFTPLUS_SIGMOID_EXACT)
                           .replace(_SIGMOID_SFU, _SIGMOID_EXACT), source),
        "no_products": (no_products, source.replace(*_GEMM_PRODUCTS)),
        # the tile copies and the pre-gate products stop; the reverse sweep
        # and the weight gradients read what the workspace held before
        "no_workspace_writes": (header.replace(_BULK_STORE, "  (void)dst; (void)src; (void)bytes;")
                                .replace(*_M_STORES[0]), source.replace(*_M_STORES[1])),
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
    {(variant, source): library}: the forward variants of cnf_primal.cu and
    cnf_dynamics.cu, and ("vjp_" + name, "cnf_dynamics_vjp.cu") for the
    VJP's; with ``parent`` also ("parent", source) for the parent
    checkout's three CNF sources."""
    header = (kernels.CSRC / "cnf_tc.cuh").read_text()
    vjp_source = (kernels.CSRC / "cnf_dynamics_vjp.cu").read_text()
    common = (kernels.CSRC / "common.cuh").read_text()
    jobs = {}
    for name, (text, _) in variants(header).items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "cnf_tc.cuh").write_text(text)
        for src in SOURCES:
            (d / src).write_text((kernels.CSRC / src).read_text())
            jobs[name, src] = d / src
    for name, (text, source) in vjp_variants(header, vjp_source).items():
        d = out_dir / f"vjp_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "cnf_tc.cuh").write_text(text)
        (d / "common.cuh").write_text(common)
        (d / "cnf_dynamics_vjp.cu").write_text(source)
        jobs[f"vjp_{name}", "cnf_dynamics_vjp.cu"] = d / "cnf_dynamics_vjp.cu"
    if parent is not None:
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
        if key[0] in ("kernel", "vjp_kernel"):
            _print_registers(key[1], log)
    return libs


def build_parent_vjp(out_dir: Path, parent: Path) -> Path:
    """The parent checkout's VJP source, built alone -> its library."""
    lib = out_dir / "parent" / "cnf_dynamics_vjp.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    src = parent / "caspr_tpu_torch" / "csrc" / "cnf_dynamics_vjp.cu"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    return lib


def _print_registers(src, log):
    """ptxas's registers and spills of each CNF kernel in ``src``'s log."""
    function = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            function = m.group(1) if "kernel" in m.group(1) else None
        elif function and "registers" in line:
            name = re.search(r"\d+(cnf_\w+?_kernel|vjp_\w+?_kernel|wgrad_\w+?_kernel)I?(\w*)",
                             function)
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
    for name in ("caspr_cnf_dynamics_vjp_workspace", "caspr_cnf_dynamics_vjp_bf16_workspace"):
        if hasattr(lib, name):  # a parent checkout may lack the second
            getattr(lib, name).argtypes = [_I] * 5
            getattr(lib, name).restype = ctypes.c_longlong
    bt, n, d = y.shape
    h, num_hidden = wf.shape[0], wh.shape[0]
    wh_t = wh.transpose(1, 2).contiguous()
    dy, dgb = torch.empty_like(y), torch.empty_like(gb)
    dw = torch.empty(2 * h * d + num_hidden * h * h, dtype=torch.float32, device=y.device)
    if mode == "bf16" and not hasattr(lib, "caspr_cnf_dynamics_vjp_bf16_workspace"):
        mode_ws = "f32"  # the parent's bf16 variant shared the float32 workspace
    else:
        mode_ws = mode
    ws = kernels.vjp_workspace(lib, mode_ws, bt, n, h, d, num_hidden, y.device)

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
    """Parent against change: bits and times in turns (parent, change,
    change, parent), the forward kernels at phase 2's shape, the VJP at its
    training shape.  The kernels are held bit for bit to the parent's, but
    the bf16 VJP's exact_softplus build, which computes what the parent's
    bf16 VJP (the float32-tile design) computed."""
    rows = []
    for kernel in KERNELS:
        src = f"{kernel}.cu"
        for mode in MODES:
            parent = forward_call(libs["parent", src], kernel, mode, inputs)
            change = forward_call(libs["kernel", src], kernel, mode, inputs)
            same_as = "kernel"
            twin = forward_call(libs[same_as, src], kernel, mode, inputs)
            want = [t.clone() for t in parent()]
            got = [t.clone() for t in twin()]
            times = [_ms(fn, reps) for fn in (parent, change, change, parent)]
            rows.append({"ab": kernel, "matmul_dtype": mode, "bit_equal_to_parent": same_as,
                         "bit_equal": _bits_equal(got, want),
                         "max_abs_diff": _max_diff(got, want),
                         "ms_parent_change_change_parent": times})
    vjp_args = vjp_inputs(inputs)
    src = "cnf_dynamics_vjp.cu"
    for mode in MODES:
        parent = vjp_call(libs["parent", src], mode, vjp_args)
        change = vjp_call(libs["vjp_kernel", src], mode, vjp_args)
        same_as = "vjp_kernel" if mode == "f32" else "vjp_exact_softplus"
        twin = vjp_call(libs[same_as, src], mode, vjp_args)
        want = [t.clone() for t in parent()]
        got = [t.clone() for t in twin()]
        rows.append({"ab": "cnf_dynamics_vjp", "matmul_dtype": mode,
                     "shape": f"y, e, ct (25, 1024, 3), H {inputs[3].shape[0]}",
                     "bit_equal_to_parent": same_as,
                     "bit_equal_dy_dgb_dw": [bool(torch.equal(a.view(torch.int32),
                                                              b.view(torch.int32)))
                                             for a, b in zip(got, want)],
                     "max_abs_diff": _max_diff(got, want),
                     "ms_parent_change_change_parent": [_ms(fn, reps) for fn in
                                                        (parent, change, change, parent)]})
    return rows


# --phases: clock64 stamps in the bf16 kernels (text inserted at these
# places), read back through an extra C entry
_STAMP = ("__device__ long long caspr_clk[64];\n__device__ long long caspr_prod[64];\n"
          "#define STAMP(i) if ((threadIdx.x & 127) == 0 && blockIdx.x == 5 && blockIdx.y == 20) "
          "caspr_clk[(threadIdx.x >> 7) * 32 + (i)] = clock64();\n")
_STAMPS = (("  start_tile_ring(sm, w_tiled, ks, stages);\n",
            "  STAMP(0)\n  start_tile_ring(sm, w_tiled, ks, stages);\n  STAMP(1)\n"),
           ("  fence_async_smem();\n  consumer_sync();\n\n  // hidden layers",
            "  fence_async_smem();\n  consumer_sync();\n  STAMP(2)\n\n  // hidden layers"),
           ("    layer_bf16<NCH>(sm, w_tiled, l, stages, n_wg, epi);\n  }\n",
            "    layer_bf16<NCH>(sm, w_tiled, l, stages, n_wg, epi);\n    STAMP(3 + l)\n  }\n"),
           ("\n}\n\ntemplate <int NCH, bool kBf16>\ncudaError_t launch",
            "\n  STAMP(15)\n}\n\ntemplate <int NCH, bool kBf16>\ncudaError_t launch"))
# The VJP's tile kernel: a running stamp index (NEXT) through its phases, for
# each design of its bfloat16 variant: (anchor, text put before it, text put
# after it), and the phase names for a given number of hidden layers.
_NEXT = "STAMP(caspr_n) ++caspr_n;\n"
_VJP_STAMPS = {
    # the first design: the float32 tile shared with the float32 variant
    "float32_tile": (
        (("  start_ring<kBf16>(sm, w_prep, kHpad, 2 * num_hidden);\n",
          "  int caspr_n = 0;\n  " + _NEXT, "  " + _NEXT),
         ("\n  const int lane = tid & 31, wg = tid >> 7, w = (tid >> 5) & 3;\n", "  " + _NEXT, ""),
         ("    ring_product<NCH, kBf16, kOverlapParts>(acc, sm, w_prep, kHpad, l, products, n_wg);\n",
          "", "    " + _NEXT),
         ("    consumer_sync();  // the layer's output is in the tile\n", "", "    " + _NEXT),
         ("  consumer_sync();  // rowbuf holds dm of the last layer, last_part the warps' sums\n",
          "", "  " + _NEXT),
         ("  // ---- reverse sweep over the layers with H outputs ----\n", "  " + _NEXT, ""),
         ("    consumer_sync();  // dm of layer li is in the tile\n", "", "    " + _NEXT),
         ("    ring_product<NCH, kBf16, kOverlapParts>(acc, sm, w_prep, kHpad, products - li, products,\n"
          "                                            n_wg);\n", "", "    " + _NEXT),
         ("      if (k == lane && k < d) dy[base + p * d + k] = s[k];\n  }\n}\n",
          "", ""),),
        lambda nh: ["ring", "first_layer",
                    *(f"fwd_{part}_{l}" for l in range(nh) for part in ("product", "epilogue")),
                    "last_layer", "last_reverse",
                    *(name for li in range(nh, -1, -1)
                      for name in ((f"rev_epilogue_{li}",) + ((f"rev_product_{li}",) if li else ()))),
                    "dy"]),
}
# this design's layers also sum their chunks' product cycles (caspr_prod, by
# ring layer: the forward's 0 .. L-3, the reverse's L-2 .. 2 L-5)
_STAMPER = "(threadIdx.x & 127) == 0 && blockIdx.x == 5 && blockIdx.y == 20"
_VJP_STAMPS["tile_bf16"] = (
    (("  start_tile_ring(sm, ws.w_tiled, ks, stages);\n", "  int caspr_n = 0;\n  " + _NEXT,
      "  " + _NEXT),
     ("  stage_w_last(sm, w_last, h, d, kHpad);\n  consumer_sync();\n", "", "  " + _NEXT),
     ("  if (tid == 0) bulk_store(z_tile(0), tile_s, kTileBytes);\n", "", "  " + _NEXT),
     ("    if (tid == 0) bulk_store(z_tile(1 + l), tile_s, kTileBytes);\n", "", "    " + _NEXT),
     ("  float* dgb_part = ws.dgb_part + blk * kWarpParts * 2 * num_layers * h;\n", "  " + _NEXT,
      ""),
     ("    if (tid == 0) bulk_store(dm_tile(num_layers - 2), tile_s, kTileBytes);\n", "",
      "    " + _NEXT),
     ("    if (tid == 0) bulk_store(dm_tile(li), tile_s, kTileBytes);\n", "", "    " + _NEXT),
     ("  float acc[32];\n  uint32_t outp[NCH][16];\n", "", "  long long caspr_p = 0;\n"),
     ("    chunk_products<NCH>(acc, rg, w, a_base, layer, c, stages);\n",
      "    const long long caspr_t = clock64();\n", "    caspr_p += clock64() - caspr_t;\n"),
     ("  if (threadIdx.x == 0) bulk_wait_read();\n  store_layer<NCH>(sm, outp, n_wg);\n}\n",
      f"  if ({_STAMPER}) caspr_prod[(threadIdx.x >> 7) * 32 + layer] = caspr_p;\n", ""),
     ("  if (tid == 0) bulk_wait();  // the workspace copies are complete\n}\n", "", "")),
    lambda nh: ["ring", "inputs", "first_layer", *(f"fwd_layer_{l}" for l in range(nh)),
                "last_layer", *(f"rev_layer_{li}" for li in range(nh, -1, -1)), "dy"])
_READ = ('\nextern "C" int caspr_read_clk(long long* dst) {\n'
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, caspr_clk, sizeof(caspr_clk)));\n}\n"
         'extern "C" int caspr_read_prod(long long* dst) {\n'
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, caspr_prod, sizeof(caspr_prod)));\n}\n")


def _stamp_vjp(text: str):
    """The VJP source with its stamps, and the phase names, for whichever
    design it holds."""
    for design, (marks, names) in _VJP_STAMPS.items():
        if all(anchor in text for anchor, _, _ in marks):
            for anchor, before, after in marks:
                text = text.replace(anchor, before + anchor + after)
            # the stamp at the kernel's end, after dy
            end = marks[-1][0]
            text = text.replace(end, end[:-2] + "  " + _NEXT + "}\n")
            return design, text, names
    raise RuntimeError("cnf_dynamics_vjp.cu holds no design this check knows: update it")


def phases(out_dir, inputs, source: Path):
    """Build the stamped kernels (from ``source``, a csrc directory) and
    print each warpgroup's cycles a phase: the forward bf16 kernels at
    phase 2's shape, the bf16 VJP at its training shape."""
    header = (source / "cnf_tc.cuh").read_text()
    d = out_dir / "phases"
    d.mkdir(parents=True, exist_ok=True)
    (d / "cnf_tc.cuh").write_text(header)
    (d / "common.cuh").write_text((source / "common.cuh").read_text())
    texts = {}
    for src in SOURCES:
        text = _STAMP + (source / src).read_text()
        for old, new in _STAMPS:
            if old not in text:
                raise RuntimeError(f"{src} no longer holds {old!r}: update this check")
            text = text.replace(old, new)
        texts[src] = text
    design, text, vjp_names = _stamp_vjp((source / "cnf_dynamics_vjp.cu").read_text())
    texts["cnf_dynamics_vjp.cu"] = _STAMP + text
    procs = {}
    for src, text in texts.items():
        (d / src).write_text(text + _READ)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(d / f"{src}.so"),
               str(d / src)]
        procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for src, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the stamped {src}:\n{log}")
    num_hidden = inputs[4].shape[0]

    def read(lib_path):
        lib = ctypes.CDLL(str(lib_path))
        lib.caspr_read_clk.argtypes = [_P]
        clk = np.zeros(64, np.int64)
        lib.caspr_read_clk(clk.ctypes.data)
        return clk

    for kernel, src, rows in zip(KERNELS, SOURCES, (64, 32)):  # points a block
        run = forward_call(d / f"{src}.so", kernel, "bf16", inputs)
        ms = _ms(run, 10)
        run()
        torch.cuda.synchronize()
        clk = read(d / f"{src}.so")
        names = ["start", "first_layer", *(f"hidden_{l}" for l in range(num_hidden)), "last_layer"]
        marks = [0, 1, 2, *(3 + l for l in range(num_hidden)), 15]
        for wg in range(2):
            t = clk[wg * 32: wg * 32 + 32]
            cycles = {name: int(t[b] - t[a]) for name, a, b in zip(names, marks, marks[1:])}
            print(json.dumps({"phases": kernel, "matmul_dtype": "bf16", "warpgroup": wg,
                              "ms_stamped": ms, "cycles": cycles,
                              "block": f"cloud 20, points {5 * rows} on"}), flush=True)
    lib_path = d / "cnf_dynamics_vjp.cu.so"
    run = vjp_call(lib_path, "bf16", vjp_inputs(inputs))
    ms = _ms(run, 10)
    run()
    torch.cuda.synchronize()
    clk = read(lib_path)
    names = vjp_names(num_hidden)
    lib = ctypes.CDLL(str(lib_path))
    lib.caspr_read_prod.argtypes = [_P]
    prod = np.zeros(64, np.int64)
    lib.caspr_read_prod(prod.ctypes.data)
    for wg in range(2):
        t = clk[wg * 32: wg * 32 + 32]
        cycles = {name: int(t[i + 1] - t[i]) for i, name in enumerate(names)}
        row = {"phases": "cnf_dynamics_vjp", "design": design, "matmul_dtype": "bf16",
               "warpgroup": wg, "ms_stamped": ms, "cycles": cycles,
               "total_cycles": int(t[len(names)] - t[0]), "block": "cloud 20, points 160 on"}
        if design == "tile_bf16":  # of each layer's cycles, its products' (the ring's layers)
            row["product_cycles"] = {
                **{f"fwd_layer_{l}": int(prod[wg * 32 + l]) for l in range(num_hidden)},
                **{f"rev_layer_{li}": int(prod[wg * 32 + 2 * num_hidden - 1 - li])
                   for li in range(num_hidden)}}
        print(json.dumps(row), flush=True)


def vjp_inputs(inputs):
    """The VJP's arguments at its training shape (25 clouds of 1024 points,
    the trained decoder's weights and the first 25 clouds' gates of
    ``inputs``, y, e and the cotangents from seed 1)."""
    y, e, gb, wf, wh, wl = inputs
    gen = torch.Generator(device=y.device).manual_seed(1)
    bt, n = 25, 1024
    draw = lambda *shape: torch.randn(shape, generator=gen, device=y.device)
    return (draw(bt, n, 3), draw(bt, n, 3), gb[:bt].contiguous(), wf, wh, wl, draw(bt, n, 3),
            draw(bt, n))


def vjp_launches(lib_path, mode, args, reps):
    """Each kernel of one VJP call alone: device time per launch by kernel
    name (torch.profiler over ``reps`` calls), beside the call's own time
    (CUDA events, median)."""
    from torch.profiler import ProfilerActivity, profile

    run = vjp_call(lib_path, mode, args)
    call_ms = _ms(run, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        device_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if device_us and ev.count:
            # the profiler may miss a call's first events: the launches a
            # call makes are the count over the calls, rounded
            name = re.sub(r"\(anonymous namespace\)::", "", ev.key).split("(")[0]
            per_kernel[name] = {"ms_per_launch": device_us / ev.count / 1e3,
                                "launches_per_call": max(1, round(ev.count / reps))}
    return {"vjp_launches": str(lib_path), "matmul_dtype": mode, "ms_call": call_ms,
            "kernels": per_kernel,
            "ms_kernels_sum": sum(v["ms_per_launch"] * v["launches_per_call"]
                                  for v in per_kernel.values())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of the parent commit to hold the kernels against")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--phases", action="store_true",
                        help="time the bf16 kernels' phases in one block instead")
    parser.add_argument("--source", type=Path, default=kernels.CSRC,
                        help="with --phases: the csrc directory to stamp (default this one)")
    parser.add_argument("--launches", action="store_true",
                        help="only each launch of the bf16 VJP alone (and the parent's)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("cnf_tc_breakdown: no CUDA device", file=sys.stderr)
        return 2
    inputs = phase2_inputs(torch.device("cuda"))
    if args.phases:
        phases(kernels.BUILD_DIR / "breakdown", inputs, args.source)
        return 0
    if args.launches:
        libs = {"kernel": kernels.build()}
        if args.parent is not None:
            libs["parent"] = build_parent_vjp(kernels.BUILD_DIR / "breakdown", args.parent)
        for name, lib in libs.items():
            for mode in MODES:
                print(json.dumps({"build": name, **vjp_launches(lib, mode, vjp_inputs(inputs),
                                                                args.reps)}), flush=True)
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
    vjp_args = vjp_inputs(inputs)
    src = "cnf_dynamics_vjp.cu"
    reference = [t.clone() for t in vjp_call(libs["vjp_kernel", src], "bf16", vjp_args)()]
    for name in vjp_variants(header, (kernels.CSRC / src).read_text()):
        lib = libs[f"vjp_{name}", src]
        row = vjp_launches(lib, "bf16", vjp_args, args.reps)
        print(json.dumps({"variant": name, "kernel": "cnf_dynamics_vjp", "matmul_dtype": "bf16",
                          "ms": row["ms_call"], "ms_kernels": row["kernels"],
                          "max_abs_diff_from_kernel":
                          _max_diff(vjp_call(lib, "bf16", vjp_args)(), reference),
                          "shape": "y, e, ct (25, 1024, 3)"}), flush=True)
    if args.parent is not None:
        for row in ab(libs, inputs, args.reps):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
