"""Where the tensor-core CNF kernel's time goes, by taking its parts away.

    python3 -m caspr_tpu_torch.checks.cnf_tc_breakdown        (needs a CUDA card and nvcc)

A kernel cannot be split by a profiler, so this builds variants of
``csrc/cnf_primal.cu`` (with ``csrc/cnf_tc.cuh``), each with one part of the
work removed, into ``caspr_tpu_torch/_build/breakdown/``, and times each in
both matmul modes (the 3xTF32 ``caspr_cnf_primal`` and the one-pass
``caspr_cnf_primal_bf16``) at ``chip_smoke.py``'s phase-2 shape (the trained
decoder, 40 clouds of 2048 points; median of 20 CUDA-event timings):

  - ``kernel``: the kernel as it is;
  - ``no_loads``: the weight slices are not copied (the ring's barriers
    still turn): what the L2 weight stream costs;
  - ``no_products``: no wgmma is issued: what the tensor cores cost;
  - ``no_softplus``: softplus is the identity (first layer and hidden
    epilogues);
  - ``no_promotion``: the per-slice partial sums are not added to the
    float32 accumulators (cnf_tc.cuh: layer_product; the bf16 mode has
    none, so there it times the kernel again);
  - ``no_softplus_no_promotion``: both.

The variants compute wrong values (each line prints its distance from the
kernel's); they exist only to be timed.  Prints one JSON line per variant
and mode.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import kernels
from .tf32x3_arithmetic import phase2_inputs

_LOAD = """  mbar_expect_tx(sm.full + 8 * stage, bytes);
  bulk_load(sm.stages + stage * bytes,
            static_cast<const unsigned char*>(w) + static_cast<size_t>(slice) * bytes, bytes,
            sm.full + 8 * stage);"""
_PRODUCTS = ("""      mma_m64n64k8(p, lo, b_hi, 0);
      mma_m64n64k8(p, hi, b_lo, 1);
      mma_m64n64k8(p, hi, b_hi, 1);""",
             "    mma_m64n64k16_bf16(acc[c], cur, b_desc(base + c * (kChunkN / 8) * 256), k > 0);")
_SOFTPLUS = "  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));"
_PROMOTION = ("          acc[c][i] += p[i];",
              "          acc[c - 1][i] += part[(c - 1) % kParts][i];",
              "        acc[NCH - 1][i] += part[(NCH - 1) % kParts][i];")


def variants(header: str) -> dict:
    """name -> the header's text with that part removed."""
    for piece in (_LOAD, *_PRODUCTS, _SOFTPLUS, *_PROMOTION):
        if piece not in header:
            raise RuntimeError(f"cnf_tc.cuh no longer holds {piece!r}: update this check")
    no_promotion = header
    for piece in _PROMOTION:
        no_promotion = no_promotion.replace(piece, "")
    no_products = header.replace(_PRODUCTS[0], "").replace(_PRODUCTS[1], "    (void)base;")
    return {
        "kernel": header,
        "no_loads": header.replace(
            _LOAD, "  (void)slice; (void)bytes; (void)w; mbar_arrive(sm.full + 8 * stage);"),
        "no_products": no_products,
        "no_softplus": header.replace(_SOFTPLUS, "  return x;"),
        "no_promotion": no_promotion,
        "no_softplus_no_promotion": no_promotion.replace(_SOFTPLUS, "  return x;"),
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


def build(out_dir) -> dict:
    """Compile every variant (all nvcc processes at once) -> name: library."""
    header = (kernels.CSRC / "cnf_tc.cuh").read_text()
    procs = {}
    for name, text in variants(header).items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "cnf_tc.cuh").write_text(text)
        (d / "cnf_primal.cu").write_text((kernels.CSRC / "cnf_primal.cu").read_text())
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "cnf_primal.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = out_dir / name / "lib.so"
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("cnf_tc_breakdown: no CUDA device", file=sys.stderr)
        return 2
    y, _, gb, wf, wh, wl = phase2_inputs(torch.device("cuda"))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = build(kernels.BUILD_DIR / "breakdown")
    for mode in ("f32", "bf16"):
        scratch = kernels._weights_scratch(wh, mode)
        reference = kernels.cnf_primal(y, gb, wf, wh, wl, mode)
        for name, path in libs.items():
            fn = getattr(ctypes.CDLL(str(path)), kernels._cnf_route("cnf_primal", mode)[1])
            fn.argtypes = [p] * 7 + [i] * 6 + [p]
            fn.restype = ctypes.c_int
            dx = torch.empty_like(y)

            def run():
                err = fn(y.data_ptr(), gb.data_ptr(), wf.data_ptr(), wh.data_ptr(),
                         wl.data_ptr(), scratch.data_ptr(), dx.data_ptr(), y.shape[0],
                         y.shape[1], wf.shape[0], y.shape[2], wh.shape[0], gb.shape[1],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name}: launch failed with cudaError_t {err}")

            ms = _ms(run)
            print(json.dumps({"variant": name, "matmul_dtype": mode, "ms": ms,
                              "max_abs_diff_from_kernel": float((dx - reference).abs().max()),
                              "shape": f"({y.shape[0]}, {y.shape[1]}, 3), H {wf.shape[0]}"}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
