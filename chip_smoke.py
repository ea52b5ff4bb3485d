#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (caspr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. print the card's name and power limit; build the ten CUDA kernels
     from caspr_tpu_torch/csrc and print the build time, and for the
     tensor-core kernels (cnf_primal, cnf_dynamics, the two product
     kernels of cnf_dynamics_vjp, and every instantiation of sa_fused)
     ptxas's registers, shared memory and spills and the count of their
     product instructions in the SASS (HGMMA, HMMA for sa_fused's
     mma.sync; none may spill or lack it);
  2. hold every kernel against its plain PyTorch version on the card, at
     the shapes of the batch-4 reconstruct and evaluation paths (the VJP at
     the training path's; sa_fused at all ten SA scale shapes of the
     reconstruct's encoder, on the phase-3 input, at a ragged last tile and
     at a shape only its generic instantiation takes, against its plain
     version in float64, timed queued behind a spin kernel with its
     tensor-core and float32 bounds; emd also at 12 pairs and at N + M =
     16384, fps also at N = 16384; ball_query also with balls that fill
     early and with 16384 sources, past one shared-memory chunk; three_nn
     also on duplicated points, on a grid, at Ns = 3, 2049 and 16384;
     three_interpolate bit-exact, also at C = 1030, its scalar walk), and
     time kernel, plain version and (where one PyTorch call computes the
     same function) the library call with CUDA events;
     the five encoder point-op kernels also at every shape one reconstruct
     launches them, captured from an encode of the phase-3 input (fps 1,
     ball_query 5, gather 11, three_nn 5, three_interpolate 5, and the five
     FPS calls of fps="level"; caspr_tpu_torch/checks/encoder_kernels.py),
     each held to its plain version and timed, with the sums per
     reconstruct beside the summed bound, and fps's time per step (these
     kernels are shorter than their wrappers' host work, so they are timed
     queued behind a spin kernel, back to back on the card);
  3. run full-width CaSPRModel.reconstruct (B=4, T=10, N=2048, trained
     weights from artifacts/demo_trained.pkl) with every launch count set
     to 0 just before, and check that each of its kernels ran and the
     output is finite and of the right shape; time three more runs, and
     profile one (device time by kernel, the card's idle share);
 3b. the same reconstruct with each SA mode (sa_impl "xla", "factored",
     "fused"), the launch counts set to 0 before each: sa_fused 10 times
     and gather once with "fused", gather 11 times and no sa_fused
     otherwise; the fused encode (z0, T-NOCS) against the factored one in
     relative L2; encode and reconstruct times and NFE per mode; one fused
     reconstruct profiled;
  4. run the evaluation path at full width with the same weights on
     synthetic protocol-shaped batches, the launch counts set to 0 before
     each step: (a) the shape-reconstruction protocol with observed steps
     0, 5, 9 (two batches of 4; Chamfer and EMD per frame; artifacts
     checked), with the batch time split between reconstruct, Chamfer and
     EMD and one batch profiled; (b) one batch of 4 through the likelihood
     path (run_one_epoch with an eval step: CaSPRModel.forward, the CNF
     with its Hutchinson divergence); (c) T-NOCS regression and pose
     RANSAC on one batch of 1;
  5. run one small reconstruct (B=1, T=2, N=2048, 512 decoded points) and
     one small forward (the same input, 2048 target points) on the card
     and on the CPU with the same base samples and noise: equal NFE,
     points and nll within 1e-3;
 5b. the CNF composition path (configs the fused kernels do not take:
     cnf_dims (16, 32) and (32,), random weights from a seed): the same
     small reconstruct and forward on the card and on the CPU, equal NFE,
     points and nll within 1e-3 of max(1, their largest magnitude), and no
     CNF kernel launched on the card;
  6. train at full width: fresh weights from caspr_init (seed 0), batches
     of 5 sequences x 5 frames x 1024 points in the form of bench.py's
     train step (uniform clouds, sorted times, input times x 5), three
     steps of run_one_epoch(mode="train") with every launch count set to 0
     before: the encoder's kernels, cnf_dynamics and cnf_dynamics_vjp must
     run (cnf_dynamics once per CNF evaluation, the VJP once per augmented
     one) and cnf_primal must not; the loss finite, every parameter moved;
     steps 2-3 timed and one more profiled (the VJP's kernels by name);
     one step from the trained demo
     weights; a checkpoint saved and read back;
 6b. train with sa_impl="fused": two steps at 5 x 5 x 1024 from caspr_init
     (seed 0), sa_fused launched 10 times a step, the loss finite, every
     parameter moved; the encoder's gradient of the T-NOCS loss through
     "fused" against "xla" on phase 7's input, in relative L2 within 4x the
     float32 floor of phase 7;
  7. one train step of a small full-width problem (demo weights, B=1, T=2,
     1024 input and target points, injected noise) on the card and on the
     CPU: loss within 1e-4 relative, equal forward and backward NFE, every
     gradient of the flow and the latent ODE within 1e-3 of its leaf's
     largest magnitude, the encoder's gradient within 4x the relative L2
     distance float32 keeps from float64 there (see cross_device_train);
  8. the command lines over a synthetic dataset tree in the demo format
     (caspr_tpu_torch/data/synthetic.py, seed 0: train 10, val 5 and test 6
     sequences of 10 frames x 4096 points, one test sequence of 3000-point
     frames among them, beside a 9-frame sequence and a BAD_MODELS model
     that the loader skips), each run with every launch count set to 0
     before it: (a) the
     test CLI in process with the demo weights at 10 x 2048, batch 4, all
     five protocols: fps, ball_query, gather, three_nn, three_interpolate,
     cnf_primal, cnf_dynamics and emd launched, sa_fused and
     cnf_dynamics_vjp not; each protocol's .npz finite and of its length,
     its .csv exactly the six test sequences (the padded last batch masked);
     seconds per protocol and the loader's wait per batch; (b) the same CLI
     as a subprocess with --eval-tnocs-regression, its .npz within 1e-5 of
     (a)'s; the train CLI at 5 x 5 x 1024 from caspr_init: (c) two epochs
     with validation and checkpoints every epoch (the encoder kernels,
     cnf_dynamics and cnf_dynamics_vjp launched, cnf_primal not; losses
     finite; BEST_time_model.pkl, time_model_{0,1}.pkl and the curve
     written), (d) one epoch resumed from time_model_1.pkl (the optimizer
     state restored), (e) one epoch with --ode-backward discrete
     (cnf_dynamics_vjp launched through autograd; cnf_dynamics launched
     exactly the logged forward NFE: the logged NFE is forward-only; the
     +0.5 exhaustion marker reported); seconds per train step, the
     loader's wait and the peak memory of each run;
  9. the viz command line and the pose scenes over a synthetic tree of two
     test sequences (seed 0) with the demo weights at 10 x 2048, each run
     with every launch count set to 0 before it: (a) the viz CLI in process
     with --viz-tnocs --tnocs-err-map --viz-observed --viz-interpolated
     (2048 decoded points, 30 times) and (b) --viz-observed
     --sample-contours over a one-sequence tree: fps, ball_query, gather,
     three_nn, three_interpolate, cnf_primal and emd launched, cnf_dynamics,
     its VJP and sa_fused not; every scene's directory holds its frames,
     viewer.html and an animation exactly where matplotlib imports (else
     the log says once that none was written), each frame the scene's
     vertex count (8768 for the reconstructions: 4 x 2048 + the two
     288-point cubes), all finite; the T-NOCS error, Chamfer and EMD
     finite; the contour scene in the palette's colours; each scene's model
     and export seconds; (c) the test CLI with --eval-pose-observed-ransac
     --show-pose-viz: one pose scene per sequence of 10 frames of 8320
     vertices; (d) the interpolated reconstruct at the viz settings (30
     times from cli.viz.interpolation_times, one base for every time,
     Gaussian and on the contour radii, 512 points) on the card and on the
     CPU: equal NFE, points and log-probabilities within 1e-3 of max(1,
     their largest magnitude); (e) cnf_primal at (30, 2048, 3) with this
     sequence's latent and emd at 10 pairs of 2048, held to their plain
     versions as in phase 2; (f) one interpolated scene timed, then under
     caspr_tpu_torch.utils.profiling.device_trace: wall, model and export
     seconds, device busy time, idle share and NFE;
 10. data parallelism (caspr_tpu_torch/parallel), with the kernels built
     in phase 1 before any rank starts (caspr_tpu_torch/checks/ranks.py
     runs each rank as a process of its own): (a) a train step from the
     demo weights, global batch 4 x 5 frames x 1024 points with injected
     noise, Adam at 1e-4, on two gloo ranks that share the card (nccl
     takes one rank a device), against the one-process step on the card
     on the same batch: NFE equal, loss within 1e-4 relative, every flow
     and latent-ODE gradient within 1e-3 of its leaf's largest, the
     encoder's in relative L2 within 4x phase 7's float32 floor, the two
     ranks' parameters, state and gradients bit-equal, the encoder
     kernels, cnf_dynamics and cnf_dynamics_vjp launched on both ranks;
     then the same with --ode-backward discrete; the collectives of a
     step by kind (calls and bytes); (b) the test CLI with --parallel on
     two such ranks over phase 8's tree (--eval-test and observed shape
     reconstruction, as phase 8 runs them, so that the generator gives
     the same noise and base samples; then T-NOCS regression and the pose
     protocol): rank 0 alone writes test_log.{txt,npz,csv} and
     test_log_RANSAC.{npz,csv} (rank 1 only rank1_test_log.txt), the
     .npz within 1e-5 of phase 8's one-process run (the pose's 1e-4
     relative), the .csv of its rows, ids identical and values within
     5e-6 of each (the pose's 1e-4), beside the smallest relative gap
     between two sequences' values (what rows out of order would show),
     the TEST loss within 1e-5 relative, the NFE equal, the reconstruct
     kernels and emd launched on both ranks; (c) the train CLI under torchrun (python -m
     torch.distributed.run --standalone --nproc_per_node 1) with
     --parallel --multihost, two epochs at 5 x 5 x 1024 on nccl: losses
     finite, the training kernels launched, the checkpoints written, the
     mesh logged; its seconds per step by epoch beside phase 8's
     one-process run's, and the phase's seconds;
 11. point parallelism on two gloo ranks sharing the card as (dp 1, sp 2):
     phase 10's train step (adjoint and discrete), the test and train
     command lines with --parallel --sp-size 2, a full-width reconstruct
     point-sharded against one process, and the CNF kernels at a rank's
     point counts (run_sp_path);
 12. the rest of the CNF (run_cnf_rest): (a) the reference-parity decode,
     reconstruct(..., sample_div=True) of phase 3's input and base samples
     with the demo weights: cnf_dynamics launched once per CNF evaluation
     and cnf_primal never, its NFE and seconds beside the default
     decode's from the same call, a second run identical, and phase 5's
     reconstruct with it on the card and on the CPU (equal NFE, points
     within 1e-3); (b) each layer type with softplus and each
     nonlinearity with concatsquash (12 configs, cnf_dims (16, 32), the
     gains of OTHER_CNF_GAIN): a decode of 2 x 512 points and a
     likelihood forward of 2 x 2048 with injected noise, conditioned on
     the demo model's latents of phase 5b's input, card against CPU
     (equal NFE, 1e-3 x max(1, the CPU's largest magnitude)), no CNF
     kernel launched; (c) the same 12 at (512, 512, 512), zdim 1600,
     decoding 40 x 2048 points on the demo model's latents of phase 3's
     input on the card (NFE, seconds, finite); (d) one adjoint step of a
     flow-only NLL for swish and for concat at that width, card against
     CPU with phase 7's bars (equal NFE, loss 1e-4 relative, every flow
     leaf and the context within 1e-3 of its largest);
 13. the CNF kernels' bfloat16 matmul mode (CaSPRConfig(cnf_matmul_dtype=
     "bf16"), run_bf16): (a) cnf_primal_bf16 and cnf_dynamics_bf16 at phase
     2's shapes, and cnf_dynamics_vjp_bf16 at row 10's (25 x 1024, the demo
     decoder, random cotangents), against their bfloat16 plain versions
     (each output within 2e-3 of its largest magnitude, within 1.5x the
     plain version's distance from float64, two launches bit-equal), timed
     with their bound at the bfloat16 rate, the VJP's kernels also each
     alone; all three also at H 128, 256, 384 and 512 with one and two
     hidden layers, and with D = 5 at H 256, on 8 clouds of 500 points (a
     ragged last tile) with the same bars, and the forward ones' softplus
     and sigmoid (cnf_tc.cuh's special-function forms, built into a probe)
     within 2^-16 relative of float64; (b) phase 3's reconstruct (its input and
     base samples, the demo weights) in bfloat16 beside float32, f32, bf16,
     bf16, f32, and the bfloat16 sample-div decode with phase 12's noise:
     NFE, seconds, the CNF launches (cnf_primal_bf16 once per CNF
     evaluation and no float32 CNF kernel; cnf_dynamics_bf16 alone in the
     sample-div decode), each mode's two runs identical, the distance from
     the float32 decode; (c) phase 5's reconstruct in bfloat16, card
     against CPU (CNF NFE within 6, latent NFE equal, points within 5e-3
     of their largest magnitude); (d) at 5 x 5 x 1024 one likelihood
     evaluation (demo weights) and one adjoint train step (caspr_init seed
     0, phase 6's first step) in bfloat16 beside float32 on the same
     inputs, and a third step with the VJP's products in bfloat16 too
     (cnf_bwd_matmul_dtype="bf16"): finite, the mode's cnf_dynamics kernel
     once per CNF evaluation, the VJP through the float32 cnf_dynamics_vjp
     in the first two steps and cnf_dynamics_vjp_bf16 alone, once per
     backward CNF evaluation, in the third; NFE, losses and seconds; (e)
     the bfloat16 adjoint gradient (forward and VJP) of the demo CNF block,
     a flow-only NLL of 2 x 256 points on the demo latents of phase 12,
     card against CPU (forward and backward NFE within 6, the loss within
     5e-3 of its magnitude, each leaf within 5e-3 of its largest; only the
     two bfloat16 kernels launched); (f) where bf16 applies: a bf16 config
     at (128,) x 5 (not the JAX package's can_fuse) launches the float32
     kernels, at (1024, 1024) (past the kernels' widths) none, at
     (512, 512, 512) the three bfloat16 variants, its fields within 2e-3 of
     the CPU's.

Then it prints its own seconds (from its first line of output on), one
JSON line listing every kernel and, last, the verdict line
{"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): device memory rate, float32 rate
# outside the tensor cores and TF32 and bfloat16 rates on them.  A card
# below its 700 W limit runs slower.
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
# exp, sqrt and the like go to the special-function units: 16 results per SM
# per clock against 128 fused multiply-adds (256 float32 operations).
SPECIAL_PER_S = F32_FLOPS_PER_S / 2 / 8

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
    "cnf_dynamics": ("caspr_tpu_torch/csrc/cnf_dynamics.cu",
                     "caspr_tpu/ops/cnf_fused.py:233"),
    "cnf_dynamics_vjp": ("caspr_tpu_torch/csrc/cnf_dynamics_vjp.cu",
                         "caspr_tpu/ops/cnf_fused.py:485"),
    "emd": ("caspr_tpu_torch/csrc/emd.cu",
            "caspr_tpu/ops/emd_pallas.py:133"),
    # one kernel for _sa3_call (here), _sa2_call (sa_fused2.py:228) and
    # _sa_call (sa_fused.py:163)
    "sa_fused": ("caspr_tpu_torch/csrc/sa_fused.cu",
                 "caspr_tpu/ops/sa_fused2.py:357"),
    # the bfloat16 variants (matmul_dtype="bf16") of the two forward CNF
    # kernels: the same sources and pallas_calls, run with matmul_dtype="bf16"
    "cnf_primal_bf16": ("caspr_tpu_torch/csrc/cnf_primal.cu",
                        "caspr_tpu/ops/cnf_fused.py:283"),
    "cnf_dynamics_bf16": ("caspr_tpu_torch/csrc/cnf_dynamics.cu",
                          "caspr_tpu/ops/cnf_fused.py:233"),
    # the VJP's bfloat16 variant (_fused_bwd_call with matmul_dtype="bf16")
    "cnf_dynamics_vjp_bf16": ("caspr_tpu_torch/csrc/cnf_dynamics_vjp.cu",
                              "caspr_tpu/ops/cnf_fused.py:485"),
}
RECONSTRUCT_KERNELS = ("fps", "ball_query", "gather", "three_nn", "three_interpolate",
                       "cnf_primal")
TRAIN_KERNELS = ("fps", "ball_query", "gather", "three_nn", "three_interpolate", "cnf_dynamics",
                 "cnf_dynamics_vjp")
# the training path's shapes (bench.py's train step, the reference recipe)
TRAIN_B, TRAIN_T, TRAIN_N = 5, 5, 1024


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# per source: its kernels whose products run on the tensor cores, and the
# SASS instruction of their products (wgmma: HGMMA; mma.sync: HMMA)
TENSOR_CORE_KERNELS = {
    "cnf_primal": (("cnf_primal_kernel", "cnf_primal_bf16_kernel"), "HGMMA"),
    "cnf_dynamics": (("cnf_dynamics_kernel", "cnf_dynamics_bf16_kernel"), "HGMMA"),
    "cnf_dynamics_vjp": (("vjp_tile_kernel", "wgrad_tc_kernel", "vjp_bf16_kernel",
                          "wgrad_bf16_kernel"), "HGMMA"),
    "sa_fused": (("sa_fused_kernel",), "HMMA"),
}
# the times of the kernels the last three versions redesigned, from their
# parent commits' kernels in each parent-against-change call
# (caspr_tpu_torch/checks/encoder_kernels.py, its first parent run; PERF.md:
# NVIDIA H100 80GB HBM3, 700.00 W): fps at (40, 2048, 3) -> 1024; gather,
# ball_query, three_interpolate and three_nn summed over one reconstruct's
# 11, 5, 5 and 5 launches; sa_fused summed over the ten SA scales
PARENT_MS = {"fps": 0.9489, "gather": 0.9374, "ball_query": 0.6191, "three_interpolate": 0.5244,
             "three_nn": 0.1587, "sa_fused": 13.65}


def build_facts(lib_path, build_dir):
    """Phase 1: for each tensor-core kernel, ptxas's registers, shared memory
    and spills of every instantiation (from the build's -Xptxas -v log), its
    warnings, and the count of its product instructions (HGMMA or HMMA) in
    its SASS (cuobjdump, where the toolkit has it; an instantiation without
    any fails)."""
    import shutil

    facts = []
    for name, (entries, opcode) in TENSOR_CORE_KERNELS.items():
        log = (build_dir / f"{name}.cu.log").read_text()
        current = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                current = m.group(1) if any(e in m.group(1) for e in entries) else None
                entry = next((e for e in entries if current and e in current), None)
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                args = [int(v) for v in re.findall(r"L[ib](\d+)E", current)]
                facts.append({"kernel": name, "function": entry, "mangled": current,
                              "opcode": opcode, "template_args": args,
                              "stack_bytes": int(m.group(1)), "spill_stores": int(m.group(2)),
                              "spill_loads": int(m.group(3))})
            m = re.search(r"Used (\d+) registers", line)
            if m and facts and facts[-1]["mangled"] == current:
                smem = re.search(r"(\d+) bytes smem", line)
                facts[-1].update(registers=int(m.group(1)),
                                 static_smem_bytes=int(smem.group(1)) if smem else 0)
        warnings = [w.strip() for w in log.splitlines() if "warning" in w.lower()]
        print(json.dumps({"ptxas": name, "warnings": warnings[:10]}), flush=True)
        # ptxas serialises wgmma where it cannot prove the accumulators idle
        # between issue and wait: the products would lose their overlap
        if any("wgmma" in w for w in warnings):
            raise AssertionError(f"{name}: ptxas serialised wgmma: {warnings}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}  # per function: {opcode: count}
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        current = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = m.group(1)
                counts[current] = {"HGMMA": 0, "HMMA": 0}
            elif current is not None:
                for op in counts[current]:
                    counts[current][op] += op in line
    for fact in facts:
        mangled = fact.pop("mangled")
        fact["in_sass"] = (counts.get(mangled, {}).get(fact["opcode"], 0) if counts
                           else "no cuobjdump")
        print(json.dumps({"build": "ptxas -v", **fact}), flush=True)
        what = f"{fact['function']} {fact['template_args']}"
        if fact["in_sass"] == 0:
            raise AssertionError(f"{what}: no {fact['opcode']} in its SASS")
        if fact["spill_stores"] or fact["spill_loads"]:
            raise AssertionError(f"{what}: spills")


def time_ms(torch, fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    from caspr_tpu_torch.checks.encoder_kernels import wall_ms

    return wall_ms(fn, reps)


def bound(bytes_moved: float, ops: float, special: float = 0.0, tensor_ops: float = 0.0,
          bf16_ops: float = 0.0):
    """Least time on the card for the work: (ms, what bounds it).  The
    operations take the longest of the float32 operations over the float32
    rate, the special-function evaluations over theirs, the TF32
    tensor-core operations over theirs and the bfloat16 ones over theirs."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = max(ops / F32_FLOPS_PER_S, special / SPECIAL_PER_S, tensor_ops / TF32_FLOPS_PER_S,
                bf16_ops / BF16_FLOPS_PER_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def cnf_case(torch, name, c, rows, hidden_layers, h):
    """One CNF kernel against its plain versions (``c``: run, plain,
    emulation, exact, streams, bytes, shape) over ``rows`` points of width
    ``h``: (a) each output within 1e-4 of its largest magnitude of the
    float32 plain version, (b) within 4x the distance the float32 plain
    version keeps from the float64 one, (c) two launches bit-equal.
    Returns its row: errors, times and work (the hidden layers as 3 TF32
    tensor-core passes; the float32 CUDA-core bound beside)."""
    got, plain = c["run"](), c["plain"]()
    if not all(torch.equal(a, b) for a, b in zip(got, c["run"]())):
        raise AssertionError(f"{name}: two launches on the same input differ")
    errs = [float((g - p).abs().max()) for g, p in zip(got, plain)]
    rels = [err / float(p.abs().max()) for err, p in zip(errs, plain)]
    dist = lambda a, x: float((a.double() - x).abs().max() / x.abs().max())
    vs64 = [dist(g, x) for g, x in zip(got, c["exact"])]
    plain_vs64 = [dist(p, x) for p, x in zip(plain, c["exact"])]
    emulation_vs64 = [dist(m, x) for m, x in zip(c["emulation"](), c["exact"])]
    if not max(rels) <= 1e-4:
        raise AssertionError(f"{name}: relative err against the float32 plain version {rels} > 1e-4")
    if not all(k <= 4.0 * p for k, p in zip(vs64, plain_vs64)):
        raise AssertionError(f"{name}: relative err against float64 {vs64} > 4 x the float32 "
                             f"plain version's {plain_vs64}")
    rows_r = c["streams"] * rows
    tc_ops = 3 * 2.0 * rows_r * hidden_layers * h * h
    edge_ops = 2.0 * rows_r * (3 * h + h * 3)
    return dict(
        max_abs_err=max(errs),
        tolerance="each output 1e-4 relative to its max magnitude of the float32 plain "
                  "version; within 4x the float32 plain version's distance from float64; "
                  "deterministic",
        rel_err_vs_plain=rels, rel_err_vs_float64=vs64, plain_rel_err_vs_float64=plain_vs64,
        tf32x3_emulation_rel_err_vs_float64=emulation_vs64,
        ms=time_ms(torch, c["run"]), plain_ms=time_ms(torch, c["plain"]), library_ms=None,
        work=(c["bytes"], edge_ops, 0.0, tc_ops),
        f32_bound_ms=bound(c["bytes"], edge_ops + tc_ops / 3)[0],
        shape=c["shape"],
    )


def emd_case(torch, a, b, reps=5):
    """EMD on the card against the float64 value of its plain version, in
    two steps.  The kernel's body compiled in float64 must agree with it to
    1e-9: the body is the algorithm.  The float32 kernel then differs from
    it by rounding, which the annealing amplifies: any float32 version, the
    plain one included, lands about 4e-5 in the mean and a few 1e-4 at worst
    from the float64 value, pair by pair.  So every pair is held to 1e-3 of
    its value, which an error of the algorithm would exceed, and the mean
    over the pairs to 2e-4, or twice the float32 plain version's own mean
    error where that is larger.  Two launches must give the same bits.
    Returns its row: errors, the kernel's time and its work."""
    from caspr_tpu_torch.ops import kernels
    from caspr_tpu_torch.ops.emd_plain import emd_plain

    pairs, n, m = a.shape[0], a.shape[1], b.shape[1]
    got = kernels.approx_match_emd(a, b)
    if not torch.equal(got, kernels.approx_match_emd(a, b)):
        raise AssertionError(f"emd {pairs} x {n} x {m}: two launches differ")
    want = emd_plain(a, b)
    exact = emd_plain(a.double(), b.double())
    body = kernels.approx_match_emd_float64(a.double(), b.double())
    body_err = float(((body - exact).abs() / exact).max())
    if not body_err <= 1e-9:
        raise AssertionError(f"emd {pairs} x {n} x {m}: the kernel's body in float64 is "
                             f"{body_err} from the plain version")
    kernel_rel = (got.double() - exact).abs() / exact
    plain_rel = (want.double() - exact).abs() / exact
    if not (float(kernel_rel.max()) <= 1e-3
            and float(kernel_rel.mean()) <= max(2.0 * float(plain_rel.mean()), 2e-4)):
        raise AssertionError(
            f"emd {pairs} x {n} x {m}: max / mean relative error against float64 "
            f"{float(kernel_rel.max())} / {float(kernel_rel.mean())} (plain float32: "
            f"{float(plain_rel.max())} / {float(plain_rel.mean())})")
    cluster = kernels.emd_cluster_size(pairs, n, device=a.device)
    # per (i, j, level) three sweeps, each with d2 (8 operations), the
    # exponent and the affinity's product and sum (3), the third also the
    # flow's factor and the cost's product, sum and max (5); special
    # functions: the three sweeps' exponentials (the affinity is not
    # stored, so each of the level's three dependent reductions needs it
    # anew) and the cost's square root.  The last level's affinity is
    # exp(0) = 1: no exponential, and d2 only for the cost (8 + 10).
    nm = float(pairs) * n * m
    return dict(
        shape=f"({pairs}, {n}, 3) x ({pairs}, {m}, 3) -> ({pairs},)",
        cluster=cluster, ctas=pairs * cluster,
        max_abs_err=float((got - want).abs().max()),
        float64_body_rel_err=body_err,
        rel_err_vs_float64=float(kernel_rel.max()),
        plain_rel_err_vs_float64=float(plain_rel.max()),
        mean_rel_err_vs_float64=float(kernel_rel.mean()),
        plain_mean_rel_err_vs_float64=float(plain_rel.mean()),
        rel_err_vs_plain=float(((got - want).abs() / want).max()),
        ms=time_ms(torch, lambda: kernels.approx_match_emd(a, b), reps=reps),
        work=((a.numel() + b.numel() + pairs) * 4.0, nm * (9 * (3 * 11 + 5) + 18),
              nm * (9 * 3 + 10)),
    )


def check_kernels(torch, gen):
    """Phase 2: every kernel against its plain version at path shapes."""
    from caspr_tpu_torch.checks import encoder_kernels
    from caspr_tpu_torch.checks import tf32x3_arithmetic as tf32x3
    from caspr_tpu_torch.checks.encoder_kernels import scanned_pairs
    from caspr_tpu_torch.ops import cnf_fused, kernels, pointops
    from caspr_tpu_torch.ops.emd_plain import emd_plain
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    f4 = 4.0
    rows = {}
    # the encoder's point-op kernels (and the gather's library call) are
    # shorter than their wrappers' host work: timed queued behind a spin
    queued_ms = encoder_kernels.queued_ms

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    # FPS: the one real FPS of the path (hier collapse), 2048 -> 1024
    xyz = rand(BT, POINTS, 3)
    m = 1024
    got = kernels.farthest_point_sampling(xyz, m)
    want = pointops.farthest_point_sampling(xyz, m)
    if not torch.equal(got, want):
        raise AssertionError(f"fps: {int((got != want).sum())} indices differ")
    # and a cloud past what shared memory holds (N = 16384: the kernel's
    # device-memory path), 4 clouds -> 1024
    big = rand(4, 16384, 3)
    if not torch.equal(kernels.farthest_point_sampling(big, m),
                       pointops.farthest_point_sampling(big, m)):
        raise AssertionError("fps at N = 16384: indices differ")
    big_work = (big.numel() * f4 + 4 * m * f4, 4 * (m - 1) * 16384 * 10.0)
    rows["fps"] = dict(
        max_abs_err=0.0, tolerance="indices identical", parent_ms=PARENT_MS["fps"],
        ms=queued_ms(lambda: kernels.farthest_point_sampling(xyz, m)),
        plain_ms=time_ms(torch, lambda: pointops.farthest_point_sampling(xyz, m)),
        library_ms=None,
        work=(BT * POINTS * 3 * f4 + BT * m * f4, BT * (m - 1) * POINTS * 10.0),
        shape=f"xyz ({BT}, {POINTS}, 3) -> ({BT}, {m})",
        large=dict(shape="xyz (4, 16384, 3) -> (4, 1024), device-memory path",
                   indices_identical=True,
                   ms=queued_ms(lambda: kernels.farthest_point_sampling(big, m)),
                   bound_ms=bound(*big_work)[0], bound_by=bound(*big_work)[1]),
    )
    rows["fps"].update(ns_per_step=rows["fps"]["ms"] * 1e6 / (m - 1),
                       bound_ns_per_step=bound(*rows["fps"]["work"])[0] * 1e6 / (m - 1))

    # ball query: SA level 1 (2048 sources, 1024 centroids, r .02/.05) and
    # level 5 (64 sources, 16 centroids, r .4/.8); 16 and 32 per ball.  Also
    # level 1's shape with r .2/.4, where nearly every ball fills within its
    # first few hundred sources (the early exit), and 4 clouds of 16384
    # sources (big) with 1024 centroids, past one shared-memory chunk (4096)
    ball = {}
    for name, (pts, n, mc, r1, r2) in {"level1": (xyz, 2048, 1024, 0.02, 0.05),
                                       "level5": (xyz, 64, 16, 0.4, 0.8),
                                       "early_fill": (xyz, 2048, 1024, 0.2, 0.4),
                                       "n16384": (big, 16384, 1024, 0.02, 0.05)}.items():
        src = pts[:, :n].contiguous()
        cen = pts[:, :mc].contiguous()
        nb = pts.shape[0]
        g1, g2 = kernels.ball_query_pair(src, cen, r1, 16, r2, 32)
        w1, w2 = pointops.ball_query_pair(src, cen, r1, 16, r2, 32)
        if not (torch.equal(g1, w1) and torch.equal(g2, w2)):
            raise AssertionError(f"ball query {name}: indices differ")
        pairs = scanned_pairs(src, cen,
                              [pointops.radius_sq(r1), pointops.radius_sq(r2)], [16, 32])
        ball[name] = dict(
            ms=queued_ms(lambda: kernels.ball_query_pair(src, cen, r1, 16, r2, 32)),
            plain_ms=time_ms(torch, lambda: pointops.ball_query_pair(src, cen, r1, 16, r2, 32)),
            work=((nb * n * 3 + nb * mc * 3 + nb * mc * 48) * f4, pairs * 10.0),
        )
        ball[name]["bound_ms"], ball[name]["bound_by"] = bound(*ball[name]["work"])
    # the single-radius form (kernels.ball_query, on the path with
    # bq_pair=False): level 1's second scale, r = .05, 32 per ball; indices
    # identical but in balls with a source within 1e-5 of r^2
    src, cen = xyz[:, :2048].contiguous(), xyz[:, :1024].contiguous()
    got = kernels.ball_query(src, cen, 0.05, 32)
    want = pointops.ball_query(src, cen, 0.05, 32)
    r2 = pointops.radius_sq(0.05)
    differ = (got != want).any(-1)
    near = ((pointops.pairwise_sqdist(cen, src) - r2).abs() <= 1e-5).any(-1)
    if bool((differ & ~near).any()):
        raise AssertionError(f"ball query, one radius: {int((differ & ~near).sum())} balls differ")
    single_work = ((BT * 2048 * 3 + BT * 1024 * 3 + BT * 1024 * 32) * f4,
                   scanned_pairs(src, cen, [r2], [32]) * 10.0)
    single = dict(
        ms=queued_ms(lambda: kernels.ball_query(src, cen, 0.05, 32)),
        plain_ms=time_ms(torch, lambda: pointops.ball_query(src, cen, 0.05, 32)),
        bound_ms=bound(*single_work)[0], bound_by=bound(*single_work)[1],
        balls_differing_in_the_band=int(differ.sum()),
        shape=f"level 1: ({BT}, 2048, 3) x ({BT}, 1024, 3), r .05 -> 32")
    rows["ball_query"] = dict(
        max_abs_err=0.0, tolerance="indices identical (one radius: but within 1e-5 of r^2)",
        ms=ball["level1"]["ms"], plain_ms=ball["level1"]["plain_ms"], library_ms=None,
        work=ball["level1"]["work"], parent_ms_per_reconstruct=PARENT_MS["ball_query"],
        shape=f"level 1: ({BT}, 2048, 3) x ({BT}, 1024, 3) -> 16 + 32; "
              f"level 5 ms {ball['level5']['ms']:.4f}, plain {ball['level5']['plain_ms']:.4f}",
        single_radius=single,
        early_fill=dict(shape="level 1, r .2 / .4", indices_identical=True,
                        **{k: ball["early_fill"][k] for k in ("ms", "bound_ms", "bound_by")}),
        large=dict(shape="(4, 16384, 3) x (4, 1024, 3), r .02 / .05, 4 chunks",
                   indices_identical=True,
                   **{k: ball["n16384"][k] for k in ("ms", "bound_ms", "bound_by")}),
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
        ms=queued_ms(lambda: kernels.gather_points(pts, idx)),
        plain_ms=time_ms(torch, lambda: pointops.gather_points(pts, idx)),
        library_ms=queued_ms(lambda: torch.take_along_dim(pts, idx64, dim=1)),
        work=((BT * POINTS * 9 + BT * r + BT * r * 9) * f4, 0.0),
        shape=f"({BT}, {POINTS}, 9) x ({BT}, {r}) -> ({BT}, {r}, 9)",
    )

    # three-NN: the finest FP level, 2048 queries against 1024 sources; then
    # ties (every source four times; coordinates on a 1/4 grid), Ns = 3, Ns
    # past one staged chunk of 2048 and (4, 16384) sources: indices
    # identical and distances exact (the same float32 operations, and the
    # plain version's stable sort order on equal distances)
    def three_nn_exact(name, q, s):
        gd, gi = kernels.three_nn(q, s)
        wd, wi = pointops.three_nn(q, s)
        if not torch.equal(gi, wi):
            raise AssertionError(f"three_nn {name}: {int((gi != wi).sum())} indices differ")
        if not torch.equal(gd, wd):
            raise AssertionError(f"three_nn {name}: distances differ by "
                                 f"{float((gd - wd).abs().max())}")

    def three_nn_work(q, s):
        b, nq, ns = q.shape[0], q.shape[1], s.shape[1]
        return (b * (nq + ns) * 3 + b * nq * 6) * f4, b * nq * ns * 9.0

    q, s = xyz, xyz[:, :1024].contiguous()
    three_nn_exact("level 1", q, s)
    grid = lambda *shape: torch.randint(0, 5, shape, generator=gen, device=dev).float() / 4
    big_q, big_s = xyz[:4, :1024].contiguous(), rand(4, 16384, 3)
    for name, (cq, cs) in {"duplicated": (xyz, xyz[:, :256].repeat(1, 4, 1)),
                           "grid": (grid(BT, POINTS, 3), grid(BT, 1024, 3)),
                           "ns_3": (xyz, xyz[:, :3].contiguous()),
                           "ns_2049": (xyz[:4].contiguous(), rand(4, 2049, 3)),
                           "ns_16384": (big_q, big_s)}.items():
        three_nn_exact(name, cq, cs)
    big_work = three_nn_work(big_q, big_s)
    rows["three_nn"] = dict(
        max_abs_err=0.0, tolerance="indices identical, distances exact",
        ms=queued_ms(lambda: kernels.three_nn(q, s)),
        plain_ms=time_ms(torch, lambda: pointops.three_nn(q, s)),
        library_ms=None, work=three_nn_work(q, s),
        parent_ms_per_reconstruct=PARENT_MS["three_nn"],
        ties_and_sizes_exact=["duplicated", "grid", "ns_3", "ns_2049", "ns_16384"],
        sources_16384=dict(shape="(4, 1024, 3) x (4, 16384, 3)",
                           ms=queued_ms(lambda: kernels.three_nn(big_q, big_s)),
                           bound_ms=bound(*big_work)[0], bound_by=bound(*big_work)[1]),
        shape=f"({BT}, {POINTS}, 3) x ({BT}, 1024, 3) -> ({BT}, {POINTS}, 3)",
    )

    # three-interpolate: the finest FP level moves 512 conv channels from
    # 1024 source points to 2048 queries
    wd, wi = pointops.three_nn(q, s)
    feats = rand(BT, 1024, 512) - 0.5
    inv = 1.0 / (wd + 1e-8)
    w = (inv / inv.sum(-1, keepdim=True)).contiguous()
    got = kernels.three_interpolate(feats, wi, w)
    want = pointops.three_interpolate(feats, wi, w)
    if not torch.equal(got, want):
        raise AssertionError(f"three_interpolate: not bit-exact, max abs err "
                             f"{float((got - want).abs().max())}")
    # C = 1030 (no multiple of 4: the scalar walk), 4 clouds, indices out of
    # range on both sides (clamped)
    wide = rand(4, 1024, 1030) - 0.5
    wide_idx = torch.randint(-2, 1026, (4, POINTS, 3), generator=gen, device=dev,
                             dtype=torch.int32)
    wide_w = w[:4].contiguous()
    if not torch.equal(kernels.three_interpolate(wide, wide_idx, wide_w),
                       pointops.three_interpolate(wide, wide_idx, wide_w)):
        raise AssertionError("three_interpolate at C = 1030: not bit-exact")
    wide_work = ((4 * 1024 * 1030 + 4 * POINTS * 6 + 4 * POINTS * 1030) * f4,
                 4 * POINTS * 1030 * 5.0)
    rows["three_interpolate"] = dict(
        max_abs_err=0.0, tolerance="bit-exact (same rounding order)",
        parent_ms_per_reconstruct=PARENT_MS["three_interpolate"],
        scalar_walk=dict(shape=f"(4, 1024, 1030) -> (4, {POINTS}, 1030)", bit_exact=True,
                         ms=queued_ms(lambda: kernels.three_interpolate(wide, wide_idx, wide_w)),
                         bound_ms=bound(*wide_work)[0], bound_by=bound(*wide_work)[1]),
        ms=queued_ms(lambda: kernels.three_interpolate(feats, wi, w)),
        plain_ms=time_ms(torch, lambda: pointops.three_interpolate(feats, wi, w)),
        library_ms=None,
        work=((BT * 1024 * 512 + BT * POINTS * 6 + BT * POINTS * 512) * f4,
              BT * POINTS * 512 * 5.0),
        shape=f"({BT}, 1024, 512) -> ({BT}, {POINTS}, 512)",
    )

    # CNF primal and dynamics (the tensor-core kernels, 3xTF32): the trained
    # decoder at one dynamics evaluation, the likelihood direction's with
    # noise e, held to their plain versions by cnf_case.  The bound counts
    # the hidden layers as 3 TF32 tensor-core passes at 495 TFLOP/s; the
    # float32 CUDA-core bound of the earlier kernels is printed beside it.
    params, _ = load_demo(device=dev)
    odenet = params["point_cnf"][1]["odenet"]
    tc = torch.cat([torch.full((BT, 1), 0.25, device=dev),
                    torch.randn((BT, 1600), generator=gen, device=dev)], dim=1)
    y = torch.randn((BT, POINTS, 3), generator=gen, device=dev)
    gb = cnf_fused.context_gb(odenet, tc)
    wf, wh, wl = cnf_fused.pack_weights(odenet)
    e = torch.randn((BT, POINTS, 3), generator=gen, device=dev)
    h = wf.shape[0]
    w64 = [t.double() for t in (gb, wf, wh, wl)]
    weights_bytes = (gb.numel() + wf.numel() + wh.numel() + wl.numel()) * f4
    cnf_rows = {
        "cnf_primal": dict(
            run=lambda: (kernels.cnf_primal(y, gb, wf, wh, wl),),
            plain=lambda: (cnf_fused.primal_packed(y, gb, wf, wh, wl),),
            emulation=lambda: (tf32x3.primal_tf32x3(y, gb, wf, wh, wl),),
            exact=(cnf_fused.primal_packed(y.double(), *w64),), streams=1,
            bytes=y.numel() * 2 * f4 + weights_bytes, shape=f"y ({BT}, {POINTS}, 3), H {h}"),
        "cnf_dynamics": dict(
            run=lambda: kernels.cnf_dynamics(y, e, gb, wf, wh, wl),
            plain=lambda: cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl),
            emulation=lambda: tf32x3.dynamics_tf32x3(y, e, gb, wf, wh, wl),
            exact=cnf_fused.dynamics_packed(y.double(), e.double(), *w64), streams=2,
            bytes=(y.numel() * 3 + BT * POINTS) * f4 + weights_bytes,
            shape=f"y, e ({BT}, {POINTS}, 3), H {h}"),
    }
    for name, c in cnf_rows.items():
        rows[name] = cnf_case(torch, name, c, BT * POINTS, wh.shape[0], h)

    # CNF dynamics VJP: the training path's evaluation of the adjoint's
    # augmented dynamics (25 clouds of 1024 points), random cotangents.
    # Held to the plain version run in float64 on the card: each output
    # within 1e-4 of its largest magnitude (float32 sums of up to 51 200
    # rows in another order); two launches must give the same bits.
    bt, n = TRAIN_B * TRAIN_T, TRAIN_N
    tc = torch.cat([torch.full((bt, 1), 0.25, device=dev),
                    torch.randn((bt, 1600), generator=gen, device=dev)], dim=1)
    args = (torch.randn((bt, n, 3), generator=gen, device=dev),
            torch.randn((bt, n, 3), generator=gen, device=dev), cnf_fused.context_gb(odenet, tc),
            wf, wh, wl, torch.randn((bt, n, 3), generator=gen, device=dev),
            torch.randn((bt, n), generator=gen, device=dev))
    got = kernels.cnf_dynamics_vjp(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, kernels.cnf_dynamics_vjp(*args))):
        raise AssertionError("cnf_dynamics_vjp: two launches on the same input differ")
    exact = cnf_fused.dynamics_vjp_packed(*(a.double() for a in args))
    plain = cnf_fused.dynamics_vjp_packed(*args)
    names = ("dy", "dgb", "dw_first", "dw_hidden", "dw_last")
    rels = {k: float((g.double() - w).abs().max() / w.abs().max()) for k, g, w in zip(names, got, exact)}
    plain_rels = {k: float((g.double() - w).abs().max() / w.abs().max())
                  for k, g, w in zip(names, plain, exact)}
    if not max(rels.values()) <= 1e-4:
        raise AssertionError(f"cnf_dynamics_vjp: relative err against float64 {rels} > 1e-4")
    rows_r = 2 * bt * n
    emulated = tf32x3.dynamics_vjp_tf32x3(*args)
    vjp_bytes = (sum(a.numel() for a in args) + sum(g.numel() for g in got)) * f4
    # three matrix passes over the rows (forward recompute, input
    # cotangents, weight gradients), 2 operations per multiply-add; the
    # hidden layers' on the tensor cores, three TF32 products each (3xTF32)
    vjp_tc_ops = 3 * 3 * 2.0 * rows_r * wh.shape[0] * h * h
    vjp_edge_ops = 3 * 2.0 * rows_r * (3 * h + h * 3)
    rows["cnf_dynamics_vjp"] = dict(
        max_abs_err=max(float((g.double() - w).abs().max()) for g, w in zip(got, exact)),
        tolerance="each output 1e-4 relative to its max magnitude, against the float64 plain "
                  "version; deterministic",
        rel_err_vs_float64=rels, plain_float32_rel_err_vs_float64=plain_rels,
        tf32x3_emulation_rel_err_vs_float64={
            k: float((m.double() - w).abs().max() / w.abs().max())
            for k, m, w in zip(names, emulated, exact)},
        ms=time_ms(torch, lambda: kernels.cnf_dynamics_vjp(*args)),
        plain_ms=time_ms(torch, lambda: cnf_fused.dynamics_vjp_packed(*args)),
        library_ms=None,
        work=(vjp_bytes, vjp_edge_ops, 0.0, vjp_tc_ops),
        f32_bound_ms=bound(vjp_bytes, vjp_edge_ops + vjp_tc_ops / 3)[0],
        shape=f"y, e, ct_dx ({bt}, {n}, 3), H {h}: {rows_r} rows",
    )

    # EMD: one evaluation batch's clouds (4 sequences x 10 frames), predicted
    # against target, both in the unit cube, then 12 pairs and one pair of
    # N + M = 16384, each held to the float64 value of the plain version, as
    # the TPU kernel is (tools/hw_exactness.py): emd_case's bars
    pred, target = rand(BT, POINTS, 3), rand(BT, POINTS, 3)
    emd_row = emd_case(torch, pred, target)
    emd_row["plain_ms"] = time_ms(torch, lambda: emd_plain(pred, target), reps=3)
    extra = {}
    for key, (pairs, n, m) in {"pairs_12": (12, POINTS, POINTS),
                               "n_plus_m_16384": (1, 12000, 4384)}.items():
        extra[key] = emd_case(torch, rand(pairs, n, 3), rand(pairs, m, 3), reps=3)
        extra[key]["bound_ms"], extra[key]["bound_by"] = bound(*extra[key].pop("work"))
    rows["emd"] = dict(
        emd_row, library_ms=None,
        tolerance="against float64 plain: body in float64 1e-9; float32 each pair 1e-3 relative, "
                  "mean 2e-4 (or 2x plain's mean); deterministic", **extra)
    rows["sa_fused"] = check_sa_fused(torch)
    add_per_reconstruct(torch, rows, encoder_kernels)
    for name, row in rows.items():
        bound_ms, bound_by = bound(*row["work"])
        print(json.dumps({"kernel": name, **{k: v for k, v in row.items() if k != "work"},
                          "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)
    return rows


def add_per_reconstruct(torch, rows, encoder_kernels):
    """Phase 2, the encoder's point-op kernels at every shape one
    reconstruct launches them (an encode of the phase-3 input with the demo
    weights), each held to its plain version: their sums per reconstruct
    go into each kernel's row (for fps also those of fps="level"), and one
    line per kernel lists the calls."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    model = CaSPRModel(CaSPRConfig(), device="cuda")
    params, _ = load_demo(device=model.device)
    calls = encoder_kernels.capture_calls(model, params, reconstruct_input(torch)[0])
    want = {"fps": 1, "ball_query": 5, "gather": 11, "three_nn": 5, "three_interpolate": 5,
            "fps_level": 5}
    if {k: len(v) for k, v in calls.items()} != want:
        raise AssertionError(f"encode calls {[(k, len(v)) for k, v in calls.items()]}, expected {want}")
    sums = encoder_kernels.measure(calls, bound)
    for kernel, row in sums.items():
        print(json.dumps({"kernel": kernel, "per_reconstruct": row}), flush=True)
        if kernel == "fps_level":
            continue
        rows[kernel].update({k: row[k] for k in ("ms_per_reconstruct", "plain_ms_per_reconstruct",
                                                 "bound_ms_per_reconstruct")})
    rows["gather"]["parent_ms_per_reconstruct"] = PARENT_MS["gather"]
    rows["fps"].update(level_ms_per_reconstruct=sums["fps_level"]["ms_per_reconstruct"],
                       level_bound_ms_per_reconstruct=sums["fps_level"]["bound_ms_per_reconstruct"])


def sa_extra_inputs(torch, b, n, m, k, dims, seed):
    """sa_fused's arguments (t, u, gidx, sp) at a shape the reconstruct does
    not launch: random tables, indices partly out of range (clamped), a
    mini-PointNet's parameters, on the card from ``seed``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    d1 = dims[0]
    t, u = rand(b, n, d1), 0.5 * rand(b, m, d1)
    gidx = torch.randint(-2, n + 3, (b, m, k), generator=gen, device=dev, dtype=torch.int32)
    ins = (9,) + tuple(dims)
    sp = {"convs": [{"weight": rand(d, ins[i]) / ins[i] ** 0.5, "bias": 0.1 * rand(d)}
                    for i, d in enumerate(dims)],
          "norms": [{"weight": 1.0 + 0.1 * rand(d), "bias": 0.1 * rand(d)} for d in dims]}
    return t, u, gidx, sp


def check_sa_fused(torch):
    """Phase 2, sa_fused: the kernel at the ten SA scale shapes of the
    reconstruct (the calls of an sa_impl="fused" encode of the phase-3
    input with the demo weights), at a ragged last tile and at a shape only
    the generic instantiation takes, each held to its plain version run in
    float64 on the card, each output within 1e-4 of its largest magnitude,
    and two launches must give the same bits
    (checks/encoder_kernels.py::check_sa_call).  Where a ball's variance is
    far below GroupNorm's eps (balls of one or two distinct points at the
    small radii), GroupNorm scales a float32 rounding by up to 316: the
    float32 plain version lands up to 6.5e-4 from the float64 value at
    level 1, so the kernel forms t[idx] - u, the first GroupNorm and every
    GroupNorm's statistics in double (csrc/sa_fused.cu).  Timed queued
    behind a spin kernel, per scale and summed, with the tensor-core bound
    (the convs as three TF32 passes) and the float32 bound beside.  No
    PyTorch call computes the stack: library none."""
    from caspr_tpu_torch.checks import encoder_kernels
    from caspr_tpu_torch.weights import load_demo

    params, _ = load_demo(device=torch.device("cuda"))
    calls = encoder_kernels.capture_sa_calls(params, reconstruct_input(torch)[0])
    if len(calls) != 10:
        raise AssertionError(f"captured {len(calls)} sa_fused calls, expected 10")
    scales = encoder_kernels.measure_sa(calls, bound)
    for i, row in enumerate(scales["calls"]):
        print(json.dumps({"kernel": "sa_fused", "scale": i, **row}), flush=True)
    extra = {}
    for key, (b, n, m, k, dims) in {"ragged_tile": (3, 300, 37, 16, (16, 16, 32)),
                                    "generic": (3, 300, 37, 5, (64, 96, 128))}.items():
        one = encoder_kernels.measure_sa([sa_extra_inputs(torch, b, n, m, k, dims, seed=k)],
                                         bound)["calls"][0]
        extra[key] = {name: one[name] for name in ("shape", "rel_err_vs_float64", "ms",
                                                   "bound_ms")}
    work = [encoder_kernels.sa_work(args) for args in calls]
    largest = max(scales["calls"], key=lambda r: r["ms"])
    return dict(
        max_abs_err=scales["max_abs_err"],
        tolerance="each output 1e-4 of its max magnitude against the float64 plain version; "
                  "deterministic",
        rel_err_vs_float64=scales["rel_err_vs_float64"],
        plain_rel_err_vs_float64=scales["plain_rel_err_vs_float64"],
        ms=scales["ms_sum"], plain_ms=scales["plain_ms_sum"], library_ms=None,
        parent_ms=PARENT_MS["sa_fused"], scale0_ms=scales["calls"][0]["ms"],
        work=(sum(w[0] for w in work), sum(w[2] for w in work), 0.0,
              3.0 * sum(w[1] for w in work)),
        f32_bound_ms=scales["f32_bound_ms_sum"],
        largest_shape_ms=largest["ms"], largest_shape=largest["shape"], **extra,
        shape="sum over the 10 SA scale shapes of one batch-4 reconstruct, one launch each",
    )


def reconstruct_input(torch):
    """The phase-3 reconstruct's input: (x (B, T, N, 4) uniform clouds with
    times 0..5, the decode times, a generator), on the card from SEED."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((BATCH, FRAMES, POINTS, 4), generator=gen, device=dev)
    x[..., 3] = torch.linspace(0.0, 5.0, FRAMES, device=dev)[None, :, None]
    return x, torch.linspace(0.0, 1.0, FRAMES, device=dev), gen


def run_path(torch, kernels):
    """Phase 3: full-width reconstruct through the kernels."""
    from caspr_tpu_torch.checks.encoder_kernels import FOCUS
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    cfg = CaSPRConfig()
    model = CaSPRModel(cfg, device="cuda")
    params, state = load_demo(device=dev)
    x, timestamps, gen = reconstruct_input(torch)

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
    require_launched(counts, RECONSTRUCT_KERNELS, "reconstruct")
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
    profile_path(torch, recon, median * 1e3, "reconstruct B=4 T=10 N=2048", nfe=[nfe_ode, nfe_cnf],
                 focus=FOCUS)
    return counts


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def encode_float32_floor(torch, params, x):
    """How far float32 itself lands from float64 on the encode of x: the
    relative L2 distances of z0 and T-NOCS between the card's float32
    encode (sa_impl "xla", the kernels) and its float64 encode (the plain
    point ops), on the card."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.ops.odeint import flatten_tree

    model = CaSPRModel(CaSPRConfig(), device="cuda")
    leaves, rebuild = flatten_tree(params["encoder"])
    with torch.no_grad():
        z32, t32 = model.encode(params, x)
        with plain_point_ops():
            z64, t64 = model.encode({"encoder": rebuild([t.double() for t in leaves])}, x.double())
    return {"z0": rel_l2(z32, z64), "tnocs": rel_l2(t32, t64)}


def run_sa_modes(torch, kernels):
    """Phase 3b: the phase-3 reconstruct with each SA mode.  Returns the
    launch counts of the fused reconstruct."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.models.pointnet2 import SA_IMPLS
    from caspr_tpu_torch.weights import load_demo

    params, state = load_demo(device=torch.device("cuda"))
    encodes, report = {}, {}
    for mode in SA_IMPLS:
        model = CaSPRModel(CaSPRConfig(sa_impl=mode), device="cuda")
        x, timestamps, gen = reconstruct_input(torch)

        def recon():
            return model.reconstruct(params, state, x, gen, num_points=POINTS,
                                     timestamps=timestamps)

        recon()  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        _, _, x_rec, tnocs, nfe = recon()
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        want = {"sa_fused": 10 if mode == "fused" else 0, "gather": 1 if mode == "fused" else 11}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"reconstruct with sa_impl={mode}: launches {counts}, expected {want}")
        require_launched(counts, RECONSTRUCT_KERNELS, f"reconstruct with sa_impl={mode}")
        if (tuple(x_rec.shape) != (BATCH, FRAMES, POINTS, 3) or not bool(torch.isfinite(x_rec).all())
                or not bool(torch.isfinite(tnocs).all())):
            raise AssertionError(f"reconstruct with sa_impl={mode}: output bad")
        with torch.no_grad():
            encodes[mode], _ = event_ms(torch, lambda: model.encode(params, x))
            encode_ms = float(np.median([event_ms(torch, lambda: model.encode(params, x))[1]
                                         for _ in range(5)]))
        repeats = []
        for _ in range(3):
            start = time.perf_counter()
            recon()
            torch.cuda.synchronize()
            repeats.append(time.perf_counter() - start)
        report[mode] = {"encode_ms": encode_ms, "reconstruct_s": float(np.median(repeats)),
                        "repeat_seconds": repeats, "nfe_ode": nfe[0], "nfe_cnf": nfe[1],
                        "launches": counts}
        if mode == "fused":
            fused = (recon, counts)
    rel = {name: rel_l2(encodes["fused"][i], encodes["factored"][i])
           for i, name in enumerate(("z0", "tnocs"))}
    floor = encode_float32_floor(torch, params, reconstruct_input(torch)[0])
    bar = {name: max(1e-4, 4.0 * floor[name]) for name in rel}
    print(json.dumps({"path": "reconstruct by SA mode", "batch": BATCH, "frames": FRAMES,
                      "points": POINTS, "modes": report,
                      "fused_vs_factored_rel_l2": rel, "float32_floor_rel_l2": floor,
                      "tolerance": "relative L2 1e-4, or 4x the float32 floor where larger",
                      "bar": bar}), flush=True)
    if not all(rel[name] <= bar[name] for name in rel):
        raise AssertionError(f"fused encode against factored: {rel} > {bar}")
    profile_path(torch, fused[0], report["fused"]["reconstruct_s"] * 1e3,
                 "reconstruct B=4 T=10 N=2048, sa_impl=fused",
                 nfe=[report["fused"]["nfe_ode"], report["fused"]["nfe_cnf"]])
    return fused[1]


def per_reconstruct(row, launches, bound_ms):
    """The kernels line's per-reconstruct keys of one kernel: the encoder
    kernels' sums over their captured calls; cnf_primal's launches in phase 3
    times its time and bound; null for a kernel the default reconstruct does
    not launch.  fps adds its time per step and bound per step."""
    if "ms_per_reconstruct" in row:
        keys = {"ms_per_reconstruct": row["ms_per_reconstruct"],
                "bound_ms_per_reconstruct": row["bound_ms_per_reconstruct"]}
    elif launches:
        keys = {"ms_per_reconstruct": launches * row["ms"],
                "bound_ms_per_reconstruct": launches * bound_ms}
    else:
        keys = {"ms_per_reconstruct": None, "bound_ms_per_reconstruct": None}
    if "ns_per_step" in row:
        keys.update(ns_per_step=row["ns_per_step"], bound_ns_per_step=row["bound_ns_per_step"])
    return keys


def require_launched(counts, names, path):
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise AssertionError(f"{path} ran without kernels {missing}: {counts}")


def device_time(torch, prof):
    """{kernel or copy: (device ms, calls)} of a torch.profiler run (not the
    ranges of record_function, which the trace also shows on the card)."""
    device_ms = {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA  # kernels and copies only
                or getattr(evt, "is_user_annotation", False)):
            continue
        ms = getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            device_ms[evt.key[:80]] = (ms, evt.count)
    return device_ms


def profile_path(torch, fn, wall_ms, label, nfe=None, focus=()):
    """One more fn() under torch.profiler: device time by kernel, and the
    share of the unprofiled wall time ``wall_ms`` in which the card ran no
    kernel (the profiler's own host overhead would inflate its wall); ``nfe``
    is printed beside the times when given, and the time and calls of every
    kernel whose name holds one of ``focus``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_ms = device_time(torch, prof)
    busy = sum(ms for ms, _ in device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "profile": f"{label} under torch.profiler",
        "unprofiled_wall_ms": wall_ms,
        **({"nfe": nfe} if nfe is not None else {}),
        "device_busy_ms": busy if busy else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if busy else "not measured",
        "top": [{"name": k, "ms": ms, "calls": n} for k, (ms, n) in top],
        **({"focus": [{"name": k, "ms": ms, "calls": n} for k, (ms, n) in device_ms.items()
                      if any(f in k for f in focus)]} if focus else {}),
    }), flush=True)


class SyntheticLoader:
    """Protocol-shaped synthetic batches for the evaluation functions:
    inputs in the form of the reconstruct run's (uniform points, times 0..5),
    targets in the unit cube with times 0..1, identity poses."""

    class _Dataset:
        def set_return_pose_data(self, flag):
            pass

    def __init__(self, num_batches, batch, seed):
        rng = np.random.default_rng(seed)
        self.dataset = self._Dataset()
        self.batches = []
        for i in range(num_batches):
            x = rng.random((batch, FRAMES, POINTS, 4), dtype=np.float32)
            x[..., 3] = np.linspace(0.0, 5.0, FRAMES, dtype=np.float32)[None, :, None]
            target = rng.random((batch, FRAMES, POINTS, 4), dtype=np.float32)
            target[..., 3] = np.linspace(0.0, 1.0, FRAMES, dtype=np.float32)[None, :, None]
            self.batches.append({
                "input": x, "target": target,
                "model_id": [f"model{i}"] * batch, "seq_id": [f"seq{j}" for j in range(batch)],
                "pose": np.tile(np.eye(4, dtype=np.float32), (batch, FRAMES, 1, 1)),
            })

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def event_ms(torch, fn):
    """(fn's result, its device milliseconds between two CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def require_finite_artifacts(paths, npz_lengths):
    """Every path exists; every array of the .npz among them is finite and
    has the expected length."""
    for path in paths:
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise AssertionError(f"evaluation artifact missing or empty: {path}")
    data = np.load(next(p for p in paths if p.endswith(".npz")))
    for key, length in npz_lengths.items():
        if len(data[key]) != length or not np.all(np.isfinite(data[key])):
            raise AssertionError(f"{key}: {len(data[key])} values (expected {length}), or not finite")
    return {key: float(np.mean(data[key])) for key in npz_lengths if len(data[key])}


def run_eval_path(torch, kernels, model, params, state, out_dir):
    """Phase 4: the evaluation protocols at full width.  Returns the launch
    counts of the kernels this path adds: emd from the shape-reconstruction
    protocol, cnf_dynamics from the likelihood path."""
    from caspr_tpu_torch.ops import approx_match_emd, chamfer_distance
    from caspr_tpu_torch.train import TestStatTracker, make_eval_step, run_one_epoch
    from caspr_tpu_torch.utils import evaluations as ev

    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    new_counts = {}

    # (a) shape reconstruction, observed steps 0, 5, 9: two batches of 4
    loader = SyntheticLoader(2, BATCH, SEED + 1)
    log_out = os.path.join(out_dir, "recon_log.txt")
    kernels.reset_launches()
    start = time.perf_counter()
    ev.test_shape_recon(model, params, state, loader, log_out, ev.SPLIT_OBSERVED_STEPS,
                        ev.SPLIT_UNOBSERVED_STEPS, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = dict(kernels.launches)
    require_launched(counts, RECONSTRUCT_KERNELS + ("emd",), "shape reconstruction eval")
    if counts["emd"] < 4:
        raise AssertionError(f"emd launched {counts['emd']} times, expected 2 batches x 2 legs")
    n_obs, n_unobs = 2 * BATCH * 3, 2 * BATCH * 7
    means = require_finite_artifacts(
        [log_out, log_out[:-3] + "npz", log_out[:-3] + "csv"],
        {"observed_chamfer": n_obs, "observed_emd": n_obs,
         "unobserved_chamfer": n_unobs, "unobserved_emd": n_unobs})
    new_counts["emd"] = counts["emd"]
    print(json.dumps({"eval": "shape reconstruction, observed 0,5,9", "batches": 2,
                      "batch": BATCH, "seconds": seconds, "launches": counts,
                      "means": means}), flush=True)

    # where one batch's time goes: CUDA events around each leg
    batch = loader.batches[0]
    x = torch.as_tensor(batch["input"], device=dev)[:, ev.SPLIT_OBSERVED_STEPS].contiguous()
    target = torch.as_tensor(batch["target"], device=dev)
    clouds = target[..., :3].reshape(BT, POINTS, 3).contiguous()

    def one_batch():
        with torch.no_grad():
            (_, _, pred, _, nfe), recon_ms = event_ms(torch, lambda: model.reconstruct(
                params, state, x, gen, num_points=POINTS, timestamps=target[0, :, 0, 3]))
            pred = pred.reshape(BT, POINTS, 3)
            _, chamfer_ms = event_ms(torch, lambda: chamfer_distance(pred, clouds))
            _, emd_ms = event_ms(torch, lambda: approx_match_emd(pred, clouds))
        return nfe, recon_ms, chamfer_ms, emd_ms

    one_batch()
    torch.cuda.synchronize()
    start = time.perf_counter()
    nfe, recon_ms, chamfer_ms, emd_ms = one_batch()
    wall_ms = (time.perf_counter() - start) * 1e3
    print(json.dumps({"eval_batch_split": f"B={BATCH}, 3 observed steps -> {BT} frames scored",
                      "nfe": nfe, "wall_ms": wall_ms, "reconstruct_ms": recon_ms,
                      "chamfer_ms": chamfer_ms, "emd_ms": emd_ms}), flush=True)
    profile_path(torch, one_batch, wall_ms, f"eval batch B={BATCH} (reconstruct, Chamfer, EMD)")

    # (b) the likelihood path: one batch of 4 through the eval step
    tracker = TestStatTracker()
    step = make_eval_step(model, 0.01, 100.0)
    log_out = os.path.join(out_dir, "test_log.txt")
    kernels.reset_launches()
    start = time.perf_counter()
    run_one_epoch(step, params, None, state, SyntheticLoader(1, BATCH, SEED + 2), gen, 0,
                  tracker, log_out, mode="test", print_stats_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = dict(kernels.launches)
    loss, nll, pos_err, time_err = (float(v) for v in tracker.get_mean_stats()[:4])
    nfe = [float(v) for v in tracker.get_mean_stats()[4]]
    if counts["cnf_dynamics"] == 0 or counts["cnf_dynamics"] != nfe[1]:
        raise AssertionError(f"cnf_dynamics launched {counts['cnf_dynamics']} times, CNF NFE {nfe[1]}")
    if not all(np.isfinite(v) for v in (loss, nll, pos_err, time_err)):
        raise AssertionError(f"likelihood path not finite: {(loss, nll, pos_err, time_err)}")
    new_counts["cnf_dynamics"] = counts["cnf_dynamics"]
    print(json.dumps({"eval": "likelihood (run_one_epoch, mode test)", "batch": BATCH,
                      "seconds": seconds, "nfe_ode": nfe[0], "nfe_cnf": nfe[1],
                      "mean_loss": loss, "mean_nll": nll, "tnocs_pos_err": pos_err,
                      "launches": counts}), flush=True)

    # (c) T-NOCS regression and pose RANSAC (host work): one batch of 1
    loader = SyntheticLoader(1, 1, SEED + 3)
    for name, fn, suffix in (("T-NOCS regression", ev.test_tnocs_regression, "."),
                             ("pose RANSAC", ev.test_observed_camera_pose_ransac, "_RANSAC.")):
        log_out = os.path.join(out_dir, name.split()[0].lower() + "_log.txt")
        keys = ("space", "time") if suffix == "." else ("trans", "rot", "point", "point_mean")
        kernels.reset_launches()
        start = time.perf_counter()
        fn(model, params, state, loader, log_out)
        seconds = time.perf_counter() - start
        counts = dict(kernels.launches)
        require_launched(counts, RECONSTRUCT_KERNELS[:-1], name)
        stem = log_out[: -len(".txt")]
        means = require_finite_artifacts(
            [log_out, stem + suffix + "npz", stem + suffix + "csv"], dict.fromkeys(keys, FRAMES))
        print(json.dumps({"eval": name, "batch": 1, "seconds": seconds, "launches": counts,
                          "means": means}), flush=True)
    return new_counts


def cross_device(torch):
    """Phase 5: the same small reconstruct, and the same small forward, on
    the card and on the CPU."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    cfg = CaSPRConfig()
    rng = np.random.default_rng(SEED)
    x = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    x[..., 3] = np.array([0.0, 5.0], np.float32)[None, :, None]
    base = rng.standard_normal((1, 2, 512, 3)).astype(np.float32)
    ts = np.array([0.0, 1.0], np.float32)
    # forward: target points at their own times, and the CNF's noise
    target = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    target[..., 3] = np.array([0.2, 0.9], np.float32)[None, :, None]
    noise = rng.standard_normal((2, POINTS, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = CaSPRModel(cfg, device=dev)
        params, state = load_demo(device=dev)
        to = lambda a: torch.from_numpy(a).to(dev)
        with torch.no_grad():
            _, _, rec, _, nfe = model.reconstruct(
                params, state, to(x), None, num_points=512, timestamps=to(ts),
                base_samples=to(base))
            res, _ = model.forward(params, state, to(x), to(target), e=to(noise))
        out[dev] = {"reconstruct": (rec.cpu(), nfe), "forward": (res["nll"].cpu(), res["nfe"])}
    for name, what in (("reconstruct", "B=1 T=2 N=2048 -> 512 points"),
                       ("forward", "B=1 T=2 N=2048: nll")):
        (card, card_nfe), (cpu, cpu_nfe) = out["cuda"][name], out["cpu"][name]
        err = float((card - cpu).abs().max())
        if card_nfe != cpu_nfe or not err <= 1e-3:
            raise AssertionError(f"{name}, card vs CPU: nfe {card_nfe} vs {cpu_nfe}, max abs err {err}")
        print(json.dumps({"cross_device": f"{name} {what}", "nfe": card_nfe, "max_abs_err": err,
                          "tolerance": 1e-3}), flush=True)


# Configs the fused CNF kernels do not take (ops.cnf_fused.kernel_takes):
# unequal widths, and no hidden-to-hidden layer.  With caspr_init's weights
# the flow's field is close to linear, dopri5's error estimate sits at
# float32 rounding and the step sequence follows the order of the sums; the
# CNF layers' weights get the gain of tests/test_torch_port_composition.py
# (6, and 9 with one hidden layer), where the estimate is truncation error.
COMPOSED = {(16, 32): 6.0, (32,): 9.0}


def composition_path(torch, kernels):
    """Phase 5b: the CNF composition path, card against CPU."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
    from caspr_tpu_torch.ops.odeint import flatten_tree

    rng = np.random.default_rng(SEED + 7)
    x = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    x[..., 3] = np.array([0.0, 5.0], np.float32)[None, :, None]
    base = rng.standard_normal((1, 2, 512, 3)).astype(np.float32)
    ts = np.array([0.0, 1.0], np.float32)
    target = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    target[..., 3] = np.array([0.2, 0.9], np.float32)[None, :, None]
    noise = rng.standard_normal((2, POINTS, 3)).astype(np.float32)
    for dims, gain in COMPOSED.items():
        cfg = CaSPRConfig(cnf_dims=dims)
        params, state = caspr_init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
        for layer in params["point_cnf"][1]["odenet"]["layers"]:
            layer["_layer"]["weight"] *= gain
        out = {}
        for dev in ("cuda", "cpu"):
            model = CaSPRModel(cfg, device=dev)
            move = lambda tree: (lambda lv: lv[1]([t.to(dev) for t in lv[0]]))(flatten_tree(tree))
            p, st = move(params), move(state)
            to = lambda a: torch.from_numpy(a).to(dev)
            kernels.reset_launches()
            with torch.no_grad():
                _, _, rec, _, nfe = model.reconstruct(p, st, to(x), None, num_points=512,
                                                      timestamps=to(ts), base_samples=to(base))
                res, _ = model.forward(p, st, to(x), to(target), e=to(noise))
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = dict(kernels.launches)
                cnf = {k: counts[k] for k in ("cnf_primal", "cnf_dynamics", "cnf_dynamics_vjp")}
                if any(cnf.values()):
                    raise AssertionError(f"cnf_dims={dims}: CNF kernels launched {cnf}")
                require_launched(counts, RECONSTRUCT_KERNELS[:-1], f"cnf_dims={dims} encoder")
            out[dev] = (rec.cpu(), nfe, res["nll"].cpu(), res["nfe"])
        (rec, nfe, nll, fnfe), (crec, cnfe, cnll, cfnfe) = out["cuda"], out["cpu"]
        errs = {"points": float((rec - crec).abs().max()), "nll": float((nll - cnll).abs().max())}
        # phase 5's 1e-3 is for O(1) values; the gained flow's are larger,
        # and the same step sequence carries rounding in proportion
        scale = {"points": max(1.0, float(crec.abs().max())), "nll": max(1.0, float(cnll.abs().max()))}
        print(json.dumps({"composition": f"cnf_dims={dims}, caspr_init seed {SEED}, CNF gain "
                                         f"{gain}: reconstruct B=1 T=2 N=2048 -> 512, forward",
                          "nfe": {"reconstruct": [nfe, cnfe], "forward": [fnfe, cfnfe]},
                          "max_abs_err": errs, "scale": scale,
                          "tolerance": "1e-3 x max(1, the CPU's largest magnitude)",
                          "cnf_launches": cnf, "launches": counts}), flush=True)
        if nfe != cnfe or fnfe != cfnfe or any(errs[k] > 1e-3 * scale[k] for k in errs):
            raise AssertionError(f"cnf_dims={dims}, card vs CPU: see the line above")


class TrainLoader:
    """Batches in the form of bench.py's train step: uniform clouds, times
    sorted per sequence from 0, input times x 5, target times as they are."""

    def __init__(self, num_batches, seed):
        rng = np.random.default_rng(seed)
        self.batches = []
        for _ in range(num_batches):
            times = np.sort(rng.random((TRAIN_B, TRAIN_T), dtype=np.float32), axis=1)
            times -= times[:, :1]
            x = rng.random((TRAIN_B, TRAIN_T, TRAIN_N, 4), dtype=np.float32)
            x[..., 3] = times[:, :, None] * 5.0
            target = rng.random((TRAIN_B, TRAIN_T, TRAIN_N, 4), dtype=np.float32)
            target[..., 3] = times[:, :, None]
            self.batches.append({"input": x, "target": target})

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def run_train_path(torch, kernels, out_dir):
    """Phase 6: the training path at full width.  Returns its launch counts."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
    from caspr_tpu_torch.ops.odeint import flatten_tree
    from caspr_tpu_torch.train import (TrainLossTracker, load_checkpoint, make_optimizer,
                                       make_train_step, run_one_epoch, save_checkpoint)
    from caspr_tpu_torch.train.checkpoint import adam_state
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    cfg = CaSPRConfig()
    model = CaSPRModel(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, state = caspr_init(gen, cfg, device=dev)
    before = [t.clone() for t in flatten_tree(params)[0]]
    tx = make_optimizer(1e-4)
    opt = tx.init(params)
    step = make_train_step(model, tx, 0.01, 100.0)
    seconds, metrics = [], []

    def timed_step(*args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        metrics.append(out[3])
        return out

    loader = TrainLoader(3, SEED + 4)
    kernels.reset_launches()
    params, opt, state = run_one_epoch(timed_step, params, opt, state, loader, gen, 0,
                                       TrainLossTracker(), os.path.join(out_dir, "train_log.txt"),
                                       mode="train", print_stats_every=1)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require_launched(counts, TRAIN_KERNELS, "training")
    if counts["cnf_primal"]:
        raise AssertionError(f"training launched cnf_primal {counts['cnf_primal']} times")
    # every CNF evaluation, forward or backward, is one cnf_dynamics launch;
    # every augmented one (all but f(t1) and f(t0) of the one interval) is
    # also one VJP launch
    cnf_evals = sum(m["nfe"][1] for m in metrics)
    augmented = sum(m["nfe"][1] - m["nfe_forward"][1] - 2 for m in metrics)
    if counts["cnf_dynamics"] != cnf_evals or counts["cnf_dynamics_vjp"] != augmented:
        raise AssertionError(f"launches {counts} against CNF evaluations {cnf_evals} "
                             f"(augmented {augmented})")
    if not all(np.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"training loss not finite: {[m['loss'] for m in metrics]}")
    paths = leaf_paths(params)
    still = [p for p, a, b in zip(paths, before, flatten_tree(params)[0]) if torch.equal(a, b)]
    if still:
        raise AssertionError(f"{len(still)} of {len(before)} parameter leaves did not change: {still}")
    nfe = [{"ode": {"forward": m["nfe_forward"][0], "backward": m["nfe"][0] - m["nfe_forward"][0]},
            "cnf": {"forward": m["nfe_forward"][1], "backward": m["nfe"][1] - m["nfe_forward"][1]}}
           for m in metrics]
    median = float(np.median(seconds[1:]))
    print(json.dumps({"train": "run_one_epoch(mode=train), caspr_init seed 0", "batch": TRAIN_B,
                      "frames": TRAIN_T, "points": TRAIN_N, "step_seconds": seconds,
                      "steps_2_3_median_s": median, "seqs_per_s": TRAIN_B / median,
                      "losses": [m["loss"] for m in metrics], "nfe": nfe, "launches": counts,
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    batch = loader.batches[-1]
    profile_path(torch, lambda: step(params, opt, state, batch["input"], batch["target"], gen),
                 median * 1e3, f"train step B={TRAIN_B} T={TRAIN_T} N={TRAIN_N}",
                 focus=("vjp_tile_kernel", "wgrad_tc_kernel", "thin_grad_kernel",
                        "finalize_kernel", "split_weights_kernel"))

    # the trained weights: one step
    demo_params, demo_state = load_demo(device=dev)
    start = time.perf_counter()
    _, _, _, m = step(demo_params, tx.init(demo_params), demo_state, batch["input"],
                      batch["target"], gen)
    torch.cuda.synchronize()
    print(json.dumps({"train": "one step from artifacts/demo_trained.pkl", "loss": m["loss"],
                      "seconds": time.perf_counter() - start, "nfe": m["nfe"],
                      "nfe_forward": m["nfe_forward"]}), flush=True)
    if not np.isfinite(m["loss"]):
        raise AssertionError(f"demo-weight training loss not finite: {m['loss']}")

    # a checkpoint, written and read back
    path = os.path.join(out_dir, "train_ckpt.pkl")
    save_checkpoint(path, params, state, opt, epoch=0)
    ck = load_checkpoint(path)
    saved = [np.asarray(a) for a in flatten_tree_np((ck["params"], ck["state"], ck["opt_state"]))]
    held = [t.detach().cpu().numpy() for t in flatten_tree((params, state))[0]]
    opt_np = adam_state(params, opt)
    held += [np.asarray(a) for a in flatten_tree_np(opt_np)]
    if len(saved) != len(held) or not all(np.array_equal(a, b) for a, b in zip(saved, held)):
        raise AssertionError("checkpoint read back differs from what was saved")
    print(json.dumps({"train": "checkpoint round trip", "leaves": len(saved),
                      "adam_count": int(ck["opt_state"]["count"])}), flush=True)
    return {k: counts[k] for k in ("cnf_dynamics_vjp",)}


def leaf_paths(tree, prefix=""):
    """Dotted paths of the leaves of a dict / list tree, in order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def flatten_tree_np(tree):
    """Leaves of a dict / list / tuple tree of arrays, in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in flatten_tree_np(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten_tree_np(v)]
    return [tree]


class GradRecorder:
    """An optimizer that keeps the gradients it is given and moves nothing."""

    def __init__(self, leaves):
        self.leaves = leaves
        self.grads = None

    def step(self):
        self.grads = [p.grad.detach().cpu() for p in self.leaves]

    def zero_grad(self, set_to_none=True):
        for p in self.leaves:
            p.grad = None


@contextlib.contextmanager
def plain_point_ops():
    """The encoder's point ops as their plain versions, for float64 runs
    (the kernel wrappers take float32 only); their backward equals the
    wrappers'."""
    from caspr_tpu_torch.models import pointnet2
    from caspr_tpu_torch.ops import pointops

    names = ("farthest_point_sampling", "gather_points", "ball_query", "ball_query_pair", "three_nn",
             "three_interpolate")
    saved = {n: getattr(pointnet2, n) for n in names}
    try:
        for n in names:
            setattr(pointnet2, n, getattr(pointops, n))
        yield
    finally:
        for n, fn in saved.items():
            setattr(pointnet2, n, fn)


def encoder_grads(torch, model, params, x, target, dtype):
    """The gradient of the T-NOCS loss (the encoder alone) on input x with
    respect to every encoder leaf, flattened in float64, on the device of
    params."""
    from caspr_tpu_torch.ops.odeint import flatten_tree

    leaves, rebuild = flatten_tree(params["encoder"])
    dev = leaves[0].device
    enc = rebuild([t.detach().to(dtype).requires_grad_() for t in leaves])
    _, tnocs = model.encode({"encoder": enc}, torch.from_numpy(x).to(dev, dtype))
    loss = (tnocs - torch.from_numpy(target[..., :4]).to(dev, dtype)).abs().mean()
    return torch.cat([g.flatten().double() for g in torch.autograd.grad(loss, flatten_tree(enc)[0])])


def encoder_float32_floor(torch, model, params, x, target):
    """How far float32 itself lands from float64 on the encoder's gradient:
    the relative L2 distance between the CPU's float32 and float64
    gradients of the T-NOCS loss (the encoder alone) on this input (params
    and model on the CPU)."""
    g32 = encoder_grads(torch, model, params, x, target, torch.float32)
    with plain_point_ops():
        g64 = encoder_grads(torch, model, params, x, target, torch.float64)
    return float((g32 - g64).norm() / g64.norm())


def train_step_input():
    """Phase 7's problem, 1 sequence x 2 frames x 1024 points: (x, target,
    noise) as numpy arrays."""
    rng = np.random.default_rng(SEED + 5)
    x = rng.random((1, 2, 1024, 4), dtype=np.float32)
    x[..., 3] = np.array([0.0, 2.5], np.float32)[None, :, None]
    # the T-NOCS loss compares the prediction at each input point with the
    # target point of the same index, so the two clouds are of one size
    target = rng.random((1, 2, 1024, 4), dtype=np.float32)
    target[..., 3] = np.array([0.0, 0.5], np.float32)[None, :, None]
    noise = rng.standard_normal((2, 1024, 3)).astype(np.float32)
    return x, target, noise


def train_step_floor(torch):
    """encoder_float32_floor on phase 7's input, with the demo weights."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    x, target, _ = train_step_input()
    params, _ = load_demo(device="cpu")
    return encoder_float32_floor(torch, CaSPRModel(CaSPRConfig(), device="cpu"), params, x, target)


def run_fused_train(torch, kernels, out_dir, floor):
    """Phase 6b: training with sa_impl="fused"."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
    from caspr_tpu_torch.ops.odeint import flatten_tree
    from caspr_tpu_torch.train import (TrainLossTracker, make_optimizer, make_train_step,
                                       run_one_epoch)
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    cfg = CaSPRConfig(sa_impl="fused")
    model = CaSPRModel(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, state = caspr_init(gen, cfg, device=dev)
    before = [t.clone() for t in flatten_tree(params)[0]]
    tx = make_optimizer(1e-4)
    step = make_train_step(model, tx, 0.01, 100.0)
    metrics, seconds = [], []

    def timed_step(*args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        metrics.append(out[3])
        return out

    kernels.reset_launches()
    params, _, _ = run_one_epoch(timed_step, params, tx.init(params), state, TrainLoader(2, SEED + 6),
                                 gen, 0, TrainLossTracker(),
                                 os.path.join(out_dir, "train_fused_log.txt"), mode="train",
                                 print_stats_every=1)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require_launched(counts, TRAIN_KERNELS + ("sa_fused",), "training with sa_impl=fused")
    if counts["sa_fused"] != 10 * len(metrics):
        raise AssertionError(f"sa_fused launched {counts['sa_fused']} times in {len(metrics)} steps")
    if not all(np.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"fused training loss not finite: {[m['loss'] for m in metrics]}")
    still = [p for p, a, b in zip(leaf_paths(params), before, flatten_tree(params)[0])
             if torch.equal(a, b)]
    if still:
        raise AssertionError(f"{len(still)} parameter leaves did not change: {still}")

    # the encoder's gradient through "fused" against "xla", phase 7's input
    x, target, _ = train_step_input()
    demo, _ = load_demo(device=dev)
    grads = {mode: encoder_grads(torch, CaSPRModel(CaSPRConfig(sa_impl=mode), device=dev), demo,
                                 x, target, torch.float32) for mode in ("fused", "xla")}
    rel = rel_l2(grads["fused"], grads["xla"])
    print(json.dumps({"train": "run_one_epoch(mode=train), sa_impl=fused, caspr_init seed 0",
                      "batch": TRAIN_B, "frames": TRAIN_T, "points": TRAIN_N,
                      "step_seconds": seconds, "losses": [m["loss"] for m in metrics],
                      "nfe": [m["nfe"] for m in metrics], "launches": counts,
                      "encoder_grad_fused_vs_xla_rel_l2": rel,
                      "encoder_float32_floor_rel_l2": floor,
                      "tolerance": "4 x the float32 floor"}), flush=True)
    if not rel <= 4.0 * floor:
        raise AssertionError(f"encoder gradient, fused against xla: relative L2 {rel} > 4 x {floor}")


def cross_device_train(torch, floor):
    """Phase 7: one small full-width train step on the card and on the CPU.

    The flow's and the latent ODE's gradients are held leaf by leaf to 1e-3
    of each leaf's largest magnitude.  The encoder's float32 gradient is
    ill-conditioned leaf by leaf whatever computes it (on the CPU, float32
    lands up to 5% of some leaves' largest from float64, and the JAX
    package's eager float32 as far: tests/test_torch_port_adjoint.py::
    test_encoder_gradients_in_float64_match_jax), so its whole gradient is
    held, in relative L2, to 4x the distance float32 itself keeps from
    float64 on this input (``encoder_float32_floor``), and each leaf's error
    is printed."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.ops.odeint import flatten_tree
    from caspr_tpu_torch.train import make_train_step
    from caspr_tpu_torch.weights import load_demo

    cfg = CaSPRConfig()
    x, target, noise = train_step_input()
    out = {}
    for dev in ("cuda", "cpu"):
        model = CaSPRModel(cfg, device=dev)
        params, state = load_demo(device=dev)
        recorder = GradRecorder(flatten_tree(params)[0])
        step = make_train_step(model, None, 0.01, 100.0)
        start = time.perf_counter()
        _, _, _, m = step(params, recorder, state, x, target, e=torch.from_numpy(noise).to(dev))
        out[dev] = (m, recorder.grads, time.perf_counter() - start)
    paths = leaf_paths(params)
    (card, card_grads, card_s), (cpu, cpu_grads, cpu_s) = out["cuda"], out["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    rel = {p: float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
           for p, a, b in zip(paths, card_grads, cpu_grads)}
    enc = [i for i, p in enumerate(paths) if p.startswith("encoder.")]
    flat = lambda grads: torch.cat([grads[i].flatten().double() for i in enc])
    enc_l2 = float((flat(card_grads) - flat(cpu_grads)).norm() / flat(cpu_grads).norm())
    rest = {p: r for p, r in rel.items() if not p.startswith("encoder.")}
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:5]
    print(json.dumps({"cross_device": "train step B=1 T=2 N=1024, demo weights",
                      "loss": [card["loss"], cpu["loss"]], "loss_rel_err": loss_rel,
                      "nfe": [card["nfe"], cpu["nfe"]],
                      "nfe_forward": [card["nfe_forward"], cpu["nfe_forward"]],
                      "flow_and_latent_leaves": len(rest),
                      "flow_and_latent_rel_err_max": max(rest.values()),
                      "flow_and_latent_worst": worst(rest),
                      "encoder_leaves": len(enc), "encoder_rel_l2": enc_l2,
                      "encoder_float32_floor_rel_l2": floor,
                      "encoder_leaf_rel_err_median": float(np.median([rel[paths[i]] for i in enc])),
                      "encoder_worst": worst({paths[i]: rel[paths[i]] for i in enc}),
                      "seconds": {"card": card_s, "cpu": cpu_s},
                      "tolerance": {"loss": 1e-4, "flow_and_latent_leaf": 1e-3,
                                    "encoder_rel_l2": "4 x the float32 floor"}}), flush=True)
    if (card["nfe"] != cpu["nfe"] or card["nfe_forward"] != cpu["nfe_forward"]
            or not loss_rel <= 1e-4 or not max(rest.values()) <= 1e-3
            or not enc_l2 <= 4.0 * floor):
        raise AssertionError("train step, card vs CPU: see the line above")


TEST_CLI_KERNELS = ("fps", "ball_query", "gather", "three_nn", "three_interpolate", "cnf_primal",
                    "cnf_dynamics", "emd")
CLI_TEST_SEQS = 6  # the synthetic tree's test split (caspr_tpu_torch/data/synthetic.py)


def forbid_launched(counts, names, path):
    launched = {k: counts[k] for k in names if counts[k]}
    if launched:
        raise AssertionError(f"{path} launched {launched}")


def log_numbers(log_path, pattern):
    """Every match of ``pattern`` (a regex with float groups) in the log."""
    with open(log_path) as f:
        return [tuple(float(g) for g in m.groups()) for m in re.finditer(pattern, f.read())]


FLOAT = r"(-?[0-9.]+(?:e[-+]?[0-9]+)?|nan|inf|-inf)"


def check_protocol_artifacts(stem, npz_lengths, csv_rows, test_models):
    """stem.npz holds each key at its length, finite; stem.csv a header and
    ``csv_rows`` rows, every one a real test sequence, each of them there."""
    import csv

    means = require_finite_artifacts([stem + ".npz", stem + ".csv"], npz_lengths)
    with open(stem + ".csv", newline="") as f:
        rows = list(csv.reader(f, delimiter=",", quotechar="|"))[1:]
    col = 1 if rows and rows[0][0] in ("OBSERVED", "UNOBSERVED") else 0
    models = sorted({r[col] for r in rows})
    if len(rows) != csv_rows or models != test_models:
        raise AssertionError(f"{stem}.csv: {len(rows)} rows of {models}, expected {csv_rows} "
                             f"of {test_models}")
    return means


def run_cli_path(torch, kernels, out_dir, card):
    """Phase 8: the test and train command lines over a synthetic dataset
    tree, in process through their main() and once as a subprocess."""
    import shutil

    from caspr_tpu_torch.cli import test as cli_test
    from caspr_tpu_torch.cli import train as cli_train
    from caspr_tpu_torch.data import write_synthetic_tree
    from caspr_tpu_torch.weights import DEMO_CHECKPOINT

    start = time.perf_counter()
    cfg = write_synthetic_tree(os.path.join(out_dir, "tree"), seed=SEED)
    test_models = [f"test_{i:04d}" for i in range(CLI_TEST_SEQS)]
    print(json.dumps({"cli": "synthetic tree", "seconds": time.perf_counter() - start,
                      "cfg": cfg}), flush=True)

    # (a) the test CLI in process, every protocol; each protocol's artifacts
    # are copied aside as it ends (the protocols share test_log.npz / .csv)
    test_out = os.path.join(out_dir, "cli_test")
    stem = os.path.join(test_out, "test_log")
    copies = {}

    def keep(name, fn, suffix=""):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            label = name
            if name == "recon":
                label += "_unobserved" if len(args[6]) else "_observed"
            for ext in (".npz", ".csv"):
                shutil.copy(stem + suffix + ext, os.path.join(test_out, label + ext))
            copies[label] = os.path.join(test_out, label)
            return out
        return run

    test_args = ["--data-cfg", cfg, "--weights", DEMO_CHECKPOINT, "--seq-len", str(FRAMES),
                 "--num-pts", str(POINTS), "--batch-size", str(BATCH), "--seed", str(SEED)]
    wrapped = {"test_shape_recon": keep("recon", cli_test.test_shape_recon),
               "test_tnocs_regression": keep("tnocs", cli_test.test_tnocs_regression),
               "test_observed_camera_pose_ransac": keep(
                   "pose", cli_test.test_observed_camera_pose_ransac, "_RANSAC")}
    originals = {k: getattr(cli_test, k) for k in wrapped}
    kernels.reset_launches()
    start = time.perf_counter()
    try:
        for k, v in wrapped.items():
            setattr(cli_test, k, v)
        cli_test.main(test_args + ["--out", test_out, "--eval-test",
                                   "--eval-shape-recon-observed", "--eval-shape-recon-unobserved",
                                   "--eval-tnocs-regression", "--eval-pose-observed-ransac"])
    finally:
        for k, v in originals.items():
            setattr(cli_test, k, v)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = dict(kernels.launches)
    require_launched(counts, TEST_CLI_KERNELS, "test CLI")
    forbid_launched(counts, ("sa_fused", "cnf_dynamics_vjp"), "test CLI")
    log_path = stem + ".txt"
    test_loss = log_numbers(log_path, r"Batch 0/0\] TEST Mean loss: " + FLOAT)
    if len(test_loss) != 1 or not np.isfinite(test_loss[0][0]):
        raise AssertionError(f"test CLI: TEST line {test_loss}")
    n = CLI_TEST_SEQS * FRAMES
    n_obs, n_unobs = CLI_TEST_SEQS * 3, CLI_TEST_SEQS * 7
    means = {
        "eval-test": {"loss": test_loss[0][0]},
        "eval-shape-recon-observed": check_protocol_artifacts(
            copies["recon_observed"], {"observed_chamfer": n, "observed_emd": n,
                                       "unobserved_chamfer": 0}, CLI_TEST_SEQS, test_models),
        "eval-shape-recon-unobserved": check_protocol_artifacts(
            copies["recon_unobserved"], {"observed_chamfer": n_obs, "observed_emd": n_obs,
                                         "unobserved_chamfer": n_unobs,
                                         "unobserved_emd": n_unobs},
            2 * CLI_TEST_SEQS, test_models),
        "eval-tnocs-regression": check_protocol_artifacts(
            copies["tnocs"], {"space": n, "time": n}, CLI_TEST_SEQS, test_models),
        "eval-pose-observed-ransac": check_protocol_artifacts(
            copies["pose"], dict.fromkeys(("trans", "rot", "point", "point_mean"), n),
            CLI_TEST_SEQS, test_models),
    }
    with open(log_path) as f:
        text = f.read()
    native = "Data loader: native" in text
    timing = {name: {"seconds": float(secs), "loader_wait_s_per_batch": float(wait),
                     "batches": int(nb)}
              for name, secs, wait, nb in re.findall(
                  r"TIMING (\S+): " + FLOAT + r" s, loader wait " + FLOAT
                  + r" s per batch over (\d+) batches", text)}
    if sorted(timing) != sorted(means):
        raise AssertionError(f"test CLI timed {sorted(timing)}, ran {sorted(means)}")
    print(json.dumps({"cli": "test, in process, demo weights", "card": card,
                      "test_sequences": CLI_TEST_SEQS, "batch": BATCH, "seconds": seconds,
                      "protocols": timing, "means": means, "native_loader": native,
                      "launches": counts}), flush=True)

    # (b) the test CLI as a subprocess: its T-NOCS regression is (a)'s
    sub_out = os.path.join(out_dir, "cli_test_sub")
    start = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "caspr_tpu_torch.cli.test", *test_args,
                          "--out", sub_out, "--eval-tnocs-regression"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - start
    if res.returncode != 0:
        raise AssertionError(f"test CLI subprocess exited {res.returncode}: {res.stderr[-3000:]}")
    sub, ref = np.load(os.path.join(sub_out, "test_log.npz")), np.load(copies["tnocs"] + ".npz")
    diff = max(float(np.abs(sub[k] - ref[k]).max()) for k in ("space", "time"))
    print(json.dumps({"cli": "test, subprocess, --eval-tnocs-regression", "card": card,
                      "seconds": seconds, "max_abs_diff_vs_in_process": diff}), flush=True)
    if not diff <= 1e-5:
        raise AssertionError(f"test CLI subprocess T-NOCS differs from in-process by {diff}")

    # (c)-(e) the train CLI: two epochs from caspr_init, one resumed from the
    # second's checkpoint, one with the discrete backward
    train_args = ["--data-cfg", cfg, "--seq-len", str(TRAIN_T), "--num-pts", str(TRAIN_N),
                  "--batch-size", str(TRAIN_B), "--val-every", "1", "--save-every", "1",
                  "--print-every", "1", "--seed", str(SEED)]
    runs = {}
    for run, extra in (("adjoint", ["--epochs", "2"]),
                       ("resume", ["--epochs", "1", "--weights",
                                   os.path.join(out_dir, "cli_train_adjoint", "time_model_1.pkl")]),
                       ("discrete", ["--epochs", "1", "--ode-backward", "discrete"])):
        run_out = os.path.join(out_dir, f"cli_train_{run}")
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        cli_train.main(train_args + extra + ["--out", run_out])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = dict(kernels.launches)
        log_path = os.path.join(run_out, "train_log.txt")
        losses = [v[0] for v in log_numbers(log_path, r"TRAIN Mean loss: " + FLOAT)]
        val = [v[0] for v in log_numbers(log_path, r"Batch 0/0\] VAL Mean loss: " + FLOAT)]
        train_nfe = log_numbers(log_path, r"TRAIN Mean NFE \(latent-ode, decoder\): \("
                                + FLOAT + ", " + FLOAT)
        val_nfe = log_numbers(log_path, r"Batch 0/0\] VAL Mean loss: [^\n]*\n[^\n]*\n[^\n]*\n"
                              r"[^\n]*VAL Mean NFE \(latent-ode, decoder\): \(" + FLOAT + ", "
                              + FLOAT)
        timing = log_numbers(log_path, r"TIMING epoch \d+: " + FLOAT + r" s per train step over "
                             r"(\d+) steps, loader wait " + FLOAT)
        with open(log_path) as f:
            text = f.read()
        require_launched(counts, TRAIN_KERNELS, f"train CLI ({run})")
        forbid_launched(counts, ("cnf_primal", "sa_fused"), f"train CLI ({run})")
        if not losses or not val or not all(np.isfinite(losses + val)):
            raise AssertionError(f"train CLI ({run}): train losses {losses}, VAL {val}")
        names = ["train_log.txt", "train_curve.npz"] + [f"time_model_{e}.pkl" for e in
                                                        range(len(timing))]
        if val:
            names.append("BEST_time_model.pkl")
        missing = [m for m in names if not os.path.exists(os.path.join(run_out, m))]
        if missing:
            raise AssertionError(f"train CLI ({run}) wrote no {missing}")
        info = {"cli": f"train, in process ({run})", "card": card, "batch": TRAIN_B,
                "frames": TRAIN_T, "points": TRAIN_N, "seconds": seconds,
                "s_per_train_step_by_epoch": [t[0] for t in timing],
                "loader_wait_s_per_batch_by_epoch": [t[2] for t in timing],
                "losses": losses, "val_losses": val, "train_nfe": train_nfe,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "curve_png": os.path.exists(os.path.join(run_out, "train_curve.png")),
                "native_loader": "Data loader: native" in text, "launches": counts}
        if run == "resume" and "Restored optimizer state from checkpoint" not in text:
            raise AssertionError("train CLI (resume) did not restore the optimizer state")
        if run == "discrete":
            # the backward is cnf_dynamics_vjp under autograd: no evaluation
            # beyond the forward's, which is what the logged NFE counts
            forward = sum(math.floor(v[1]) for v in train_nfe + val_nfe)
            info["nfe_exhaustion_marker"] = any(v % 1.0 for pair in train_nfe for v in pair)
            info["cnf_forward_evaluations_logged"] = forward
            if counts["cnf_dynamics"] != forward or len(val_nfe) != 1:
                raise AssertionError(f"discrete: cnf_dynamics {counts['cnf_dynamics']} launches, "
                                     f"logged forward NFE {forward} ({val_nfe})")
        runs[run] = info
        print(json.dumps(info), flush=True)
    return {"train_runs": runs, "copies": copies, "cfg": cfg, "test_args": test_args,
            "test_log": stem + ".txt"}


VIZ_KERNELS = RECONSTRUCT_KERNELS + ("emd",)
VIZ_STEPS = 30  # the viz CLI's --num-sampled-steps default
# decoded points of phase 9's card-against-CPU reconstruct (30 times each):
# the CPU's share of the phase
VIZ_CROSS_POINTS = 512
CUBE_ROWS = 2 * 12 * 24  # the ground-truth and prediction NOCS cubes
FRUSTUM_ROWS = 2 * 64  # the ground-truth and predicted camera frusta


def read_ply(path):
    """The vertex rows of an ASCII PLY as an (n, 6) array (x y z r g b);
    raises unless the rows are the header's count."""
    with open(path) as f:
        head, body = f.read().split("end_header\n")
    n = int(re.search(r"element vertex (\d+)", head).group(1))
    values = np.array(body.split(), dtype=np.float64)
    if values.size != 6 * n:
        raise AssertionError(f"{path}: {values.size} values for {n} vertices")
    return values.reshape(n, 6)


def check_scenes(out_dir, scenes, animation):
    """Each scene of {name: (frames, vertices a frame)} holds exactly its
    frame_####.ply files, viewer.html and (where ``animation``) an
    animation; every frame has that many vertices, all finite.  Returns
    the frames' rows by scene."""
    rows = {}
    for name, (frames, vertices) in scenes.items():
        scene = os.path.join(out_dir, name)
        want = {f"frame_{i:04d}.ply" for i in range(frames)} | {"viewer.html"}
        files = set(os.listdir(scene)) if os.path.isdir(scene) else set()
        anim = files & {"animation.gif", "contact_sheet.png"}
        if files - anim != want or bool(anim) != animation:
            raise AssertionError(f"{name}: files {sorted(files)}, expected {frames} frames, "
                                 f"viewer.html{' and an animation' if animation else ''}")
        rows[name] = [read_ply(os.path.join(scene, f"frame_{i:04d}.ply")) for i in range(frames)]
        bad = [i for i, r in enumerate(rows[name])
               if r.shape[0] != vertices or not np.all(np.isfinite(r[:, :3]))]
        if bad:
            raise AssertionError(f"{name}: frames {bad} not {vertices} finite vertices")
    return rows


def wallclock_lines(lines):
    """{"model <scene>" or "export <scene>": seconds} of the viz CLI's
    wallclock lines among ``lines``."""
    return {k: float(v) for line in lines
            for k, v in re.findall(r"^\[((?:model|export) \S+)\] ([0-9.]+)s$", line)}


def logged_wallclock(log_path):
    with open(log_path) as f:
        return wallclock_lines(f.read().splitlines())


def run_viz_path(torch, kernels, out_dir, card):
    """Phase 9: the viz command line and the test CLI's pose scenes over a
    synthetic tree at full width, the interpolated reconstruct card against
    CPU, cnf_primal and emd at the viz shapes, one profiled scene."""
    import importlib.util

    from caspr_tpu_torch.cli import test as cli_test
    from caspr_tpu_torch.cli import viz as cli_viz
    from caspr_tpu_torch.data import DynamicPCLDataset, SequenceLoader, write_synthetic_tree
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.checks import tf32x3_arithmetic as tf32x3
    from caspr_tpu_torch.ops import cnf_fused
    from caspr_tpu_torch.ops.emd_plain import emd_plain
    from caspr_tpu_torch.utils.profiling import annotate, device_trace
    from caspr_tpu_torch.viz.export import NO_ANIMATION, SAMPLE_CONTOURS_RADII
    from caspr_tpu_torch.weights import DEMO_CHECKPOINT, load_demo

    animation = importlib.util.find_spec("matplotlib") is not None
    tree = write_synthetic_tree(os.path.join(out_dir, "viz_tree"), seed=SEED,
                                split_sizes={"test": 2})
    tree1 = write_synthetic_tree(os.path.join(out_dir, "viz_tree1"), seed=SEED,
                                 split_sizes={"test": 1})
    seqs = [f"test_{i:04d}_seq_00000000" for i in range(2)]
    common = ["--weights", DEMO_CHECKPOINT, "--seq-len", str(FRAMES), "--num-pts", str(POINTS),
              "--seed", str(SEED)]
    recon_rows = 4 * POINTS + CUBE_ROWS  # ground truth, input, prediction, base samples
    report = {}

    def run_cli(label, main, argv, scenes, log_name):
        kernels.reset_launches()
        start = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = dict(kernels.launches)
        out = argv[argv.index("--out") + 1]
        rows = check_scenes(out, scenes, animation)
        with open(os.path.join(out, log_name)) as f:
            said = f.read().count(NO_ANIMATION)
        if said != (0 if animation else 1):
            raise AssertionError(f"{label}: the no-animation line logged {said} times")
        report[label] = {"seconds": seconds, "launches": counts}
        return counts, rows, os.path.join(out, log_name)

    # (a) the viz CLI: T-NOCS with its error map, observed and interpolated
    # scenes of both sequences
    out = os.path.join(out_dir, "viz")
    scenes = {}
    for seq in seqs:
        scenes[f"{seq}_tnocs"] = (FRAMES, 3 * POINTS + CUBE_ROWS)
        scenes[f"{seq}_observed"] = (FRAMES, recon_rows)
        scenes[f"{seq}_interpolated"] = (VIZ_STEPS, recon_rows)
    counts, _, log_path = run_cli(
        "viz CLI", cli_viz.main,
        ["--data-cfg", tree, *common, "--out", out, "--viz-tnocs", "--tnocs-err-map",
         "--viz-observed", "--viz-interpolated", "--num-sampled-pts", str(POINTS),
         "--num-sampled-steps", str(VIZ_STEPS)], scenes, "viz_log.txt")
    require_launched(counts, VIZ_KERNELS, "viz CLI")
    forbid_launched(counts, ("cnf_dynamics", "cnf_dynamics_vjp", "sa_fused"), "viz CLI")
    metrics = log_numbers(log_path, r"Cur (?:L2 nocs spatial error|Mean Chamfer|Mean EMD): "
                          + FLOAT)
    if len(metrics) != 3 * len(seqs) or not np.all(np.isfinite(metrics)):
        raise AssertionError(f"viz CLI: T-NOCS error, Chamfer and EMD {metrics}")
    report["viz CLI"].update(seconds_by_scene=logged_wallclock(log_path),
                             tnocs_chamfer_emd_x1000=[m[0] for m in metrics])

    # (b) contour base samples, one sequence: the prediction and the base
    # samples take the contours' palette colours
    out = os.path.join(out_dir, "viz_contours")
    scene = f"{seqs[0]}_observed"
    counts, rows, log_path = run_cli(
        "viz CLI --sample-contours", cli_viz.main,
        ["--data-cfg", tree1, *common, "--out", out, "--viz-observed", "--sample-contours"],
        {scene: (FRAMES, recon_rows)}, "viz_log.txt")
    require_launched(counts, VIZ_KERNELS, "viz CLI --sample-contours")
    forbid_launched(counts, ("cnf_dynamics", "cnf_dynamics_vjp", "sa_fused"),
                    "viz CLI --sample-contours")
    colours = {tuple(c) for c in rows[scene][0][2 * POINTS:4 * POINTS, 3:].astype(int)}
    if not 1 < len(colours) <= 6:
        raise AssertionError(f"contour colours {sorted(colours)}")
    report["viz CLI --sample-contours"].update(seconds_by_scene=logged_wallclock(log_path),
                                               contour_colours=len(colours))

    # (c) the test CLI's pose scenes
    out = os.path.join(out_dir, "pose")
    counts, _, _ = run_cli(
        "test CLI --show-pose-viz", cli_test.main,
        ["--data-cfg", tree, *common, "--out", out, "--batch-size", str(BATCH),
         "--eval-pose-observed-ransac", "--show-pose-viz"],
        {f"pose_{seq}": (FRAMES, 4 * POINTS + FRUSTUM_ROWS) for seq in seqs}, "test_log.txt")
    require_launched(counts, RECONSTRUCT_KERNELS[:-1], "test CLI --show-pose-viz")
    forbid_launched(counts, ("cnf_primal", "cnf_dynamics", "cnf_dynamics_vjp", "emd"),
                    "test CLI --show-pose-viz")
    for label in report:
        print(json.dumps({"viz": label, "card": card, **report[label]}), flush=True)

    # (d) the interpolated reconstruct at the viz settings, card against
    # CPU: the first sequence, 30 shared times, the same base samples at
    # every time, Gaussian and on the contour radii
    batch = next(iter(SequenceLoader(DynamicPCLDataset(
        tree, split="test", num_pts=POINTS, seq_len=FRAMES, shift_time_to_zero=True,
        random_point_sample=False), batch_size=1)))
    x = torch.from_numpy(batch["input"])
    times = cli_viz.interpolation_times(VIZ_STEPS)
    rng = np.random.default_rng(SEED)
    cpu_model = CaSPRModel(CaSPRConfig(), device="cpu")
    bases = {
        "gaussian": torch.from_numpy(
            rng.standard_normal((1, VIZ_CROSS_POINTS, 3)).astype(np.float32)),
        "contours": cpu_model.sample_base(torch.Generator().manual_seed(SEED), 1,
                                          VIZ_CROSS_POINTS, sample_contours=SAMPLE_CONTOURS_RADII),
    }
    out = {}
    for dev in ("cuda", "cpu"):
        model = CaSPRModel(CaSPRConfig(), device=dev)
        params, state = load_demo(device=dev)
        for name, base in bases.items():
            y = base[:, None].expand(1, VIZ_STEPS, VIZ_CROSS_POINTS, 3).contiguous().to(dev)
            with torch.no_grad():
                _, logp, rec, _, nfe = model.reconstruct(
                    params, state, x.to(dev), None, num_points=VIZ_CROSS_POINTS,
                    timestamps=times.to(dev), base_samples=y)
            out[dev, name] = (rec.cpu(), logp.cpu(), nfe)
    for name in bases:
        (rec, logp, nfe), (crec, clogp, cnfe) = out["cuda", name], out["cpu", name]
        errs = {"points": float((rec - crec).abs().max()), "logp": float((logp - clogp).abs().max())}
        scale = {"points": max(1.0, float(crec.abs().max())),
                 "logp": max(1.0, float(clogp.abs().max()))}
        print(json.dumps({"cross_device": f"viz interpolated reconstruct, {name} base: B=1 T=10 "
                                          f"N=2048 -> {VIZ_STEPS} times x {VIZ_CROSS_POINTS}",
                          "nfe": [nfe, cnfe], "max_abs_err": errs, "scale": scale,
                          "tolerance": "equal NFE; 1e-3 x max(1, the CPU's largest magnitude)"}),
              flush=True)
        if nfe != cnfe or any(errs[k] > 1e-3 * scale[k] for k in errs):
            raise AssertionError(f"viz reconstruct ({name} base), card vs CPU: see the line above")

    # (e) cnf_primal at the interpolated decode's shape (30 times x 2048
    # rows, the context of this sequence's latent at the 30 times) and emd
    # at an observed scene's 10 frame pairs of 2048 points (uniform clouds),
    # held to their plain versions
    dev = torch.device("cuda")
    model = CaSPRModel(CaSPRConfig(), device="cuda")
    params, state = load_demo(device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        z0, _ = model.encode(params, x.to(dev))
        z, _ = model.aggregate_and_solve_latent(params, z0, times.to(dev)[None],
                                                shared_times=True)
        odenet = params["point_cnf"][1]["odenet"]
        tc = torch.cat([torch.full((VIZ_STEPS, 1), 0.25, device=dev), z.reshape(VIZ_STEPS, -1)],
                       dim=1)
        y = torch.randn((VIZ_STEPS, POINTS, 3), generator=gen, device=dev)
        gb = cnf_fused.context_gb(odenet, tc)
        wf, wh, wl = cnf_fused.pack_weights(odenet)
        w64 = [t.double() for t in (gb, wf, wh, wl)]
        weights_bytes = sum(t.numel() for t in (gb, wf, wh, wl)) * 4.0
        viz_rows = {"cnf_primal": cnf_case(torch, "cnf_primal", dict(
            run=lambda: (kernels.cnf_primal(y, gb, wf, wh, wl),),
            plain=lambda: (cnf_fused.primal_packed(y, gb, wf, wh, wl),),
            emulation=lambda: (tf32x3.primal_tf32x3(y, gb, wf, wh, wl),),
            exact=(cnf_fused.primal_packed(y.double(), *w64),), streams=1,
            bytes=y.numel() * 2 * 4.0 + weights_bytes,
            shape=f"y ({VIZ_STEPS}, {POINTS}, 3), H {wf.shape[0]}, one sequence's latent"),
            VIZ_STEPS * POINTS, wh.shape[0], wf.shape[0])}
        rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
        pred, target = rand(FRAMES, POINTS, 3), rand(FRAMES, POINTS, 3)
        viz_rows["emd"] = emd_case(torch, pred, target)
        viz_rows["emd"].update(
            plain_ms=time_ms(torch, lambda: emd_plain(pred, target), reps=3), library_ms=None,
            tolerance="against float64 plain: body in float64 1e-9; float32 each pair 1e-3 "
                      "relative, mean 2e-4 (or 2x plain's mean); deterministic")
    for name, row in viz_rows.items():
        bound_ms, bound_by = bound(*row.pop("work"))
        print(json.dumps({"kernel": name, "path": "viz", **row, "bound_ms": bound_ms,
                          "bound_by": bound_by}), flush=True)

    # (f) one interpolated scene (the reconstruct and its export), once for
    # its wall time and once under the port's device_trace
    flags = cli_viz.parse_args(["--data-cfg", tree, "--out", os.path.join(out_dir, "profiled"),
                                "--viz-interpolated", "--num-sampled-steps", str(VIZ_STEPS),
                                "--num-sampled-pts", str(POINTS)])
    pcl_in, nocs_out = batch["input"], batch["target"]
    seconds = {}

    def scene(name):
        say = lambda line: seconds.update(wallclock_lines([line]))
        return cli_viz.interpolated_scene(flags, model, params, state, pcl_in, nocs_out, gen,
                                          name, say=say, note=lambda line: None)

    start = time.perf_counter()
    _, nfe = scene("scene")
    wall_ms = (time.perf_counter() - start) * 1e3
    label = "viz interpolated scene"
    with device_trace(os.path.join(out_dir, "trace")) as prof, annotate(label):
        scene("scene_profiled")
    device_ms = device_time(torch, prof)
    device_ms.pop(label, None)  # the range, where the profiler does not mark it as one
    busy = sum(ms for ms, _ in device_ms.values())
    (trace,) = os.listdir(os.path.join(out_dir, "trace"))
    top = sorted(device_ms.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({
        "profile": "viz interpolated scene (30 x 2048 decoded, PLY and viewer export) under "
                   "caspr_tpu_torch.utils.profiling.device_trace", "card": card,
        "unprofiled_wall_ms": wall_ms, "model_s": seconds["model scene"],
        "export_s": seconds["export scene"], "nfe": list(nfe),
        "device_busy_ms": busy if busy else "not measured",
        "device_idle_share": 1.0 - busy / wall_ms if busy else "not measured",
        "device_idle_share_of_model": 1.0 - busy / (seconds["model scene"] * 1e3) if busy
        else "not measured",
        "annotated": any(e.key == label for e in prof.key_averages()),
        "trace_bytes": os.path.getsize(os.path.join(out_dir, "trace", trace)),
        "top": [{"name": k, "ms": ms, "calls": n} for k, (ms, n) in top]}), flush=True)
    if not busy:
        raise AssertionError("the profiled viz scene shows no device time")


# phase 10: the global batch of the two-rank train step, and its ranks
PAR_B, PAR_RANKS = 4, 2
PAR_LR = 1e-4
# phase 10(b)'s bars against phase 8, relative to each value: the .csv's
# per-sequence means (2-row decodes and encodes round otherwise than 4-row
# ones on the card: 6.0e-7 relative on shape reconstruction and 2.8e-7 on
# T-NOCS were read, where rows out of order differ by 1.0e-2 and 3.1e-2
# at least), and the pose protocol's errors (RANSAC's pose moves with the
# encoder's rounding; tests/test_torch_port_parallel.py's bar).
PAR_CSV_REL, PAR_POSE_REL = 5e-6, 1e-4


def parallel_step_input(batch=PAR_B):
    """Phase 10's global batch, 4 sequences x 5 frames x 1024 points in
    the form of phase 6's, and its Hutchinson noise, as numpy arrays."""
    rng = np.random.default_rng(SEED + 10)
    times = np.sort(rng.random((batch, TRAIN_T), dtype=np.float32), axis=1)
    times -= times[:, :1]
    x = rng.random((batch, TRAIN_T, TRAIN_N, 4), dtype=np.float32)
    x[..., 3] = times[:, :, None] * 5.0
    target = rng.random((batch, TRAIN_T, TRAIN_N, 4), dtype=np.float32)
    target[..., 3] = times[:, :, None]
    noise = rng.standard_normal((batch * TRAIN_T, TRAIN_N, 3)).astype(np.float32)
    return x, target, noise


def one_process_steps(torch, x, target, noise):
    """The one-process train step on the card from the demo weights, with
    the continuous adjoint and with the discrete backward, Adam at PAR_LR:
    {backward: (metrics, {path: gradient})}."""
    from caspr_tpu_torch.checks.ranks import RecordingOptimizer
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.ops.odeint import flatten_tree
    from caspr_tpu_torch.train import make_train_step
    from caspr_tpu_torch.weights import load_demo

    model = CaSPRModel(CaSPRConfig(), device="cuda")
    out = {}
    for backward in ("adjoint", "discrete"):
        params, state = load_demo(device=model.device)
        leaves = flatten_tree(params)[0]
        opt = RecordingOptimizer(torch.optim.Adam(leaves, lr=PAR_LR), leaves)
        step = make_train_step(model, None, 0.01, 100.0, ode_backward=backward)
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, _, _, m = step(params, opt, state, x, target, e=torch.from_numpy(noise).cuda())
        torch.cuda.synchronize()
        out[backward] = (m, dict(zip(leaf_paths(params), opt.grads)), time.perf_counter() - start)
    return out


def compare_parallel_step(ranks, one, floor, backward,
                          label=f"train step, {PAR_RANKS} gloo ranks sharing the card against one "
                                "process", bars=None):
    """A step on ranks against the one-process step: NFE, the loss, every
    flow and latent-ODE gradient leaf (of its largest), the encoder's in
    relative L2, and the ranks' parameters equal.  ``bars``: (loss, leaf,
    encoder), by default data parallelism's 1e-4, 1e-3 and 4x the float32
    floor."""
    loss_bar, leaf_bar, enc_bar = bars or (1e-4, 1e-3, 4.0 * floor)
    m1, grads1, seconds1 = one
    got = ranks[0]
    nfe_ok = all(r["metrics"]["nfe"] == m1["nfe"] and r["metrics"]["nfe_forward"]
                 == m1["nfe_forward"] for r in ranks)
    loss_rel = abs(got["metrics"]["loss"] - m1["loss"]) / abs(m1["loss"])
    rel = {p: float(np.abs(got["grads"][p] - g).max() / max(float(np.abs(g).max()), 1e-30))
           for p, g in grads1.items()}
    rest = {p: r for p, r in rel.items() if not p.startswith("encoder.")}
    enc = [p for p in grads1 if p.startswith("encoder.")]
    flat = lambda grads: np.concatenate([grads[p].ravel().astype(np.float64) for p in enc])
    enc_l2 = float(np.linalg.norm(flat(got["grads"]) - flat(grads1)) / np.linalg.norm(flat(grads1)))
    equal = all(np.array_equal(r[k][p], got[k][p]) for r in ranks[1:]
                for k in ("params", "state", "grads") for p in got[k])
    worst = sorted(rest.items(), key=lambda kv: -kv[1])[:3]
    print(json.dumps({
        "parallel": label, "backward": backward, "global_batch": PAR_B, "frames": TRAIN_T, "points": TRAIN_N,
        "nfe": [r["metrics"]["nfe"] for r in ranks] + [m1["nfe"]],
        "nfe_forward": [r["metrics"]["nfe_forward"] for r in ranks] + [m1["nfe_forward"]],
        "loss": [got["metrics"]["loss"], m1["loss"]], "loss_rel_err": loss_rel,
        "flow_and_latent_rel_err_max": max(rest.values()), "flow_and_latent_worst": worst,
        "encoder_rel_l2": enc_l2, "encoder_float32_floor_rel_l2": floor,
        "ranks_bit_equal": equal, "step_seconds": {"ranks": [r["seconds"] for r in ranks],
                                                   "one_process": seconds1},
        "collectives_per_step": got["collectives"],
        "launches": [r["launches"] for r in ranks],
        "tolerance": {"loss": loss_bar, "flow_and_latent_leaf": leaf_bar,
                      "encoder_rel_l2": enc_bar}}), flush=True)
    if (not nfe_ok or not loss_rel <= loss_bar or not max(rest.values()) <= leaf_bar
            or not enc_l2 <= enc_bar or not equal):
        raise AssertionError(f"{backward} step on ranks against one process: see the line above")


def compare_test_cli(runs, outs, phase8, label, card, ranks_seconds):
    """Phase 10(b) and 11(b): the test CLI's artifacts on ranks (``runs``:
    {"recon": each rank's "cli" result of --eval-test
    --eval-shape-recon-observed, "tnocs": of --eval-tnocs-regression
    --eval-pose-observed-ransac}, written to ``outs``) against phase 8's
    one-process run, from rank 0 alone: the .npz within 1e-5 (the pose
    protocol's PAR_POSE_REL relative), the .csv's ids equal and values
    within PAR_CSV_REL relative, the NFE and the --eval-test loss."""
    with open(phase8["test_log"]) as f:
        want_nfe = re.findall(r"^NFE Mean: \(" + FLOAT + ", " + FLOAT + r"\)", f.read(), re.M)[0]
    test_line = r"Batch 0/0\] TEST Mean loss: " + FLOAT
    want_loss = log_numbers(phase8["test_log"], test_line)
    cli = {}
    # (protocol, its CLI run, phase 8's copy, artifact stem, .npz keys, .csv id columns, bars):
    # the .npz absolute, the .csv relative to each value (PAR_CSV_REL); the
    # pose protocol's both relative (PAR_POSE_REL), as in
    # tests/test_torch_port_parallel.py
    protocols = (
        ("recon", "recon", "recon_observed", "test_log", ("observed_chamfer", "observed_emd"), 3,
         (1e-5, 0.0), PAR_CSV_REL),
        ("tnocs", "tnocs", "tnocs", "test_log", ("space", "time"), 2, (1e-5, 0.0), PAR_CSV_REL),
        ("pose", "tnocs", "pose", "test_log_RANSAC", ("trans", "rot", "point", "point_mean"), 2,
         (0.0, PAR_POSE_REL), PAR_POSE_REL))
    want_files = {"recon": ["test_log.txt", "test_log.npz", "test_log.csv", "rank1_test_log.txt"]}
    want_files["tnocs"] = want_files["recon"] + ["test_log_RANSAC.npz", "test_log_RANSAC.csv"]
    for name, run, ref, stem_name, keys, ids, (npz_abs, npz_rel), csv_rel in protocols:
        out = outs[run]
        stem = os.path.join(out, stem_name)
        written = sorted(os.listdir(out))
        got, want = np.load(stem + ".npz"), np.load(phase8["copies"][ref] + ".npz")
        npz_ok = all(got[k].shape == want[k].shape and bool(np.all(
            np.abs(got[k] - want[k]) <= npz_abs + npz_rel * np.abs(want[k]))) for k in keys)
        npz_diff = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
        with open(stem + ".csv") as f:
            rows = [r.split(",") for r in f.read().splitlines()]
        with open(phase8["copies"][ref] + ".csv") as f:
            want_rows = [r.split(",") for r in f.read().splitlines()]
        same_ids = [r[:ids] for r in rows] == [r[:ids] for r in want_rows]
        values = lambda table: np.array([r[ids:] for r in table[1:]], float)
        got_v, want_v = values(rows), values(want_rows)
        csv_rel_diff = float((np.abs(got_v - want_v) / np.abs(want_v)).max()) \
            if got_v.shape == want_v.shape else math.inf
        # what rows out of order would show at least: the smallest gap
        # between two sequences' values in one column, over its value
        gaps = [abs(a - b) / abs(b) for col in want_v.T for i, a in enumerate(col)
                for b in col[i + 1:]]
        cli[name] = {"files": written, "npz_max_abs_diff": npz_diff, "csv_ids_equal": same_ids,
                     "csv_rows_identical": rows == want_rows, "csv_max_rel_diff": csv_rel_diff,
                     "csv_rel_tolerance": csv_rel, "row_order_min_rel_gap": min(gaps, default=None),
                     "launches": [r["launches"] for r in runs[run]],
                     "seconds": [r["seconds"] for r in runs[run]],
                     "collectives": runs[run][0]["collectives"]}
        if name == "recon":
            with open(stem + ".txt") as f:
                cli[name]["nfe"] = re.findall(r"^NFE Mean: \(" + FLOAT + ", " + FLOAT + r"\)",
                                              f.read(), re.M)
            cli[name]["nfe_one_process"] = want_nfe
            cli[name]["test_loss"] = log_numbers(stem + ".txt", test_line)
            cli[name]["test_loss_one_process"] = want_loss
            if cli[name]["nfe"] != [want_nfe]:
                raise AssertionError(f"{label}: NFE {cli[name]['nfe']}, one process {want_nfe}")
            if (len(cli[name]["test_loss"]) != 1
                    or not abs(cli[name]["test_loss"][0][0] - want_loss[0][0])
                    <= 1e-5 * abs(want_loss[0][0])):
                raise AssertionError(f"{label}: --eval-test loss {cli[name]['test_loss']}, one "
                                     f"process {want_loss}")
            for launches in cli[name]["launches"]:
                require_launched(launches, VIZ_KERNELS, label)
        if (written != sorted(want_files[run]) or not npz_ok or not same_ids
                or len(rows) != len(want_rows) or not csv_rel_diff <= csv_rel):
            raise AssertionError(f"{label} ({name}) against phase 8: {cli[name]}")
    print(json.dumps({"parallel": label, "card": card, "ranks_seconds": ranks_seconds,
                      "protocols": cli}), flush=True)


def run_parallel_path(torch, kernels, phase8, floor, card):
    """Phase 10: data parallelism.  (a) a train step and (b) the test CLI
    on two gloo ranks that share the card, against the one-process runs;
    (c) the train CLI under torchrun on nccl, a group of one, two epochs
    (the first one's steps carry the fresh process's warm-up and nccl's
    first collective; phase 8's run in this process is warm)."""
    from caspr_tpu_torch.checks.ranks import run_ranks, run_torchrun

    begun = time.perf_counter()
    x, target, noise = parallel_step_input()
    one = one_process_steps(torch, x, target, noise)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="phase10_", dir=os.path.dirname(phase8["test_log"]))
    case = {"x": x, "target": target, "e": noise, "optimizer": "adam", "lr": PAR_LR}
    test_args = [a for a in phase8["test_args"]]
    outs = {name: os.path.join(work, f"cli_test_{name}") for name in ("recon", "tnocs")}
    parts = [{"job": "steps", "cases": [case, dict(case, ode_backward="discrete")]},
             # --eval-test first, as in phase 8: its Hutchinson noise comes
             # from the generator ahead of the decoder's base samples
             {"job": "cli", "cli": "test",
              "argv": test_args + ["--out", outs["recon"], "--parallel", "--eval-test",
                                   "--eval-shape-recon-observed"]},
             {"job": "cli", "cli": "test",
              "argv": test_args + ["--out", outs["tnocs"], "--parallel",
                                   "--eval-tnocs-regression", "--eval-pose-observed-ransac"]}]
    start = time.perf_counter()
    results = run_ranks(PAR_RANKS, {"job": "parts", "backend": "gloo", "device": "cuda:0",
                                    "weights": "demo", "parts": parts, "timeout": 300},
                        os.path.join(work, "ranks"), timeout=600)
    ranks_seconds = time.perf_counter() - start

    # (a) the train step, adjoint then discrete
    steps = [r[0] for r in results]
    for r in steps:
        require_launched(r[0]["launches"], TRAIN_KERNELS, "two-rank train step")
    for i, backward in enumerate(("adjoint", "discrete")):
        compare_parallel_step([r[i] for r in steps], one[backward], floor, backward)

    # (b) the test CLI: phase 8's artifacts, from rank 0 alone
    compare_test_cli({"recon": [r[1] for r in results], "tnocs": [r[2] for r in results]},
                     outs, phase8, f"test CLI --parallel, {PAR_RANKS} gloo ranks sharing the "
                     "card, against phase 8's one-process run", card, ranks_seconds)

    # (c) torchrun, one rank on nccl, --parallel --multihost: the train CLI
    run_out = os.path.join(work, "cli_train_torchrun")
    train_args = ["--data-cfg", phase8["cfg"], "--seq-len", str(TRAIN_T), "--num-pts",
                  str(TRAIN_N), "--batch-size", str(TRAIN_B), "--val-every", "1",
                  "--save-every", "1", "--print-every", "1", "--seed", str(SEED), "--epochs", "2",
                  "--out", run_out, "--parallel", "--multihost"]
    start = time.perf_counter()
    (res,) = run_torchrun(1, {"job": "cli", "cli": "train", "argv": train_args},
                          os.path.join(work, "torchrun"), timeout=600)
    seconds = time.perf_counter() - start
    log_path = os.path.join(run_out, "train_log.txt")
    losses = [v[0] for v in log_numbers(log_path, r"TRAIN Mean loss: " + FLOAT)]
    timing = log_numbers(log_path, r"TIMING epoch \d+: " + FLOAT + r" s per train step over "
                         r"(\d+) steps")
    with open(log_path) as f:
        text = f.read()
    require_launched(res["launches"], TRAIN_KERNELS, "torchrun train CLI")
    one_step = phase8["train_runs"]["adjoint"]["s_per_train_step_by_epoch"]
    info = {"parallel": "torchrun --nproc_per_node 1 train CLI --parallel --multihost (nccl)",
            "card": card, "backend": res["backend"], "seconds": seconds, "losses": losses,
            "s_per_train_step_by_epoch": [t[0] for t in timing],
            "phase8_one_process_s_per_train_step_by_epoch": one_step,
            "collectives": res["collectives"], "launches": res["launches"],
            "mesh_line": re.findall(r"Parallel mesh over [^\n]*", text),
            "files": sorted(os.listdir(run_out)), "phase_seconds": time.perf_counter() - begun}
    print(json.dumps(info), flush=True)
    if (not losses or not all(np.isfinite(losses)) or res["backend"] != "nccl"
            or not os.path.exists(os.path.join(run_out, "time_model_1.pkl"))
            or info["mesh_line"] != ["Parallel mesh over 1 devices, axes ('dp',) (1,), rank 0"]):
        raise AssertionError(f"torchrun train CLI: {info}")
    return one


# phase 11: point parallelism, (dp 1, sp 2) on two gloo ranks sharing the card
SP_RANKS = 2
# phase 11(a)'s bars against the one-process step (loss, flow or latent
# leaf of its largest, encoder relative L2).  With dp 1 only the sums over
# points are reordered: 4.7e-8, 9.2e-7 and 3.3e-6 were read (adjoint; the
# discrete step less) on an H100 80GB HBM3 at 700 W.  A context cotangent
# not summed over sp halves the encoder's gradient through the latent code,
# and a value replicated over sp but counted on each rank doubles its
# leaves; a share off by far less than a factor of 2 still fails them.
SP_STEP_BARS = (1e-6, 1e-5, 1e-4)
# the point counts a row the CNF kernels take under sp: 2048 and 1024
# points over sp 2 and 4, and 1000 over 2 (a ragged last 64-row tile)
SP_CNF_POINTS = (1024, 512, 256, 500)


def check_sp_cnf_shapes(torch):
    """Phase 11(e): cnf_primal, cnf_dynamics and cnf_dynamics_vjp at the
    point counts a rank holds under sp (SP_CNF_POINTS), 20 clouds of each,
    from the demo weights, against their plain versions in float64 on the
    card: each output within 1e-4 of its largest magnitude."""
    from caspr_tpu_torch.ops import cnf_fused, kernels
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    odenet = load_demo(device=dev)[0]["point_cnf"][1]["odenet"]
    wf, wh, wl = cnf_fused.pack_weights(odenet)
    bt = 20
    tc = torch.cat([torch.full((bt, 1), 0.25, device=dev),
                    torch.randn((bt, 1600), generator=gen, device=dev)], dim=1)
    gb = cnf_fused.context_gb(odenet, tc)
    w64 = [t.double() for t in (gb, wf, wh, wl)]
    errs = {}
    for n in SP_CNF_POINTS:
        y, e, ct = (torch.randn((bt, n, 3), generator=gen, device=dev) for _ in range(3))
        ct_div = torch.randn((bt, n), generator=gen, device=dev)
        cases = {
            "cnf_primal": ((kernels.cnf_primal(y, gb, wf, wh, wl),),
                           (cnf_fused.primal_packed(y.double(), *w64),)),
            "cnf_dynamics": (kernels.cnf_dynamics(y, e, gb, wf, wh, wl),
                             cnf_fused.dynamics_packed(y.double(), e.double(), *w64)),
            "cnf_dynamics_vjp": (
                kernels.cnf_dynamics_vjp(y, e, gb, wf, wh, wl, ct, ct_div),
                cnf_fused.dynamics_vjp_packed(y.double(), e.double(), *w64, ct.double(),
                                              ct_div.double())),
        }
        for name, (got, exact) in cases.items():
            errs[f"{name} N={n}"] = max(float((g.double() - x).abs().max() / x.abs().max())
                                        for g, x in zip(got, exact))
    print(json.dumps({"sp_cnf_kernels": "the CNF kernels at the point counts of a rank under sp, "
                      "against float64", "clouds": bt, "rel_err_vs_float64": errs,
                      "tolerance": 1e-4}), flush=True)
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"CNF kernels at sp point counts: {errs}")


def sp_reconstruct_input(torch):
    """Phase 11(c)'s reconstruct: phase 3's input and decode times and
    base samples from SEED + 11, as numpy arrays."""
    x, timestamps, _ = reconstruct_input(torch)
    base = np.random.default_rng(SEED + 11).standard_normal(
        (BATCH, FRAMES, POINTS, 3)).astype(np.float32)
    return x.cpu().numpy(), timestamps.cpu().numpy(), base


def one_process_reconstruct(torch, x, timestamps, base):
    """The one-process reconstruct of phase 3 on the card from the demo
    weights, with the given base samples: (points, NFE, seconds of the
    second of two runs)."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    model = CaSPRModel(CaSPRConfig(), device="cuda")
    params, state = load_demo(device=model.device)
    args = [torch.as_tensor(a, device=model.device) for a in (x, timestamps, base)]
    for _ in range(2):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.no_grad():
            _, _, x_rec, _, nfe = model.reconstruct(params, state, args[0], None,
                                                    num_points=x.shape[2], timestamps=args[1],
                                                    base_samples=args[2])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    return x_rec.cpu().numpy(), nfe, seconds


def compare_sp_reconstruct(ranks, one, label, card):
    """The ranks' point ranges, joined in sp-rank order, against the
    one-process reconstruct: equal NFE, every point within 1e-3."""
    points, nfe, seconds = one
    got = np.concatenate([r["points"] for r in ranks], axis=2)
    diff = float(np.abs(got - points).max()) if got.shape == points.shape else math.inf
    info = {"parallel": label, "card": card, "shape": list(points.shape),
            "nfe": [r["nfe"] for r in ranks] + [nfe], "max_abs_diff": diff, "tolerance": 1e-3,
            "seconds": {"ranks": [r["seconds"] for r in ranks], "one_process": seconds},
            "collectives": ranks[0]["collectives"], "launches": [r["launches"] for r in ranks]}
    print(json.dumps(info), flush=True)
    for r in ranks:
        require_launched(r["launches"], RECONSTRUCT_KERNELS, label)
    if not diff <= 1e-3 or any(tuple(r["nfe"]) != tuple(nfe) for r in ranks):
        raise AssertionError(f"{label}: see the line above")


def run_sp_path(torch, kernels, phase8, floor, card, one):
    """Phase 11: point parallelism on two gloo ranks that share the card
    as (dp 1, sp 2), in one launch: (a) phase 10's train step (global
    batch 4 x 5 frames x 1024 points, 512 a rank), adjoint and discrete,
    against phase 10's one-process steps ``one``; (b) the test CLI with
    --parallel --sp-size 2 against phase 8's one-process artifacts; (c) the
    full-width reconstruct, batch 4 x 10 x 2048 (1024 points a rank),
    against the one-process reconstruct on the same base samples; (d) the
    train CLI with --parallel --sp-size 2, one epoch of phase 8's recipe,
    against phase 8's first epoch; and (e) the CNF kernels at a rank's
    point counts."""
    from caspr_tpu_torch.checks.ranks import run_ranks

    begun = time.perf_counter()
    check_sp_cnf_shapes(torch)
    x, target, noise = parallel_step_input()
    rx, rts, rbase = sp_reconstruct_input(torch)
    one_recon = one_process_reconstruct(torch, rx, rts, rbase)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="phase11_", dir=os.path.dirname(phase8["test_log"]))
    case = {"x": x, "target": target, "e": noise, "optimizer": "adam", "lr": PAR_LR}
    outs = {name: os.path.join(work, f"cli_test_{name}") for name in ("recon", "tnocs")}
    train_out = os.path.join(work, "cli_train")
    sp_flags = ["--parallel", "--sp-size", str(SP_RANKS)]
    parts = [{"job": "steps", "cases": [case, dict(case, ode_backward="discrete")]},
             {"job": "cli", "cli": "test",
              "argv": phase8["test_args"] + ["--out", outs["recon"], *sp_flags, "--eval-test",
                                             "--eval-shape-recon-observed"]},
             {"job": "cli", "cli": "test",
              "argv": phase8["test_args"] + ["--out", outs["tnocs"], *sp_flags,
                                             "--eval-tnocs-regression",
                                             "--eval-pose-observed-ransac"]},
             {"job": "reconstruct", "x": rx, "timestamps": rts, "base": rbase},
             {"job": "cli", "cli": "train",
              "argv": ["--data-cfg", phase8["cfg"], "--seq-len", str(TRAIN_T), "--num-pts",
                       str(TRAIN_N), "--batch-size", str(TRAIN_B), "--val-every", "1",
                       "--save-every", "1", "--print-every", "1", "--seed", str(SEED),
                       "--epochs", "1", "--out", train_out, *sp_flags]}]
    start = time.perf_counter()
    results = run_ranks(SP_RANKS, {"job": "parts", "backend": "gloo", "device": "cuda:0",
                                   "sp_size": SP_RANKS, "weights": "demo", "parts": parts,
                                   "timeout": 300}, os.path.join(work, "ranks"), timeout=600)
    ranks_seconds = time.perf_counter() - start
    label = f"(dp 1, sp {SP_RANKS}) on {SP_RANKS} gloo ranks sharing the card"

    # (a) the train step, adjoint then discrete
    steps = [r[0] for r in results]
    for r in steps:
        require_launched(r[0]["launches"], TRAIN_KERNELS, f"{label}: train step")
        if r[0]["mesh"] != f"{SP_RANKS} devices, axes ('dp', 'sp') (1, {SP_RANKS})":
            raise AssertionError(f"{label}: mesh {r[0]['mesh']}")
    for i, backward in enumerate(("adjoint", "discrete")):
        compare_parallel_step([r[i] for r in steps], one[backward], floor, backward,
                              f"train step, {label}, against one process", SP_STEP_BARS)
    # (b) the test CLI
    compare_test_cli({"recon": [r[1] for r in results], "tnocs": [r[2] for r in results]},
                     outs, phase8, f"test CLI --parallel --sp-size {SP_RANKS}, {label}, against "
                     "phase 8's one-process run", card, ranks_seconds)
    # (c) the full-width reconstruct, point-sharded
    compare_sp_reconstruct([r[3] for r in results], one_recon,
                           f"reconstruct {BATCH} x {FRAMES} x {POINTS}, {label}, against one "
                           "process", card)
    # (d) the train CLI: rank 0 writes what one process writes, rank 1 its log
    logs = [os.path.join(train_out, name) for name in ("train_log.txt", "rank1_train_log.txt")]
    losses = [[v[0] for v in log_numbers(path, r"TRAIN Mean loss: " + FLOAT)] for path in logs]
    want = phase8["train_runs"]["adjoint"]["losses"][:len(losses[0])]
    rel = max((abs(a - b) / abs(b) for a, b in zip(losses[0], want)), default=math.inf)
    timing = log_numbers(logs[0], r"TIMING epoch \d+: " + FLOAT + r" s per train step")
    with open(logs[0]) as f:
        mesh_line = re.findall(r"Parallel mesh over [^\n]*", f.read())
    info = {"parallel": f"train CLI --parallel --sp-size {SP_RANKS}, {label}, one epoch against "
            "phase 8's first", "card": card, "losses": losses[0], "phase8_losses": want,
            "max_rel_diff": rel, "tolerance": 1e-4, "mesh_line": mesh_line,
            "s_per_train_step": [t[0] for t in timing], "files": sorted(os.listdir(train_out)),
            "launches": [r[4]["launches"] for r in results],
            "collectives": results[0][4]["collectives"]}
    print(json.dumps(info), flush=True)
    for r in results:
        require_launched(r[4]["launches"], TRAIN_KERNELS, f"{label}: train CLI")
    if (losses[0] != losses[1] or len(losses[0]) != len(want) or not rel <= 1e-4
            or mesh_line != [f"Parallel mesh over {SP_RANKS} devices, axes ('dp', 'sp') "
                             f"(1, {SP_RANKS}), rank 0"]
            or not {"time_model_0.pkl", "BEST_time_model.pkl", "rank1_train_log.txt"}
            <= set(info["files"])):
        raise AssertionError(f"{label}: train CLI: see the line above")
    print(json.dumps({"phase": "11", "card": card, "ranks_seconds": ranks_seconds,
                      "phase_seconds": time.perf_counter() - begun}), flush=True)


# phase 12: the rest of the CNF.  Each layer type with softplus and each
# nonlinearity with concatsquash (the twelve configs that are not the
# kernels' concatsquash + softplus); the JAX package reaches them through a
# CNFConfig, the port also through CaSPRConfig's cnf_layer_type and
# cnf_nonlinearity.
OTHER_LAYER_TYPES = ("ignore", "concat", "concat_v2", "squash", "scale", "concatscale")
OTHER_NONLINEARITIES = ("tanh", "relu", "elu", "square", "identity", "swish")
OTHER_CNF = ([(lt, "softplus") for lt in OTHER_LAYER_TYPES]
             + [("concatsquash", nl) for nl in OTHER_NONLINEARITIES])
# (b)'s CNF widths: phase 5b's composition config
OTHER_CNF_DIMS = (16, 32)
# (b)'s gain on the CNF layers' weights.  With caspr_init's weights these
# fields are close to linear at these widths: dopri5's error estimate sits
# at float32 rounding and the step sequence follows the order of the sums
# (the CPU's float32 and float64 runs of tanh, elu, identity, swish, squash
# and scale take different steps at gains of 1 to 4).  Phase 5b's gain of
# 6, where the float32 and float64 runs take the same steps, except where
# the field blows up at 6: ignore (its decode's points reach 5e9) and
# concat_v2 (3.4e3) take 3, where they agree.  relu takes none: its
# divergence, a step of the pre-activation, jumps where a point crosses a
# kink, and the rejected steps there follow rounding (at 3 the card's
# forward took 344 evaluations to the CPU's 338, at 6 the CPU's float32
# 1352 to its float64 1358); at 1 float32 and float64 agree (44).  square
# takes none: it blows up from a gain of 1.25, and its float64 decode takes
# 14 evaluations to float32's 20-26 at every gain from 0.25 to 1.2.
OTHER_CNF_GAIN = {"ignore": 3.0, "concat_v2": 3.0, "relu": 1.0, "square": 1.0}
# (d)'s configs: swish's learned beta, and concat's first layer, the widest
# (512 x (3 + 1 + 1600))
OTHER_CNF_STEPS = (("concatsquash", "swish"), ("concat", "softplus"))
CNF_LEAVES = ("cnf_primal", "cnf_dynamics", "cnf_dynamics_vjp")


def other_cnf_params(torch, layer_type, nonlinearity, dims, device):
    """caspr_init's draw (seed SEED) of a CaSPRConfig with these CNF
    settings: its point_cnf (params, state) on ``device``."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, caspr_init
    from caspr_tpu_torch.ops.odeint import flatten_tree

    cfg = CaSPRConfig(cnf_dims=dims, cnf_layer_type=layer_type, cnf_nonlinearity=nonlinearity)
    params, state = caspr_init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    move = lambda tree: (lambda lv: lv[1]([t.to(device) for t in lv[0]]))(flatten_tree(tree))
    return cfg.cnf_config(), move(params["point_cnf"]), move(state["point_cnf"])


def sample_div_decode(torch, kernels, model, params, state, card):
    """Phase 12(a): the reference-parity decode at full width (phase 3's
    input and base samples, a noise from SEED + 12), cnf_dynamics launched
    once per CNF evaluation and cnf_primal never, beside the default decode
    from the same call; then phase 5's reconstruct with it, card against
    CPU."""
    x, timestamps, gen = reconstruct_input(torch)
    base = model.sample_base(gen, BT, POINTS).reshape(BATCH, FRAMES, POINTS, 3)
    noise = torch.randn((BT, POINTS, 3), generator=torch.Generator(device="cuda").manual_seed(
        SEED + 12), device="cuda")
    runs = {}
    for mode, kw in (("default", {}), ("sample_div", {"sample_div": True, "e": noise}),
                     ("sample_div again", {"sample_div": True, "e": noise})):
        torch.cuda.synchronize()
        kernels.reset_launches()
        start = time.perf_counter()
        with torch.no_grad():
            _, _, rec, _, nfe = model.reconstruct(params, state, x, None, num_points=POINTS,
                                                  timestamps=timestamps, base_samples=base, **kw)
        torch.cuda.synchronize()
        runs[mode] = (rec, nfe, time.perf_counter() - start, dict(kernels.launches))
    rec, nfe, _, counts = runs["sample_div"]
    cnf = {k: counts[k] for k in CNF_LEAVES}
    require_launched(counts, RECONSTRUCT_KERNELS[:-1], "sample-div reconstruct")
    if cnf != {"cnf_primal": 0, "cnf_dynamics": int(nfe[1]), "cnf_dynamics_vjp": 0}:
        raise AssertionError(f"sample-div reconstruct: CNF launches {cnf}, CNF NFE {nfe[1]}")
    if tuple(rec.shape) != (BATCH, FRAMES, POINTS, 3) or not bool(torch.isfinite(rec).all()):
        raise AssertionError(f"sample-div reconstruct output bad: shape {tuple(rec.shape)}")
    if runs["sample_div again"][1] != nfe or not torch.equal(runs["sample_div again"][0], rec):
        raise AssertionError("sample-div reconstruct: a second run differs")
    print(json.dumps({
        "sample_div": f"reconstruct B={BATCH} T={FRAMES} N={POINTS}, demo weights", "card": card,
        "nfe": {m: runs[m][1] for m in ("default", "sample_div")},
        "seconds": {m: runs[m][2] for m in runs},
        "cnf_launches": cnf, "default_cnf_launches": {k: runs["default"][3][k] for k in CNF_LEAVES},
        "max_abs_diff_from_default": float((rec - runs["default"][0]).abs().max())}), flush=True)

    # phase 5's small reconstruct with the sample-div decode, card vs CPU
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    rng = np.random.default_rng(SEED)
    xs = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    xs[..., 3] = np.array([0.0, 5.0], np.float32)[None, :, None]
    small_base = rng.standard_normal((1, 2, 512, 3)).astype(np.float32)
    small_noise = np.random.default_rng(SEED + 12).standard_normal((2, 512, 3)).astype(np.float32)
    ts = np.array([0.0, 1.0], np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        small = CaSPRModel(CaSPRConfig(), device=dev)
        p, st = load_demo(device=dev)
        to = lambda a: torch.from_numpy(a).to(dev)
        with torch.no_grad():
            _, _, r, _, n = small.reconstruct(p, st, to(xs), None, num_points=512,
                                              timestamps=to(ts), base_samples=to(small_base),
                                              sample_div=True, e=to(small_noise))
        out[dev] = (r.cpu(), n)
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    print(json.dumps({"cross_device": "sample-div reconstruct B=1 T=2 N=2048 -> 512 points",
                      "nfe": [out["cuda"][1], out["cpu"][1]], "max_abs_err": err,
                      "tolerance": 1e-3}), flush=True)
    if out["cuda"][1] != out["cpu"][1] or not err <= 1e-3:
        raise AssertionError("sample-div reconstruct, card vs CPU: see the line above")
    return runs["sample_div"][3]["cnf_dynamics"]


def other_cnf_cross_device(torch, kernels, ctx_small):
    """Phase 12(b): each of the twelve configs at phase 5b's size, conditioned
    on the demo encoder's latents of phase 5b's input: a decode of 512
    points per latent and a likelihood forward of 2048 target points with
    injected noise, card against CPU, no CNF kernel launched."""
    from caspr_tpu_torch.models.cnf import flow_forward, flow_reverse

    rng = np.random.default_rng(SEED + 7)
    base = rng.standard_normal((2, 512, 3)).astype(np.float32)
    target = rng.random((2, POINTS, 3), dtype=np.float32)
    noise = rng.standard_normal((2, POINTS, 3)).astype(np.float32)
    for layer_type, nonlinearity in OTHER_CNF:
        gain = OTHER_CNF_GAIN.get(layer_type, OTHER_CNF_GAIN.get(nonlinearity, 6.0))
        out = {}
        for dev in ("cuda", "cpu"):
            ccfg, params, state = other_cnf_params(torch, layer_type, nonlinearity,
                                                   OTHER_CNF_DIMS, dev)
            for layer in params[1]["odenet"]["layers"]:
                layer["_layer"]["weight"] *= gain
            to = lambda a: torch.as_tensor(a).to(dev)
            kernels.reset_launches()
            with torch.no_grad():
                rec, nfe = flow_reverse(params, state, ccfg, to(base), to(ctx_small))
                y, lp, _, fnfe = flow_forward(params, state, ccfg, to(target), to(ctx_small),
                                              to(np.zeros((2, POINTS, 1), np.float32)),
                                              e=to(noise))
            if dev == "cuda":
                torch.cuda.synchronize()
                cnf = {k: kernels.launches[k] for k in CNF_LEAVES}
                if any(cnf.values()):
                    raise AssertionError(f"{layer_type} + {nonlinearity}: CNF kernels {cnf}")
            out[dev] = (rec.cpu(), nfe, torch.cat([y, lp], dim=-1).cpu(), fnfe)
        (rec, nfe, fwd, fnfe), (crec, cnfe, cfwd, cfnfe) = out["cuda"], out["cpu"]
        errs = {"points": float((rec - crec).abs().max()), "forward": float((fwd - cfwd).abs().max())}
        scale = {"points": max(1.0, float(crec.abs().max())),
                 "forward": max(1.0, float(cfwd.abs().max()))}
        print(json.dumps({"other_cnf": f"{layer_type} + {nonlinearity}, dims {OTHER_CNF_DIMS}, "
                                       f"caspr_init seed {SEED}, CNF gain {gain}: decode 2 x 512, "
                                       f"forward 2 x 2048",
                          "nfe": {"decode": [nfe, cnfe], "forward": [fnfe, cfnfe]},
                          "max_abs_err": errs, "scale": scale,
                          "tolerance": "1e-3 x max(1, the CPU's largest magnitude)"}), flush=True)
        if nfe != cnfe or fnfe != cfnfe or any(errs[k] > 1e-3 * scale[k] for k in errs):
            raise AssertionError(f"{layer_type} + {nonlinearity}, card vs CPU: see the line above")


def other_cnf_full_width(torch, kernels, ctx_full, card):
    """Phase 12(c): each of the twelve configs at CaSPRConfig's widths
    (512, 512, 512), zdim 1600, decoding 2048 points for each of the demo
    model's 40 latents of phase 3's input, on the card alone."""
    from caspr_tpu_torch.models.cnf import flow_reverse

    base = torch.randn((BT, POINTS, 3), generator=torch.Generator(device="cuda").manual_seed(
        SEED + 13), device="cuda")
    rows = []
    for layer_type, nonlinearity in OTHER_CNF:
        ccfg, params, state = other_cnf_params(torch, layer_type, nonlinearity, (512, 512, 512),
                                               "cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        start = time.perf_counter()
        with torch.no_grad():
            rec, nfe = flow_reverse(params, state, ccfg, base, ctx_full)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        cnf = {k: kernels.launches[k] for k in CNF_LEAVES}
        finite = bool(torch.isfinite(rec).all())
        rows.append({"config": f"{layer_type} + {nonlinearity}", "nfe": nfe, "seconds": seconds,
                     "largest": float(rec.abs().max()), "finite": finite})
        if not finite or any(cnf.values()) or tuple(rec.shape) != (BT, POINTS, 3):
            raise AssertionError(f"{layer_type} + {nonlinearity} at full width: finite {finite}, "
                                 f"CNF kernels {cnf}, shape {tuple(rec.shape)}")
    print(json.dumps({"other_cnf_full_width": f"decode {BT} x {POINTS}, dims (512, 512, 512), "
                                              f"zdim 1600, caspr_init seed {SEED}",
                      "card": card, "runs": rows}), flush=True)


def other_cnf_steps(torch, ctx_small):
    """Phase 12(d): one adjoint step of a flow-only NLL (mean over points of
    -(log N(y) - dlogp)), MovingBatchNorm statistics updated, for swish and
    for concat at CaSPRConfig's widths: card against CPU, equal forward and
    backward NFE, loss within 1e-4 relative, every flow leaf's gradient and
    the context's within 1e-3 of its largest (phase 7's bars)."""
    from caspr_tpu_torch.models.cnf import flow_forward
    from caspr_tpu_torch.ops.odeint import NFESink, flatten_tree
    from caspr_tpu_torch.ops.sampling import standard_normal_logprob

    _, target, noise = train_step_input()
    pts = target[0, :, :, :3]
    for layer_type, nonlinearity in OTHER_CNF_STEPS:
        out = {}
        for dev in ("cuda", "cpu"):
            ccfg, params, state = other_cnf_params(torch, layer_type, nonlinearity,
                                                   (512, 512, 512), dev)
            leaves = flatten_tree(params)[0]
            for leaf in leaves:
                leaf.requires_grad_()
            ctx = torch.as_tensor(ctx_small).to(dev).requires_grad_()
            to = lambda a: torch.as_tensor(a).to(dev)
            sink = NFESink()
            start = time.perf_counter()
            y, lp, new_state, nfe = flow_forward(params, state, ccfg, to(pts), ctx,
                                                 to(np.zeros((2, pts.shape[1], 1), np.float32)),
                                                 e=to(noise), training=True, nfe_sink=sink)
            loss = (-(standard_normal_logprob(y).sum(-1) - lp[..., 0])).mean()
            loss.backward()
            grads = [leaf.grad.cpu() for leaf in leaves] + [ctx.grad.cpu()]
            out[dev] = (loss.item(), nfe, sink.value, grads, time.perf_counter() - start)
        paths = leaf_paths(params) + ["context"]
        (loss, nfe, bwd, grads, sec), (closs, cnfe, cbwd, cgrads, csec) = out["cuda"], out["cpu"]
        rel = {p: float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
               for p, a, b in zip(paths, grads, cgrads)}
        loss_rel = abs(loss - closs) / abs(closs)
        print(json.dumps({"other_cnf_step": f"{layer_type} + {nonlinearity}, dims (512, 512, 512),"
                                            f" zdim 1600: flow-only NLL, 2 x 1024 points",
                          "nfe": {"forward": [nfe, cnfe], "backward": [bwd, cbwd]},
                          "loss": [loss, closs], "loss_rel_err": loss_rel,
                          "leaves": len(rel), "rel_err_max": max(rel.values()),
                          "worst": sorted(rel.items(), key=lambda kv: -kv[1])[:4],
                          "seconds": {"card": sec, "cpu": csec},
                          "tolerance": {"loss": 1e-4, "leaf": 1e-3}}), flush=True)
        if (nfe != cnfe or bwd != cbwd or not loss_rel <= 1e-4
                or not max(rel.values()) <= 1e-3):
            raise AssertionError(f"{layer_type} + {nonlinearity} step, card vs CPU: see above")


def run_cnf_rest(torch, kernels, card):
    """Phase 12: the reference-parity decode and the other CNF configs.
    Returns the sample-div decode's cnf_dynamics launches and the demo
    model's latents of phase 5b's input (2 x 1600, numpy)."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    model = CaSPRModel(CaSPRConfig(), device="cuda")
    params, state = load_demo(device=model.device)
    launches = sample_div_decode(torch, kernels, model, params, state, card)
    # the demo model's latents: phase 5b's input (1 x 2, decode times 0 and
    # 1) and phase 3's (4 x 10)
    rng = np.random.default_rng(SEED + 7)
    x_small = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    x_small[..., 3] = np.array([0.0, 5.0], np.float32)[None, :, None]
    x, timestamps, _ = reconstruct_input(torch)
    with torch.no_grad():
        latents = []
        for xx, ts in ((torch.from_numpy(x_small).cuda(), torch.tensor([0.0, 1.0]).cuda()),
                       (x, timestamps)):
            z0, _ = model.encode(params, xx)
            z, _ = model.aggregate_and_solve_latent(
                params, z0, ts.reshape(1, -1).expand(xx.shape[0], -1), shared_times=True)
            latents.append(z.reshape(-1, z.shape[-1]))
    ctx_small = latents[0].cpu().numpy()
    other_cnf_cross_device(torch, kernels, ctx_small)
    other_cnf_full_width(torch, kernels, latents[1], card)
    other_cnf_steps(torch, ctx_small)
    return launches, ctx_small


# Phase 13: the CNF kernels' bfloat16 matmul mode (CNFConfig.matmul_dtype;
# the JAX package's CASPR_TPU_CNF_MATMUL=bf16)
BF16_CFG = dict(cnf_matmul_dtype="bf16")
# and with the VJP's products in bfloat16 (CNFConfig.bwd_matmul_dtype; the
# JAX package's CASPR_TPU_CNF_BWD=pallas in that mode)
BF16_BWD_CFG = dict(BF16_CFG, cnf_bwd_matmul_dtype="bf16")
BF16_LEAVES = ("cnf_primal_bf16", "cnf_dynamics_bf16", "cnf_dynamics_vjp_bf16")


def cnf_bf16_case(torch, name, c, rows, hidden_layers, h):
    """One bfloat16 variant against its bfloat16 plain version (``c``: run,
    plain, exact (float64, no rounding), streams, bytes, shape, special)
    over ``rows`` points of width ``h``: (a) each output within 2e-3 of its
    largest magnitude of the plain version (a bfloat16 rounding of an
    activation may flip by one unit where the sums' order differs), (b)
    within 1.5x the plain version's distance from float64, (c) two launches
    bit-equal.  Returns its row: errors, times and work (the hidden layers
    as one bfloat16 tensor-core pass; softplus's special functions)."""
    got, plain = c["run"](), c["plain"]()
    if not all(torch.equal(a, b) for a, b in zip(got, c["run"]())):
        raise AssertionError(f"{name}: two launches on the same input differ")
    errs = [float((g - p).abs().max()) for g, p in zip(got, plain)]
    rels = [err / float(p.abs().max()) for err, p in zip(errs, plain)]
    dist = lambda a, x: float((a.double() - x).abs().max() / x.abs().max())
    vs64 = [dist(g, x) for g, x in zip(got, c["exact"])]
    plain_vs64 = [dist(p, x) for p, x in zip(plain, c["exact"])]
    print(json.dumps({"bf16_kernel": name, "rel_err_vs_plain": rels, "rel_err_vs_float64": vs64,
                      "plain_rel_err_vs_float64": plain_vs64}), flush=True)
    if not max(rels) <= 2e-3:
        raise AssertionError(f"{name}: relative err against the bf16 plain version {rels} > 2e-3")
    if not all(k <= 1.5 * p for k, p in zip(vs64, plain_vs64)):
        raise AssertionError(f"{name}: relative err against float64 {vs64} > 1.5 x the bf16 "
                             f"plain version's {plain_vs64}")
    rows_r = c["streams"] * rows
    # the epilogue in float32: the gate's product and the bias's sum, and
    # softplus's max and sum on every activation; the first and last layers
    # on the CUDA cores
    acts = rows * (hidden_layers + 1) * h
    edge_ops = 2.0 * rows_r * (3 * h + h * 3) + 4.0 * acts * c["streams"]
    return dict(
        max_abs_err=max(errs),
        tolerance="each output 2e-3 relative to its max magnitude of the bf16 plain version; "
                  "within 1.5x the bf16 plain version's distance from float64; deterministic",
        rel_err_vs_plain=rels, rel_err_vs_float64=vs64, plain_rel_err_vs_float64=plain_vs64,
        ms=time_ms(torch, c["run"]), plain_ms=time_ms(torch, c["plain"]), library_ms=None,
        work=(c["bytes"], edge_ops, c["special"] * acts, 0.0,
              2.0 * rows_r * hidden_layers * h * h),
        shape=c["shape"],
    )


def check_bf16_kernels(torch):
    """Phase 13(a): the two bfloat16 variants against their bfloat16 plain
    versions at phase 2's shapes (the trained decoder, 40 clouds of 2048
    points, y and e)."""
    from caspr_tpu_torch.ops import cnf_fused, kernels
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    params, _ = load_demo(device=dev)
    odenet = params["point_cnf"][1]["odenet"]
    tc = torch.cat([torch.full((BT, 1), 0.25, device=dev),
                    torch.randn((BT, 1600), generator=gen, device=dev)], dim=1)
    y = torch.randn((BT, POINTS, 3), generator=gen, device=dev)
    e = torch.randn((BT, POINTS, 3), generator=gen, device=dev)
    gb = cnf_fused.context_gb(odenet, tc)
    wf, wh, wl = cnf_fused.pack_weights(odenet)
    h = wf.shape[0]
    w64 = [t.double() for t in (gb, wf, wh, wl)]
    weights_bytes = (gb.numel() + wf.numel() + wh.numel() + wl.numel()) * 4.0
    cases = {
        # softplus: an exp and a log1p; with the tangent also the sigmoid's
        # reciprocal
        "cnf_primal_bf16": dict(
            run=lambda: (kernels.cnf_primal(y, gb, wf, wh, wl, "bf16"),),
            plain=lambda: (cnf_fused.primal_packed(y, gb, wf, wh, wl, "bf16"),),
            exact=(cnf_fused.primal_packed(y.double(), *w64),), streams=1, special=2.0,
            bytes=y.numel() * 2 * 4.0 + weights_bytes, shape=f"y ({BT}, {POINTS}, 3), H {h}"),
        "cnf_dynamics_bf16": dict(
            run=lambda: kernels.cnf_dynamics(y, e, gb, wf, wh, wl, "bf16"),
            plain=lambda: cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl, "bf16"),
            exact=cnf_fused.dynamics_packed(y.double(), e.double(), *w64), streams=2,
            special=3.0, bytes=(y.numel() * 3 + BT * POINTS) * 4.0 + weights_bytes,
            shape=f"y, e ({BT}, {POINTS}, 3), H {h}"),
    }
    rows = {name: cnf_bf16_case(torch, name, c, BT * POINTS, wh.shape[0], h)
            for name, c in cases.items()}
    rows["cnf_dynamics_vjp_bf16"] = vjp_bf16_case(torch, odenet, gen)
    check_bf16_widths(torch, gen)
    check_sfu(torch)
    for name, row in rows.items():
        bound_ms, bound_by = bound(*row["work"])
        print(json.dumps({"kernel": name, **{k: v for k, v in row.items() if k != "work"},
                          "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)
    return rows


# Phase 13(a), more widely: every width and depth where both bf16_takes and
# kernel_takes hold (H a multiple of 128 up to 512 here; one or two hidden
# layers) with the model's D = 3, and one with D = 5 (the kernels' path for
# a point dimension other than 3), on clouds of 500 points (a ragged last
# tile of each kernel)
BF16_SHAPES = tuple((h, hidden, 3) for h in (128, 256, 384, 512) for hidden in (1, 2)) + (
    (256, 2, 5),)
BF16_WIDTH_CLOUDS, BF16_WIDTH_POINTS = 8, 500


def random_packed(torch, gen, bt, h, hidden, d=3):
    """A concatsquash stack's packed arguments (ops/cnf_fused.py) with
    caspr_init's scales: weights uniform within 1/sqrt(fan_in), gates in
    (0, 1), effective biases of about 0.5; the last layer's gates and biases
    on its d channels only."""
    dev = torch.device("cuda")
    uni = lambda shape, fan_in: (2 * torch.rand(shape, generator=gen, device=dev) - 1) / fan_in ** 0.5
    layers = hidden + 2
    gb = torch.zeros((bt, max(8, 2 * layers), h), device=dev)
    gb[:, :layers] = torch.sigmoid(torch.randn((bt, layers, h), generator=gen, device=dev))
    gb[:, layers:2 * layers] = 0.5 * torch.randn((bt, layers, h), generator=gen, device=dev)
    gb[:, layers - 1, d:] = 0.0
    gb[:, 2 * layers - 1, d:] = 0.0
    return gb, uni((h, d), d), uni((hidden, h, h), h).contiguous(), uni((d, h), h)


def check_bf16_widths(torch, gen):
    """Phase 13(a) at BF16_SHAPES (H, hidden layers, D) on 8 clouds of 500
    points: cnf_primal_bf16, cnf_dynamics_bf16 and cnf_dynamics_vjp_bf16
    (random cotangents) against their bf16 plain versions with
    cnf_bf16_case's bars (2e-3 of each output's largest, 1.5x the plain
    version's distance from float64, two launches bit-equal)."""
    from caspr_tpu_torch.ops import cnf_fused, kernels

    dev = torch.device("cuda")
    report = {}
    for h, hidden, d in BF16_SHAPES:
        gb, wf, wh, wl = random_packed(torch, gen, BF16_WIDTH_CLOUDS, h, hidden, d)
        y, e = (torch.randn((BF16_WIDTH_CLOUDS, BF16_WIDTH_POINTS, d), generator=gen,
                            device=dev) for _ in range(2))
        w64 = [t.double() for t in (gb, wf, wh, wl)]
        vjp_args = (y, e, gb, wf, wh, wl,
                    torch.randn((BF16_WIDTH_CLOUDS, BF16_WIDTH_POINTS, d), generator=gen, device=dev),
                    torch.randn((BF16_WIDTH_CLOUDS, BF16_WIDTH_POINTS), generator=gen, device=dev))
        cases = {
            "cnf_primal_bf16": (lambda: (kernels.cnf_primal(y, gb, wf, wh, wl, "bf16"),),
                                (cnf_fused.primal_packed(y, gb, wf, wh, wl, "bf16"),),
                                (cnf_fused.primal_packed(y.double(), *w64),)),
            "cnf_dynamics_bf16": (lambda: kernels.cnf_dynamics(y, e, gb, wf, wh, wl, "bf16"),
                                  cnf_fused.dynamics_packed(y, e, gb, wf, wh, wl, "bf16"),
                                  cnf_fused.dynamics_packed(y.double(), e.double(), *w64)),
            "cnf_dynamics_vjp_bf16": (
                lambda: kernels.cnf_dynamics_vjp(*vjp_args, "bf16"),
                cnf_fused.dynamics_vjp_packed(*vjp_args, "bf16"),
                cnf_fused.dynamics_vjp_packed(*(a.double() for a in vjp_args))),
        }
        for name, (run, plain, exact) in cases.items():
            got = run()
            if not all(torch.equal(a, b) for a, b in zip(got, run())):
                raise AssertionError(f"{name} H {h} x {hidden}, D {d}: two launches differ")
            dist = lambda a, x: float((a.double() - x).abs().max() / x.abs().max())
            rels = [dist(g, p.double()) for g, p in zip(got, plain)]
            vs64 = [dist(g, x) for g, x in zip(got, exact)]
            plain_vs64 = [dist(p, x) for p, x in zip(plain, exact)]
            report[f"{name} H{h}x{hidden} D{d}"] = {"rel_err_vs_plain": rels,
                                                     "rel_err_vs_float64": vs64,
                                                     "plain_rel_err_vs_float64": plain_vs64}
            if not max(rels) <= 2e-3:
                raise AssertionError(f"{name} H {h} x {hidden}, D {d}: relative err against the "
                                     f"bf16 plain version {rels} > 2e-3")
            if not all(k <= 1.5 * q for k, q in zip(vs64, plain_vs64)):
                raise AssertionError(f"{name} H {h} x {hidden}, D {d}: relative err against float64 "
                                     f"{vs64} > 1.5 x the bf16 plain version's {plain_vs64}")
    print(json.dumps({"bf16_widths": f"{BF16_WIDTH_CLOUDS} clouds x {BF16_WIDTH_POINTS} points, "
                      "random weights at caspr_init's scales", "tolerance": "2e-3 of each "
                      "output's largest against the bf16 plain version; 1.5x its distance from "
                      "float64; deterministic", "cases": report}), flush=True)


def check_sfu(torch):
    """Phase 13(a): softplus and sigmoid of the bf16 kernels (cnf_tc.cuh
    softplus_sfu, softplus_sigmoid_sfu, built into a probe) within 2^-16
    relative of float64 over 4.2 M float32 inputs from -100 to 100, wherever
    softplus is a normal float32 (x >= -87.3)."""
    from caspr_tpu_torch.checks import cnf_bf16_arithmetic as arith

    x = arith.sfu_inputs(1 << 21)
    errs = arith.sfu_probe(x.cuda())
    print(json.dumps({"sfu": "softplus_sfu and softplus_sigmoid_sfu against float64",
                      "inputs": int(x.numel()), "bar": arith.SFU_BAR, **errs}), flush=True)
    if not max(errs["softplus_rel"], errs["sigmoid_rel"]) <= arith.SFU_BAR:
        raise AssertionError(f"softplus / sigmoid on the special-function units: {errs}")


def vjp_bf16_case(torch, odenet, gen):
    """Phase 13(a), the VJP: cnf_dynamics_vjp(..., "bf16") at row 10's
    shapes (the training path's 25 clouds of 1024 points, the demo decoder's
    weights, random cotangents) against its bfloat16 plain version with
    cnf_bf16_case's bars: each output within 2e-3 of its largest magnitude,
    within 1.5x the plain version's distance from the float64 VJP without
    rounding, two launches bit-equal.  Its work is row 10's: the three
    matrix passes (forward recompute, input cotangents, weight gradients),
    here one bfloat16 pass each at 989 TFLOP/s; softplus's and the
    sigmoids' special functions beside.  Each of its kernels is also timed
    alone (checks/cnf_tc_breakdown.py's vjp_launches)."""
    from caspr_tpu_torch.checks import cnf_tc_breakdown
    from caspr_tpu_torch.ops import cnf_fused, kernels

    dev = torch.device("cuda")
    bt, n = TRAIN_B * TRAIN_T, TRAIN_N
    tc = torch.cat([torch.full((bt, 1), 0.25, device=dev),
                    torch.randn((bt, 1600), generator=gen, device=dev)], dim=1)
    wf, wh, wl = cnf_fused.pack_weights(odenet)
    h = wf.shape[0]
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    args = (draw(bt, n, 3), draw(bt, n, 3), cnf_fused.context_gb(odenet, tc), wf, wh, wl,
            draw(bt, n, 3), draw(bt, n))
    run = lambda: kernels.cnf_dynamics_vjp(*args, "bf16")
    plain_fn = lambda: cnf_fused.dynamics_vjp_packed(*args, "bf16")
    got, plain = run(), plain_fn()
    if not all(torch.equal(a, b) for a, b in zip(got, run())):
        raise AssertionError("cnf_dynamics_vjp_bf16: two launches on the same input differ")
    exact = cnf_fused.dynamics_vjp_packed(*(a.double() for a in args))
    names = ("dy", "dgb", "dw_first", "dw_hidden", "dw_last")
    dist = lambda a, x: float((a.double() - x).abs().max() / x.abs().max())
    rels = {k: dist(g, p.double()) for k, g, p in zip(names, got, plain)}
    vs64 = {k: dist(g, x) for k, g, x in zip(names, got, exact)}
    plain_vs64 = {k: dist(p, x) for k, p, x in zip(names, plain, exact)}
    print(json.dumps({"bf16_kernel": "cnf_dynamics_vjp_bf16", "rel_err_vs_plain": rels,
                      "rel_err_vs_float64": vs64, "plain_rel_err_vs_float64": plain_vs64}),
          flush=True)
    if not max(rels.values()) <= 2e-3:
        raise AssertionError(f"cnf_dynamics_vjp_bf16: relative err against the bf16 plain "
                             f"version {rels} > 2e-3")
    if not all(vs64[k] <= 1.5 * plain_vs64[k] for k in names):
        raise AssertionError(f"cnf_dynamics_vjp_bf16: relative err against float64 {vs64} > "
                             f"1.5 x the bf16 plain version's {plain_vs64}")
    rows_r = 2 * bt * n
    hidden = wh.shape[0]
    # the epilogues in float32 (gate products, bias sums, softplus, the
    # sigmoid's chain rule: about 4 operations an activation each way) and
    # the first and last layers on the CUDA cores, in all three passes;
    # special functions: the recompute's exp, log1p and reciprocal, the
    # reverse sweep's exp and reciprocal, per activation of the primal rows
    acts = bt * n * (hidden + 1) * h
    edge_ops = 3 * 2.0 * rows_r * (3 * h + h * 3) + 8.0 * acts * 2
    vjp_bytes = (sum(a.numel() for a in args) + sum(g.numel() for g in got)) * 4.0
    # the wrapper's time, and each of its kernels alone (device time a
    # launch, torch.profiler over 20 calls of the C entry)
    ms = time_ms(torch, run)
    alone = cnf_tc_breakdown.vjp_launches(kernels.build(), "bf16", args, 20)
    print(json.dumps({"bf16_vjp_launches": "cnf_dynamics_vjp_bf16", "ms_wrapper": ms,
                      "ms_entry": alone["ms_call"], "ms_kernels_sum": alone["ms_kernels_sum"],
                      "kernels": alone["kernels"]}), flush=True)
    return dict(
        max_abs_err=max(float((g - p).abs().max()) for g, p in zip(got, plain)),
        tolerance="each output 2e-3 relative to its max magnitude of the bf16 plain version; "
                  "within 1.5x the bf16 plain version's distance from float64; deterministic",
        rel_err_vs_plain=rels, rel_err_vs_float64=vs64, plain_rel_err_vs_float64=plain_vs64,
        ms=ms, plain_ms=time_ms(torch, plain_fn), library_ms=None, ms_launches=alone,
        work=(vjp_bytes, edge_ops, 5.0 * acts, 0.0, 3 * 2.0 * rows_r * hidden * h * h),
        shape=f"y, e, ct ({bt}, {n}, 3), H {h}: {rows_r} rows",
    )


def bf16_reconstructs(torch, kernels, card):
    """Phase 13(b): the demo-weights reconstruct of phase 3's input and base
    samples in bfloat16 beside float32 (f32, bf16, bf16, f32, so that each
    mode has a run on either side of the other), and its sample-div decode
    with phase 12's noise; the launch counts set to 0 before each run.
    Returns the bf16 decode's cnf_primal_bf16 launches."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    params, state = load_demo(device="cuda")
    models = {"f32": CaSPRModel(CaSPRConfig(), device="cuda"),
              "bf16": CaSPRModel(CaSPRConfig(**BF16_CFG), device="cuda")}
    x, timestamps, gen = reconstruct_input(torch)
    base = models["f32"].sample_base(gen, BT, POINTS).reshape(BATCH, FRAMES, POINTS, 3)
    noise = torch.randn((BT, POINTS, 3), generator=torch.Generator(device="cuda").manual_seed(
        SEED + 12), device="cuda")
    runs = {}
    for mode, label, kw in (("f32", "f32", {}), ("bf16", "bf16", {}), ("bf16", "bf16 again", {}),
                            ("f32", "f32 again", {}),
                            ("bf16", "bf16 sample_div", {"sample_div": True, "e": noise})):
        torch.cuda.synchronize()
        kernels.reset_launches()
        start = time.perf_counter()
        with torch.no_grad():
            _, _, rec, _, nfe = models[mode].reconstruct(params, state, x, None,
                                                         num_points=POINTS, timestamps=timestamps,
                                                         base_samples=base, **kw)
        torch.cuda.synchronize()
        runs[label] = (rec, nfe, time.perf_counter() - start,
                       {k: kernels.launches[k] for k in CNF_LEAVES + BF16_LEAVES})
    cnf_nfe = lambda label: int(runs[label][1][1])
    want = {"f32": {"cnf_primal": cnf_nfe("f32")},
            "bf16": {"cnf_primal_bf16": cnf_nfe("bf16")},
            "bf16 sample_div": {"cnf_dynamics_bf16": cnf_nfe("bf16 sample_div")}}
    for label, counts in want.items():
        got = {k: v for k, v in runs[label][3].items() if v}
        if got != counts:
            raise AssertionError(f"{label} reconstruct: CNF launches {got}, expected {counts}")
    for label, (rec, _, _, _) in runs.items():
        if tuple(rec.shape) != (BATCH, FRAMES, POINTS, 3) or not bool(torch.isfinite(rec).all()):
            raise AssertionError(f"{label} reconstruct output bad: shape {tuple(rec.shape)}")
    for label in ("bf16", "f32"):
        again = runs[f"{label} again"]
        if again[1] != runs[label][1] or not torch.equal(again[0], runs[label][0]):
            raise AssertionError(f"{label} reconstruct: a second run differs")
    f32_rec = runs["f32"][0]
    print(json.dumps({
        "bf16_reconstruct": f"reconstruct B={BATCH} T={FRAMES} N={POINTS}, demo weights, phase "
                            f"3's input and base samples", "card": card,
        "nfe": {k: v[1] for k, v in runs.items()},
        "seconds": {k: v[2] for k, v in runs.items()},
        "cnf_launches": {k: v[3] for k, v in runs.items()},
        "max_abs_diff_from_f32": {k: float((v[0] - f32_rec).abs().max()) for k, v in runs.items()
                                  if k.startswith("bf16")},
        "largest_f32": float(f32_rec.abs().max())}), flush=True)
    return runs["bf16"][3]["cnf_primal_bf16"]


def bf16_cross_device(torch):
    """Phase 13(c): phase 5's reconstruct in bfloat16 on the card and on
    the CPU (the plain version): CNF NFE within 6 (the margin the JAX
    package's tests allow between its own two routes: the bfloat16
    roundings of the card's and the CPU's sums may differ by a unit, and
    dopri5 then takes other steps), equal latent-ODE NFE, points within
    5e-3 of their largest magnitude."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    rng = np.random.default_rng(SEED)
    x = rng.random((1, 2, POINTS, 4), dtype=np.float32)
    x[..., 3] = np.array([0.0, 5.0], np.float32)[None, :, None]
    base = rng.standard_normal((1, 2, 512, 3)).astype(np.float32)
    ts = np.array([0.0, 1.0], np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = CaSPRModel(CaSPRConfig(**BF16_CFG), device=dev)
        params, state = load_demo(device=dev)
        to = lambda a: torch.from_numpy(a).to(dev)
        with torch.no_grad():
            _, _, rec, _, nfe = model.reconstruct(params, state, to(x), None, num_points=512,
                                                  timestamps=to(ts), base_samples=to(base))
        out[dev] = (rec.cpu(), nfe)
    (card, card_nfe), (cpu, cpu_nfe) = out["cuda"], out["cpu"]
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    print(json.dumps({"cross_device": "bf16 reconstruct B=1 T=2 N=2048 -> 512 points",
                      "nfe": [card_nfe, cpu_nfe], "max_abs_err": err, "largest": scale,
                      "tolerance": "CNF NFE within 6, latent NFE equal, points 5e-3 x largest"}),
          flush=True)
    if (abs(card_nfe[1] - cpu_nfe[1]) > 6 or card_nfe[0] != cpu_nfe[0]
            or not err <= 5e-3 * scale):
        raise AssertionError("bf16 reconstruct, card vs CPU: see the line above")


def bf16_likelihood_and_step(torch, kernels, card):
    """Phase 13(d): at 5 x 5 x 1024, on the same inputs, one likelihood
    evaluation (CaSPRModel.forward with the demo weights, phase 6's first
    batch, a noise from SEED + 16) in float32 and in bfloat16, and one
    adjoint train step (phase 6's first: caspr_init seed 0, its generator,
    its batch) in float32, in bfloat16 and in bfloat16 with the VJP's
    products in bfloat16 (cnf_bwd_matmul_dtype="bf16", this slice's path):
    finite; the forward dynamics through the mode's kernel alone
    (cnf_dynamics or cnf_dynamics_bf16, once per CNF evaluation), the
    adjoint's VJP through cnf_dynamics_vjp in the first two steps and
    cnf_dynamics_vjp_bf16 alone in the third, once per backward CNF
    evaluation.  Returns the bfloat16 likelihood's cnf_dynamics_bf16
    launches and, per bfloat16 variant, its launches in its train step."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel, caspr_init
    from caspr_tpu_torch.train import make_optimizer, make_train_step
    from caspr_tpu_torch.weights import load_demo

    dev = torch.device("cuda")
    batch = TrainLoader(1, SEED + 4).batches[0]
    to = lambda a: torch.from_numpy(a).to(dev)
    demo_params, demo_state = load_demo(device=dev)
    leaves = CNF_LEAVES + BF16_LEAVES
    # (config, forward kernel, VJP kernel, whether the likelihood runs)
    modes = {"f32": (CaSPRConfig(), "cnf_dynamics", "cnf_dynamics_vjp", True),
             "bf16": (CaSPRConfig(**BF16_CFG), "cnf_dynamics_bf16", "cnf_dynamics_vjp", True),
             "bf16, bf16 VJP": (CaSPRConfig(**BF16_BWD_CFG), "cnf_dynamics_bf16",
                                "cnf_dynamics_vjp_bf16", False)}
    out = {}
    for mode, (cfg, kernel, vjp, likelihood_too) in modes.items():
        model = CaSPRModel(cfg, device=dev)
        out[mode] = {}
        if likelihood_too:
            torch.cuda.synchronize()
            kernels.reset_launches()
            start = time.perf_counter()
            with torch.no_grad():
                res, _ = model.forward(demo_params, demo_state, to(batch["input"]),
                                       to(batch["target"]),
                                       torch.Generator(device=dev).manual_seed(SEED + 16))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = {k: kernels.launches[k] for k in leaves}
            nll = res["nll"]
            if counts != {**dict.fromkeys(leaves, 0), kernel: int(res["nfe"][1])}:
                raise AssertionError(f"{mode} likelihood: CNF launches {counts}, CNF NFE "
                                     f"{res['nfe'][1]}")
            if (not bool(torch.isfinite(nll).all())
                    or tuple(nll.shape) != (TRAIN_B, TRAIN_T, TRAIN_N)):
                raise AssertionError(f"{mode} likelihood: nll bad, shape {tuple(nll.shape)}")
            out[mode]["likelihood"] = dict(nfe=res["nfe"], seconds=seconds,
                                           mean_nll=float(nll.mean()), cnf_launches=counts)

        gen = torch.Generator(device=dev).manual_seed(SEED)
        params, state = caspr_init(gen, cfg, device=dev)
        tx = make_optimizer(1e-4)
        step = make_train_step(model, tx, 0.01, 100.0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        start = time.perf_counter()
        _, _, _, m = step(params, tx.init(params), state, batch["input"], batch["target"], gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = {k: kernels.launches[k] for k in leaves}
        want = {**dict.fromkeys(leaves, 0), kernel: int(m["nfe"][1]),
                vjp: int(m["nfe"][1] - m["nfe_forward"][1] - 2)}
        if counts != want:
            raise AssertionError(f"{mode} train step: CNF launches {counts}, expected {want}")
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"{mode} train step: loss not finite: {m['loss']}")
        out[mode]["train_step"] = dict(loss=m["loss"], cnf_loss=m["cnf_loss"], nfe=m["nfe"],
                                       nfe_forward=m["nfe_forward"], seconds=seconds,
                                       cnf_launches=counts)
    print(json.dumps({"bf16_likelihood_and_step": f"B={TRAIN_B} T={TRAIN_T} N={TRAIN_N}: "
                                                  f"CaSPRModel.forward with the demo weights; "
                                                  f"one adjoint step from caspr_init seed 0",
                      "card": card, **out}), flush=True)
    steps = {mode: out[mode]["train_step"]["cnf_launches"] for mode in modes}
    return (out["bf16"]["likelihood"]["cnf_launches"]["cnf_dynamics_bf16"],
            {"cnf_dynamics_bf16": steps["bf16"]["cnf_dynamics_bf16"],
             "cnf_dynamics_vjp_bf16": steps["bf16, bf16 VJP"]["cnf_dynamics_vjp_bf16"]})


def bf16_block_gradient(torch, kernels, ctx_small):
    """Phase 13(e): the bfloat16 adjoint gradient of one CNF block (the demo
    decoder's, cnf_bwd_matmul_dtype="bf16") on the card and on the CPU (the
    plain versions), on the same inputs: a flow-only NLL of 2 clouds of 256
    points of phase 7's target, with its noise, conditioned on the demo
    model's latents of phase 5b's input.  Forward and backward CNF NFE each
    within 6 (the bfloat16 roundings of the two devices' sums may differ by
    a unit, and the solvers then take other steps), the loss within 5e-3 of
    its magnitude, each gradient leaf (the block's and the context's)
    within 5e-3 of its largest; on the card the two bfloat16 kernels and no
    float32 CNF kernel."""
    from caspr_tpu_torch.models.caspr import CaSPRConfig
    from caspr_tpu_torch.models.cnf import cnf_block_forward
    from caspr_tpu_torch.ops.odeint import NFESink, flatten_tree
    from caspr_tpu_torch.ops.sampling import standard_normal_logprob
    from caspr_tpu_torch.weights import load_demo

    ccfg = CaSPRConfig(**BF16_BWD_CFG).cnf_config()
    _, target, noise = train_step_input()
    pts, e = (np.ascontiguousarray(a) for a in (target[0, :, :256, :3], noise[:, :256]))
    out = {}
    for dev in ("cuda", "cpu"):
        params = load_demo(device=dev)[0]["point_cnf"][1]
        leaves = flatten_tree(params)[0]
        for leaf in leaves:
            leaf.requires_grad_()
        ctx = torch.as_tensor(ctx_small).to(dev).requires_grad_()
        to = lambda a: torch.as_tensor(a).to(dev)
        sink = NFESink()
        kernels.reset_launches()
        start = time.perf_counter()
        y, lp, nfe = cnf_block_forward(params, ccfg, to(pts), ctx,
                                       to(np.zeros((2, 256, 1), np.float32)), to(e),
                                       training=True, nfe_sink=sink)
        loss = (-(standard_normal_logprob(y).sum(-1) - lp[..., 0])).mean()
        loss.backward()
        grads = [leaf.grad.cpu() for leaf in leaves] + [ctx.grad.cpu()]
        counts = {k: v for k, v in kernels.launches.items() if v}
        out[dev] = (loss.item(), nfe, sink.value, grads, time.perf_counter() - start, counts)
    paths = leaf_paths(params) + ["context"]
    (loss, nfe, bwd, grads, sec, counts), (closs, cnfe, cbwd, cgrads, csec, ccounts) = (
        out["cuda"], out["cpu"])
    rel = {p: float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
           for p, a, b in zip(paths, grads, cgrads)}
    loss_rel = abs(loss - closs) / abs(closs)
    print(json.dumps({"bf16_block_gradient": "demo CNF block, bf16 forward and VJP, flow-only "
                                             "NLL, 2 x 256 points",
                      "nfe": {"forward": [nfe, cnfe], "backward": [bwd, cbwd]},
                      "loss": [loss, closs], "loss_rel_err": loss_rel, "leaves": len(rel),
                      "rel_err_max": max(rel.values()),
                      "worst": sorted(rel.items(), key=lambda kv: -kv[1])[:4],
                      "card_launches": counts, "seconds": {"card": sec, "cpu": csec},
                      "tolerance": {"nfe": 6, "loss": 5e-3, "leaf": 5e-3}}), flush=True)
    if ccounts or set(counts) != {"cnf_dynamics_bf16", "cnf_dynamics_vjp_bf16"}:
        raise AssertionError(f"bf16 block gradient: launches card {counts}, CPU {ccounts}")
    if (abs(nfe - cnfe) > 6 or abs(bwd - cbwd) > 6 or not loss_rel <= 5e-3
            or not max(rel.values()) <= 5e-3):
        raise AssertionError("bf16 block gradient, card vs CPU: see the line above")


# Phase 13(f): which CNF kernels a bf16 config launches, by its widths: the
# JAX package's can_fuse decides where bf16 applies, the kernels' reach
# whether they run (one field, one field with divergence and its VJP)
BF16_REACH = (
    ((128,) * 5, ("cnf_primal", "cnf_dynamics", "cnf_dynamics_vjp")),  # kernels, float32
    ((1024, 1024), ()),  # the rounded composition
    ((512, 512, 512), BF16_LEAVES),
)


def bf16_reach(torch, kernels, ctx_small):
    """Phase 13(f): for each of BF16_REACH's widths, a bf16 config
    (cnf_bwd_matmul_dtype="bf16" too; caspr_init's weights) runs the field,
    the field with its divergence and the latter's VJP on the card: the
    launches are the expected ones, once each, the three fields agree with
    the CPU's within 2e-3 of their largest magnitudes, and the VJP's dy is
    finite."""
    import dataclasses

    from caspr_tpu_torch.models.cnf import odenet_dynamics, odenet_primal

    rng = np.random.default_rng(SEED + 13)
    y, e = rng.standard_normal((2, 2, 512, 3)).astype(np.float32)
    tc = np.concatenate([np.full((2, 1), 0.3, np.float32), ctx_small], axis=1)
    report = {}
    for dims, want in BF16_REACH:
        fields = {}
        for dev in ("cuda", "cpu"):
            ccfg, params, _ = other_cnf_params(torch, "concatsquash", "softplus", dims, dev)
            ccfg = dataclasses.replace(ccfg, matmul_dtype="bf16", bwd_matmul_dtype="bf16")
            odenet = params[1]["odenet"]
            points = torch.from_numpy(y).to(dev).requires_grad_()
            to = lambda a: torch.from_numpy(a).to(dev)
            kernels.reset_launches()
            dx = odenet_primal(odenet, ccfg, to(tc), points.detach())
            dx2, div = odenet_dynamics(odenet, ccfg, to(tc), points, to(e))
            (dx2.sum() + div.sum()).backward()
            fields[dev] = [t.detach().cpu() for t in (dx, dx2, div, points.grad)]
            if dev == "cuda":
                counts = {k: v for k, v in kernels.launches.items() if v}
        rels = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(fields["cuda"][:3], fields["cpu"][:3])]
        report[str(dims)] = dict(launches=counts, rel_err_vs_cpu=rels)
        if counts != dict.fromkeys(want, 1):
            raise AssertionError(f"bf16 config at {dims}: launches {counts}, expected {want}")
        if not all(bool(torch.isfinite(t).all()) for t in fields["cuda"]) or max(rels) > 2e-3:
            raise AssertionError(f"bf16 config at {dims}: card against CPU {rels}")
    print(json.dumps({"bf16_reach": report}), flush=True)


def run_bf16(torch, kernels, card, ctx_small):
    """Phase 13: the bfloat16 matmul mode.  Returns (its kernel rows, the
    launches of each variant on its main path, the train steps' launches of
    the bfloat16 variants)."""
    rows = check_bf16_kernels(torch)
    primal = bf16_reconstructs(torch, kernels, card)
    bf16_cross_device(torch)
    dynamics, steps = bf16_likelihood_and_step(torch, kernels, card)
    bf16_block_gradient(torch, kernels, ctx_small)
    bf16_reach(torch, kernels, ctx_small)
    return rows, {"cnf_primal_bf16": primal, "cnf_dynamics_bf16": dynamics,
                  "cnf_dynamics_vjp_bf16": steps["cnf_dynamics_vjp_bf16"]}, steps


def phase_done(name: str, begun: float):
    print(json.dumps({"phase_done": name, "seconds_since_start": time.perf_counter() - begun}),
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
    begun = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    lib = kernels.build()
    print(json.dumps({"build_seconds": time.perf_counter() - begun, "library": lib.name}), flush=True)
    build_facts(lib, kernels.BUILD_DIR)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_kernels(torch, gen)
    phase_done("2", begun)
    counts = run_path(torch, kernels)
    phase_done("3", begun)
    counts["sa_fused"] = run_sa_modes(torch, kernels)["sa_fused"]
    phase_done("3b", begun)
    from caspr_tpu_torch.models.caspr import CaSPRConfig, CaSPRModel
    from caspr_tpu_torch.weights import load_demo

    model = CaSPRModel(CaSPRConfig(), device="cuda")
    params, state = load_demo(device=model.device)
    with tempfile.TemporaryDirectory() as out_dir:
        counts.update(run_eval_path(torch, kernels, model, params, state, out_dir))
        phase_done("4", begun)
        cross_device(torch)
        phase_done("5", begun)
        composition_path(torch, kernels)
        phase_done("5b", begun)
        counts.update(run_train_path(torch, kernels, out_dir))
        phase_done("6", begun)
        floor = train_step_floor(torch)
        run_fused_train(torch, kernels, out_dir, floor)
        phase_done("6b", begun)
    cross_device_train(torch, floor)
    phase_done("7", begun)
    with tempfile.TemporaryDirectory() as cli_dir:
        phase8 = run_cli_path(torch, kernels, cli_dir, card)
        phase_done("8", begun)
        with tempfile.TemporaryDirectory() as out_dir:
            run_viz_path(torch, kernels, out_dir, card)
        phase_done("9", begun)
        one = run_parallel_path(torch, kernels, phase8, floor, card)
        phase_done("10", begun)
        run_sp_path(torch, kernels, phase8, floor, card, one)
        phase_done("11", begun)
    sample_div_launches, ctx_small = run_cnf_rest(torch, kernels, card)
    phase_done("12", begun)
    bf16_rows, bf16_counts, bf16_step_launches = run_bf16(torch, kernels, card, ctx_small)
    rows.update(bf16_rows)
    counts.update(bf16_counts)
    phase_done("13", begun)

    listing = []
    for name, row in rows.items():
        bound_ms, bound_by = bound(*row["work"])
        source, replaces = KERNEL_INFO[name]
        listing.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": row["library_ms"],
            **({"f32_bound_ms": row["f32_bound_ms"]} if "f32_bound_ms" in row else {}),
            **per_reconstruct(row, counts[name] if name in ("cnf_primal", "cnf_primal_bf16")
                              else None, bound_ms),
            **({"launches_per_sample_div_reconstruct": sample_div_launches}
               if name == "cnf_dynamics" else {}),
            **({"launches_per_train_step": bf16_step_launches[name]}
               if name in bf16_step_launches else {}),
        })
    print(json.dumps({"seconds_since_start": time.perf_counter() - begun}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
