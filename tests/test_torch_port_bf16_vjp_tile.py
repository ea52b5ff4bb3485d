"""The bfloat16 CNF VJP kernels' arithmetic and layouts, modelled on the CPU
(caspr_tpu_torch/checks/cnf_bf16_arithmetic.py).

The bf16 variant of csrc/cnf_dynamics_vjp.cu cannot run here, so these
tests hold what its design changed, as the model computes it, to the bars
the card holds the kernel to (chip_smoke.py phase 13(a)):

  - (a) rounding each layer input z_l and each dm_l to bfloat16 once, where
    the tile kernel stores them (in the tile, and as the tile's bytes in the
    workspace), gives the bf16 plain version's outputs bit for bit (it
    rounds the same float32 values at every product);
  - (b) with the kernels' special-function softplus and sigmoid in the
    forward recompute (cnf_tc.cuh softplus_sigmoid_sfu) and sigmoid_sfu in
    the reverse sweep, every output (dy, dgb, dW) is within 2e-3 of its
    largest magnitude of the JAX package's bf16 _fused_bwd_call in interpret
    mode, and within 1.5x the bf16 plain version's distance from the float64
    VJP without rounding;
  - (c) the byte offsets: the weight-gradient product's bulk copies and
    MN-major descriptors read every element of dm^T and z where the tile
    kernel wrote it in the workspace, at every width, half, K-step and
    warpgroup; the pre-gate products' fragment order is one slot for each
    value, the same for the first layer's stores and the reverse sweep's
    loads; the first and last layers' weight-gradient kernel reads the
    tiles where they were written.

Sizes: H 128 and 256, one and two hidden layers, 2 clouds of 100 points.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from caspr_tpu.models import cnf as jcnf
from caspr_tpu.ops import cnf_fused as jcnf_fused
from caspr_tpu_torch.checks import cnf_bf16_arithmetic as arith
from caspr_tpu_torch.ops import cnf_fused
from test_torch_port_cnf_layers import _t, _to_torch
from test_torch_port_model import torch_threads  # noqa: F401  (one PyTorch thread)

FIELD_TOL, VS64_RATIO = 2e-3, 1.5
DIMS = [(128, 128), (128, 128, 128), (256, 256), (256, 256, 256)]
NAMES = ("dy", "dgb", "dw_first", "dw_hidden", "dw_last")
_ids = lambda d: f"H{d[0]}x{len(d) - 1}"


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _problem(dims):
    """The packed arguments of a JAX-initialised concatsquash ODEnet at
    ``dims`` (2 clouds of 100 points, inputs and cotangents from a seed);
    the JAX package's bf16 VJP kernel in interpret mode, the bf16 plain
    version and the float64 VJP without rounding."""
    jcfg = jcnf.CNFConfig(input_dim=3, dims=dims, zdim=16)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(23), jcfg)
    rng = np.random.default_rng(23)
    tc = (0.5 * rng.standard_normal((2, 17))).astype(np.float32)
    y, e, ct_dx = rng.standard_normal((3, 2, 100, 3)).astype(np.float32)
    ct_div = rng.standard_normal((2, 100)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jcnf_fused._fused_bwd_call(
            *jcnf_fused._pack_weights(jparams), jcnf_fused._context_gb(jparams, jnp.asarray(tc)),
            jnp.asarray(y), jnp.asarray(e), jnp.asarray(ct_dx), jnp.asarray(ct_div),
            matmul_dtype="bf16")
    want = [np.asarray(w) for w in want]
    want[2], want[4] = want[2][:, :3], want[4][:3]  # the JAX package pads D to 8
    params = _to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    args = (_t(y), _t(e), cnf_fused.context_gb(params, _t(tc)), *cnf_fused.pack_weights(params),
            _t(ct_dx), _t(ct_div))
    plain = cnf_fused.dynamics_vjp_packed(*args, "bf16")
    exact = cnf_fused.dynamics_vjp_packed(*(a.double() for a in args))
    return args, want, plain, exact


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
def test_rounding_once_where_stored_is_the_plain_versions_rounding(dims):
    """(a): bit for bit, every output."""
    args, _, plain, _ = _problem(dims)
    for name, got, want in zip(NAMES, arith.vjp_tile(*args), plain):
        assert torch.equal(got, want), name


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
def test_the_sfu_activations_keep_the_jax_bars(dims):
    """(b): the forward's softplus_sigmoid_sfu and the reverse sweep's
    sigmoid_sfu, as the kernel runs them."""
    args, want, plain, exact = _problem(dims)
    got = arith.vjp_tile(*args, act=arith.softplus_sigmoid_sfu, sigmoid=arith.sigmoid_sfu)
    for name, g, w, p, x in zip(NAMES, got, want, plain, exact):
        assert _rel(g, w) <= FIELD_TOL, (name, _rel(g, w))
        ours, theirs = _rel(g, x), _rel(p, x)
        assert ours <= VS64_RATIO * theirs, (name, "from float64: model", ours, "plain", theirs)
    # the special functions reach the outputs: the bars are not vacuous
    assert any(not torch.equal(g, p) for g, p in zip(got, plain))


def test_sigmoid_sfu_is_the_softplus_sigmoids_sigmoid():
    x = arith.sfu_inputs(1 << 14)
    assert torch.equal(arith.sigmoid_sfu(x), arith.softplus_sigmoid_sfu(x)[1])
    errs = arith.sfu_rel_errors(x, *arith.softplus_sigmoid_sfu(x, rcp_err=arith.RCP_ERR))
    assert errs["sigmoid_rel"] <= arith.SFU_BAR, errs


@pytest.mark.parametrize("hpad", [128, 256, 384, 512])
def test_the_weight_gradient_product_reads_dm_and_z_where_the_tile_kernel_wrote_them(hpad):
    """For every dW tile (o0, k0) of a width, warpgroup, half and K-step of
    a stage: element (m, k) of A (dm^T: out channel o0 + 64 wg + m, row 32
    half + 16 kstep + k of the tile block) and element (n, k) of B (z: in
    channel k0 + n, the same row) lie, through the stage's bulk copy, where
    the tile kernel's copy of its tile put them."""
    tile = arith.btile_bytes(hpad)
    for block in (0, 3):
        for c0 in range(0, hpad, arith.GEMM_TILE):
            # the copy: 16-byte aligned, inside the tile block's tile
            src = arith.gemm_stage_source(block, c0, 0, hpad)
            assert src % 16 == 0 and arith.GEMM_OPERAND % 16 == 0
            assert src + arith.GEMM_OPERAND <= (block + 1) * tile
            for half in range(2):
                for kstep in range(2):
                    row = 32 * half + 16 * kstep
                    for k in range(16):
                        for mn in range(arith.GEMM_TILE):
                            if mn < 64:
                                for wg in range(2):
                                    off = arith.gemm_a_at(wg, half, kstep, mn, k)
                                    assert arith.gemm_stage_source(block, c0, off, hpad) == \
                                        arith.workspace_at(block, row + k, c0 + 64 * wg + mn, hpad)
                            off = arith.gemm_b_at(half, kstep, mn, k)
                            assert arith.gemm_stage_source(block, c0, off, hpad) == \
                                arith.workspace_at(block, row + k, c0 + mn, hpad)
                    # descriptor start addresses 16-byte aligned
                    for wg in range(2):
                        assert arith.gemm_a_at(wg, half, kstep, 0, 0) % 16 == 0
                    assert arith.gemm_b_at(half, kstep, 0, 0) % 16 == 0


@pytest.mark.parametrize("hpad", [128, 512])
def test_the_pre_gate_products_have_one_slot_each_and_the_first_layer_fills_them(hpad):
    slots = {arith.m_slot(r, c) for r in range(arith.ROWS) for c in range(hpad)}
    assert slots == {(i, j) for i in range(arith.ROWS * hpad // 4) for j in range(4)}
    for p in range(arith.ROWS // 2):
        r = (p >> 3) * 16 + (p & 7)  # point p's primal row; its tangent row is 8 further
        for c in range(0, hpad, 2):
            slot = arith.m_slot_first_layer(p, c)
            assert [arith.m_slot(r, c), arith.m_slot(r, c + 1), arith.m_slot(r + 8, c),
                    arith.m_slot(r + 8, c + 1)] == [(slot, j) for j in range(4)]
    # a warp's slots of one channel group are 512 contiguous bytes
    for w in range(4):
        rows = [16 * w + g for g in range(8)]
        idx = sorted(arith.m_slot(r, c)[0] for r in rows for c in range(0, 8, 2))
        assert idx == list(range(idx[0], idx[0] + 32))


@pytest.mark.parametrize("hpad", [128, 384])
def test_the_first_and_last_layers_gradients_read_the_tiles_where_written(hpad):
    for r in range(0, 3 * arith.ROWS):
        for o in range(hpad):
            assert arith.thin_wide_at(r, o, hpad) == \
                arith.workspace_at(r // arith.ROWS, r % arith.ROWS, o, hpad)
