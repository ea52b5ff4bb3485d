"""The bfloat16 forward CNF kernels' tile arithmetic, modelled on the CPU
(caspr_tpu_torch/checks/cnf_bf16_arithmetic.py).

The bf16 variants of csrc/cnf_primal.cu and csrc/cnf_dynamics.cu cannot run
here, so these tests hold what their design changed, as the model computes
it, to the bars the card holds the kernels to (chip_smoke.py phase 13(a)):

  - (a) rounding each activation to bfloat16 once, where the epilogue stores
    it in the tile, gives the bf16 plain versions' outputs bit for bit (they
    round the same float32 values at every product);
  - (b) softplus and sigmoid off by 2^-16 relative (the bar on the special-
    function-unit versions), all up, all down or with random signs, fed
    through that stack: dx within 2e-3 of its largest magnitude of the JAX
    package's bf16 Pallas kernels in interpret mode, and every output (div
    too) within 1.5x the bf16 plain version's distance from the float64
    stack without rounding.  div is not held to 2e-3 of JAX's here: at these
    sizes and random weights one bfloat16 rounding that flips in a tangent
    activation moves it by about 1e-3 of its largest, and an activation off
    by as little as 2^-20 everywhere flips enough of them to put it 2.1e-3
    from JAX's (8.4e-3 at 2^-16), while its distance from float64 stays
    within 1.07x the plain version's;
  - the kernels' softplus and sigmoid algorithm (cnf_tc.cuh softplus_sfu,
    softplus_sigmoid_sfu) is within 2^-16 relative of float64 wherever
    softplus is a normal float32, with ex2, lg2 and rcp exact or off by the
    special-function units' error bounds either way, and gives a stack at
    the same bars as (b);
  - the tile's and the tiled weights' byte offsets: every element of the
    wgmma A and B operands is read from where the epilogue and
    tile_weights_kernel (through the ring's bulk copies) put it, for every
    width, block rotation, chunk and step, and a warp's epilogue stores,
    first-layer stores and last-layer loads fall on distinct shared-memory
    banks.

Sizes: H 128 and 256, one and two hidden layers, 2 clouds of 100 points.
"""

import functools
import math

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

FIELD_TOL, VS64_RATIO = 2e-3, 1.5
DIMS = [(128, 128), (128, 128, 128), (256, 256), (256, 256, 256)]
_ids = lambda d: f"H{d[0]}x{len(d) - 1}"


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_double(v) for v in tree]
    return tree.double()


@functools.lru_cache(maxsize=None)
def _problem(dims):
    """The packed stack of a JAX-initialised concatsquash ODEnet at ``dims``,
    2 clouds of 100 points and noise from a seed; the JAX bf16 kernels'
    outputs in interpret mode and the float64 stack without rounding."""
    jcfg = jcnf.CNFConfig(input_dim=3, dims=dims, zdim=16)
    jparams = jcnf.odenet_init(jax.random.PRNGKey(17), jcfg)
    rng = np.random.default_rng(17)
    tc = (0.5 * rng.standard_normal((2, 17))).astype(np.float32)
    y, e = rng.standard_normal((2, 2, 100, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jax_out = (np.asarray(jcnf_fused.fused_concatsquash_primal(
                       jparams, jnp.asarray(tc), jnp.asarray(y), "bf16")),
                   *(np.asarray(a) for a in jcnf_fused.fused_concatsquash_dynamics(
                       jparams, jnp.asarray(tc), jnp.asarray(y), jnp.asarray(e), "bf16")))
    params = _to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    packed = (cnf_fused.context_gb(params, _t(tc)), *cnf_fused.pack_weights(params))
    p64 = _double(params)
    packed64 = (cnf_fused.context_gb(p64, _t(tc).double()), *cnf_fused.pack_weights(p64))
    y64, e64 = _t(y).double(), _t(e).double()
    exact = (cnf_fused.primal_packed(y64, *packed64),
             *cnf_fused.dynamics_packed(y64, e64, *packed64))
    return _t(y), _t(e), packed, jax_out, exact


def _tile_stack(dims, act):
    y, e, packed, _, _ = _problem(dims)
    return (arith.primal_tile(y, *packed, act=act), *arith.dynamics_tile(y, e, *packed, act=act))


def _plain_stack(dims):
    y, e, packed, _, _ = _problem(dims)
    return (cnf_fused.primal_packed(y, *packed, "bf16"),
            *cnf_fused.dynamics_packed(y, e, *packed, "bf16"))


def _hold_to_jax(dims, got, div_to_jax=True):
    _, _, _, jax_out, exact = _problem(dims)
    plain = _plain_stack(dims)
    for name, g, want, p, x in zip(("primal dx", "dynamics dx", "dynamics div"), got, jax_out,
                                   plain, exact):
        err = _rel(g, want)
        ours, theirs = _rel(g, x), _rel(p, x)
        if name != "dynamics div" or div_to_jax:
            assert err <= FIELD_TOL, (name, err)
        assert ours <= VS64_RATIO * theirs, (name, "from float64: model", ours, "plain", theirs)


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
def test_rounding_once_in_the_tile_is_the_plain_versions_rounding(dims):
    """(a): bit for bit, both kernels."""
    for got, want in zip(_tile_stack(dims, arith.exact_softplus_sigmoid), _plain_stack(dims)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("sign", ["up", "down", "random"])
@pytest.mark.parametrize("dims", DIMS, ids=_ids)
def test_activations_off_by_the_bar_keep_the_jax_bars(dims, sign):
    """(b)."""
    act = {"up": arith.perturbed(arith.SFU_BAR), "down": arith.perturbed(-arith.SFU_BAR),
           "random": arith.perturbed(arith.SFU_BAR, seed=5)}[sign]
    got = _tile_stack(dims, act)
    _hold_to_jax(dims, got, div_to_jax=False)
    # the perturbation reaches the outputs: the bar is not below every rounding
    assert any(not torch.equal(g, p) for g, p in zip(got, _plain_stack(dims)))


@pytest.mark.parametrize("dims", DIMS, ids=_ids)
def test_the_sfu_algorithm_through_the_stack_keeps_the_jax_bars(dims):
    _hold_to_jax(dims, _tile_stack(dims, arith.softplus_sigmoid_sfu))


@pytest.mark.parametrize("corner", [(0, 0, 0), (1, 1, 1), (-1, -1, -1), (1, -1, 1), (-1, 1, -1)])
def test_the_sfu_algorithm_is_within_its_bar(corner):
    """softplus_sfu and the sigmoid within 2^-16 of float64 from x = -87.3 up
    (and under 2^-126 below), with the special functions exact or at their
    error bounds in either direction."""
    x = arith.sfu_inputs(1 << 18)
    errs = [c * b for c, b in zip(corner, (arith.EX2_ERR, arith.LG2_ERR, arith.RCP_ERR))]
    got = arith.sfu_rel_errors(x, *arith.softplus_sigmoid_sfu(x, *errs))
    assert got["softplus_rel"] <= arith.SFU_BAR, got
    assert got["sigmoid_rel"] <= arith.SFU_BAR, got
    assert got["softplus_abs_below"] <= 2.0 ** -126, got
    # the margin the design claims: under 2^-17 with exact special functions
    if corner == (0, 0, 0):
        assert max(got["softplus_rel"], got["sigmoid_rel"]) <= 2.0 ** -17, got


def test_the_sfu_series_and_logarithm_meet_at_one_sixteenth():
    """Both branches of log1p_sfu agree with float64 log1p on each side of u
    = 1/16 (|x| = ln 16), so the switch adds no step."""
    x = torch.tensor([math.log(16.0)], dtype=torch.float32)
    ints = x.view(torch.int32) + torch.arange(-2000, 2001, dtype=torch.int32)
    for xs in (ints.view(torch.float32), -ints.view(torch.float32)):
        sp, _ = arith.softplus_sigmoid_sfu(xs)
        want = torch.logaddexp(xs.double(), torch.zeros_like(xs.double()))
        assert float(((sp.double() - want).abs() / want).max()) <= 2.0 ** -18


@pytest.mark.parametrize("hpad", [128, 256, 384, 512])
def test_the_a_operand_reads_the_tile_where_the_epilogue_writes(hpad):
    size = hpad // 8 * arith.TILE_LBO
    offsets = {arith.btile_at(r, c) for r in range(arith.ROWS) for c in range(hpad)}
    assert len(offsets) == arith.ROWS * hpad and max(offsets) + 2 <= size
    assert all(o % 2 == 0 for o in offsets)
    for kk in range(hpad // arith.SLICE_K):
        for m in range(arith.ROWS):
            for k in range(arith.SLICE_K):
                assert arith.a_operand_at(m, k, kk) == arith.btile_at(m, 16 * kk + k)
    # descriptor start addresses 16-byte aligned
    assert all((kk * 2 * arith.TILE_LBO) % 16 == 0 for kk in range(hpad // 16))


@pytest.mark.parametrize("hpad", [128, 256, 384, 512])
def test_the_b_operand_reads_the_weights_of_its_ring_stage(hpad):
    """For each block rotation, layer, warpgroup, chunk, step and K-slice of
    the step: the stage load_tslice copies into the warpgroup's ring (one
    bulk copy, or two where the step's K-slices wrap) holds, where b_desc
    reads element (n, k), the weight of output channel wg * H_pad / 2 + 64 c
    + n and input channel 16 kk + k, kk the K-slice whose A the same wgmma
    reads."""
    ks, nch, half = hpad // 16, hpad // 128, hpad // 2
    spc = ks // arith.SUB
    layers = 2
    slots = {arith.weight_slot(l, o, k, hpad) for l in range(layers) for o in range(hpad)
             for k in range(hpad)}
    assert slots == set(range(layers * hpad * hpad))
    for block in (0, 1, 3, ks - 1, 1000):
        for l in range(layers):
            for wg in range(2):
                for c in range(nch):
                    for m in range(spc):
                        s = (l * nch + c) * spc + m
                        pieces = arith.stage_pieces(s, ks, block, wg)
                        assert sum(size for _, size, _ in pieces) == arith.SUB * arith.SLICE_BYTES
                        assert all(src % 16 == 0 and dst % 16 == 0 for src, _, dst in pieces)
                        for j in range(arith.SUB):
                            kk = arith.rotated_slice(m * arith.SUB + j, ks, block)
                            for n in range(0, 64, 7):
                                for k in range(16):
                                    o = wg * half + 64 * c + n
                                    want = 2 * arith.weight_slot(l, o, 16 * kk + k, hpad)
                                    got = arith.stage_source(s, ks, block, wg,
                                                             arith.b_operand_at(n, k, j))
                                    assert got == want


def _banks(byte_offsets):
    """The shared-memory wavefronts a warp's access needs: the number of
    distinct 4-byte words on the busiest bank."""
    words = {}
    for off in byte_offsets:
        words.setdefault((off // 4) % 32, set()).add(off // 4)
    return max(len(w) for w in words.values())


@pytest.mark.parametrize("hpad", [128, 512])
def test_a_warps_tile_accesses_are_free_of_bank_conflicts(hpad):
    for w in range(4):  # epilogue stores: lane (g, t) -> rows 16 w + g (+ 8), 2 channels
        for j in range(8):
            for c in range(hpad // 128):
                ch0 = 64 * c + 8 * j
                for dr in (0, 8):
                    offs = [arith.btile_at(16 * w + lane // 4 + dr, ch0 + 2 * (lane % 4))
                            for lane in range(32)]
                    assert _banks(offs) == 1
    for r in range(arith.ROWS):  # last layer: lane reads column lane + 32 i of row r
        for i in range(hpad // 32):
            assert _banks([arith.btile_at(r, 32 * i + lane) for lane in range(32)]) == 1
    for r in range(arith.ROWS):  # first layer: lane writes channels 2 lane, + 1 (+ 64 i) of row r
        for base in range(0, hpad, 64):
            assert _banks([arith.btile_at(r, base + 2 * lane) for lane in range(32)]) == 1
