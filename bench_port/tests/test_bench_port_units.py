"""The benchmark's arithmetic and its inputs: the traffic generator, the work
counts, the interval arithmetic of the idle share, the import guard."""

import math
import subprocess
import sys
import types

import pytest
import torch

from harness import core, flops, intervals, sequences
from harness.trace import Trace

BENCH = core.Path(__file__).resolve().parents[1]

TRAFFIC = {"frames": 4, "points": 32, "batch": 3, "pool": 2, "max_timestamp": 5.0,
           "motion": {"axes": [0.2, 0.45], "turn": [0.1, 0.4], "drift": 0.1, "distance": 1.5},
           "base_samples": True}


def pool(seed, **extra):
    gen = torch.Generator().manual_seed(seed)
    return sequences.make_pool(gen, {**TRAFFIC, **extra}, "cpu")


def test_pool_is_deterministic_by_seed():
    a, b, c = pool(2**31 + 5), pool(2**31 + 5), pool(2**31 + 6)
    for x, y in zip(a, b):
        for key in x:
            assert torch.equal(x[key], y[key])
    assert not torch.equal(a[0]["input"], c[0]["input"])
    assert not torch.equal(a[0]["input"], a[1]["input"])  # the pool's batches differ


def test_sequences_have_the_dataset_format():
    (entry, _) = pool(3)
    x, y = entry["input"], entry["target"]
    assert x.shape == (3, 4, 32, 4) and entry["base"].shape == (3, 4, 32, 3)
    steps = torch.arange(4) / 3
    assert torch.allclose(y[..., 3], steps[None, :, None].expand(3, 4, 32))
    assert torch.allclose(x[..., 3], 5.0 * y[..., 3])
    # points on an ellipsoid in the unit cube, rigidly moved: distances kept
    assert (y[..., :3] >= 0).all() and (y[..., :3] <= 1).all()
    exact = "donot_use_mm_for_euclid_dist"
    d_nocs = torch.cdist(y[0, 1, :, :3], y[0, 1, :, :3], compute_mode=exact)
    d_world = torch.cdist(x[0, 1, :, :3], x[0, 1, :, :3], compute_mode=exact)
    assert torch.allclose(d_nocs, d_world, atol=1e-5)


def test_training_frames_are_sorted_and_start_at_zero():
    (entry, _) = pool(4, frames=10, seq_len=5, hutchinson_noise=True)
    x, y = entry["input"], entry["target"]
    assert x.shape == (3, 5, 32, 4) and entry["noise"].shape == (15, 32, 3)
    assert (y[:, 0, :, 3] == 0).all() and (x[:, 0, :, 3] == 0).all()
    assert (y[:, 1:, 0, 3] > y[:, :-1, 0, 3]).all()
    assert torch.allclose(x[..., 3], 5.0 * y[..., 3], atol=1e-6)


MODEL = {"radii_list": [0.02, 0.05, 0.1, 0.2, 0.4, 0.8], "sa_points": [1024, 512, 256, 64, 16],
         "ball_samples": [16, 32], "local_feat_size": 512, "latent_feat_size": 1600,
         "global_feat_size": 1024, "space_time_pt_feat": 64, "ode_hidden_size": 512,
         "motion_feat_size": 64, "cnf_dims": [512, 512, 512]}


def test_cnf_work_by_hand():
    per_row = 3 * 512 + 512 * 512 + 512 * 512 + 512 * 3  # multiply-adds of 3-512-512-512-3
    for passes in (1, 2, 4):
        f, b = flops.cnf_work(MODEL, 160, 2048, passes)
        assert f == 2 * passes * 160 * 2048 * per_row
        assert b > 160 * 2048 * 3 * 4 * 2  # at least the points in and out
    assert flops.cnf_context(MODEL) == 2 * 1601 * (512 * 3 + 3)


def test_fusion_convs_by_hand():
    # the products that depend on latent_feat_size are the fusion conv2's
    # (1600 -> out) and the T-NOCS head's (out -> 4), over every point
    small = {**MODEL, "latent_feat_size": 800}
    tn = 10 * 2048
    delta = flops.encoder_flops(MODEL, 10, 2048) - flops.encoder_flops(small, 10, 2048)
    assert delta == 2 * tn * (1600 * (1600 - 800) + (1600 - 800) * 4)


def test_counts_match_the_reference_products():
    """The CNF field's and the latent field's counts are exactly the
    products the plain reference computes; the encoder's count is at most
    the unfactored reference's."""
    from torch.utils.flop_counter import FlopCounterMode

    from reference import caspr as ref

    tiny = {**MODEL, "local_feat_size": 32, "latent_feat_size": 48, "global_feat_size": 32,
            "space_time_pt_feat": 16, "cnf_dims": [32, 32, 32], "ode_hidden_size": 32,
            "motion_feat_size": 16, "sa_points": [32, 16, 8, 4, 3], "ball_samples": [4, 8],
            "pretrain_tnocs": False, "radii_list": [0.1, 0.2, 0.3, 0.4, 0.6, 0.8]}
    from harness.weights import seeded_weights

    gen = torch.Generator().manual_seed(0)
    params = seeded_weights(gen, ref.param_shapes(tiny), "cpu")
    layers = params["point_cnf"][1]["odenet"]["layers"]
    clouds, points = 6, 64
    with FlopCounterMode(display=False) as count:
        ref.field(layers, 0.1, torch.randn(clouds, 48), torch.randn(clouds, points, 3))
    want = flops.cnf_work(tiny, clouds, points, 1)[0] + 2 * clouds * flops.cnf_context(tiny)
    assert count.get_total_flops() == want
    with FlopCounterMode(display=False) as count:
        ref.latent_field(params["latent_ode"], torch.randn(5, 16))
    assert count.get_total_flops() == 5 * flops.latent_flops(tiny)
    x = pool(1, points=64, frames=3, batch=2)[0]["input"]
    with FlopCounterMode(display=False) as count:
        ref.encode(params, tiny, x)
    assert 0.3 * count.get_total_flops() < 2 * flops.encoder_flops(tiny, 3, 64) \
        <= 2 * count.get_total_flops()


def test_latent_and_reconstruct_counts():
    assert flops.latent_flops(MODEL) == 2 * (64 * 512 + 512 * 512 * 2 + 512 * 64)
    enc = flops.encoder_flops(MODEL, 10, 2048)
    one = flops.reconstruct_flops(MODEL, 10, 2048, 26, 20)
    cnf = flops.cnf_work(MODEL, 10, 2048, 1)[0] + 2 * 10 * flops.cnf_context(MODEL)
    assert math.isclose(one, enc + 26 * flops.latent_flops(MODEL) + 20 * cnf)


def test_union_busy_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (6.0, 7.0)]
    assert intervals.union(spans) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert intervals.busy(spans, 0.0, 10.0) == 4.0  # overlaps counted once
    assert intervals.busy(spans, 1.5, 6.5) == 0.5 + 1.0 + 0.5
    assert intervals.gaps(spans, 0.0, 8.0) == [(2.0, 3.0), (4.0, 6.0), (7.0, 8.0)]
    host = [("step", 0.0, 8.0), ("sync", 4.5, 5.9), ("item", 2.1, 2.9)]
    assert intervals.label_gaps(intervals.gaps(spans, 0.0, 8.0), host) == {
        "item": 1.0, "sync": 2.0, "step": 1.0}


def test_trace_idle_share():
    t = Trace(window_s=10.0, calls=2,
              device_ops=[("k1", 0.0, 4.0, "kernel"), ("k2", 2.0, 5.0, "kernel"),
                          ("copy", 8.0, 9.0, "memcpy")],
              host=[("aten::item", 5.0, 8.0)])
    assert t.busy_s() == 6.0
    assert t.kernels(("k2",)) == [("k2", 2.0, 5.0)] and len(t.kernels()) == 2
    assert t.top_ops()[0] == ("k1", 4.0)
    assert dict(t.idle_by_host()) == {"aten::item": 3.0, "python between operators": 1.0}


def test_wrapper_kernels_take_the_weight_preparation_before_them():
    ops = [("split_weights_kernel", 0.0, 0.1), ("vjp_tile_kernel<4>", 0.1, 1.0),
           ("wgrad_tc_kernel", 1.0, 1.5), ("split_weights_kernel", 2.0, 2.1),
           ("elementwise_kernel", 2.1, 2.2), ("vjp_tile_kernel<4>", 2.2, 3.0),
           ("tile_weights_kernel", 3.0, 3.1), ("tile_weights_kernel", 3.1, 3.2),
           ("cnf_primal_bf16_kernel<4>", 3.2, 4.0)]
    t = Trace(window_s=5.0, calls=1, device_ops=[(*op, "kernel") for op in ops[::-1]])
    # a preparation counts for the named kernel that follows it next
    assert [k[1] for k in t.wrapper_kernels(("vjp_tile_kernel", "wgrad_tc_kernel"))] == [
        0.0, 0.1, 1.0, 2.2]
    assert [k[1] for k in t.wrapper_kernels(("cnf_primal_bf16_kernel",))] == [3.0, 3.1, 3.2]


def test_a_model_or_dtype_other_than_stated_is_refused():
    from harness import program
    from reference import caspr as ref

    cell = core.load_cell("recon_cars_b16", BENCH)
    for key, value in (("cnf_nonlinearity", "tanh"), ("cnf_blocks", 2), ("augment_pairs", False)):
        with pytest.raises(ValueError, match=key):
            ref.check_model({**cell.model, key: value})
    params = {"a": torch.zeros(2), "b": [torch.zeros(1, dtype=torch.float64)]}
    with pytest.raises(ValueError, match="float64"):
        program.stated_dtype(cell, params)


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "caspr_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("x"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "caspr_tpu.models", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert core.forbidden_modules() == ["caspr_tpu", "jax"]
    with pytest.raises(core.ForbiddenImport, match="caspr_tpu, jax"):
        core.guard("test")


def test_reference_and_harness_load_neither_jax_nor_the_program():
    code = ("import sys; sys.path[:0] = ['bench_port']; "
            "import reference.caspr, harness.core, harness.flops, harness.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'caspr_tpu', 'caspr_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=core.Path(__file__).resolve().parents[2], check=True)
    assert out.stdout.strip() == "[]"
