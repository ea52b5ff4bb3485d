"""Cells on several ranks and a reference per configuration, on the CPU.

A configuration file may name its reference module, which alone checks it;
the seeded weights of the existing cells are those of the harness before
the key existed.  The data-parallel train driver runs on two gloo ranks at
the tiny size (``tiny.py``), is correct, and is not correct when a rank's
gradient skips the all-reduce; a rank that ends early ends the run with a
failure, fast.  The readers of the collectives' metrics give hand-counted
values on a hand-built trace and counter."""

import copy
import hashlib
import json
import time
import types
from argparse import Namespace
from pathlib import Path

import pytest
import torch

import run
import tiny
from harness import core, program, ranks
from harness.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DP = "tiny_train_dp"
STUB = '''"""A stand-in reference for tests: a model without T-NOCS regression."""

IMPLEMENTS = {"regress_tnocs": False}


def check_model(m):
    wrong = {k: m.get(k) for k, v in IMPLEMENTS.items() if m.get(k) != v}
    if wrong:
        raise ValueError(f"the stub computes {IMPLEMENTS}, not {wrong}")


def param_shapes(m):
    return {"head": {"weight": (4, m["latent_feat_size"]), "bias": (4,)}}
'''
# sha256 of the float32 bytes of made_weights(cell, "cpu", 2**31 + 5)'s
# (params, state) leaves, in order, by the harness before configurations
# named their reference
PARENT_DIGESTS = {
    "tiny_train": "fe598978ec47f07147fd4d7c79e6386634113dc52f2a90372cb89e2a6475f91a",
    "tiny_tnocs": "9765ace2d610e6d8d8636ace66dc185f33b84d4ad00f2a59421fe6c95c7c561c",
    "tnocs_eval_b16": "53b9120ec53cbd9d51dcc9e2e13e6e9ff08f97cfcc8dbe0c3941f46026907947",
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny copy with a data-parallel train cell on 2 ranks and a cell
    whose configuration (no T-NOCS regression) names a stub reference."""
    bench = tiny.make_copy(tmp_path_factory.mktemp("ranks"))
    root = bench.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "tiny_train.json").read_text())
    traffic.update(driver="train_step_dp", batch=4)
    traffic["limits"]["ranks_gap"] = 0.0
    (bench / "traffic" / f"{DP}.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": DP, "config": "tiny_cars", "traffic": DP, "chips": 2,
                              "why": "test"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "train_cars_dp4_b20" in metric.get("workloads", []):
            metric["workloads"].append(DP)
    (bench / "reference" / "stub_ref.py").write_text(STUB)
    cars = json.loads((bench / "configs" / "tiny_cars.json").read_text())
    for name, ref in (("tiny_warp", "stub_ref"), ("tiny_warp_caspr", "caspr"), ("tiny_warp_none", None)):
        cfg = copy.deepcopy(cars)
        cfg["model"]["regress_tnocs"] = False
        if ref is not None:
            cfg["reference"] = ref
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test", "reduced": [],
                                "file": f"{bench.name}/configs/{name}.json"})
        spec["workloads"].append({"name": name, "config": name, "traffic": "tiny_recon",
                                  "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def test_a_configuration_is_checked_by_the_reference_it_names(bench):
    cell = core.load_cell("tiny_warp", bench)
    assert Path(cell.reference.__file__) == bench / "reference" / "stub_ref.py"
    assert cell.reference.IMPLEMENTS == {"regress_tnocs": False}
    assert cell.model["regress_tnocs"] is False
    shapes = cell.reference.param_shapes(cell.model)
    weights, _ = program.made_weights(cell, "cpu", 7)
    assert weights["head"]["weight"].shape == shapes["head"]["weight"]
    for name in ("tiny_warp_caspr", "tiny_warp_none"):  # caspr computes T-NOCS regression
        with pytest.raises(ValueError, match="regress_tnocs"):
            core.load_cell(name, bench)


def digest(params, state):
    h = hashlib.sha256()
    for leaf in program.leaves([params, state]):
        h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PARENT_DIGESTS))
def test_the_cells_load_caspr_and_make_the_weights_they_made(bench, name):
    from reference import caspr

    where = BENCH if name == "tnocs_eval_b16" else bench
    cell = core.load_cell(name, where)
    assert cell.reference.__name__ == "reference.caspr"
    assert cell.reference.param_shapes(cell.model) == caspr.param_shapes(cell.model)
    assert digest(*program.made_weights(cell, "cpu", 2**31 + 5)) == PARENT_DIGESTS[name]


def test_the_benchmark_cells_load_the_imported_caspr():
    from reference import caspr

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        assert core.load_cell(w["name"], BENCH).reference is caspr


def dp_run(bench, monkeypatch, fault=None, timeout=120.0):
    """A run of the tiny dp cell on 2 gloo ranks: ((out, code), seconds)."""
    monkeypatch.setenv("PYTHONPATH", str(REPO))  # the ranks run the copy's run.py
    args = Namespace(workload=DP, seed=2**31 + 21, seconds=1.0, trace=0)
    cell = core.load_cell(DP, bench)
    start = time.perf_counter()
    out = ranks.launch(args, cell, bench, start, device="cpu", fault=fault, timeout=timeout)
    return out, time.perf_counter() - start


def test_the_dp_driver_on_two_ranks_is_correct(bench, monkeypatch, capsys):
    (out, code), _ = dp_run(bench, monkeypatch)
    assert code is None, code
    result, table = out["result"], out["table"]
    assert result["correct"], table
    assert table["ranks_gap"] == {"value": 0.0, "limit": 0.0}
    assert result["device"]["count"] == 2 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_seqs_per_s", "setup_s"}
    core.emit(result, table)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["correct"] is True


def test_a_gradient_that_skips_the_all_reduce_is_not_correct(bench, monkeypatch):
    (out, code), _ = dp_run(bench, monkeypatch, fault="gradient_not_reduced")
    assert code is None, code
    assert out["table"]["ranks_gap"]["value"] > 0
    assert not out["result"]["correct"]


def test_a_rank_that_ends_early_fails_the_run_in_time(bench, monkeypatch, capsys):
    (out, code), seconds = dp_run(bench, monkeypatch, fault="rank_exits", timeout=90.0)
    assert out is None and code != 0
    assert seconds < 90.0
    assert "rank 1 exited 0 before its run ended" in capsys.readouterr().err


def reader(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", "test_metric_" + name.replace(".", "_"))


def hand_trace(calls=2):
    device = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.0, 0.25, "kernel"),
              ("nccl:all_reduce", 0.0, 0.26, "kernel"),  # torch's annotation: not a kernel
              ("cnf_dynamics_kernel", 0.1, 1.0, "kernel"),
              ("ncclKernel_Broadcast_RING_LL_Sum_int8_t", 2.0, 2.5, "kernel"),
              ("Memcpy HtoD", 3.0, 3.5, "kernel")]
    return Trace(window_s=4.0, calls=calls, device_ops=device)


COUNTED = {"norm": {"calls": 700, "bytes": 700 * 4}, "grad": {"calls": 2, "bytes": 2 * 50_000_000},
           "adjoint_vjp": {"calls": 100, "bytes": 100 * 8_000_000}}


@pytest.mark.parametrize("name,expected", [
    ("allreduce_mb_per_step.train", (2800 + 100_000_000 + 800_000_000) / 1e6 / 2),
    ("collectives_per_step.train", 802 / 2),
    ("nccl_ms_per_step.train", 1000.0 * 0.75 / 2),
])
def test_collective_readers_give_the_hand_counted_values(name, expected):
    r = types.SimpleNamespace(trace=hand_trace(), counters={"collectives": COUNTED})
    assert reader(name).read(r) == pytest.approx(expected, rel=1e-12)
    for nothing in (types.SimpleNamespace(trace=None, counters={}),
                    types.SimpleNamespace(trace=hand_trace(calls=0), counters={"collectives": COUNTED})):
        assert reader(name).read(nothing) is None


def test_collective_readers_need_their_counter_or_kernels():
    r = types.SimpleNamespace(trace=Trace(window_s=1.0, calls=2,
                                          device_ops=[("cnf_dynamics_kernel", 0.0, 0.5, "kernel")]),
                              counters={})
    for name in ("allreduce_mb_per_step.train", "collectives_per_step.train",
                 "nccl_ms_per_step.train"):
        assert reader(name).read(r) is None


def test_mfu_on_one_card_reads_as_before():
    from harness import flops, peaks

    cell = core.load_cell("train_cars_b20", BENCH)
    infos = [{"seqs": 20, "nfe": (26.0, 20.0), "nfe_bwd": (454.0, 28.0)},
             {"seqs": 20, "nfe": (27.0, 20.0), "nfe_bwd": (442.0, 26.0)}]
    r = core.Readings(cell, window_s=3.1, infos=infos)
    m, t = cell.model, cell.traffic
    work = sum(info["seqs"] * flops.train_flops(m, t["seq_len"], t["points"], info["nfe"],
                                                info["nfe_bwd"]) for info in infos)
    parent = 100.0 * work / r.window_s / peaks.DENSE_FLOPS  # the reader before cells on several cards
    assert reader("mfu_pct.train").read(r) == parent
    four = core.load_cell("train_cars_dp4_b20", BENCH)
    assert reader("mfu_pct.train").read(core.Readings(four, window_s=3.1, infos=infos)) == \
        pytest.approx(parent / 4, rel=1e-12)


def test_solo_and_a_run_on_one_card_decide_alone():
    team = ranks.Solo()
    assert team.lead and team.agree(True) is True and team.agree(False) is False
    assert team.largest(5) == 5
    assert run.parse(["--workload", "x", "--seed", str(2**40), "--seconds", "1"]).trace == 0
