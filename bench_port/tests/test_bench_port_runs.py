"""Whole runs of tiny cells on the CPU, past the look for a card: cells added
as data alone are found, sound runs are correct, and each fault that a cell
can have under its timed path makes ``correct`` false."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import run
import tiny
from harness import faults


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def tiny_run(bench, cell, trace=0, fault=None, seed=2**31 + 11):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                      "--trace", str(trace)])
    return run.run_cell(args, bench=bench, device="cpu", start=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("cell", ["tiny_recon", "tiny_tnocs", "tiny_train"])
def test_cells_added_as_data_run_and_are_correct(bench, cell):
    result, table = tiny_run(bench, cell)
    assert result["correct"], table
    assert result["attempted"] >= 1 and result["failed"] == 0
    rate = "train_seqs_per_s" if cell == "tiny_train" else "eval_seqs_per_s"
    assert set(result["metrics"]) >= {rate, "setup_s"}
    traced, _ = tiny_run(bench, cell, trace=1)
    assert traced["correct"] and "setup_s" not in traced["metrics"]
    assert traced["metrics"], "a traced run reads per-layer metrics"


@pytest.mark.parametrize("cell,fault", [
    ("tiny_recon", "answer_altered"), ("tiny_recon", "half_batch"),
    ("tiny_tnocs", "answer_altered"), ("tiny_tnocs", "half_batch"),
    ("tiny_train", "state_unchanged"), ("tiny_train", "half_batch"),
    ("tiny_train", "cnf_grad_zeroed"),
])
def test_a_broken_timed_path_is_not_correct(bench, cell, fault):
    result, table = tiny_run(bench, cell, fault=faults.FAULTS[fault])
    assert not result["correct"], table


def test_a_run_without_the_program_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    alone = tiny.make_copy(tmp_path)
    out = subprocess.run([sys.executable, str(alone / "run.py"), "--workload", "recon_cars_b16",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_a_loaded_jax_module_stops_the_run(bench, monkeypatch):
    def plant(driver):
        import types
        monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))

    with pytest.raises(run.core.ForbiddenImport):
        tiny_run(bench, "tiny_tnocs", fault=plant)


def test_result_line_is_last_and_checks_come_last(capsys):
    run.core.emit({"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}},
                  {"points_gap": {"value": 1e-6, "limit": 1e-4}})
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert err.splitlines()[-1] == "check points_gap 1e-06 limit 0.0001"
