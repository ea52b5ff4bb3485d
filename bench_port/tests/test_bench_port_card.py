"""The controls on the card, at the cells' widths and sizes that a test run
holds: the plain reference with its float32 products in TF32, put in the
program's place, fails a limit of the cell, and the program passes them;
in the training cell a zero gradient on the CNF's field weights fails one,
and in the data-parallel one, on two cards, a rank's gradient that skips
the all-reduce.  On the CPU these skip (TF32 exists on the card alone)."""

import json
import subprocess
import sys

import pytest

import readings
import tiny
from harness import core

pytestmark = pytest.mark.card

# the evaluation cells at their own batch (a widest gap grows with the points
# compared: at batch 2 the T-NOCS control read 8.4e-4, under the cell's
# limit), the training cell at a fifth of its batch
SMALL = {"recon_cars_b16": {"pool": 3, "check_calls": 1},
         "tnocs_eval_b16": {"pool": 3, "check_calls": 1},
         "train_cars_b20": {"batch": 4, "pool": 3}}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_program_passes(card, tmp_path, cell):
    import torch

    bench = tiny.make_copy(tmp_path)
    (tmp_path / "artifacts").symlink_to(tiny.BENCH.parent / "artifacts")  # the checkpoint
    path = bench / "traffic" / f"{cell}.json"
    traffic = {**json.loads(path.read_text()), **SMALL[cell]}
    path.write_text(json.dumps(traffic))
    c = core.load_cell(cell, bench)
    module = core.load_module(bench / "drivers" / f"{traffic['driver']}.py", "card_driver")
    limits = traffic["limits"]
    driver = None
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        if traffic["driver"] == "train_step":
            row = readings.train_readings(torch, module, c, seed, True, "cuda")
        else:
            if driver is None:
                driver = module.Driver(c, "cuda", *core.seeds(seed, 2))
                driver.warm()
            row = readings.eval_readings(torch, driver, c, seed, True, "cuda")
        assert all(row["program"][k] <= limits[k] for k in limits), row
        assert any(row["control"][k] > limits[k] for k in limits), row
        if traffic["driver"] == "train_step":
            # a zero gradient on the CNF's field weights alone fails a limit
            assert any(row["cnf_grad_zeroed"][k] > limits[k] for k in limits), row


def test_dp_control_and_faults_fail_and_program_passes(card, tmp_path):
    """``train_cars_dp4_b20`` on two cards at a fifth of its global batch,
    through ``readings.py``'s ranks."""
    import torch

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cell = "train_cars_dp4_b20"
    bench = tiny.make_copy(tmp_path)
    for name in ("artifacts", "caspr_tpu_torch"):  # the checkpoint, the program
        (tmp_path / name).symlink_to(tiny.BENCH.parent / name)
    path = bench / "traffic" / f"{cell}.json"
    traffic = {**json.loads(path.read_text()), "batch": 4, "pool": 3}
    path.write_text(json.dumps(traffic))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        if w["name"] == cell:
            w["chips"] = 2
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    seeds = [str(2**31 + k) for k in (1, 2, 3)]
    out = subprocess.run([sys.executable, str(bench / "readings.py"), "--workload", cell,
                          "--seeds", *seeds, "--control-seeds", *seeds, "--timeout", "1200"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=1300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    limits = traffic["limits"]
    assert len(rows) == 3
    for row in rows:
        assert all(row["program"][k] <= limits[k] for k in limits), row["program"]
        assert any(row["control"][k] > limits[k] for k in limits if k in row["control"]), row
        assert any(row["cnf_grad_zeroed"][k] > limits[k] for k in limits), row
        assert row["gradient_not_reduced"]["ranks_gap"] > limits["ranks_gap"], row
