"""The controls on the card, at the cells' widths and sizes that a test run
holds: the plain reference with its float32 products in TF32, put in the
program's place, fails a limit of the cell, and the program passes them;
in the training cell a zero gradient on the CNF's field weights fails one.
On the CPU these skip (TF32 exists on the card alone)."""

import json

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
