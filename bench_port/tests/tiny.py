"""A copy of the benchmark with tiny cells added as data alone (a
configuration, traffic files and BENCHMARK.json entries), for CPU runs."""

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_MODEL = {"radii_list": [0.1, 0.2, 0.3, 0.4, 0.6, 0.8], "local_feat_size": 32,
              "latent_feat_size": 48, "ode_hidden_size": 32, "motion_feat_size": 16,
              "global_feat_size": 32, "space_time_pt_feat": 16, "cnf_dims": [32, 32, 32],
              "sa_points": [32, 16, 8, 4, 3], "ball_samples": [4, 8]}
GROUPS = ("encoder", "latent_ode", "point_cnf")
SHAPE = {"batch": 2, "frames": 3, "points": 64, "pool": 3, "warmup_calls": 1}
CELLS = {
    "tiny_recon": ("tiny_cars", {"driver": "reconstruct", "base_samples": True,
                                 "check_calls": 2, "trace_calls": 1,
                                 "limits": {"tnocs_gap": 1e-4, "points_gap": 1e-4,
                                            "nfe_gap": 0}}),
    "tiny_tnocs": ("tiny_tnocs", {"driver": "encode", "check_calls": 2, "trace_calls": 1,
                                  "limits": {"tnocs_gap": 1e-4, "latent_gap": 1e-4}}),
    "tiny_train": ("tiny_cars", {"driver": "train_step", "seq_len": 2, "frames": 4,
                                 "hutchinson_noise": True, "check_steps": 3,
                                 "check_calls": 0, "trace_calls": 1,
                                 # Adam's first steps move near-zero gradient
                                 # entries by their sign: tiny leaves are noisy
                                 "limits": {"loss_gap": 1e-2, "nfe_gap": 0,
                                            **{f"grad_gap.{g}": 1e-1 for g in GROUPS},
                                            **{f"change_gap.{g}": 0.5 for g in GROUPS}}}),
}


def make_copy(tmp: Path) -> Path:
    """tmp/BENCHMARK.json and tmp/bench_port with the tiny cells; returns
    the copy's bench_port."""
    bench = tmp / BENCH.name
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cars = json.loads((BENCH / "configs" / "caspr_cars.json").read_text())
    base = json.loads((BENCH / "traffic" / "recon_cars_b16.json").read_text())
    for name, pretrain in (("tiny_cars", False), ("tiny_tnocs", True)):
        cfg = copy.deepcopy(cars)
        cfg["model"].update(TINY_MODEL, pretrain_tnocs=pretrain)
        cfg["weights"] = "seed"
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test", "reduced": [],
                                "file": f"{bench.name}/configs/{name}.json"})
    for cell, (config, traffic) in CELLS.items():
        t = {k: base[k] for k in ("max_timestamp", "motion")}
        t.update(SHAPE, **traffic)
        (bench / "traffic" / f"{cell}.json").write_text(json.dumps(t))
        spec["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1,
                                  "why": "test"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            kind = "train" if traffic["driver"] == "train_step" else "eval"
            if "workloads" in metric and (metric["name"].startswith(kind)
                                          or metric["name"].endswith("." + kind)):
                metric["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
