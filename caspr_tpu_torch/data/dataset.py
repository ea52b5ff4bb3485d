"""Dynamic point-cloud sequence dataset and its batching loader: the port's
own copy of caspr_tpu/data/dataset.py (numpy and threads only), with the
same observable semantics:

  - ``@cfg``-file dataset options through a line-splitting argparse parser;
    relative paths resolve against the working directory, then against the
    cfg file's directory and its parent;
  - split selection by split-file directories or train / val fractions,
    the ``BAD_MODELS`` skip list, the expected-sequence-length filter;
  - per-sequence npz loading with blank-frame truncation, repeat padding
    of short frames, and NOCS [0, 1] / world [0, max_timestamp] timestamps;
  - per-item sorted time-step subsampling and point subsampling (per
    sequence or per step), ``shift_time_to_zero``, pose data, first steps;
  - ``SequenceLoader``: the epoch order and every item's generator derive
    from ``SeedSequence([seed, epoch])``; ``pad_last`` with ``valid``,
    ``drop_last``, ``num_shards`` / ``shard_index``; a thread pool fetches
    two batches ahead.

Batches stay numpy: the model's entry points move them to its device.
Where the JAX package reads ``CASPR_TPU_NATIVE_LOADER``, the port takes the
constructor keyword ``native_loader``.  ``SequenceLoader.waits`` holds the
seconds the consumer waited for each batch of its last pass.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

# renders that are just spheres
BAD_MODELS = [
    "93ce8e230939dfc230714334794526d4",
    "207e69af994efa9330714334794526d4",
    "2307b51ca7e4a03d30714334794526d4",
]

DEFAULT_MAX_TIMESTAMP = 5.0
DEFAULT_EXPECTED_SEQ_LEN = 10
DEFAULT_EXPECTED_NUM_PTS = 4096


class _SplitLineParser(argparse.ArgumentParser):
    def convert_arg_line_to_args(self, arg_line):
        return arg_line.split()


def parse_dataset_cfg(cfg_file_path: str):
    """Parse a dataset .cfg (--data, --splits, --max-timestamp,
    --expected-num-pts, --expected-seq-len)."""
    parser = _SplitLineParser(fromfile_prefix_chars="@", allow_abbrev=False)
    parser.add_argument("--data", type=str, nargs="+", required=True)
    parser.add_argument("--splits", type=str, nargs="+", default=None)
    parser.add_argument("--max-timestamp", type=float, default=DEFAULT_MAX_TIMESTAMP)
    parser.add_argument("--expected-num-pts", type=int, default=DEFAULT_EXPECTED_NUM_PTS)
    parser.add_argument("--expected-seq-len", type=int, default=DEFAULT_EXPECTED_SEQ_LEN)
    args = parser.parse_args(["@" + cfg_file_path])

    # the reference's cfgs name paths like ../data/cars relative to a script
    # directory one level below the repository's root: the working
    # directory first, then the cfg file's directory and its parent
    cfg_dir = os.path.dirname(os.path.abspath(cfg_file_path))

    def _resolve(p):
        if p is None or os.path.isabs(p) or os.path.exists(p):
            return p
        for anchor in (cfg_dir, os.path.join(cfg_dir, "..")):
            alt = os.path.normpath(os.path.join(anchor, p))
            if os.path.exists(alt):
                return alt
        return p

    args.data = [_resolve(p) for p in args.data]
    if args.splits is not None:
        args.splits = [_resolve(p) for p in args.splits]
    return args


def load_time_data(data_roots: Sequence[str], split: str, train_frac: float, val_frac: float,
                   splits_dirs: Optional[Sequence[str]] = None,
                   data_seq_len: int = DEFAULT_EXPECTED_SEQ_LEN) -> List[List[str]]:
    """The frame-file lists of every sequence of a split."""
    all_seq_paths: List[List[str]] = []
    for src_idx, data_root in enumerate(data_roots):
        if not os.path.exists(data_root):
            raise FileNotFoundError(f"Could not find data root {data_root}")

        split_list = None
        cur_split_dir = None
        if splits_dirs is not None:
            cur_split_dir = splits_dirs[src_idx]
            split_file = os.path.join(cur_split_dir, split + "_split.txt")
            if not os.path.exists(split_file):
                raise FileNotFoundError(f"No split file for requested split: {split_file}")
            with open(split_file, "r") as f:
                split_list = [s for s in f.read().split("\n")]

        if split_list is None:
            model_dirs = [os.path.join(data_root, f) for f in sorted(os.listdir(data_root))
                          if f[0] != "."]
            model_dirs = [f for f in model_dirs if os.path.isdir(f)]
        else:
            model_dirs = [os.path.join(data_root, m) for m in split_list if m != ""]

        seq_paths: List[List[List[str]]] = []
        for model_path in model_dirs:
            model_id = os.path.basename(model_path)
            if cur_split_dir is not None and not os.path.exists(model_path):
                print(f"WARNING: model {model_id} in split file missing; skipping")
                continue
            if model_id in BAD_MODELS:
                continue
            cur_model_paths = []
            seq_dirs = [os.path.join(model_path, f) for f in sorted(os.listdir(model_path))
                        if f[0] != "."]
            seq_dirs = [f for f in seq_dirs if os.path.isdir(f)]
            for seq_path in seq_dirs:
                frames = sorted(glob.glob(os.path.join(seq_path, "*frame*.npz")))
                if len(frames) != data_seq_len:
                    continue
                cur_model_paths.append(frames)
            seq_paths.append(cur_model_paths)

        num_models = len(seq_paths)
        if splits_dirs is None:
            if train_frac + val_frac > 1.0:
                raise ValueError("train_frac + val_frac must be <= 1.0")
            n_train = int(train_frac * num_models)
            n_val = int(val_frac * num_models)
            split_inds = {"train": np.arange(n_train),
                          "val": np.arange(n_train, n_train + n_val),
                          "test": np.arange(n_train + n_val, num_models)}[split]
        else:
            split_inds = np.arange(num_models)

        for i in split_inds.tolist():
            all_seq_paths.extend(seq_paths[i])

    return all_seq_paths


def load_seq_path(seq_path_list: Sequence[str], max_timestamp: float = DEFAULT_MAX_TIMESTAMP,
                  expected_num_pts: int = DEFAULT_EXPECTED_NUM_PTS):
    """Load one sequence: (nocs_seq (T, N, 4), depth_seq (T, N, 4), pose_seq
    (T, 4, 4)), float64.  A blank frame ends the fill (the remaining steps
    stay zero); a short frame repeats its points up to ``expected_num_pts``."""
    seq_len = len(seq_path_list)
    step_size = 0.0 if seq_len == 1 else 1.0 / (seq_len - 1)

    nocs_seq = np.zeros((seq_len, expected_num_pts, 4))
    depth_seq = np.zeros((seq_len, expected_num_pts, 4))
    pose_seq = np.zeros((seq_len, 4, 4))
    for step_idx, pc_file in enumerate(seq_path_list):
        pc_data = np.load(pc_file)
        nocs_pc = pc_data["nocs_data"]
        depth_pc = pc_data["depth_data"]
        pose = pc_data["obj_T"]

        if depth_pc.size == 0:  # warping-cars style data: NOCS as the input
            depth_pc = nocs_pc
        if pose.size == 0:
            pose = np.zeros((4, 4))
        if np.count_nonzero(nocs_pc) == 0:  # blank frame: drop the tail
            break

        while nocs_pc.shape[0] < expected_num_pts:
            pad = expected_num_pts - nocs_pc.shape[0]
            nocs_pc = np.concatenate([nocs_pc, nocs_pc[:pad]], axis=0)
            depth_pc = np.concatenate([depth_pc, depth_pc[:pad]], axis=0)

        pose_seq[step_idx] = pose
        t_nocs = np.full((nocs_pc.shape[0], 1), step_size * step_idx)
        nocs_seq[step_idx] = np.concatenate([nocs_pc, t_nocs], axis=1)
        t_world = max_timestamp * t_nocs
        depth_seq[step_idx] = np.concatenate([depth_pc, t_world], axis=1)

    return nocs_seq, depth_seq, pose_seq


class DynamicPCLDataset:
    """The sequences of one split, subsampled per item by an explicit numpy
    generator.  ``native_loader`` reads the npz files through the C++
    loader (``data.native_loader``, identical arrays) where it builds;
    ``use_native_loader`` says whether it does."""

    def __init__(self, data_cfg: str, split: str = "train", train_frac: float = 0.8,
                 val_frac: float = 0.1, num_pts: int = 1024, seq_len: int = 5,
                 shift_time_to_zero: bool = False, random_point_sample: bool = True,
                 random_point_sample_per_step: bool = False, native_loader: bool = True):
        if split not in ("train", "val", "test"):
            raise ValueError(f"invalid split {split!r}")
        data_args = parse_dataset_cfg(data_cfg)
        self.data_paths = data_args.data
        self.split_paths = data_args.splits
        self.data_seq_len = data_args.expected_seq_len
        self.expected_num_pts = data_args.expected_num_pts
        self.max_timestamp = data_args.max_timestamp

        self.split = split
        self.num_pts = num_pts
        self.seq_len = seq_len
        self.shift_time_to_zero = shift_time_to_zero
        self.random_point_sample = random_point_sample
        self.random_point_sample_per_step = random_point_sample_per_step
        self.return_pose_data = False
        self.return_first_steps = False
        if native_loader:
            from .native_loader import native_available

            self.use_native_loader = native_available()
        else:
            self.use_native_loader = False

        self.seq_data_paths = load_time_data(self.data_paths, split, train_frac, val_frac,
                                             self.split_paths, data_seq_len=self.data_seq_len)

    def __len__(self):
        return len(self.seq_data_paths)

    def set_return_pose_data(self, flag: bool):
        self.return_pose_data = flag

    def set_return_first_steps(self, flag: bool):
        self.return_first_steps = flag

    def __getitem__(self, idx):
        return self.get_item(idx, np.random)

    def get_item(self, idx: int, rng):
        """Load and subsample one sequence: 'input' (T, N, 4) world cloud,
        'target' (T, N, 4) T-NOCS cloud, float32, optionally 'pose' (T, 4,
        4), and 'model_id', 'seq_id'."""
        frames = self.seq_data_paths[idx]
        model_id = frames[0].split("/")[-3]
        seq_id = frames[0].split("/")[-2]
        if self.use_native_loader:
            from .native_loader import load_seq_path_native as load
        else:
            load = load_seq_path
        nocs_seq, depth_seq, pose_seq = load(frames, max_timestamp=self.max_timestamp,
                                             expected_num_pts=self.expected_num_pts)

        if self.return_first_steps:
            steps = np.arange(self.seq_len)
        else:
            steps = np.sort(rng.choice(nocs_seq.shape[0], self.seq_len, replace=False))

        if self.random_point_sample:
            pts = rng.choice(nocs_seq.shape[1], self.num_pts, replace=False)
            input_data = depth_seq[steps][:, pts].copy()
            output_data = nocs_seq[steps][:, pts].copy()
        elif self.random_point_sample_per_step:
            per_step = np.stack([rng.choice(nocs_seq.shape[1], self.num_pts, replace=False)
                                 for _ in range(len(steps))])
            rows = np.repeat(np.arange(len(steps)), self.num_pts)
            cols = per_step.reshape(-1)
            input_data = depth_seq[steps][rows, cols].reshape(len(steps), self.num_pts, -1)
            output_data = nocs_seq[steps][rows, cols].reshape(len(steps), self.num_pts, -1)
        else:
            input_data = depth_seq[steps][:, : self.num_pts].copy()
            output_data = nocs_seq[steps][:, : self.num_pts].copy()

        if self.shift_time_to_zero:
            input_data[:, :, -1] -= np.min(input_data[:, :, -1])
            output_data[:, :, -1] -= np.min(output_data[:, :, -1])

        item = {
            "input": input_data.astype(np.float32),
            "target": output_data.astype(np.float32),
            "model_id": model_id,
            "seq_id": seq_id,
        }
        if self.return_pose_data:
            item["pose"] = pose_seq[steps].astype(np.float32)
        return item


class SequenceLoader:
    """Batches of a ``DynamicPCLDataset`` with thread-pool prefetch.

    Deterministic given ``seed``: the epoch order and every item's
    subsampling generator derive from ``SeedSequence([seed, epoch])``.
    Batches are dicts of stacked numpy arrays plus 'model_id' / 'seq_id'
    lists.  ``pad_last`` repeats items of a short last batch cyclically, so
    every batch has ``batch_size`` rows, and adds ``batch['valid']``, the
    number of real rows, which the consumers mask the padding with.
    ``num_shards`` / ``shard_index``: every process computes the same
    global order and takes its ``batch_size / num_shards`` rows of each
    global batch."""

    def __init__(self, dataset: DynamicPCLDataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 2,
                 pad_last: bool = False, num_shards: int = 1, shard_index: int = 0):
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last are mutually exclusive")
        if num_shards > 1 and batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by {num_shards} shards")
        if num_shards > 1 and not (drop_last or pad_last):
            raise ValueError("multi-shard loading needs full-size batches: set "
                             "drop_last or pad_last")
        if not 0 <= shard_index < max(num_shards, 1):
            raise ValueError(f"shard_index {shard_index} out of range")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.num_shards = max(num_shards, 1)
        self.shard_index = shard_index
        self.epoch = 0
        self.waits: List[float] = []

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        root = np.random.SeedSequence([self.seed, self.epoch])
        order_rng = np.random.default_rng(root.spawn(1)[0])
        order = np.arange(n)
        if self.shuffle:
            order_rng.shuffle(order)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]

        item_seeds = root.spawn(len(order))

        def fetch(pos):
            rng = np.random.default_rng(item_seeds[pos])
            return self.dataset.get_item(int(order[pos]), rng)

        batches = [list(range(i, min(i + self.batch_size, len(order))))
                   for i in range(0, len(order), self.batch_size)]
        valid_counts = [len(b) for b in batches]
        if self.pad_last:
            batches = [[b[i % len(b)] for i in range(self.batch_size)] for b in batches]
        if self.num_shards > 1:
            # the padding of pad_last sits at the global tail, so a shard's
            # real rows are the clipped remainder of the global count
            lbs = self.batch_size // self.num_shards
            local_valids = [min(max(v - self.shard_index * lbs, 0), lbs) for v in valid_counts]
            batches = [b[self.shard_index * lbs:(self.shard_index + 1) * lbs] for b in batches]
        self.waits = []
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = [[pool.submit(fetch, p) for p in b] for b in batches[:2]]
            for bi in range(len(batches)):
                asked = time.perf_counter()
                if bi + 2 < len(batches):
                    futures.append([pool.submit(fetch, p) for p in batches[bi + 2]])
                items = [f.result() for f in futures[bi]]
                batch = {
                    "input": np.stack([it["input"] for it in items]),
                    "target": np.stack([it["target"] for it in items]),
                    "model_id": [it["model_id"] for it in items],
                    "seq_id": [it["seq_id"] for it in items],
                }
                if self.pad_last:
                    if self.num_shards > 1:
                        batch["valid"] = local_valids[bi]
                        batch["valid_global"] = valid_counts[bi]
                    else:
                        batch["valid"] = valid_counts[bi]
                if "pose" in items[0]:
                    batch["pose"] = np.stack([it["pose"] for it in items])
                self.waits.append(time.perf_counter() - asked)
                yield batch
