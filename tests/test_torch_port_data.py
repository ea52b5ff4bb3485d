"""The port's dataset loader (caspr_tpu_torch/data) against the JAX
package's (caspr_tpu/data) on synthetic trees under tmp_path: every array of
every batch identical (assert_array_equal), every id list equal.

The trees come from ``caspr_tpu_torch.data.write_synthetic_tree`` (a seed,
the demo format): split files, a model of short frames (repeat-padded), a
sequence one frame short (filtered out) and a ``BAD_MODELS`` model
(skipped); one test adds a blank frame (the tail truncated).  The JAX
loader runs its numpy path (``CASPR_TPU_NATIVE_LOADER=0``), so that it
builds nothing; the port's native loader is held to the port's numpy path.
"""

import os
import shutil

import numpy as np
import pytest

from caspr_tpu import data as jdata
from caspr_tpu_torch import data
from caspr_tpu_torch.data import native_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"train": 5, "val": 3, "test": 4}
NUM_PTS = 96

# (dataset options, pose data, first steps, loader options)
CASES = {
    "random_steps_and_points": (dict(split="train", seq_len=5, num_pts=32), False, False,
                                dict(batch_size=2, shuffle=True, drop_last=True)),
    "shift_time_to_zero": (dict(split="train", seq_len=5, num_pts=32, shift_time_to_zero=True),
                           False, False, dict(batch_size=3, shuffle=True)),
    "first_points": (dict(split="val", seq_len=10, num_pts=40, random_point_sample=False),
                     False, False, dict(batch_size=2)),
    "points_per_step": (dict(split="test", seq_len=4, num_pts=16, random_point_sample=False,
                             random_point_sample_per_step=True), False, False,
                        dict(batch_size=3, shuffle=True, pad_last=True)),
    "test_protocol_pose": (dict(split="test", seq_len=10, num_pts=NUM_PTS,
                                random_point_sample=False, shift_time_to_zero=True), True, False,
                           dict(batch_size=3, pad_last=True)),
    "first_steps": (dict(split="train", seq_len=3, num_pts=24), False, True,
                    dict(batch_size=2, shuffle=True, pad_last=True)),
    "shards": (dict(split="train", seq_len=5, num_pts=32), True, False,
               dict(batch_size=4, shuffle=True, pad_last=True, num_shards=2, shard_index=1)),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return data.write_synthetic_tree(str(tmp_path_factory.mktemp("tree")), seed=5,
                                     num_pts=NUM_PTS, split_sizes=SIZES)


@pytest.fixture(autouse=True)
def _jax_numpy_loader(monkeypatch):
    monkeypatch.setenv("CASPR_TPU_NATIVE_LOADER", "0")


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def _both(cfg, ds_kwargs, pose, first, native=True):
    port = data.DynamicPCLDataset(cfg, native_loader=native, **ds_kwargs)
    ref = jdata.DynamicPCLDataset(cfg, **ds_kwargs)
    for ds in (port, ref):
        ds.set_return_pose_data(pose)
        ds.set_return_first_steps(first)
    return port, ref


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax(tree, case, seed):
    ds_kwargs, pose, first, loader_kwargs = CASES[case]
    port, ref = _both(tree, ds_kwargs, pose, first)
    assert port.seq_data_paths == ref.seq_data_paths
    loader = data.SequenceLoader(port, seed=seed, **loader_kwargs)
    jloader = jdata.SequenceLoader(ref, seed=seed, **loader_kwargs)
    assert len(loader) == len(jloader)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        _assert_batches_equal(loader, jloader)
        assert len(loader.waits) == len(jloader)


def test_split_membership_and_skips(tree):
    """The split files' models less the BAD_MODELS one; the short sequence
    is filtered out; the short frames are padded to the expected count."""
    for split, count in SIZES.items():
        ds = data.DynamicPCLDataset(tree, split=split, native_loader=False)
        assert len(ds) == count
        assert ds.seq_data_paths == jdata.DynamicPCLDataset(tree, split=split).seq_data_paths
        assert all(data.BAD_MODELS[0] not in f[0] for f in ds.seq_data_paths)
        assert all(len(f) == 10 for f in ds.seq_data_paths)
    short = data.DynamicPCLDataset(tree, split="test", native_loader=False).seq_data_paths[-1]
    raw = np.load(short[0])["nocs_data"]
    assert raw.shape[0] < NUM_PTS
    nocs, depth, _ = data.load_seq_path(short, 5.0, NUM_PTS)
    np.testing.assert_array_equal(nocs[0, raw.shape[0]:, :3], raw[: NUM_PTS - raw.shape[0]])
    np.testing.assert_allclose(nocs[:, 0, 3], np.linspace(0, 1, 10), atol=1e-12)
    np.testing.assert_allclose(depth[:, 0, 3], np.linspace(0, 5, 10), atol=1e-12)


def test_fraction_splits_match_jax(tree, tmp_path):
    """A cfg without --splits: every model directory, cut by the train and
    val fractions."""
    args = data.parse_dataset_cfg(tree)
    cfg = os.path.join(tmp_path, "fractions.cfg")
    with open(cfg, "w") as f:
        f.write(f"--data {args.data[0]}\n--expected-num-pts {NUM_PTS}\n")
    for split in ("train", "val", "test"):
        for fracs in ((0.8, 0.1), (0.5, 0.25)):
            port = data.DynamicPCLDataset(cfg, split=split, train_frac=fracs[0],
                                          val_frac=fracs[1], num_pts=8, native_loader=False)
            ref = jdata.DynamicPCLDataset(cfg, split=split, train_frac=fracs[0],
                                          val_frac=fracs[1], num_pts=8)
            assert port.seq_data_paths == ref.seq_data_paths
            if len(port):
                _assert_batches_equal(data.SequenceLoader(port, 4, seed=2),
                                      jdata.SequenceLoader(ref, 4, seed=2))
    with pytest.raises(ValueError):
        data.DynamicPCLDataset(cfg, train_frac=0.8, val_frac=0.3)


def test_blank_frame_truncates(tree, tmp_path):
    """A blank frame ends the sequence's fill: it and the frames after it
    stay zero, on both loaders and both of the port's paths."""
    root = os.path.join(tmp_path, "blank")
    shutil.copytree(os.path.dirname(tree), root)
    cfg = os.path.join(root, "blank.cfg")
    args = data.parse_dataset_cfg(tree)
    with open(cfg, "w") as f:
        f.write(f"--data {os.path.join(root, 'data')}\n--splits {os.path.join(root, 'splits')}\n"
                f"--expected-num-pts {NUM_PTS}\n")
    seq = data.DynamicPCLDataset(cfg, split="val", native_loader=False).seq_data_paths[0]
    frame = np.load(seq[6])
    np.savez(seq[6], nocs_data=np.zeros_like(frame["nocs_data"]),
             depth_data=frame["depth_data"], obj_T=frame["obj_T"])
    nocs, depth, pose = data.load_seq_path(seq, args.max_timestamp, NUM_PTS)
    assert np.count_nonzero(nocs[6:]) == np.count_nonzero(depth[6:]) == 0
    assert np.count_nonzero(pose[6:]) == 0 and np.count_nonzero(nocs[5]) > 0
    for native in (False, True):
        port, ref = _both(cfg, dict(split="val", seq_len=10, num_pts=NUM_PTS,
                                    random_point_sample=False), True, False, native=native)
        _assert_batches_equal(data.SequenceLoader(port, 2, seed=1, pad_last=True),
                              jdata.SequenceLoader(ref, 2, seed=1, pad_last=True))


def test_native_loader_matches_numpy(tree, tmp_path):
    """The C++ loader (built from native/npz_loader.cpp into the port's
    build directory) gives the numpy path's arrays bit for bit, on stored
    and on deflated archives, short frames included."""
    if not native_loader.native_available():
        pytest.skip("no g++ or zlib: the native loader does not build here")
    lib = native_loader._load_native()
    assert os.path.dirname(lib._name) == os.path.join(REPO, "caspr_tpu_torch", "_build")
    seqs = []
    for split in SIZES:
        seqs += data.DynamicPCLDataset(tree, split=split, native_loader=False).seq_data_paths
    deflated = os.path.join(tmp_path, "deflated")
    os.makedirs(deflated)
    frames = []
    for i, path in enumerate(seqs[-1]):
        arrays = dict(np.load(path))
        frames.append(os.path.join(deflated, f"seq_frame_{i:03d}.npz"))
        np.savez_compressed(frames[-1], **{k: v.astype(np.float64) for k, v in arrays.items()})
    for seq in seqs + [frames]:
        want = data.load_seq_path(seq, 5.0, NUM_PTS)
        got = native_loader.load_seq_path_native(seq, 5.0, NUM_PTS)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert data.DynamicPCLDataset(tree, split="train").use_native_loader
    assert not data.DynamicPCLDataset(tree, split="train", native_loader=False).use_native_loader


def test_shipped_cfgs_parse_as_jax():
    cfg_dir = os.path.join(REPO, "data", "configs")
    names = sorted(n for n in os.listdir(cfg_dir) if n.endswith(".cfg"))
    assert len(names) >= 5
    for name in names:
        path = os.path.join(cfg_dir, name)
        assert vars(data.parse_dataset_cfg(path)) == vars(jdata.parse_dataset_cfg(path)), name


def test_loader_refuses_what_jax_refuses(tree):
    ds = data.DynamicPCLDataset(tree, split="train", native_loader=False)
    for kwargs in (dict(batch_size=2, drop_last=True, pad_last=True),
                   dict(batch_size=3, drop_last=True, num_shards=2),
                   dict(batch_size=2, num_shards=2),
                   dict(batch_size=2, drop_last=True, num_shards=2, shard_index=2)):
        with pytest.raises(ValueError):
            data.SequenceLoader(ds, **kwargs)
        with pytest.raises(ValueError):
            jdata.SequenceLoader(ds, **kwargs)
    with pytest.raises(ValueError):
        data.DynamicPCLDataset(tree, split="holdout")
