"""The port's TokenDataset (ray_tpu_torch/train/dataloader.py, over its own
copy of the C++ loader) on the reference's cases (tests/test_dataloader.py,
minus the trainer integration, which needs the runtime), and against the
reference's TokenDataset: the same file, seed, shard and epochs give the
same batches in the same order, exactly."""

import pickle

import numpy as np
import pytest

from ray_tpu.train.dataloader import TokenDataset as JaxTokenDataset
from ray_tpu_torch._native import library_path
from ray_tpu_torch.train.dataloader import TokenDataset


@pytest.fixture()
def corpus(tmp_path):
    """1000 windows of seq 16 (u32 tokens = their flat index)."""
    tokens = np.arange(1000 * 17, dtype=np.uint32)
    path = tmp_path / "corpus.bin"
    tokens.tofile(path)
    return str(path), tokens


def test_windows_and_content(corpus):
    path, tokens = corpus
    ds = TokenDataset(path, seq_len=16, shuffle=False)
    try:
        assert ds.num_samples == 1000
        batch = ds.take_batch(4)["tokens"]
        assert batch.shape == (4, 17) and batch.dtype == np.uint32
        np.testing.assert_array_equal(batch[0], tokens[:17])
        np.testing.assert_array_equal(batch[1], tokens[17:34])
    finally:
        ds.close()


def test_shuffle_is_seeded_permutation(corpus):
    path, tokens = corpus
    a = TokenDataset(path, seq_len=16, seed=7)
    b = TokenDataset(path, seq_len=16, seed=7)
    c = TokenDataset(path, seq_len=16, seed=8)
    try:
        ba = next(a.iter_batches(8))["tokens"]
        bb = next(b.iter_batches(8))["tokens"]
        bc = next(c.iter_batches(8))["tokens"]
        np.testing.assert_array_equal(ba, bb)  # deterministic
        assert not np.array_equal(ba, bc)  # seed changes order
        # Every row is a contiguous window starting on a window boundary.
        starts = ba[:, 0]
        assert all(s % 17 == 0 for s in starts.tolist())
        np.testing.assert_array_equal(
            ba, np.stack([tokens[s: s + 17] for s in starts])
        )
    finally:
        a.close()
        b.close()
        c.close()


def test_prefetch_iterates_whole_epoch(corpus):
    path, _ = corpus
    ds = TokenDataset(path, seq_len=16, seed=1)
    try:
        seen = 0
        first_rows = set()
        for batch in ds.iter_batches(64):
            assert batch["tokens"].shape == (64, 17)
            seen += 64
            first_rows.update(batch["tokens"][:, 0].tolist())
        assert seen == 1000 - 1000 % 64  # ragged tail dropped
        assert len(first_rows) == seen  # no duplicate windows
    finally:
        ds.close()


def test_sharding_partitions_windows(corpus):
    path, _ = corpus
    shards = [
        TokenDataset(path, seq_len=16, seed=3).shard(r, 4) for r in range(4)
    ]
    try:
        rows = [set() for _ in range(4)]
        for r, ds in enumerate(shards):
            for batch in ds.iter_batches(25):
                rows[r].update(batch["tokens"][:, 0].tolist())
        # Disjoint coverage across ranks.
        for i in range(4):
            for j in range(i + 1, 4):
                assert not (rows[i] & rows[j])
        assert sum(len(r) for r in rows) == 1000
    finally:
        for ds in shards:
            ds.close()


def test_multi_epoch_reshuffles(corpus):
    path, _ = corpus
    ds = TokenDataset(path, seq_len=16, seed=5)
    try:
        order = []
        for batch in ds.iter_batches(1000, epochs=2):
            order.append(batch["tokens"][:, 0].copy())
        assert len(order) == 2
        assert not np.array_equal(order[0], order[1])  # re-shuffled
        assert set(order[0].tolist()) == set(order[1].tolist())
    finally:
        ds.close()


def test_descriptor_reopens_a_shard(corpus):
    """descriptor() survives pickling; from_descriptor opens its own
    loader on the given shard, with every setting kept."""
    path, _ = corpus
    ds = TokenDataset(path, seq_len=16, dtype="u32", seed=9, shuffle=True)
    desc = pickle.loads(pickle.dumps(ds.descriptor()))
    again = TokenDataset.from_descriptor(desc, rank=1, world=3)
    direct = TokenDataset(path, seq_len=16, seed=9).shard(1, 3)
    try:
        assert again.num_samples == direct.num_samples == 1000 // 3
        for a, b in zip(again.iter_batches(10), direct.iter_batches(10)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    finally:
        for d in (ds, again, direct):
            d.close()


@pytest.mark.parametrize("dtype,rank,world,batch,epochs,shuffle", [
    ("u32", 0, 1, 64, 2, True),
    ("u32", 2, 3, 25, 2, True),
    ("u16", 1, 4, 16, 3, True),
    ("u16", 0, 1, 100, 1, False),
])
def test_batches_match_reference(tmp_path, dtype, rank, world, batch,
                                 epochs, shuffle):
    """Random tokens from a seed, 1000 windows of 17 plus a ragged tail of
    5 tokens: the port and the reference yield the same batches, in the
    same order, over every epoch, and take_batch agrees."""
    np_dtype = {"u32": np.uint32, "u16": np.uint16}[dtype]
    tokens = np.random.default_rng(11).integers(
        0, np.iinfo(np_dtype).max, size=1000 * 17 + 5, dtype=np_dtype
    )
    path = str(tmp_path / "tokens.bin")
    tokens.tofile(path)
    kw = dict(dtype=dtype, seed=4, shuffle=shuffle)
    ours = TokenDataset(path, seq_len=16, **kw).shard(rank, world)
    ref = JaxTokenDataset(path, seq_len=16, **kw).shard(rank, world)
    try:
        assert ours.num_samples == ref.num_samples
        got = [b["tokens"] for b in ours.iter_batches(batch, epochs=epochs)]
        want = [b["tokens"] for b in ref.iter_batches(batch, epochs=epochs)]
        assert len(got) == len(want) == epochs * (ref.num_samples // batch)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(ours.take_batch(7, start=3)["tokens"],
                                      ref.take_batch(7, start=3)["tokens"])
    finally:
        ours.close()
        ref.close()


def test_loader_builds_from_the_port_sources(corpus):
    """The library is the port's own build, under build/ray_tpu_torch/,
    named by a hash of its source and flags."""
    path, _ = corpus
    ds = TokenDataset(path, seq_len=16)
    ds.close()
    lib = library_path("dataloader", ("dataloader.cpp",))
    assert lib.is_file() and lib.parent.name == "ray_tpu_torch"


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError, match="dl_open"):
        TokenDataset(str(tmp_path / "absent.bin"), seq_len=16)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises NativeBuildError; nothing falls back."""
    from ray_tpu_torch import _native

    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_native.NativeBuildError, match="g\\+\\+ failed"):
        _native.build_library("broken", ("broken.cpp",))
    assert not list((tmp_path / "build").glob("*.so"))
