"""TokenDataset: the training input pipeline over the native loader (port
of ray_tpu/train/dataloader.py).

A C++ mmap gather loop (``ray_tpu_torch/native/dataloader.cpp``, built
with g++ at first use) assembles [batch, seq+1] token batches on the host
while the previous step runs on the device (background prefetch).
``shard(rank, world)`` stripes the shuffled window permutation across
data-parallel ranks. For the same file, seed and shard the batches are
the JAX package's, in the same order.

Batches stay host numpy ``uint32``, as in the reference. Moving one to
the device is the training loop's job (``chip_smoke.py`` phase 7, the
tests): the port's step indexes the embedding with the tokens and gathers
the targets with ``.long()``, so it takes int32 or int64 ids. Ids are below
2^31, so a loop views the array as int32 (no copy; torch's uint32 has few
operations), pins it and copies it non-blocking.
"""

from __future__ import annotations

from ray_tpu_torch._native.dataloader import NativeTokenLoader


class TokenDataset:
    """Iterate fixed-length token windows from a flat binary corpus.

    ``path`` holds little-endian uint16 or uint32 token ids back to back
    (the standard .bin dump). Each sample is ``seq_len + 1`` tokens (inputs
    and shifted targets come from the same window).
    """

    def __init__(
        self,
        path: str,
        seq_len: int,
        *,
        dtype: str = "u32",
        seed: int = 0,
        shuffle: bool = True,
    ):
        dtype_bytes = {"u16": 2, "u32": 4}[dtype]
        self._loader = NativeTokenLoader(
            path, seq_len + 1, dtype_bytes=dtype_bytes
        )
        self.path = path
        self.dtype = dtype
        self.seq_len = seq_len
        self.seed = seed
        self.shuffle = shuffle
        self._rank, self._world = 0, 1
        self._epoch = 0

    def descriptor(self) -> dict:
        """Picklable spec: a worker re-opens its own mmap (a loader holds
        a file descriptor and a thread, which must not cross processes)."""
        return {
            "__token_dataset__": {
                "path": self.path,
                "seq_len": self.seq_len,
                "dtype": self.dtype,
                "seed": self.seed,
                "shuffle": self.shuffle,
            }
        }

    @classmethod
    def from_descriptor(
        cls, desc: dict, rank: int = 0, world: int = 1
    ) -> "TokenDataset":
        spec = desc["__token_dataset__"]
        ds = cls(
            spec["path"],
            spec["seq_len"],
            dtype=spec["dtype"],
            seed=spec["seed"],
            shuffle=spec["shuffle"],
        )
        if world > 1:
            ds.shard(rank, world)
        return ds

    @property
    def num_samples(self) -> int:
        return self._loader.num_windows // self._world

    def shard(self, rank: int, world: int) -> "TokenDataset":
        """Restrict this dataset to data-parallel shard ``rank`` of
        ``world``."""
        self._rank, self._world = rank, world
        self._loader.set_shard(rank, world)
        return self

    def iter_batches(self, batch_size: int, *, epochs: int = 1):
        """Yield {"tokens": [B, seq+1] uint32} with background prefetch;
        the tail partial batch of each epoch is dropped (one shape for
        every step)."""
        # Every rank yields exactly this many batches per epoch (ranks can
        # differ by one window; an uneven count would leave one rank
        # waiting in a collective at the epoch boundary).
        batches_per_epoch = self.num_samples // batch_size
        for _ in range(epochs):
            if self.shuffle:
                # The same seed on every shard: one global permutation,
                # disjoint stripes per rank.
                self._loader.shuffle(self.seed + self._epoch)
            self._loader.prefetch_start(batch_size)
            try:
                for _i in range(batches_per_epoch):
                    batch = self._loader.next()
                    if len(batch) < batch_size:
                        break  # the loader ran out early
                    yield {"tokens": batch}
            finally:
                self._loader.prefetch_stop()
            self._epoch += 1

    def take_batch(self, batch_size: int, start: int = 0) -> dict:
        """Synchronous gather (no prefetch thread), e.g. for evaluation."""
        return {"tokens": self._loader.fill(start, batch_size)}

    def close(self) -> None:
        self._loader.close()

