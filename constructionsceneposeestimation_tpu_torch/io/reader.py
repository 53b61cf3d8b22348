"""Sharded dataset reader for external trainers (the consumer side of
io/packed.py shards).

The reference has no reader at all — its dataset is a tree of text/PNG files
consumed ad hoc. This gives the packed npz shards a tfrecord-style contract:

* deterministic shuffling (shard order + in-shard row order, seeded per epoch),
* fixed-size batches that cross shard boundaries (remainders carry over),
* background shard prefetch on a thread (numpy I/O overlaps consumer compute),
* field selection so a heatmap trainer doesn't pay to decode depth/instance.

Pure numpy/host code by design: feeding a train step is just
``torch.from_numpy(batch[...]).to(device)`` (``train/loop.make_data_train_step``).
A copy of the JAX package's ``io/reader.py``.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import packed


class ShardDataset:
    """Random-access + streaming view over a packed shard directory."""

    def __init__(self, root: str):
        self.root = root
        self.paths = packed.shard_paths(root)
        if not self.paths:
            raise FileNotFoundError(f"no shard_*.npz under {root}")
        mpath = os.path.join(root, "dataset_manifest.json")
        self.manifest = None
        if os.path.exists(mpath):
            with open(mpath) as f:
                self.manifest = json.load(f)
        # Per-shard frame counts from the (tiny) frame_id vector.
        self._counts: List[int] = []
        for p in self.paths:
            with np.load(p) as z:
                self._counts.append(int(z["frame_id"].shape[0]))

    def __len__(self) -> int:
        return sum(self._counts)

    @property
    def fields(self) -> List[str]:
        with np.load(self.paths[0]) as z:
            return list(z.files)

    def load_shard(self, i: int,
                   fields: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        with np.load(self.paths[i]) as z:
            keys = fields if fields is not None else z.files
            return {k: z[k] for k in keys}

    def field_shape(self, field: str, shard: int = 0) -> tuple:
        """Array shape of ``field`` WITHOUT decompressing its data: reads
        only the npy header of the zip member (a 512^2 rgb field would
        otherwise cost hundreds of MB of decompression just for a check)."""
        import zipfile
        with zipfile.ZipFile(self.paths[shard]) as zf:
            with zf.open(field + ".npy") as f:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, _, _ = np.lib.format.read_array_header_1_0(f)
                else:
                    shape, _, _ = np.lib.format.read_array_header_2_0(f)
        return tuple(shape)

    def batches(
        self,
        batch_size: int,
        fields: Optional[Sequence[str]] = None,
        shuffle: bool = True,
        seed: int = 0,
        epochs: int = 1,
        drop_remainder: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield dict batches of stacked rows. Shard order and in-shard row
        order reshuffle deterministically each epoch; one shard of read-ahead
        runs on a background thread."""
        with ThreadPoolExecutor(max_workers=1) as pool:
            for epoch in range(epochs):
                rng = np.random.default_rng((seed, epoch))
                order = (rng.permutation(len(self.paths)) if shuffle
                         else np.arange(len(self.paths)))
                carry: Optional[Dict[str, np.ndarray]] = None
                fut = pool.submit(self.load_shard, int(order[0]), fields)
                for j in range(len(order)):
                    shard = fut.result()
                    if j + 1 < len(order):
                        fut = pool.submit(self.load_shard, int(order[j + 1]), fields)
                    n = next(iter(shard.values())).shape[0]
                    rows = rng.permutation(n) if shuffle else np.arange(n)
                    shard = {k: v[rows] for k, v in shard.items()}
                    if carry is not None:
                        shard = {k: np.concatenate([carry[k], shard[k]])
                                 for k in shard}
                        carry = None
                    n = next(iter(shard.values())).shape[0]
                    stop = (n // batch_size) * batch_size
                    for lo in range(0, stop, batch_size):
                        yield {k: v[lo:lo + batch_size] for k, v in shard.items()}
                    if stop < n:
                        carry = {k: v[stop:] for k, v in shard.items()}
                if carry is not None and not drop_remainder:
                    yield carry
