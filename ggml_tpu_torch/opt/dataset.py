"""Dataset: host-resident data and labels with shard-wise shuffle (a copy
of ggml_tpu/opt/dataset.py; reference: ggml_opt_dataset_*,
include/ggml-opt.h:39-58, src/ggml-opt.cpp:16-90).

Numpy only: the same Generator gives the same permutation as in the JAX
package.  get_batch returns numpy; the optimizer moves a batch to the device.
"""

from __future__ import annotations

import numpy as np


class Dataset:
    def __init__(self, data: np.ndarray, labels: np.ndarray | None, ndata_shard: int = 1):
        if labels is not None and len(data) != len(labels):
            raise ValueError(f"{len(data)} data points but {len(labels)} labels")
        if len(data) % ndata_shard:
            raise ValueError(f"{len(data)} data points are not whole shards of {ndata_shard}")
        self.data = np.asarray(data)
        self.labels = None if labels is None else np.asarray(labels)
        self.ndata_shard = ndata_shard
        self.perm = np.arange(len(data) // ndata_shard)  # permutation over shards

    @property
    def ndata(self) -> int:
        return len(self.data)

    def shuffle(self, rng: np.random.Generator, idata: int | None = None) -> None:
        """Fisher-Yates over shards; idata limits shuffling to the first idata
        data points (the train split), as ggml_opt_dataset_shuffle does."""
        if idata is None:
            n = len(self.perm)
        else:
            if idata % self.ndata_shard:
                raise ValueError(f"idata {idata} is not whole shards of {self.ndata_shard}")
            n = idata // self.ndata_shard
        sub = self.perm[:n]
        rng.shuffle(sub)
        self.perm[:n] = sub

    def get_batch(self, ibatch: int, batch_size: int):
        """Batch ibatch under the current permutation: (x, y) numpy."""
        if batch_size % self.ndata_shard:
            raise ValueError(f"batch {batch_size} is not whole shards of {self.ndata_shard}")
        spb = batch_size // self.ndata_shard
        shards = self.perm[ibatch * spb : (ibatch + 1) * spb]
        idx = (shards[:, None] * self.ndata_shard + np.arange(self.ndata_shard)).reshape(-1)
        x = self.data[idx]
        y = None if self.labels is None else self.labels[idx]
        return x, y
