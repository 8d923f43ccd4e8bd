"""Megatron-style pretraining batch samplers, sharded over data
parallelism.

The port's own copy of ``apex_tpu/transformer/data.py`` (numpy only):
deterministic and shuffled samplers that yield each data-parallel rank
its slice of the global batch.  Host-side Python (these drive the input
pipeline, not the device program); works with any indexable dataset.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

__all__ = [
    "MegatronPretrainingSampler",
    "MegatronPretrainingRandomSampler",
]


class MegatronPretrainingSampler:
    """Sequential sampler."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        if total_samples <= 0:
            raise RuntimeError(
                f"no sample to consume: {total_samples}"
            )
        if consumed_samples >= total_samples:
            raise RuntimeError(
                f"no samples left to consume: {consumed_samples} >= "
                f"{total_samples}"
            )
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank should be smaller than data-parallel "
                f"size: {data_parallel_rank} >= {data_parallel_size}"
            )
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        self.drop_last = drop_last

    def __len__(self) -> int:
        return self.total_samples

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.micro_batch_size
        return start, start + self.micro_batch_size

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_data_parallel_size:
                s, e = self.get_start_end_idx()
                yield batch[s:e]
                batch = []
        if batch and not self.drop_last:
            s, e = self.get_start_end_idx()
            yield batch[s:e]


class MegatronPretrainingRandomSampler:
    """Shuffled sampler with an epoch-deterministic permutation."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
    ):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        self.last_batch_size = (
            self.total_samples % self.micro_batch_times_data_parallel_size
        )

    def __len__(self) -> int:
        return self.total_samples

    def __iter__(self) -> Iterator[List[int]]:
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples
        assert (
            current_epoch_samples % self.micro_batch_times_data_parallel_size
            == 0
        )

        # dp-rank-sharded bucket walk over a per-epoch permutation
        bucket_size = (
            self.total_samples // self.micro_batch_times_data_parallel_size
        ) * self.micro_batch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        g = np.random.default_rng(self.epoch)
        random_idx = g.permutation(bucket_size) + start_idx
        idx_range = [int(i) for i in random_idx[bucket_offset:]]

        batch: List[int] = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.micro_batch_size:
                self.consumed_samples += (
                    self.micro_batch_times_data_parallel_size
                )
                yield batch
                batch = []
