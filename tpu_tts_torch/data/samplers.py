"""Samplers: a copy of `tpu_tts/data/samplers.py`, the torch-free mirror of
Coqui TTS `TTS/utils/samplers.py` (`PerfectBatchSampler`, `SortedSampler`,
`BucketBatchSampler`)."""

import random
from typing import List, Optional


class SubsetSampler:
    """Sample elements from a fixed index subset, in order."""

    def __init__(self, indices: List[int]):
        self.indices = indices

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class PerfectBatchSampler:
    """Each batch contains exactly `num_classes_in_batch` classes ×
    (batch_size / num_classes) utterances per class — the speaker-encoder
    GE2E batch shape."""

    def __init__(
        self,
        dataset_items: List,
        classes: List,
        batch_size: int,
        num_classes_in_batch: int,
        num_gpus: int = 1,
        shuffle: bool = True,
        drop_last: bool = False,
        label_key: str = "class_name",
    ):
        assert batch_size % (num_classes_in_batch * num_gpus) == 0, (
            "Batch size must be divisible by number of classes times the number of data parallel devices (if enabled)."
        )
        label_indices = {}
        for idx, item in enumerate(dataset_items):
            label = item[label_key]
            label_indices.setdefault(label, []).append(idx)
        if shuffle:
            self._samplers = [_RandomCycleSampler(label_indices[key]) for key in classes]
        else:
            self._samplers = [SubsetSampler(label_indices[key]) for key in classes]
        self._batch_size = batch_size
        self._drop_last = drop_last
        self._dp_devices = num_gpus
        self._num_classes_in_batch = num_classes_in_batch

    def __iter__(self):
        batch = []
        if self._num_classes_in_batch != len(self._samplers):
            valid_samplers_idx = random.sample(range(len(self._samplers)), self._num_classes_in_batch)
        else:
            valid_samplers_idx = None
        iters = [iter(s) for s in self._samplers]
        done = False
        while True:
            b = []
            for i, it in enumerate(iters):
                if valid_samplers_idx is not None and i not in valid_samplers_idx:
                    continue
                entry = next(it, None)
                if entry is None:
                    done = True
                    break
                b.append(entry)
            if done:
                break
            batch += b
            if len(batch) == self._batch_size:
                yield batch
                batch = []
                if valid_samplers_idx is not None:
                    valid_samplers_idx = random.sample(range(len(self._samplers)), self._num_classes_in_batch)
        if not self._drop_last and batch:
            groups = len(batch) // self._num_classes_in_batch
            if groups % self._dp_devices == 0:
                yield batch
            else:
                batch = batch[: (groups // self._dp_devices) * self._dp_devices * self._num_classes_in_batch]
                if batch:
                    yield batch

    def __len__(self):
        class_batch_size = self._batch_size // self._num_classes_in_batch
        return min(((len(s) + class_batch_size - 1) // class_batch_size) for s in self._samplers)


class _RandomCycleSampler:
    def __init__(self, indices: List[int]):
        self.indices = indices

    def __iter__(self):
        idxs = self.indices[:]
        random.shuffle(idxs)
        return iter(idxs)

    def __len__(self):
        return len(self.indices)


def identity(x):
    return x


class SortedSampler:
    """Iterate indices sorted by a key, descending."""

    def __init__(self, data, sort_key=identity):
        self.data = data
        self.sort_key = sort_key
        zip_ = [(i, self.sort_key(row)) for i, row in enumerate(self.data)]
        zip_ = sorted(zip_, key=lambda r: r[1])
        self.sorted_indexes = [item[0] for item in zip_]

    def __iter__(self):
        return iter(self.sorted_indexes)

    def __len__(self):
        return len(self.data)


class BucketBatchSampler:
    """Shuffle → partition into `bucket_size_multiplier × batch` buckets →
    sort inside each bucket → emit batches (minimizes pad waste)."""

    def __init__(
        self,
        sampler,
        data,
        batch_size: int,
        drop_last: bool = False,
        sort_key=identity,
        bucket_size_multiplier: int = 100,
    ):
        self.sampler = list(sampler)
        self.data = data
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.sort_key = sort_key
        self.bucket_size = min(batch_size * bucket_size_multiplier, len(self.sampler))

    def _chunks(self, lst, n):
        for i in range(0, len(lst), n):
            yield lst[i : i + n]

    def __iter__(self):
        order = self.sampler[:]
        random.shuffle(order)
        for bucket in self._chunks(order, self.bucket_size):
            sorted_sampler = SortedSampler([self.data[i] for i in bucket], self.sort_key)
            batches = list(self._chunks([bucket[i] for i in sorted_sampler], self.batch_size))
            random.shuffle(batches)
            for batch in batches:
                if self.drop_last and len(batch) < self.batch_size:
                    continue
                yield batch

    def __len__(self):
        if self.drop_last:
            return len(self.sampler) // self.batch_size
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size
