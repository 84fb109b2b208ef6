"""Dataset loading entry points.

Counterpart of `tpu_tts/data/__init__.py` (`split_dataset`:13,
`load_tts_samples`:61, `prefetch_batches`), which mirrors Coqui TTS
`TTS/tts/datasets/__init__.py`. The per-process batch slicing of the JAX
package's multi-host loader (`shard_batch_indices`) comes with the
data-parallel trainer (ROADMAP.md, M10).
"""

import os
from typing import Callable, Dict, List, Tuple, Union

import numpy as np

from tpu_tts_torch.data import formatters as _formatters


def split_dataset(items: List, eval_split_max_size=None, eval_split_size=0.01) -> Tuple[List, List]:
    """Speaker-aware eval/train split (ref datasets/__init__.py:13)."""
    speakers = [item["speaker_name"] for item in items]
    is_multi_speaker = len(set(speakers)) > 1
    if eval_split_size > 1:
        eval_split_size = int(eval_split_size)
    else:
        if eval_split_max_size:
            eval_split_size = min(eval_split_max_size, int(len(items) * eval_split_size))
        else:
            eval_split_size = int(len(items) * eval_split_size)
    if eval_split_size <= 0:
        raise ValueError(
            " [!] You do not have enough samples for the evaluation set. You can work around this setting the"
            " 'eval_split_size' parameter to a minimum of {}".format(1 / len(items))
        )
    rng = np.random.RandomState(0)
    perm = rng.permutation(len(items)).tolist()
    items = [items[i] for i in perm]
    if is_multi_speaker:
        items_eval: List = []
        speakers = [item["speaker_name"] for item in items]
        speaker_counter = {s: speakers.count(s) for s in set(speakers)}
        while len(items_eval) < eval_split_size:
            item_idx = rng.randint(0, len(items))
            speaker_to_be_removed = items[item_idx]["speaker_name"]
            if speaker_counter[speaker_to_be_removed] > 1:
                items_eval.append(items[item_idx])
                speaker_counter[speaker_to_be_removed] -= 1
                del items[item_idx]
        return items_eval, items
    return items[:eval_split_size], items[eval_split_size:]


def get_audio_size(audiopath: str) -> int:
    """Return number of samples in a wav file without decoding it fully."""
    import scipy.io.wavfile

    sr, data = scipy.io.wavfile.read(audiopath, mmap=True)
    return data.shape[0]


def add_extra_keys(metadata: List[Dict], language: str, dataset_name: str) -> List[Dict]:
    for item in metadata:
        item["language"] = language
        item["audio_unique_name"] = f"{dataset_name}#{os.path.splitext(os.path.relpath(item['audio_file'], item['root_path']))[0]}"
    return metadata


def load_tts_samples(
    datasets: Union[List, Dict],
    eval_split: bool = True,
    formatter: Callable = None,
    eval_split_max_size=None,
    eval_split_size: float = 0.01,
) -> Tuple[List[Dict], List[Dict]]:
    """Merge configured datasets into (train, eval) sample lists."""
    meta_data_train_all: List = []
    meta_data_eval_all: List = [] if eval_split else None
    if not isinstance(datasets, list):
        datasets = [datasets]
    for dataset in datasets:
        formatter_name = dataset["formatter"]
        dataset_name = dataset["dataset_name"]
        root_path = dataset["path"]
        meta_file_train = dataset["meta_file_train"]
        meta_file_val = dataset["meta_file_val"]
        ignored_speakers = dataset["ignored_speakers"]
        language = dataset["language"]

        if formatter is None:
            formatter = _get_formatter_by_name(formatter_name)
        meta_data_train = formatter(root_path, meta_file_train, ignored_speakers=ignored_speakers)
        if not meta_data_train:
            raise ValueError(f" [!] No training samples found in {root_path}/{meta_file_train}")
        meta_data_train = add_extra_keys(meta_data_train, language, dataset_name)
        print(f" | > Found {len(meta_data_train)} files in {os.path.abspath(root_path)}")

        if eval_split:
            if meta_file_val:
                meta_data_eval = formatter(root_path, meta_file_val, ignored_speakers=ignored_speakers)
                meta_data_eval = add_extra_keys(meta_data_eval, language, dataset_name)
            else:
                eval_size_per_dataset = eval_split_max_size // len(datasets) if eval_split_max_size else None
                meta_data_eval, meta_data_train = split_dataset(
                    meta_data_train, eval_size_per_dataset, eval_split_size
                )
            meta_data_eval_all += meta_data_eval
        meta_data_train_all += meta_data_train

        if dataset.get("meta_file_attn_mask", None) if hasattr(dataset, "get") else dataset["meta_file_attn_mask"]:
            meta_data = dict(load_attention_mask_meta_data(dataset["meta_file_attn_mask"]))
            for idx, ins in enumerate(meta_data_train_all):
                attn_file = meta_data[ins["audio_file"]].strip()
                meta_data_train_all[idx].update({"alignment_file": attn_file})
            if meta_data_eval_all:
                for idx, ins in enumerate(meta_data_eval_all):
                    attn_file = meta_data[ins["audio_file"]].strip()
                    meta_data_eval_all[idx].update({"alignment_file": attn_file})
        formatter = None
    return meta_data_train_all, meta_data_eval_all


def load_attention_mask_meta_data(metafile_path: str) -> List:
    with open(metafile_path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    meta_data = []
    for line in lines:
        wav_file, attn_file = line.split("|")
        meta_data.append([wav_file, attn_file])
    return meta_data


def _get_formatter_by_name(name: str) -> Callable:
    return getattr(_formatters, name.lower())


def prefetch_batches(make_batch, schedule, num_workers: int):
    """Yield `make_batch(item)` for each schedule entry, optionally built
    ahead by a thread pool, the role of `torch.utils.data.DataLoader(
    num_workers=...)` in Coqui's trainer: host-side batch
    construction (audio decode + feature compute + collate) overlaps device
    step execution instead of serializing with it.

    Threads (not processes) suffice here because the hot host work — wav
    decode, numpy mel/F0, padding — runs in C with the GIL released.
    Ordering is deterministic: batches are yielded in schedule order
    regardless of completion order. `make_batch` may return None to skip an
    entry (e.g. a batch too small to shard across processes).
    """
    if num_workers <= 0:
        for entry in schedule:
            batch = make_batch(entry)
            if batch is not None:
                yield batch
        return
    import collections
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = collections.deque()
        it = iter(schedule)
        depth = num_workers + 2  # bounded queue: keeps host memory flat
        try:
            for _ in range(depth):
                pending.append(pool.submit(make_batch, next(it)))
        except StopIteration:
            pass
        while pending:
            batch = pending.popleft().result()
            try:
                pending.append(pool.submit(make_batch, next(it)))
            except StopIteration:
                pass
            if batch is not None:
                yield batch
