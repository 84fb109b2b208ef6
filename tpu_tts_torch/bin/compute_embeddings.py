"""Compute the d-vector of every clip of a dataset into Coqui's d-vector file.

Counterpart of `tpu_tts/bin/compute_embeddings.py`:

    python -m tpu_tts_torch.bin.compute_embeddings --model_path checkpoint.pth --config_path config_se.json \\
        --config_dataset_path config.json --output_path speakers.json [--no_eval] [--device cpu]

or with `--formatter_name`, `--dataset_path` (and `--meta_file_train`)
instead of a dataset config. The file is `{clip: {"name": speaker,
"embedding": [...]}}` (`.json` or `.pth`; a directory gets
`speakers.json`), the `d_vector_file` of a d-vector VITS.
"""

import argparse
import os

from tpu_tts_torch.config import load_config
from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
from tpu_tts_torch.data import load_tts_samples
from tpu_tts_torch.managers import SpeakerManager, save_file


def compute_embeddings(model_path, config_path, output_path, formatter_name=None, dataset_name=None,
                       dataset_path=None, meta_file_train=None, meta_file_val=None, config_dataset_path=None,
                       no_eval=False, device=None):
    if config_dataset_path:
        datasets = load_config(config_dataset_path).datasets
    else:
        datasets = BaseDatasetConfig(formatter=formatter_name, dataset_name=dataset_name or formatter_name,
                                     path=dataset_path, meta_file_train=meta_file_train or "",
                                     meta_file_val=meta_file_val or "")
    meta_data_train, meta_data_eval = load_tts_samples(datasets, eval_split=not no_eval)
    samples = meta_data_train + (meta_data_eval or [])
    manager = SpeakerManager(encoder_model_path=model_path, encoder_config_path=config_path, device=device)
    embeddings = {}
    for idx, sample in enumerate(samples):
        clip_name = os.path.splitext(os.path.basename(sample["audio_file"]))[0]
        embeddings[clip_name] = {"name": sample["speaker_name"],
                                 "embedding": manager.compute_embedding_from_clip(sample["audio_file"])}
        if idx % 50 == 0:
            print(f" > {idx}/{len(samples)}", flush=True)
    if os.path.isdir(output_path):
        output_path = os.path.join(output_path, "speakers.json")
    save_file(embeddings, output_path)
    print(f" > Saved {len(embeddings)} embeddings to {output_path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compute embedding vectors for each audio file in a dataset.")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--config_dataset_path", type=str, default=None)
    parser.add_argument("--output_path", type=str, default="speakers.json")
    parser.add_argument("--formatter_name", type=str, default=None)
    parser.add_argument("--dataset_name", type=str, default=None)
    parser.add_argument("--dataset_path", type=str, default=None)
    parser.add_argument("--meta_file_train", type=str, default=None)
    parser.add_argument("--meta_file_val", type=str, default=None)
    parser.add_argument("--no_eval", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = parser.parse_args(argv)
    compute_embeddings(a.model_path, a.config_path, a.output_path, formatter_name=a.formatter_name,
                       dataset_name=a.dataset_name, dataset_path=a.dataset_path, meta_file_train=a.meta_file_train,
                       meta_file_val=a.meta_file_val, config_dataset_path=a.config_dataset_path, no_eval=a.no_eval,
                       device=a.device)


if __name__ == "__main__":
    main()
