"""Evaluate a speaker encoder: the mean cosine within and across speakers.

Counterpart of `tpu_tts/bin/eval_encoder.py`:

    python -m tpu_tts_torch.bin.eval_encoder checkpoint.pth config_se.json config_dataset.json [--device cpu]

Every clip of the dataset config's datasets gets its windowed embedding;
the lines printed are JAX's: utterances and speakers, the mean intra- and
inter-speaker cosine, and their margin. The checkpoint's batch-norm
running statistics are read with its weights (`tpu_tts` reads the weights
only; ROADMAP.md, queue 3).
"""

import argparse

import numpy as np

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.config import load_config
from tpu_tts_torch.data import load_tts_samples
from tpu_tts_torch.encoder.models import setup_encoder_model


def evaluate(embs: np.ndarray, labels) -> dict:
    """Mean cosine over pairs of different clips of one speaker and of two speakers."""
    embs = embs / np.linalg.norm(embs, axis=1, keepdims=True)
    labels = np.asarray(labels)
    sim = embs @ embs.T
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    diff = ~same
    np.fill_diagonal(diff, False)
    intra = float(sim[same].mean()) if same.any() else float("nan")
    inter = float(sim[diff].mean()) if diff.any() else float("nan")
    return {"intra": intra, "inter": inter, "margin": intra - inter}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("model_path", type=str)
    parser.add_argument("config_path", type=str)
    parser.add_argument("config_dataset_path", type=str)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    ds_config = load_config(args.config_dataset_path) if args.config_dataset_path != args.config_path else config
    model = setup_encoder_model(config, device=args.device)
    model.load_checkpoint(config, args.model_path, eval=True)
    samples, _ = load_tts_samples(ds_config.datasets, eval_split=False)
    ap = AudioProcessor.init_from_config(config)
    embs = np.stack([model.compute_embedding(ap.load_wav(s["audio_file"])) for s in samples])
    labels = [s["speaker_name"] for s in samples]
    r = evaluate(embs, labels)
    print(f" > {len(samples)} utterances, {len(set(labels))} speakers")
    print(f" > mean intra-speaker cosine: {r['intra']:.4f}")
    print(f" > mean inter-speaker cosine: {r['inter']:.4f}")
    print(f" > separation margin: {r['margin']:.4f}")
    return r


if __name__ == "__main__":
    main()
