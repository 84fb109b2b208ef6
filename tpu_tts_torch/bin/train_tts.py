"""Train a TTS model with the port.

Counterpart of `tpu_tts/bin/train_tts.py`:

    python -m tpu_tts_torch.bin.train_tts --config_path config.json \\
        [--restore_path model.pth] [--continue_path run_dir] [--device cpu] [--coqpit.field value ...]

`--continue_path` resumes a run directory (its `config.json` and newest
checkpoint: weights, optimizers, step, epoch and the generators' states);
`--restore_path` starts from the weights of a checkpoint, the port's or a
Coqui VITS `.pth` holding the generator and `disc.*`, or an XTTS model
directory's checkpoint, whose directory then becomes the config's
`model_dir` unless it names one (its `speakers_xtts.pth` is copied beside
the run's checkpoints, so the run directory serves as a model directory).
A multi-speaker VITS takes its speaker ids from the samples. The run
trains on `--device` (`cuda` unless told otherwise) and writes to the
config's `output_path`, or into the continued directory.
"""

import os
import sys
from dataclasses import dataclass

from tpu_tts_torch.config import load_config
from tpu_tts_torch.data import load_tts_samples
from tpu_tts_torch.models import setup_model
from tpu_tts_torch.train import Trainer, TrainerArgs


@dataclass
class TrainTTSArgs(TrainerArgs):
    config_path: str = ""


def parse_args(argv):
    """(the trainer's `--name value` args, the rest for the config)."""
    args = TrainTTSArgs()
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--") and "." not in a[2:] and hasattr(args, a[2:]) and i + 1 < len(argv):
            args.set_dotted(a[2:], argv[i + 1])
            i += 2
            continue
        rest.append(a)
        i += 1
    return args, rest


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    train_args, rest = parse_args(argv)
    if train_args.continue_path:
        train_args.config_path = os.path.join(train_args.continue_path, "config.json")

    config = load_config(train_args.config_path)
    rest = config.parse_args(rest, arg_prefix="coqpit")
    if rest:
        print(f" [!] Unused args: {rest}")

    train_samples, eval_samples = load_tts_samples(
        config.datasets,
        eval_split=True,
        eval_split_max_size=config.eval_split_max_size,
        eval_split_size=config.eval_split_size,
    )
    if train_args.restore_path and hasattr(config, "model_dir") and not config.model_dir:
        config.model_dir = os.path.dirname(os.path.abspath(train_args.restore_path))
    model = setup_model(config, device=train_args.device, samples=train_samples + (eval_samples or []))
    output_path = train_args.continue_path if train_args.continue_path else config.output_path
    trainer = Trainer(
        TrainerArgs.from_dict({k: v for k, v in train_args.to_dict().items() if k != "config_path"}),
        model.config,
        output_path,
        model=model,
        train_samples=train_samples,
        eval_samples=eval_samples,
    )
    trainer.fit()


if __name__ == "__main__":
    main()
