"""Train a GAN vocoder with the port.

Counterpart of `tpu_tts/bin/train_vocoder.py`:

    python -m tpu_tts_torch.bin.train_vocoder --config_path config.json \\
        [--restore_path model.pth] [--continue_path run_dir] [--device cpu] [--coqpit.field value ...]

The config is a GAN vocoder's (`hifigan`, `melgan`, `fullband_melgan`,
`multiband_melgan`, `univnet`); its `data_path` is searched for wavs
(`feature_path`, if set, for `.npy` features paired by name), and
`eval_split_size` of them are held out. Training runs the two optimizers,
D then G, through the port's `Trainer`, which prints, saves Coqui-format
`.pth` checkpoints with `config.json`, evaluates and resumes. The run
directory then serves as a vocoder (`--vocoder_path`,
`--vocoder_config_path`). `--continue_path` resumes a run directory;
`--restore_path` starts from the weights of a checkpoint (the port's or a
Coqui GAN vocoder's).
"""

import os
import sys

from tpu_tts_torch.bin.train_tts import parse_args
from tpu_tts_torch.config import load_config
from tpu_tts_torch.train import Trainer, TrainerArgs
from tpu_tts_torch.vocoder.datasets import load_wav_data, load_wav_feat_data
from tpu_tts_torch.vocoder.models import setup_model


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    train_args, rest = parse_args(argv)
    if train_args.continue_path:
        train_args.config_path = os.path.join(train_args.continue_path, "config.json")
    config = load_config(train_args.config_path)
    rest = config.parse_args(rest, arg_prefix="coqpit")
    if rest:
        print(f" [!] Unused args: {rest}")
    if config.feature_path:
        train_samples, eval_samples = load_wav_feat_data(config.data_path, config.feature_path,
                                                         config.eval_split_size)
    else:
        train_samples, eval_samples = load_wav_data(config.data_path, config.eval_split_size)
    model = setup_model(config, device=train_args.device)
    trainer = Trainer(
        TrainerArgs.from_dict({k: v for k, v in train_args.to_dict().items() if k != "config_path"}),
        config,
        train_args.continue_path or config.output_path,
        model=model,
        train_samples=train_samples,
        eval_samples=eval_samples,
    )
    trainer.fit()


if __name__ == "__main__":
    main()
