"""Train a speaker (or emotion) encoder with the port.

Counterpart of `tpu_tts/bin/train_encoder.py` (its own loop, not the
`Trainer`):

    python -m tpu_tts_torch.bin.train_encoder --config_path config_se.json \\
        [--restore_path checkpoint_N.pth] [--max_steps N] [--device cpu] [--coqpit.field value ...]

Batches come from `PerfectBatchSampler` (`num_classes_in_batch` classes ×
`num_utter_per_class` crops of `voice_len` seconds); the d-vectors of a
batch are read as `[num_classes_in_batch, num_utter_per_class, dim]` in the
sampler's order, as `tpu_tts` reads them (ROADMAP.md, queue 3, F10). The
loss is GE2E with `loss: "ge2e"`, else angular prototypical (F8: also for
"softmaxproto"), its scale w and offset b trained beside the model from 10
and −5; the optimizer is the config's (`radam` by default) with its
`grad_clip` and, with `lr_decay`, the Noam schedule. A "batch"-norm ResNet
updates its running statistics every step. Checkpoints
(`<output_path>/checkpoint_<step>.pth`, `{"model": state_dict, "step"}`,
the running statistics in the state dict) are written every `save_step`
steps, at `--max_steps` and at the end. The sampler's shuffles and the
initial weights are seeded with `training_seed`.
"""

import argparse
import os
import random
import sys
import time

import torch

from tpu_tts_torch.audio import AudioProcessor
from tpu_tts_torch.config import load_config
from tpu_tts_torch.data import load_tts_samples
from tpu_tts_torch.data.samplers import PerfectBatchSampler
from tpu_tts_torch.encoder.dataset import EncoderDataset
from tpu_tts_torch.encoder.losses import angle_proto_loss, ge2e_loss
from tpu_tts_torch.encoder.models import setup_encoder_model
from tpu_tts_torch.train import checkpoint as ckpt_io
from tpu_tts_torch.train.optimizers import get_optimizer, noam_schedule


def encoder_loss(config, dvecs, w, b):
    """The training loss of d-vectors `[S, U, D]`: GE2E or angular prototypical."""
    return ge2e_loss(dvecs, w, b) if config.loss == "ge2e" else angle_proto_loss(dvecs, w, b)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--restore_path", default="")
    parser.add_argument("--max_steps", type=int, default=0, help="stop early (0 = the config's epochs)")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args, rest = parser.parse_known_args(argv if argv is not None else sys.argv[1:])

    config = load_config(args.config_path)
    config.parse_args(rest, arg_prefix="coqpit")
    random.seed(config.training_seed)  # the sampler's shuffles
    torch.manual_seed(config.training_seed)  # the initial weights
    ap = AudioProcessor.init_from_config(config)
    train_items, _ = load_tts_samples(config.datasets, eval_split=False)
    label_key = getattr(config, "class_name_key", "speaker_name")
    dataset = EncoderDataset(config, ap, train_items, voice_len=config.voice_len,
                             num_classes_in_batch=config.num_classes_in_batch,
                             num_utter_per_class=config.num_utter_per_class,
                             augmentation_config=config.audio_augmentation, label_key=label_key,
                             seed=config.training_seed)
    S, U = config.num_classes_in_batch, config.num_utter_per_class
    sampler = PerfectBatchSampler([{"class_name": it[label_key]} for it in dataset.items], dataset.get_class_list(),
                                  batch_size=S * U, num_classes_in_batch=S, drop_last=True)

    model = setup_encoder_model(config, device=args.device)
    net = model.net.train()
    if args.restore_path:
        net.load_state_dict(ckpt_io.load_checkpoint(args.restore_path)["model"], strict=True)
    w = torch.nn.Parameter(torch.tensor(10.0, device=model.device))
    b = torch.nn.Parameter(torch.tensor(-5.0, device=model.device))
    schedule = noam_schedule(config.lr, config.warmup_steps) if config.lr_decay else config.lr
    opt = get_optimizer(config.optimizer, config.optimizer_params, list(net.parameters()) + [w, b], config,
                        schedule=schedule)

    def save(step):
        ckpt_io.save_checkpoint({"model": net.state_dict(), "step": step}, config.output_path, step, config)

    os.makedirs(config.output_path, exist_ok=True)
    step = 0
    for epoch in range(config.epochs):
        dataset.set_epoch(epoch)
        for batch_idxs in sampler:
            t0 = time.time()
            batch = dataset.collate_fn([dataset[i] for i in batch_idxs])
            wavs = torch.from_numpy(batch["wavs"]).to(model.device)
            loss = encoder_loss(config, net(model.features_from_wav(wavs)).reshape(S, U, -1), w, b)
            loss.backward()
            opt.step()
            step += 1
            if step % config.print_step == 0:
                print(f" | > step {step} loss {loss.item():.5f} ({time.time() - t0:.2f}s)", flush=True)
            if step % config.save_step == 0:
                save(step)
            if args.max_steps and step >= args.max_steps:
                save(step)
                print(" > Done (max_steps).")
                return
    save(step)


if __name__ == "__main__":
    main()
