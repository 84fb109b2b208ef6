"""Training of the port: the trainer, optimizers and checkpoints."""

from tpu_tts_torch.train.trainer import Trainer, TrainerArgs  # noqa: F401
