"""WaveRNN config (mirror of `tpu_tts/vocoder/configs/wavegrad_config.py`
`WavernnConfig`:39). The model reads `model_args` (`WavernnArgs`)."""

from dataclasses import dataclass, field
from typing import Optional

from tpu_tts_torch.config import register_config_class
from tpu_tts_torch.vocoder.configs.shared_configs import BaseVocoderConfig


@register_config_class("wavernn")
@dataclass
class WavernnConfig(BaseVocoderConfig):
    model: str = "wavernn"
    generator_model: str = "wavernn"
    discriminator_model: str = ""
    model_args: Optional[dict] = None
    mode: str = "mold"  # mold | gauss | int (bits)
    mulaw: bool = True
    target_loss: str = "loss"
    epochs: int = 10000
    batch_size: int = 256
    seq_len: int = 1280
    padding: int = 2
    use_noise_augment: bool = False
    use_cache: bool = True
    mixed_precision: bool = True
    eval_split_size: int = 50
    num_epochs_before_test: int = 10
    grad_clip: float = 4.0
    lr: float = 1e-4
    lr_scheduler: str = "step"
    lr_scheduler_params: dict = field(default_factory=lambda: {"gamma": 0.5, "step_size": 200000})
