"""Shared vocoder config (mirror of `tpu_tts/vocoder/configs/shared_configs.py`
`BaseVocoderConfig`; the GAN config comes with the GAN vocoders, M8)."""

from dataclasses import dataclass, field
from typing import Optional

from tpu_tts_torch.config.shared_configs import BaseAudioConfig, BaseTrainingConfig


@dataclass
class BaseVocoderConfig(BaseTrainingConfig):
    audio: BaseAudioConfig = field(default_factory=BaseAudioConfig)
    use_noise_augment: bool = False
    eval_split_size: int = 10
    data_path: str = ""
    feature_path: Optional[str] = None
    seq_len: int = 1000
    pad_short: int = 0
    conv_pad: int = 0
    use_cache: bool = False
    epochs: int = 10000
    wd: float = 0.0
    optimizer: str = "adamw"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.8, 0.99], "weight_decay": 0.0})
