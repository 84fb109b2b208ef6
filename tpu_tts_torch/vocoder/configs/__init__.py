from tpu_tts_torch.vocoder.configs.gan_configs import (
    FullbandMelganConfig,
    HifiganConfig,
    MelganConfig,
    MultibandMelganConfig,
    ParallelWaveganConfig,
    UnivnetConfig,
)
from tpu_tts_torch.vocoder.configs.shared_configs import BaseGANVocoderConfig, BaseVocoderConfig
from tpu_tts_torch.vocoder.configs.wavernn_config import WavernnConfig

__all__ = [
    "BaseVocoderConfig",
    "BaseGANVocoderConfig",
    "HifiganConfig",
    "MelganConfig",
    "FullbandMelganConfig",
    "MultibandMelganConfig",
    "ParallelWaveganConfig",
    "UnivnetConfig",
    "WavernnConfig",
]
