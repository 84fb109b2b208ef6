from tpu_tts_torch.configs.delightful_tts_config import DelightfulTTSConfig
from tpu_tts_torch.configs.forward_tts_config import (
    FastPitchConfig,
    Fastspeech2Config,
    FastSpeechConfig,
    ForwardTTSArgs,
    SpeedySpeechConfig,
)
from tpu_tts_torch.configs.glow_tts_config import GlowTTSConfig
from tpu_tts_torch.configs.shared_configs import BaseTTSConfig
from tpu_tts_torch.configs.vits_config import VitsConfig
from tpu_tts_torch.configs.xtts_config import XttsArgs, XttsConfig

__all__ = ["BaseTTSConfig", "DelightfulTTSConfig", "FastPitchConfig", "FastSpeechConfig", "Fastspeech2Config",
           "ForwardTTSArgs", "GlowTTSConfig", "SpeedySpeechConfig", "VitsConfig", "XttsArgs", "XttsConfig"]
