from tpu_tts_torch.vocoder.configs.shared_configs import BaseVocoderConfig
from tpu_tts_torch.vocoder.configs.wavernn_config import WavernnConfig

__all__ = ["BaseVocoderConfig", "WavernnConfig"]
