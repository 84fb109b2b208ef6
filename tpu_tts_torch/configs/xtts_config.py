"""XTTS config (copy of `tpu_tts/configs/xtts_config.py` and of `XttsArgs`,
`tpu_tts/models/xtts.py`:34-66; mirrors of Coqui TTS
`TTS/tts/configs/xtts_config.py` and the `XttsArgs` of `TTS/tts/models/xtts.py`)."""

from dataclasses import dataclass, field
from typing import List, Optional

from tpu_tts_torch.config import register_config_class
from tpu_tts_torch.config.base import Coqpit
from tpu_tts_torch.configs.shared_configs import BaseTTSConfig


@dataclass
class XttsArgs(Coqpit):
    gpt_layers: int = 30
    gpt_n_heads: int = 16
    gpt_n_model_channels: int = 1024
    gpt_number_text_tokens: int = 6681
    gpt_num_audio_tokens: int = 1026
    gpt_start_audio_token: int = 1024
    gpt_stop_audio_token: int = 1025
    gpt_max_text_tokens: int = 402
    gpt_max_audio_tokens: int = 605
    gpt_cond_len: int = 30  # seconds of conditioning audio used
    num_cond_latents: int = 32
    d_vector_dim: int = 512
    decoder_input_dim: int = 1024
    output_sample_rate: int = 24000
    input_sample_rate: int = 22050
    output_hop_length: int = 256
    gpt_code_stride: int = 1024  # ar_mel_length_compression of Coqui's HifiDecoder
    decoder_upsample_rates: tuple = (8, 8, 2, 2)
    kv_cache_len: int = 1100
    # ------------------------------ fine-tuning (read by training, not ported yet)
    gpt_start_text_token: int = 261  # vocab [START]/[STOP] ids
    gpt_stop_text_token: int = 0
    gpt_loss_text_ce_weight: float = 0.01
    gpt_loss_mel_ce_weight: float = 1.0
    dvae_sample_rate: int = 22050
    max_wav_length: int = 255995  # ~11.6 s
    max_text_length: int = 200
    min_conditioning_length: int = 66150  # 3 s
    max_conditioning_length: int = 132300  # 6 s
    mel_norm_file: str = ""  # per-bin mel divisors (mel_stats.pth)
    dvae_checkpoint: str = ""
    tokenizer_file: str = ""


@register_config_class("xtts")
@dataclass
class XttsConfig(BaseTTSConfig):
    model: str = "xtts"
    model_args: XttsArgs = field(default_factory=XttsArgs)
    model_dir: Optional[str] = None
    languages: List[str] = field(
        default_factory=lambda: [
            "en", "es", "fr", "de", "it", "pt", "pl", "tr", "ru", "nl", "cs", "ar", "zh-cn", "hu", "ko", "ja", "hi",
        ]
    )
    temperature: float = 0.75
    length_penalty: float = 1.0
    repetition_penalty: float = 10.0
    top_k: int = 50
    top_p: float = 0.85
    num_gpt_outputs: int = 1
    gpt_cond_len: int = 30
    gpt_cond_chunk_len: int = 4
    max_ref_len: int = 30
    sound_norm_refs: bool = False
