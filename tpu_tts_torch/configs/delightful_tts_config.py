"""DelightfulTTS config (mirror of Coqui TTS `TTS/tts/configs/
delightful_tts_config.py` and its `DelightfulTtsArgs`, `VocoderConfig` and
`DelightfulTtsAudioConfig`).

Counterpart of `tpu_tts/configs/delightful_tts_config.py` (`VocoderConfig`
:16, the 100-mel audio defaults `_delightful_audio`:31,
`DelightfulTTSConfig`:45) and of `DelightfulTtsArgs`
(`tpu_tts/models/delightful_tts.py`:61), which lives here so that loading
a config builds no model. A `config.json` that `tpu_tts` writes loads
through `tpu_tts_torch.config.load_config`.

Only the fields inference reads are here: the model's widths, the decoder,
the audio and the speakers. The training settings (optimizers, schedulers,
loss weights, discriminator, data loader) come with the training slice;
`Coqpit.from_dict` passes over them in a `config.json` that holds them.
"""

from dataclasses import dataclass, field
from typing import List, Optional

from tpu_tts_torch.config import register_config_class
from tpu_tts_torch.config.base import Coqpit
from tpu_tts_torch.config.shared_configs import BaseAudioConfig
from tpu_tts_torch.configs.shared_configs import BaseTTSConfig


@dataclass
class DelightfulTtsArgs(Coqpit):
    num_chars: int = 100
    # conformer encoder / decoder
    n_hidden_conformer_encoder: int = 512
    n_layers_conformer_encoder: int = 6
    n_heads_conformer_encoder: int = 8
    dropout_conformer_encoder: float = 0.1
    kernel_size_conv_mod_conformer_encoder: int = 7
    lrelu_slope: float = 0.3
    n_hidden_conformer_decoder: int = 512
    n_layers_conformer_decoder: int = 6
    n_heads_conformer_decoder: int = 8
    dropout_conformer_decoder: float = 0.1
    kernel_size_conv_mod_conformer_decoder: int = 11
    # reference encoders
    bottleneck_size_p_reference_encoder: int = 4
    bottleneck_size_u_reference_encoder: int = 512
    ref_enc_filters_reference_encoder: list = field(default_factory=lambda: [32, 32, 64, 64, 128, 128])
    ref_enc_size_reference_encoder: int = 3
    ref_enc_strides_reference_encoder: list = field(default_factory=lambda: [1, 2, 1, 2, 1])
    ref_enc_gru_size_reference_encoder: int = 32
    token_num_reference_encoder: int = 32
    predictor_kernel_size_reference_encoder: int = 5
    # variance adaptors
    n_hidden_variance_adaptor: int = 512
    kernel_size_variance_adaptor: int = 5
    dropout_variance_adaptor: float = 0.5
    emb_kernel_size_variance_adaptor: int = 3
    # multi-speaker
    use_speaker_embedding: bool = False
    num_speakers: int = 0
    speaker_embedding_channels: int = 384
    use_d_vector_file: bool = False
    d_vector_dim: int = 0
    length_scale: float = 1.0
    # filled by the model
    num_mels: int = 100


@dataclass
class VocoderConfig(Coqpit):
    resblock_type_decoder: str = "1"
    resblock_kernel_sizes_decoder: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilation_sizes_decoder: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    upsample_rates_decoder: List[int] = field(default_factory=lambda: [8, 8, 2, 2])
    upsample_initial_channel_decoder: int = 512
    upsample_kernel_sizes_decoder: List[int] = field(default_factory=lambda: [16, 16, 4, 4])


def _delightful_audio() -> BaseAudioConfig:
    """100 mels over 0–8 kHz at 22.05 kHz, hop 256."""
    return BaseAudioConfig(
        sample_rate=22050,
        hop_length=256,
        win_length=1024,
        fft_size=1024,
        mel_fmin=0.0,
        mel_fmax=8000.0,
        num_mels=100,
        pitch_fmax=640.0,
    )


@register_config_class("delightful_tts")
@dataclass
class DelightfulTTSConfig(BaseTTSConfig):
    model: str = "delightful_tts"
    audio: BaseAudioConfig = field(default_factory=_delightful_audio)
    model_args: DelightfulTtsArgs = field(default_factory=DelightfulTtsArgs)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)

    # multi-speaker
    num_speakers: int = 0
    use_speaker_embedding: bool = False
    speakers_file: Optional[str] = None
    use_d_vector_file: bool = False
    d_vector_file: Optional[str] = None
    d_vector_dim: Optional[int] = None

    def __post_init__(self):
        if hasattr(super(), "__post_init__"):
            super().__post_init__()
        # the multi-speaker settings reach the model's args
        if self.num_speakers > 0:
            self.model_args.num_speakers = self.num_speakers
        if self.use_speaker_embedding:
            self.model_args.use_speaker_embedding = True
        if self.use_d_vector_file:
            self.model_args.use_d_vector_file = True
        if self.d_vector_dim is not None and self.d_vector_dim > 0:
            self.model_args.d_vector_dim = self.d_vector_dim
