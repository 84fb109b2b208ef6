"""DelightfulTTS config (mirror of Coqui TTS `TTS/tts/configs/
delightful_tts_config.py` and its `DelightfulTtsArgs`, `VocoderConfig` and
`DelightfulTtsAudioConfig`).

Counterpart of `tpu_tts/configs/delightful_tts_config.py` (`VocoderConfig`
:16, the 100-mel audio defaults `_delightful_audio`:31,
`DelightfulTTSConfig`:45) and of `DelightfulTtsArgs`
(`tpu_tts/models/delightful_tts.py`:61), which lives here so that loading
a config builds no model. A `config.json` that `tpu_tts` writes loads
through `tpu_tts_torch.config.load_config`.

Only the fields the port reads are here: the model's widths, the decoder,
the audio and the speakers; the segment size, the discriminator, the two
optimizers and their schedulers, the loss weights that `loss_fn` reads and
the data loader's fields (`tpu_tts/configs/delightful_tts_config.py`
:51-105). `tpu_tts` never reads `init_discriminator`,
`steps_to_start_discriminator`, `ssim_loss_alpha`, `char_dur_loss_alpha` or
`binary_loss_warmup_epochs` for DelightfulTTS (ROADMAP.md, F19), so the
port leaves them out; `Coqpit.from_dict` passes over them, and over any
other field the port does not hold, in a `config.json` that has them.
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
    spec_segment_size: int = 32  # mel frames of the decoder's training window
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
    # the training discriminator (VITS's): a scale and one period discriminator a period
    use_spectral_norm_discriminator: bool = False
    periods_discriminator: List[int] = field(default_factory=lambda: [2, 3, 5, 7, 11])


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
    use_attn_priors: bool = True
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)

    # optimizers: the discriminator's (0) and the generator's (1)
    grad_clip: float = 1000.0
    lr_gen: float = 0.0002
    lr_disc: float = 0.0002
    lr_scheduler_gen: str = "exponential"
    lr_scheduler_gen_params: dict = field(default_factory=lambda: {"gamma": 0.999875, "last_epoch": -1})
    lr_scheduler_disc: str = "exponential"
    lr_scheduler_disc_params: dict = field(default_factory=lambda: {"gamma": 0.999875, "last_epoch": -1})
    optimizer: str = "adamw"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.8, 0.99], "eps": 1e-9, "weight_decay": 0.01})

    # acoustic model losses
    mel_loss_alpha: float = 1.0
    aligner_loss_alpha: float = 1.0
    pitch_loss_alpha: float = 1.0
    energy_loss_alpha: float = 1.0
    u_prosody_loss_alpha: float = 0.5
    p_prosody_loss_alpha: float = 0.5
    dur_loss_alpha: float = 1.0
    binary_align_loss_alpha: float = 0.1

    # vocoder losses
    disc_loss_alpha: float = 1.0
    gen_loss_alpha: float = 1.0
    feat_loss_alpha: float = 1.0
    vocoder_mel_loss_alpha: float = 10.0
    multi_scale_stft_loss_alpha: float = 2.5
    multi_scale_stft_loss_params: dict = field(
        default_factory=lambda: {
            "n_ffts": [1024, 2048, 512],
            "hop_lengths": [120, 240, 50],
            "win_lengths": [600, 1200, 240],
        }
    )

    # data loader
    return_wav: bool = True
    compute_f0: bool = True
    f0_cache_path: Optional[str] = None
    attn_prior_cache_path: Optional[str] = None

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
