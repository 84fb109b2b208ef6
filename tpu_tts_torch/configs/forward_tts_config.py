"""Configs of the ForwardTTS family: FastPitch, FastSpeech, FastSpeech2 and
SpeedySpeech (mirrors of Coqui TTS `TTS/tts/configs/{fast_pitch_config.py,
fast_speech_config.py, fastspeech2_config.py, speedy_speech_config.py}`).

Counterpart of `tpu_tts/configs/forward_tts_configs.py` (`_ForwardBase`:21,
`FastPitchConfig`:63, `FastSpeechConfig`:72, `Fastspeech2Config`:81,
`_speedy_args`:93, `SpeedySpeechConfig`:113) and of `ForwardTTSArgs`
(`tpu_tts/models/forward_tts.py`:45), which lives here so that loading a
config builds no model. Each config names `base_model="forward_tts"`; its
`__post_init__` sets `use_pitch` and `use_energy` on the model args. A
`config.json` that `tpu_tts` writes loads through
`tpu_tts_torch.config.load_config`.

Only the fields the port reads are here. `tpu_tts` stores
`binary_loss_warmup_epochs` and `duration_loss_type` and never applies them
(ROADMAP.md, F22), its data loader never reads `min_seq_len` or
`max_seq_len`, and `r` is 1, the loader's default; the port leaves them
out, and `Coqpit.from_dict` passes over them in a `config.json` that has
them.
"""

from dataclasses import dataclass, field
from typing import Optional

from tpu_tts_torch.config import register_config_class
from tpu_tts_torch.config.base import Coqpit
from tpu_tts_torch.configs.shared_configs import BaseTTSConfig


@dataclass
class ForwardTTSArgs(Coqpit):
    num_chars: Optional[int] = None
    out_channels: int = 80
    hidden_channels: int = 384
    use_aligner: bool = True
    # pitch
    use_pitch: bool = True
    pitch_predictor_hidden_channels: int = 256
    pitch_predictor_kernel_size: int = 3
    pitch_predictor_dropout_p: float = 0.1
    pitch_embedding_kernel_size: int = 3
    # energy
    use_energy: bool = False
    energy_predictor_hidden_channels: int = 256
    energy_predictor_kernel_size: int = 3
    energy_predictor_dropout_p: float = 0.1
    energy_embedding_kernel_size: int = 3
    # duration
    duration_predictor_hidden_channels: int = 256
    duration_predictor_kernel_size: int = 3
    duration_predictor_dropout_p: float = 0.1
    positional_encoding: bool = True
    poisitonal_encoding_use_scale: bool = True
    length_scale: float = 1
    encoder_type: str = "fftransformer"
    encoder_params: dict = field(
        default_factory=lambda: {"hidden_channels_ffn": 1024, "num_heads": 1, "num_layers": 6, "dropout_p": 0.1}
    )
    decoder_type: str = "fftransformer"
    decoder_params: dict = field(
        default_factory=lambda: {"hidden_channels_ffn": 1024, "num_heads": 1, "num_layers": 6, "dropout_p": 0.1}
    )
    detach_duration_predictor: bool = False
    max_duration: int = 75
    num_speakers: int = 1
    use_speaker_embedding: bool = False
    speakers_file: Optional[str] = None
    use_d_vector_file: bool = False
    d_vector_dim: Optional[int] = None
    d_vector_file: Optional[str] = None
    norm_type: str = "batch"  # of the residual-conv coders; "frozen_batch" for a Coqui checkpoint's statistics


@dataclass
class _ForwardBase(BaseTTSConfig):
    base_model: str = "forward_tts"
    model_args: ForwardTTSArgs = field(default_factory=ForwardTTSArgs)
    # multi-speaker
    num_speakers: int = 0
    speakers_file: Optional[str] = None
    use_speaker_embedding: bool = False
    use_d_vector_file: bool = False
    d_vector_file: Optional[str] = None
    d_vector_dim: int = 0
    # optimizer
    optimizer: str = "adam"
    optimizer_params: dict = field(default_factory=lambda: {"betas": [0.9, 0.998], "weight_decay": 1e-6})
    lr_scheduler: str = "noam"
    lr_scheduler_params: dict = field(default_factory=lambda: {"warmup_steps": 4000})
    lr: float = 1e-4
    grad_clip: float = 5.0
    # losses
    spec_loss_type: str = "mse"
    use_ssim_loss: bool = True
    ssim_loss_alpha: float = 1.0
    spec_loss_alpha: float = 1.0
    aligner_loss_alpha: float = 1.0
    pitch_loss_alpha: float = 0.1
    energy_loss_alpha: float = 0.1
    dur_loss_alpha: float = 0.1
    binary_align_loss_alpha: float = 0.1
    # dataset
    compute_f0: bool = False
    f0_cache_path: Optional[str] = None
    energy_cache_path: Optional[str] = None


@register_config_class("fast_pitch")
@dataclass
class FastPitchConfig(_ForwardBase):
    model: str = "fast_pitch"
    compute_f0: bool = True

    def __post_init__(self):
        self.model_args.use_pitch = True


@register_config_class("fast_speech")
@dataclass
class FastSpeechConfig(_ForwardBase):
    model: str = "fast_speech"

    def __post_init__(self):
        self.model_args.use_pitch = False


@register_config_class("fastspeech2")
@dataclass
class Fastspeech2Config(_ForwardBase):
    model: str = "fastspeech2"
    compute_f0: bool = True
    compute_energy: bool = True

    def __post_init__(self):
        self.model_args.use_pitch = True
        self.model_args.use_energy = True


def _speedy_args() -> ForwardTTSArgs:
    """SpeedySpeech's model args (Coqui's `speedy_speech_config.py`): 128
    wide, residual-conv encoder and decoder, no pitch."""
    return ForwardTTSArgs(
        use_pitch=False,
        hidden_channels=128,
        positional_encoding=True,
        encoder_type="residual_conv_bn",
        encoder_params={"kernel_size": 4, "dilations": [1, 2, 4, 1, 2, 4, 1, 2, 4, 1, 2, 4, 1], "num_conv_blocks": 2},
        decoder_type="residual_conv_bn",
        decoder_params={"kernel_size": 4, "dilations": [1, 2, 4, 8, 1, 2, 4, 8, 1, 2, 4, 8, 1], "num_conv_blocks": 2},
    )


@register_config_class("speedy_speech")
@dataclass
class SpeedySpeechConfig(_ForwardBase):
    model: str = "speedy_speech"
    model_args: ForwardTTSArgs = field(default_factory=_speedy_args)
