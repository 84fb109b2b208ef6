"""Shared vocoder configs (mirror of `tpu_tts/vocoder/configs/shared_configs.py`:
`BaseVocoderConfig`:10, `BaseGANVocoderConfig`:26)."""

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


@dataclass
class BaseGANVocoderConfig(BaseVocoderConfig):
    model: str = "gan"
    generator_model: str = ""
    discriminator_model: str = ""
    generator_model_params: dict = field(default_factory=dict)
    discriminator_model_params: dict = field(default_factory=dict)
    # loss switches
    use_stft_loss: bool = True
    use_subband_stft_loss: bool = True
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = True
    use_feat_match_loss: bool = True
    use_l1_spec_loss: bool = True
    # loss weights
    stft_loss_weight: float = 0
    subband_stft_loss_weight: float = 0
    mse_G_loss_weight: float = 1
    hinge_G_loss_weight: float = 0
    feat_match_loss_weight: float = 100
    l1_spec_loss_weight: float = 45
    stft_loss_params: dict = field(
        default_factory=lambda: {
            "n_ffts": [1024, 2048, 512],
            "hop_lengths": [120, 240, 50],
            "win_lengths": [600, 1200, 240],
        }
    )
    l1_spec_loss_params: dict = field(
        default_factory=lambda: {
            "use_mel": True,
            "sample_rate": 22050,
            "n_fft": 1024,
            "hop_length": 256,
            "win_length": 1024,
            "n_mels": 80,
            "mel_fmin": 0.0,
            "mel_fmax": None,
        }
    )
    target_loss: str = "loss_1"  # generator loss picks best model
    grad_clip: list = field(default_factory=lambda: [5.0, 5.0])
    lr_gen: float = 0.0002
    lr_disc: float = 0.0002
    lr: float = 0.0002
    lr_scheduler_gen: str = "exponential"
    lr_scheduler_gen_params: dict = field(default_factory=lambda: {"gamma": 0.999, "decay_steps": 1000})
    lr_scheduler_disc: str = "exponential"
    lr_scheduler_disc_params: dict = field(default_factory=lambda: {"gamma": 0.999, "decay_steps": 1000})
    scheduler_after_epoch: bool = True
    use_pqmf: bool = False
    # read by nothing in either package: D trains from step 0 (ROADMAP.md, queue 3, F11)
    steps_to_start_discriminator: int = 0
    diff_samples_for_G_and_D: bool = False
