"""Per-model GAN vocoder configs (mirror of `tpu_tts/vocoder/configs/gan_configs.py`:
`HifiganConfig`:13, `MelganConfig`:51, `FullbandMelganConfig`:78,
`MultibandMelganConfig`:88, `ParallelWaveganConfig`:128, `UnivnetConfig`:156),
registered under the same model names, so a Coqui vocoder `config.json`
loads. `ParallelWaveganConfig` loads; its model is not ported yet."""

from dataclasses import dataclass, field

from tpu_tts_torch.config import register_config_class
from tpu_tts_torch.vocoder.configs.shared_configs import BaseGANVocoderConfig


@register_config_class("hifigan")
@dataclass
class HifiganConfig(BaseGANVocoderConfig):
    model: str = "hifigan"
    discriminator_model: str = "hifigan_discriminator"
    generator_model: str = "hifigan_generator"
    generator_model_params: dict = field(
        default_factory=lambda: {
            "upsample_factors": [8, 8, 2, 2],
            "upsample_kernel_sizes": [16, 16, 4, 4],
            "upsample_initial_channel": 512,
            "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
            "resblock_type": "1",
        }
    )
    batch_size: int = 16
    seq_len: int = 8192
    pad_short: int = 2000
    use_noise_augment: bool = False
    use_cache: bool = True
    use_stft_loss: bool = False
    use_subband_stft_loss: bool = False
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = False
    use_feat_match_loss: bool = True
    use_l1_spec_loss: bool = True
    stft_loss_weight: float = 0
    subband_stft_loss_weight: float = 0
    mse_G_loss_weight: float = 1
    hinge_G_loss_weight: float = 0
    feat_match_loss_weight: float = 108
    l1_spec_loss_weight: float = 45
    lr_gen: float = 1e-4
    lr_disc: float = 1e-4
    wd: float = 1e-6


@register_config_class("melgan")
@dataclass
class MelganConfig(BaseGANVocoderConfig):
    model: str = "melgan"
    discriminator_model: str = "melgan_multiscale_discriminator"
    discriminator_model_params: dict = field(
        default_factory=lambda: {"base_channels": 16, "max_channels": 1024, "downsample_factors": [4, 4, 4, 4]}
    )
    generator_model: str = "melgan_generator"
    generator_model_params: dict = field(
        default_factory=lambda: {"upsample_factors": [8, 8, 2, 2], "num_res_blocks": 3}
    )
    batch_size: int = 16
    seq_len: int = 8192
    pad_short: int = 2000
    use_noise_augment: bool = True
    use_stft_loss: bool = True
    use_subband_stft_loss: bool = False
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = False
    use_feat_match_loss: bool = True
    use_l1_spec_loss: bool = False
    stft_loss_weight: float = 0.5
    mse_G_loss_weight: float = 2.5
    feat_match_loss_weight: float = 108


@register_config_class("fullband_melgan")
@dataclass
class FullbandMelganConfig(MelganConfig):
    model: str = "fullband_melgan"
    generator_model: str = "fullband_melgan_generator"
    generator_model_params: dict = field(
        default_factory=lambda: {"upsample_factors": [8, 8, 2, 2], "num_res_blocks": 4}
    )


@register_config_class("multiband_melgan")
@dataclass
class MultibandMelganConfig(BaseGANVocoderConfig):
    model: str = "multiband_melgan"
    discriminator_model: str = "melgan_multiscale_discriminator"
    discriminator_model_params: dict = field(
        default_factory=lambda: {"base_channels": 16, "max_channels": 512, "downsample_factors": [4, 4, 4]}
    )
    generator_model: str = "multiband_melgan_generator"
    generator_model_params: dict = field(
        default_factory=lambda: {"upsample_factors": [2, 8, 2, 2], "num_res_blocks": 4}
    )
    use_pqmf: bool = True
    batch_size: int = 64
    seq_len: int = 16384
    pad_short: int = 2000
    use_noise_augment: bool = False
    use_cache: bool = True
    steps_to_start_discriminator: int = 200000
    use_stft_loss: bool = True
    use_subband_stft_loss: bool = True
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = False
    use_feat_match_loss: bool = False
    use_l1_spec_loss: bool = False
    subband_stft_loss_params: dict = field(
        default_factory=lambda: {
            "n_ffts": [384, 683, 171],
            "hop_lengths": [30, 60, 10],
            "win_lengths": [150, 300, 60],
        }
    )
    stft_loss_weight: float = 0.5
    subband_stft_loss_weight: float = 0.5
    mse_G_loss_weight: float = 2.5
    feat_match_loss_weight: float = 108
    lr_gen: float = 1e-4
    lr_disc: float = 1e-4


@register_config_class("parallel_wavegan")
@dataclass
class ParallelWaveganConfig(BaseGANVocoderConfig):
    model: str = "parallel_wavegan"
    generator_model: str = "parallel_wavegan_generator"
    discriminator_model: str = "parallel_wavegan_discriminator"
    generator_model_params: dict = field(
        default_factory=lambda: {"upsample_factors": [4, 4, 4, 4], "stacks": 3, "num_res_blocks": 30}
    )
    batch_size: int = 6
    seq_len: int = 25600
    pad_short: int = 2000
    use_noise_augment: bool = False
    use_cache: bool = True
    steps_to_start_discriminator: int = 200000
    use_stft_loss: bool = True
    use_subband_stft_loss: bool = False
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = False
    use_feat_match_loss: bool = False
    use_l1_spec_loss: bool = False
    stft_loss_weight: float = 0.5
    mse_G_loss_weight: float = 2.5
    grad_clip: list = field(default_factory=lambda: [10.0, 10.0])
    lr_gen: float = 0.0002
    lr_disc: float = 0.0002


@register_config_class("univnet")
@dataclass
class UnivnetConfig(BaseGANVocoderConfig):
    model: str = "univnet"
    batch_size: int = 32
    generator_model: str = "univnet_generator"
    discriminator_model: str = "univnet_discriminator"
    generator_model_params: dict = field(
        default_factory=lambda: {
            "in_channels": 64,
            "out_channels": 1,
            "hidden_channels": 32,
            "cond_channels": 80,
            "upsample_factors": [8, 8, 4],
            "lvc_layers_each_block": 4,
            "lvc_kernel_size": 3,
            "kpnet_hidden_channels": 64,
            "kpnet_conv_size": 3,
            "dropout": 0.0,
        }
    )
    seq_len: int = 8192
    pad_short: int = 2000
    use_noise_augment: bool = True
    use_stft_loss: bool = True
    use_subband_stft_loss: bool = False
    use_mse_gan_loss: bool = True
    use_hinge_gan_loss: bool = False
    use_feat_match_loss: bool = False
    use_l1_spec_loss: bool = False
    stft_loss_weight: float = 2.5
    mse_G_loss_weight: float = 1
    steps_to_start_discriminator: int = 200000
