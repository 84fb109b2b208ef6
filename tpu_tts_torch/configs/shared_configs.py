"""Shared TTS model configs (mirror of Coqui TTS `TTS/`tts/configs/
shared_configs.py: GSTConfig:10, CapacitronVAEConfig:52, BaseTTSConfig:156)."""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_tts_torch.config.base import Coqpit
from tpu_tts_torch.config.shared_configs import BaseAudioConfig, BaseDatasetConfig, BaseTrainingConfig
from tpu_tts_torch.text.characters import CharactersConfig


@dataclass
class GSTConfig(Coqpit):
    """Global style token module config."""

    gst_style_input_wav: Optional[str] = None
    gst_style_input_weights: Optional[dict] = None
    gst_embedding_dim: int = 256
    gst_use_speaker_embedding: bool = False
    gst_num_heads: int = 4
    gst_num_style_tokens: int = 10


@dataclass
class CapacitronVAEConfig(Coqpit):
    """Capacitron prosody-VAE module config."""

    capacitron_loss_alpha: int = 1
    capacitron_capacity: int = 150
    capacitron_VAE_embedding_dim: int = 128
    capacitron_use_text_summary_embeddings: bool = True
    capacitron_text_summary_embedding_dim: int = 128
    capacitron_use_speaker_embedding: bool = False
    capacitron_VAE_loss_alpha: float = 0.25
    capacitron_grad_clip: float = 5.0


@dataclass
class BaseTTSConfig(BaseTrainingConfig):
    """Shared config for all `tts` models."""

    audio: BaseAudioConfig = field(default_factory=BaseAudioConfig)
    # phoneme settings
    use_phonemes: bool = False
    phonemizer: Optional[str] = None
    phoneme_language: Optional[str] = None
    compute_input_seq_cache: bool = False
    text_cleaner: Optional[str] = None
    enable_eos_bos_chars: bool = False
    test_sentences_file: str = ""
    phoneme_cache_path: Optional[str] = None
    # vocabulary parameters
    characters: Optional[CharactersConfig] = None
    add_blank: bool = False
    # training params
    batch_group_size: int = 0
    loss_masking: Optional[bool] = None
    # dataloading
    min_audio_len: int = 1
    max_audio_len: float = float("inf")
    min_text_len: int = 1
    max_text_len: float = float("inf")
    compute_f0: bool = False
    compute_energy: bool = False
    compute_linear_spec: bool = False
    precompute_num_workers: int = 0
    use_noise_augment: bool = False
    start_by_longest: bool = False
    shuffle: bool = True
    drop_last: bool = False
    # dataset
    datasets: List[BaseDatasetConfig] = field(default_factory=lambda: [BaseDatasetConfig()])
    # optimizer
    optimizer: str = "radam"
    optimizer_params: Optional[dict] = None
    lr_scheduler: Optional[str] = None
    lr_scheduler_params: dict = field(default_factory=dict)
    # testing
    test_sentences: List[str] = field(default_factory=list)
    # evaluation
    eval_split_max_size: Optional[int] = None
    eval_split_size: float = 0.01
    # weighted samplers
    use_speaker_weighted_sampler: bool = False
    speaker_weighted_sampler_alpha: float = 1.0
    use_language_weighted_sampler: bool = False
    language_weighted_sampler_alpha: float = 1.0
    use_length_weighted_sampler: bool = False
    length_weighted_sampler_alpha: float = 1.0
