"""Shared config dataclasses: audio, dataset, trainer and base training configs.

Mirrors the surface of Coqui TTS `TTS/config/shared_configs.py` (BaseAudioConfig:9,
BaseDatasetConfig:192, BaseTrainingConfig:249) plus the fields of the external
Coqui ``trainer.TrainerConfig`` the reference inherits — rebuilt here because this
JAX package ships its own trainer. The port reads only the inference fields;
the rest keep a config.json written by either package loadable.
"""

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from tpu_tts_torch.config.base import Coqpit, check_argument


@dataclass
class BaseAudioConfig(Coqpit):
    """Audio/featurization parameters consumed by `AudioProcessor`."""

    # stft
    fft_size: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    frame_shift_ms: Optional[int] = None
    frame_length_ms: Optional[int] = None
    stft_pad_mode: str = "reflect"
    # audio
    sample_rate: int = 22050
    resample: bool = False
    preemphasis: float = 0.0
    ref_level_db: int = 20
    do_sound_norm: bool = False
    log_func: str = "np.log10"
    do_trim_silence: bool = True
    trim_db: int = 45
    do_rms_norm: bool = False
    db_level: Optional[float] = None
    # griffin-lim
    power: float = 1.5
    griffin_lim_iters: int = 60
    # mel
    num_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    spec_gain: int = 20
    do_amp_to_db_linear: bool = True
    do_amp_to_db_mel: bool = True
    # f0
    pitch_fmax: float = 640.0
    pitch_fmin: float = 1.0
    # normalization
    signal_norm: bool = True
    min_level_db: int = -100
    symmetric_norm: bool = True
    max_norm: float = 4.0
    clip_norm: bool = True
    stats_path: Optional[str] = None

    def check_values(self):
        c = asdict(self)
        check_argument("num_mels", c, restricted=True, min_val=10, max_val=2056)
        check_argument("fft_size", c, restricted=True, min_val=128, max_val=4058)
        check_argument("sample_rate", c, restricted=True, min_val=512, max_val=100000)
        check_argument("frame_length_ms", c, restricted=True, min_val=10, max_val=1000, allow_none=True)
        check_argument("frame_shift_ms", c, restricted=True, min_val=1, max_val=1000, allow_none=True)
        check_argument("preemphasis", c, restricted=True, min_val=0, max_val=1)
        check_argument("min_level_db", c, restricted=True, min_val=-1000, max_val=10)
        check_argument("ref_level_db", c, restricted=True, min_val=0, max_val=1000)
        check_argument("power", c, restricted=True, min_val=1, max_val=5)
        check_argument("griffin_lim_iters", c, restricted=True, min_val=10, max_val=1000)


@dataclass
class BaseDatasetConfig(Coqpit):
    """One dataset entry: formatter name + paths + language metadata."""

    formatter: str = ""
    dataset_name: str = ""
    path: str = ""
    meta_file_train: str = ""
    ignored_speakers: Optional[List[str]] = None
    language: str = ""
    phonemizer: str = ""
    meta_file_val: str = ""
    meta_file_attn_mask: str = ""

    def check_values(self):
        c = asdict(self)
        check_argument("formatter", c, restricted=True)
        check_argument("path", c, restricted=True)
        check_argument("meta_file_train", c, restricted=True)


@dataclass
class TrainerConfig(Coqpit):
    """Trainer-level knobs (the reference pulls these from the external
    ``trainer`` package; this framework implements them in tpu_tts/train)."""

    # run metadata
    output_path: str = "output"
    logger_uri: Optional[str] = None
    run_name: str = "run"
    project_name: Optional[str] = None
    run_description: str = "🐸tpu-tts run"
    # logging
    print_step: int = 25
    plot_step: int = 100
    model_param_stats: bool = False
    wandb_entity: Optional[str] = None
    dashboard_logger: str = "tensorboard"
    save_on_interrupt: bool = True
    log_model_step: Optional[int] = None
    # checkpointing
    save_step: int = 10000
    save_n_checkpoints: int = 5
    save_checkpoints: bool = True
    save_all_best: bool = False
    save_best_after: int = 0
    target_loss: Optional[str] = None
    # eval
    print_eval: bool = False
    run_eval: bool = True
    run_eval_steps: Optional[int] = None
    test_delay_epochs: int = 0
    # training
    epochs: int = 1000
    batch_size: int = 32
    eval_batch_size: int = 16
    grad_clip: float = 0.0
    scheduler_after_epoch: bool = True
    lr: float = 0.001
    optimizer: Optional[str] = None
    optimizer_params: Dict[str, Any] = field(default_factory=dict)
    lr_scheduler: Optional[str] = None
    lr_scheduler_params: Dict[str, Any] = field(default_factory=dict)
    use_grad_scaler: bool = False
    allow_tf32: bool = False
    cudnn_enable: bool = True  # accepted for config compat
    cudnn_deterministic: bool = False
    cudnn_benchmark: bool = False
    training_seed: int = 54321
    # precision: "f32" or "bf16" compute
    mixed_precision: bool = False
    precision: str = "bf16"
    # distributed (accepted for compat)
    distributed_backend: str = "jax"
    distributed_url: str = ""
    # shape bucketing (training data loader)
    shape_bucket_text: Optional[List[int]] = None
    shape_bucket_frames: Optional[List[int]] = None
    # profiler trace window (training)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_end_step: int = 15


@dataclass
class BaseTrainingConfig(TrainerConfig):
    """Shared training config for all models (ref shared_configs.py:249)."""

    model: Optional[str] = None
    num_loader_workers: int = 0
    num_eval_loader_workers: int = 0
    use_noise_augment: bool = False
