"""Speaker and emotion encoder configs: a copy of `tpu_tts/encoder/configs.py`
(Coqui's `TTS/encoder/configs/{base_encoder_config,speaker_encoder_config,
emotion_encoder_config}.py`), registered under the same model names."""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_tts_torch.config import register_config_class
from tpu_tts_torch.config.shared_configs import BaseAudioConfig, BaseDatasetConfig, BaseTrainingConfig


@dataclass
class BaseEncoderConfig(BaseTrainingConfig):
    model: Optional[str] = None
    audio: BaseAudioConfig = field(default_factory=BaseAudioConfig)
    datasets: List[BaseDatasetConfig] = field(default_factory=lambda: [BaseDatasetConfig()])
    # model params
    model_params: Dict = field(
        default_factory=lambda: {
            "model_name": "lstm",
            "input_dim": 80,
            "proj_dim": 256,
            "lstm_dim": 768,
            "num_lstm_layers": 3,
            "use_lstm_with_projection": True,
        }
    )
    audio_augmentation: Dict = field(default_factory=dict)
    # training
    epochs: int = 10000
    loss: str = "angleproto"
    grad_clip: float = 3.0
    lr: float = 0.0001
    optimizer: str = "radam"
    optimizer_params: Dict = field(default_factory=lambda: {"betas": [0.9, 0.999], "weight_decay": 0})
    lr_decay: bool = False
    warmup_steps: int = 4000
    # logging
    tb_model_param_stats: bool = False
    steps_plot_stats: int = 10
    save_step: int = 1000
    print_step: int = 20
    run_eval: bool = False
    # data
    num_classes_in_batch: int = 32
    num_utter_per_class: int = 10
    eval_num_classes_in_batch: Optional[int] = None
    eval_num_utter_per_class: Optional[int] = None
    voice_len: float = 1.6


@register_config_class("speaker_encoder")
@dataclass
class SpeakerEncoderConfig(BaseEncoderConfig):
    model: str = "speaker_encoder"
    class_name_key: str = "speaker_name"


@register_config_class("emotion_encoder")
@dataclass
class EmotionEncoderConfig(BaseEncoderConfig):
    model: str = "emotion_encoder"
    class_name_key: str = "emotion_name"
    map_classid_to_classname: Dict = field(default_factory=dict)
