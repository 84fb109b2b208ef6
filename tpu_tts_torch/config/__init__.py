"""Config loading + model-name → config-class registry.

Mirrors Coqui TTS `TTS/config/__init__.py` (`load_config`:68, `register_config`:23,
`check_config_and_model_args`:103) with an explicit decorator registry instead of
module reflection.
"""

import json
import os
import re
from typing import Any, Dict, Type

from tpu_tts_torch.config.base import Coqpit
from tpu_tts_torch.config.shared_configs import (
    BaseAudioConfig,
    BaseDatasetConfig,
    BaseTrainingConfig,
    TrainerConfig,
)

_CONFIG_REGISTRY: Dict[str, Type[Coqpit]] = {}


def register_config_class(model_name: str):
    """Class decorator: register a config class under a model name."""

    def wrapper(cls):
        _CONFIG_REGISTRY[model_name.lower()] = cls
        return cls

    return wrapper


def _ensure_registry_populated() -> None:
    """Import the config modules so their decorators run (lazy to avoid cycles)."""
    import importlib

    importlib.import_module("tpu_tts_torch.configs")
    importlib.import_module("tpu_tts_torch.vocoder.configs")
    importlib.import_module("tpu_tts_torch.encoder.configs")


def register_config(model_name: str) -> Type[Coqpit]:
    """Find the config class for a model name (ref config/__init__.py:23)."""
    _ensure_registry_populated()
    key = model_name.lower()
    if key not in _CONFIG_REGISTRY:
        raise ModuleNotFoundError(f" [!] No config found for model `{model_name}`.")
    return _CONFIG_REGISTRY[key]


def read_json_with_comments(json_path: str) -> Dict[str, Any]:
    """Tolerant JSON reader stripping // and /* */ comments (backward compat)."""
    with open(json_path, "r", encoding="utf-8") as f:
        input_str = f.read()
    input_str = re.sub(
        r"(\"(?:[^\"\\]|\\.)*\")|(/\*(?:.|[\n\r])*?\*/)|(//.*)",
        lambda m: m.group(1) or "",
        input_str,
    )
    return json.loads(input_str)


def _process_model_name(config_dict: Dict) -> str:
    model_name = config_dict["model"] if "model" in config_dict else config_dict["generator_model"]
    return model_name.replace("_generator", "").replace("_discriminator", "")


def load_config(config_path: str) -> Coqpit:
    """Load a json/yaml config file and build the matching typed config
    (ref config/__init__.py:68)."""
    ext = os.path.splitext(config_path)[1]
    if ext in (".yml", ".yaml"):
        import yaml

        with open(config_path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f)
    elif ext == ".json":
        try:
            with open(config_path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except json.decoder.JSONDecodeError:
            data = read_json_with_comments(config_path)
    else:
        raise TypeError(f" [!] Unknown config file type {ext}")
    config_class = register_config(_process_model_name(data).lower())
    config = config_class()
    config.update(data)
    return config


def check_config_and_model_args(config: Coqpit, arg_name: str, value: Any) -> bool:
    """True iff `arg_name` equals `value` in `config.model_args` or `config`
    (ref config/__init__.py:103)."""
    if hasattr(config, "model_args") and config.model_args is not None and arg_name in config.model_args:
        return config.model_args[arg_name] == value
    if hasattr(config, arg_name):
        return config[arg_name] == value
    return False


def get_from_config_or_model_args(config: Coqpit, arg_name: str) -> Any:
    if hasattr(config, "model_args") and config.model_args is not None and arg_name in config.model_args:
        return config.model_args[arg_name]
    return config[arg_name]


def get_from_config_or_model_args_with_default(config: Coqpit, arg_name: str, def_val: Any) -> Any:
    if hasattr(config, "model_args") and config.model_args is not None and arg_name in config.model_args:
        return config.model_args[arg_name]
    if hasattr(config, arg_name):
        return config[arg_name]
    return def_val
