"""Base of the port's TTS models: config, audio settings, tokenizer, device,
speaker/language managers and checkpoint loading (`utils/checkpoint.py`).

Counterpart of `tpu_tts/models/base_tts.py`. The training contract comes
with training (ROADMAP.md).
"""

from typing import Optional

import torch

from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.utils.checkpoint import load_net_checkpoint


class BaseTTSModel:
    def __init__(self, config, ap=None, tokenizer=None, device: Optional[str] = None):
        self.config = config
        self.ap = ap
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.net: torch.nn.Module = None
        # multi-speaker and multi-language models come with M5c (ROADMAP.md)
        self.speaker_manager = None
        self.language_manager = None

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """Load a `.pth` file into `self.net`: the port's `state_dict`, or a
        Coqui-format checkpoint (`{"model": ...}` or flat)."""
        ckpt = load_net_checkpoint(self.net, checkpoint_path, strict=strict)
        if eval:
            self.net.eval()
        return ckpt
