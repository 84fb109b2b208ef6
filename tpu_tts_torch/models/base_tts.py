"""Base of the port's TTS models: config, audio settings, tokenizer, device
and checkpoint loading. Counterpart of `tpu_tts/models/base_tts.py`; the
training contract comes with training (ROADMAP.md)."""

from typing import Optional

import torch

from tpu_tts_torch.device import resolve_device


class BaseTTSModel:
    def __init__(self, config, ap=None, tokenizer=None, device: Optional[str] = None):
        self.config = config
        self.ap = ap
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.net: torch.nn.Module = None

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """Load a torch `state_dict` file saved from `self.net`."""
        state = torch.load(checkpoint_path, map_location=self.device, weights_only=True)
        self.net.load_state_dict(state, strict=strict)
        if eval:
            self.net.eval()
        return state
