"""Synthesizer: checkpoint + config → text-to-speech on a device.

Counterpart of `tpu_tts/infer/synthesizer.py` (`Synthesizer`:19, `tts`:176)
for a VITS checkpoint: a torch `state_dict` file of `VitsNet` beside its
`config.json`. Sentences are synthesised one by one and joined with 10000
samples of silence, as in the JAX synthesizer.
"""

import time
from typing import List

import numpy as np

from tpu_tts_torch.config import load_config
from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.infer.synthesis import synthesis
from tpu_tts_torch.text.sentence_split import split_sentences

SENTENCE_GAP = 10000  # samples of silence after each sentence


class Synthesizer:
    def __init__(self, tts_checkpoint: str = "", tts_config_path: str = "", device=None) -> None:
        self.device = resolve_device(device)
        self.tts_model = None
        self.tts_config = None
        self.output_sample_rate = 22050
        if tts_checkpoint:
            self._load_tts(tts_checkpoint, tts_config_path)

    def _load_tts(self, checkpoint: str, config_path: str) -> None:
        from tpu_tts_torch.models import setup_model

        self.tts_config = load_config(config_path)
        self.tts_model = setup_model(self.tts_config, device=self.device)
        self.tts_model.load_checkpoint(self.tts_config, checkpoint, eval=True)
        self.output_sample_rate = self.tts_config.audio["sample_rate"]

    def split_into_sentences(self, text: str) -> List[str]:
        return split_sentences(text)

    def save_wav(self, wav, path: str) -> None:
        self.tts_model.ap.save_wav(np.asarray(wav, dtype=np.float32), path, self.output_sample_rate)

    def tts(self, text: str = "", speaker_name: str = "", language_name: str = "", split_sentences: bool = True,
            **kwargs) -> List[float]:
        if not text:
            raise ValueError("You need to define `text` to synthesize.")
        if speaker_name or language_name:
            raise NotImplementedError("speaker and language selection is not ported yet (ROADMAP.md, queue 1)")
        start = time.time()
        sens = self.split_into_sentences(text) if split_sentences else [text]
        wavs: List[float] = []
        for sen in sens:
            outputs = synthesis(self.tts_model, sen, self.tts_config)
            wavs += list(outputs["wav"])
            wavs += [0.0] * SENTENCE_GAP
        process_time = time.time() - start
        audio_time = len(wavs) / self.output_sample_rate
        print(f" > Processing time: {process_time}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-9)}")
        return wavs
