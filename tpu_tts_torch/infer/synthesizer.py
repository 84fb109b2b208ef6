"""Synthesizer: checkpoint + config (+ vocoder) → text-to-speech on a device.

Counterpart of `tpu_tts/infer/synthesizer.py` (`Synthesizer`:19,
`_load_vocoder`:80, `tts`:176 with its vocoder stage :247-254,
`_interpolate_mel`:272). Checkpoints are torch `state_dict` files of the
model's net beside its `config.json`. An end-to-end model (VITS) gives the
waveform; a mel model (Glow-TTS) hands its mel to the vocoder (WaveRNN)
through the audio configs' denormalize → normalize handshake, resampled in
time when the two sample rates differ. Sentences are synthesised one by one
and joined with 10000 samples of silence, as in the JAX synthesizer.

The vocoder's waveform is taken as the 1-D array WaveRNN returns; the JAX
synthesizer indexes it `[0, :, 0]` and so fails with WaveRNN (ROADMAP.md,
queue 3).
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
    def __init__(self, tts_checkpoint: str = "", tts_config_path: str = "", vocoder_checkpoint: str = "",
                 vocoder_config: str = "", device=None) -> None:
        self.device = resolve_device(device)
        self.tts_model = None
        self.tts_config = None
        self.vocoder_model = None
        self.vocoder_config = None
        self.output_sample_rate = 22050
        if tts_checkpoint:
            self._load_tts(tts_checkpoint, tts_config_path)
        if vocoder_checkpoint:
            self._load_vocoder(vocoder_checkpoint, vocoder_config)

    def _load_tts(self, checkpoint: str, config_path: str) -> None:
        from tpu_tts_torch.models import setup_model

        self.tts_config = load_config(config_path)
        self.tts_model = setup_model(self.tts_config, device=self.device)
        self.tts_model.load_checkpoint(self.tts_config, checkpoint, eval=True)
        self.output_sample_rate = self.tts_config.audio["sample_rate"]

    def _load_vocoder(self, checkpoint: str, config_path: str) -> None:
        from tpu_tts_torch.audio import AudioProcessor
        from tpu_tts_torch.vocoder.models import setup_model as setup_vocoder

        self.vocoder_config = load_config(config_path)
        self.vocoder_ap = AudioProcessor.init_from_config(self.vocoder_config)
        self.vocoder_model = setup_vocoder(self.vocoder_config, device=self.device)
        self.vocoder_model.load_checkpoint(self.vocoder_config, checkpoint, eval=True)
        self.output_sample_rate = self.vocoder_config.audio["sample_rate"]

    def split_into_sentences(self, text: str) -> List[str]:
        return split_sentences(text)

    def save_wav(self, wav, path: str) -> None:
        self.tts_model.ap.save_wav(np.asarray(wav, dtype=np.float32), path, self.output_sample_rate)

    def vocode(self, mel: np.ndarray) -> np.ndarray:
        """A TTS model's normalised mel `[T, C]` → the vocoder's waveform."""
        if self.vocoder_model is None:
            raise NotImplementedError("Griffin-Lim is not ported yet: serve a mel model with a vocoder (ROADMAP.md)")
        mel_denorm = self.tts_model.ap.denormalize(mel.T).T
        vocoder_input = self.vocoder_ap.normalize(mel_denorm.T).T
        scale_factor = self.vocoder_config.audio["sample_rate"] / self.tts_config.audio["sample_rate"]
        if scale_factor != 1.0:
            vocoder_input = _interpolate_mel(vocoder_input, scale_factor)
        return self.vocoder_model.inference(vocoder_input.astype(np.float32))

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
            wav = outputs["wav"] if outputs["wav"] is not None else self.vocode(outputs["model_outputs"])
            wavs += list(wav)
            wavs += [0.0] * SENTENCE_GAP
        process_time = time.time() - start
        audio_time = len(wavs) / self.output_sample_rate
        print(f" > Processing time: {process_time}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-9)}")
        return wavs


def _interpolate_mel(mel: np.ndarray, scale_factor: float) -> np.ndarray:
    """Linear interpolation of a mel `[T, C]` along time by `scale_factor`."""
    T, C = mel.shape
    new_T = int(round(T * scale_factor))
    x_old = np.linspace(0, 1, T)
    x_new = np.linspace(0, 1, new_T)
    return np.stack([np.interp(x_new, x_old, mel[:, c]) for c in range(C)], axis=1)
