"""The part of `tpu_tts.audio.AudioProcessor` that serving reads: the sample
rate, the hop length and `save_wav` (16-bit PCM through scipy). The full
processor comes with training (ROADMAP.md)."""

import io
from typing import Optional

import numpy as np
import scipy.io.wavfile


def wav_to_pcm16(wav: np.ndarray) -> np.ndarray:
    """Peak-normalised 16-bit PCM, as `tpu_tts.audio.numpy_transforms.save_wav`."""
    return (wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))).astype(np.int16)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, sample_rate, wav_to_pcm16(np.asarray(wav, dtype=np.float32)))
    return buf.getvalue()


class AudioProcessor:
    def __init__(self, sample_rate: int = 22050, hop_length: int = 256):
        self.sample_rate = sample_rate
        self.hop_length = hop_length

    @staticmethod
    def init_from_config(config) -> "AudioProcessor":
        a = config.audio
        return AudioProcessor(sample_rate=int(a["sample_rate"]), hop_length=int(a["hop_length"]))

    def save_wav(self, wav: np.ndarray, path: str, sr: Optional[int] = None) -> None:
        scipy.io.wavfile.write(path, sr if sr else self.sample_rate, wav_to_pcm16(np.asarray(wav, dtype=np.float32)))
