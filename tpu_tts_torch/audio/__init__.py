"""The part of `tpu_tts.audio.AudioProcessor` that serving reads: the sample
rate, the hop length, `save_wav` (16-bit PCM through scipy), and the mel
`normalize`/`denormalize` of the signal-norm path that hands a TTS model's
mel to a vocoder (`tpu_tts/audio/processor.py:158-198`). The mean-variance
scaler (`stats_path`) and the spectrogram transforms come later (ROADMAP.md).
"""

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


def mulaw_decode(wav: np.ndarray, mulaw_qc: int) -> np.ndarray:
    """Inverse mu-law (`tpu_tts/audio/numpy_transforms.py:707`)."""
    mu = 2**mulaw_qc - 1
    return np.sign(wav) / mu * ((1 + mu) ** np.abs(wav) - 1)


class AudioProcessor:
    def __init__(self, sample_rate: int = 22050, hop_length: int = 256, num_mels: Optional[int] = None,
                 signal_norm=None, symmetric_norm=None, max_norm=None, clip_norm=True, min_level_db=None,
                 ref_level_db=None, stats_path=None, **_):
        if stats_path and signal_norm:
            raise NotImplementedError("mean-variance mel statistics (stats_path) are not ported yet (ROADMAP.md)")
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.num_mels = num_mels
        self.signal_norm = signal_norm
        self.symmetric_norm = symmetric_norm
        self.max_norm = 1.0 if max_norm is None else float(max_norm)
        self.clip_norm = clip_norm
        self.min_level_db = min_level_db or 0
        self.ref_level_db = ref_level_db

    @staticmethod
    def init_from_config(config) -> "AudioProcessor":
        return AudioProcessor(**config.audio.to_dict())

    def normalize(self, S: np.ndarray) -> np.ndarray:
        """dB mel `[C, T]` → the model's normalised range."""
        S = S.copy()
        if not self.signal_norm:
            return S
        S -= self.ref_level_db
        S_norm = (S - self.min_level_db) / (-self.min_level_db)
        if self.symmetric_norm:
            S_norm = ((2 * self.max_norm) * S_norm) - self.max_norm
            if self.clip_norm:
                S_norm = np.clip(S_norm, -self.max_norm, self.max_norm)
            return S_norm
        S_norm = self.max_norm * S_norm
        if self.clip_norm:
            S_norm = np.clip(S_norm, 0, self.max_norm)
        return S_norm

    def denormalize(self, S: np.ndarray) -> np.ndarray:
        """Inverse of `normalize`."""
        S_denorm = S.copy()
        if not self.signal_norm:
            return S_denorm
        if self.symmetric_norm:
            if self.clip_norm:
                S_denorm = np.clip(S_denorm, -self.max_norm, self.max_norm)
            S_denorm = ((S_denorm + self.max_norm) * -self.min_level_db / (2 * self.max_norm)) + self.min_level_db
            return S_denorm + self.ref_level_db
        if self.clip_norm:
            S_denorm = np.clip(S_denorm, 0, self.max_norm)
        S_denorm = (S_denorm * -self.min_level_db / self.max_norm) + self.min_level_db
        return S_denorm + self.ref_level_db

    def save_wav(self, wav: np.ndarray, path: str, sr: Optional[int] = None) -> None:
        scipy.io.wavfile.write(path, sr if sr else self.sample_rate, wav_to_pcm16(np.asarray(wav, dtype=np.float32)))
