"""Host-side audio of the port: `AudioProcessor` (`processor.py`), the numpy
DSP under it (`numpy_transforms.py`), and the WAV bytes the server sends."""

import io

import numpy as np

from tpu_tts_torch.audio.processor import AudioProcessor, StandardScaler


def wav_to_pcm16(wav: np.ndarray) -> np.ndarray:
    """Peak-normalised 16-bit PCM, as `tpu_tts.audio.numpy_transforms.save_wav`."""
    return (wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))).astype(np.int16)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    import scipy.io.wavfile

    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, sample_rate, wav_to_pcm16(np.asarray(wav, dtype=np.float32)))
    return buf.getvalue()


def mulaw_decode(wav: np.ndarray, mulaw_qc: int) -> np.ndarray:
    """Inverse mu-law (`tpu_tts/audio/numpy_transforms.py:707`)."""
    mu = 2**mulaw_qc - 1
    return np.sign(wav) / mu * ((1 + mu) ** np.abs(wav) - 1)


__all__ = ["AudioProcessor", "StandardScaler", "mulaw_decode", "wav_bytes", "wav_to_pcm16"]
