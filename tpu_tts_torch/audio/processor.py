"""`AudioProcessor`: the config-driven host-side audio façade of serving.

Counterpart of `tpu_tts/audio/processor.py` (`StandardScaler`:17,
`AudioProcessor`:42, `normalize`/`denormalize`:158-198, `load_stats`/
`setup_scaler`:201-222, `inv_spectrogram`/`inv_melspectrogram`:259-282,
`melspectrogram`:249, `compute_f0`:290, `find_endpoint`/`trim_silence`
:308-326, `sound_norm`/`rms_volume_norm`:328-335, `load_wav`:337,
`save_wav`:345), which follows Coqui TTS `TTS/utils/audio/processor.py`.
Built on the port's `numpy_transforms`; everything here runs on the host in
numpy, as in the JAX package. Griffin-Lim takes an optional `seed` (an int
or a `np.random.Generator`) for its first phases; the JAX processor never
passes one. The energy and quantisation helpers come with the models that
read them (ROADMAP.md, M8 and M9b).
"""

from typing import Dict, Optional, Tuple, Union

import numpy as np

from tpu_tts_torch.audio import numpy_transforms as nt

Seed = Union[None, int, np.random.Generator]


class StandardScaler:
    """Mean/std feature scaler of the mean-variance mel statistics."""

    def __init__(self, mean: np.ndarray = None, scale: np.ndarray = None):
        self.mean_ = mean
        self.scale_ = scale

    def transform(self, X):
        X = np.asarray(X)
        return (X - self.mean_) / self.scale_

    def inverse_transform(self, X):
        X = np.asarray(X)
        return X * self.scale_ + self.mean_


class AudioProcessor:
    """Normalisation of model mels, Griffin-Lim, silence trimming and wav I/O."""

    def __init__(
        self,
        sample_rate=None,
        resample=False,
        num_mels=None,
        log_func="np.log10",
        min_level_db=None,
        frame_shift_ms=None,
        frame_length_ms=None,
        hop_length=None,
        win_length=None,
        ref_level_db=None,
        fft_size=1024,
        power=None,
        preemphasis=0.0,
        signal_norm=None,
        symmetric_norm=None,
        max_norm=None,
        mel_fmin=None,
        mel_fmax=None,
        pitch_fmax=None,
        pitch_fmin=None,
        spec_gain=20,
        stft_pad_mode="reflect",
        clip_norm=True,
        griffin_lim_iters=None,
        do_trim_silence=False,
        trim_db=60,
        do_sound_norm=False,
        do_amp_to_db_linear=True,
        do_amp_to_db_mel=True,
        do_rms_norm=False,
        db_level=None,
        stats_path=None,
        verbose=False,
        **_,
    ):
        self.sample_rate = sample_rate
        self.resample = resample
        self.num_mels = num_mels
        self.log_func = log_func
        self.min_level_db = min_level_db or 0
        self.frame_shift_ms = frame_shift_ms
        self.frame_length_ms = frame_length_ms
        self.ref_level_db = ref_level_db
        self.fft_size = fft_size
        self.power = power
        self.preemphasis = preemphasis
        self.griffin_lim_iters = griffin_lim_iters
        self.signal_norm = signal_norm
        self.symmetric_norm = symmetric_norm
        self.mel_fmin = mel_fmin or 0
        self.mel_fmax = mel_fmax
        self.pitch_fmin = pitch_fmin
        self.pitch_fmax = pitch_fmax
        self.spec_gain = float(spec_gain)
        self.stft_pad_mode = stft_pad_mode
        self.max_norm = 1.0 if max_norm is None else float(max_norm)
        self.clip_norm = clip_norm
        self.do_trim_silence = do_trim_silence
        self.trim_db = trim_db
        self.do_sound_norm = do_sound_norm
        self.do_amp_to_db_linear = do_amp_to_db_linear
        self.do_amp_to_db_mel = do_amp_to_db_mel
        self.do_rms_norm = do_rms_norm
        self.db_level = db_level
        self.stats_path = stats_path
        if log_func == "np.log":
            self.base = np.e
        elif log_func == "np.log10":
            self.base = 10
        else:
            raise ValueError(" [!] unknown `log_func` value.")
        if hop_length is None:
            self.win_length, self.hop_length = nt.millisec_to_length(
                frame_length_ms=self.frame_length_ms, frame_shift_ms=self.frame_shift_ms, sample_rate=self.sample_rate
            )
        else:
            self.hop_length = hop_length
            self.win_length = win_length
        assert min_level_db != 0.0, " [!] min_level_db is 0"
        assert self.win_length <= self.fft_size, (
            f" [!] win_length cannot be larger than fft_size - {self.win_length} vs {self.fft_size}"
        )
        if verbose:
            print(" > Setting up Audio Processor...")
            for key, value in vars(self).items():
                print(f" | > {key}:{value}")
        self.mel_basis = nt.build_mel_basis(
            sample_rate=self.sample_rate, fft_size=self.fft_size, num_mels=self.num_mels,
            mel_fmax=self.mel_fmax, mel_fmin=self.mel_fmin,
        )
        if stats_path and signal_norm:
            mel_mean, mel_std, linear_mean, linear_std, _ = self.load_stats(stats_path)
            self.setup_scaler(mel_mean, mel_std, linear_mean, linear_std)
            self.signal_norm = True
            self.max_norm = None
            self.clip_norm = None
            self.symmetric_norm = None

    @staticmethod
    def init_from_config(config, verbose=False) -> "AudioProcessor":
        if "audio" in config:
            return AudioProcessor(verbose=verbose, **config.audio.to_dict())
        return AudioProcessor(verbose=verbose, **config.to_dict())

    # ---- normalisation ------------------------------------------------------
    def normalize(self, S: np.ndarray) -> np.ndarray:
        """dB spectrogram `[C, T]` → the model's normalised range."""
        S = S.copy()
        if not self.signal_norm:
            return S
        if hasattr(self, "mel_scaler"):
            if S.shape[0] == self.num_mels:
                return self.mel_scaler.transform(S.T).T
            if S.shape[0] == self.fft_size / 2:
                return self.linear_scaler.transform(S.T).T
            raise RuntimeError(" [!] Mean-Var stats does not match the given feature dimensions.")
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
        if hasattr(self, "mel_scaler"):
            if S_denorm.shape[0] == self.num_mels:
                return self.mel_scaler.inverse_transform(S_denorm.T).T
            if S_denorm.shape[0] == self.fft_size / 2:
                return self.linear_scaler.inverse_transform(S_denorm.T).T
            raise RuntimeError(" [!] Mean-Var stats does not match the given feature dimensions.")
        if self.symmetric_norm:
            if self.clip_norm:
                S_denorm = np.clip(S_denorm, -self.max_norm, self.max_norm)
            S_denorm = ((S_denorm + self.max_norm) * -self.min_level_db / (2 * self.max_norm)) + self.min_level_db
            return S_denorm + self.ref_level_db
        if self.clip_norm:
            S_denorm = np.clip(S_denorm, 0, self.max_norm)
        S_denorm = (S_denorm * -self.min_level_db / self.max_norm) + self.min_level_db
        return S_denorm + self.ref_level_db

    # ---- mean-variance statistics --------------------------------------------
    def load_stats(self, stats_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, Dict]:
        """The `.npy` statistics file of `compute_statistics`: a pickled dict of
        `mel_mean`, `mel_std`, `linear_mean`, `linear_std` and the
        `audio_config` they were taken with, which must match this one."""
        stats = np.load(stats_path, allow_pickle=True).item()
        mel_mean = stats["mel_mean"]
        mel_std = stats["mel_std"]
        linear_mean = stats["linear_mean"]
        linear_std = stats["linear_std"]
        stats_config = stats["audio_config"]
        skip = ["griffin_lim_iters", "stats_path", "do_trim_silence", "ref_level_db", "power"]
        for key, val in stats_config.items():
            if key in skip or key in ("sample_rate", "trim_db"):
                continue
            if hasattr(self, key):
                assert getattr(self, key) == val, (
                    f" [!] Audio param {key} does not match the value used for computing mean-var stats. "
                    f"{getattr(self, key)} vs {val}"
                )
        return mel_mean, mel_std, linear_mean, linear_std, stats_config

    def setup_scaler(self, mel_mean, mel_std, linear_mean, linear_std) -> None:
        self.mel_scaler = StandardScaler(mel_mean, mel_std)
        self.linear_scaler = StandardScaler(linear_mean, linear_std)

    # ---- Griffin-Lim ----------------------------------------------------------------
    def apply_inv_preemphasis(self, x: np.ndarray) -> np.ndarray:
        return nt.deemphasis(x=x, coef=self.preemphasis)

    def inv_mel_magnitudes(self, mel_spectrogram: np.ndarray) -> np.ndarray:
        """The linear magnitudes, raised to `power`, that Griffin-Lim phases in
        `inv_melspectrogram`."""
        S = nt.db_to_amp(x=self.denormalize(mel_spectrogram), gain=self.spec_gain, base=self.base)
        return nt.mel_to_spec(mel=S, mel_basis=self.mel_basis) ** self.power

    def inv_spectrogram(self, spectrogram: np.ndarray, seed: Seed = None) -> np.ndarray:
        S = nt.db_to_amp(x=self.denormalize(spectrogram), gain=self.spec_gain, base=self.base)
        W = self._griffin_lim(S**self.power, seed)
        return self.apply_inv_preemphasis(W) if self.preemphasis != 0 else W

    def inv_melspectrogram(self, mel_spectrogram: np.ndarray, seed: Seed = None) -> np.ndarray:
        W = self._griffin_lim(self.inv_mel_magnitudes(mel_spectrogram), seed)
        return self.apply_inv_preemphasis(W) if self.preemphasis != 0 else W

    def _griffin_lim(self, S, seed: Seed = None):
        return nt.griffin_lim(spec=S, num_iter=self.griffin_lim_iters, seed=seed, hop_length=self.hop_length,
                              win_length=self.win_length, fft_size=self.fft_size, pad_mode=self.stft_pad_mode)

    # ---- mel spectrogram (the training data path) ------------------------------------
    def melspectrogram(self, y: np.ndarray) -> np.ndarray:
        """Waveform → normalised mel spectrogram `[num_mels, T]`."""
        if self.preemphasis != 0:
            y = nt.preemphasis(x=y, coef=self.preemphasis)
        D = nt.stft(y=y, fft_size=self.fft_size, hop_length=self.hop_length, win_length=self.win_length,
                    pad_mode=self.stft_pad_mode)
        S = nt.spec_to_mel(spec=np.abs(D), mel_basis=self.mel_basis)
        if self.do_amp_to_db_mel:
            S = nt.amp_to_db(x=S, gain=self.spec_gain, base=self.base)
        return self.normalize(S).astype(np.float32)

    def compute_f0(self, x: np.ndarray) -> np.ndarray:
        """pyin F0 `[T_mel]` of a waveform, 0 where unvoiced; a length that is
        a multiple of the hop is padded by hop/2 first, as `tpu_tts`'s."""
        if len(x) % self.hop_length == 0:
            x = np.pad(x, (0, self.hop_length // 2), mode=self.stft_pad_mode)
        return nt.compute_f0(x=x, pitch_fmax=self.pitch_fmax, pitch_fmin=self.pitch_fmin, hop_length=self.hop_length,
                             win_length=self.win_length, sample_rate=self.sample_rate,
                             stft_pad_mode=self.stft_pad_mode, center=True)

    # ---- silence and volume ----------------------------------------------------------
    def find_endpoint(self, wav: np.ndarray, min_silence_sec=0.8) -> int:
        return nt.find_endpoint(wav=wav, trim_db=self.trim_db, sample_rate=self.sample_rate,
                                min_silence_sec=min_silence_sec, gain=self.spec_gain, base=self.base)

    def trim_silence(self, wav: np.ndarray) -> np.ndarray:
        return nt.trim_silence(wav=wav, sample_rate=self.sample_rate, trim_db=self.trim_db,
                               win_length=self.win_length, hop_length=self.hop_length)

    @staticmethod
    def sound_norm(x: np.ndarray) -> np.ndarray:
        return nt.volume_norm(x=x)

    def rms_volume_norm(self, x: np.ndarray, db_level: Optional[float] = None) -> np.ndarray:
        return nt.rms_volume_norm(x=x, db_level=self.db_level if db_level is None else db_level)

    # ---- I/O -------------------------------------------------------------------------
    def load_wav(self, filename: str, sr: Optional[int] = None) -> np.ndarray:
        """A wav file as float32, resampled to `sr` or (with `resample`) the
        configured rate, then trimmed and normalised as configured."""
        if sr is not None:
            x = nt.load_wav(filename=filename, sample_rate=sr, resample=True)
        else:
            x = nt.load_wav(filename=filename, sample_rate=self.sample_rate, resample=self.resample)
        if self.do_trim_silence:
            try:
                x = self.trim_silence(x)
            except ValueError:
                print(f" [!] File cannot be trimmed for silence - {filename}")
        if self.do_sound_norm:
            x = self.sound_norm(x)
        if self.do_rms_norm:
            x = self.rms_volume_norm(x, self.db_level)
        return x

    def save_wav(self, wav: np.ndarray, path: str, sr: Optional[int] = None, pipe_out=None) -> None:
        nt.save_wav(wav=np.asarray(wav, dtype=np.float32), path=path, sample_rate=sr if sr else self.sample_rate,
                    pipe_out=pipe_out)

