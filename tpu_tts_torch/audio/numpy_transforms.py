"""Host-side numpy DSP of serving: mel filterbank, STFT/iSTFT, Griffin-Lim,
dB scaling, pre-emphasis, silence detection and trimming, and wav I/O.

Counterpart of `tpu_tts/audio/numpy_transforms.py`, which re-implements
Coqui TTS `TTS/utils/audio/numpy_transforms.py` on numpy + scipy without
librosa (Slaney mel scale and norm, centred reflect-padded STFT). These run
on the host in both packages: Griffin-Lim is no TPU kernel and gets no CUDA
kernel. `pyin` and `compute_f0` are copies of the JAX module's, the pitch
targets of DelightfulTTS training; its energy and quantisation helpers come
with the models that read them (ROADMAP.md).

All functions take keyword-only arguments and swallow extra `**kwargs`, so
a whole audio-config dict can be splatted in, as in the JAX module.
"""

from io import BytesIO
from typing import Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Mel scale (Slaney variant — librosa.filters.mel default)
# ---------------------------------------------------------------------------

_MEL_HIGH_FREQ_Q = 27.0 / np.log(6.4)
_MEL_BREAK_HZ = 1000.0
_MEL_SCALE = 200.0 / 3.0  # linear region slope: mels per Hz below 1 kHz


def hz_to_mel(freq, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    mels = freq / _MEL_SCALE
    min_log_mel = _MEL_BREAK_HZ / _MEL_SCALE
    log_region = freq >= _MEL_BREAK_HZ
    if np.ndim(mels):
        mels = np.where(
            log_region,
            min_log_mel + np.log(np.maximum(freq, 1e-10) / _MEL_BREAK_HZ) * _MEL_HIGH_FREQ_Q,
            mels,
        )
    elif log_region:
        mels = min_log_mel + np.log(freq / _MEL_BREAK_HZ) * _MEL_HIGH_FREQ_Q
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = mels * _MEL_SCALE
    min_log_mel = _MEL_BREAK_HZ / _MEL_SCALE
    log_region = mels >= min_log_mel
    if np.ndim(freqs):
        freqs = np.where(log_region, _MEL_BREAK_HZ * np.exp((mels - min_log_mel) / _MEL_HIGH_FREQ_Q), freqs)
    elif log_region:
        freqs = _MEL_BREAK_HZ * np.exp((mels - min_log_mel) / _MEL_HIGH_FREQ_Q)
    return freqs


def mel_filterbank(
    *,
    sample_rate: int,
    fft_size: int,
    num_mels: int,
    mel_fmin: float = 0.0,
    mel_fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    **kwargs,
) -> np.ndarray:
    """Triangular mel filterbank, shape `[num_mels, fft_size//2 + 1]`.

    Matches `librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)` (the call the
    Coqui makes in `numpy_transforms.py`:32 and `vits.py`:154) bit-for-bit in
    float64 up to rounding.
    """
    if mel_fmax is None:
        mel_fmax = float(sample_rate) / 2
    fftfreqs = np.linspace(0, float(sample_rate) / 2, int(1 + fft_size // 2), dtype=np.float64)
    mel_pts = np.linspace(hz_to_mel(mel_fmin, htk), hz_to_mel(mel_fmax, htk), num_mels + 2)
    mel_f = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : num_mels + 2] - mel_f[:num_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def build_mel_basis(
    *,
    sample_rate: int = None,
    fft_size: int = None,
    num_mels: int = None,
    mel_fmax: Optional[float] = None,
    mel_fmin: float = 0.0,
    **kwargs,
) -> np.ndarray:
    """Coqui-compatible alias (Coqui `numpy_transforms.py`:15)."""
    if mel_fmax is not None:
        assert mel_fmax <= sample_rate // 2
        assert mel_fmax - mel_fmin > 0
    return mel_filterbank(
        sample_rate=sample_rate, fft_size=fft_size, num_mels=num_mels, mel_fmin=mel_fmin, mel_fmax=mel_fmax
    )


def millisec_to_length(
    *, frame_length_ms: int = None, frame_shift_ms: int = None, sample_rate: int = None, **kwargs
) -> Tuple[int, int]:
    """hop/win length from milliseconds (numpy_transforms.py:35)."""
    factor = frame_length_ms / frame_shift_ms
    assert factor.is_integer(), " [!] frame_shift_ms should divide frame_length_ms"
    win_length = int(frame_length_ms / 1000.0 * sample_rate)
    hop_length = int(win_length / float(factor))
    return win_length, hop_length


# ---------------------------------------------------------------------------
# dB scaling
# ---------------------------------------------------------------------------

def _log(x, base):
    return np.log10(x) if base == 10 else np.log(x)


def _exp(x, base):
    return np.power(10, x) if base == 10 else np.exp(x)


def amp_to_db(*, x: np.ndarray = None, gain: float = 1, base: int = 10, **kwargs) -> np.ndarray:
    assert (x < 0).sum() == 0, " [!] Input values must be non-negative."
    return gain * _log(np.maximum(1e-8, x), base)


def db_to_amp(*, x: np.ndarray = None, gain: float = 1, base: int = 10, **kwargs) -> np.ndarray:
    return _exp(x / gain, base)


# ---------------------------------------------------------------------------
# Pre-emphasis
# ---------------------------------------------------------------------------

def preemphasis(*, x: np.ndarray, coef: float = 0.97, **kwargs) -> np.ndarray:
    if coef == 0:
        raise RuntimeError(" [!] Preemphasis is set 0.0.")
    import scipy.signal

    return scipy.signal.lfilter([1, -coef], [1], x)


def deemphasis(*, x: np.ndarray = None, coef: float = 0.97, **kwargs) -> np.ndarray:
    if coef == 0:
        raise RuntimeError(" [!] Preemphasis is set 0.0.")
    import scipy.signal

    return scipy.signal.lfilter([1], [1, -coef], x)


# ---------------------------------------------------------------------------
# STFT / iSTFT (librosa-compatible framing)
# ---------------------------------------------------------------------------

def get_window(window: str, win_length: int) -> np.ndarray:
    """Periodic (fftbins) window, as used by librosa/torch."""
    import scipy.signal

    return scipy.signal.get_window(window, win_length, fftbins=True).astype(np.float64)


def _pad_window(w: np.ndarray, fft_size: int) -> np.ndarray:
    """Center-pad a window to fft_size (librosa `pad_center`)."""
    if len(w) == fft_size:
        return w
    lpad = (fft_size - len(w)) // 2
    return np.pad(w, (lpad, fft_size - len(w) - lpad))


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into `[num_frames, frame_length]` (no copy)."""
    num_frames = 1 + (len(y) - frame_length) // hop_length
    shape = (num_frames, frame_length)
    strides = (y.strides[0] * hop_length, y.strides[0])
    return np.lib.stride_tricks.as_strided(y, shape=shape, strides=strides)


def stft(
    *,
    y: np.ndarray = None,
    fft_size: int = None,
    hop_length: int = None,
    win_length: int = None,
    pad_mode: str = "reflect",
    window: str = "hann",
    center: bool = True,
    **kwargs,
) -> np.ndarray:
    """Complex STFT `[fft_size//2+1, num_frames]`, matching `librosa.stft`
    (wrapped by Coqui at `numpy_transforms.py`:173)."""
    if win_length is None:
        win_length = fft_size
    if hop_length is None:
        hop_length = win_length // 4
    w = _pad_window(get_window(window, win_length), fft_size)
    if center:
        y = np.pad(y, fft_size // 2, mode=pad_mode)
    frames = frame_signal(np.ascontiguousarray(y, dtype=np.float64), fft_size, hop_length)
    return np.fft.rfft(frames * w[None, :], axis=-1).T


def istft(
    *,
    y: np.ndarray = None,
    hop_length: int = None,
    win_length: int = None,
    window: str = "hann",
    center: bool = True,
    **kwargs,
) -> np.ndarray:
    """Inverse STFT with windowed overlap-add + squared-window normalization,
    matching `librosa.istft` (Coqui `numpy_transforms.py`:204)."""
    n_freq, n_frames = y.shape
    fft_size = 2 * (n_freq - 1)
    if win_length is None:
        win_length = fft_size
    if hop_length is None:
        hop_length = win_length // 4
    w = _pad_window(get_window(window, win_length), fft_size)
    total = fft_size + hop_length * (n_frames - 1)
    out = np.zeros(total, dtype=np.float64)
    wsum = np.zeros(total, dtype=np.float64)
    frames = np.fft.irfft(y, n=fft_size, axis=0).T  # [n_frames, fft_size]
    w2 = w * w
    for i in range(n_frames):
        s = i * hop_length
        out[s : s + fft_size] += frames[i] * w
        wsum[s : s + fft_size] += w2
    nz = wsum > 1e-10
    out[nz] /= wsum[nz]
    if center:
        out = out[fft_size // 2 : total - fft_size // 2]
    return out


def griffin_lim(*, spec: np.ndarray = None, num_iter=60, seed: Union[None, int, np.random.Generator] = None,
                **kwargs) -> np.ndarray:
    """Iterative phase reconstruction (Coqui `numpy_transforms.py`:222). The
    first phases are uniform draws of `np.random.default_rng(seed)`: a seed
    or a `np.random.Generator` makes the result repeatable, None does not."""
    rng = np.random.default_rng(seed)
    angles = np.exp(2j * np.pi * rng.random(spec.shape))
    S_complex = np.abs(spec).astype(complex)
    y = istft(y=S_complex * angles, **kwargs)
    if not np.isfinite(y).all():
        print(" [!] Waveform is not finite everywhere. Skipping the GL.")
        return np.array([0.0])
    for _ in range(num_iter):
        angles = np.exp(1j * np.angle(stft(y=y, **kwargs)))
        y = istft(y=S_complex * angles, **kwargs)
    return y


# ---------------------------------------------------------------------------
# Spectrogram <-> mel
# ---------------------------------------------------------------------------

def spec_to_mel(*, spec: np.ndarray, mel_basis: np.ndarray = None, **kwargs) -> np.ndarray:
    return np.dot(mel_basis, spec)


def mel_to_spec(*, mel: np.ndarray = None, mel_basis: np.ndarray = None, **kwargs) -> np.ndarray:
    assert (mel < 0).sum() == 0, " [!] Input values must be non-negative."
    inv_mel_basis = np.linalg.pinv(mel_basis)
    return np.maximum(1e-10, np.dot(inv_mel_basis, mel))


# ---------------------------------------------------------------------------
# F0 (probabilistic YIN): training's pitch targets
# ---------------------------------------------------------------------------

def _beta_cdf(x: np.ndarray, a: float, b: float) -> np.ndarray:
    from scipy.special import betainc

    return betainc(a, b, x)


def pyin(
    y: np.ndarray,
    *,
    fmin: float,
    fmax: float,
    sr: int,
    frame_length: int,
    win_length: int = None,
    hop_length: int = None,
    n_thresholds: int = 100,
    beta_parameters: Tuple[float, float] = (2, 18),
    boltzmann_parameter: float = 2.0,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    center: bool = True,
    pad_mode: str = "reflect",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Probabilistic YIN (Mauch & Dixon 2014): F0 with a Viterbi-decoded
    voicing decision, with `librosa.pyin`'s parameters, on numpy and scipy.
    A copy of `tpu_tts/audio/numpy_transforms.py::pyin`.

    Returns (f0[T], voiced_flag[T], voiced_prob[T]).
    """
    win_length = win_length or frame_length // 2
    hop_length = hop_length or frame_length // 4
    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, frame_length // 2, mode=pad_mode)
    frames = frame_signal(np.ascontiguousarray(y), frame_length, hop_length)  # [T, frame_length]
    T = frames.shape[0]

    min_period = max(int(np.floor(sr / fmax)), 1)
    max_period = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)
    W = win_length

    # --- YIN difference function d(tau) over the W-sample window, per frame,
    # via the autocorrelation identity (O(T·F logF) instead of O(T·tau·W))
    fsize = 1 << (frame_length + max_period).bit_length()
    fft = np.fft.rfft(frames, fsize, axis=1)
    # cross-correlation of x[0:W] with x[tau:tau+W]: full autocorr of the
    # frame restricted to the window — compute corr(x, x_w) where x_w is the
    # frame with only the first W samples kept
    frames_w = frames.copy()
    frames_w[:, W:] = 0.0
    fft_w = np.fft.rfft(frames_w, fsize, axis=1)
    acf = np.fft.irfft(fft * np.conj(fft_w), fsize, axis=1)[:, : max_period + 1]
    cum = np.concatenate([np.zeros((T, 1)), np.cumsum(frames**2, axis=1)], axis=1)
    e0 = cum[:, W]  # energy of x[0:W]
    taus = np.arange(max_period + 1)
    e_tau = cum[:, taus + W] - cum[:, taus]  # energy of x[tau:tau+W]
    d = e0[:, None] + e_tau - 2 * acf  # [T, max_period+1]

    # cumulative mean normalized difference
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = np.cumsum(d[:, 1:], axis=1) / taus[1:][None, :]
        cmnd = np.ones_like(d)
        cmnd[:, 1:] = np.where(denom > 0, d[:, 1:] / denom, 1.0)
    yin_band = cmnd[:, min_period : max_period + 1]  # [T, L]
    L = yin_band.shape[1]
    if L < 3 or T == 0:
        z = np.zeros(T, dtype=np.float32)
        return z, np.zeros(T, dtype=bool), z

    # parabolic interpolation shifts (on the full cmnd grid, last column
    # edge-replicated so the band's right neighbor always exists)
    cmnd_ext = np.concatenate([cmnd, cmnd[:, -1:]], axis=1)
    a = cmnd_ext[:, min_period - 1 : max_period]
    b = yin_band
    c = cmnd_ext[:, min_period + 1 : max_period + 2]
    den = a - 2 * b + c
    shifts = np.where(np.abs(den) > 1e-12, 0.5 * (a - c) / np.where(np.abs(den) > 1e-12, den, 1.0), 0.0)
    shifts = np.clip(shifts, -0.5, 0.5)

    # local minima (troughs) along the lag axis
    is_trough = np.ones_like(yin_band, dtype=bool)
    is_trough[:, 1:] &= yin_band[:, 1:] < yin_band[:, :-1]
    is_trough[:, :-1] &= yin_band[:, :-1] <= yin_band[:, 1:]

    # trough probabilities from the threshold prior (beta) × rank prior
    # (Boltzmann), plus the no-trough mass on the global minimum
    thresholds = np.linspace(0.0, 1.0, n_thresholds + 1)
    beta_probs = np.diff(_beta_cdf(thresholds, *beta_parameters))  # [n_thresholds]

    n_bins_per_semitone = int(np.round(1.0 / resolution))
    n_pitch_bins = int(np.floor(12 * n_bins_per_semitone * np.log2(fmax / fmin))) + 1
    observation = np.zeros((T, 2 * n_pitch_bins))
    voiced_prob = np.zeros(T)

    lam = boltzmann_parameter
    for t in range(T):
        idx = np.flatnonzero(is_trough[t])
        if idx.size == 0:
            continue
        vals = yin_band[t, idx]
        # rank of each trough among those below each threshold
        below = vals[:, None] < thresholds[None, 1:]  # [K, n_thresholds]
        probs = np.zeros(idx.size)
        counts = below.sum(axis=0)  # troughs below each threshold
        ranks = np.cumsum(below, axis=0) - 1  # rank per trough per threshold
        for j in np.flatnonzero(counts):
            n = counts[j]
            w = np.exp(-lam * np.arange(n))
            w = w / w.sum()
            sel = below[:, j]
            probs[sel] += beta_probs[j] * w[ranks[sel, j]]
        # thresholds with no trough below: global-min trough absorbs a little
        empty_mass = beta_probs[counts == 0].sum()
        probs[np.argmin(vals)] += no_trough_prob * empty_mass
        # candidate frequencies → pitch bins
        periods = (min_period + idx + shifts[t, idx]).astype(np.float64)
        freqs = sr / np.maximum(periods, 1e-9)
        ok = (freqs >= fmin) & (freqs <= fmax)
        if not np.any(ok):
            continue
        bins = np.clip(
            np.round(12 * n_bins_per_semitone * np.log2(freqs[ok] / fmin)).astype(int),
            0,
            n_pitch_bins - 1,
        )
        np.add.at(observation[t], bins, probs[ok])
        voiced_prob[t] = min(observation[t, :n_pitch_bins].sum(), 1.0)

    observation[:, n_pitch_bins:] = (1.0 - voiced_prob[:, None]) / n_pitch_bins

    # --- banded Viterbi over (voiced, unvoiced) × pitch-bin states
    hop_time = hop_length / sr
    max_trans = max(int(round(12 * n_bins_per_semitone * max_transition_rate * hop_time)), 1)
    half = max_trans
    tri = 1.0 - np.abs(np.arange(-half, half + 1)) / (half + 1)  # triangular weights
    tri = tri / tri.sum()
    log_tri = np.log(np.maximum(tri, 1e-30))
    log_sw, log_st = np.log(switch_prob), np.log1p(-switch_prob)
    log_obs = np.log(np.maximum(observation, 1e-30))

    B = n_pitch_bins
    NEG = -1e30

    def banded_max(prev):
        """max_k prev[k] + log_tri[k - bin + half]  (and the argmax k)."""
        padded = np.full(B + 2 * half, NEG)
        padded[half : half + B] = prev
        win = np.lib.stride_tricks.sliding_window_view(padded, 2 * half + 1)  # [B, 2h+1]
        scores = win + log_tri[None, :]
        arg = np.argmax(scores, axis=1)
        return scores[np.arange(B), arg], arg + np.arange(B) - half

    v = log_obs[0, :B] - np.log(2 * B)
    u = log_obs[0, B:] - np.log(2 * B)
    back_v = np.zeros((T, B), dtype=np.int32)  # packed: k + B if from unvoiced
    back_u = np.zeros((T, B), dtype=np.int32)
    for t in range(1, T):
        bv, av = banded_max(v)
        bu, au = banded_max(u)
        from_v, from_u = bv + log_st, bu + log_sw
        new_v = np.where(from_v >= from_u, from_v, from_u) + log_obs[t, :B]
        back_v[t] = np.where(from_v >= from_u, av, au + B)
        from_v2, from_u2 = bv + log_sw, bu + log_st
        new_u = np.where(from_v2 >= from_u2, from_v2, from_u2) + log_obs[t, B:]
        back_u[t] = np.where(from_v2 >= from_u2, av, au + B)
        v, u = new_v, new_u

    # backtrace
    states = np.zeros(T, dtype=np.int32)
    last_v, last_u = int(np.argmax(v)), int(np.argmax(u))
    states[-1] = last_v if v[last_v] >= u[last_u] else last_u + B
    for t in range(T - 1, 0, -1):
        s = states[t]
        states[t - 1] = back_v[t, s] if s < B else back_u[t, s - B]

    voiced_flag = states < B
    bins = np.where(voiced_flag, states, states - B)
    f0 = (fmin * 2.0 ** (bins / (12.0 * n_bins_per_semitone))).astype(np.float32)
    return f0, voiced_flag, voiced_prob.astype(np.float32)


def compute_f0(
    *,
    x: np.ndarray = None,
    pitch_fmax: float = None,
    pitch_fmin: float = None,
    hop_length: int = None,
    win_length: int = None,
    sample_rate: int = None,
    stft_pad_mode: str = "reflect",
    center: bool = True,
    **kwargs,
) -> np.ndarray:
    """Frame-level F0 `[T_frames]`, 0 on the frames pyin's Viterbi path
    calls unvoiced (`tpu_tts/audio/numpy_transforms.py::compute_f0`)."""
    assert pitch_fmax is not None, " [!] Set `pitch_fmax` before calling `compute_f0`."
    assert pitch_fmin is not None, " [!] Set `pitch_fmin` before calling `compute_f0`."
    f0, voiced_mask, _ = pyin(
        np.asarray(x, dtype=np.float64),
        fmin=max(pitch_fmin, 1e-2),
        fmax=pitch_fmax,
        sr=sample_rate,
        frame_length=win_length,
        win_length=win_length // 2,
        hop_length=hop_length,
        center=center,
        pad_mode=stft_pad_mode,
    )
    f0[~voiced_mask] = 0.0
    return f0


# ---------------------------------------------------------------------------
# Silence
# ---------------------------------------------------------------------------

def find_endpoint(
    *,
    wav: np.ndarray = None,
    trim_db: float = -40,
    sample_rate: int = None,
    min_silence_sec=0.8,
    gain: float = None,
    base: int = None,
    **kwargs,
) -> int:
    window_length = int(sample_rate * min_silence_sec)
    hop = int(window_length / 4)
    threshold = db_to_amp(x=-trim_db, gain=gain, base=base)
    for x in range(hop, len(wav) - window_length, hop):
        if np.max(wav[x : x + window_length]) < threshold:
            return x + hop
    return len(wav)


def _signal_db(frames_rms: np.ndarray, ref: float) -> np.ndarray:
    power = np.maximum(frames_rms, 1e-10) ** 2
    return 10.0 * np.log10(power / max(ref**2, 1e-20))


def trim_silence(
    *,
    wav: np.ndarray = None,
    sample_rate: int = None,
    trim_db: float = None,
    win_length: int = None,
    hop_length: int = None,
    **kwargs,
) -> np.ndarray:
    """Trim leading/trailing silence below `trim_db` relative to peak, with a
    0.01 s margin (Coqui `numpy_transforms.py`:360 → `librosa.effects.trim`)."""
    margin = int(sample_rate * 0.01)
    wav = wav[margin:-margin] if margin > 0 else wav
    if len(wav) < win_length:
        return wav
    padded = np.pad(np.asarray(wav, dtype=np.float64), win_length // 2, mode="reflect")
    frames = frame_signal(np.ascontiguousarray(padded), win_length, hop_length)
    rms = np.sqrt(np.mean(frames**2, axis=1))
    db = _signal_db(rms, ref=float(np.max(rms)))
    non_silent = db > -abs(trim_db)
    if not non_silent.any():
        return wav[:0]
    idx = np.flatnonzero(non_silent)
    start = int(idx[0] * hop_length)
    end = min(len(wav), int((idx[-1] + 1) * hop_length))
    return wav[start:end]


# ---------------------------------------------------------------------------
# Wav I/O (stdlib/scipy; Coqui uses soundfile + librosa)
# ---------------------------------------------------------------------------

def volume_norm(*, x: np.ndarray = None, coef: float = 0.95, **kwargs) -> np.ndarray:
    return x / abs(x).max() * coef


def rms_norm(*, wav: np.ndarray = None, db_level: float = -27.0, **kwargs) -> np.ndarray:
    r = 10 ** (db_level / 20)
    a = np.sqrt((len(wav) * (r**2)) / np.sum(wav**2))
    return wav * a


def rms_volume_norm(*, x: np.ndarray, db_level: float = -27.0, **kwargs) -> np.ndarray:
    if not -99 <= db_level <= 0:
        raise ValueError(" [!] db_level should be between -99 and 0")
    return rms_norm(wav=x, db_level=db_level)


def resample_wav(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    g = np.gcd(int(orig_sr), int(target_sr))
    import scipy.signal

    return scipy.signal.resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def load_wav(*, filename: str, sample_rate: int = None, resample: bool = False, **kwargs) -> np.ndarray:
    """Read a wav file to float32 in [-1, 1]; optional polyphase resampling
    (Coqui `numpy_transforms.py`:407 uses soundfile/librosa)."""
    import scipy.io.wavfile

    sr, data = scipy.io.wavfile.read(filename)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if resample and sample_rate is not None and sr != sample_rate:
        x = resample_wav(x, sr, sample_rate)
    return x


def save_wav(*, wav: np.ndarray, path: str, sample_rate: int = None, pipe_out=None, **kwargs) -> None:
    """Save float waveform as 16-bit PCM (Coqui `numpy_transforms.py`:428); with
    `pipe_out` (a text stream such as `sys.stdout`) the WAV bytes also go to its
    binary buffer."""
    import scipy.io.wavfile

    wav_norm = wav * (32767 / max(0.01, np.max(np.abs(wav))))
    wav_norm = wav_norm.astype(np.int16)
    if pipe_out:
        wav_buffer = BytesIO()
        scipy.io.wavfile.write(wav_buffer, sample_rate, wav_norm)
        wav_buffer.seek(0)
        pipe_out.buffer.write(wav_buffer.read())
    scipy.io.wavfile.write(path, sample_rate, wav_norm)

