"""The port's host-side audio, its phoneme front end, Glow-TTS served through
Griffin-Lim, and Coqui-format Glow-TTS and WaveRNN checkpoints, against
`tpu_tts` (CPU).

- `griffin_lim` with the same seed (1e-5), `inv_melspectrogram`'s magnitudes
  before the phase loop (1e-5 relative), the STFT → mel → dB chain,
  `find_endpoint`, `trim_silence`, wav I/O, and the mean-variance scaler
  read from a `stats_path` the test writes (1e-6);
- `TTSTokenizer` phoneme ids through `en_rules` equal to `tpu_tts`'s; the
  French and Mandarin cleaners equal; a gated phonemizer raises;
- Glow-TTS without a vocoder: `Synthesizer.tts` goes through Griffin-Lim and
  the silence trim; with both packages' Griffin-Lim phases drawn from one
  seed (the JAX call patched in the test) the waveform agrees within 2e-3 of
  its peak, and with a trim threshold that cuts, the lengths after the trim
  are equal;
- a Coqui-format Glow-TTS checkpoint (`{"model": ...}` beside optimizer
  state) and a flat WaveRNN state dict, written by the test, loaded by the
  JAX models' `load_checkpoint` and by the port's: mel within 1e-4 with
  equal `y_lengths`, waveform within 1e-5.
"""

import argparse
import copy
import functools

import numpy as np
import pytest
import torch

from tests.test_torch_port_glow import TINY_GLOW, jax_glow, port_glow_config
from tests.torch_port_common import TINY_WAVERNN, cached_flax_shape_check, max_err

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

SENTENCES = ["Hello world, this is a test.", "It took me three years to develop a voice!",
             "Dr. Smith thought through the night; the school choir sang."]


def _audio_pair(**audio):
    from tpu_tts.audio import AudioProcessor as JaxAP
    from tpu_tts.config.shared_configs import BaseAudioConfig as JaxAudio
    from tpu_tts_torch.audio import AudioProcessor
    from tpu_tts_torch.config.shared_configs import BaseAudioConfig

    return (JaxAP(verbose=False, **JaxAudio(**audio).to_dict()),
            AudioProcessor(**BaseAudioConfig(**audio).to_dict()))


def test_griffin_lim_matches_jax():
    from tpu_tts.audio import numpy_transforms as jnt
    from tpu_tts_torch.audio import numpy_transforms as nt

    spec = np.abs(np.random.default_rng(0).standard_normal((129, 40))) ** 1.5
    kw = dict(num_iter=12, hop_length=64, win_length=256, fft_size=256)
    ref = jnt.griffin_lim(spec=spec, seed=7, **kw)
    got = nt.griffin_lim(spec=spec, seed=7, **kw)
    assert got.shape == ref.shape == (64 * 39,) and max_err(got, ref) <= 1e-5
    np.testing.assert_array_equal(nt.griffin_lim(spec=spec, seed=np.random.default_rng(7), **kw), got)


def test_inv_mel_magnitudes_and_mel_basis_match_jax():
    from tpu_tts.audio import numpy_transforms as jnt

    jap, ap = _audio_pair(num_mels=40, fft_size=512, win_length=512, hop_length=128, mel_fmax=8000.0)
    np.testing.assert_array_equal(ap.mel_basis, jap.mel_basis)
    mel = np.random.default_rng(1).uniform(-4, 4, (40, 30))
    ref = jnt.mel_to_spec(mel=jnt.db_to_amp(x=jap.denormalize(mel), gain=jap.spec_gain, base=jap.base),
                          mel_basis=jap.mel_basis) ** jap.power
    got = ap.inv_mel_magnitudes(mel)
    assert got.shape == (257, 30) and max_err(got / ref.max(), ref / ref.max()) <= 1e-5
    wav = ap.inv_melspectrogram(mel, seed=3)
    assert wav.shape == (128 * 29,) and np.isfinite(wav).all()
    # the forward transforms: |STFT| → mel → dB, as the JAX module computes them
    from tpu_tts_torch.audio import numpy_transforms as nt

    spec = np.abs(nt.stft(y=wav, fft_size=512, hop_length=128, win_length=512))
    np.testing.assert_array_equal(spec, np.abs(jnt.stft(y=wav, fft_size=512, hop_length=128, win_length=512)))
    mel_db = nt.amp_to_db(x=nt.spec_to_mel(spec=spec, mel_basis=ap.mel_basis), gain=20, base=10)
    ref_db = jnt.amp_to_db(x=jnt.spec_to_mel(spec=spec, mel_basis=jap.mel_basis), gain=20, base=10)
    np.testing.assert_array_equal(mel_db, ref_db)


def test_find_endpoint_and_trim_silence_match_jax():
    from tpu_tts.infer.synthesis import trim_silence as jax_trim
    from tpu_tts_torch.infer.synthesis import trim_silence

    jap, ap = _audio_pair()
    sr = 22050
    t = np.arange(int(2.6 * sr)) / sr
    wav = 0.5 * np.sin(2 * np.pi * 220 * t)
    wav[int(1.0 * sr): int(2.2 * sr)] *= 1e-4  # 1.2 s below the -45 dB threshold
    wav[: int(0.05 * sr)] *= 1e-4
    end = ap.find_endpoint(wav)
    assert end == jap.find_endpoint(wav) and int(1.0 * sr) < end < int(1.5 * sr)
    np.testing.assert_array_equal(trim_silence(wav, ap), jax_trim(wav, jap))
    got, ref = ap.trim_silence(wav), jap.trim_silence(wav)
    assert len(got) < len(wav) - int(0.04 * sr)
    np.testing.assert_array_equal(got, ref)


def test_save_and_load_wav_match_jax(tmp_path):
    """16-bit PCM through `save_wav` (with `pipe_out`, the bytes also go to the
    stream's buffer) and back through `load_wav`, resampled as the JAX one."""
    import io
    import types

    from tpu_tts.audio import numpy_transforms as jnt
    from tpu_tts_torch.audio import numpy_transforms as nt

    jap, ap = _audio_pair()
    wav = 0.3 * np.sin(np.arange(4000) / 7.0).astype(np.float32)
    pipe = types.SimpleNamespace(buffer=io.BytesIO())
    ap.save_wav(wav, str(tmp_path / "port.wav"), pipe_out=pipe)
    jap.save_wav(wav, str(tmp_path / "jax.wav"))
    port_bytes = (tmp_path / "port.wav").read_bytes()
    assert port_bytes == (tmp_path / "jax.wav").read_bytes() == pipe.buffer.getvalue()
    for kw in (dict(), dict(sample_rate=16000, resample=True)):
        got = nt.load_wav(filename=str(tmp_path / "port.wav"), **kw)
        np.testing.assert_array_equal(got, jnt.load_wav(filename=str(tmp_path / "port.wav"), **kw))
    assert max_err(nt.load_wav(filename=str(tmp_path / "port.wav")), wav / np.abs(wav).max()) <= 1e-4


def test_mean_variance_scaler_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    audio = dict(num_mels=20, fft_size=64, win_length=64, hop_length=16, signal_norm=True)
    stats = {"mel_mean": rng.normal(-30, 5, 20), "mel_std": rng.uniform(5, 15, 20),
             "linear_mean": rng.normal(-40, 5, 33), "linear_std": rng.uniform(5, 15, 33),
             "audio_config": {"num_mels": 20, "fft_size": 64, "hop_length": 16, "sample_rate": 16000}}
    np.save(tmp_path / "stats.npy", stats, allow_pickle=True)
    jap, ap = _audio_pair(**audio, stats_path=str(tmp_path / "stats.npy"))
    assert ap.mel_scaler is not None and ap.symmetric_norm is None and ap.max_norm is None
    mel_db = rng.normal(-30, 10, (20, 12))
    norm = ap.normalize(mel_db)
    assert max_err(norm, jap.normalize(mel_db)) <= 1e-6
    assert max_err(ap.denormalize(norm), jap.denormalize(norm)) <= 1e-6
    assert max_err(ap.denormalize(norm), mel_db) <= 1e-6
    bad = {**stats, "audio_config": {**stats["audio_config"], "fft_size": 128}}
    np.save(tmp_path / "bad.npy", bad, allow_pickle=True)
    with pytest.raises(AssertionError, match="fft_size"):
        _audio_pair(**audio, stats_path=str(tmp_path / "bad.npy"))


def test_en_rules_phoneme_ids_match_jax():
    from tpu_tts.configs.vits_config import VitsConfig as JaxConfig
    from tpu_tts.text import cleaners as jax_cleaners
    from tpu_tts.text.tokenizer import TTSTokenizer as JaxTokenizer
    from tpu_tts_torch.configs.vits_config import VitsConfig
    from tpu_tts_torch.text import cleaners
    from tpu_tts_torch.text.characters import IPAPhonemes
    from tpu_tts_torch.text.tokenizer import TTSTokenizer

    for kw in (dict(phonemizer="en_rules"), dict()):  # by name, and as English's default
        kw = dict(use_phonemes=True, phoneme_language="en", text_cleaner="phoneme_cleaners", add_blank=True, **kw)
        tok, cfg = TTSTokenizer.init_from_config(VitsConfig(**kw))
        jtok, jcfg = JaxTokenizer.init_from_config(JaxConfig(**kw))
        assert isinstance(tok.characters, IPAPhonemes) and tok.phonemizer.name() == jtok.phonemizer.name() == "en_rules"
        assert cfg.characters.characters_class.rsplit(".", 1)[-1] == "IPAPhonemes"
        for s in SENTENCES:
            ids = tok.text_to_ids(s)
            assert ids == jtok.text_to_ids(s) and len(ids) > 2 * len(s.split())
    for s in ("M. Dupont arrive à 10 h, Mme Martin aussi.", "Il a dit: «bonjour»!"):
        assert cleaners.french_cleaners(s) == jax_cleaners.french_cleaners(s)
    for s in ("我有123个苹果和45.6元", "2024年"):
        assert cleaners.chinese_mandarin_cleaners(s) == jax_cleaners.chinese_mandarin_cleaners(s)


def test_gated_phonemizers_raise():
    from tpu_tts_torch.configs.vits_config import VitsConfig
    from tpu_tts_torch.text.phonemizers import DEF_LANG_TO_PHONEMIZER, PHONEMIZERS, ESpeak, get_phonemizer_by_name
    from tpu_tts_torch.text.tokenizer import TTSTokenizer

    for name in ("zh_cn_phonemizer", "ko_kr_phonemizer", "ja_jp_phonemizer", "bn_phonemizer", "be_phonemizer"):
        assert name in PHONEMIZERS and name in DEF_LANG_TO_PHONEMIZER.values()
    # ja/ko/bn run natively (tests/test_torch_port_phonemizers.py); zh and be need their packages
    assert all(PHONEMIZERS[n].is_available() for n in ("ko_kr_phonemizer", "ja_jp_phonemizer", "bn_phonemizer"))
    try:
        import pypinyin  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="pypinyin"):
            get_phonemizer_by_name("zh_cn_phonemizer", language="xx")
        with pytest.raises(RuntimeError, match="pypinyin"):
            TTSTokenizer.init_from_config(VitsConfig(use_phonemes=True, phoneme_language="zh-cn"))
    if not ESpeak.is_available():
        with pytest.raises(RuntimeError, match="espeak"):
            get_phonemizer_by_name("espeak", language="en-us")
    with pytest.raises(ValueError, match="not found"):
        get_phonemizer_by_name("no_such_backend")


# ------------------------------------------------- Glow-TTS served through Griffin-Lim

# the Glow-TTS audio config with the tiny model's 20 mel channels
GLOW_AUDIO = dict(num_mels=20)
TEXT = "Be a voice, not an echo, and keep on going."


@pytest.fixture(scope="module")
def glows():
    """The tiny JAX Glow-TTS (its compiled programs shared) and the port's,
    on the same weights, each with the 20-mel audio processor."""
    from tpu_tts.config.shared_configs import BaseAudioConfig as JaxAudio
    from tpu_tts_torch.config.shared_configs import BaseAudioConfig
    from tpu_tts_torch.models.glow_convert import params_from_flax
    from tpu_tts_torch.models.glow_tts import GlowTTS

    jap, ap = _audio_pair(**GLOW_AUDIO)
    jm = copy.copy(jax_glow())
    jm.config = copy.deepcopy(jm.config)
    jm.config.audio, jm.ap = JaxAudio(**GLOW_AUDIO), jap
    pm = GlowTTS.init_from_config(port_glow_config(), device="cpu")
    pm.net.load_state_dict(params_from_flax(jm.params), strict=True)
    pm.config.audio, pm.ap = BaseAudioConfig(**GLOW_AUDIO), ap
    assert pm.config.audio.do_trim_silence and jm.config.audio.do_trim_silence
    return jm, pm


def _synths(jm, pm):
    from tpu_tts.infer.synthesizer import Synthesizer as JaxSynthesizer
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    js, ps = JaxSynthesizer(), Synthesizer(device="cpu")
    js.tts_model, js.tts_config = jm, jm.config
    ps.tts_model, ps.tts_config = pm, pm.config
    return js, ps


def test_glow_griffin_lim_synthesizer_matches_jax(glows, monkeypatch):
    import tpu_tts.audio.numpy_transforms as jnt
    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP

    jm, pm = glows
    monkeypatch.setattr(jnt, "griffin_lim", functools.partial(jnt.griffin_lim, seed=0))
    js, ps = _synths(jm, pm)
    ref = np.asarray(js.tts(TEXT), dtype=np.float32)
    got = np.asarray(ps.tts(TEXT, seed=0), dtype=np.float32)
    frames = int(pm.inference(pm.tokenizer.text_to_ids(TEXT))["y_lengths"][0])
    # Griffin-Lim's iSTFT gives (frames − 1) hops; nothing is below -45 dB to trim
    assert got.shape == ref.shape == ((frames - 1) * 256 + SENTENCE_GAP,)
    assert (frames - 1) * 256 > 22050 + 4410  # long enough for find_endpoint to look
    assert max_err(got, ref) <= 2e-3 * float(np.abs(ref).max())

    # a threshold above the whole signal: both cut at the first window
    monkeypatch.setattr(jm.ap, "trim_db", -100)
    monkeypatch.setattr(pm.ap, "trim_db", -100)
    ref_cut, got_cut = js.tts(TEXT), ps.tts(TEXT, seed=0)
    assert len(got_cut) == len(ref_cut) == 2 * int(22050 * 0.8 / 4) + SENTENCE_GAP


def test_coqui_checkpoint_glow_tts(glows, tmp_path):
    from tpu_tts_torch.models.glow_tts import GlowTTS

    jm, pm = glows
    # a training checkpoint pickles more than tensors (here its config as an
    # object), so the port reads it as a full pickle, as the JAX loader does
    torch.save({"model": pm.net.state_dict(), "optimizer": {"state": {}, "param_groups": []}, "step": 5,
                "config": argparse.Namespace(model="glow_tts")}, tmp_path / "glow.pth")
    jl = copy.copy(jm)
    jl.load_checkpoint(jm.config, str(tmp_path / "glow.pth"))
    pl = GlowTTS.init_from_config(port_glow_config(), device="cpu")
    pl.load_checkpoint(pl.config, str(tmp_path / "glow.pth"))
    x = np.asarray(pm.tokenizer.text_to_ids(TEXT), dtype=np.int32)
    ref, got = jl.inference(x), pl.inference(x)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(ref["y_lengths"]))
    assert max_err(got["model_outputs"], ref["model_outputs"]) <= 1e-4


def test_coqui_checkpoint_wavernn(tmp_path):
    from tests.torch_port_common import port_wavernn_config
    from tpu_tts.vocoder.configs.wavegrad_config import WavernnConfig as JaxWavernnConfig
    from tpu_tts.vocoder.models.wavernn import Wavernn as JaxWavernn
    from tpu_tts.vocoder.models.wavernn import WavernnArgs as JaxWavernnArgs
    from tpu_tts_torch.vocoder.models.wavernn import Wavernn

    torch.manual_seed(3)
    src = Wavernn(port_wavernn_config(), device="cpu")
    with torch.no_grad():
        for name, t in src.net.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                t.copy_(torch.rand_like(t) + 0.5 if name.endswith("var") else 0.3 * torch.randn_like(t))
            elif t.is_floating_point():
                t.copy_(0.3 * torch.randn_like(t))
    torch.save(src.net.state_dict(), tmp_path / "wavernn.pth")  # flat

    cfg = JaxWavernnConfig()
    cfg.model_args = JaxWavernnArgs(**TINY_WAVERNN)
    jl = JaxWavernn(cfg)
    jl.load_checkpoint(cfg, str(tmp_path / "wavernn.pth"))
    pl = Wavernn(port_wavernn_config(), device="cpu")
    pl.load_checkpoint(pl.config, str(tmp_path / "wavernn.pth"))
    mels = np.random.default_rng(8).standard_normal((6, TINY_WAVERNN["feat_dims"])).astype(np.float32)
    ref = jl.inference(mels, batched=False, use_pallas=True, seed=5)
    got = pl.inference(mels, batched=False, seed=5)
    assert got.shape == np.asarray(ref).shape == (6 * 4,) and float(np.std(ref)) > 1e-3
    assert max_err(got, ref) <= 1e-5
