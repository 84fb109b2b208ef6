"""GAN vocoder training on the CPU (float32 unless said).

- A tiny HiFi-GAN GAN's D and G loss terms against one jitted JAX forward
  of `GAN.loss_fn` (the full-width HiFi-GAN discriminator; no JAX backward
  through it, whose compile alone takes minutes): 1e-5 relative;
- a tiny 4-band MelGAN GAN's D and G losses against
  `jax.value_and_grad(GAN.loss_fn)`: 1e-5 relative, every gradient within
  1e-4 of its tensor's max;
- `bin/train_vocoder` on the in-repo LJSpeech wavs: a tiny multiband MelGAN
  GAN trains one epoch, `--continue_path` resumes it for a second (weights,
  both optimizers, step and epoch), and the run directory serves as the
  vocoder behind a Glow-TTS through `bin/synthesize`.

The tiny models and their weights are `tests/test_torch_port_vocoder.py`'s.
"""

import copy
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.test_torch_port_train import _compare_grads, _effective_jax_tree, _effective_torch_grads
from tests.test_torch_port_vocoder import MELS, hifigan_pair, multiband_pair
from tests.torch_port_common import CompiledAhead, cached_flax_shape_check, session_runs

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ljspeech", "wavs")


def _gan_batch(T_mel, seed, hop=16):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((2, T_mel, MELS)).astype(np.float32)
    t = np.arange(T_mel * hop)
    wav = (0.4 * np.sin(2 * np.pi * 0.03 * t)[None] + 0.05 * rng.standard_normal((2, T_mel * hop)))
    jb = {"mel_input": mel, "waveform": wav.astype(np.float32)[:, :, None]}
    return jb, {k: torch.from_numpy(v) for k, v in jb.items()}


def _dft_bases64(fft_size, win_length, window):
    """`tpu_tts.audio.jax_transforms._dft_bases` in float64."""
    from tpu_tts.audio.numpy_transforms import _pad_window, get_window

    w = _pad_window(get_window(window, win_length), fft_size).astype(np.float64)
    ang = 2.0 * np.pi * np.arange(fft_size)[:, None] * np.arange(fft_size // 2 + 1)[None, :] / fft_size
    return np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]


class _Float64Numpy:
    """`jax.numpy` whose `float32` is `float64`: the JAX package's STFT and
    loss code, which names float32 for its matmuls and casts, runs in
    float64 unchanged."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _config(out):
    from tpu_tts_torch.config.shared_configs import BaseAudioConfig
    from tpu_tts_torch.vocoder.configs import MultibandMelganConfig

    return MultibandMelganConfig(
        audio=BaseAudioConfig(num_mels=20, fft_size=256, win_length=256, hop_length=64),
        generator_model_params={"upsample_factors": [2, 2, 2, 2], "num_res_blocks": 1},
        discriminator_model_params={"base_channels": 4, "max_channels": 16, "downsample_factors": [2, 2]},
        stft_loss_params={"n_ffts": [128, 256, 64], "hop_lengths": [32, 64, 16], "win_lengths": [96, 192, 48]},
        subband_stft_loss_params={"n_ffts": [64, 96, 32], "hop_lengths": [16, 24, 8], "win_lengths": [48, 72, 24]},
        batch_size=2, eval_batch_size=2, seq_len=512, pad_short=100, use_noise_augment=True, epochs=1,
        print_step=1, save_step=0, eval_split_size=2, data_path=FIXTURE, output_path=out)


def test_train_vocoder_cli_continue_and_synthesize(tmp_path, capsys):
    """One epoch (`--small_run 2`: one step of 2 clips, then the eval),
    resumed for a second by `--continue_path` with its checkpoint's
    optimizer state and step; the newest checkpoint and the run's
    `config.json` then vocode a Glow-TTS's mel through `bin/synthesize`."""
    from tpu_tts_torch.bin.synthesize import main as synthesize
    from tpu_tts_torch.bin.train_vocoder import main as train_vocoder
    from tpu_tts_torch.configs import GlowTTSConfig
    from tpu_tts_torch.models.glow_tts import GlowTTS
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint, load_checkpoint

    out = str(tmp_path / "run")
    cfg_path = str(tmp_path / "config.json")
    _config(out).save_json(cfg_path)
    train_vocoder(["--config_path", cfg_path, "--device", "cpu", "--small_run", "2"])
    first, _ = get_last_checkpoint(out)
    state = load_checkpoint(first)
    assert state["epoch"] == 1 and state["step"] == 1 and len(state["optimizer"]) == 2
    assert any(k.startswith("model_d.discriminators.2.") for k in state["model"])
    assert "model_g.layers.1.parametrizations.weight.original1" in state["model"]

    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    saved["epochs"] = 2
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(saved, f)
    train_vocoder(["--continue_path", out, "--device", "cpu", "--small_run", "2"])
    last, best = get_last_checkpoint(out)
    resumed = load_checkpoint(last)
    assert resumed["step"] == 2 and resumed["epoch"] == 2 and os.path.exists(best)
    assert all(opt["count"] == 2 for opt in resumed["optimizer"])
    assert "STEP: 2" in capsys.readouterr().out

    glow = GlowTTS.init_from_config(GlowTTSConfig(out_channels=20, hidden_channels_enc=16, hidden_channels_dec=16,
                                                  hidden_channels_dp=16, num_block_layers=2, text_cleaner=
                                                  "english_cleaners", encoder_params={
                                                      "kernel_size": 3, "dropout_p": 0.1, "num_layers": 2,
                                                      "num_heads": 2, "hidden_channels_ffn": 24}), device="cpu")
    torch.save(glow.net.state_dict(), tmp_path / "glow.pth")
    glow.config.save_json(str(tmp_path / "glow.json"))
    wav_path = str(tmp_path / "out.wav")
    synthesize(["--text", "Be a voice.", "--model_path", str(tmp_path / "glow.pth"), "--config_path",
                str(tmp_path / "glow.json"), "--vocoder_path", last, "--vocoder_config_path",
                os.path.join(out, "config.json"), "--out_path", wav_path, "--device", "cpu"])
    sr, pcm = scipy.io.wavfile.read(wav_path)
    assert sr == 22050 and pcm.size > 10000 and np.abs(pcm).max() > 0
    assert len(glob.glob(os.path.join(out, "checkpoint_*.pth"))) == 2


@functools.lru_cache(maxsize=None)
def hifigan_program():
    """One jitted JAX forward of the tiny HiFi-GAN GAN's `loss_fn` for both
    sub-steps on `_gan_batch(8, 8)`, compiled ahead."""
    jm, _ = hifigan_pair()
    jb, _ = _gan_batch(8, 8)
    return CompiledAhead(lambda p, b: [jm.loss_fn(p, b, jax.random.PRNGKey(0), i) for i in (0, 1)], jm.params,
                         {k: jnp.asarray(v) for k, v in jb.items()})


def test_hifigan_gan_losses_match_jax_forward():
    """A tiny HiFi-GAN GAN's D and G loss terms (the full-width HiFi-GAN
    discriminator, the l1 mel, feature-matching and MSE terms) against one
    jitted JAX forward of `GAN.loss_fn` for both sub-steps."""
    _, pm = hifigan_pair()
    _, pb = _gan_batch(8, 8)
    refs = hifigan_program().result()
    pm.train(True)
    with torch.no_grad():
        for idx, (ref_loss, ref_logs) in enumerate(refs):
            loss, logs = pm.loss_fn(pb, idx)
            assert set(logs) == set(ref_logs) and float(ref_logs["loss"]) > 0
            for k, v in ref_logs.items():
                assert abs(float(logs[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (idx, k, float(logs[k]), float(v))


@functools.lru_cache(maxsize=None)
def multiband_program():
    """The float64 port GAN of `test_multiband_gan_step_matches_jax`, its
    batch, the JAX params, and `jax.value_and_grad` of its D and G steps in
    one program, compiled ahead."""
    from tpu_tts.audio import jax_transforms
    from tpu_tts.vocoder.layers import losses as jl
    from tpu_tts.vocoder.models.vocoder_convert import convert_gan_torch_state_dict
    from tpu_tts_torch.vocoder.models import setup_model

    jm, pm32 = multiband_pair(base_channels=64)
    pm = setup_model(pm32.config, device="cpu")
    pm.net.model_g = copy.deepcopy(pm32.net.model_g)
    pm.net.load_state_dict(pm32.net.state_dict())
    pm.net.double()
    # JAX's generator from the port's float64 weights (the JAX converter), so
    # both fold the same kernels
    gen64 = convert_gan_torch_state_dict({k: v.numpy() for k, v in pm.net.state_dict().items()},
                                         generator_name=pm.config.generator_model)["generator"]
    jb, pb = _gan_batch(64, 9)
    pb = {k: v.double() for k, v in pb.items()}

    def step(params, batch):
        out = []
        for idx, key in ((0, "discriminator"), (1, "generator")):
            def loss_of(sub, idx=idx, key=key):
                return jm.loss_fn({**params, key: sub}, batch, jax.random.PRNGKey(0), idx)

            out.append(jax.value_and_grad(loss_of, has_aux=True)(params[key]))
        return out

    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_transforms, "_dft_bases", _dft_bases64)
        for module in (jax_transforms, jl):
            mp.setattr(module, "jnp", _Float64Numpy())
        mp.setattr(jm.pqmf, "H", jnp.asarray(np.asarray(jm.pqmf.H), jnp.float64))
        mp.setattr(jm.pqmf, "G", jnp.asarray(np.asarray(jm.pqmf.G), jnp.float64))
        params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                              {"generator": gen64, "discriminator": jm.params["discriminator"]})
        program = CompiledAhead(step, params, {k: jnp.asarray(v, jnp.float64) for k, v in jb.items()},
                                context=jax.enable_x64)
    return pm, pb, params, program


@pytest.fixture(scope="module", autouse=True)
def _compile_ahead(request, cached_flax_shape_check):
    """Both JAX programs traced before the module's first test; XLA compiles
    the first while the second traces, and both while the tests before them
    (last in the module) run."""
    if session_runs(request, "test_hifigan_gan_losses"):
        hifigan_program()
    if session_runs(request, "test_multiband_gan_step"):
        multiband_program()


def test_multiband_gan_step_matches_jax():
    """A tiny 4-band MelGAN GAN (PQMF, the subband STFT term; the generator
    at a 64-channel base): one D and one
    G step's losses and every gradient against `jax.value_and_grad`, both
    sides in float64 (JAX with x64, its STFT and losses' float32 read as
    float64; the port's net in float64), at 64 mel frames: the subband
    term's log magnitude of STFT bins 2·10⁴ times below their frame's level
    amplifies rounding, so at 16 frames the port's own float32 G gradient
    is up to 2.6e-3 of a tensor's max from its float64 one, JAX's float32
    gradient 1.9e-3 from JAX's float64 one, and even in float64 a 1e-7
    change of a weight moves it by 1e-4; 64 frames are better conditioned."""
    from tpu_tts_torch.vocoder.models.vocoder_convert import gan_state_dict_from_flax

    pm, pb, params, program = multiband_program()
    refs = program.result()
    pm.train(True)
    for idx, ((ref_loss, ref_logs), ref_grads) in enumerate(refs):
        for p in pm.net.parameters():
            p.grad = None
        loss, logs = pm.loss_fn(pb, idx)
        loss.backward()
        for k, v in ref_logs.items():
            assert abs(float(logs[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (idx, k, float(logs[k]), float(v))
        key, part = ("discriminator", "model_d") if idx == 0 else ("generator", "model_g")
        eff = _effective_jax_tree(params[key], ref_grads)
        want = gan_state_dict_from_flax({key: eff}, "multiband_melgan_generator", 2)
        want = {k[len(part) + 1:]: v for k, v in want.items() if k.startswith(part + ".")}
        _compare_grads(_effective_torch_grads(getattr(pm.net, part)), want, part, rel=1e-4)
        other = pm.net.model_g if idx == 0 else pm.net.model_d
        assert all(p.grad is None for p in other.parameters())
