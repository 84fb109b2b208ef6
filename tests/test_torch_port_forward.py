"""The port's ForwardTTS family (FastPitch, FastSpeech, FastSpeech2,
SpeedySpeech) against `tpu_tts` on the CPU, float32.

Each variant runs at tiny widths: hidden 32, 20 mels, two FFT layers of two
heads (FFN 48) or SpeedySpeech's residual-conv coders (dilations (1, 2) and
(1, 2, 4), kernel 4), predictors 24 wide, every dropout 0. Both packages
compute on the same weights: the port's drawn from a numpy seed (norm
scales 1 ± 0.1, the duration head drawn so that a token lasts a few frames;
SpeedySpeech's BatchNorm statistics drawn too), carried to JAX
through Coqui's key names and `tpu_tts`'s converter (`pair`). The layer
classes' flax trees are drawn the other way and reach the port through
`models/forward_convert.py::params_from_flax`. Held here:

- every new layer class against its flax module (in one jitted program
  with the four variants' inference; both JAX programs are compiled ahead,
  `tests/torch_port_common.py::CompiledAhead`), on
  rows of unequal lengths, within 1e-5: the FFT block (its key-padding
  mask), the positional encoding (learned scale), a residual Conv1dBN stack
  (each row's own boundary), SpeedySpeech's encoder and decoder with
  BatchNorm in eval mode, and the WaveNet decoder;
- `inference` of all four variants (FastSpeech with a speaker table): the
  same durations (JAX's pre-round durations first held ≥ 1e-3 from a .5
  tie, so that a rounding near-tie fails loudly instead of flaking), equal
  `y_lengths` and alignments, the log-durations within 1e-5, the mel
  within 1e-4;
- `loss_fn` of FastPitch, FastSpeech2 (energy) and SpeedySpeech
  (BatchNorm in train mode), aligner priors on, against
  `jax.value_and_grad`, both sides in float64: every logged term within
  1e-5 of max(1, |term|), every gradient within 1e-3 of its tensor's
  largest |gradient| plus 1e-6, the MAS durations equal, and SpeedySpeech's
  running statistics after the step within 1e-6 of JAX's `batch_stats`. In
  float32 the decoder's attention takes inputs scaled by √C plus the
  sinusoids, its softmax saturates, and its query and key gradients (up to
  2.5e-5) are float32 rounding: JAX's and the port's part by 67 % of the
  tensor's max; the running variances (≈ 2) part by 1.9e-6;
- the trainer's eval losses leave SpeedySpeech's BatchNorm statistics as
  they were, as JAX's eval drops its `batch_stats`;
- the energy collate of FastSpeech2's `get_data_loader` against
  `tpu_tts`'s on two fixture clips;
- a Coqui-keyed state dict through `tpu_tts`'s converter and the port's
  own reader: the same tensors, and a SpeedySpeech checkpoint loaded with
  the `frozen_batch` switch;
- the `Synthesizer` with FastPitch behind a tiny HiFi-GAN against JAX's
  FastPitch mel and JAX's HiFi-GAN within 2e-4;
- `setup_model` from each config and from its saved `config.json`;
- `bin/train_tts` on the fixture, `--continue_path`, and the run directory
  served by the `Synthesizer`, `/api/tts`, `api.TTS` and the CLI behind the
  vocoder.
"""

import argparse
import copy
import functools
import io
import json
import os
import tempfile
import threading
import urllib.request

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.test_torch_port_train import _compare_grads
from tests.torch_port_common import CompiledAhead, cached_flax_shape_check, max_err, randomize, session_runs

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ljspeech")
CONFIGS = {"fast_pitch": "FastPitchConfig", "fast_speech": "FastSpeechConfig", "fastspeech2": "Fastspeech2Config",
           "speedy_speech": "SpeedySpeechConfig"}
MELS = 20
TEXT = "Be a voice, not an echo."
SPEAKERS = {"ana": 0, "ben": 1, "cleo": 2}


def tiny(cfg, speakers_file=None):
    """Either package's config at the tiny widths; FastSpeech with a
    3-speaker table when `speakers_file` is given."""
    ma = cfg.model_args
    ma.out_channels, ma.hidden_channels = MELS, 32
    cfg.audio.num_mels = MELS
    ma.encoder_params, ma.decoder_params = dict(ma.encoder_params), dict(ma.decoder_params)
    if ma.encoder_type == "fftransformer":
        for p in (ma.encoder_params, ma.decoder_params):
            p.update(num_layers=2, hidden_channels_ffn=48, num_heads=2, dropout_p=0.0)
    else:
        ma.encoder_params["dilations"], ma.decoder_params["dilations"] = [1, 2], [1, 2, 4]
    for k in ("duration", "pitch", "energy"):
        setattr(ma, f"{k}_predictor_hidden_channels", 24)
        setattr(ma, f"{k}_predictor_dropout_p", 0.0)
    if speakers_file:
        ma.use_speaker_embedding, ma.num_speakers = True, len(SPEAKERS)
        cfg.use_speaker_embedding, cfg.speakers_file = True, speakers_file
    cfg.text_cleaner, cfg.use_phonemes = "english_cleaners", False
    cfg.audio.do_trim_silence = False
    cfg.batch_size = cfg.eval_batch_size = 2
    cfg.num_loader_workers = 0
    return cfg


@functools.lru_cache(maxsize=None)
def speakers_file() -> str:
    path = os.path.join(tempfile.mkdtemp(), "speakers.json")
    with open(path, "w") as f:
        json.dump(SPEAKERS, f)
    return path


def _draw(tree, seed):
    """`randomize` with layer-norm and batch-norm scales 1 ± 0.1."""
    def fix(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "scale" and "pos_encoder" not in keys:
            return (1.0 + 0.1 * np.tanh(leaf)).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fix, randomize(tree, seed))


def _draw_port(net, seed: int):
    """Every parameter and BatchNorm statistic of a port net from a numpy
    seed: norm scales 1 ± 0.1, the duration head's weights ~N(0, 0.25²) and
    bias 1.5 (a few frames a token, the count varying from token to token),
    running variances in [0.5, 1.5], the rest ~N(0, 0.1²)."""
    from tpu_tts_torch.layers.common import LayerNorm

    rng = np.random.default_rng(seed)
    scales = {f"{n}.{leaf}" for n, m in net.named_modules()
              if isinstance(m, (torch.nn.LayerNorm, torch.nn.modules.batchnorm._BatchNorm, LayerNorm))
              for leaf in ("weight", "gamma")}
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name in scales:
                v = 1.0 + 0.1 * rng.uniform(-1, 1, t.shape)
            elif name.endswith("running_var"):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif name == "duration_predictor.proj.bias":
                v = np.full(t.shape, 1.5)
            elif name == "duration_predictor.proj.weight":
                v = 0.25 * rng.standard_normal(t.shape)
            else:
                v = 0.1 * rng.standard_normal(t.shape)
            t.copy_(torch.from_numpy(v.astype(np.float32)))


def _pop_stats(tree) -> dict:
    """The BatchNorm `mean`/`var` leaves of a converted tree, moved out of it
    into a `batch_stats` tree of the same paths."""
    stats = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = {"mean": v.pop("mean"), "var": v.pop("var")} if "mean" in v else _pop_stats(v)
            if sub:
                stats[k] = sub
    return stats


@functools.lru_cache(maxsize=None)
def pair(name, speakers_file=None):
    """(JAX `ForwardTTS`, port `ForwardTTS`) of one variant on the same
    weights: the port's, drawn from a numpy seed (`_draw_port`), carried to
    JAX through Coqui's names (`forward_convert.coqui_state_dict`) and
    `tpu_tts`'s `convert_forward_tts_torch_state_dict`, not a flax init
    trace; flax's shape check holds the tree to its layout when it runs.
    SpeedySpeech's BatchNorm statistics go to JAX's `batch_stats`."""
    import tpu_tts.configs.forward_tts_configs as jax_configs
    import tpu_tts_torch.configs.forward_tts_config as configs
    from tpu_tts.models.forward_convert import convert_forward_tts_torch_state_dict
    from tpu_tts.models.forward_tts import ForwardTTS as JaxForwardTTS
    from tpu_tts_torch.models.forward_convert import coqui_state_dict
    from tpu_tts_torch.models.forward_tts import ForwardTTS

    pm = ForwardTTS.init_from_config(tiny(getattr(configs, CONFIGS[name])(), speakers_file), device="cpu")
    _draw_port(pm.net, 3)
    sd = pm.net.state_dict()
    tree = convert_forward_tts_torch_state_dict({k: v.numpy() for k, v in coqui_state_dict(sd).items()}, num_heads=2)
    tree["pos_encoder"] = {"scale": sd["pos_encoder.scale"].numpy()}
    jm = JaxForwardTTS.init_from_config(tiny(getattr(jax_configs, CONFIGS[name])(), speakers_file))
    stats = _pop_stats(tree)
    jm.params, jm.model_state = tree, ({"batch_stats": stats} if stats else {})
    return jm, pm


def text_ids(model) -> np.ndarray:
    return np.asarray(model.tokenizer.text_to_ids(TEXT), dtype=np.int64)


# ------------------------------------------------------------------ layers
LAYERS = ("fft_block", "positional_encoding", "residual_conv_bn", "speedy_encoder", "speedy_decoder",
          "wavenet_decoder")
B, T, C = 2, 19, 16
LENGTHS = np.array([T, 11])


def _flax_layers():
    from tpu_tts.layers import feed_forward as ff

    return {
        "fft_block": ff.FFTransformerBlock(C, 2, 24, 2, 0.0),
        "positional_encoding": ff.PositionalEncoding(C, use_scale=True),
        "residual_conv_bn": ff.ResidualConv1dBNBlock(C, C, 4, (1, 3), 2, "layer"),
        "speedy_encoder": ff.ResidualConv1dBNEncoder(C, C, 4, (1, 2), 2, "batch"),
        "speedy_decoder": ff.ResidualConv1dBNDecoder(C, C, 4, (1, 2, 4), 2, "batch"),
        "wavenet_decoder": ff.WaveNetDecoder(C, C, 3, 2, 3),
    }


def _port_layer(name):
    from tpu_tts_torch.layers import feed_forward as ff

    return {
        "fft_block": lambda: ff.FFTransformerBlock(C, 2, 24, 2, 0.0),
        "positional_encoding": lambda: ff.PositionalEncoding(C, use_scale=True),
        "residual_conv_bn": lambda: ff.ResidualConv1dBNBlock(C, C, 4, (1, 3), 2, "layer"),
        "speedy_encoder": lambda: ff.ResidualConv1dBNEncoder(C, C, C, 4, (1, 2), 2, "batch"),
        "speedy_decoder": lambda: ff.ResidualConv1dBNDecoder(C, C, 4, (1, 2, 4), 2, "batch"),
        "wavenet_decoder": lambda: ff.WaveNetDecoder(C, C, 3, 2, 3),
    }[name]()


INFER = ("fast_pitch", "fast_speech_speakers", "fastspeech2", "speedy_speech")


def _infer_pair(variant):
    return pair("fast_speech", speakers_file()) if variant == "fast_speech_speakers" else pair(variant)


def _infer_aux(variant) -> dict:
    return {"speaker_ids": np.array([2], np.int32)} if variant == "fast_speech_speakers" else {}


@functools.lru_cache(maxsize=None)
def jax_program():
    """In one jitted float32 program: every layer's flax module on one input
    `[B, T, C]` (the second row 11 frames long), and `ForwardTTS.inference`
    of TEXT for each INFER variant (JAX's own method, its jitted net call
    inlined); compiled ahead. Returns (inputs, layer variables, the
    program)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32)[:, :, None]
    mods = _flax_layers()
    variables = {}
    for i, (name, mod) in enumerate(mods.items()):
        shapes = jax.eval_shape(lambda m=mod: m.init(jax.random.PRNGKey(0), x, mask))
        v = {"params": _draw(shapes["params"], 10 + i)}
        if "batch_stats" in shapes:
            v["batch_stats"] = jax.tree_util.tree_map_with_path(
                lambda p, leaf: (rng.uniform(0.5, 1.5, leaf.shape) if p[-1].key == "var"
                                 else 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32), shapes["batch_stats"])
        variables[name] = v
    models = {v: _infer_pair(v)[0] for v in INFER}
    ids = {v: text_ids(_infer_pair(v)[1]).astype(np.int32) for v in INFER}

    def run(vs, x, m):
        return ({n: mods[n].apply(vs[n], x, m) for n in mods},
                {v: jm.inference(ids[v], aux_input=_infer_aux(v)) for v, jm in models.items()})

    return (x, mask), variables, CompiledAhead(run, variables, x, mask)


def jax_refs():
    """(inputs, layer variables, layer outputs, inference outputs)."""
    inputs, variables, program = jax_program()
    return (inputs, variables, *program.result())


# ------------------------------------------------------------------ training
LOSS_VARIANTS = ("fast_pitch", "fastspeech2", "speedy_speech")


def _batch():
    """Two rows of 11 and 7 tokens over 40 and 29 mel frames from a numpy
    seed: a mel, a pitch in Hz (0 on unvoiced frames), an energy and the
    beta-binomial aligner priors."""
    from tpu_tts_torch.ops.helpers import compute_attn_prior

    rng = np.random.default_rng(21)
    x_lens, y_lens = np.array([11, 7]), np.array([40, 29])
    b = {"text_input": np.zeros((2, 11), np.int64), "text_lengths": x_lens, "mel_lengths": y_lens,
         "mel_input": np.zeros((2, 40, MELS), np.float32), "pitch": np.zeros((2, 40), np.float32),
         "energy": np.zeros((2, 40), np.float32), "attn_priors": np.zeros((2, 40, 11), np.float32)}
    for i in range(2):
        b["text_input"][i, : x_lens[i]] = rng.integers(1, 40, x_lens[i])
        b["mel_input"][i, : y_lens[i]] = rng.standard_normal((y_lens[i], MELS))
        b["pitch"][i, : y_lens[i]] = (100 + 150 * rng.uniform(size=y_lens[i])) * (rng.uniform(size=y_lens[i]) > 0.2)
        b["energy"][i, : y_lens[i]] = 5 * rng.uniform(size=y_lens[i])
        b["attn_priors"][i, : y_lens[i], : x_lens[i]] = compute_attn_prior(int(x_lens[i]), int(y_lens[i]))
    return b


@functools.lru_cache(maxsize=None)
def jax_loss_program():
    """`jax.value_and_grad(ForwardTTS.loss_fn)` of each LOSS_VARIANTS model on
    `_batch`, in one jitted program in float64 (x64, the float32 that the
    model, loss and norm code names read as float64), compiled ahead: per
    variant (loss, logs, the MAS durations, the new `batch_stats`), the
    gradient tree."""
    import tpu_tts.layers.common as jax_common
    import tpu_tts.layers.losses as jax_losses
    import tpu_tts.models.forward_tts as jax_ftts
    from tests.test_torch_port_vocoder_train import _Float64Numpy

    models = {v: pair(v)[0] for v in LOSS_VARIANTS}
    mas = jax_ftts.maximum_path_jax

    def step(params, states, batch):
        out = {}
        for v, jm in models.items():
            def loss_of(p, jm=jm, st=states[v]):
                seen = []

                def recorded(value, mask):
                    seen.append(mas(value, mask))
                    return seen[-1]

                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(jax_ftts, "maximum_path_jax", recorded)
                    loss, (logs, new_state) = jm.loss_fn(p, batch, jax.random.PRNGKey(0), model_state=st)
                return loss, (logs, seen[0].sum(-1), new_state)

            out[v] = jax.value_and_grad(loss_of, has_aux=True)(params[v])
        return out

    wide = functools.partial(jax.tree_util.tree_map, lambda v: np.asarray(v, np.float64) if v.dtype == np.float32 else v)
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        for module in (jax_ftts, jax_losses, jax_common):
            mp.setattr(module, "jnp", _Float64Numpy())
        return CompiledAhead(step, wide({v: jm.params for v, jm in models.items()}),
                             wide({v: jm.model_state for v, jm in models.items()}), wide(_batch()),
                             context=jax.enable_x64)


@pytest.fixture(scope="module", autouse=True)
def _compile_ahead(request, cached_flax_shape_check):
    """Both JAX programs traced before the module's first test; XLA compiles
    them while the second traces and the tests before the ones that read
    them (last in the module) run."""
    if session_runs(request, "test_layer", "test_inference", "test_synthesizer"):
        jax_program()
    if session_runs(request, "test_loss_fn"):
        jax_loss_program()


def test_eval_epoch_keeps_batchnorm_statistics(tmp_path):
    """The trainer's eval losses run the net in train mode, as JAX's do, and
    leave SpeedySpeech's BatchNorm running statistics as they were (JAX
    drops the eval step's `batch_stats`); a training step moves them."""
    from tpu_tts_torch.train import Trainer, TrainerArgs

    _, pm = pair("speedy_speech")
    model = copy.copy(pm)
    model.net = copy.deepcopy(pm.net)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    trainer = Trainer(TrainerArgs(device="cpu"), copy.deepcopy(pm.config), str(tmp_path), model=model)
    before = {k: v.clone() for k, v in model.net.named_buffers()}
    assert np.isfinite(trainer.eval_epoch([batch]))
    assert all(torch.equal(before[k], v) for k, v in model.net.named_buffers())
    trainer.train_step(batch)
    assert not torch.equal(before["encoder.postnet_norm.running_var"], model.net.encoder.postnet_norm.running_var)


# ------------------------------------------------------------------ data
def _samples(load):
    from tpu_tts.config.shared_configs import BaseDatasetConfig

    ds = BaseDatasetConfig(formatter="ljspeech", meta_file_train="metadata.csv", path=FIXTURE, dataset_name="fix")
    samples, _ = load([ds], eval_split=False)
    return [s for s in samples if os.path.basename(s["audio_file"])[:-4] in ("LJ001-0001", "LJ001-0004")]


def test_energy_collate_matches_jax():
    """FastSpeech2's loader (`compute_energy`, pitch off here: pyin is held in
    `test_torch_port_delightful_train.py`) against `tpu_tts`'s."""
    from tpu_tts.data import load_tts_samples as jax_load
    from tpu_tts_torch.data import load_tts_samples

    jm, pm = pair("fastspeech2")
    jc, pc = copy.deepcopy(jm.config), copy.deepcopy(pm.config)
    jc.compute_f0 = pc.compute_f0 = False
    (jb,) = list(jm.get_data_loader(jc, {}, False, _samples(jax_load), False, 1))
    (pb,) = list(pm.get_data_loader(pc, {}, False, _samples(load_tts_samples), False))
    assert "pitch" not in pb and pb["energy"].shape == jb["energy"].shape == (2, jb["mel_input"].shape[1])
    assert max_err(pb["energy"], jb["energy"]) <= 1e-5 * float(np.abs(jb["energy"]).max())
    assert (pb["energy"][1, int(pb["mel_lengths"][1]):] == 0).all() and float(pb["energy"].min()) >= 0


# ------------------------------------------------------------------ Coqui keys
@pytest.mark.parametrize("variant", ["fast_pitch", "speedy_speech"])
def test_coqui_keys_round_trip(variant, tmp_path):
    """Coqui's names (written from the port's weights by
    `forward_convert.coqui_state_dict`) through `tpu_tts`'s
    `convert_forward_tts_torch_state_dict` and `params_from_flax`, and
    through the port's own reader: the same tensors; then a `.pth` of them
    loaded by `ForwardTTS.load_checkpoint` gives the same mel (SpeedySpeech
    rebuilt with `frozen_batch`)."""
    from tpu_tts.models.forward_convert import convert_forward_tts_torch_state_dict
    from tpu_tts_torch.models import setup_model
    from tpu_tts_torch.models.forward_convert import coqui_state_dict, params_from_flax, state_dict_from_coqui

    _, pm = pair(variant)
    target = pm.net.state_dict()
    coqui = {**coqui_state_dict(target), "pos_encoder.pe": torch.zeros(1, 8, 32)}  # a buffer both readers recompute
    via_jax = params_from_flax(convert_forward_tts_torch_state_dict({k: v.numpy() for k, v in coqui.items()}))
    ours = state_dict_from_coqui(coqui, target)
    assert set(ours) == set(target)
    assert set(via_jax) == {k for k in target if k != "pos_encoder.scale"}  # tpu_tts keeps the scale's init
    for k, v in via_jax.items():
        assert torch.equal(ours[k].reshape(v.shape), v) and torch.equal(ours[k], target[k]), k

    torch.save({"model": coqui, "config": {}}, tmp_path / "coqui.pth")
    m = setup_model(copy.deepcopy(pm.config), device="cpu")
    m.load_checkpoint(m.config, str(tmp_path / "coqui.pth"))
    assert m.args.norm_type == ("frozen_batch" if variant == "speedy_speech" else "batch")
    ids = text_ids(pm)
    got, ref = m.inference(ids), pm.inference(ids)
    assert torch.equal(got["y_lengths"], ref["y_lengths"]) and max_err(got["model_outputs"], ref["model_outputs"]) <= 1e-6


# ------------------------------------------------------------------ serving
@functools.lru_cache(maxsize=None)
def _vocoder_files(root):
    """A tiny HiFi-GAN (`tests/test_torch_port_vocoder.py`'s widths), its
    generator alone, JAX's and the port's on the same seeded weights (the
    JAX tree laid out by `tpu_tts`'s converter); the port's as a Coqui
    `.pth` + `config.json` under `root`."""
    from tests.test_torch_port_vocoder import TINY_HIFIGAN, _audio
    from tpu_tts.config.shared_configs import BaseAudioConfig as JaxAudio
    from tpu_tts.vocoder.configs import HifiganConfig as JaxHifiganConfig
    from tpu_tts.vocoder.models.gan import GAN as JaxGAN
    from tpu_tts.vocoder.models.vocoder_convert import convert_gan_torch_state_dict
    from tpu_tts_torch.config.shared_configs import BaseAudioConfig
    from tpu_tts_torch.vocoder.configs import HifiganConfig
    from tpu_tts_torch.vocoder.models import setup_model
    from tpu_tts_torch.vocoder.models.vocoder_convert import gan_state_dict_from_flax

    jv = JaxGAN.init_from_config(JaxHifiganConfig(audio=JaxAudio(**_audio()), **TINY_HIFIGAN))
    pv = setup_model(HifiganConfig(audio=BaseAudioConfig(**_audio()), **TINY_HIFIGAN), device="cpu",
                     discriminator=False)
    tree = convert_gan_torch_state_dict({k: v.numpy() for k, v in pv.net.state_dict().items()},
                                        generator_name=pv.config.generator_model)["generator"]
    del tree["conv_post"]["bias"]  # the converter's zero fill of the bias the model leaves out
    jv.params = {"generator": randomize(tree, 11)}
    pv.net.load_state_dict(gan_state_dict_from_flax(jv.params, pv.config.generator_model, 4), strict=True)
    paths = {"vocoder_path": os.path.join(root, "vocoder.pth"),
             "vocoder_config_path": os.path.join(root, "vocoder.json")}
    torch.save({"model": pv.net.state_dict()}, paths["vocoder_path"])
    pv.config.save_json(paths["vocoder_config_path"])
    return jv, paths


@pytest.fixture(scope="module")
def vocoder(tmp_path_factory):
    return _vocoder_files(str(tmp_path_factory.mktemp("vocoder")))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_setup_model_from_config_and_json(name, tmp_path):
    """`setup_model` builds each variant from its config and from the saved
    `config.json` (`base_model` → `forward_tts`), with the variant's
    switches; another model name still raises."""
    import tpu_tts_torch.configs.forward_tts_config as configs
    from tpu_tts_torch.config import load_config
    from tpu_tts_torch.models import setup_model
    from tpu_tts_torch.models.forward_tts import ForwardTTS

    cfg = tiny(getattr(configs, CONFIGS[name])())
    cfg.save_json(str(tmp_path / "c.json"))
    loaded = load_config(str(tmp_path / "c.json"))
    assert type(loaded) is type(cfg) and loaded.model == name and loaded.base_model == "forward_tts"
    for c in (cfg, loaded):
        m = setup_model(c, device="cpu")
        assert isinstance(m, ForwardTTS)
        assert hasattr(m.net, "pitch_predictor") == (name in ("fast_pitch", "fastspeech2"))
        assert hasattr(m.net, "energy_predictor") == (name == "fastspeech2")
    assert sum(p.numel() for p in m.net.parameters()) == sum(p.numel() for p in pair(name)[1].net.parameters())
    with pytest.raises(NotImplementedError, match="not ported"):
        setup_model(argparse.Namespace(model="tacotron2", base_model=None), device="cpu")


def _pcm(body: bytes) -> np.ndarray:
    return scipy.io.wavfile.read(io.BytesIO(body))[1].astype(np.int32)


def test_train_tts_cli_continue_and_serve(vocoder, tmp_path, capsys):
    """`bin/train_tts` trains a tiny FastPitch one epoch on the fixture
    (`--small_run 2`: one step of 2 clips, pyin F0 cached, then the eval),
    `--continue_path` resumes it for a second, and the newest checkpoint
    serves behind the tiny HiFi-GAN through the `Synthesizer`, `/api/tts`,
    `api.TTS` and the CLI, each giving the same 16-bit waveform."""
    import tpu_tts_torch.configs.forward_tts_config as configs
    from tpu_tts_torch.api import TTS
    from tpu_tts_torch.audio import wav_to_pcm16
    from tpu_tts_torch.bin import synthesize
    from tpu_tts_torch.bin.train_tts import main as train_main
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.ops import mas
    from tpu_tts_torch.server.server import create_server
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint, load_checkpoint

    _, voc = vocoder
    out = str(tmp_path / "run")
    cfg = tiny(configs.FastPitchConfig())
    cfg.update(dict(epochs=1, print_step=1, save_step=10000, output_path=out, eval_split_size=0.25, run_eval=True,
                    test_delay_epochs=-1, f0_cache_path=str(tmp_path / "f0"), dashboard_logger="none",
                    datasets=[BaseDatasetConfig(formatter="ljspeech", meta_file_train="metadata.csv", path=FIXTURE,
                                                dataset_name="fix")]))
    cfg_path = str(tmp_path / "config.json")
    cfg.save_json(cfg_path)
    mas.load_library()
    train_main(["--config_path", cfg_path, "--device", "cpu", "--small_run", "2"])
    first, _ = get_last_checkpoint(out)
    state = load_checkpoint(first)
    assert state["epoch"] == 1 and state["step"] == 1 and len(state["optimizer"]) == 1
    assert any(k.startswith("aligner.") for k in state["model"]) and "pitch_emb.conv.weight" in state["model"]
    assert len(os.listdir(tmp_path / "f0")) >= 2  # the pitch cache

    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    saved["epochs"] = 2
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(saved, f)
    train_main(["--continue_path", out, "--device", "cpu", "--small_run", "2"])
    last, _ = get_last_checkpoint(out)
    resumed = load_checkpoint(last)
    assert resumed["step"] == 2 and resumed["epoch"] == 2
    assert any(not torch.equal(resumed["model"][k], state["model"][k]) for k in state["model"])

    paths = {"model_path": last, "config_path": os.path.join(out, "config.json"), **voc}
    synth = Synthesizer(paths["model_path"], paths["config_path"], paths["vocoder_path"],
                        paths["vocoder_config_path"], device="cpu")
    wav = np.asarray(synth.tts(TEXT), dtype=np.float32)
    assert wav.size > 1000 and np.isfinite(wav).all() and float(np.std(wav)) > 1e-4
    ref = wav_to_pcm16(wav).astype(np.int32)

    server = create_server(argparse.Namespace(**paths, device="cpu", host="127.0.0.1", port=0))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/api/tts",
                                     data=json.dumps({"text": TEXT}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            np.testing.assert_array_equal(_pcm(r.read()), ref)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    tts = TTS(model_path=paths["model_path"], config_path=paths["config_path"], vocoder_path=paths["vocoder_path"],
              vocoder_config_path=paths["vocoder_config_path"], device="cpu")
    np.testing.assert_array_equal(_pcm(open(tts.tts_to_file(text=TEXT, file_path=str(tmp_path / "api.wav")),
                                            "rb").read()), ref)
    synthesize.main(["--text", TEXT, "--out_path", str(tmp_path / "cli.wav"), "--device", "cpu",
                     *[a for k, v in paths.items() for a in (f"--{k}", v)]])
    np.testing.assert_array_equal(_pcm(open(tmp_path / "cli.wav", "rb").read()), ref)
    capsys.readouterr()


# ------------------------------------------------- the tests that read the JAX programs, last
@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_flax(name):
    from tpu_tts_torch.models.forward_convert import params_from_flax

    (x, mask), variables, refs, _ = jax_refs()
    mod = _port_layer(name).eval()
    v = variables[name]
    mod.load_state_dict(params_from_flax(v["params"], v.get("batch_stats")), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == refs[name].shape and float(np.abs(refs[name]).max()) > 0.1
    assert max_err(got, refs[name]) <= 1e-5


@pytest.mark.parametrize("variant", INFER)
def test_inference_matches_jax(variant):
    jm, pm = _infer_pair(variant)
    ids = text_ids(pm)
    np.testing.assert_array_equal(ids, jm.tokenizer.text_to_ids(TEXT))
    ref = jax_refs()[3][variant]
    got = pm.inference(ids, aux_input=_infer_aux(variant))
    w = (np.exp(ref["durations_log"][0]) - 1.0) * pm.args.length_scale
    w = w[w > 1.0]
    assert w.size and np.min(np.abs(np.abs(w - np.floor(w)) - 0.5)) >= 1e-3, f"a .5 near-tie in JAX's durations {w}"
    assert max_err(got["durations_log"], ref["durations_log"]) <= 1e-5
    np.testing.assert_array_equal(got["alignments"].numpy(), ref["alignments"])
    np.testing.assert_array_equal(got["y_lengths"].numpy(), ref["y_lengths"])
    durations = got["durations"].numpy()[0]
    assert durations.sum() == ref["y_lengths"][0] > len(ids) and len(np.unique(durations)) > 1
    assert got["model_outputs"].shape == ref["model_outputs"].shape
    assert max_err(got["model_outputs"], ref["model_outputs"]) <= 1e-4


def test_synthesizer_fast_pitch_hifigan_matches_jax(vocoder, tmp_path):
    """FastPitch → the tiny HiFi-GAN through the port's `Synthesizer` against
    JAX's FastPitch mel, the denormalize → normalize handshake and JAX's
    `GAN.inference`: within 2e-4. On the CPU K1's plain version decodes."""
    from tpu_tts.audio import AudioProcessor as JaxAP
    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP, Synthesizer

    jv, paths = vocoder
    jm, pm = pair("fast_pitch")
    torch.save(pm.net.state_dict(), tmp_path / "fp.pth")
    pm.config.save_json(str(tmp_path / "fp.json"))
    synth = Synthesizer(str(tmp_path / "fp.pth"), str(tmp_path / "fp.json"), paths["vocoder_path"],
                        paths["vocoder_config_path"], device="cpu")
    wav = np.asarray(synth.tts(TEXT), dtype=np.float32)

    out = jax_refs()[3]["fast_pitch"]
    mel = out["model_outputs"][0, : int(out["y_lengths"][0])]
    voc_ap = JaxAP(verbose=False, **synth.vocoder_config.audio.to_dict())
    ref = np.asarray(jv.inference(voc_ap.normalize(jm.ap.denormalize(mel.T)).T.astype(np.float32)))[0, :, 0]
    assert len(wav) == len(ref) + SENTENCE_GAP == mel.shape[0] * 16 + SENTENCE_GAP and float(np.std(ref)) > 1e-3
    assert max_err(wav[: len(ref)], ref) <= 2e-4


@pytest.mark.parametrize("variant", LOSS_VARIANTS)
def test_loss_fn_matches_jax(variant, monkeypatch):
    import tpu_tts_torch.models.forward_tts as ftts
    from tpu_tts_torch.models.forward_convert import params_from_flax

    (ref_loss, (ref_logs, ref_durations, ref_state)), ref_grads = jax_loss_program().result()[variant]
    _, pm = pair(variant)
    net = copy.deepcopy(pm.net).double().train(True)
    model = copy.copy(pm)
    model.net = net
    seen = []
    mas = ftts.maximum_path
    monkeypatch.setattr(ftts, "maximum_path", lambda v, m: seen.append(mas(v, m)) or seen[-1])
    batch = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in _batch().items()}
    loss, logs = model.loss_fn(batch)
    loss.backward()
    assert loss.dtype == torch.float64
    assert set(logs) == set(ref_logs) and {"loss_ssim", "loss_binary_alignment", "loss_aligner"} <= set(logs)
    for k, v in ref_logs.items():
        assert abs(float(logs[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, float(logs[k]), float(v))
    durations = seen[0].sum(-1).numpy()
    np.testing.assert_array_equal(durations, ref_durations)
    assert durations.sum(1).tolist() == [40, 29] and len(np.unique(durations[0])) > 2
    _compare_grads({n: p.grad for n, p in net.named_parameters()}, params_from_flax(ref_grads), variant)
    if variant == "speedy_speech":
        want = {k: v for k, v in params_from_flax({}, ref_state["batch_stats"]).items() if "running" in k}
        got = dict(net.named_buffers())
        assert want and all(max_err(got[k], want[k]) <= 1e-6 for k in want)
        assert max_err(got["encoder.postnet_norm.running_var"], pm.net.encoder.postnet_norm.running_var) > 1e-3
