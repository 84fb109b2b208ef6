"""Multi-speaker, multilingual VITS training and VITS voice conversion in the
port against `tpu_tts` on the CPU, f32.

The model is the multilingual recipe's shape at the tiny widths of
`tests/torch_port_common.py` (a speaker table, a language table, the
deterministic duration predictor), cut as `tests/test_torch_port_train.py`
cuts it, without dropout. Both packages read the same numpy-seeded weights,
batch (with per-row speaker and language ids) and draws (the posterior's ε
and the segment uniforms; the JAX side takes them by patching
`jax.random.normal`/`uniform` while it traces). Tolerances:
- one D step and one G step: each loss term within 1e-5 relative, every
  parameter's gradient within 1e-3 of its tensor's largest |gradient| plus
  1e-6 (the bars of `tests/test_torch_port_train.py`), `emb_g` and `emb_l`
  among them with nonzero gradients;
- the collate's speaker ids, language ids and d-vectors equal, the
  balancers' weights within 1e-12, `speakers.pth` and `language_ids.json`
  equal;
- voice conversion within 2e-4 (the VITS waveform bar) of
  `Vits.voice_conversion`, and through the `Synthesizer` and the CLI.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.test_torch_port_train import (
    TRAIN_ARGS,
    _compare_grads,
    _effective_jax_tree,
    _effective_torch_grads,
    patch_jax_draws,
)
from tests.torch_port_common import (
    SEED,
    TINY_ARGS,
    TINY_AUDIO,
    flax_param_shapes,
    cached_flax_shape_check,
    max_err,
    randomize,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

SPEAKER_ARGS = dict(TRAIN_ARGS, use_speaker_embedding=True, num_speakers=3, speaker_embedding_channels=8,
                    use_language_embedding=True, embedded_language_dim=4, num_languages=2, use_sdp=False)
SPEAKERS, LANGUAGES = {"ana": 0, "ben": 1, "cho": 2}, {"en": 0, "fr": 1}
B, T_X, T_SPEC, HOP = 2, 11, 24, 16
PERIODS = TINY_ARGS["periods_multi_period_discriminator"]


def configs(**config_kw):
    """The JAX and the port's `VitsConfig`, with a dataset of each language
    (the language manager reads them)."""
    from tpu_tts.config.shared_configs import BaseDatasetConfig as JaxDataset
    from tpu_tts.configs.vits_config import VitsArgs as JaxArgs
    from tpu_tts.configs.vits_config import VitsAudioConfig as JaxAudio
    from tpu_tts.configs.vits_config import VitsConfig as JaxConfig
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig

    args = {**TINY_ARGS, **SPEAKER_ARGS}
    return (JaxConfig(model_args=JaxArgs(**args), audio=JaxAudio(**TINY_AUDIO),
                      datasets=[JaxDataset(language=lang) for lang in LANGUAGES], **config_kw),
            VitsConfig(model_args=VitsArgs(**args), audio=VitsAudioConfig(**TINY_AUDIO),
                       datasets=[BaseDatasetConfig(language=lang) for lang in LANGUAGES], **config_kw))


@functools.lru_cache(maxsize=None)
def jax_model():
    """The tiny multi-speaker multilingual JAX `Vits`: the generator's tree
    from a flax trace of the training forward with ids (the JAX converter
    misplaces multi-speaker weights, ROADMAP F2), the discriminator's from
    the converter; both drawn from numpy seeds."""
    from tpu_tts.models.vits import Vits
    from tpu_tts.models.vits_convert import convert_vits_torch_state_dict
    from tpu_tts_torch.models.vits import Vits as PortVits

    jcfg, pcfg = configs()
    jm = Vits(jcfg)
    ids = jnp.zeros((1,), jnp.int32)
    gen = flax_param_shapes(jm.net, jnp.zeros((1, 8), jnp.int32), jnp.array([8]), jnp.zeros((1, 12, 33)),
                            jnp.array([12]), speaker_ids=ids, language_ids=ids, train=True)
    pm = PortVits(pcfg, device="cpu")
    pm.init_training()
    disc = convert_vits_torch_state_dict({k: v.numpy() for k, v in pm.training_state_dict().items()})["discriminator"]
    jm.params = {"generator": randomize(gen, SEED), "discriminator": randomize(disc, SEED + 1)}
    return jm


def port_model(**config_kw):
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.models.vits_convert import training_params_from_flax

    pm = Vits(configs(**config_kw)[1], device="cpu")
    pm.init_training()
    pm.load_training_state(training_params_from_flax(jax_model().params, PERIODS), strict=True)
    return pm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, T_X), np.int32)
    x[0], x[1, :7] = rng.integers(1, 40, T_X), rng.integers(1, 40, 7)
    spec_lengths = np.array([T_SPEC, 18], np.int32)
    wav = np.zeros((B, T_SPEC * HOP), np.float32)
    for i, n in enumerate(spec_lengths):
        t = np.arange(n * HOP)
        wav[i, : n * HOP] = 0.4 * np.sin(2 * np.pi * (0.03 + 0.01 * i) * t) + 0.05 * rng.standard_normal(n * HOP)
    ids = {"speaker_ids": np.array([2, 0], np.int32), "language_ids": np.array([1, 0], np.int32)}
    draws = {"posterior": rng.standard_normal((B, T_SPEC, TINY_ARGS["hidden_channels"])).astype(np.float32),
             "sdp": np.zeros((1,), np.float32),  # no SDP: never drawn
             "segments": rng.uniform(size=B).astype(np.float32)}
    jb = {"text_input": x, "text_lengths": np.array([T_X, 7], np.int32), "mel_lengths": spec_lengths,
          "waveform": wav[:, :, None], **ids}
    pb = {"text_input": torch.from_numpy(x).long(), "text_lengths": torch.tensor([T_X, 7]),
          "mel_lengths": torch.from_numpy(spec_lengths).long(), "waveform": torch.from_numpy(wav)[:, None],
          **{k: torch.from_numpy(v).long() for k, v in ids.items()}}
    pd = {"posterior": torch.from_numpy(draws["posterior"]).transpose(1, 2),
          "segments": torch.from_numpy(draws["segments"])}
    return jb, pb, draws, pd


@functools.lru_cache(maxsize=None)
def jax_step_refs():
    """`jax.value_and_grad(Vits.loss_fn)` of the D step (0) and the G step (1), in one program."""
    jm = jax_model()
    jb, _, draws, _ = _batch()

    def step(params, batch):
        return [jax.value_and_grad(lambda sub, idx=idx, key=key: jm.loss_fn({**params, key: sub}, batch,
                                                                            jax.random.PRNGKey(0), idx),
                                   has_aux=True)(params[key])
                for idx, key in ((0, "discriminator"), (1, "generator"))]

    with pytest.MonkeyPatch.context() as mp:
        patch_jax_draws(mp, draws)
        return jax.device_get(jax.jit(step)(jm.params, {k: jnp.asarray(v) for k, v in jb.items()}))


@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_speakers_train_step_matches_jax(optimizer_idx):
    """One D step (0) or G step (1) of the multi-speaker multilingual
    `Vits.loss_fn` against JAX's: every loss term and every gradient, with
    the speaker and language embeddings' in the G step."""
    from tpu_tts_torch.models.vits_convert import disc_params_from_flax, params_from_flax

    jm, pm = jax_model(), port_model()
    pm.train(True)
    _, pb, _, pd = _batch()
    (ref_loss, ref_logs), ref_grads = jax_step_refs()[optimizer_idx]
    loss, logs = pm.loss_fn(pb, optimizer_idx, draws=pd)
    loss.backward()
    for k, v in ref_logs.items():
        assert abs(float(logs[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, float(logs[k]), float(v))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * max(1.0, abs(float(ref_loss)))
    key = "discriminator" if optimizer_idx == 0 else "generator"
    eff = _effective_jax_tree(jm.params[key], ref_grads)
    if optimizer_idx == 0:
        _compare_grads(_effective_torch_grads(pm.disc), disc_params_from_flax(eff, PERIODS), "D")
        return
    _compare_grads(_effective_torch_grads(pm.net), params_from_flax(eff), "G")
    for name in ("emb_g.weight", "emb_l.weight"):
        assert float(dict(pm.net.named_parameters())[name].grad.abs().max()) > 0, name


def _write_clips(root, rows, seed=3):
    rng = np.random.default_rng(seed)
    samples = []
    for i, (speaker, language) in enumerate(rows):
        path = os.path.join(root, f"c{i}.wav")
        scipy.io.wavfile.write(path, 22050, (0.3 * rng.standard_normal(200 + 37 * i) * 16000).astype(np.int16))
        samples.append({"text": "hello there"[: 4 + i], "audio_file": path, "speaker_name": speaker,
                        "language": language, "root_path": root, "audio_unique_name": f"c{i}"})
    return samples


def test_collate_ids_dvectors_balancers_and_id_files_match_jax(tmp_path):
    """The collate's `speaker_ids`, `language_ids` and `d_vectors` against the
    JAX collate on the same items; the speaker, language and length
    balancers' weights; the loader's weighted draws; `on_init_start`'s
    `speakers.pth` and `language_ids.json` against JAX's."""
    from types import SimpleNamespace

    from tpu_tts.audio import AudioProcessor as JaxAP
    from tpu_tts.data.dataset import TTSDataset as JaxDataset
    from tpu_tts.models.base_tts import BaseTTSModel as JaxBase
    from tpu_tts.models.vits import Vits as JaxVits
    from tpu_tts.text.tokenizer import TTSTokenizer as JaxTokenizer
    from tpu_tts_torch.audio import AudioProcessor
    from tpu_tts_torch.data.dataset import TTSDataLoader, TTSDataset
    from tpu_tts_torch.managers import SpeakerManager
    from tpu_tts_torch.models.base_tts import sampler_weights
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.text.tokenizer import TTSTokenizer

    rows = [("ana", "en"), ("ben", "en"), ("ana", "fr"), ("cho", "en"), ("ben", "fr"), ("ana", "en")]
    samples = _write_clips(str(tmp_path), rows)
    dvec = {n: [list(np.random.default_rng(i).standard_normal(4))] for i, n in enumerate(SPEAKERS)}
    jcfg, pcfg = configs(use_speaker_weighted_sampler=True, use_language_weighted_sampler=True,
                         use_length_weighted_sampler=True, length_weighted_sampler_alpha=0.5)
    maps = dict(speaker_id_mapping=SPEAKERS, d_vector_mapping=dvec, language_id_mapping=LANGUAGES)
    jtok, pok = JaxTokenizer.init_from_config(jcfg)[0], TTSTokenizer.init_from_config(pcfg)[0]
    jd = JaxDataset(samples=list(samples), ap=JaxAP.init_from_config(jcfg, verbose=False), tokenizer=jtok,
                    return_wav=True, **maps)
    pdata = TTSDataset(samples=list(samples), ap=AudioProcessor.init_from_config(pcfg), tokenizer=pok,
                       return_wav=True, **maps)
    jb, pb = jd.collate_fn([jd[i] for i in range(4)]), pdata.collate_fn([pdata[i] for i in range(4)])
    for k in ("speaker_ids", "language_ids", "d_vectors"):
        np.testing.assert_array_equal(pb[k].numpy(), jb[k], err_msg=k)

    for s in samples:  # the length balancer reads the audio length
        s["audio_length"] = os.path.getsize(s["audio_file"])
    w = sampler_weights(pcfg, samples)
    np.testing.assert_allclose(w, JaxBase._sampler_weights(jcfg, samples), rtol=0, atol=1e-12)
    assert w[2] > w[0]  # a French clip of a frequent speaker outweighs an English one
    loader = TTSDataLoader(pdata, batch_size=3, seed=5, weights=w)
    loader.set_epoch(2)
    drawn = sorted(i for b in loader._batch_indices() for i in b)
    want = np.random.default_rng([5, 2]).choice(len(samples), size=len(samples), replace=True, p=w / w.sum())
    assert drawn == sorted(int(i) for i in want)

    pm = Vits.init_from_config(pcfg, device="cpu", samples=samples)
    assert pm.speaker_manager.name_to_id == SPEAKERS and isinstance(pm.speaker_manager, SpeakerManager)
    jm = JaxVits.init_from_config(jcfg, samples=samples)
    outs = {}
    for name, m, cfg in (("port", pm, pm.config), ("jax", jm, jm.config)):
        out = tmp_path / name
        os.makedirs(out)
        m.on_init_start(SimpleNamespace(output_path=str(out), config=cfg))
        with open(out / "language_ids.json") as f:
            outs[name] = (torch.load(out / "speakers.pth", weights_only=False), json.load(f),
                          cfg.model_args.speakers_file)
    assert outs["port"][:2] == outs["jax"][:2] == (SPEAKERS, LANGUAGES)
    assert outs["port"][2] == str(tmp_path / "port" / "speakers.pth")


def _source_wav(seed=9, frames=21):
    t = np.arange(frames * HOP)
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * 0.02 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


class JitNet:
    """A flax module whose `apply` runs jitted (JAX's voice conversion calls
    `self.net.apply` eagerly, op by op)."""

    def __init__(self, net):
        self._apply = jax.jit(net.apply, static_argnames=("method",))

    def apply(self, *args, **kwargs):
        return self._apply(*args, **kwargs)


def jax_voice_conversion(monkeypatch, fn, eps: np.ndarray):
    """`fn()` (a JAX voice conversion) with the posterior's ε = `eps` `[1, T, C]` and the net jitted."""
    jm = jax_model()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps))
    monkeypatch.setattr(jm, "net", JitNet(jm.net))
    try:
        return fn()
    finally:
        monkeypatch.undo()


def test_voice_conversion_matches_jax(monkeypatch):
    """`Vits.voice_conversion` from speaker 0 to 2 against JAX's on the same
    ε (JAX's `normal` patched), within 2e-4; another target moves the
    waveform."""
    jm, pm = jax_model(), port_model()
    pm.train(False)
    wav = _source_wav()
    eps = np.random.default_rng(4).standard_normal((1, 21, TINY_ARGS["hidden_channels"])).astype(np.float32)
    ref = jax_voice_conversion(monkeypatch, lambda: jm.voice_conversion(wav, 0, 2), eps)
    got = pm.voice_conversion(wav, 0, 2, noise=torch.from_numpy(eps).transpose(1, 2))
    assert got.shape == ref.shape == (21 * HOP,)
    assert float(np.std(ref)) > 1e-3 and max_err(got, ref) <= 2e-4
    other = pm.voice_conversion(wav, 0, 1, noise=torch.from_numpy(eps).transpose(1, 2))
    assert max_err(other, got) > 1e-3


def test_synthesizer_and_cli_voice_conversion_match_jax(tmp_path, monkeypatch):
    """A trained checkpoint (posterior encoder included) through
    `Synthesizer.tts(reference_wav=, reference_speaker_name=)` and the CLI's
    `--reference_wav`, against JAX's `transfer_voice` on the port's ε
    (a generator seeded 0)."""
    from tpu_tts.infer.synthesis import transfer_voice
    from tpu_tts_torch.bin.synthesize import main as synth_main
    from tpu_tts_torch.configs.shared_configs import CharactersConfig
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    jm, pm = jax_model(), port_model()
    paths = {k: str(tmp_path / f) for k, f in (("model", "model.pth"), ("config", "config.json"),
                                               ("speakers", "speakers.json"), ("ref", "ref.wav"),
                                               ("out", "out.wav"))}
    torch.save({"model": pm.training_state_dict(), "step": 3}, paths["model"])
    with open(paths["speakers"], "w") as f:
        json.dump(SPEAKERS, f)
    cfg = pm.config
    cfg.characters = CharactersConfig(  # 40 symbols, the tiny model's `num_chars`
        characters_class="tpu_tts_torch.text.characters.Graphemes", pad="<PAD>", eos="<EOS>", bos="<BOS>",
        blank="<BLNK>", characters="abcdefghijklmnopqrstuvwxyz", punctuations="!'(),-.:;?")
    cfg.model_args.speakers_file = paths["speakers"]
    cfg.audio.do_trim_silence = False
    cfg.save_json(paths["config"])
    wav = _source_wav()
    scipy.io.wavfile.write(paths["ref"], TINY_AUDIO.get("sample_rate", 22050), wav)

    synth = Synthesizer(paths["model"], paths["config"], device="cpu")
    got = np.asarray(synth.tts(reference_wav=paths["ref"], speaker_name="cho", reference_speaker_name="ana"))
    eps = torch.randn(1, TINY_ARGS["hidden_channels"], 21, generator=torch.Generator().manual_seed(0))
    ref = jax_voice_conversion(monkeypatch, lambda: transfer_voice(jm, jm.config, wav, speaker_id=2,
                                                                   reference_speaker_id=0),
                               eps.transpose(1, 2).numpy())
    assert got.shape == ref.shape and max_err(got, ref) <= 2e-4

    synth_main(["--model_path", paths["model"], "--config_path", paths["config"], "--device", "cpu",
                "--reference_wav", paths["ref"], "--reference_speaker_idx", "ana", "--speaker_idx", "cho",
                "--out_path", paths["out"]])
    _, pcm = scipy.io.wavfile.read(paths["out"])
    assert pcm.shape == got.shape
