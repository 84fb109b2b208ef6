"""Multi-speaker, multilingual and d-vector VITS in the port against `tpu_tts` (CPU, f32, noise scales 0).

The same numpy-seeded weights go into both packages (the JAX tree drawn by
`randomize`, carried into the port by `params_from_flax`), and the same
token ids, speaker ids, language ids and d-vectors go through both
`Vits.inference`:

- (a) `emb_g` + `emb_l` + the deterministic duration predictor, the
  multilingual recipe's shape; the text encoder runs at 32 + 4 channels;
- (b) d-vectors + the stochastic duration predictor + ResBlock2 + a deeper
  text encoder, YourTTS's shape scaled down;
- (c) `encoder_sample_rate` (the flow's output interpolated ×2 in time),
  with `interpolate_z` on and off;
- (d) a speaker embedding with `condition_dp_on_speaker=False`.

(c) and (d) use the deterministic duration predictor; (b) holds the SDP.

Each case: per-row `y_lengths` and durations equal, the waveform within
2e-4 over each row's valid length, and the conditioning live (other speaker
ids change the waveform). The JAX-side raw durations are first held ≥ 1e-3
from an integer. Then, on case (a) built from its config with speakers and
language files: the micro-batcher on a mixed batch (two speakers, two
languages, one request of two sentences, padded to B = 4) row by row against
the JAX micro-batcher; `Synthesizer.tts` against the JAX synthesizer; the
server's `/api/tts?speaker_id=&language_id=`, `api.TTS` and the CLI from a
Coqui-format checkpoint; a Coqui-format multi-speaker `.pth` round trip; and
the managers against `tpu_tts.managers`.
"""

import argparse
import io
import json
import threading
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.torch_port_common import SEED, TINY_ARGS, TINY_AUDIO, max_err, randomize

torch.set_num_threads(1)

HOP = 16  # TINY_AUDIO
WAVE_TOL = 2e-4  # the VITS parity bar of tests/test_torch_port_vits.py
SPEAKERS = {"ana": 0, "ben": 1, "cho": 2}
LANGUAGES = {"en": 0, "fr": 1}

CASES = {
    "a_multilingual_dp": dict(use_speaker_embedding=True, num_speakers=3, speaker_embedding_channels=16,
                              use_language_embedding=True, embedded_language_dim=4, num_languages=2, use_sdp=False),
    "b_yourtts": dict(use_d_vector_file=True, d_vector_dim=16, resblock_type_decoder="2", num_layers_text_encoder=3),
    # the deterministic duration predictor in (c) and (d): the SDP's spline
    # flows cost the JAX side seconds of compile, and (b) holds the SDP
    "c_encoder_rate_linear": dict(encoder_sample_rate=11025, interpolate_z=True, use_sdp=False),
    "c_encoder_rate_nearest": dict(encoder_sample_rate=11025, interpolate_z=False, use_sdp=False),
    "d_dp_unconditioned": dict(use_speaker_embedding=True, num_speakers=3, speaker_embedding_channels=16,
                               condition_dp_on_speaker=False, use_sdp=False),
}
LENGTHS = [13, 7, 20, 10]


def configs(overrides, **config_kw):
    """The JAX and the port's `VitsConfig` of the tiny model with `overrides`."""
    from tpu_tts.configs.vits_config import VitsArgs as JaxArgs
    from tpu_tts.configs.vits_config import VitsAudioConfig as JaxAudio
    from tpu_tts.configs.vits_config import VitsConfig as JaxConfig
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig

    args = {**TINY_ARGS, **overrides}
    return (JaxConfig(model_args=JaxArgs(**args), audio=JaxAudio(**TINY_AUDIO), **config_kw),
            VitsConfig(model_args=VitsArgs(**args), audio=VitsAudioConfig(**TINY_AUDIO), **config_kw))


def conditioning(args, B: int, seed: int = 5) -> dict:
    """Per-row speaker ids, language ids and d-vectors a model of `args` reads."""
    rng = np.random.default_rng(seed)
    aux = {}
    if args.use_speaker_embedding and args.num_speakers > 1:
        aux["speaker_ids"] = (np.arange(B) % args.num_speakers).astype(np.int32)
    if args.use_d_vector_file:
        aux["d_vectors"] = rng.standard_normal((B, args.d_vector_dim)).astype(np.float32)
    if args.use_language_embedding:
        aux["language_ids"] = (np.arange(B) // 2 % args.num_languages).astype(np.int32)
    return aux


def build_pair(overrides, from_config: bool = False, **config_kw):
    """The JAX `Vits` with seeded random params of the modules inference
    reads (the posterior encoder is training's) and the port's `Vits` on the
    CPU carrying them. With `from_config`, both are built by
    `init_from_config` (tokenizer, speaker and language managers)."""
    from tpu_tts.models.vits import Vits as JaxVits
    from tpu_tts.models.vits import VitsNet
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.models.vits_convert import params_from_flax

    jcfg, pcfg = configs(overrides, **config_kw)
    jm = JaxVits.init_from_config(jcfg) if from_config else JaxVits(jcfg)
    kw = {k: jnp.asarray(v) for k, v in conditioning(jm.args, 1).items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "sdp"))}
    shapes = jax.eval_shape(lambda: jm.net.init(rngs, jnp.zeros((1, 8), jnp.int32), jnp.array([8]), 16,
                                                method=VitsNet.inference, **kw))["params"]
    jm.params = {"generator": randomize(shapes, SEED)}
    pm = Vits.init_from_config(pcfg, device="cpu") if from_config else Vits(pcfg, device="cpu")
    missing, unexpected = pm.net.load_state_dict(params_from_flax(jm.params["generator"]), strict=False)
    # what inference leaves out: the SDP's posterior flows and the flow its reverse drops
    assert not unexpected and all(k.startswith(("duration_predictor.post_", "duration_predictor.flows.1."))
                                  for k in missing), (missing, unexpected)
    return jm, pm


def token_batch(seed: int = 11):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(LENGTHS), max(LENGTHS)), np.int32)
    for i, n in enumerate(LENGTHS):
        x[i, :n] = rng.integers(1, 40, n)
    return x


def raw_durations(pm, x, aux) -> np.ndarray:
    """The port's durations before the ceil, at noise scale 0."""
    net = pm.net
    t = {k: torch.as_tensor(v).long() if k != "d_vectors" else torch.as_tensor(v) for k, v in aux.items()}
    with torch.no_grad():
        g, lang = net.cond_embeddings(t.get("speaker_ids"), t.get("d_vectors"), t.get("language_ids"))
        h, _, _, mask = net.text_encoder(torch.from_numpy(x).long(), torch.tensor(LENGTHS), lang_emb=lang)
        dp_g = g if net.args.condition_dp_on_speaker else None
        if net.args.use_sdp:
            noise = torch.zeros(x.shape[0], 2, x.shape[1])
            logw = net.duration_predictor.reverse(h, mask, noise, noise_scale=0.0, g=dp_g, lang_emb=lang)
        else:
            logw = net.duration_predictor(h, mask, g=dp_g, lang_emb=lang)
    w = (torch.exp(logw) * mask)[:, 0].numpy()
    return w[np.arange(x.shape[1])[None, :] < np.array(LENGTHS)[:, None]]


def assert_rows_match(got, ref, n_rows):
    y_ref = np.asarray(ref["y_lengths"])
    np.testing.assert_array_equal(got["y_lengths"].numpy(), y_ref)
    durations_ref = np.asarray(ref["alignments"]).sum(axis=1)  # [B, T_en]
    np.testing.assert_array_equal(got["durations"].numpy()[:, : durations_ref.shape[1]], durations_ref)
    wav_ref, wav = np.asarray(ref["model_outputs"]), got["model_outputs"].numpy()
    assert wav.shape == wav_ref.shape
    for i in range(n_rows):
        n = int(y_ref[i]) * HOP
        assert float(np.std(wav_ref[i, :n])) > 1e-2, i
        assert max_err(wav[i, :n], wav_ref[i, :n]) <= WAVE_TOL, i


@pytest.mark.parametrize("case", sorted(CASES))
def test_vits_variant_matches_jax(case, multilingual):
    jm, pm = multilingual if case.startswith("a_") else build_pair(CASES[case])
    x = token_batch()
    aux = conditioning(jm.args, len(LENGTHS))
    w = raw_durations(pm, x, aux)
    assert np.min(np.abs(w - np.round(w))) >= 1e-3, f"ceil near-tie in the durations {w}"
    lengths = np.array(LENGTHS, np.int32)
    ref = jm.inference(x, aux_input={"x_lengths": lengths, **{k: jnp.asarray(v) for k, v in aux.items()}})
    got = pm.inference(x, aux_input={"x_lengths": lengths, **aux})
    assert_rows_match(got, ref, len(LENGTHS))
    if jm.net.interp_factor > 1:
        assert pm.net.interp_factor == jm.net.interp_factor == 2
        assert got["model_outputs"].shape[1] == got["alignments"].shape[1] * HOP * 2
    if aux:  # the conditioning is live: other speakers (or d-vectors) give another waveform
        other = {k: (np.roll(v, 1, axis=0) if k != "language_ids" else v) for k, v in aux.items()}
        moved = pm.inference(x, aux_input={"x_lengths": lengths, **other})
        n = int(min(moved["y_lengths"].min(), got["y_lengths"].min())) * HOP
        assert max_err(moved["model_outputs"][:, :n], got["model_outputs"][:, :n]) > 1e-3


# ------------------------------------------------------- case (a) from its config files

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multispeaker")
    paths = {"speakers_file": str(tmp / "speakers.json"), "language_ids_file": str(tmp / "language_ids.json")}
    json.dump(SPEAKERS, open(paths["speakers_file"], "w"))
    json.dump(LANGUAGES, open(paths["language_ids_file"], "w"))
    return tmp, paths


@pytest.fixture(scope="module")
def multilingual(files):
    """Case (a) built from its config on both sides: graphemes with
    `multilingual_cleaners`, speakers and languages from JSON files."""
    _, paths = files
    jm, pm = build_pair({**CASES["a_multilingual_dp"], **paths}, from_config=True,
                        text_cleaner="multilingual_cleaners")
    assert jm.args.num_chars == pm.args.num_chars >= 40
    assert pm.speaker_manager.name_to_id == SPEAKERS and pm.language_manager.name_to_id == LANGUAGES
    return jm, pm


def synths(jm, pm):
    from tpu_tts.infer.synthesizer import Synthesizer as JaxSynthesizer
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    js, ps = JaxSynthesizer(), Synthesizer(device="cpu")
    for s, m in ((js, jm), (ps, pm)):
        s.tts_model, s.tts_config = m, m.config
        s.speaker_manager, s.language_manager = m.speaker_manager, m.language_manager
    return js, ps


# sentences of at most 15 characters (31 tokens with blanks): the batch and
# the single rows run the compiled [4, 32] and [1, 32] programs of the JAX model
REQUESTS = [("Bonjour, amis.", "cho", "fr"), ("Hello there. A second one.", "ben", "en")]


def test_batcher_mixed_batch_matches_jax(multilingual):
    """Two requests of two speakers and two languages (3 sentences) sent
    together: one inference call at B = 4 on each side, its pad row a copy of
    row 0; each reply equal to the JAX batcher's within 2e-4."""
    from tpu_tts.infer.batcher import TTSMicroBatcher as JaxBatcher
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher, row_conditioning

    jm, pm = multilingual
    js, ps = synths(jm, pm)
    replies = {}
    jb, pb = JaxBatcher(js, gather_window_s=0.5), TTSMicroBatcher(ps, gather_window_s=0.5)

    def go(side, batcher, i):
        text, speaker, language = REQUESTS[i]
        replies[side, i] = np.asarray(batcher.tts(text, speaker_name=speaker, language_name=language))

    try:
        for side, batcher in (("jax", jb), ("port", pb)):
            threads = [threading.Thread(target=go, args=(side, batcher, i)) for i in range(len(REQUESTS))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        jb.close()
        pb.close()
    assert (jb.batches_run, jb.rows_run) == (1, 3)
    assert (pb.batches_run, pb.rows_run, pb.batch_sizes) == (1, 3, [4])
    for i in range(len(REQUESTS)):
        got, ref = replies["port", i], replies["jax", i]
        assert got.dtype == np.float32 and got.shape == ref.shape and float(np.std(ref)) > 1e-2
        assert max_err(got, ref) <= WAVE_TOL, i

    class Job:  # the rows of a call: a d-vector on one row, no id on another
        def __init__(self, speaker_id=None, d_vector=None, language_id=None):
            self.speaker_id, self.d_vector, self.language_id = speaker_id, d_vector, language_id

    aux = row_conditioning([Job(2, None, 1), Job(None, [1.0, 2.0], None), Job(2, None, 1)])
    np.testing.assert_array_equal(aux["speaker_ids"], [2, 0, 2])
    np.testing.assert_array_equal(aux["language_ids"], [1, 0, 1])
    np.testing.assert_array_equal(aux["d_vectors"], [[0, 0], [1, 2], [0, 0]])
    assert row_conditioning([Job(), Job()]) == {}


def coqui_file(sd, path):
    """A state dict written as Coqui writes a training checkpoint, with a
    discriminator tensor the inference net has no place for."""
    sd = {k: v.clone() for k, v in sd.items()}
    sd["disc.nets.0.conv_post.bias"] = torch.zeros(1)
    torch.save({"model": sd, "optimizer": [{"state": {}}], "step": 10, "epoch": 1}, path)
    return path


@pytest.fixture(scope="module")
def served(multilingual, files):
    """Case (a) saved as a Coqui-format checkpoint and its config.json."""
    _, pm = multilingual
    tmp, _ = files
    paths = {"model_path": coqui_file(pm.net.state_dict(), str(tmp / "model.pth")),
             "config_path": str(tmp / "config.json")}
    pm.config.save_json(paths["config_path"])
    return paths


def test_coqui_multispeaker_checkpoint_round_trip(multilingual, served, tmp_path):
    """The Coqui-format file loads back into a model built from the saved
    config with every tensor equal, the speaker and language modules under
    their Coqui names; so does a YourTTS-shaped net (d-vectors, ResBlock2)."""
    from tpu_tts_torch.config import load_config
    from tpu_tts_torch.models.vits import Vits

    _, pm = multilingual
    loaded = Vits.init_from_config(load_config(served["config_path"]), device="cpu")
    loaded.load_checkpoint(loaded.config, served["model_path"])
    sd = loaded.net.state_dict()
    for key in ("emb_g.weight", "emb_l.weight", "waveform_decoder.cond_layer.weight",
                "flow.flows.0.enc.cond_layer.parametrizations.weight.original1", "duration_predictor.cond.weight",
                "duration_predictor.cond_lang.weight", "duration_predictor.conv_1.weight"):
        assert key in sd, key
    assert sd["text_encoder.proj.weight"].shape[1] == 32 + 4
    for k, v in pm.net.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert loaded.speaker_manager.name_to_id == SPEAKERS and loaded.args.num_speakers == 3

    _, pcfg = configs(CASES["b_yourtts"])
    src, dst = Vits(pcfg, device="cpu"), Vits(configs(CASES["b_yourtts"])[1], device="cpu")
    dst.load_checkpoint(dst.config, coqui_file(src.net.state_dict(), str(tmp_path / "yourtts.pth")))
    for k, v in src.net.state_dict().items():
        assert torch.equal(dst.net.state_dict()[k], v), k
    assert "waveform_decoder.resblocks.0.convs.1.parametrizations.weight.original0" in src.net.state_dict()
    assert "duration_predictor.cond.weight" in src.net.state_dict() and not hasattr(src.net, "emb_g")


def _pcm(body):
    assert body[:4] == b"RIFF"
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
    assert sr == 22050
    return pcm


def test_synthesizer_server_api_cli_match_jax(multilingual, served, tmp_path, capsys):
    """`Synthesizer.tts(speaker_name=, language_name=)` against the JAX
    synthesizer within 2e-4; the server (from the Coqui-format file, through
    its batcher) on `/api/tts?speaker_id=&language_id=`, `api.TTS` and the
    CLI give the JAX waveform too, as 16-bit PCM."""
    from tpu_tts_torch.api import TTS
    from tpu_tts_torch.audio import wav_to_pcm16
    from tpu_tts_torch.bin import synthesize
    from tpu_tts_torch.server.server import TTSHandler, create_server

    jm, pm = multilingual
    js, ps = synths(jm, pm)
    text, speaker, language = REQUESTS[1]
    ref = np.asarray(js.tts(text, speaker_name=speaker, language_name=language), dtype=np.float32)
    got = np.asarray(ps.tts(text, speaker_name=speaker, language_name=language), dtype=np.float32)
    assert ps.resolve_speaker(speaker) == (1, None) and ps.resolve_language(language) == 0
    assert got.shape == ref.shape and float(np.std(ref)) > 1e-2
    assert max_err(got, ref) <= WAVE_TOL
    with pytest.raises(ValueError, match="multi-speaker"):
        ps.resolve_speaker("")
    with pytest.raises(NotImplementedError, match="speaker encoder"):  # no encoder attached: JAX ignores the wav
        ps.tts(text, speaker_wav="clip.wav")
    with pytest.raises(ValueError, match="posterior encoder"):  # an inference checkpoint cannot convert voices
        ps.tts(text, speaker_name=speaker, reference_wav=np.zeros(4096, np.float32))

    peak = max(0.01, float(np.max(np.abs(ref))))
    pcm_ref = wav_to_pcm16(ref).astype(np.int32)
    pcm_tol = WAVE_TOL * 32767 / peak + 1

    server = create_server(argparse.Namespace(**served, device="cpu", host="127.0.0.1", port=0, max_batch=16))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert TTSHandler._batcher is not None
        query = urllib.parse.urlencode({"text": text, "speaker_id": speaker, "language_id": language})
        with urllib.request.urlopen(f"{base}/api/tts?{query}", timeout=120) as r:
            pcm = _pcm(r.read())
        assert pcm.shape == pcm_ref.shape and np.abs(pcm - pcm_ref).max() <= pcm_tol
        with urllib.request.urlopen(f"{base}/details", timeout=60) as r:
            details = json.loads(r.read())
        assert details["speakers"] == list(SPEAKERS) and details["languages"] == list(LANGUAGES)
        with urllib.request.urlopen(f"{base}/", timeout=60) as r:
            page = r.read().decode()
        assert 'id="speaker_id"' in page and '<option value="cho">' in page and 'id="language_id"' in page
    finally:
        server.shutdown()
        server.server_close()
        TTSHandler._batcher.close()
        TTSHandler._batcher = None
        thread.join(timeout=10)

    tts = TTS(model_path=served["model_path"], config_path=served["config_path"], device="cpu")
    assert tts.is_multi_speaker and tts.speakers == list(SPEAKERS) and tts.languages == list(LANGUAGES)
    out = tts.tts_to_file(text=text, speaker=speaker, language=language, file_path=str(tmp_path / "api.wav"))
    api_pcm = _pcm(open(out, "rb").read())
    assert np.abs(api_pcm - pcm_ref).max() <= pcm_tol
    args = ["--model_path", served["model_path"], "--config_path", served["config_path"], "--device", "cpu"]
    synthesize.main(["--text", text, "--speaker_idx", speaker, "--language_idx", language,
                     "--out_path", str(tmp_path / "cli.wav"), *args])
    np.testing.assert_array_equal(_pcm(open(tmp_path / "cli.wav", "rb").read()), api_pcm)
    capsys.readouterr()
    synthesize.main(["--list_speaker_idxs", *args])
    synthesize.main(["--list_language_idxs", *args])
    listed = capsys.readouterr().out
    assert str(SPEAKERS) in listed and str(LANGUAGES) in listed


def test_managers_match_jax(tmp_path):
    """Ids and mean d-vectors from `.json`, `.npy` and `.pth` files, a list of
    d-vector files merged, and `init_from_config`, against `tpu_tts.managers`."""
    from tpu_tts import managers as jax_managers
    from tpu_tts_torch import managers

    rng = np.random.default_rng(2)
    clips = {f"{spk}_{i}": {"name": spk, "embedding": rng.standard_normal(8).tolist()}
             for spk in ("zoe", "amy", "kai") for i in range(3 if spk != "kai" else 1)}
    first = dict(list(clips.items())[:4])
    second = dict(list(clips.items())[4:])
    json.dump(first, open(tmp_path / "d1.json", "w"))
    np.save(tmp_path / "d2.npy", second, allow_pickle=True)
    torch.save(clips, tmp_path / "d3.pth")
    json.dump(SPEAKERS, open(tmp_path / "speakers.json", "w"))
    json.dump(LANGUAGES, open(tmp_path / "languages.json", "w"))
    for source in ([str(tmp_path / "d1.json"), str(tmp_path / "d2.npy")], str(tmp_path / "d3.pth")):
        pm, jm = managers.SpeakerManager(d_vectors_file_path=source), jax_managers.SpeakerManager(d_vectors_file_path=source)
        assert pm.name_to_id == jm.name_to_id == {"amy": 0, "kai": 1, "zoe": 2}
        assert pm.num_speakers == 3
        for name in pm.speaker_names:
            np.testing.assert_array_equal(pm.get_mean_embedding(name, num_samples=None),
                                          jm.get_mean_embedding(name, num_samples=None))
            np.testing.assert_array_equal(pm.get_mean_embedding(name, num_samples=1),
                                          jm.get_mean_embedding(name, num_samples=1))
    means = managers.SpeakerManager(d_vectors_file_path=str(tmp_path / "d3.pth"))
    np.testing.assert_allclose(means.get_mean_embedding("zoe"),
                               np.mean([clips[f"zoe_{i}"]["embedding"] for i in range(3)], axis=0), rtol=0, atol=1e-12)

    from tpu_tts.configs.vits_config import VitsArgs as JaxArgs
    from tpu_tts_torch.configs.vits_config import VitsArgs

    kw = dict(use_speaker_embedding=True, speakers_file=str(tmp_path / "speakers.json"), use_language_embedding=True,
              language_ids_file=str(tmp_path / "languages.json"))
    for make, lm_make, Args in ((managers.SpeakerManager.init_from_config, managers.LanguageManager.init_from_config,
                                 VitsArgs),
                                (jax_managers.SpeakerManager.init_from_config,
                                 jax_managers.LanguageManager.init_from_config, JaxArgs)):
        assert make(Args(**kw)).name_to_id == SPEAKERS
        assert lm_make(Args(**kw)).name_to_id == LANGUAGES
        assert make(Args()) is None and lm_make(Args()) is None
    d = managers.SpeakerManager.init_from_config(VitsArgs(use_d_vector_file=True, d_vector_file=[str(tmp_path / "d1.json")]))
    assert d.speaker_names == ["amy", "zoe"]
    for manager in (d, jax_managers.SpeakerManager.init_from_config(JaxArgs(use_d_vector_file=True, d_vector_file=[
            str(tmp_path / "d1.json")]))):  # no encoder: both raise
        with pytest.raises(RuntimeError, match="not initialized"):
            manager.compute_embedding_from_clip("clip.wav")
