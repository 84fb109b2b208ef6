"""The port's DelightfulTTS against `tpu_tts` (CPU, f32), at the widths of
`tests/test_delightful_tts.py::_tiny_config`.

Both packages compute on the same weights: the JAX tree is
`jax.eval_shape(DelightfulTTS.init_params)` drawn from a numpy seed
(`randomize`), carried into the port by `models/delightful_convert.py`. The
duration predictor's head is drawn wide (1–8 frames a token), so the
rounding of durations is exercised. Held here:

- every class of `layers/delightful.py` (and its two functions) against its
  flax counterpart on the same subtree of the model's params, within 1e-5,
  one case each;
- `AcousticModelNet.infer` (`DelightfulNet.infer_spec`): durations and mel
  lengths equal, the mel within 1e-4;
- `DelightfulTTS.inference` against `tpu_tts`'s
  `inference(ids, aux_input={"use_pallas_decoder": True})` with the Pallas
  MRF in interpret mode, waveforms within 2e-4 at equal length, with no
  speaker, with speaker ids (`use_speaker_embedding`) and with d-vectors
  (`use_d_vector_file`);
- a tiny checkpoint through the `Synthesizer`, `/api/tts` (on the locked
  path: DelightfulTTS is not batched), `api.TTS` and `bin/synthesize`, and
  the speaker variants through the `Synthesizer`'s speaker resolution,
  each against the JAX waveform.
"""

import argparse
import functools
import io
import json
import threading
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.torch_port_common import cached_flax_shape_check, max_err, randomize

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

LAYER_TOL = 1e-5
MEL_TOL = 1e-4
WAVE_TOL = 2e-4
N_SPEAKERS, SPK_DIM = 4, 16
SPEAKERS = {f"spk_{c}": i for i, c in enumerate("abcd")}
TEXT = "Be a voice, not an echo."


def tiny(cfg, variant: str = ""):
    """`tests/test_delightful_tts.py::_tiny_config`'s widths on either
    package's config; `variant` "speakers" (a 4-speaker table) or "dvectors"."""
    ma = cfg.model_args
    ma.n_hidden_conformer_encoder = 32
    ma.n_layers_conformer_encoder = 1
    ma.n_heads_conformer_encoder = 2
    ma.n_hidden_conformer_decoder = 32
    ma.n_layers_conformer_decoder = 1
    ma.n_heads_conformer_decoder = 2
    ma.n_hidden_variance_adaptor = 32
    ma.bottleneck_size_u_reference_encoder = 32
    ma.ref_enc_filters_reference_encoder = [4, 4, 8, 8, 16, 16]
    ma.ref_enc_gru_size_reference_encoder = 8
    ma.token_num_reference_encoder = 4
    cfg.vocoder.upsample_initial_channel_decoder = 32
    cfg.vocoder.resblock_kernel_sizes_decoder = [3]
    cfg.vocoder.resblock_dilation_sizes_decoder = [[1, 3]]
    cfg.audio.num_mels = 20
    cfg.audio.do_trim_silence = False
    if variant == "speakers":
        cfg.use_speaker_embedding = ma.use_speaker_embedding = True
        cfg.num_speakers = ma.num_speakers = N_SPEAKERS
        ma.speaker_embedding_channels = SPK_DIM
    elif variant == "dvectors":
        cfg.use_d_vector_file = ma.use_d_vector_file = True
        cfg.d_vector_dim = ma.d_vector_dim = SPK_DIM
    return cfg


def _jax_build(variant: str):
    from tpu_tts.audio import AudioProcessor
    from tpu_tts.configs import DelightfulTTSConfig
    from tpu_tts.models.delightful_tts import DelightfulTTS
    from tpu_tts.text.tokenizer import TTSTokenizer

    cfg = tiny(DelightfulTTSConfig(), variant)
    tok, cfg = TTSTokenizer.init_from_config(cfg)
    return DelightfulTTS(cfg, ap=AudioProcessor.init_from_config(cfg), tokenizer=tok)


@functools.lru_cache(maxsize=None)
def speaker_tree():
    """`jax.eval_shape(init_params)` of the 4-speaker model's generator,
    drawn from a numpy seed: norms' scales ≈ 1 ± 0.1 (as `randomize` draws
    `g` and `gamma`; else every layer norm all but silences its output), the
    duration head wide enough for 1–8 frames a token."""
    tree = jax.eval_shape(_jax_build("speakers").init_params, jax.random.PRNGKey(0))["generator"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: 1.0 + 0.1 * np.tanh(leaf) if path[-1].key == "scale" else np.asarray(leaf),
        randomize(tree, 3))
    head = params["acoustic_model"]["duration_predictor"]["linear_layer"]
    head["kernel"] = (np.random.default_rng(6).standard_normal(head["kernel"].shape) * 0.6).astype(np.float32)
    head["bias"] = np.full((1,), 1.2, np.float32)
    return params


@functools.lru_cache(maxsize=None)
def jax_model(variant: str = ""):
    """The tiny JAX `DelightfulTTS` of `variant` on `speaker_tree`'s weights.
    The trees of the other variants are that tree less what they lack: the
    d-vector model has no `emb_g`; the single-speaker model has no `emb_g`,
    no conformer `conditioning` and no decoder `cond_layer` (flax's `apply`
    fails on any param a model reads and the tree lacks)."""
    params = jax.tree_util.tree_map(lambda a: a, speaker_tree())  # a copy of the containers
    am = params["acoustic_model"]
    if variant != "speakers":
        del am["emb_g"]
    if not variant:
        for conformer in (am["encoder"], am["decoder"]):
            for block in conformer.values():
                del block["conditioning"]
        del params["waveform_decoder"]["cond_layer"]
    model = _jax_build(variant)
    model.params = {"generator": params}
    return model


def port_config(variant: str = "", **top):
    from tpu_tts_torch.configs import DelightfulTTSConfig

    return tiny(DelightfulTTSConfig(**top), variant)


@functools.lru_cache(maxsize=None)
def port_model(variant: str = ""):
    from tpu_tts_torch.models.delightful_convert import params_from_flax
    from tpu_tts_torch.models.delightful_tts import DelightfulTTS

    model = DelightfulTTS.init_from_config(port_config(variant), device="cpu")
    model.net.load_state_dict(params_from_flax(jax_model(variant).params["generator"]), strict=True)
    return model


# --------------------------------------------------------------------------- layers


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def layer_cases():
    """name → [(flax module, its params, the port module's callable, args,
    flax `method`)], two calls for an adaptor (its inference and training
    embeddings), each on the same subtree of the tiny models' params."""
    from tpu_tts.layers import delightful as J

    plain, spk = jax_model().params["generator"]["acoustic_model"], jax_model("speakers").params["generator"]
    pnet, snet = port_model().net.acoustic_model, port_model("speakers").net.acoustic_model
    B, T, E = 2, 12, 32
    x = _rand(B, T, E)
    valid = np.arange(T)[None] < np.array([T, 9])[:, None]
    mels, mel_lens = _rand(B, 24, 20, seed=1), np.array([24, 17], np.int32)
    enc = np.asarray(J.positional_encoding(E, 24))
    g = _rand(B, SPK_DIM, seed=2)
    ref = dict(num_mels=20, ref_enc_filters=(4, 4, 8, 8, 16, 16), ref_enc_size=3, ref_enc_strides=(1, 2, 1, 2, 1),
               ref_enc_gru_size=8)
    upe, ppe = plain["utterance_prosody_encoder"], plain["phoneme_prosody_encoder"]
    pupe = pnet.utterance_prosody_encoder
    blk, pblk = plain["encoder"]["block_0"], pnet.encoder.block_0
    n_chars = plain["src_word_emb"]["embeddings"]["embedding"].shape[0]
    cases = {
        "EmbeddingPadded": (J.EmbeddingPadded(n_chars, E, pnet.src_word_emb.padding_idx), plain["src_word_emb"],
                            pnet.src_word_emb, (np.array([[0, 3, 7, 0], [5, 0, 39, 1]], np.int32),)),
        "BSConv1d": (J.BSConv1d(32, 5), plain["duration_predictor"]["conv_0"]["conv"],
                     pnet.duration_predictor.conv_0.conv, (x,)),
        "ConvTransposed": (J.ConvTransposed(32, 5), plain["duration_predictor"]["conv_0"],
                           pnet.duration_predictor.conv_0, (x,)),
        "Conv1dGLU": (J.Conv1dGLU(E, 7, SPK_DIM), spk["acoustic_model"]["encoder"]["block_0"]["conditioning"],
                      snet.encoder.block_0.conditioning, (x, g)),
        "CoordConv1d": (J.CoordConv1d(4, 3), upe["encoder"]["conv_0"], pupe.encoder.conv_0, (mels,)),
        "InstanceNorm1dAffine": (J.InstanceNorm1dAffine(4), upe["encoder"]["norm_0"], pupe.encoder.norm_0,
                                 (_rand(B, T, 4, seed=3) * 3 + 1,)),
        "RelativeMultiHeadAttention": (J.RelativeMultiHeadAttention(E, 2), blk["slf_attn"]["attention"],
                                       pblk.slf_attn.attention, (x, x, x, enc[:, :T], valid[:, None, None, :])),
        "ConformerMultiHeadedSelfAttention": (J.ConformerMultiHeadedSelfAttention(E, 2, 0.1), blk["slf_attn"],
                                              pblk.slf_attn, (x, x, x, valid[:, None, None, :], enc)),
        "ConformerFeedForward": (J.ConformerFeedForward(E), blk["ff"], pblk.ff, (x,)),
        "ConformerConvModule": (J.ConformerConvModule(E, 7), blk["conformer_conv_1"], pblk.conformer_conv_1, (x,)),
        "ConformerBlock": (J.ConformerBlock(E, 2, 7, SPK_DIM, 0.1), spk["acoustic_model"]["encoder"]["block_0"],
                           snet.encoder.block_0, (x, valid, valid[:, None, None, :], g, enc)),
        "Conformer": (J.Conformer(E, 1, 2, 0, 0.1, 11), plain["decoder"], pnet.decoder, (x, valid, None, enc)),
        "ReferenceEncoder": (J.ReferenceEncoder(**ref), upe["encoder"], pupe.encoder, (mels, mel_lens)),
        "StyleEmbedAttention": (J.StyleEmbedAttention(E, 1, E), upe["stl"]["attention"], pupe.stl.attention,
                                (_rand(B, 1, 16), _rand(B, 4, E, seed=4))),
        "STL": (J.STL(E, 4), upe["stl"], pupe.stl, (_rand(B, 16),)),
        "UtteranceLevelProsodyEncoder": (
            J.UtteranceLevelProsodyEncoder(**ref, dropout=0.1, n_hidden=E, bottleneck_size_u=32, token_num=4),
            upe, pupe, (mels, mel_lens)),
        "PhonemeLevelProsodyEncoder": (
            J.PhonemeLevelProsodyEncoder(**ref, dropout=0.1, n_hidden=E, n_heads=2, bottleneck_size_p=4),
            ppe, pnet.phoneme_prosody_encoder, (x, valid, mels, mel_lens, enc)),
        "VariancePredictor": (J.VariancePredictor(32), plain["duration_predictor"], pnet.duration_predictor,
                              (x, valid.astype(np.float32))),
        "PhonemeProsodyPredictor": (J.PhonemeProsodyPredictor(E, 5, 0.1, 4), plain["phoneme_prosody_predictor"],
                                    pnet.phoneme_prosody_predictor, (x, valid)),
    }
    out = {name: [(mod, params, port, args, None)] for name, (mod, params, port, args) in cases.items()}
    durs = np.array([[3, 1, 4, 2, 0, 0], [2, 2, 1, 1, 1, 0]], np.float32)
    target = np.abs(_rand(B, 12, seed=5)) * (np.arange(12) % 5 != 0)  # some zero frames
    mask = valid[:, :6].astype(np.float32)
    for name, kind, mod in (("PitchAdaptor", "pitch", J.PitchAdaptor(E, 32)),
                            ("EnergyAdaptor", "energy", J.EnergyAdaptor(E, 32))):
        port = getattr(pnet, f"{kind}_adaptor")
        out[name] = [(mod, plain[f"{kind}_adaptor"], getattr(port, method), args, method)
                     for method, args in ((f"get_{kind}_embedding", (x[:, :6], mask)),
                                          (f"get_{kind}_embedding_train", (x[:, :6], target, durs, mask)))]
    return out


NORM_INPUT = _rand(2, 5, 7) * 4 + 2


@functools.lru_cache(maxsize=None)
def layer_refs():
    """Every case's flax output, and the two functions', from one jitted JAX program."""
    from tpu_tts.layers import delightful as J

    cases = layer_cases()

    def run(params, args, norm_input):
        out = {name: [mod.apply({"params": params[name][i]}, *args[name][i], method=method)
                      for i, (mod, _, _, _, method) in enumerate(calls)] for name, calls in cases.items()}
        out["positional_encoding"] = [J.positional_encoding(48, 300)]
        out["_norm_last"] = [J._norm_last(norm_input)]
        return out

    params = {name: [c[1] for c in calls] for name, calls in cases.items()}
    args = {name: [c[3] for c in calls] for name, calls in cases.items()}
    return jax.jit(run)(params, args, NORM_INPUT)


LAYERS = ["positional_encoding", "_norm_last", "EmbeddingPadded", "BSConv1d", "ConvTransposed", "Conv1dGLU",
          "CoordConv1d", "InstanceNorm1dAffine", "RelativeMultiHeadAttention", "ConformerMultiHeadedSelfAttention",
          "ConformerFeedForward", "ConformerConvModule", "ConformerBlock", "Conformer", "ReferenceEncoder",
          "StyleEmbedAttention", "STL", "UtteranceLevelProsodyEncoder", "PhonemeLevelProsodyEncoder",
          "VariancePredictor", "PhonemeProsodyPredictor", "PitchAdaptor", "EnergyAdaptor"]


def _compare(got, ref, tol=LAYER_TOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == r.shape and float(np.abs(r).max()) > 0
        assert max_err(g.astype(np.float32), r.astype(np.float32)) <= tol


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_flax(name):
    """Each class (and function) of `layers/delightful.py` against its flax
    counterpart, within 1e-5."""
    from tpu_tts_torch.layers import delightful as P

    if name == "positional_encoding":
        _compare(P.positional_encoding(48, 300), layer_refs()[name][0])
        return
    if name == "_norm_last":
        _compare(P._norm_last(torch.from_numpy(NORM_INPUT)), layer_refs()[name][0])
        return
    for (_, _, port, args, _), ref in zip(layer_cases()[name], layer_refs()[name]):
        with torch.no_grad():
            got = port(*[None if a is None else torch.from_numpy(np.array(a)) for a in args])
        _compare(got, ref)


# --------------------------------------------------------------------------- the model


def _speaker_aux(variant):
    if variant == "speakers":
        return {"speaker_ids": [SPEAKERS["spk_b"]]}
    if variant == "dvectors":
        return {"d_vectors": _rand(1, SPK_DIM, seed=7)}
    return {}


@functools.lru_cache(maxsize=None)
def jax_waveform(variant: str):
    """`tpu_tts`'s `DelightfulTTS.inference` of TEXT with the Pallas decoder in interpret mode."""
    jm = jax_model(variant)
    ids = np.asarray(jm.tokenizer.text_to_ids(TEXT), dtype=np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_TTS_PALLAS_INTERPRET", "1")
        return jm.inference(ids, aux_input={"use_pallas_decoder": True, **_speaker_aux(variant)})


def jax_acoustic(variant: str):
    """The acoustic stage of `jax_waveform(variant)`'s own program
    (`DelightfulNet.infer(decode=False)`, jitted inside `tpu_tts`'s
    `inference`), called again on the same inputs: the mel the JAX decoder
    read, without compiling the acoustic model a second time."""
    jm = jax_model(variant)
    jax_waveform(variant)
    (run,) = jm._infer_cache.values()
    acoustic = dict(zip(run.__code__.co_freevars, (c.cell_contents for c in run.__closure__)))["acoustic"]
    ids = np.asarray(jm.tokenizer.text_to_ids(TEXT), dtype=np.int32)
    x = np.zeros((1, 32), np.int32)
    x[0, : len(ids)] = ids
    aux = {k: np.asarray(v, np.int32 if k == "speaker_ids" else np.float32) for k, v in _speaker_aux(variant).items()}
    return acoustic(jm.params["generator"], x, np.array([len(ids)], np.int32), **aux), x, aux


@pytest.mark.parametrize("variant", ["", "speakers", "dvectors"])
def test_acoustic_model_infer_matches_jax(variant):
    """`DelightfulNet.infer(decode=False)` (`AcousticModelNet.infer`):
    durations, mel lengths and alignments equal, the mel within 1e-4."""
    ref, x, aux = jax_acoustic(variant)
    with torch.no_grad():
        got = port_model(variant).net.infer(torch.from_numpy(x).long(), torch.tensor([int((x > 0).sum())]),
                                            ref["mel"].shape[1], decode=False,
                                            **{k: torch.from_numpy(v) for k, v in aux.items()})
    dur = np.asarray(ref["durations"])
    assert len(set(dur[0][dur[0] > 0].tolist())) >= 3, dur  # durations vary, so their rounding is held
    np.testing.assert_array_equal(got["durations"].numpy(), dur)
    np.testing.assert_array_equal(got["mel_lens"].numpy(), np.asarray(ref["mel_lens"]))
    np.testing.assert_array_equal(got["alignments"].numpy(), np.asarray(ref["alignments"]))
    assert float(np.std(np.asarray(ref["mel"]))) > 1e-2
    assert max_err(got["mel"], ref["mel"]) <= MEL_TOL
    if variant:
        assert max_err(got["g"], np.swapaxes(np.asarray(ref["g"]), 1, 2)) <= LAYER_TOL


@pytest.mark.parametrize("variant", ["", "speakers", "dvectors"])
def test_inference_matches_jax_pallas_decoder(variant):
    pm = port_model(variant)
    ref = jax_waveform(variant)
    got = pm.inference(pm.tokenizer.text_to_ids(TEXT), aux_input=_speaker_aux(variant))
    wav, ref_wav = got["model_outputs"].numpy(), np.asarray(ref["model_outputs"])
    assert wav.shape == ref_wav.shape == (1, int(got["y_lengths"][0]) * 256, 1)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(ref["durations"]))
    assert float(np.std(ref_wav)) > 1e-3
    assert max_err(wav, ref_wav) <= WAVE_TOL
    if variant == "speakers":  # another speaker moves the waveform
        other = pm.inference(pm.tokenizer.text_to_ids(TEXT), aux_input={"speaker_ids": [0]})["model_outputs"]
        assert other.shape != got["model_outputs"].shape or max_err(other, got["model_outputs"]) > 1e-3


def test_config_setup_model_and_training_raises(tmp_path):
    """A `config.json` that `tpu_tts` writes loads as the port's
    `DelightfulTTSConfig`, each of the port's own model, vocoder, audio,
    speaker and training settings equal to `tpu_tts`'s (the fields
    `tpu_tts` never reads for DelightfulTTS, ROADMAP.md F19, are passed
    over); `setup_model` builds the model (on the card unless asked for the
    CPU); the training entries no longer raise: `init_training` builds the
    discriminator of `periods_discriminator`, and `get_optimizer` the D and
    G AdamW optimizers with their exponential schedules and clip."""
    from tpu_tts_torch.config import load_config
    from tpu_tts_torch.configs import DelightfulTTSConfig
    from tpu_tts_torch.models import setup_model

    jm = jax_model("speakers")
    jm.config.save_json(str(tmp_path / "config.json"))
    cfg = load_config(str(tmp_path / "config.json"))
    assert type(cfg).__name__ == "DelightfulTTSConfig"
    for key in ("model_args", "vocoder", "audio"):
        port, ref = cfg[key].to_dict(), jm.config[key].to_dict()
        assert port == {k: ref[k] for k in port}, key
    assert {"spec_segment_size"} <= set(cfg.model_args.to_dict())
    assert {"periods_discriminator", "use_spectral_norm_discriminator"} <= set(cfg.vocoder.to_dict())
    top = [k for k in DelightfulTTSConfig.__annotations__ if k not in ("model_args", "vocoder", "audio")]
    assert {"use_attn_priors", "lr_gen", "binary_align_loss_alpha", "multi_scale_stft_loss_params",
            "f0_cache_path"} <= set(top)
    assert {k: cfg[k] for k in top} == {k: jm.config[k] for k in top}
    unread = {"init_discriminator", "steps_to_start_discriminator", "ssim_loss_alpha", "char_dur_loss_alpha",
              "binary_loss_warmup_epochs"}
    assert unread <= set(jm.config.to_dict()) and not unread & set(cfg.to_dict())
    pm = setup_model(cfg, device="cpu")
    assert type(pm).__name__ == "DelightfulTTS" and pm.net.acoustic_model.emb_g.num_embeddings == N_SPEAKERS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            setup_model(cfg)  # the card by default
    pm.config.vocoder.periods_discriminator = [2]  # the default five hold 46 M parameters to initialise
    pm.init_training()
    assert pm.num_optimizers() == 2 and len(pm.disc.nets) == 2
    opt_d, opt_g = pm.get_optimizer()
    assert [len(o.params) for o in (opt_d, opt_g)] == [len(list(pm.disc.parameters())),
                                                      len(list(pm.net.parameters()))]
    for opt, lr in ((opt_d, cfg.lr_disc), (opt_g, cfg.lr_gen)):
        assert type(opt.inner).__name__ == "AdamW" and opt.grad_clip == cfg.grad_clip
        assert opt.lr() == pytest.approx(lr)
        assert opt.inner.param_groups[0]["betas"] == (0.8, 0.99) and opt.inner.param_groups[0]["weight_decay"] == 0.01


# --------------------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The three tiny models saved as a state dict and a `config.json`
    written by `tpu_tts`'s config, with a speakers file and a d-vector file."""
    tmp = tmp_path_factory.mktemp("delightful")
    (tmp / "speakers.json").write_text(json.dumps(SPEAKERS))
    dvec = _rand(1, SPK_DIM, seed=7)[0].tolist()
    (tmp / "dvectors.json").write_text(json.dumps({"clip_0.wav": {"name": "spk_x", "embedding": dvec}}))
    out = {}
    for variant, top in (("", {}), ("speakers", {"speakers_file": str(tmp / "speakers.json")}),
                         ("dvectors", {"d_vector_file": str(tmp / "dvectors.json")})):
        jm = jax_model(variant)
        cfg = jm.config
        for key, value in top.items():
            setattr(cfg, key, value)
            setattr(cfg.model_args, key, value)
        torch.save(port_model(variant).net.state_dict(), tmp / f"model{variant}.pth")
        cfg.save_json(str(tmp / f"config{variant}.json"))
        out[variant] = {"model_path": str(tmp / f"model{variant}.pth"), "config_path": str(tmp / f"config{variant}.json")}
    return out


def _pcm(body: bytes) -> np.ndarray:
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
    assert sr == 22050
    return pcm.astype(np.int32)


def test_synthesizer_server_api_cli_match_jax(checkpoints, tmp_path, capsys):
    """A tiny checkpoint (its `config.json` written by `tpu_tts`) through the
    `Synthesizer`, `/api/tts` on the locked path, `api.TTS` and the CLI: the
    JAX waveform and the 10000-sample gap."""
    from tpu_tts_torch.api import TTS
    from tpu_tts_torch.audio import wav_to_pcm16
    from tpu_tts_torch.bin import synthesize
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher
    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP, Synthesizer
    from tpu_tts_torch.server.server import TTSHandler, create_server

    paths = checkpoints[""]
    ref = np.concatenate([np.asarray(jax_waveform("")["model_outputs"])[0, :, 0], np.zeros(SENTENCE_GAP, np.float32)])
    synth = Synthesizer(paths["model_path"], paths["config_path"], device="cpu")
    assert type(synth.tts_config).__name__ == "DelightfulTTSConfig" and not TTSMicroBatcher.supports(synth)
    got = np.asarray(synth.tts(TEXT), dtype=np.float32)
    assert got.shape == ref.shape and max_err(got, ref) <= WAVE_TOL
    pcm_ref = wav_to_pcm16(ref).astype(np.int32)
    pcm_tol = WAVE_TOL * 32767 / max(0.01, float(np.abs(ref).max())) + 1

    server = create_server(argparse.Namespace(**paths, device="cpu", host="127.0.0.1", port=0))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert TTSHandler._batcher is None  # the locked path
        url = f"http://127.0.0.1:{server.server_address[1]}/api/tts?{urllib.parse.urlencode({'text': TEXT})}"
        with urllib.request.urlopen(url, timeout=120) as r:
            pcm = _pcm(r.read())
        assert pcm.shape == pcm_ref.shape and np.abs(pcm - pcm_ref).max() <= pcm_tol
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)

    tts = TTS(model_path=paths["model_path"], config_path=paths["config_path"], device="cpu")
    api_pcm = _pcm(open(tts.tts_to_file(text=TEXT, file_path=str(tmp_path / "api.wav")), "rb").read())
    assert np.abs(api_pcm - pcm_ref).max() <= pcm_tol
    synthesize.main(["--text", TEXT, "--model_path", paths["model_path"], "--config_path", paths["config_path"],
                     "--out_path", str(tmp_path / "cli.wav"), "--device", "cpu"])
    np.testing.assert_array_equal(_pcm(open(tmp_path / "cli.wav", "rb").read()), api_pcm)
    capsys.readouterr()


@pytest.mark.parametrize("variant", ["speakers", "dvectors"])
def test_synthesizer_speakers_match_jax(checkpoints, variant):
    """A speaker name through the `Synthesizer`: an id of `emb_g`, or the
    mean d-vector of the speaker's clips; the JAX waveform of that id or
    d-vector."""
    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP, Synthesizer

    paths = checkpoints[variant]
    synth = Synthesizer(paths["model_path"], paths["config_path"], device="cpu")
    name = "spk_b" if variant == "speakers" else "spk_x"
    speaker_id, d_vector = synth.resolve_speaker(name)
    if variant == "speakers":
        assert speaker_id == 1 and d_vector is None and synth.tts_model.net.acoustic_model.emb_g.num_embeddings == 4
    else:
        assert speaker_id is None and max_err(np.asarray(d_vector), _rand(1, SPK_DIM, seed=7)[0]) == 0
    ref = np.concatenate([np.asarray(jax_waveform(variant)["model_outputs"])[0, :, 0], np.zeros(SENTENCE_GAP)])
    got = np.asarray(synth.tts(TEXT, speaker_name=name), dtype=np.float32)
    assert got.shape == ref.shape and max_err(got, ref.astype(np.float32)) <= WAVE_TOL
