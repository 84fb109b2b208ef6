"""The port's Glow-TTS and the Glow-TTS → WaveRNN serving slice against `tpu_tts` (CPU, f32).

A tiny Glow-TTS (the default encoder and decoder depth of 12 flow blocks at
narrow widths) with seeded random params on the JAX side, carried into the
port through `params_from_flax`:

- the decoder's reverse flow and `GlowTTS.inference` at noise scale 0: mel
  within 1e-4 (12 flow blocks of float32 sums and a 4×4 inverse each),
  `y_lengths` and alignments equal; the JAX durations are first held ≥ 1e-3
  from an integer, so a ceil near-tie fails loudly instead of flaking;
- the weight bridge back through the JAX package's converter;
- the port's `Synthesizer` and `/api/tts` with Glow-TTS + WaveRNN against
  the JAX composition built by hand: `GlowTTS.inference`, the
  denormalize → normalize handshake, `_interpolate_mel` (the two audio
  configs differ in sample rate and levels) and `Wavernn.inference(
  use_pallas=True)`. The JAX synthesizer itself cannot run this pair: it
  indexes WaveRNN's 1-D waveform as `[0, :, 0]`. The vocoder is held to the
  JAX vocoder on the port's own mel, so a 1e-5 difference in the mel cannot
  flip a sampled class.
"""

import argparse
import functools
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.torch_port_common import cached_flax_shape_check, jax_wavernn, max_err, port_wavernn, randomize
from tpu_tts.models.glow_convert import convert_glow_tts_torch_state_dict
from tpu_tts_torch.models.glow_convert import params_from_flax

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

TINY_GLOW = dict(
    hidden_channels_enc=16,
    hidden_channels_dec=16,
    hidden_channels_dp=16,
    out_channels=20,
    encoder_params={"kernel_size": 3, "dropout_p": 0.1, "num_layers": 2, "num_heads": 2, "hidden_channels_ffn": 24},
    num_block_layers=2,
    inference_noise_scale=0.0,
    text_cleaner="english_cleaners",
)
# the vocoder's audio config differs from the TTS model's (defaults), so the
# handshake and the time interpolation both do work
VOCODER_AUDIO = dict(sample_rate=24000, ref_level_db=25, min_level_db=-90)
TEXT = "Be a voice, not an echo."


@functools.lru_cache(maxsize=None)
def jax_glow():
    """The tiny JAX Glow-TTS with params from a numpy seed; the tree's layout
    is the JAX package's converter applied to the port's state dict (the
    paths and shapes of a flax trace, so the same draws, without the
    trace's seconds)."""
    from tpu_tts.configs.glow_tts_config import GlowTTSConfig
    from tpu_tts.models.glow_tts import GlowTTS
    from tpu_tts_torch.models.glow_tts import GlowTTS as PortGlowTTS

    model = GlowTTS.init_from_config(GlowTTSConfig(**TINY_GLOW))
    port = PortGlowTTS.init_from_config(port_glow_config(), device="cpu")
    params = randomize(convert_glow_tts_torch_state_dict({k: v.numpy() for k, v in port.net.state_dict().items()}), 5)
    rng = np.random.default_rng(6)
    for name, node in params["decoder"].items():
        if name.startswith("invconv_"):  # a random rotation, as the flax init draws
            node["weight"] = np.linalg.qr(rng.standard_normal((4, 4)))[0].astype(np.float32)
    params["encoder"]["duration_predictor"]["proj"]["bias"] = np.full((1,), 1.2, np.float32)  # 2-5 frames a token
    model.params = params
    return model


def port_glow_config():
    from tpu_tts_torch.configs import GlowTTSConfig

    return GlowTTSConfig(**TINY_GLOW)


@pytest.fixture(scope="module")
def models():
    from tpu_tts_torch.models.glow_tts import GlowTTS

    jm = jax_glow()
    pm = GlowTTS.init_from_config(port_glow_config(), device="cpu")
    pm.net.load_state_dict(params_from_flax(jm.params), strict=True)
    return jm, pm


def _apply(jm, fn, *args):
    return jax.jit(lambda p, *a: jm.net.apply({"params": p}, *a, method=fn))(jm.params, *args)


def test_decoder_reverse_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 30, 20)).astype(np.float32)
    mask = np.ones((2, 30, 1), np.float32)
    mask[1, 22:] = 0
    ref = _apply(jm, lambda n, z, m: n.decoder(z * m, m, reverse=True)[0], z, mask)
    with torch.no_grad():
        zt, mt = torch.from_numpy(z).transpose(1, 2), torch.from_numpy(mask).transpose(1, 2)
        got = pm.net.decoder.reverse(zt * mt, mt).transpose(1, 2)
    assert max_err(got, z * mask) > 1e-1  # not the identity
    assert max_err(got, ref) <= 1e-4


def test_inference_matches_jax(models):
    jm, pm = models
    x = np.random.default_rng(4).integers(1, 40, (1, 13)).astype(np.int32)
    logw = _apply(jm, lambda n, x, xl: n.encoder(x, xl)[2], jnp.asarray(x), jnp.asarray([13]))
    w = np.exp(np.asarray(logw)[0, :, 0]) - 1
    assert np.min(np.abs(w - np.round(w))) >= 1e-3, f"ceil near-tie in the JAX durations {w}"

    ref = jm.inference(x)
    got = pm.inference(x)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(ref["y_lengths"]))
    assert int(ref["y_lengths"][0]) > 26  # durations above one frame a token
    np.testing.assert_array_equal(got["alignments"].numpy(), np.asarray(ref["alignments"]))
    assert got["model_outputs"].shape == (1, 384, 20)  # the mel bucket: 13 tokens · 24 frames → 3 · 128
    assert float(np.std(np.asarray(ref["model_outputs"]))) > 1e-1
    assert max_err(got["model_outputs"], ref["model_outputs"]) <= 1e-4


def test_weight_bridge_round_trip(models):
    """port state_dict → the JAX package's converter → the JAX params the port
    was loaded from (weight-normalised kernels compared folded)."""
    jm, pm = models
    back = convert_glow_tts_torch_state_dict({k: v.numpy() for k, v in pm.net.state_dict().items()})

    def fold(node):
        norm = np.sqrt(np.sum(node["v"] ** 2, axis=(0, 1), keepdims=True) + 1e-12)
        return node["v"] / norm * node["g"][None, None, :]

    def walk(a, b, path):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        if "v" in a and "g" in a:
            assert max_err(fold(a), fold(b)) <= 1e-6, path
            a, b = {k: v for k, v in a.items() if k not in "vg"}, {k: v for k, v in b.items() if k not in "vg"}
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=f"{path}/{k}")

    walk(jm.params, back, "")


def test_unported_variants_raise():
    from tpu_tts_torch.models.glow_tts import GlowTTS

    for enc in ("gated_conv", "residual_conv_bn", "time_depth_separable"):
        with pytest.raises(NotImplementedError):
            GlowTTS.init_from_config(port_glow_config().__class__(**{**TINY_GLOW, "encoder_type": enc}), device="cpu")
    with pytest.raises(NotImplementedError):
        GlowTTS.init_from_config(port_glow_config().__class__(**TINY_GLOW, use_d_vector_file=True), device="cpu")


@pytest.fixture(scope="module")
def checkpoints(models, tmp_path_factory):
    """The port's Glow-TTS and WaveRNN (hop 256) saved as state_dict + config.json."""
    _, pm = models
    vocoder = port_wavernn(jax_wavernn((4, 8, 8)), audio=VOCODER_AUDIO)
    tmp = tmp_path_factory.mktemp("glow_wavernn")
    torch.save(pm.net.state_dict(), tmp / "glow.pth")
    pm.config.save_json(str(tmp / "glow.json"))
    torch.save(vocoder.net.state_dict(), tmp / "wavernn.pth")
    vocoder.config.save_json(str(tmp / "wavernn.json"))
    return {k: str(tmp / f) for k, f in (("model_path", "glow.pth"), ("config_path", "glow.json"),
                                          ("vocoder_path", "wavernn.pth"), ("vocoder_config_path", "wavernn.json"))}


@pytest.fixture(scope="module")
def served(checkpoints):
    """The port's `Synthesizer.tts` of TEXT, with the port's own mel of it."""
    from tpu_tts_torch.infer.synthesis import synthesis
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    synth = Synthesizer(checkpoints["model_path"], checkpoints["config_path"], checkpoints["vocoder_path"],
                        checkpoints["vocoder_config_path"], device="cpu")
    mel = synthesis(synth.tts_model, TEXT, synth.tts_config)["model_outputs"]
    return synth, mel, np.asarray(synth.tts(TEXT), dtype=np.float32)


def test_synthesizer_glow_wavernn_matches_jax(models, served):
    from tpu_tts.audio import AudioProcessor
    from tpu_tts.config.shared_configs import BaseAudioConfig
    from tpu_tts.infer.synthesizer import _interpolate_mel
    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP

    jm, _ = models
    synth, mel, wav = served
    assert synth.output_sample_rate == 24000 and len(synth.split_into_sentences(TEXT)) == 1

    ids = np.asarray(jm.tokenizer.text_to_ids(TEXT), dtype=np.int32)
    np.testing.assert_array_equal(ids, synth.tts_model.tokenizer.text_to_ids(TEXT))
    out = jm.inference(ids)
    jax_mel = np.asarray(out["model_outputs"])[0, : int(out["y_lengths"][0])]
    assert mel.shape == jax_mel.shape and max_err(mel, jax_mel) <= 1e-4

    voc_ap = AudioProcessor(verbose=False, **BaseAudioConfig(**VOCODER_AUDIO).to_dict())
    vocoder_input = voc_ap.normalize(jm.ap.denormalize(mel.T)).T
    vocoder_input = _interpolate_mel(vocoder_input, 24000 / 22050)
    ref = jax_wavernn((4, 8, 8)).inference(vocoder_input.astype(np.float32), use_pallas=True)
    assert len(wav) == len(ref) + SENTENCE_GAP == vocoder_input.shape[0] * 256 + SENTENCE_GAP
    assert float(np.std(ref)) > 1e-2
    assert max_err(wav[: len(ref)], ref) <= 1e-5
    assert not wav[len(ref) :].any()


def test_server_glow_wavernn_on_cpu(checkpoints, served):
    from tpu_tts_torch.audio import wav_to_pcm16
    from tpu_tts_torch.server.server import create_server

    server = create_server(argparse.Namespace(**checkpoints, device="cpu", host="127.0.0.1", port=0))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        req = urllib.request.Request(f"{base}/api/tts", data=json.dumps({"text": TEXT}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            body = r.read()
        with urllib.request.urlopen(f"{base}/details", timeout=60) as r:
            details = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert body[:4] == b"RIFF"
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
    assert sr == 24000
    np.testing.assert_array_equal(pcm, wav_to_pcm16(served[2]))
    assert details["tts_config"]["model"] == "glow_tts" and details["vocoder_config"]["model"] == "wavernn"
