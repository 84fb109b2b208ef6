"""The port's serving layer against `tpu_tts` (CPU, f32, noise scales 0).

- `Vits.inference` on a `[4, T]` batch of mixed `x_lengths`: per-row
  `y_lengths` and durations equal to the JAX model's on the same padded
  batch, waveforms within 2e-4 over each row's valid length;
- the micro-batcher: its rows equal the JAX micro-batcher's (cropped at
  `y_lengths · hop`, joined with the 10000-sample gap) within 2e-4; a single
  request through it equals the locked path exactly; an error in a batch
  reaches each of its requests; 4 concurrent server
  requests run in fewer than 4 batches and give the serial replies (PCM16,
  within one step of rounding);
- the VITS `Synthesizer.tts` held to the JAX `Synthesizer.tts` (2e-4), and a
  `speaker_name` on a single-speaker model resolved to no id, not raised;
- a Coqui-format VITS checkpoint (`{"model": ...}` with discriminator keys)
  loaded by the JAX model's `load_checkpoint` and the port's loader: the
  same waveform within 2e-4; the flat file with old-style `weight_g` /
  `weight_v` pairs loads to the same weights exactly; a missing key raises;
- the HTTP surface on the CPU: `/`, the MaryTTS routes, `api.TTS(...)
  .tts_to_file`, `bin/synthesize.py --text ... --out_path` and
  `--list_models`.

The JAX references share two compiled shapes, `[4, 32]` and `[1, 32]` token
ids at the 128-frame decode bucket, through shallow copies of the one tiny
JAX model (the copies share its compiled programs).
"""

import argparse
import copy
import io
import json
import threading
import urllib.parse
import urllib.request

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.torch_port_common import cached_flax_shape_check, jax_model, max_err, port_config, port_model

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

HOP = 16  # TINY_AUDIO
GAP = 10000
WAVE_TOL = 2e-4  # the VITS parity bar of tests/test_torch_port_vits.py


class CharIds:
    """A tokenizer for the 40-symbol tiny models: each character to an id in
    [1, 39], shared by both packages."""

    def text_to_ids(self, text, language=None):
        return [1 + ord(c) % 39 for c in text]


def with_front_end(model, ap):
    """A shallow copy of a model (sharing its net and compiled programs) with
    the tokenizer and audio processor a synthesizer reads."""
    m = copy.copy(model)
    m.tokenizer, m.ap = CharIds(), ap
    return m


@pytest.fixture(scope="module")
def models():
    from tpu_tts.audio import AudioProcessor as JaxAP
    from tpu_tts_torch.audio import AudioProcessor

    jm, pm = jax_model(), port_model()
    return with_front_end(jm, JaxAP.init_from_config(jm.config, verbose=False)), \
        with_front_end(pm, AudioProcessor.init_from_config(pm.config))


def jax_synth(jm):
    from tpu_tts.infer.synthesizer import Synthesizer

    s = Synthesizer()
    s.tts_model, s.tts_config = jm, jm.config
    return s


def port_synth(pm):
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    s = Synthesizer(device="cpu")
    s.tts_model, s.tts_config = pm, pm.config
    return s


def test_batched_inference_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(11)
    lens = [13, 7, 20, 10]
    x = np.zeros((4, 20), np.int32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.integers(1, 40, n)
    got = pm.inference(x, aux_input={"x_lengths": lens})
    with torch.no_grad():  # the port's raw durations, held away from a ceil near-tie
        h, _, _, mask = pm.net.text_encoder(torch.from_numpy(x).long(), torch.tensor(lens))
        noise = torch.zeros(4, 2, x.shape[1])
        w = (torch.exp(pm.net.duration_predictor.reverse(h, mask, noise, noise_scale=0.0)) * mask)[:, 0].numpy()
    valid = w[np.arange(20)[None, :] < np.array(lens)[:, None]]
    assert np.min(np.abs(valid - np.round(valid))) >= 1e-3, f"ceil near-tie in the durations {valid}"

    ref = jm.inference(x, aux_input={"x_lengths": np.array(lens, np.int32)})
    y_ref = np.asarray(ref["y_lengths"])
    np.testing.assert_array_equal(got["y_lengths"].numpy(), y_ref)
    assert len(set(y_ref.tolist())) == 4  # mixed lengths
    durations_ref = np.asarray(ref["alignments"]).sum(axis=1)  # [B, T_en]
    np.testing.assert_array_equal(got["durations"].numpy()[:, : durations_ref.shape[1]], durations_ref)
    wav_ref, wav = np.asarray(ref["model_outputs"]), got["model_outputs"].numpy()
    assert wav.shape == wav_ref.shape
    for i in range(4):
        n = int(y_ref[i]) * HOP
        assert float(np.std(wav_ref[i, :n])) > 1e-2
        assert max_err(wav[i, :n], wav_ref[i, :n]) <= WAVE_TOL, i


TEXTS3 = "The first line here. A second one. And a third sentence."


def test_batcher_matches_jax_batcher(models):
    """One request of 3 sentences: one inference call at B = 4 (a pad row
    repeating row 0) on each side, rows cropped, gapped and joined."""
    from tpu_tts.infer.batcher import TTSMicroBatcher as JaxBatcher
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher

    jm, pm = models
    jb, pb = JaxBatcher(jax_synth(jm)), TTSMicroBatcher(port_synth(pm))
    try:
        ref, got = np.asarray(jb.tts(TEXTS3)), pb.tts(TEXTS3)
    finally:
        jb.close()
        pb.close()
    assert (pb.batches_run, pb.rows_run, pb.batch_sizes) == (1, 3, [4])
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert max_err(got, ref) <= WAVE_TOL
    assert float(np.std(ref)) > 1e-2


def test_single_request_equals_locked_path(models):
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher

    _, pm = models
    synth = port_synth(pm)
    batcher = TTSMicroBatcher(synth)
    try:
        got = batcher.tts("Same words either way.")
    finally:
        batcher.close()
    np.testing.assert_array_equal(got, np.asarray(synth.tts("Same words either way."), dtype=np.float32))


def test_batch_error_reaches_every_request(models):
    """An exception in a batched call is raised in each request of the batch."""
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher

    _, pm = models
    broken = copy.copy(pm)
    broken.inference = lambda x, aux_input=None: (_ for _ in ()).throw(RuntimeError("decoder failed"))
    batcher = TTSMicroBatcher(port_synth(broken), gather_window_s=0.2)
    errors = []

    def go(text):
        try:
            batcher.tts(text)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=go, args=(t,)) for t in ("One here.", "Two here. And three.")]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        batcher.close()
    assert errors == ["decoder failed"] * 2 and batcher.batches_run == 0


def test_synthesizer_matches_jax(models):
    jm, pm = models
    text = "Hello there, world. How are you today?"
    ref = np.asarray(jax_synth(jm).tts(text), dtype=np.float32)
    synth = port_synth(pm)
    got = np.asarray(synth.tts(text, speaker_name="someone"), dtype=np.float32)  # single-speaker: ignored
    assert synth.resolve_speaker("someone") == (None, None) and synth.resolve_language("en") is None
    assert got.shape == ref.shape and float(np.std(ref)) > 1e-2
    assert max_err(got, ref) <= WAVE_TOL


def coqui_vits_file(sd, path, flat_old_weight_norm=False):
    """The port's VITS state dict written as Coqui writes it: a training
    checkpoint `{"model": ..., "optimizer": ..., "step": ...}` holding the
    discriminator too, or a flat dict with `weight_g`/`weight_v` pairs."""
    sd = {k: v.clone() for k, v in sd.items()}
    if flat_old_weight_norm:
        sd = {k.replace(".parametrizations.weight.original0", ".weight_g")
              .replace(".parametrizations.weight.original1", ".weight_v"): v for k, v in sd.items()}
        torch.save(sd, path)
        return path
    g = torch.Generator().manual_seed(0)
    v = torch.randn(16, 1, 15, generator=g)
    sd["disc.nets.0.convs.0.parametrizations.weight.original0"] = v.norm(dim=(1, 2), keepdim=True)
    sd["disc.nets.0.convs.0.parametrizations.weight.original1"] = v
    sd["disc.nets.0.convs.0.bias"] = torch.zeros(16)
    torch.save({"model": sd, "optimizer": [{"state": {}}], "step": 1000, "epoch": 3}, path)
    return path


def test_coqui_checkpoint_loads_in_both(models, tmp_path):
    from tpu_tts_torch.models.vits import Vits

    jm, pm = models
    path = coqui_vits_file(pm.net.state_dict(), str(tmp_path / "coqui.pth"))
    jl = copy.copy(jm)
    jl.load_checkpoint(jm.config, path)
    assert "discriminator" in jl.params and "posterior_encoder" not in jl.params["generator"]
    # the tiny model's (unread) posterior encoder keeps the param tree's
    # structure, so the compiled programs are reused
    jl.params["generator"]["posterior_encoder"] = jm.params["generator"]["posterior_encoder"]
    pl = Vits(port_config(), device="cpu")
    pl.load_checkpoint(pl.config, path)

    x = np.random.default_rng(4).integers(1, 40, (1, 13)).astype(np.int32)
    ref, got = jl.inference(x), pl.inference(x)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(ref["y_lengths"]))
    n = int(ref["y_lengths"][0]) * HOP
    assert max_err(got["model_outputs"][:, :n], np.asarray(ref["model_outputs"])[:, :n]) <= WAVE_TOL

    flat = Vits(port_config(), device="cpu")
    flat.load_checkpoint(flat.config, coqui_vits_file(pm.net.state_dict(), str(tmp_path / "flat.pth"), True))
    for k, v in pl.net.state_dict().items():
        assert torch.equal(flat.net.state_dict()[k], v), k

    broken = {k: v for k, v in pm.net.state_dict().items() if not k.startswith("flow.flows.0.")}
    torch.save({"model": broken}, tmp_path / "broken.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        Vits(port_config(), device="cpu").load_checkpoint(None, str(tmp_path / "broken.pth"))


def test_read_checkpoint_warns_before_a_full_pickle(tmp_path, capsys):
    """Tensors and plain containers load with `weights_only` and no warning;
    a pickled object (a training config) loads only after a warning."""
    from tpu_tts_torch.utils.checkpoint import read_checkpoint

    torch.save({"model": {"w": torch.ones(2)}, "step": 3}, tmp_path / "plain.pth")
    assert read_checkpoint(str(tmp_path / "plain.pth"))["step"] == 3
    assert "WARNING" not in capsys.readouterr().out
    torch.save({"model": {"w": torch.ones(2)}, "config": argparse.Namespace(lr=1e-3)}, tmp_path / "full.pth")
    ckpt = read_checkpoint(str(tmp_path / "full.pth"))
    assert ckpt["config"].lr == 1e-3 and torch.equal(ckpt["model"]["w"], torch.ones(2))
    assert "WARNING" in capsys.readouterr().out


# ------------------------------------------------------------------ HTTP surface

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's server on a tiny random VITS (noise scales 0) loaded from a
    Coqui-format checkpoint, its batcher with a 0.2 s gather window."""
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.server.server import TTSHandler, create_server

    torch.manual_seed(0)
    model = Vits.init_from_config(port_config(), device="cpu")
    tmp = tmp_path_factory.mktemp("serving")
    paths = {"model_path": coqui_vits_file(model.net.state_dict(), str(tmp / "model.pth")),
             "config_path": str(tmp / "config.json")}
    model.config.save_json(paths["config_path"])
    server = create_server(argparse.Namespace(**paths, device="cpu", host="127.0.0.1", port=0, max_batch=16))
    assert TTSHandler._batcher is not None
    TTSHandler._batcher.close()
    TTSHandler._batcher = TTSMicroBatcher(TTSHandler.synthesizer, gather_window_s=0.2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", TTSHandler, paths
    server.shutdown()
    server.server_close()
    TTSHandler._batcher.close()
    TTSHandler._batcher = None
    thread.join(timeout=10)


def _get(url, data=None):
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=120) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _pcm(body):
    assert body[:4] == b"RIFF"
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
    assert sr == 22050 and np.abs(pcm).max() > 0
    return pcm


def test_concurrent_requests_share_batches(served):
    from tpu_tts_torch.audio import wav_to_pcm16

    base, handler, _ = served
    batcher = handler._batcher
    texts = [f"Concurrent request number {w}." for w in ("one", "two", "three", "four")]
    b0, results = batcher.batches_run, {}

    def go(i):
        results[i] = _get(f"{base}/api/tts?text={urllib.parse.quote(texts[i])}")

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert batcher.batches_run - b0 < 4
    for i, text in enumerate(texts):
        status, ctype, body = results[i]
        assert status == 200 and ctype == "audio/wav"
        serial = wav_to_pcm16(np.asarray(handler.synthesizer.tts(text), dtype=np.float32))
        pcm = _pcm(body)
        assert pcm.shape == serial.shape
        assert np.abs(pcm.astype(np.int32) - serial).max() <= 1  # PCM16 rounding of float sums in another order


def test_index_and_marytts_routes(served, monkeypatch):
    base, handler, _ = served
    monkeypatch.setattr(handler._batcher, "gather_window_s", 0.0)  # one request at a time here
    status, ctype, body = _get(base + "/")
    assert status == 200 and ctype == "text/html" and b"<audio" in body
    assert _get(base + "/locales")[2] == b"en_US\n"
    assert _get(base + "/voices")[2] == b"default en_US u\n"
    by_get = _pcm(_get(base + "/process?INPUT_TEXT=" + urllib.parse.quote("Mary says hi."))[2])
    by_post = _pcm(_get(base + "/process", data=b"INPUT_TEXT=Mary+says+hi.&LOCALE=en_US")[2])
    np.testing.assert_array_equal(by_get, by_post)
    status, _, body = _get(base + "/api/tts", data=json.dumps({"text": "Mary says hi.", "speaker_id": ""}).encode())
    np.testing.assert_array_equal(_pcm(body), by_get)


def test_api_and_cli_by_path(served, tmp_path, capsys):
    from tpu_tts_torch.api import TTS
    from tpu_tts_torch.bin import synthesize

    _, _, paths = served
    tts = TTS(model_path=paths["model_path"], config_path=paths["config_path"], device="cpu")
    assert not tts.is_multi_speaker and tts.speakers is None and not tts.is_multi_lingual
    out = tts.tts_to_file(text="From the api.", file_path=str(tmp_path / "api.wav"))
    api_pcm = _pcm(open(out, "rb").read())
    synthesize.main(["--text", "From the api.", "--model_path", paths["model_path"], "--config_path",
                     paths["config_path"], "--out_path", str(tmp_path / "cli.wav"), "--device", "cpu"])
    np.testing.assert_array_equal(_pcm(open(tmp_path / "cli.wav", "rb").read()), api_pcm)
    capsys.readouterr()
    synthesize.main(["--list_models"])
    listed = capsys.readouterr().out
    assert "tts_models/en/ljspeech/vits" in listed and len(TTS.list_models()) == listed.count("\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTS(model_name="tts_models/en/ljspeech/vits")
