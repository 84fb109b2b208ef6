"""The port's VITS serving slice against `tpu_tts` (CPU, f32).

`Vits.inference` of both packages on the same weights and token ids, with
both noise scales at 0: the waveform within 2e-4 and the durations and
`y_lengths` equal. The JAX durations are first held ≥ 1e-3 from an integer,
so a ceil near-tie fails loudly instead of flaking. Then the weight bridge
back through the JAX package's own converter, and the port's `Synthesizer`
and `/api/tts` server on the CPU.
"""

import argparse
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

from tests.torch_port_common import jax_model, max_err, port_config, port_model
from tpu_tts.models.vits_convert import convert_vits_torch_state_dict

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return jax_model(), port_model()


def test_inference_matches_jax(models):
    jm, pm = models
    x = np.random.default_rng(4).integers(1, 40, (1, 13)).astype(np.int32)

    def durations(m, x, xl):
        h, _, _, mask = m.text_encoder(x, xl)
        logw = m.duration_predictor(h, mask, reverse=True, noise_scale=0.0)
        return jnp.exp(logw) * mask

    w = jax.jit(lambda p, x, xl: jm.net.apply({"params": p}, x, xl, method=durations, rngs={"sdp": jax.random.PRNGKey(0)}))(
        jm.params["generator"], jnp.asarray(x), jnp.asarray([13])
    )
    w = np.asarray(w)[0, :, 0]
    assert np.min(np.abs(w - np.round(w))) >= 1e-3, f"ceil near-tie in the JAX durations {w}"

    ref = jm.inference(x)
    got = pm.inference(x)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(ref["y_lengths"]))
    np.testing.assert_array_equal(got["durations"].numpy()[0, :13], np.ceil(w))
    np.testing.assert_array_equal(got["alignments"].numpy(), np.asarray(ref["alignments"]))
    assert float(np.std(np.asarray(ref["model_outputs"]))) > 1e-2
    assert max_err(got["model_outputs"], ref["model_outputs"]) <= 2e-4


def test_weight_bridge_round_trip(models):
    """port state_dict → the JAX package's converter → the JAX params the port
    was loaded from. Weight-normalised kernels are compared folded: the
    converter stores (v = kernel, g = ‖kernel‖)."""
    jm, pm = models
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    back = convert_vits_torch_state_dict(sd)["generator"]
    src = {k: v for k, v in jm.params["generator"].items() if k != "posterior_encoder"}

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

    walk(src, back, "")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from tpu_tts_torch.models.vits import Vits

    torch.manual_seed(0)
    config = port_config(inference_noise_scale=0.667, inference_noise_scale_dp=1.0)
    model = Vits.init_from_config(config, device="cpu")
    tmp = tmp_path_factory.mktemp("port_ckpt")
    torch.save(model.net.state_dict(), tmp / "model.pth")
    model.config.save_json(str(tmp / "config.json"))
    return str(tmp / "model.pth"), str(tmp / "config.json")


def test_synthesizer_tts_on_cpu(checkpoint):
    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP, Synthesizer

    synth = Synthesizer(*checkpoint, device="cpu")
    text = "Hello world. How are you?"
    wav = np.asarray(synth.tts(text), dtype=np.float32)
    model = synth.tts_model
    frames = [int(model.inference(model.tokenizer.text_to_ids(s))["y_lengths"][0]) for s in synth.split_into_sentences(text)]
    assert len(frames) == 2
    assert len(wav) == sum(frames) * model.ap.hop_length + 2 * SENTENCE_GAP
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_server_api_tts_on_cpu(checkpoint):
    from tpu_tts_torch.server.server import create_server

    args = argparse.Namespace(model_path=checkpoint[0], config_path=checkpoint[1], device="cpu", host="127.0.0.1", port=0)
    server = create_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/api/tts"
        req = urllib.request.Request(url, data=json.dumps({"text": "Be a voice."}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            body = r.read()
        assert body[:4] == b"RIFF"
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        assert sr == 22050 and len(pcm) > 0 and np.abs(pcm).max() > 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
