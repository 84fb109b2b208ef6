"""The port's speaker encoder (M9a) against `tpu_tts` on the CPU, float32.

The port's encoders keep Coqui's layout, so their state dicts are Coqui
speaker-encoder state dicts: `tpu_tts.encoder.encoder_convert` builds the
JAX tree from them (frozen batch norms; for the "batch" and "layer" norms
the tree is regrouped into flax's `TorchBatchNorm_0`/`LayerNorm_0` nodes and
`batch_stats`). Tolerances:
- the LSTM and narrow ResNets (layers (1, 1, 1, 1), ASP and SAP, each norm)
  in eval within 1e-5;
- one training step of a "batch" ResNet with GE2E and angle-proto: loss
  within 1e-5 relative, every gradient within 1e-4 of its tensor's max, the
  running statistics within 1e-6;
- the four losses within 1e-6, their gradients too;
- `compute_embedding`'s windows within 1e-5;
- the managers' d-vector of a clip within 1e-5 of `tpu_tts.managers`', and
  the `Synthesizer` given that clip as `speaker_wav` synthesises with it;
- the speaker-consistency loss and its gradient within 1e-5.
Then `train_encoder` → `compute_embeddings` → `eval_encoder` on the
in-repo LJSpeech fixture.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.torch_port_common import TINY_ARGS, TINY_AUDIO, cached_flax_shape_check, max_err, seeded

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "ljspeech")
RESNET = dict(input_dim=16, proj_dim=8, layers=(1, 1, 1, 1), num_filters=(8, 8, 16, 16))


def jax_tree(net):
    """(params, batch_stats) of the JAX encoder for the port's `net`."""
    from tpu_tts.encoder.encoder_convert import convert_lstm_encoder_state_dict, convert_resnet_encoder_state_dict
    from tpu_tts_torch.encoder.models import LSTMSpeakerEncoder

    sd = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    if isinstance(net, LSTMSpeakerEncoder):
        tree = convert_lstm_encoder_state_dict(sd)
        for i in range(len(net.layers)):  # Coqui's projection has no bias, the port's and JAX's do
            tree[f"proj_{i}"]["bias"] = sd[f"layers.{i}.linear.bias"]
        return tree, {}
    if net.norm_type == "layer":  # the converter reads batch-norm keys
        sd.update({k[:-6] + suffix: np.zeros_like(v) if suffix.endswith("mean") else np.ones_like(v)
                   for k, v in list(sd.items()) if k.endswith(("bn1.weight", "bn2.weight", "downsample.1.weight",
                                                              "attention.2.weight"))
                   for suffix in ("running_mean", "running_var")})
    tree = convert_resnet_encoder_state_dict(sd, input_dim=net.input_dim, num_filters=net.num_filters)
    stats = {}

    def regroup(node, st, path=()):
        for k, v in node.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
                if net.norm_type == "batch":
                    node[k] = {"TorchBatchNorm_0": {"scale": v["scale"], "bias": v["bias"]}}
                    st[k] = {"TorchBatchNorm_0": {"mean": v["mean"], "var": v["var"]}}
                elif net.norm_type == "layer":
                    ln = {"scale": v["scale"], "bias": v["bias"]}
                    node[k] = ln if k == "attn_bn" else {"LayerNorm_0": ln}
            elif isinstance(v, dict):
                sub = {}
                regroup(v, sub, path + (k,))
                if sub:
                    st[k] = sub

    regroup(tree, stats)
    return tree, stats


def jax_net(net):
    from tpu_tts.encoder.models import LSTMSpeakerEncoder as JaxLSTM
    from tpu_tts.encoder.models import ResNetSpeakerEncoder as JaxResNet
    from tpu_tts_torch.encoder.models import LSTMSpeakerEncoder

    if isinstance(net, LSTMSpeakerEncoder):
        lstm = net.layers[0].lstm
        return JaxLSTM(input_dim=lstm.input_size, proj_dim=net.layers[0].linear.out_features,
                       lstm_dim=lstm.hidden_size, num_lstm_layers=len(net.layers))
    return JaxResNet(input_dim=net.input_dim, proj_dim=net.proj_dim, layers=net.layers, num_filters=net.num_filters,
                     encoder_type=net.encoder_type, norm_type=net.norm_type)


def _mel(seed, B=3, C=16, T=40):
    return np.random.default_rng(seed).standard_normal((B, C, T)).astype(np.float32)


@pytest.mark.parametrize("kind", ["lstm", "resnet-ASP-frozen_batch", "resnet-SAP-frozen_batch", "resnet-ASP-batch",
                                  "resnet-SAP-layer"])
def test_encoder_eval_matches_jax(kind):
    from tpu_tts_torch.encoder.models import LSTMSpeakerEncoder, ResNetSpeakerEncoder

    if kind == "lstm":
        net = seeded(LSTMSpeakerEncoder(input_dim=16, proj_dim=8, lstm_dim=12, num_lstm_layers=2), 1)
    else:
        _, enc, norm = kind.split("-")
        net = seeded(ResNetSpeakerEncoder(**RESNET, encoder_type=enc, norm_type=norm), 2)
    net.eval()
    params, stats = jax_tree(net)
    x = _mel(0)
    ref = jax.jit(lambda p, s, x: jax_net(net).apply({"params": p, **({"batch_stats": s} if s else {})}, x))(
        params, stats, jnp.asarray(x.transpose(0, 2, 1)))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (3, 8) and max_err(got, ref) <= 1e-5
    with torch.no_grad():
        raw = net(torch.from_numpy(x), l2_norm=False)
    assert float(raw.norm(dim=1).std()) > 1e-3  # the l2 norm does work


@pytest.mark.parametrize("loss", ["ge2e", "angleproto"])
def test_resnet_training_step_matches_jax(loss):
    """One training step of a "batch" ResNet (S = 2 speakers × U = 3
    utterances): the loss, every gradient (w and b included) and the new
    running statistics."""
    from tpu_tts.encoder.losses import angle_proto_loss as jax_angle, ge2e_loss as jax_ge2e
    from tpu_tts_torch.encoder.losses import angle_proto_loss, ge2e_loss
    from tpu_tts_torch.encoder.models import ResNetSpeakerEncoder

    net = seeded(ResNetSpeakerEncoder(**RESNET, norm_type="batch"), 3).train()
    params, stats = jax_tree(net)
    jn, jfn = jax_net(net), (jax_ge2e if loss == "ge2e" else jax_angle)
    x = _mel(1, B=6)

    @jax.jit
    def ref(all_params, stats, x):
        def loss_of(p):
            d, new = jn.apply({"params": p["model"], "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
            return jfn(d.reshape(2, 3, -1), p["w"], p["b"]), new["batch_stats"]

        return jax.value_and_grad(loss_of, has_aux=True)(all_params)

    (ref_loss, ref_stats), ref_grads = jax.device_get(ref({"model": params, "w": jnp.float32(10.0),
                                                           "b": jnp.float32(-5.0)}, stats,
                                                          jnp.asarray(x.transpose(0, 2, 1))))
    w, b = torch.nn.Parameter(torch.tensor(10.0)), torch.nn.Parameter(torch.tensor(-5.0))
    d = net(torch.from_numpy(x)).reshape(2, 3, -1)
    got_loss = (ge2e_loss if loss == "ge2e" else angle_proto_loss)(d, w, b)
    got_loss.backward()
    assert abs(float(got_loss) - float(ref_loss)) <= 1e-5 * max(1.0, abs(float(ref_loss)))
    for got, want in ((w.grad, ref_grads["w"]), (b.grad, ref_grads["b"])):
        assert abs(float(got) - float(want)) <= 1e-4 * max(abs(float(want)), 1e-3)

    flat_want = dict(_flatten(jax.tree.map(np.asarray, ref_grads["model"])))
    flat_got = dict(_flatten(jax_tree_of_grads(net)))
    assert set(flat_want) == set(flat_got)
    bad = []
    for k, g in flat_want.items():
        scale = float(np.abs(g).max())
        if not np.abs(flat_got[k] - g).max() <= 1e-4 * scale + 1e-6:  # the floor: attn_conv2's bias, 0 analytically
            bad.append((k, float(np.abs(flat_got[k] - g).max()), scale))
    assert not bad, bad[:6]
    got_stats = dict(_flatten(jax_tree(net)[1]))
    for k, v in _flatten(jax.tree.map(np.asarray, ref_stats)):
        assert np.abs(got_stats[k] - v).max() <= 1e-6, k
    assert any(np.abs(got_stats[k] - v).max() > 1e-3 for k, v in _flatten(stats))  # the statistics moved


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def jax_tree_of_grads(net):
    """The port's gradients in the JAX tree's layout: the bridge applied to a
    copy of the net whose parameters hold their gradients."""
    from tpu_tts_torch.encoder.models import ResNetSpeakerEncoder

    carrier = ResNetSpeakerEncoder(input_dim=net.input_dim, proj_dim=net.proj_dim, layers=net.layers,
                                   num_filters=net.num_filters, encoder_type=net.encoder_type, norm_type="batch")
    carrier.load_state_dict(net.state_dict())
    with torch.no_grad():
        for (name, p), (_, src) in zip(carrier.named_parameters(), net.named_parameters()):
            p.copy_(src.grad)
    return jax_tree(carrier)[0]


def test_losses_match_jax():
    """GE2E, angle-proto, softmax and softmax + angle-proto, values and
    gradients, with |w| below angle-proto's 1e-6 clamp in one case."""
    from tpu_tts.encoder import losses as jl
    from tpu_tts_torch.encoder import losses as pl

    rng = np.random.default_rng(4)
    dvecs = rng.standard_normal((3, 4, 5)).astype(np.float32)
    logits = rng.standard_normal((12, 3)).astype(np.float32)
    labels = np.repeat(np.arange(3), 4).astype(np.int32)

    @jax.jit
    def ref(d, w, b, lg):
        fns = (lambda d: jl.ge2e_loss(d, w, b), lambda d: jl.angle_proto_loss(d, w, b),
               lambda d: jl.softmax_loss(lg + d.sum(), labels), lambda d: jl.softmax_angle_proto_loss(d, w, b, lg, labels))
        return [jax.value_and_grad(f)(d) for f in fns]

    for w_val in (3.0, -1e-8):
        refs = jax.device_get(ref(jnp.asarray(dvecs), jnp.float32(w_val), jnp.float32(-1.0), jnp.asarray(logits)))
        w, b = torch.tensor(w_val), torch.tensor(-1.0)
        lg, lab = torch.from_numpy(logits), torch.from_numpy(labels)
        fns = (lambda d: pl.ge2e_loss(d, w, b), lambda d: pl.angle_proto_loss(d, w, b),
               lambda d: pl.softmax_loss(lg + d.sum(), lab), lambda d: pl.softmax_angle_proto_loss(d, w, b, lg, lab))
        for fn, (rv, rg) in zip(fns, refs):
            d = torch.from_numpy(dvecs).requires_grad_(True)
            v = fn(d)
            v.backward()
            assert abs(float(v) - float(rv)) <= 1e-6 * max(1.0, abs(float(rv)))
            assert max_err(d.grad, rg) <= 1e-6 * max(1.0, float(np.abs(rg).max()))


def _encoder_config(tmp, model_params, audio=None):
    """A speaker-encoder config (the port's) saved as JSON, and its path."""
    from tpu_tts_torch.encoder.configs import SpeakerEncoderConfig

    cfg = SpeakerEncoderConfig(output_path=str(tmp / "enc_out"), model_params=model_params)
    cfg.audio.update(dict(fft_size=256, win_length=256, hop_length=64, num_mels=16, mel_fmax=8000.0,
                          do_trim_silence=False, **(audio or {})))
    path = str(tmp / "enc_config.json")
    cfg.save_json(path)
    return cfg, path


def _lstm_checkpoint(tmp):
    """A seeded tiny LSTM encoder saved as a Coqui-format checkpoint (no
    projection bias, as Coqui's), with its config."""
    from tpu_tts_torch.encoder.models import LSTMSpeakerEncoder

    cfg, cfg_path = _encoder_config(tmp, {"model_name": "lstm", "input_dim": 16, "proj_dim": 16, "lstm_dim": 12,
                                          "num_lstm_layers": 1})
    net = seeded(LSTMSpeakerEncoder(input_dim=16, proj_dim=16, lstm_dim=12, num_lstm_layers=1), 5)
    sd = {k: v for k, v in net.state_dict().items() if not k.endswith("linear.bias")}
    path = str(tmp / "encoder.pth")
    torch.save({"model": sd, "step": 0}, path)
    return path, cfg_path


def test_compute_embedding_windows_match_jax(tmp_path):
    """`SpeakerEncoderModel.compute_embedding`: centred log-mels, 4 windows of
    20 frames at `np.linspace` offsets, their mean; and a clip shorter than
    a window taken whole."""
    from tpu_tts.encoder.models import SpeakerEncoderModel as JaxModel
    from tpu_tts_torch.config import load_config
    from tpu_tts_torch.encoder.models import setup_encoder_model

    ckpt, cfg_path = _lstm_checkpoint(tmp_path)
    pm = setup_encoder_model(load_config(cfg_path), device="cpu")
    pm.load_checkpoint(pm.config, ckpt)
    from tpu_tts.config import load_config as jax_load_config

    jm = JaxModel(jax_load_config(cfg_path))
    jm.load_checkpoint(jm.config, ckpt)
    wav = (np.random.default_rng(6).standard_normal(4000) * 0.3).astype(np.float32)
    for n in (4000, 900):
        assert max_err(pm.compute_embedding(wav[:n], num_frames=20, num_eval=4),
                       jm.compute_embedding(wav[:n], num_frames=20, num_eval=4)) <= 1e-5


def test_managers_and_synthesizer_speaker_wav(tmp_path):
    """A d-vector from a clip through the managers against
    `tpu_tts.managers`; the `Synthesizer` given that clip as `speaker_wav`
    synthesises with that d-vector; without an encoder it raises."""
    from tpu_tts import managers as jax_managers
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.infer.synthesis import synthesis
    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.managers import SpeakerManager
    from tpu_tts_torch.models.vits import Vits

    ckpt, cfg_path = _lstm_checkpoint(tmp_path)
    clip = str(tmp_path / "clip.wav")
    rate = 22050
    scipy.io.wavfile.write(clip, rate, (np.random.default_rng(7).standard_normal(6000) * 0.2).astype(np.float32))
    pman = SpeakerManager(encoder_model_path=ckpt, encoder_config_path=cfg_path, device="cpu")
    jman = jax_managers.SpeakerManager(encoder_model_path=ckpt, encoder_config_path=cfg_path)
    d = pman.compute_embedding_from_clip([clip, clip])
    assert len(d) == 16 and max_err(np.asarray(d), np.asarray(jman.compute_embedding_from_clip([clip, clip]))) <= 1e-5

    cfg = VitsConfig(model_args=VitsArgs(**{**TINY_ARGS, "use_d_vector_file": True, "d_vector_dim": 16}),
                     audio=VitsAudioConfig(**TINY_AUDIO))
    model = Vits.init_from_config(cfg, device="cpu")
    model.speaker_manager = pman
    synth = Synthesizer(device="cpu")
    synth.tts_model, synth.tts_config, synth.speaker_manager = model, cfg, pman
    got = np.asarray(synth.tts("hello there", speaker_wav=clip, split_sentences=False), np.float32)
    want = synthesis(model, "hello there", cfg, d_vector=np.asarray(jman.compute_embedding_from_clip(clip)))["wav"]
    assert max_err(got[: len(want)], want) <= 1e-4
    other = synthesis(model, "hello there", cfg, d_vector=-np.asarray(d))["wav"]
    assert max_err(other, want) > 1e-3  # the d-vector conditions the voice
    synth.speaker_manager = SpeakerManager()
    with pytest.raises(NotImplementedError, match="speaker encoder"):
        synth.tts("hello there", speaker_wav=clip)


def test_speaker_consistency_loss_matches_jax(tmp_path):
    """`Vits.speaker_consistency_loss` of real and generated segments, and
    its gradient through the generated side, against JAX's
    `_speaker_consistency_loss`; `init_training` without an encoder raises."""
    from tpu_tts import managers as jax_managers
    from tpu_tts.configs.vits_config import VitsArgs as JaxArgs
    from tpu_tts.configs.vits_config import VitsAudioConfig as JaxAudio
    from tpu_tts.configs.vits_config import VitsConfig as JaxConfig
    from tpu_tts.models.vits import Vits as JaxVits
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.managers import SpeakerManager
    from tpu_tts_torch.models.vits import Vits

    ckpt, cfg_path = _lstm_checkpoint(tmp_path)
    args = {**TINY_ARGS, "use_d_vector_file": True, "d_vector_dim": 16, "use_speaker_encoder_as_loss": True}
    pm = Vits(VitsConfig(model_args=VitsArgs(**args), audio=VitsAudioConfig(**TINY_AUDIO)), device="cpu",
              speaker_manager=SpeakerManager(encoder_model_path=ckpt, encoder_config_path=cfg_path, device="cpu"))
    jm = JaxVits(JaxConfig(model_args=JaxArgs(**args), audio=JaxAudio(**TINY_AUDIO)))
    jm.speaker_manager = jax_managers.SpeakerManager(encoder_model_path=ckpt, encoder_config_path=cfg_path)
    rng = np.random.default_rng(8)
    real, fake = ((rng.standard_normal((2, 1, 2048)) * 0.3).astype(np.float32) for _ in range(2))
    ref, ref_grad = jax.jit(jax.value_and_grad(lambda f: jm._speaker_consistency_loss(
        jnp.asarray(real.transpose(0, 2, 1)), f)))(jnp.asarray(fake.transpose(0, 2, 1)))
    f = torch.from_numpy(fake).requires_grad_(True)
    got = pm.speaker_consistency_loss(torch.from_numpy(real), f)
    got.backward()
    assert abs(float(got) - float(ref)) <= 1e-5
    assert max_err(f.grad.transpose(1, 2), ref_grad) <= 1e-5 * max(1.0, float(np.abs(np.asarray(ref_grad)).max()))
    assert all(p.grad is None for p in pm.speaker_manager.encoder.net.parameters())  # the encoder is frozen
    pm.init_training()
    bare = Vits(VitsConfig(model_args=VitsArgs(**args), audio=VitsAudioConfig(**TINY_AUDIO)), device="cpu")
    with pytest.raises(ValueError, match="speaker encoder"):
        bare.init_training()


def test_train_embed_eval_on_fixture(tmp_path, capsys):
    """`train_encoder` (2 steps, radam) → `compute_embeddings` →
    `eval_encoder` on the 2-speaker LJSpeech fixture (`metadata_2spk.csv`)
    with a narrow LSTM."""
    from tpu_tts_torch.bin.compute_embeddings import compute_embeddings
    from tpu_tts_torch.bin.eval_encoder import main as eval_main
    from tpu_tts_torch.bin.train_encoder import main as train_main
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.encoder.configs import SpeakerEncoderConfig

    out = str(tmp_path / "enc_out")
    cfg = SpeakerEncoderConfig(output_path=out, epochs=1, num_classes_in_batch=2, num_utter_per_class=2,
                               voice_len=0.8, save_step=1, print_step=1, lr=1e-3,
                               datasets=[BaseDatasetConfig(formatter="coqui", meta_file_train="metadata_2spk.csv",
                                                           path=FIXTURE, dataset_name="fix")])
    cfg.model_params.update({"proj_dim": 16, "lstm_dim": 32, "num_lstm_layers": 1})
    cfg.audio.mel_fmax = 8000.0
    cfg_path = str(tmp_path / "enc_config.json")
    cfg.save_json(cfg_path)
    train_main(["--config_path", cfg_path, "--max_steps", "2", "--device", "cpu"])
    ckpts = sorted(glob.glob(os.path.join(out, "checkpoint_*.pth")))
    assert [os.path.basename(p) for p in ckpts] == ["checkpoint_1.pth", "checkpoint_2.pth"]
    first, last = (torch.load(p, weights_only=False)["model"] for p in ckpts)
    assert any(not torch.equal(first[k], last[k]) for k in first)  # radam moved the weights
    emb_path = str(tmp_path / "speakers.json")
    compute_embeddings(ckpts[-1], os.path.join(out, "config.json"), emb_path, config_dataset_path=cfg_path,
                       no_eval=True, device="cpu")
    embs = json.load(open(emb_path))
    assert len(embs) == 16 and {v["name"] for v in embs.values()} == {"spk0", "spk1"}
    assert all(len(v["embedding"]) == 16 and np.isfinite(v["embedding"]).all() for v in embs.values())
    capsys.readouterr()
    r = eval_main([ckpts[-1], os.path.join(out, "config.json"), cfg_path, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "mean intra-speaker cosine" in printed and "separation margin" in printed and np.isfinite(r["margin"])
