"""The port's XTTS-v2 GPT fine-tuning against `tpu_tts` on the CPU, at the
JAX fixture's widths (`tests/torch_port_common.py::XTTS_ARGS`) with a tiny
DVAE, float32, the same seeded weights and batch on both sides.

Tolerances:
- `torchaudio_mel` within 1e-5 of JAX's, with and without `mel_norms`
  (torch's FFT against JAX's DFT matmuls);
- the DVAE's codes equal JAX's, through the weight bridge and through
  Coqui's `dvae.pth` keys; its decoded mel within 1e-4 relative;
- `train_forward`'s targets and masks equal; each loss term within 1e-5
  relative, through the ready-made codes and through the raw wavs; every
  trained gradient within 1e-4 of its tensor's largest |gradient|, against
  `jax.grad`; the decoder and `speaker_proj` get none;
- three AdamW updates against `optax.masked(adamw)` at the recipe's
  settings within 1e-6 relative, the frozen parameters bit-identical;
- the dataset's items and collate equal to JAX's on the same generators.
Then `bin/train_tts` fine-tunes a model directory on the CPU.
"""

import functools
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.torch_port_common import XTTS_ARGS, cached_flax_shape_check, jax_xtts, max_err, port_xtts

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

DVAE = dict(num_tokens=XTTS_ARGS["gpt_num_audio_tokens"] - 2, codebook_dim=16, hidden_dim=16, num_layers=2,
            num_resnet_blocks=1, channels=80)
TRAIN = dict(max_text_length=12, max_wav_length=4096, min_conditioning_length=1536, max_conditioning_length=2560)
B = 2
MEL = dict(hop_length=256, win_length=1024, sample_rate=22050, num_mels=80, fmin=0.0, fmax=8000.0)


@functools.lru_cache(maxsize=None)
def jax_dvae():
    """A tiny JAX `DiscreteVAE` with params from a numpy seed (encoder, decoder, codebook)."""
    from tpu_tts.layers.xtts.dvae import DiscreteVAE

    dvae = DiscreteVAE(**DVAE)
    shapes = jax.eval_shape(lambda: dvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80))))["params"]
    rng = np.random.default_rng(11)
    return dvae, jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def port_dvae():
    from tpu_tts_torch.layers.xtts.dvae import DiscreteVAE
    from tpu_tts_torch.models.xtts_convert import dvae_params_from_flax

    dvae = DiscreteVAE(**DVAE)
    dvae.load_state_dict(dvae_params_from_flax(jax_dvae()[1]), strict=True)
    return dvae.eval().requires_grad_(False)


@functools.lru_cache(maxsize=None)
def models():
    """The tiny JAX and port XTTS (the other XTTS files' weights; the loss
    reads no length of TRAIN, the batch has them) and the tiny DVAE."""
    jm, pm = jax_xtts(), port_xtts()
    jm.dvae, jm.dvae_params = jax_dvae()
    jm.mel_norms = None
    pm.dvae = port_dvae()
    return jm, pm


def _batch(seed=0):
    """Raw-wav batch (numpy): text of lengths 9 and 5, wavs of 4096 and 2500 samples, conditioning slices."""
    rng = np.random.default_rng(seed)
    text = np.zeros((B, TRAIN["max_text_length"]), np.int32)
    text[0, :9], text[1, :5] = rng.integers(1, 47, 9), rng.integers(1, 47, 5)
    wav = np.zeros((B, TRAIN["max_wav_length"]), np.float32)
    cond = np.zeros((B, TRAIN["max_conditioning_length"]), np.float32)
    for i, (n, c) in enumerate(((4096, 2560), (2500, 1800))):
        t = np.arange(n)
        wav[i, :n] = 0.4 * np.sin(2 * np.pi * (0.01 + 0.005 * i) * t) + 0.05 * rng.standard_normal(n)
        cond[i, :c] = 0.3 * rng.standard_normal(c)
    return {"text_tokens": text, "text_lengths": np.array([9, 5], np.int32), "wav": wav,
            "wav_lengths": np.array([4096, 2500], np.int32), "cond_wav": cond,
            "cond_lengths": np.array([2560, 1800], np.int32)}


@pytest.mark.parametrize("norms", [False, True])
def test_torchaudio_mel_matches_jax(norms):
    from tpu_tts.audio import jax_transforms as jt
    from tpu_tts_torch.audio import torch_transforms as tt

    y = _batch()["wav"]
    mel_norms = (1.0 + np.random.default_rng(2).uniform(size=80)).astype(np.float32) if norms else None
    for fft in (2048, 1024):  # the conditioning mel, the DVAE's mel
        ref = jax.jit(lambda y, n, fft=fft: jt.torchaudio_mel(y, fft_size=fft, mel_norms=n, **MEL))(y, mel_norms)
        got = tt.torchaudio_mel(torch.from_numpy(y), fft_size=fft, **MEL,
                                mel_norms=None if mel_norms is None else torch.from_numpy(mel_norms))
        assert got.shape == (B, 80, 1 + y.shape[1] // 256)
        assert max_err(got.transpose(1, 2), ref) <= 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def test_dvae_codes_match_jax_through_the_bridge_and_coqui_keys():
    from tpu_tts.layers.xtts.dvae import DiscreteVAE, convert_dvae_torch_state_dict
    from tpu_tts_torch.layers.xtts.dvae import DiscreteVAE as PortDVAE
    from tpu_tts_torch.layers.xtts.dvae import load_dvae_state

    jd, params = jax_dvae()
    mel = np.random.default_rng(5).standard_normal((B, 36, 80)).astype(np.float32)
    pd = port_dvae()
    # a state dict in Coqui's key layout, with the codebook's training buffers
    coqui = {k: v.clone() for k, v in pd.state_dict().items()}
    coqui.update({"codebook.cluster_size": torch.zeros(DVAE["num_tokens"]),
                  "codebook.embed_avg": torch.zeros(DVAE["codebook_dim"], DVAE["num_tokens"])})
    via_jax = convert_dvae_torch_state_dict({k: v.numpy() for k, v in coqui.items()})

    @jax.jit
    def refs(params, via_jax, mel):
        codes = jd.apply({"params": params}, mel, method=DiscreteVAE.get_codebook_indices)
        return (codes, jd.apply({"params": params}, codes, method=DiscreteVAE.decode),
                jd.apply({"params": via_jax}, mel, method=DiscreteVAE.get_codebook_indices))

    ref, dec_ref, ref_coqui = (np.asarray(r) for r in refs(params, via_jax, mel))
    got = pd.get_codebook_indices(torch.from_numpy(mel).transpose(1, 2)).numpy()
    assert got.shape == (B, 9) and len(np.unique(ref)) > 3
    np.testing.assert_array_equal(got, ref)
    dec = pd.decode(torch.from_numpy(got)).transpose(1, 2)
    assert max_err(dec, dec_ref) <= 1e-4 * float(np.abs(dec_ref).max())
    np.testing.assert_array_equal(ref_coqui, ref)
    loaded = PortDVAE(**DVAE)
    load_dvae_state(loaded, {"model": coqui}, strict=True)
    np.testing.assert_array_equal(loaded.get_codebook_indices(torch.from_numpy(mel).transpose(1, 2)).numpy(), ref)


@functools.lru_cache(maxsize=None)
def jax_loss_refs():
    """`jax.value_and_grad(Xtts.loss_fn)` on `_batch()` through the raw wavs
    and through ready-made codes (the raw route's, with shorter lengths),
    with the framed targets and masks of `train_forward`; one program."""
    from tpu_tts.models.xtts import XttsNet

    jm, _ = models()

    @jax.jit
    def step(params, raw):
        def value_and_grad(b):
            return jax.value_and_grad(lambda p: jm.loss_fn(p, b, jax.random.PRNGKey(0)), has_aux=True)(params)

        codes = jm.dvae.apply({"params": jm.dvae_params}, jm._dvae_mel(raw["wav"]),
                              method=type(jm.dvae).get_codebook_indices)
        ready = {"text_tokens": raw["text_tokens"], "text_lengths": raw["text_lengths"],
                 "cond_mel": jm._style_mel(raw["cond_wav"]), "audio_codes": codes,
                 "code_lengths": jnp.array([7, 5], jnp.int32)}
        framed = jm.net.apply({"params": params}, ready["cond_mel"], ready["text_tokens"], ready["text_lengths"],
                              jnp.pad(codes, ((0, 0), (0, 3))), ready["code_lengths"], method=XttsNet.train_forward)
        framed = {k: framed[k] for k in ("text_targets", "mel_targets", "text_mask", "mel_mask")}
        return {"wavs": (value_and_grad(raw), raw, None), "codes": (value_and_grad(ready), ready, framed)}

    return jax.device_get(step(jm.params, {k: jnp.asarray(v) for k, v in _batch().items()}))


@pytest.mark.parametrize("route", ["codes", "wavs"])
def test_loss_and_gradients_match_jax(route):
    """`Xtts.loss_fn` against `jax.value_and_grad(Xtts.loss_fn)`: the framing
    (targets, masks) of `train_forward`, each loss term, every gradient of
    the trained set; the frozen decoder and `speaker_proj` get none."""
    from tpu_tts_torch.models.xtts_convert import params_from_flax

    _, pm = models()
    ((ref_loss, ref_logs), ref_grads), jb, framed = jax_loss_refs()[route]
    pb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    pb = {k: v.transpose(1, 2) if k == "cond_mel" else (v.long() if not v.is_floating_point() else v)
          for k, v in pb.items()}
    pm.net.zero_grad(set_to_none=True)
    pm.train(True)
    loss, logs = pm.loss_fn(pb, 0)
    loss.backward()
    pm.train(False)
    for k in ("loss_text_ce", "loss_mel_ce"):
        assert abs(float(logs[k]) - float(ref_logs[k])) <= 1e-5 * max(1.0, abs(float(ref_logs[k]))), k
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * max(1.0, abs(float(ref_loss)))
    if framed is not None:
        cond, codes, code_lengths = pm.targets(pb)
        out = pm.net.train_forward(cond, pb["text_tokens"], pb["text_lengths"], torch.nn.functional.pad(codes, (0, 3)),
                                   code_lengths)
        for k, v in framed.items():
            np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)

    trained = {k: v for k, v in ref_grads.items() if k not in ("hifigan_decoder", "speaker_proj")}
    want = params_from_flax(trained)
    got = dict(pm.net.named_parameters())
    assert set(want) == {n for n in got if n.startswith("gpt.")}
    bad = []
    for name, w in want.items():
        g = got[name].grad
        scale = float(w.abs().max())
        if g is None or not float((g - w).abs().max()) <= 1e-4 * scale + 1e-7:
            bad.append((name, None if g is None else float((g - w).abs().max()), scale))
    assert not bad, bad[:6]
    assert all(p.grad is None for n, p in got.items() if not n.startswith("gpt."))
    assert float(got["gpt.conditioning_encoder.init.weight"].grad.abs().max()) > 0


def test_masked_adamw_matches_optax():
    """Three updates of `Xtts.get_optimizer()` (AdamW at the recipe's lr
    5e-6, betas 0.9/0.96, eps 1e-8, weight decay 1e-2, the exponential
    schedule) against `optax.masked(adamw)` with the frozen decoder and
    `speaker_proj` masked out and given zero gradients, as JAX's loss gives
    them: the trained parameters within 1e-6 relative, the frozen ones
    bit-identical. AdamW is elementwise, so each side's parameters go to
    optax as two flat vectors, trained and frozen."""
    import optax

    from tpu_tts.train.optimizers import get_scheduler

    pm = port_xtts()
    pm.config.lr, pm.config.lr_scheduler = 5e-6, "exponential"
    pm.config.lr_scheduler_params = {"gamma": 0.5, "decay_steps": 2}
    pm.config.optimizer_params = {"betas": [0.9, 0.96], "eps": 1e-8, "weight_decay": 1e-2}
    (opt,) = pm.get_optimizer()
    named = dict(pm.net.named_parameters())
    trained = [n for n in named if n.startswith("gpt.")]
    assert {id(p) for p in opt.params} == {id(named[n]) for n in trained}
    frozen_names = [n for n in named if not n.startswith("gpt.")]
    assert any(n.startswith("speaker_proj.") for n in frozen_names) and any("hifigan_decoder" in n for n in frozen_names)

    def flat(names):
        return jnp.asarray(torch.cat([named[n].detach().reshape(-1) for n in names]).numpy())

    tx = optax.masked(optax.adamw(get_scheduler("exponential", {"gamma": 0.5, "decay_steps": 2}, 5e-6), b1=0.9,
                                  b2=0.96, eps=1e-8, weight_decay=1e-2), {"trained": True, "frozen": False})
    params = {"trained": flat(trained), "frozen": flat(frozen_names)}
    frozen = {n: named[n].detach().clone() for n in frozen_names}

    @jax.jit
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    rng = np.random.default_rng(4)
    for _ in range(3):
        g = (0.1 * rng.standard_normal(params["trained"].shape)).astype(np.float32)
        params, state = update({"trained": jnp.asarray(g), "frozen": jnp.zeros_like(params["frozen"])}, state, params)
        offset = 0
        for n in trained:
            p = named[n]
            p.grad = torch.from_numpy(g[offset : offset + p.numel()].copy()).reshape(p.shape)
            offset += p.numel()
        assert opt.step()
    np.testing.assert_allclose(flat(trained), np.asarray(params["trained"]), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(params["frozen"]), flat(frozen_names))
    assert all(torch.equal(named[n].detach(), frozen[n]) for n in frozen_names)
    assert opt.count == 3 and opt.lr() == pytest.approx(5e-6 * 0.5 ** (3 / 2))


def _write_clips(root, n=3, seed=7):
    """n wavs of 0.1–0.19 s at 22050 Hz in LJSpeech's layout, with their metadata."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    lines = []
    for i in range(n):
        sig = 0.3 * rng.standard_normal(2205 + 1000 * i)
        scipy.io.wavfile.write(os.path.join(root, "wavs", f"c{i}.wav"), 22050, (sig * 32767 / 2).astype(np.int16))
        text = "hello world again"[: 8 + 3 * i]
        lines.append(f"c{i}|{text}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return [{"text": ln.split("|")[1], "audio_file": os.path.join(root, "wavs", ln.split("|")[0] + ".wav"),
             "language": "en"} for ln in lines]


class CharTokenizer:
    """Token ids from a character table (no XTTS vocab ships with the repository)."""

    def encode(self, text, lang):
        return [ord(c) % 40 + 1 for c in text]


def test_dataset_items_and_collate_match_jax(tmp_path):
    """Items and the fixed-shape collate equal JAX's: in eval (the middle
    slice), and in training when both packages draw the slice from the
    port's per-item generator; the loader's epochs are repeatable."""
    from tpu_tts.layers.xtts import dataset as jds
    from tpu_tts_torch.layers.xtts.dataset import XttsDataLoader, XttsDataset, get_prompt_slice

    samples = _write_clips(str(tmp_path))
    kw = dict(tokenizer=CharTokenizer(), sample_rate=22050, max_text_length=10, max_wav_length=4000,
              min_conditioning_length=1500, max_conditioning_length=2600, seed=3)
    for is_eval in (True, False):
        jd, pd = jds.XttsDataset(samples, is_eval=is_eval, **kw), XttsDataset(samples, is_eval=is_eval, **kw)
        pd.epoch = 2
        items = [pd[i] for i in range(len(pd))]
        for i, it in enumerate(items):
            if not is_eval:  # hand JAX the port's generator of this item
                jd.rng = pd.item_rng(i)
            ref = jd[i]
            for k in ("text_tokens", "wav", "cond_wav"):
                np.testing.assert_array_equal(it[k], ref[k], err_msg=k)
            assert (it["text_length"], it["wav_length"], it["cond_length"]) == (
                ref["text_length"], ref["wav_length"], ref["cond_length"])
        if not is_eval:
            assert [len(it["cond_wav"]) for it in items] != [min(2600, it["wav_length"]) for it in items]
            np.testing.assert_array_equal(get_prompt_slice(items[0]["wav"], 2600, 1500, random.Random(1)),
                                          jds.get_prompt_slice(items[0]["wav"], 2600, 1500, random.Random(1)))
        for k, v in jd.collate(items).items():
            np.testing.assert_array_equal(pd.collate(items)[k].numpy(), v, err_msg=k)
    loader = XttsDataLoader(pd, batch_size=2, seed=3)
    loader.set_epoch(1)
    a = [b["cond_wav"] for b in loader]
    loader.set_epoch(1)
    b = [b["cond_wav"] for b in loader]
    assert len(a) == 1 and torch.equal(a[0], b[0])


def test_train_tts_cli_fine_tunes_a_model_directory(tmp_path, monkeypatch):
    """`bin/train_tts --restore_path <model dir>/model.pth` fine-tunes the
    tiny XTTS on the CPU for one step (a DVAE from seed 0): the run directory
    holds a checkpoint, `config.json` and the base's `speakers_xtts.pth`, the
    GPT moved and the decoder and `speaker_proj` did not, and the
    `Synthesizer` loads it as a model directory."""
    from tpu_tts_torch.bin.train_tts import main as train_main
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.layers.xtts.tokenizer import VoiceBpeTokenizer
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint, load_checkpoint

    monkeypatch.setattr(VoiceBpeTokenizer, "encode", lambda self, text, lang: CharTokenizer().encode(text, lang))
    base = port_xtts(**TRAIN)  # the data loader reads TRAIN's lengths
    model_dir, run = tmp_path / "base", str(tmp_path / "run")
    os.makedirs(model_dir)
    torch.save({"model": base.net.state_dict()}, model_dir / "model.pth")
    torch.save({"spk": {"gpt_cond_latent": torch.zeros(4, 32), "speaker_embedding": torch.ones(16)}},
               model_dir / "speakers_xtts.pth")
    _write_clips(str(tmp_path / "data"))
    cfg = base.config
    cfg.update({"batch_size": 2, "eval_batch_size": 1, "epochs": 1, "print_step": 1, "save_step": 0, "lr": 1e-3,
                "output_path": run, "run_eval": False, "eval_split_size": 0.34, "optimizer_params": {}, "lr_scheduler": "exponential",
                "lr_scheduler_params": {"gamma": 0.5, "decay_steps": 50000},
                "datasets": [BaseDatasetConfig(formatter="ljspeech", path=str(tmp_path / "data"), language="en",
                                               meta_file_train="metadata.csv").to_dict()]})
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    train_main(["--config_path", cfg_path, "--restore_path", str(model_dir / "model.pth"), "--device", "cpu"])
    last, _ = get_last_checkpoint(run)
    state = load_checkpoint(last)
    assert state["step"] == 1 and os.path.exists(os.path.join(run, "speakers_xtts.pth"))
    before, after = base.net.state_dict(), state["model"]
    assert not torch.equal(after["gpt.mel_head.weight"], before["gpt.mel_head.weight"])
    for k in before:
        if not k.startswith("gpt."):
            assert torch.equal(after[k], before[k]), k
    synth = Synthesizer(model_dir=run, device="cpu")
    assert torch.equal(synth.tts_model.net.state_dict()["gpt.mel_head.weight"], after["gpt.mel_head.weight"])
    assert "spk" in synth.tts_model._bundled_speakers()
