"""The port's DelightfulTTS training against `tpu_tts` on the CPU, f32.

The model runs at the tiny widths of `tests/test_train_delightful.py`
(hidden 32, one conformer layer of two heads, `spec_segment_size` 8,
HiFi-GAN 16 channels up by 8·8·4 to the hop of 256), every dropout 0, the
scale discriminator alone (no period: in float64 XLA:CPU takes seconds on
its 1024-channel convs; the VITS tests hold the period discriminators, and
the smoke's tiny DelightfulTTS step on the card has one), and the default
config's losses: aligner priors and the binary alignment term on. Both
packages compute on the same weights: `jax.eval_shape(init_params)` drawn
from a numpy seed, carried into the port by
`models/delightful_convert.py::training_params_from_flax`. Both read one
batch, collated by `tpu_tts` from `tests/data/ljspeech/`, and the same
segment draws (the JAX side takes them by patching `jax.random.uniform`
while it traces). Held here:

- pyin `compute_f0` (through `AudioProcessor.compute_f0`) on a seeded clip
  with voiced and silent stretches: the same voicing, F0 within 1e-4
  relative;
- `compute_attn_prior` within 1e-6;
- the batch `get_data_loader` collates with `compute_f0` and
  `use_attn_priors`: the same keys and shapes, values within 1e-5;
- `AlignmentNetwork` with and without a prior, with masked tokens: the soft
  attention and the finite log-probs within 1e-5, −inf where JAX has it;
- `forward_sum_loss` with unequal lengths within 1e-5, its gradient within
  1e-4, finite where the log-probs are −inf, also with a row that has more
  tokens than frames;
- one D step (0) and one G step (1) of `loss_fn` against
  `jax.value_and_grad(DelightfulTTS.loss_fn)`, both in one jitted program
  (which XLA compiles in 5 s less than one program each, sharing the
  generator forward), both sides in float64 (JAX with x64, the float32 its loss code names read
  as float64; the port's net and discriminator in float64): every logged
  term within 1e-5 relative, every gradient within 1e-3 of its tensor's
  largest |gradient| plus 1e-6 (weight-normalised kernels as dL/dW), the
  MAS durations equal. In float32 the multi-scale STFT term's log-magnitude
  gradient amplifies rounding: the port's own float32 G gradients part by
  up to 8e-4 of a tensor's max between 1 and 4 CPU threads, and JAX's and
  the port's by up to 6.7e-4 on this batch, a margin that would rest on the
  machine's summation order;
- `bin/train_tts` on the fixture, resumed with `--continue_path`, its run
  directory served by the `Synthesizer`.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import _compare_grads, _effective_jax_tree, _effective_torch_grads
from tests.test_torch_port_vocoder_train import _dft_bases64, _Float64Numpy
from tests.torch_port_common import CompiledAhead, cached_flax_shape_check, max_err, randomize, session_runs

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ljspeech")
PERIODS = []
CLIPS = ("LJ001-0001", "LJ001-0004")  # 12789 and 18081 samples: 50 and 71 mel frames, unequal rows
SEGMENTS = np.array([0.7, 0.2], np.float32)  # the decoder windows' uniforms


def tiny(cfg):
    """`tests/test_train_delightful.py`'s widths on either package's config,
    dropout 0, one period discriminator, the fixture as its dataset."""
    ma = cfg.model_args
    ma.n_hidden_conformer_encoder = ma.n_hidden_conformer_decoder = ma.n_hidden_variance_adaptor = 32
    ma.n_layers_conformer_encoder = ma.n_layers_conformer_decoder = 1
    ma.n_heads_conformer_encoder = ma.n_heads_conformer_decoder = 2
    ma.bottleneck_size_u_reference_encoder = 32
    ma.ref_enc_filters_reference_encoder = [4, 4, 8, 8, 16, 16]
    ma.spec_segment_size = 8
    ma.dropout_conformer_encoder = ma.dropout_conformer_decoder = ma.dropout_variance_adaptor = 0.0
    v = cfg.vocoder
    v.upsample_rates_decoder, v.upsample_kernel_sizes_decoder = [8, 8, 4], [16, 16, 8]
    v.upsample_initial_channel_decoder = 16
    v.resblock_kernel_sizes_decoder, v.resblock_dilation_sizes_decoder = [3], [[1, 3]]
    v.periods_discriminator = PERIODS
    cfg.text_cleaner, cfg.use_phonemes = "english_cleaners", False
    cfg.audio.do_trim_silence = False
    cfg.batch_size = cfg.eval_batch_size = 2
    cfg.num_loader_workers = 0
    return cfg


@functools.lru_cache(maxsize=None)
def jax_model():
    """The tiny JAX `DelightfulTTS`, its generator and discriminator drawn
    from a numpy seed (`randomize`; norms' scales ≈ 1 ± 0.1)."""
    from tpu_tts.audio import AudioProcessor
    from tpu_tts.configs import DelightfulTTSConfig
    from tpu_tts.models.delightful_tts import DelightfulTTS
    from tpu_tts.text.tokenizer import TTSTokenizer

    cfg = tiny(DelightfulTTSConfig())
    tok, cfg = TTSTokenizer.init_from_config(cfg)
    m = DelightfulTTS(cfg, ap=AudioProcessor.init_from_config(cfg), tokenizer=tok)
    shapes = jax.eval_shape(m.init_params, jax.random.PRNGKey(0))
    m.params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: 1.0 + 0.1 * np.tanh(leaf) if path[-1].key == "scale" else np.asarray(leaf),
        randomize(shapes, 5))
    return m


def port_config():
    from tpu_tts_torch.configs import DelightfulTTSConfig

    return tiny(DelightfulTTSConfig())


def port_model():
    from tpu_tts_torch.models.delightful_convert import training_params_from_flax
    from tpu_tts_torch.models.delightful_tts import DelightfulTTS

    m = DelightfulTTS.init_from_config(port_config(), device="cpu")
    m.init_training()
    m.load_training_state(training_params_from_flax(jax_model().params, PERIODS), strict=True)
    m.train(True)
    return m


def _samples(load):
    from tpu_tts.config.shared_configs import BaseDatasetConfig

    ds = BaseDatasetConfig(formatter="ljspeech", meta_file_train="metadata.csv", path=FIXTURE, dataset_name="fix")
    samples, _ = load([ds], eval_split=False)
    return [s for s in samples if os.path.basename(s["audio_file"])[:-4] in CLIPS]


@functools.lru_cache(maxsize=None)
def batches():
    """The fixture's two CLIPS through each package's `get_data_loader`
    (pitch and priors on): (JAX's numpy batch, the port's torch batch)."""
    from tpu_tts.data import load_tts_samples as jax_load
    from tpu_tts_torch.data import load_tts_samples

    jm, pm = jax_model(), port_model()
    jl = jm.get_data_loader(jm.config, {}, False, _samples(jax_load), False, 1)
    pl = pm.get_data_loader(pm.config, {}, False, _samples(load_tts_samples), False)
    (jb,), (pb,) = list(jl), list(pl)
    return jb, pb


# ------------------------------------------------------------------ features
def test_compute_f0_matches_jax():
    """pyin on 2.5 s of a seeded voiced tone with two silent stretches, a
    length that is a multiple of the hop (the hop/2 pad)."""
    from tpu_tts.audio import AudioProcessor as JaxAP
    from tpu_tts.configs import DelightfulTTSConfig as JaxConfig
    from tpu_tts_torch.audio import AudioProcessor

    rng = np.random.default_rng(11)
    sr, hop = 22050, 256
    t = np.arange(hop * 215) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    wav = sum(0.3 / h * np.sin(2 * np.pi * h * np.cumsum(f0) / sr) for h in range(1, 5))
    wav[int(0.6 * sr): int(0.9 * sr)] = 0.0
    wav[int(1.8 * sr): int(2.1 * sr)] = 0.0
    wav = (wav + 0.003 * rng.standard_normal(t.size)).astype(np.float32)
    ref = JaxAP.init_from_config(JaxConfig()).compute_f0(wav)
    got = AudioProcessor.init_from_config(port_config()).compute_f0(wav)
    assert got.shape == ref.shape and 0 < int((ref > 0).sum()) < ref.size  # voiced and unvoiced frames
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert np.all(np.abs(got - ref) <= 1e-4 * np.abs(ref))


def test_attn_prior_matches_jax():
    from tpu_tts.ops.helpers import compute_attn_prior as jax_prior
    from tpu_tts_torch.ops.helpers import compute_attn_prior

    for x_len, y_len in ((7, 30), (23, 71), (1, 5)):
        ref = jax_prior(x_len, y_len)
        got = compute_attn_prior(x_len, y_len)
        assert got.shape == ref.shape == (y_len, x_len) and max_err(got, ref) <= 1e-6


def test_collated_batch_matches_jax():
    """The two clips collated by each package's `get_data_loader`, which
    forces `compute_f0` and `return_wav`, with `use_attn_priors`."""
    jb, pb = batches()
    arrays = {k for k, v in jb.items() if isinstance(v, np.ndarray)}
    assert {"pitch", "attn_priors", "waveform"} <= arrays
    assert arrays == {k for k, v in pb.items() if torch.is_tensor(v)}
    for k in arrays:
        got = pb[k].numpy()
        ref = jb[k][:, None, :, 0] if k == "waveform" else jb[k]  # JAX's waveform is [B, T, 1]
        assert got.shape == ref.shape, k
        assert max_err(got.astype(np.float32), ref.astype(np.float32)) <= 1e-5, k
    assert float((jb["pitch"] > 0).mean()) > 0.1 and float(jb["attn_priors"].max()) > 0.1


# ------------------------------------------------------------------ aligner and its loss
@functools.lru_cache(maxsize=None)
def aligner_refs():
    """flax's `AlignmentNetwork` on the model's aligner params, with and
    without a prior, the second row's last 4 tokens masked."""
    from tpu_tts.layers.feed_forward import AlignmentNetwork
    from tpu_tts.ops.helpers import compute_attn_prior

    rng = np.random.default_rng(12)
    B, T_de, T_en = 2, 17, 9
    q = rng.standard_normal((B, T_de, 100)).astype(np.float32)
    k = rng.standard_normal((B, T_en, 32)).astype(np.float32)
    mask = (np.arange(T_en)[None] < np.array([T_en, 5])[:, None]).astype(np.float32)
    prior = np.stack([compute_attn_prior(T_en, T_de)] * B).astype(np.float32)
    mod = AlignmentNetwork(in_query_channels=100, in_key_channels=32)
    params = jax_model().params["generator"]["acoustic_model"]["aligner"]
    run = jax.jit(lambda p, q, k, m, pr: (mod.apply({"params": p}, q, k, mask=m),
                                         mod.apply({"params": p}, q, k, mask=m, attn_prior=pr)))
    return (q, k, mask, prior), jax.device_get(run(params, q, k, mask, prior))


def test_alignment_network_matches_flax():
    (q, k, mask, prior), refs = aligner_refs()
    aligner = port_model().net.acoustic_model.aligner
    for with_prior, (ref_soft, ref_logp) in zip((False, True), refs):
        with torch.no_grad():
            soft, logp = aligner(torch.from_numpy(q), torch.from_numpy(k), mask=torch.from_numpy(mask),
                                 attn_prior=torch.from_numpy(prior) if with_prior else None)
        assert max_err(soft, ref_soft) <= 1e-5
        finite = np.isfinite(ref_logp)
        assert not finite.all() and np.array_equal(np.isfinite(logp.numpy()), finite)
        assert np.all(np.isneginf(logp.numpy()[~finite]))
        assert float(np.abs(logp.numpy()[finite] - ref_logp[finite]).max()) <= 1e-5


@pytest.mark.parametrize("out_lens", [(30, 20, 11), (30, 4, 11)])
def test_forward_sum_loss_matches_jax(out_lens):
    """Three rows of unequal token and frame counts, −inf on masked tokens:
    the loss normalised by the mel lengths, and its gradient; with a row of
    more tokens (5) than frames (4) too, where `tpu_tts` gives about
    1e30 / out_len and the port takes its step-for-step forward."""
    from tpu_tts.layers.losses import forward_sum_loss as jax_fsl
    from tpu_tts_torch.layers.losses import forward_sum_loss

    rng = np.random.default_rng(13)
    x = (3 * rng.standard_normal((3, 1, 30, 9))).astype(np.float32)
    in_lens, out_lens = np.array([9, 5, 3]), np.array(out_lens)
    for b, n in enumerate(in_lens):
        x[b, :, :, n:] = -np.inf
    ref, ref_grad = jax.jit(jax.value_and_grad(jax_fsl))(jnp.asarray(x), jnp.asarray(in_lens), jnp.asarray(out_lens))
    t = torch.from_numpy(x).requires_grad_()
    loss = forward_sum_loss(t, torch.from_numpy(in_lens), torch.from_numpy(out_lens))
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * max(1.0, abs(float(ref)))
    assert torch.isfinite(t.grad).all() and float(np.abs(np.asarray(ref_grad)).max()) > 0
    assert max_err(t.grad, ref_grad) <= 1e-4


# ------------------------------------------------------------------ one D + G step
def _step_batches():
    """JAX's collated batch for both packages (the port's own is held to it
    above) in float64, the port's waveform channels-first."""
    jb, _ = batches()
    keys = ("text_input", "text_lengths", "mel_lengths", "waveform", "pitch", "attn_priors")
    jb = {k: np.asarray(jb[k], np.float64) if k in ("waveform", "pitch", "attn_priors") else np.asarray(jb[k])
          for k in keys}
    pb = {k: torch.from_numpy(v) for k, v in jb.items()}
    pb["waveform"] = pb["waveform"][:, None, :, 0]
    for k in ("text_input", "text_lengths", "mel_lengths"):
        pb[k] = pb[k].long()
    return jb, pb


@functools.lru_cache(maxsize=None)
def jax_step_program():
    """`jax.value_and_grad(DelightfulTTS.loss_fn)` of the D step (0) and the
    G step (1) in one jitted program, in float64: each (loss, (logs, MAS
    durations `[B, T_src]`), the gradient of the discriminator or the
    generator). Both halves of the params are arguments, so that XLA folds
    neither into the other's program. Traced when the module's first test
    starts (`_compile_ahead`), compiled meanwhile."""
    import flax.linen as nn

    import tpu_tts.layers.losses as jax_losses
    import tpu_tts.models.delightful_tts as jax_dtts
    import tpu_tts.vocoder.layers.losses as jax_voc_losses
    import tpu_tts.vocoder.models.hifigan_generator as jax_hifigan
    from tpu_tts.audio import jax_transforms
    from tpu_tts.layers.delightful import positional_encoding

    jm = jax_model()
    jb, _ = _step_batches()
    mas = jax_dtts.maximum_path_jax

    def step(params, batch):
        out = []
        for idx, key in ((0, "discriminator"), (1, "generator")):
            def loss_of(sub, idx=idx, key=key):
                seen = []

                def recorded(value, mask):
                    seen.append(mas(value, mask))
                    return seen[-1]

                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(jax_dtts, "maximum_path_jax", recorded)
                    loss, logs = jm.loss_fn({**params, key: sub}, batch, jax.random.PRNGKey(0), idx)
                return loss, (logs, seen[0].sum(-1))

            out.append(jax.value_and_grad(loss_of, has_aux=True)(params[key]))
        return out

    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda rng, shape=(), *a, **k: jnp.asarray(SEGMENTS))
        mp.setattr(jax_transforms, "_dft_bases", _dft_bases64)
        for module in (jax_dtts, jax_transforms, jax_losses, jax_voc_losses, jax_hifigan):
            mp.setattr(module, "jnp", _Float64Numpy())
        mp.setattr(jax_dtts, "positional_encoding", functools.partial(positional_encoding, dtype=jnp.float64))
        cell_carry = nn.GRUCell.initialize_carry  # the reference encoders' GRU state starts in float64 too
        mp.setattr(nn.GRUCell, "initialize_carry",
                   lambda self, rng, shape: cell_carry(self, rng, shape).astype(jnp.float64))
        params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), jm.params)
        return CompiledAhead(step, params, jb, context=jax.enable_x64)


def jax_step_refs():
    return jax_step_program().result()


@pytest.fixture(scope="module", autouse=True)
def _compile_ahead(request, cached_flax_shape_check):
    """The step program traced before the module's first test; XLA compiles
    it while the tests before the step tests (last in the module) run."""
    if session_runs(request, "test_train_step_losses_grads_and_durations_match_jax"):
        jax_step_program()


# ------------------------------------------------------------------ CLI
def test_train_tts_cli_continue_and_synthesize(tmp_path):
    """`bin/train_tts` trains one epoch on the fixture (`--small_run 2`: one
    step of 2 clips, then the eval), `--continue_path` resumes it for a
    second (the weights, `disc.*` included, restored strictly), and the
    newest checkpoint serves through the port's `Synthesizer`."""
    from tpu_tts_torch.bin.train_tts import main as train_main
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.ops import mas
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint, load_checkpoint

    out = str(tmp_path / "run")
    cfg = port_config()
    cfg.update(dict(epochs=1, print_step=1, save_step=10000, output_path=out, eval_split_size=0.25, run_eval=True,
                    test_delay_epochs=-1, f0_cache_path=str(tmp_path / "f0"),
                    dashboard_logger="none",  # the tensorboard writer is held by the VITS CLI test
                    datasets=[BaseDatasetConfig(formatter="ljspeech", meta_file_train="metadata.csv", path=FIXTURE,
                                                dataset_name="fix")]))
    cfg_path = str(tmp_path / "config.json")
    cfg.save_json(cfg_path)
    mas.load_library()
    train_main(["--config_path", cfg_path, "--device", "cpu", "--small_run", "2"])
    first, _ = get_last_checkpoint(out)
    state = load_checkpoint(first)
    assert state["epoch"] == 1 and state["step"] == 1
    assert any(k.startswith("disc.nets.0.") for k in state["model"])
    assert any(k.startswith("acoustic_model.aligner.") for k in state["model"])
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

    synth = Synthesizer(last, os.path.join(out, "config.json"), device="cpu")
    wav = np.asarray(synth.tts("a stitch in time saves nine."))
    assert wav.size > 1000 and np.isfinite(wav).all()


@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_train_step_losses_grads_and_durations_match_jax(optimizer_idx, monkeypatch):
    """One D step (0) or G step (1), float64 on both sides: every logged
    term, the loss, every gradient of the optimizer's half, and the
    aligner's MAS durations."""
    import tpu_tts_torch.models.delightful_tts as dtts
    from tpu_tts_torch.models.delightful_convert import params_from_flax
    from tpu_tts_torch.models.vits_convert import disc_params_from_flax

    (ref_loss, (ref_logs, ref_durations)), ref_grads = jax_step_refs()[optimizer_idx]
    pm = port_model()
    pm.net.double()
    pm.disc.double()
    _, pb = _step_batches()
    seen = []
    mas = dtts.maximum_path
    monkeypatch.setattr(dtts, "maximum_path", lambda v, m: seen.append(mas(v, m)) or seen[-1])
    loss, logs = pm.loss_fn(pb, optimizer_idx, draws={"segments": torch.from_numpy(SEGMENTS)})
    loss.backward()
    assert loss.dtype == torch.float64
    if optimizer_idx == 1:
        assert set(logs) == set(ref_logs) and "loss_binary_alignment" in logs
    for k, v in ref_logs.items():
        assert abs(float(logs[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, float(logs[k]), float(v))
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * max(1.0, abs(float(ref_loss)))
    durations = seen[0].sum(-1).numpy()
    np.testing.assert_array_equal(durations, np.asarray(ref_durations))
    assert durations.sum(1).tolist() == pb["mel_lengths"].tolist() and len(np.unique(durations[0])) > 2

    key = "discriminator" if optimizer_idx == 0 else "generator"
    eff = _effective_jax_tree(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), jax_model().params[key]),
                              ref_grads)
    if optimizer_idx == 0:
        _compare_grads(_effective_torch_grads(pm.disc), disc_params_from_flax(eff, PERIODS), "D")
        assert all(p.grad is None for p in pm.net.parameters())  # the D step leaves G alone
        return
    _compare_grads(_effective_torch_grads(pm.net), params_from_flax(eff), "G")
    assert all(p.grad is None for p in pm.disc.parameters())  # and the G step D
