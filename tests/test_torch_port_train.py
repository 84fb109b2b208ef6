"""The port's VITS training (M6) against `tpu_tts` on the CPU, f32.

Both sides read one seeded numpy batch and the same three draws: the
posterior's ε, the SDP posterior's noise and the segment uniforms (the JAX
side takes them by patching `jax.random.normal`/`uniform` while it traces;
`tpu_tts` is not changed). Dropout is 0 on both sides. Tolerances:
- MAS: the torch loop, the C++ copy and `maximum_path_jax` give equal paths;
- `wav_to_spec` / `wav_to_mel` within 1e-5 (torch's FFT against JAX's DFT
  matmuls);
- inside the G step, the posterior encoder's (z, m, logs), the forward
  flow's output and the SDP's negative log-likelihood within 1e-4;
- the discriminator's scores and features within 1e-5;
- one D step and one G step: each loss term within 1e-5 relative, and every
  parameter's gradient within 1e-3 of that tensor's largest |gradient| plus
  1e-6 (f32 sums in another order; the floor covers gradients that are 0
  analytically, such as the attention's key biases, which the softmax
  cancels); the weight-normalised kernels are compared as dL/dW of the
  folded kernel, since the two packages split W into (g, v) differently;
- the optimizer update against optax's within 1e-6 relative, through the
  exponential schedule, the clip, a non-finite skip and two micro-batches
  a step (`optax.MultiSteps`).
Then the train → continue → synthesize cycle through `bin/train_tts` on
the in-repo LJSpeech fixture, a Coqui-format `.pth` round trip, and the
train-mode generator's gradients.
"""

import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import SEED, TINY_ARGS, TINY_AUDIO, cached_flax_shape_check, max_err, port_config, randomize
from tpu_tts_torch.ops import hifigan_mrf, mas

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

# TINY_ARGS cut where the JAX G step's compile time grows (one text-encoder
# layer, one WN layer a coupling, one resblock kernel), and no dropout
TRAIN_ARGS = dict(num_layers_text_encoder=1, num_layers_flow=1, resblock_kernel_sizes_decoder=[3],
                  resblock_dilation_sizes_decoder=[[1, 3]], dropout_p_text_encoder=0.0,
                  dropout_p_duration_predictor=0.0)
B, T_X, T_SPEC = 2, 11, 24
HOP = 16


@functools.lru_cache(maxsize=None)
def jax_train_model():
    """The tiny JAX `Vits` at TRAIN_ARGS, its generator and discriminator
    params drawn from a numpy seed (`randomize`). The tree's layout comes
    from the JAX package's own Coqui converter applied to the port's state
    dict, in a second rather than the seconds a flax trace of the training
    forward takes; flax's `apply` would reject a tree that lacked a
    parameter."""
    from tpu_tts.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts.models.vits import Vits
    from tpu_tts.models.vits_convert import convert_vits_torch_state_dict
    from tpu_tts_torch.models.vits import Vits as PortVits

    m = Vits(VitsConfig(model_args=VitsArgs(**{**TINY_ARGS, **TRAIN_ARGS}), audio=VitsAudioConfig(**TINY_AUDIO)))
    pm = PortVits(port_config(**TRAIN_ARGS), device="cpu")
    pm.init_training()
    tree = convert_vits_torch_state_dict({k: v.numpy() for k, v in pm.training_state_dict().items()})
    m.params = {"generator": randomize(tree["generator"], SEED), "discriminator": randomize(tree["discriminator"], SEED + 1)}
    return m


def port_train_model():
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.models.vits_convert import training_params_from_flax

    m = Vits(port_config(**TRAIN_ARGS), device="cpu")
    m.init_training()
    m.load_training_state(training_params_from_flax(jax_train_model().params, TINY_ARGS[
        "periods_multi_period_discriminator"]), strict=True)
    m.train(True)
    return m


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, T_X), np.int32)
    x[0], x[1, :7] = rng.integers(1, 40, T_X), rng.integers(1, 40, 7)
    spec_lengths = np.array([T_SPEC, 18], np.int32)
    wav = np.zeros((B, T_SPEC * HOP), np.float32)
    for i, n in enumerate(spec_lengths):
        t = np.arange(n * HOP)
        wav[i, : n * HOP] = 0.4 * np.sin(2 * np.pi * (0.03 + 0.01 * i) * t) + 0.05 * rng.standard_normal(n * HOP)
    draws = {"posterior": rng.standard_normal((B, T_SPEC, TINY_ARGS["hidden_channels"])).astype(np.float32),
             "sdp": rng.standard_normal((B, T_X, 2)).astype(np.float32),
             "segments": rng.uniform(size=B).astype(np.float32)}
    jb = {"text_input": x, "text_lengths": np.array([T_X, 7], np.int32), "mel_lengths": spec_lengths,
          "waveform": wav[:, :, None]}
    pb = {"text_input": torch.from_numpy(x).long(), "text_lengths": torch.tensor([T_X, 7]),
          "mel_lengths": torch.from_numpy(spec_lengths).long(), "waveform": torch.from_numpy(wav)[:, None]}
    pd = {"posterior": torch.from_numpy(draws["posterior"]).transpose(1, 2), "sdp": torch.from_numpy(draws["sdp"]).transpose(1, 2),
          "segments": torch.from_numpy(draws["segments"])}
    return jb, pb, draws, pd


def patch_jax_draws(mp, draws):
    """Make JAX's training draws the given numpy arrays while it traces."""
    by_shape = {draws["posterior"].shape: draws["posterior"], draws["sdp"].shape: draws["sdp"]}
    mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(by_shape[tuple(shape)]))
    mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(draws["segments"]))


LAYERS = ("VitsPosteriorEncoder", "ResidualCouplingBlocks", "StochasticDurationPredictor")


@functools.lru_cache(maxsize=None)
def jax_step_refs():
    """`jax.value_and_grad(Vits.loss_fn)` of the D step (0) and the G step (1)
    on `_batch()`, in one program: XLA shares the generator forward both
    run. Each is (loss, (logs, the outputs of LAYERS), grads), the outputs
    of the G step only: returned from the D step too they would keep the
    posterior, flow and SDP, which the D loss does not read, in its program.
    Both halves of the params are arguments, since as constants XLA would
    fold the discriminator into the G step's program."""
    jm = jax_train_model()
    jb, _, draws, _ = _batch()

    def step(params, batch):
        out = []
        for idx, key in ((0, "discriminator"), (1, "generator")):
            def loss_of(sub, idx=idx, key=key):
                seen, intercept = _capture_jax(LAYERS if idx == 1 else ())
                with intercept:
                    loss, logs = jm.loss_fn({**params, key: sub}, batch, jax.random.PRNGKey(0), idx)
                return loss, (logs, seen)

            out.append(jax.value_and_grad(loss_of, has_aux=True)(params[key]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        patch_jax_draws(mp, draws)
        return jax.device_get(jax.jit(step)(jm.params, {k: jnp.asarray(v) for k, v in jb.items()}))


# ----------------------------------------------------------------------- ops
def test_mas_backends_agree_with_jax():
    from tpu_tts.ops.mas import maximum_path_jax

    rng = np.random.default_rng(1)
    value = rng.standard_normal((3, 9, 31)).astype(np.float32)
    mask = np.zeros_like(value)
    for b, (tx, ty) in enumerate([(9, 31), (6, 17), (4, 4)]):
        mask[b, :tx, :ty] = 1
    ref = np.asarray(maximum_path_jax(jnp.asarray(value), jnp.asarray(mask)))
    assert ref.sum() == 31 + 17 + 4  # one cell a frame
    for got in (mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy(),
                mas.maximum_path_torch(torch.from_numpy(value), torch.from_numpy(mask)).numpy(),
                mas.maximum_path_numpy(value, mask)):
        np.testing.assert_array_equal(got, ref)


def test_spectrograms_match_jax():
    from tpu_tts.audio import jax_transforms as jt
    from tpu_tts_torch.audio import torch_transforms as tt

    y = np.random.default_rng(2).standard_normal((2, HOP * 40)).astype(np.float32) * 0.5
    kw = dict(fft_size=64, hop_length=HOP, win_length=64)
    mel_kw = dict(num_mels=20, sample_rate=22050, fmin=0.0, fmax=None)
    spec, mel = jax.jit(lambda y: (jt.wav_to_spec(y, center=False, **kw),
                                   jt.wav_to_mel(y, center=False, **kw, **mel_kw)))(jnp.asarray(y))
    assert max_err(tt.wav_to_spec(torch.from_numpy(y), **kw), spec) <= 1e-5
    assert max_err(tt.wav_to_mel(torch.from_numpy(y), **kw, **mel_kw), mel) <= 1e-5


def test_segments_match_jax():
    from tpu_tts.ops.helpers import rand_segments as jax_rand_segments
    from tpu_tts_torch.ops.helpers import rand_segments

    x = np.random.default_rng(3).standard_normal((3, 4, 20)).astype(np.float32)
    lengths = np.array([20, 9, 3], np.int32)
    u = np.array([0.999, 0.5, 0.3], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(u))
        ref, ref_idx = jax_rand_segments(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths), 8,
                                         let_short_samples=True, pad_short=True)
    got, idx = rand_segments(torch.from_numpy(x), torch.from_numpy(lengths).long(), 8, let_short_samples=True,
                             pad_short=True, u=torch.from_numpy(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -------------------------------------------------------------------- layers
def test_discriminator_matches_jax():
    jm, pm = jax_train_model(), port_train_model()
    y = np.random.default_rng(6).standard_normal((B, 4 * HOP + 5, 1)).astype(np.float32) * 0.5  # not a period multiple
    scores, feats = jax.jit(lambda p, y: jm.disc.apply({"params": p}, y))(jm.params["discriminator"], jnp.asarray(y))
    with torch.no_grad():
        got_scores, got_feats = pm.disc(torch.from_numpy(y).transpose(1, 2))
    assert len(got_scores) == 1 + len(TINY_ARGS["periods_multi_period_discriminator"])
    for r, g in zip(scores, got_scores):
        assert max_err(g, r) <= 1e-5
    for rl, gl in zip(feats, got_feats):
        for r, g in zip(rl, gl):
            g = g.permute(0, 2, 3, 1) if g.ndim == 4 else g.transpose(1, 2)  # NCHW/NCT → the JAX NHWC/NTC
            assert max_err(g, r) <= 1e-5


# ------------------------------------------------------------- one D + G step
def _effective_torch_grads(module):
    """Each parameter's gradient; for a weight-normalised kernel W = g·v/‖v‖
    its `original1` entry is dL/dW = (‖v‖/g)·dL/dv + v̂·dL/dg."""
    out = {}
    for name, p in module.named_parameters():
        out[name] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
    for name, mod in module.named_modules():
        if name.endswith("parametrizations.weight") or name == "parametrizations.weight":
            g, v = mod.original0, mod.original1
            norm = v.detach().flatten(1).norm(dim=1).reshape(g.shape)
            out[f"{name}.original1"] = norm / g.detach() * v.grad + v.detach() / norm * g.grad
    return out


def _effective_jax_tree(params, grads):
    """The JAX gradient tree with each weight-norm pair (v, g) replaced by
    (dL/dW, ‖dL/dW‖), so the bridge's fold gives dL/dW in torch's layout."""
    if not isinstance(grads, dict) and not hasattr(grads, "items"):
        return np.asarray(grads)
    if "v" in grads and "g" in grads:
        v, g = np.asarray(params["v"], np.float64), np.asarray(params["g"], np.float64)
        dv, dg = np.asarray(grads["v"], np.float64), np.asarray(grads["g"], np.float64)
        axes = tuple(range(v.ndim - 1))
        norm = np.sqrt(np.sum(v**2, axis=axes, keepdims=True) + 1e-12)
        eff = norm / g * dv + v / norm * dg
        out = {k: np.asarray(val) for k, val in grads.items() if k not in ("v", "g")}
        out["v"] = eff.astype(np.float32)
        out["g"] = np.sqrt(np.sum(eff**2, axis=axes)).astype(np.float32)
        return out
    return {k: _effective_jax_tree(params[k], grads[k]) for k in grads}


def _compare_grads(got, want, label, rel=1e-3):
    bad, checked = [], 0
    for k, w in want.items():
        if k.endswith("original0"):
            continue  # ‖dL/dW‖ of the fold, not a gradient
        g = got[k].numpy().reshape(w.shape)
        scale = float(np.abs(w.numpy()).max())
        checked += 1
        if not np.abs(g - w.numpy()).max() <= rel * scale + 1e-6:
            bad.append((k, float(np.abs(g - w.numpy()).max()), scale))
    assert checked > 0 and not bad, f"{label}: {bad[:8]}"


def _capture_jax(names):
    """An interceptor recording the outputs of the flax modules whose class
    names are given, while JAX traces."""
    import flax.linen as nn

    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        name = type(context.module).__name__
        if context.method_name == "__call__" and name in names and not kwargs.get("reverse", False):
            seen.setdefault(name, out)
        return out

    return seen, nn.intercept_methods(interceptor)


@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_train_step_losses_and_grads_match_jax(optimizer_idx):
    """One D step (0) or G step (1) of `Vits.loss_fn` against
    `jax.value_and_grad(Vits.loss_fn)`: every loss term and every gradient;
    in the G step also the posterior encoder's, the forward flow's and the
    SDP's outputs."""
    from tpu_tts_torch.models.vits_convert import disc_params_from_flax, params_from_flax

    jm, pm = jax_train_model(), port_train_model()
    _, pb, _, pd = _batch()
    key = "discriminator" if optimizer_idx == 0 else "generator"
    (ref_loss, (ref_logs, ref_seen)), ref_grads = jax_step_refs()[optimizer_idx]
    seen = {}
    hooks = [getattr(pm.net, name).register_forward_hook(lambda mod, a, out, name=name: seen.setdefault(name, out))
             for name in ("posterior_encoder", "flow", "duration_predictor")]
    try:
        loss, logs = pm.loss_fn(pb, optimizer_idx, draws=pd)
    finally:
        for h in hooks:
            h.remove()
    loss.backward()
    for k, v in ref_logs.items():
        assert abs(float(logs[k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), (k, float(logs[k]), float(v))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * max(1.0, abs(float(ref_loss)))

    eff = _effective_jax_tree(jm.params[key], ref_grads)
    if optimizer_idx == 0:
        want = disc_params_from_flax(eff, TINY_ARGS["periods_multi_period_discriminator"])
        _compare_grads(_effective_torch_grads(pm.disc), want, "D")
        assert all(p.grad is None for p in pm.net.parameters())  # the D step leaves G alone
        return
    _compare_grads(_effective_torch_grads(pm.net), params_from_flax(eff), "G")
    assert all(p.grad is None for p in pm.disc.parameters())  # and the G step D
    z, m_q, logs_q, y_mask = (t.detach() for t in seen["posterior_encoder"])
    for r, g in zip(ref_seen["VitsPosteriorEncoder"][:3], (z, m_q, logs_q)):
        assert max_err(g.transpose(1, 2), r) <= 1e-4
    assert max_err(seen["flow"].detach().transpose(1, 2), ref_seen["ResidualCouplingBlocks"]) <= 1e-4
    assert max_err(seen["flow"].detach(), z) > 1e-2  # the flow does work
    nll = ref_seen["StochasticDurationPredictor"]
    assert max_err(seen["duration_predictor"].detach(), nll) <= 1e-4 * max(1.0, float(np.abs(np.asarray(nll)).max()))


# ----------------------------------------------------------------- optimizer
def test_optimizer_matches_optax():
    """AdamW with VITS's settings (betas 0.8/0.99, eps 1e-9, weight decay
    0.01), the exponential schedule with decay_steps 3, clip at 1.0; step 3's
    gradient holds a NaN and must leave everything untouched."""
    import optax

    from tpu_tts.configs.vits_config import VitsConfig as JaxVitsConfig
    from tpu_tts.train.optimizers import get_optimizer as jax_get_optimizer
    from tpu_tts.train.optimizers import get_scheduler as jax_get_scheduler
    from tpu_tts_torch.configs.vits_config import VitsConfig
    from tpu_tts_torch.train.optimizers import get_optimizer, get_scheduler

    sched = ("exponential", {"gamma": 0.5, "decay_steps": 3}, 0.01)
    jcfg, pcfg = JaxVitsConfig(grad_clip=[1.0, 1.0]), VitsConfig(grad_clip=[1.0, 1.0])
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) * s for s in (0.1, 3.0, 0.5, 1.0, 0.2)]
    grads[2][1, 1] = np.nan

    tx = jax_get_optimizer(jcfg.optimizer, jcfg.optimizer_params, None, jcfg, schedule=jax_get_scheduler(*sched),
                           optimizer_idx=1)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    update = jax.jit(tx.update)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = get_optimizer(pcfg.optimizer, pcfg.optimizer_params, [w], pcfg, schedule=get_scheduler(*sched),
                        optimizer_idx=1)
    for i, g in enumerate(grads):
        updates, state = update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g.copy())
        assert opt.step() == (i != 2)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-6, atol=1e-7)
    assert opt.count == 4 and opt.lr() == pytest.approx(0.01 * 0.5 ** (4 / 3))

    # two micro-batches a step, as the JAX trainer's optax.MultiSteps
    tx = optax.MultiSteps(jax_get_optimizer(jcfg.optimizer, jcfg.optimizer_params, None, jcfg,
                                            schedule=jax_get_scheduler(*sched), optimizer_idx=0),
                          every_k_schedule=2).gradient_transformation()
    params = {"w": jnp.asarray(w0)}
    state, update = tx.init(params), jax.jit(tx.update)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = get_optimizer(pcfg.optimizer, pcfg.optimizer_params, [w], pcfg, schedule=get_scheduler(*sched),
                        optimizer_idx=0)
    opt.accum_steps = 2
    for i, g in enumerate([grads[0], grads[1], grads[3], grads[4]]):
        updates, state = update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g.copy()) if w.grad is None else w.grad + torch.from_numpy(g)
        assert opt.step() == (i % 2 == 1)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- generator, MRF guard
def test_train_mode_generator_gradients_equal_autograd_through_mrf_reference():
    """In train() mode every ResBlock1 weight gets its gradient, equal to
    autograd through `mrf_stack_reference` on live (unpacked) weights."""
    from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

    torch.manual_seed(0)
    gen = HifiganGenerator(in_channels=8, upsample_initial_channel=32, upsample_factors=(2, 2),
                           upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
                           resblock_dilation_sizes=((1, 3), (1, 3))).train()
    x = torch.randn(2, 8, 13)
    gen(x).square().mean().backward()
    rb_params = [p for rb in gen.resblocks for p in rb.parameters()]
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0 for p in rb_params)
    got = [p.grad.clone() for p in rb_params]
    gen.zero_grad()

    def plain_stage(o, i):
        blocks = gen.resblocks[i * gen.num_kernels: (i + 1) * gen.num_kernels]
        stage = hifigan_mrf.MrfStage([[hifigan_mrf.MrfUnit(w1, b1, w2, b2, w1.shape[-1], d, *(None,) * 4)
                                       for w1, b1, w2, b2, d in rb.units()] for rb in blocks])
        return hifigan_mrf.mrf_stack_reference(o, stage)

    o = gen.conv_pre(x)
    for i in range(gen.num_upsamples):
        o = plain_stage(gen.ups[i](torch.nn.functional.leaky_relu(o, 0.1)), i)
    torch.tanh(gen.conv_post(torch.nn.functional.leaky_relu(o, 0.01))).square().mean().backward()
    for a, p in zip(got, rb_params):
        assert float((a - p.grad).abs().max()) <= 1e-6 * max(1.0, float(a.abs().max()))


def test_mrf_stack_refuses_a_gradient():
    """The packed MRF has no backward: asked for one it raises, on x or on
    the stage's source parameters; under no_grad it runs."""
    from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

    gen = HifiganGenerator(in_channels=8, upsample_initial_channel=32, upsample_factors=(2, 2),
                           upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1,),)).eval()
    x = torch.randn(1, 8, 5)
    with pytest.raises(RuntimeError, match="no backward"):
        gen(x)  # eval() mode, parameters requiring grad: the packed route
    with pytest.raises(RuntimeError, match="no backward"):
        hifigan_mrf.mrf_stack(torch.randn(1, 16, 9, requires_grad=True), gen.mrf_stage(0))
    with torch.no_grad():
        assert gen(x).shape == (1, 1, 20)


# --------------------------------------------------------------------- CLI
def _cli_config(out_dir):
    from tpu_tts_torch.config.shared_configs import BaseDatasetConfig
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig

    args = VitsArgs(num_chars=0, out_channels=129, spec_segment_size=8, hidden_channels=16,
                    hidden_channels_ffn_text_encoder=16, num_heads_text_encoder=2, num_layers_text_encoder=1,
                    num_layers_posterior_encoder=1, num_layers_flow=1, upsample_rates_decoder=[8, 8],
                    upsample_kernel_sizes_decoder=[16, 16], upsample_initial_channel_decoder=32,
                    resblock_kernel_sizes_decoder=[3], resblock_dilation_sizes_decoder=[[1]],
                    periods_multi_period_discriminator=[2])
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ljspeech")
    cfg = VitsConfig(model_args=args, audio=VitsAudioConfig(fft_size=256, win_length=256, hop_length=64, num_mels=20),
                     batch_size=2, eval_batch_size=2, text_cleaner="english_cleaners", use_phonemes=False, epochs=1,
                     print_step=1, save_step=10000, output_path=out_dir, eval_split_size=0.25, run_eval=True,
                     test_delay_epochs=-1,
                     datasets=[BaseDatasetConfig(formatter="ljspeech", meta_file_train="metadata.csv", path=fixture,
                                                 dataset_name="fix")])
    return cfg


def test_train_tts_cli_continue_and_synthesize(tmp_path):
    """`bin/train_tts` trains one epoch on the fixture (`--small_run 2`: one
    step of 2 clips, then the eval), `--continue_path` resumes it for a
    second (restoring weights, `disc.*` included, strictly), and the newest
    checkpoint serves through the port's `Synthesizer`."""
    from tpu_tts_torch.bin.train_tts import main as train_main
    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.train.checkpoint import get_last_checkpoint, load_checkpoint

    out = str(tmp_path / "run")
    cfg = _cli_config(out)
    cfg_path = str(tmp_path / "config.json")
    cfg.save_json(cfg_path)
    train_main(["--config_path", cfg_path, "--device", "cpu", "--small_run", "2"])
    first, _ = get_last_checkpoint(out)
    state = load_checkpoint(first)
    assert state["epoch"] == 1 and state["step"] == 1
    assert any(k.startswith("disc.nets.1.") for k in state["model"])

    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    saved["epochs"] = 2
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(saved, f)
    train_main(["--continue_path", out, "--device", "cpu", "--small_run", "2"])
    last, best = get_last_checkpoint(out)
    resumed = load_checkpoint(last)
    assert resumed["step"] == 2 and resumed["epoch"] == 2 and os.path.exists(best)
    assert len(glob.glob(os.path.join(out, "best_model_*.pth"))) == 1

    synth = Synthesizer(last, os.path.join(out, "config.json"), device="cpu")
    wav = np.asarray(synth.tts("a stitch in time saves nine."))
    assert wav.size > 1000 and np.isfinite(wav).all()


def test_coqui_pth_round_trip_gives_equal_losses(tmp_path):
    """The port's trained state as a Coqui-format `.pth` (`{"model": ...}`
    with `disc.*`, the generator's weight norm as `weight_g`/`weight_v`),
    reloaded strictly into a fresh model: the same D and G losses."""
    from tpu_tts_torch.models.vits import Vits

    pm = port_train_model()
    sd = {}
    for k, v in pm.training_state_dict().items():
        k = k.replace(".parametrizations.weight.original0", ".weight_g").replace(
            ".parametrizations.weight.original1", ".weight_v") if not k.startswith("disc.") else k
        sd[k] = v.clone()
    path = str(tmp_path / "coqui.pth")
    torch.save({"model": sd, "optimizer": [{}, {}], "step": 7, "epoch": 1}, path)
    other = Vits(port_config(**TRAIN_ARGS), device="cpu")
    other.init_training()
    other.load_training_state(torch.load(path)["model"], strict=True)
    other.train(True)
    _, pb, _, pd = _batch(9)
    for idx in (0, 1):
        with torch.no_grad():
            a, b = pm.loss_fn(pb, idx, draws=pd)[0], other.loss_fn(pb, idx, draws=pd)[0]
        assert float(a) == float(b)
