"""The port's M6 leftovers against `tpu_tts` on the CPU: mixed precision,
`encoder_sample_rate` training, `radam`/`rmsprop` and the dashboard logger.

Tolerances:
- one D step and one G step of a tiny VITS at mixed precision (bfloat16
  compute on float32 parameters, VITS's own route) against JAX's, compiled
  so that every bfloat16 op rounds: every loss within 2e-2 relative; the
  gradients by `_check_bf16_grads` (each tensor's direction, and the L2
  distance from the float32 gradient: JAX's bfloat16 gradients themselves
  stray up to 30 % of a tensor's max from float32 at these widths, so a
  per-tensor bound of 5e-2 of max cannot hold); the dtype of each named
  module's output equal to JAX's; the parameters and optimizer state
  float32 after a step. The MAS path of the port's forward is compared
  with JAX's: where bfloat16 rounding flips a near-tie, the flipped cells
  are reported and the losses compared on JAX's path;
- the tiny XTTS fine-tuning loss through the trainer's generic cast (its
  forward runs in float32 on bfloat16-rounded weights, as JAX's type
  promotion gives it) against JAX's `autocast_args`: losses within 2e-2
  relative, every gradient within 5e-2 of its tensor's max, the DVAE's
  codes counted;
- one D and one G step with `encoder_sample_rate` (float32): losses within
  1e-5 relative, gradients within 1e-3 of max;
- the antialiased resize within 1e-6 of `jax.image.resize`;
- `radam` and `rmsprop` within 1e-6 relative of optax over 20 steps.
Dropout is 0 and the draws are JAX's (`tests/test_torch_port_train.py`).
"""

import functools
import glob
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import (
    HOP,
    TRAIN_ARGS,
    _compare_grads,
    _effective_jax_tree,
    _effective_torch_grads,
    patch_jax_draws,
)
from tests.torch_port_common import (SEED, TINY_ARGS, TINY_AUDIO, CompiledAhead, cached_flax_shape_check, max_err,
                                     port_config, randomize, session_runs)

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

# no SDP (its splines cost the JAX trace seconds), one resblock unit
MP_ARGS = dict(TRAIN_ARGS, use_sdp=False, resblock_dilation_sizes_decoder=[[1]])
B, T_X = 2, 11


def _configs(mixed: bool, **overrides):
    from tpu_tts.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig

    args = {**MP_ARGS, **overrides}
    jcfg = VitsConfig(model_args=VitsArgs(**{**TINY_ARGS, **args}), audio=VitsAudioConfig(**TINY_AUDIO),
                      mixed_precision=mixed)
    pcfg = port_config(**args)
    pcfg.mixed_precision = mixed
    return jcfg, pcfg


def _port(mixed: bool, encoder_rate: bool):
    from tpu_tts_torch.models.vits import Vits

    pm = Vits(_configs(mixed, **(dict(encoder_sample_rate=11025) if encoder_rate else {}))[1], device="cpu")
    pm.init_training()
    return pm


@functools.lru_cache(maxsize=None)
def jax_model(mixed: bool, encoder_rate: bool = False):
    """The JAX `Vits` with a seeded tree, whose layout comes from the JAX
    converter applied to the port's state dict."""
    from tpu_tts.models.vits import Vits
    from tpu_tts.models.vits_convert import convert_vits_torch_state_dict

    jm = Vits(_configs(mixed, **(dict(encoder_sample_rate=11025) if encoder_rate else {}))[0])
    tree = convert_vits_torch_state_dict({k: v.numpy() for k, v in _port(mixed, encoder_rate).training_state_dict()
                                          .items()})
    jm.params = {"generator": randomize(tree["generator"], SEED), "discriminator": randomize(tree["discriminator"],
                                                                                          SEED + 1)}
    return jm


def models(mixed: bool, encoder_rate: bool = False):
    """(the cached JAX `Vits`, a fresh port `Vits` on its weights, in train mode)."""
    from tpu_tts_torch.models.vits_convert import training_params_from_flax

    jm, pm = jax_model(mixed, encoder_rate), _port(mixed, encoder_rate)
    pm.load_training_state(training_params_from_flax(jm.params, TINY_ARGS["periods_multi_period_discriminator"]))
    pm.train(True)
    return jm, pm


def _batch(t_spec: int, draw_frames: int):
    """A seeded batch (lengths t_spec and 3/4 of it) and JAX's draws, the
    posterior's over `draw_frames` frames."""
    rng = np.random.default_rng(0)
    x = np.zeros((B, T_X), np.int32)
    x[0], x[1, :7] = rng.integers(1, 40, T_X), rng.integers(1, 40, 7)
    spec_lengths = np.array([t_spec, 3 * t_spec // 4], np.int32)
    wav = np.zeros((B, t_spec * HOP), np.float32)
    for i, n in enumerate(spec_lengths):
        t = np.arange(n * HOP)
        wav[i, : n * HOP] = 0.4 * np.sin(2 * np.pi * (0.03 + 0.01 * i) * t) + 0.05 * rng.standard_normal(n * HOP)
    draws = {"posterior": rng.standard_normal((B, draw_frames, TINY_ARGS["hidden_channels"])).astype(np.float32),
             "sdp": rng.standard_normal((B, T_X, 2)).astype(np.float32),
             "segments": rng.uniform(size=B).astype(np.float32)}
    jb = {"text_input": x, "text_lengths": np.array([T_X, 7], np.int32), "mel_lengths": spec_lengths,
          "waveform": wav[:, :, None]}
    pb = {"text_input": torch.from_numpy(x).long(), "text_lengths": torch.tensor([T_X, 7]),
          "mel_lengths": torch.from_numpy(spec_lengths).long(), "waveform": torch.from_numpy(wav)[:, None]}
    pd = {"posterior": torch.from_numpy(draws["posterior"]).transpose(1, 2),
          "segments": torch.from_numpy(draws["segments"])}
    return jb, pb, draws, pd


# flax class → the port's module (on the `Vits`) whose output dtype must match
DTYPE_MODULES = {
    "VitsTextEncoder": lambda m: m.net.text_encoder,
    "VitsPosteriorEncoder": lambda m: m.net.posterior_encoder,
    "WN": lambda m: m.net.posterior_encoder.enc,
    "ResidualCouplingBlocks": lambda m: m.net.flow,
    "DurationPredictor": lambda m: m.net.duration_predictor,
    "WNConvTranspose1d": lambda m: m.net.waveform_decoder.ups[0],
    "ResBlock1": lambda m: m.net.waveform_decoder.resblocks[0],
    "HifiganGenerator": lambda m: m.net.waveform_decoder,
    "DiscriminatorS": lambda m: m.disc.nets[0],
}


def _first_leaf(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


@functools.lru_cache(maxsize=None)
def jax_program(mixed: bool, encoder_rate: bool = False):
    """`jax.value_and_grad(Vits.loss_fn)` of the D step (0) and the G step
    (1) in one program, the G step with the alignment of its forward (the D
    step's forward, on the same weights and draws, is the same; returned
    from the D step it would keep MAS and the flow, which the D loss does
    not read, in its program), traced now and compiled ahead; and the
    output dtype of each module of DTYPE_MODULES while it traced."""
    import flax.linen as nn

    jm = jax_model(mixed, encoder_rate)
    jb, _, draws, _ = _batch(*((48, 24) if encoder_rate else (24, 24)))
    dtypes = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        name = type(context.module).__name__
        if context.method_name == "__call__" and name in DTYPE_MODULES and not kwargs.get("reverse", False):
            dtypes.setdefault(name, str(_first_leaf(out).dtype))
        if context.method_name == "__call__" and name == "VitsNet":
            seen["attn"] = out["alignments"]
        return out

    seen = {}

    def step(params, batch):
        out = []
        for idx, key in ((0, "discriminator"), (1, "generator")):
            def loss_of(sub, idx=idx, key=key):
                with nn.intercept_methods(interceptor):
                    loss, logs = jm.loss_fn({**params, key: sub}, batch, jax.random.PRNGKey(0), idx)
                return loss, (logs, seen["attn"] if idx == 1 else None)

            out.append(jax.value_and_grad(loss_of, has_aux=True)(params[key]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        patch_jax_draws(mp, draws)
        args = (jm.params, {k: jnp.asarray(v) for k, v in jb.items()})
        # every bfloat16 op rounds, as on an accelerator and in the port; XLA:CPU
        # otherwise keeps float32 between fused bfloat16 ops
        program = CompiledAhead(step, *args, compiler_options={"xla_allow_excess_precision": False})
    return program, dtypes


def jax_refs(mixed: bool, encoder_rate: bool = False):
    program, dtypes = jax_program(mixed, encoder_rate)
    return program.result(), dtypes


def _run_port(pm, pb, pd, idx, forced_attn=None):
    """The port's (loss, logs, alignment `[B, T_de, T_en]`, output dtypes),
    its gradients left on the parameters; with `forced_attn` (JAX's) MAS
    returns that path."""
    import tpu_tts_torch.models.vits as vits_mod

    dtypes, seen = {}, {}

    def hook(name):
        def record(mod, args, out):
            dtypes.setdefault(name, str(_first_leaf(out).dtype).replace("torch.", ""))
        return record

    def record_attn(mod, args, out):
        seen.setdefault("attn", out["alignments"])

    hooks = [get(pm).register_forward_hook(hook(name)) for name, get in DTYPE_MODULES.items()]
    hooks.append(pm.net.register_forward_hook(record_attn))
    for p in list(pm.net.parameters()) + list(pm.disc.parameters()):
        p.grad = None
    try:
        with pytest.MonkeyPatch.context() as mp:
            if forced_attn is not None:
                mp.setattr(vits_mod, "maximum_path",
                           lambda value, mask: torch.from_numpy(np.swapaxes(forced_attn, 1, 2).copy()))
            loss, logs = pm.loss_fn(pb, idx, draws=pd)
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    return loss, logs, seen["attn"].detach().numpy(), dtypes


def _check_bf16_grads(got, want, exact, label):
    """bfloat16 gradients against JAX's: every tensor whose exact gradient
    is not ~0 points the same way as JAX's (cosine ≥ 0.95), and the port's
    distance from the exact gradient (its float32 step on the same weights,
    equal to JAX's float32 step within 1e-3 of max,
    `tests/test_torch_port_train.py`) is at most twice JAX's plus 5 % (L2
    over all gradients). At these widths both packages' bfloat16 gradients
    stray from the float32 ones by up to 30 % of a tensor's max: the noise of
    8-bit mantissas through a GAN step, which a per-tensor bound cannot
    separate from a fault."""
    keys = [k for k in want if not k.endswith("original0")]
    flat = {name: {k: d[k].numpy().reshape(-1).astype(np.float64) for k in keys}
            for name, d in (("port", got), ("jax", want), ("exact", exact))}
    bad = []
    for k in keys:
        p, j, e = (flat[n][k] for n in ("port", "jax", "exact"))
        if np.abs(e).max() > 1e-3 and not p @ j >= 0.95 * np.linalg.norm(p) * np.linalg.norm(j):
            bad.append((k, float(p @ j / (np.linalg.norm(p) * np.linalg.norm(j)))))
    assert not bad, f"{label} cosine: {bad[:8]}"
    vec = {n: np.concatenate([flat[n][k] for k in keys]) for n in flat}
    err_port = np.linalg.norm(vec["port"] - vec["exact"])
    err_jax = np.linalg.norm(vec["jax"] - vec["exact"])
    print(f" > {label}: bfloat16 gradients' L2 distance from float32, relative: port {err_port / np.linalg.norm(vec['exact']):.4f}, "
          f"JAX {err_jax / np.linalg.norm(vec['exact']):.4f}; port to JAX "
          f"{np.linalg.norm(vec['port'] - vec['jax']) / np.linalg.norm(vec['jax']):.4f}")
    assert err_port <= 2 * err_jax + 5e-2 * np.linalg.norm(vec["exact"])


def _step_against_jax(optimizer_idx, mixed, encoder_rate, loss_tol, grad_tol):
    """One port step against JAX's: losses within `loss_tol` relative; in
    float32 each gradient within `grad_tol` of its tensor's max, at mixed
    precision `_check_bf16_grads`."""
    from tpu_tts_torch.layers.common import set_compute_dtype
    from tpu_tts_torch.models.vits_convert import disc_params_from_flax, params_from_flax

    jm, pm = models(mixed, encoder_rate)
    _, pb, _, pd = _batch(*((48, 24) if encoder_rate else (24, 24)))
    refs, jax_dtypes = jax_refs(mixed, encoder_rate)
    (ref_loss, (ref_logs, _)), ref_grads = refs[optimizer_idx]
    ref_attn = refs[1][0][1][1]  # the G step's alignment: the D step's forward is the same
    loss, logs, attn, dtypes = _run_port(pm, pb, pd, optimizer_idx)
    forced = None
    flipped = np.argwhere(attn != ref_attn)
    if len(flipped):  # a bfloat16 near-tie went the other way: compare on JAX's path
        print(f" > MAS: {len(flipped)} of {attn.size} cells differ from JAX's path (b, frame, token): "
              f"{flipped[:8].tolist()}")
        forced = ref_attn
        loss, logs, attn, dtypes = _run_port(pm, pb, pd, optimizer_idx, forced_attn=forced)
    for k, v in ref_logs.items():
        assert abs(float(logs[k]) - float(v)) <= loss_tol * max(1.0, abs(float(v))), (k, float(logs[k]), float(v))
    assert abs(float(loss) - float(ref_loss)) <= loss_tol * max(1.0, abs(float(ref_loss)))
    part = pm.disc if optimizer_idx == 0 else pm.net
    got = _effective_torch_grads(part)
    exact = None
    if mixed:
        for module in (pm.net, pm.disc):
            set_compute_dtype(module, None)
        _run_port(pm, pb, pd, optimizer_idx, forced_attn=forced)
        exact = _effective_torch_grads(part)
    key = "discriminator" if optimizer_idx == 0 else "generator"
    eff = _effective_jax_tree(jm.params[key], ref_grads)
    if optimizer_idx == 0:
        want = disc_params_from_flax(eff, TINY_ARGS["periods_multi_period_discriminator"])
    else:
        want = params_from_flax(eff)
    label = "D" if optimizer_idx == 0 else "G"
    if mixed:
        _check_bf16_grads(got, want, exact, label)
    else:
        _compare_grads(got, want, label, grad_tol)
    return dtypes, jax_dtypes, pm


@pytest.mark.parametrize("n, m", [(4410, 2205), (22050, 16000)])
def test_resize_matches_jax_image_resize(n, m):
    from tpu_tts_torch.audio.torch_transforms import resize_linear

    y = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(y), (2, m), method="linear")
    assert max_err(resize_linear(torch.from_numpy(y), m), ref) <= 1e-6


@functools.lru_cache(maxsize=None)
def jax_xtts_program():
    """The tiny XTTS loss and gradients through the raw wavs under
    `tpu_tts`'s `autocast_args`, with the DVAE's codes, compiled ahead."""
    from tests.test_torch_port_xtts_train import _batch as xtts_batch
    from tests.test_torch_port_xtts_train import models as xtts_models
    from tpu_tts.train.precision import autocast_args as jax_autocast

    jm, _ = xtts_models()

    def ref(params, batch):
        def loss_of(p):
            p16, b16 = jax_autocast(p, batch)
            loss, logs = jm.loss_fn(p16, b16, jax.random.PRNGKey(0))
            codes = jm.dvae.apply({"params": jm.dvae_params}, jm._dvae_mel(b16["wav"]),
                                  method=type(jm.dvae).get_codebook_indices)
            return loss.astype(jnp.float32), (logs, codes)

        return jax.value_and_grad(loss_of, has_aux=True)(params)

    return CompiledAhead(ref, jm.params, {k: jnp.asarray(v) for k, v in xtts_batch().items()})


@pytest.fixture(scope="module", autouse=True)
def _compile_ahead(request, cached_flax_shape_check):
    """The module's three JAX programs traced before its first test; XLA
    compiles each while the next traces and the tests before them (last in
    the module) run."""
    if session_runs(request, "test_mixed_precision_step"):
        jax_program(True)
    if session_runs(request, "test_encoder_sample_rate_step"):
        jax_program(False, True)
    if session_runs(request, "test_mixed_precision_xtts_loss"):
        jax_xtts_program()


@pytest.mark.parametrize("name, params", [("radam", {}), ("radam", {"weight_decay": 0.01}), ("rmsprop", {}),
                                          ("rmsprop", {"alpha": 0.95, "eps": 1e-6})])
def test_radam_rmsprop_match_optax(name, params):
    """20 updates on a flat vector, through rho_t's threshold at step 6 for
    radam (betas 0.9/0.999), gradients shrinking to 1e-4 with exact zeros
    and 1e-9s: the port's `get_optimizer` against the JAX package's (jitted,
    as its trainer runs it)."""
    import optax

    from tpu_tts.train.optimizers import get_optimizer as jax_get_optimizer
    from tpu_tts_torch.train.optimizers import get_optimizer

    rng = np.random.default_rng(7)
    w0 = rng.standard_normal(64).astype(np.float32)
    grads = [(rng.standard_normal(64) * s).astype(np.float32) for s in np.geomspace(1, 1e-4, 20)]
    grads[7][:10], grads[8][:5] = 0.0, 1e-9
    tx = jax_get_optimizer(name, dict(params), 1e-2)
    update = jax.jit(tx.update)
    state, w = tx.init(jnp.asarray(w0)), jnp.asarray(w0)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = get_optimizer(name, dict(params), [p], lr=1e-2)
    for g in grads:
        u, state = update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, u)
        p.grad = torch.from_numpy(g.copy())
        assert opt.step()
        assert max_err(p, w) <= 1e-6 * float(np.abs(np.asarray(w)).max())
    assert max_err(p, w0) > 1e-2


def _event_tags(logdir):
    """The scalar tags of the TFRecord event files under `logdir`."""
    from tensorboardX.proto import event_pb2

    tags = set()
    for path in glob.glob(os.path.join(logdir, "events.out.tfevents.*")):
        data = open(path, "rb").read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i : i + 8])
            ev = event_pb2.Event.FromString(data[i + 12 : i + 12 + n])
            tags.update(v.tag for v in ev.summary.value)
            i += 12 + n + 4
    return tags


def test_dashboard_logger_writes_events(tmp_path):
    """`Trainer.fit` on a one-parameter model with eval data: the event file
    under `<run>/logs` holds every step's `train/*` scalars and `eval/loss`;
    with another `dashboard_logger` nothing is written."""
    from tpu_tts_torch.config.shared_configs import BaseTrainingConfig
    from tpu_tts_torch.train import Trainer, TrainerArgs
    from tpu_tts_torch.train.optimizers import get_optimizer

    class Loader(list):
        def set_epoch(self, epoch):
            pass

    class Line:
        device = torch.device("cpu")

        def __init__(self):
            self.w = torch.nn.Parameter(torch.zeros(1))

        def init_training(self):
            pass

        def num_optimizers(self):
            return 1

        def optimizer_params(self, idx=0):
            return [self.w]

        def get_optimizer(self):
            return [get_optimizer("sgd", {}, [self.w], lr=0.1)]

        def loss_fn(self, batch, idx, generator=None):
            loss = torch.mean((self.w * batch["x"] - batch["y"]) ** 2)
            return loss, {"loss_line": loss}

        def get_data_loader(self, config, assets, is_eval, samples, verbose=False):
            x = torch.arange(4.0)
            return Loader([{"x": x, "y": 2 * x}] * len(samples))

        def train(self, mode=True):
            pass

        def training_state_dict(self):
            return {"w": self.w}

        def load_training_state(self, state, strict=True):
            self.w.data.copy_(state["w"])

    for logger in ("tensorboard", "wandb"):
        cfg = BaseTrainingConfig(epochs=1, print_step=1, save_step=0, dashboard_logger=logger)
        out = str(tmp_path / logger)
        Trainer(TrainerArgs(device="cpu"), cfg, out, model=Line(), train_samples=[0, 1, 2],
                eval_samples=[0]).fit()
        tags = _event_tags(os.path.join(out, "logs"))
        if logger == "tensorboard":
            assert {"train/loss", "train/loss_line", "eval/loss"} <= tags
        else:
            assert not os.path.exists(os.path.join(out, "logs"))


@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_mixed_precision_step_matches_jax(optimizer_idx):
    """A D step (0) or G step (1) at mixed precision: losses, gradients and
    the dtype map against JAX; then a trainer update keeps every parameter
    and optimizer moment float32."""
    dtypes, jax_dtypes, pm = _step_against_jax(optimizer_idx, True, False, 2e-2, None)
    want = {"VitsTextEncoder": "float32", "VitsPosteriorEncoder": "float32", "WN": "float32",
            "ResidualCouplingBlocks": "float32", "DurationPredictor": "float32", "WNConvTranspose1d": "bfloat16",
            "ResBlock1": "bfloat16", "HifiganGenerator": "float32", "DiscriminatorS": "bfloat16"}
    assert jax_dtypes == want
    assert dtypes == want
    opt = pm.get_optimizer()[optimizer_idx]
    opt.step()
    assert opt.count == 1
    params = list(pm.disc.parameters() if optimizer_idx == 0 else pm.net.parameters())
    assert {p.dtype for p in params} == {torch.float32}
    assert {v.dtype for st in opt.inner.state.values() for v in st.values() if torch.is_tensor(v)} == {torch.float32}


@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_encoder_sample_rate_step_matches_jax(optimizer_idx):
    """`encoder_sample_rate` half the output rate, float32: the posterior
    reads the resized waveform, the decoder the upsampled z at ×2 offsets."""
    _step_against_jax(optimizer_idx, False, True, 1e-5, 1e-3)


def test_mixed_precision_xtts_loss_matches_jax():
    """The tiny XTTS fine-tuning loss through the raw wavs under the
    trainer's generic cast (its net's parameters and the batch in bfloat16,
    the DVAE float32 outside it) against `tpu_tts`'s `autocast_args`."""
    from tests.test_torch_port_xtts_train import _batch as xtts_batch
    from tests.test_torch_port_xtts_train import models as xtts_models
    from tpu_tts_torch.models.xtts_convert import params_from_flax
    from tpu_tts_torch.train import precision

    jm, pm = xtts_models()
    raw = xtts_batch()
    (ref_loss, (ref_logs, ref_codes)), ref_grads = jax_xtts_program().result()
    pb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in raw.items()}
    net = pm.net
    net.zero_grad(set_to_none=True)
    pm.train(True)
    params16, batch16 = precision.autocast_args(dict(net.named_parameters()), pb)
    loss, logs = precision.call_cast(net, params16, pm.loss_fn, batch16, 0)
    loss.float().backward()
    pm.train(False)
    codes = pm.dvae.get_codebook_indices(pm._dvae_mel(batch16["wav"]))
    n_diff = int((codes.numpy() != ref_codes).sum())
    print(f" > DVAE codes on the bfloat16 waveform: {n_diff} of {codes.numel()} differ from JAX's")
    assert n_diff == 0
    for k in ("loss_text_ce", "loss_mel_ce"):
        assert abs(float(logs[k]) - float(ref_logs[k])) <= 2e-2 * max(1.0, abs(float(ref_logs[k]))), k
    assert abs(float(loss) - float(ref_loss)) <= 2e-2 * max(1.0, abs(float(ref_loss)))
    want = params_from_flax({k: v for k, v in ref_grads.items() if k not in ("hifigan_decoder", "speaker_proj")})
    got = dict(net.named_parameters())
    assert all(got[k].dtype == torch.float32 for k in want)
    _compare_grads({k: got[k].grad for k in want}, want, "XTTS", 5e-2)
