"""Shared set-up of the `test_torch_port_*` files: a tiny VITS and a tiny
WaveRNN built on both sides, the JAX params drawn from a numpy seed and
carried into the port through `params_from_flax`."""

import concurrent.futures
import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TINY_ARGS = dict(
    num_chars=40,
    hidden_channels=32,
    hidden_channels_ffn_text_encoder=48,
    num_heads_text_encoder=2,
    num_layers_text_encoder=2,
    num_layers_flow=2,
    # training-only parts the JAX param tree still holds: kept small
    out_channels=33,
    num_layers_posterior_encoder=1,
    spec_segment_size=4,
    upsample_rates_decoder=[4, 4],
    upsample_kernel_sizes_decoder=[8, 8],
    upsample_initial_channel_decoder=32,
    resblock_kernel_sizes_decoder=[3, 7],
    resblock_dilation_sizes_decoder=[[1, 3], [1, 3]],
    periods_multi_period_discriminator=[2],
    inference_noise_scale=0.0,
    inference_noise_scale_dp=0.0,
)
TINY_AUDIO = dict(fft_size=64, win_length=64, hop_length=16, num_mels=20)
SEED = 3


def randomize(tree, seed: int):
    """Every leaf of a param tree (arrays or shapes) drawn from a numpy seed:
    weight-norm `g` and layer-norm `gamma` ≈ 1 ± 0.1, everything else
    ~N(0, 0.1²). This makes the zero-initialised coupling `post` and spline
    `proj` layers do real work."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = tuple(leaf.shape)
        if path[-1].key in ("g", "gamma"):
            return (1.0 + 0.1 * rng.uniform(-1, 1, shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


_INIT_SHAPES = {}


def _shape_key(obj, depth: int = 0):
    """What decides the shapes an initializer gives: plain values as they
    are, arrays and tracers by shape and dtype, a function by its code, its
    defaults and what its closure holds, a partial by its parts. Raises
    TypeError for anything else."""
    if depth > 8:
        raise TypeError("too deep")
    if obj is None or isinstance(obj, (bool, int, float, str, bytes, type, np.dtype)):
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj).__name__, tuple(_shape_key(x, depth + 1) for x in obj)
    if isinstance(obj, dict):
        return "dict", tuple(sorted((k, _shape_key(v, depth + 1)) for k, v in obj.items()))
    if isinstance(obj, (np.ndarray, jax.Array, jax.core.Tracer, jax.ShapeDtypeStruct)):
        return "array", tuple(obj.shape), str(obj.dtype)
    if isinstance(obj, functools.partial):
        return "partial", _shape_key(obj.func, depth + 1), _shape_key(obj.args, depth + 1), \
            _shape_key(obj.keywords, depth + 1)
    if isinstance(obj, types.FunctionType):
        cells = tuple(_shape_key(c.cell_contents, depth + 1) for c in obj.__closure__ or ())
        return "function", obj.__code__, _shape_key(obj.__defaults__, depth + 1), \
            _shape_key(obj.__kwdefaults__, depth + 1), cells
    if callable(obj):
        hash(obj)
        return "callable", obj
    raise TypeError(type(obj).__name__)


def _init_shapes(init_fn, args, kwargs):
    """The shapes `init_fn(key, *args, **kwargs)` gives, as flax's
    `Scope.param` derives them to check a given parameter, remembered by
    `_shape_key` of the initializer and its arguments (what an
    initializer's output shape can depend on); anything else is derived
    anew each time, as flax does."""
    def derive():
        out = jax.eval_shape(lambda: init_fn(jax.random.key(0), *args, **kwargs))
        return [np.shape(leaf) for leaf in jax.tree_util.tree_leaves(out)]

    try:
        key = _shape_key((init_fn, args, kwargs))
        hash(key)
    except (TypeError, ValueError):  # ValueError: an empty closure cell
        return derive()
    if key not in _INIT_SHAPES:
        _INIT_SHAPES[key] = derive()
    return _INIT_SHAPES[key]


def cache_flax_param_shape_check(mp):
    """While JAX traces a reference, flax's `Scope.param` still checks every
    given parameter's shape against its initializer's, and raises the same
    `ScopeParamShapeError` on a mismatch, but derives each initializer's
    shapes once per process instead of once per parameter and trace (one
    `jax.eval_shape` each, a large share of a trace's seconds)."""
    import flax.core.scope as scope

    orig = scope.Scope.param

    def param(self, name, init_fn, *args, unbox=True, **kwargs):
        if not self.has_variable("params", name):
            return orig(self, name, init_fn, *args, unbox=unbox, **kwargs)
        self.reserve(name, "params")
        value = self.get_variable("params", name)
        if unbox:
            value = scope.meta.unbox(value)
        for val, want in zip(jax.tree_util.tree_leaves(value), _init_shapes(init_fn, args, kwargs)):
            if np.shape(val) != want:
                raise scope.errors.ScopeParamShapeError(name, self.path_text, np.shape(val), want)
        return value

    mp.setattr(scope.Scope, "param", param)


@pytest.fixture(scope="module")
def cached_flax_shape_check():
    """`cache_flax_param_shape_check` for every test of a module (set with
    `pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")`, the
    fixture imported), undone when the module's tests end."""
    with pytest.MonkeyPatch.context() as mp:
        cache_flax_param_shape_check(mp)
        yield


_XLA_COMPILES = concurrent.futures.ThreadPoolExecutor(max_workers=2, thread_name_prefix="xla-compile")


class CompiledAhead:
    """A JAX reference program traced and lowered now, on the calling thread
    (where the caller's patches of the JAX package apply), and compiled by
    XLA on a worker thread: XLA's compile holds no GIL, so the tests that run
    meanwhile overlap it. `result()` waits for the executable, runs it once
    on `args` inside `context` (`jax.enable_x64` for a float64 program, whose
    inputs must not be cast down) and keeps its outputs as numpy. The
    program, its inputs and its outputs are those of `jax.jit(fn)(*args)`."""

    def __init__(self, fn, *args, context=contextlib.nullcontext, compiler_options=None):
        self._args = args
        self._context = context
        lowered = jax.jit(fn).lower(*args)
        self._compiled = _XLA_COMPILES.submit(lambda: lowered.compile(compiler_options=compiler_options))
        self._out = None

    def result(self):
        if self._out is None:
            with self._context():
                self._out = jax.device_get(self._compiled.result()(*self._args))
        return self._out


def session_runs(request, *prefixes) -> bool:
    """Whether the session runs a test of the requesting module whose name
    starts with one of `prefixes` (so that a module fixture compiles ahead
    only what a `-k` selection reads)."""
    return any(item.module is request.module and item.name.startswith(prefixes) for item in request.session.items)


def flax_param_shapes(module, *args, **kwargs):
    """The param tree of a flax module, as shapes, without running it."""
    rngs = dict(zip(("params", "posterior", "segments", "sdp", "dropout"), jax.random.split(jax.random.PRNGKey(0), 5)))
    return jax.eval_shape(lambda: module.init(rngs, *args, **kwargs))["params"]


def jax_config():
    from tpu_tts.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig

    return VitsConfig(model_args=VitsArgs(**TINY_ARGS), audio=VitsAudioConfig(**TINY_AUDIO))


def port_config(**overrides):
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig

    return VitsConfig(model_args=VitsArgs(**{**TINY_ARGS, **overrides}), audio=VitsAudioConfig(**TINY_AUDIO))


@functools.lru_cache(maxsize=None)
def jax_model():
    """The tiny JAX `Vits` with seeded random generator params (built once
    per process). The tree's layout comes from the JAX package's Coqui
    converter applied to the port's training state dict: the same paths and
    shapes as a flax trace of the training forward (so the same draws), in
    a fraction of the trace's seconds."""
    from tpu_tts.models.vits import Vits
    from tpu_tts.models.vits_convert import convert_vits_torch_state_dict
    from tpu_tts_torch.models.vits import Vits as PortVits

    model = Vits(jax_config())
    pm = PortVits(port_config(), device="cpu")
    pm.init_training()
    tree = convert_vits_torch_state_dict({k: v.numpy() for k, v in pm.training_state_dict().items()})
    model.params = {"generator": randomize(tree["generator"], SEED)}
    return model


def port_model():
    """The port's tiny `Vits` on the CPU carrying the JAX model's weights."""
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.models.vits_convert import params_from_flax

    model = Vits(port_config(), device="cpu")
    sd = params_from_flax(jax_model().params["generator"])
    model.net.load_state_dict({k: v for k, v in sd.items() if not k.startswith("posterior_encoder.")}, strict=True)
    return model


def max_err(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


TINY_WAVERNN = dict(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8, num_res_blocks=1,
                    upsample_factors=[2, 2], mode="7", mulaw=True, pad=2, feat_dims=20)


def draw_wavernn_tree(tree, seed: int):
    """Params and batch statistics from a numpy seed: BatchNorm `scale` and
    running `var` ≈ 1 ± 0.3, the smoothing kernels a moving average ± 0.05,
    everything else ~N(0, 0.3²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, tuple(leaf.shape)
        if name.startswith("smooth_"):
            return (1.0 / shape[0] + 0.05 * rng.uniform(-1, 1, shape)).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.3 * rng.uniform(-1, 1, shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def jax_wavernn(upsample_factors=(2, 2)):
    """The tiny JAX `Wavernn` ('bits' mode 7, mu-law, aux net) with seeded
    random params and batch statistics (built once per process and hop)."""
    from tpu_tts.vocoder.configs.wavegrad_config import WavernnConfig
    from tpu_tts.vocoder.models.wavernn import Wavernn, WavernnArgs

    cfg = WavernnConfig()
    cfg.model_args = WavernnArgs(**{**TINY_WAVERNN, "upsample_factors": list(upsample_factors)})
    model = Wavernn(cfg)
    a, hop = model.args, int(np.prod(model.args.upsample_factors))
    x, mels = jnp.zeros((2, 4 * hop)), jnp.zeros((2, 2 * a.pad + 4, a.feat_dims))
    shapes = jax.eval_shape(lambda: model.net.init(jax.random.PRNGKey(0), x, mels))
    variables = draw_wavernn_tree(shapes, 7)
    model.params = variables["params"]
    model.model_state = {"batch_stats": variables["batch_stats"]}
    return model


def port_wavernn_config(audio=None, **overrides):
    from tpu_tts_torch.config.shared_configs import BaseAudioConfig
    from tpu_tts_torch.vocoder.configs import WavernnConfig

    return WavernnConfig(model_args={**TINY_WAVERNN, **overrides}, audio=BaseAudioConfig(**(audio or {})))


def port_wavernn(jm, **config):
    """The port's `Wavernn` on the CPU carrying the JAX model's weights."""
    from tpu_tts_torch.vocoder.models.wavernn import Wavernn
    from tpu_tts_torch.vocoder.models.wavernn_convert import params_from_flax

    model = Wavernn(port_wavernn_config(upsample_factors=list(jm.args.upsample_factors), **config), device="cpu")
    model.net.load_state_dict(params_from_flax(jm.params, jm.model_state), strict=True)
    return model


# the JAX XTTS fixture's widths (tests/test_xtts.py): 2 GPT layers, 32 wide
XTTS_ARGS = dict(gpt_layers=2, gpt_n_heads=2, gpt_n_model_channels=32, gpt_number_text_tokens=50,
                 gpt_num_audio_tokens=34, gpt_start_audio_token=32, gpt_stop_audio_token=33,
                 gpt_start_text_token=48, gpt_stop_text_token=0, num_cond_latents=4, d_vector_dim=16,
                 decoder_input_dim=32, decoder_upsample_rates=(4, 4), kv_cache_len=128)


def draw_xtts_tree(tree, seed: int):
    """XTTS params from a numpy seed: norm scales ≈ 1 ± 0.1, the position
    embeddings ~N(0, 1) (so greedy decoding does not settle on one code),
    everything else ~N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        shape = tuple(leaf.shape)
        if names[-1] in ("scale", "g", "norm_gamma"):
            return (1.0 + 0.1 * rng.uniform(-1, 1, shape)).astype(np.float32)
        std = 1.0 if names[-2] in ("text_pos_embedding", "audio_pos_embedding") else 0.1
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def jax_xtts(**overrides):
    """A tiny JAX `Xtts` (XTTS_ARGS with `overrides`) with seeded params
    (built once per process). The tree's layout is the JAX package's Coqui
    converter applied to the port's state dict, plus `speaker_proj` (Coqui
    has none): the paths and shapes of a flax `init_all` trace, so the same
    draws, without the trace's seconds."""
    from tpu_tts.configs.xtts_config import XttsConfig
    from tpu_tts.models.xtts import Xtts, XttsArgs
    from tpu_tts.models.xtts_convert import convert_xtts_torch_state_dict
    from tpu_tts_torch.configs.xtts_config import XttsArgs as PortArgs
    from tpu_tts_torch.configs.xtts_config import XttsConfig as PortConfig
    from tpu_tts_torch.models.xtts import Xtts as PortXtts

    cfg = XttsConfig()
    cfg.model_args = XttsArgs(**{**XTTS_ARGS, **overrides})
    model = Xtts(cfg)
    port = PortXtts(PortConfig(model_args=PortArgs(**{**XTTS_ARGS, **overrides})), device="cpu")
    sd = {k: v.numpy() for k, v in port.net.state_dict().items()}
    tree = convert_xtts_torch_state_dict(sd)
    tree["speaker_proj"] = {"kernel": sd["speaker_proj.weight"].T, "bias": sd["speaker_proj.bias"]}
    model.params = draw_xtts_tree(tree, SEED)
    return model


def port_xtts(**overrides):
    """The port's tiny `Xtts` on the CPU carrying `jax_xtts(**overrides)`'s weights."""
    from tpu_tts_torch.configs.xtts_config import XttsArgs, XttsConfig
    from tpu_tts_torch.models.xtts import Xtts
    from tpu_tts_torch.models.xtts_convert import params_from_flax

    model = Xtts(XttsConfig(model_args=XttsArgs(**{**XTTS_ARGS, **overrides})), device="cpu")
    model.net.load_state_dict(params_from_flax(jax_xtts(**overrides).params), strict=True)
    return model


def speaker_wav(seed: int, n: int = 11025) -> np.ndarray:
    """Half a second of seeded noise at 22.05 kHz, the JAX pool tests' cloning audio."""
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)


def seeded(net, seed: int):
    """Every float tensor of `net`'s state dict from a seed: running
    variances ≈ 1 ± 0.3, means and biases ~N(0, 0.1²), weights He-scaled."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if not v.is_floating_point():
                continue
            if k.endswith("running_var"):
                v.copy_(1 + 0.3 * torch.rand(v.shape, generator=g))
            elif k.endswith(("running_mean", "bias")):
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
            elif v.ndim == 1:
                v.copy_(1 + 0.1 * torch.randn(v.shape, generator=g))
            else:
                v.copy_(torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5)
    return net
