"""Shared set-up of the `test_torch_port_*` files: one tiny VITS built on both
sides, the JAX generator params drawn from a numpy seed and carried into the
port through `params_from_flax`."""

import functools

import jax
import numpy as np
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
    per process)."""
    from tpu_tts.models.vits import Vits

    import jax.numpy as jnp

    model = Vits(jax_config())
    x = jnp.zeros((1, 8), jnp.int32)
    spec = jnp.zeros((1, 12, model.args.out_channels))
    shapes = flax_param_shapes(model.net, x, jnp.array([8]), spec, jnp.array([12]), train=True)
    model.params = {"generator": randomize(shapes, SEED)}
    return model


def port_model():
    """The port's tiny `Vits` on the CPU carrying the JAX model's weights."""
    from tpu_tts_torch.models.vits import Vits
    from tpu_tts_torch.models.vits_convert import params_from_flax

    model = Vits(port_config(), device="cpu")
    model.net.load_state_dict(params_from_flax(jax_model().params["generator"]), strict=True)
    return model


def max_err(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))
