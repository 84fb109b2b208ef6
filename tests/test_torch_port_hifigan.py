"""The port's HiFi-GAN MRF stack and generator against `tpu_tts` (CPU, f32).

`mrf_stack_reference` is held to the Pallas kernel in interpret mode and to
the flax `ResBlock1` mean at 2e-4, the bar of tests/test_hifigan_pallas.py,
on a time length that is a multiple of no tile. The generator is held to
the flax generator at 2e-4. The CUDA kernel itself is held to the plain
version on the card in tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import flax_param_shapes, cached_flax_shape_check, max_err, randomize
from tpu_tts.ops.hifigan_pallas import mrf_stack_pallas
from tpu_tts.vocoder.models.hifigan_generator import HifiganGenerator as FlaxGenerator
from tpu_tts.vocoder.models.hifigan_generator import ResBlock1 as FlaxResBlock1
from tpu_tts_torch.models.vits_convert import params_from_flax
from tpu_tts_torch.ops import hifigan_mrf
from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


def _stage(C, seed, kernel_sizes=KS, dilations=DILS):
    """Random folded weights in flax layout: [block][unit] = (w1 [k, C, C], b1, w2, b2)."""
    rng = np.random.default_rng(seed)
    return [
        [
            tuple(
                (rng.standard_normal(s) * sc).astype(np.float32)
                for s, sc in (((k, C, C), (k * C) ** -0.5), ((C,), 0.1), ((k, C, C), (k * C) ** -0.5), ((C,), 0.1))
            )
            for _ in dils
        ]
        for k, dils in zip(kernel_sizes, dilations)
    ]


def _port_stage(weights, dilations=DILS, device="cpu"):
    def t(a):  # flax [k, in, out] → torch [out, in, k]; biases as they are
        return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (2, 1, 0)) if a.ndim == 3 else a)).to(device)

    return hifigan_mrf.pack_stage(
        [
            [(t(w1), t(b1), t(w2), t(b2), d) for (w1, b1, w2, b2), d in zip(units, dils)]
            for units, dils in zip(weights, dilations)
        ]
    )


def _flax_mean(x, weights, kernel_sizes=KS, dilations=DILS):
    outs = []
    for units, k, dils in zip(weights, kernel_sizes, dilations):
        params = {}
        for i, (w1, b1, w2, b2) in enumerate(units):
            for name, w, b in ((f"convs1_{i}", w1, b1), (f"convs2_{i}", w2, b2)):
                params[name] = {"v": w, "g": np.sqrt(np.sum(w**2, axis=(0, 1))), "bias": b}
        outs.append(FlaxResBlock1(x.shape[-1], k, tuple(dils)).apply({"params": params}, x))
    return sum(outs) / len(outs)


@pytest.mark.parametrize("T", [77])
def test_mrf_reference_matches_pallas_and_flax(T):
    C = 16
    weights = _stage(C, seed=T)
    x = np.random.default_rng(1).standard_normal((2, T, C)).astype(np.float32)
    stage = _port_stage(weights)
    got = hifigan_mrf.mrf_stack_reference(torch.from_numpy(x).transpose(1, 2), stage).transpose(1, 2)
    pallas = jax.jit(lambda x: mrf_stack_pallas(x, weights, KS, DILS, interpret=True))(jnp.asarray(x))
    flax = jax.jit(lambda x: _flax_mean(x, weights))(jnp.asarray(x))
    assert max_err(got, x) > 1e-2  # the stack does work
    assert max_err(got, pallas) <= 2e-4
    assert max_err(got, flax) <= 2e-4
    # on a CPU tensor the wrapper takes the plain version
    cpu = hifigan_mrf.mrf_stack(torch.from_numpy(x).transpose(1, 2), stage)
    assert max_err(cpu.transpose(1, 2), got) == 0.0


def test_generator_matches_flax():
    kw = dict(
        resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)), upsample_kernel_sizes=(8, 8),
        upsample_initial_channel=32, upsample_factors=(4, 4),
    )
    flax_gen = FlaxGenerator(in_channels=16, **kw)
    x = np.random.default_rng(2).standard_normal((2, 21, 16)).astype(np.float32)
    params = randomize(flax_param_shapes(flax_gen, jnp.asarray(x)), seed=5)
    ref = jax.jit(lambda p, x: flax_gen.apply({"params": p}, x))(params, jnp.asarray(x))

    gen = HifiganGenerator(in_channels=16, **kw)
    sd = params_from_flax({"waveform_decoder": params})
    gen.load_state_dict({k[len("waveform_decoder."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = gen(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == (2, 21 * 16, 1)
    assert float(np.std(np.asarray(ref))) > 1e-2
    assert max_err(got, ref) <= 2e-4
