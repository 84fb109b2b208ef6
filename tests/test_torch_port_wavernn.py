"""The port's WaveRNN vocoder against `tpu_tts` (CPU, f32).

One tiny WaveRNN ('bits' mode 7, mu-law, aux net) with seeded random params
on the JAX side, carried into the port through `params_from_flax`:

- the plain sampler against `PallasWavernnSampler` in interpret mode with
  `time_chunk=8` (the state carries across chunks): greedy within 1e-5 (the
  bar of tests/test_wavernn_pallas.py), sampled with seed 3 equal (the port
  draws with the JAX kernel's interpret-mode hash): the same class at every
  step;
- the upsample network and one step of the cell within 1e-5;
- `Wavernn.inference` against JAX `inference(use_pallas=True)`, folded and
  not, waveform within 1e-5;
- the teacher-forced check that holds the kernel to the plain version;
- a batch split by row offset draws what the whole batch draws;
- the weight bridge back through the JAX package's converter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import cached_flax_shape_check, jax_wavernn, max_err, port_wavernn, port_wavernn_config
from tpu_tts.ops.wavernn_pallas import PallasWavernnSampler
from tpu_tts.vocoder.models.vocoder_convert import convert_wavernn_state_dict
from tpu_tts_torch.ops import wavernn_sampler

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

@pytest.fixture(scope="module")
def models():
    jm = jax_wavernn()
    return jm, port_wavernn(jm)


def _streams(B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 20)).astype(np.float32),
            rng.standard_normal((B, T, 8)).astype(np.float32))


@pytest.mark.parametrize("greedy", [True, False])
def test_sampler_matches_pallas_interpret(models, greedy):
    jm, pm = models
    mels_up, aux = _streams(T=21)
    sampler = PallasWavernnSampler.from_flax_params(jm.params, jm.args)
    sampler.interpret, sampler.greedy, sampler.time_chunk = True, greedy, 8
    ref = np.asarray(sampler(jnp.asarray(mels_up), jnp.asarray(aux), seed=3))

    w = wavernn_sampler.pack_weights(pm.net)
    streams, tc = wavernn_sampler.precompute_streams(w, torch.from_numpy(mels_up), torch.from_numpy(aux), 8)
    assert tc == 8 and streams[0].shape[1] == 24  # padded to whole chunks
    got = wavernn_sampler.sample(w, streams, tc, greedy=greedy, seed=3)[:, :21]
    assert len(np.unique(ref)) > 3  # the draw moves
    if greedy:
        assert max_err(got, ref) <= 1e-5
    else:  # the same class at every step (the value 2·c/(C−1) − 1 may round apart by an ulp)
        np.testing.assert_array_equal(np.rint((got.numpy() + 1) * 127 / 2), np.rint((ref + 1) * 127 / 2))


@pytest.mark.parametrize("greedy", [True, False])
def test_score_gap_holds_draws_to_their_step(models, greedy):
    """The teacher-forced check of the kernel: the plain version's own draws
    score the best at every step; a draw moved to another class does not."""
    _, pm = models
    mels_up, aux = _streams(T=16, seed=4)
    w = wavernn_sampler.pack_weights(pm.net)
    streams, tc = wavernn_sampler.precompute_streams(w, torch.from_numpy(mels_up), torch.from_numpy(aux), 8)
    own = wavernn_sampler.sample_reference(w, streams, tc, greedy=greedy, seed=2)
    assert float(wavernn_sampler.score_gap(w, streams, tc, own, greedy=greedy, seed=2).abs().max()) == 0.0
    moved = own.clone()
    moved[1, 9] = -own[1, 9] if own[1, 9] != 0 else 1.0
    gap = wavernn_sampler.score_gap(w, streams, tc, moved, greedy=greedy, seed=2)
    assert float(gap[1, 9]) > 1e-3 and float(gap[0].abs().max()) == 0.0


@pytest.mark.parametrize("greedy", [True, False])
def test_sampler_split_by_row_offset_equals_whole_batch(models, greedy):
    """A batch split into consecutive chunks, each drawn with `row0` at its
    first row's index, gives what the whole batch gives, row for row: the
    kernel's wrapper splits a batch of any size over launches this way."""
    _, pm = models
    mels_up, aux = _streams(B=5, T=16, seed=6)
    w = wavernn_sampler.pack_weights(pm.net)
    streams, tc = wavernn_sampler.precompute_streams(w, torch.from_numpy(mels_up), torch.from_numpy(aux), 8)
    whole = wavernn_sampler.sample_reference(w, streams, tc, greedy=greedy, seed=7)
    parts = [wavernn_sampler.sample_reference(w, tuple(s[b0:b1] for s in streams), tc, greedy=greedy, seed=7, row0=b0)
             for b0, b1 in ((0, 2), (2, 4), (4, 5))]
    assert len(torch.unique(whole)) > 3
    assert torch.equal(torch.cat(parts), whole)


def test_upsample_and_cell_match_jax(models):
    jm, pm = models
    rng = np.random.default_rng(1)
    mels = rng.standard_normal((2, 9, 20)).astype(np.float32)
    variables = {"params": jm.params, **jm.model_state}
    ref_up, ref_aux = jax.jit(lambda m: jm.net.apply(variables, m, method=lambda n, mm: n.upsample(mm)))(mels)
    with torch.no_grad():
        got_up, got_aux = pm.net.upsample(torch.from_numpy(mels))
    assert got_up.shape == (2, 20, 20) and got_aux.shape == (2, 20, 8)
    assert max_err(got_up, ref_up) <= 1e-5
    assert max_err(got_aux, ref_aux) <= 1e-5

    h1, h2 = rng.standard_normal((2, 2, 16)).astype(np.float32)
    x_prev = rng.uniform(-1, 1, (2, 1)).astype(np.float32)
    mel_t, aux_t = mels[:, 0], rng.standard_normal((2, 8)).astype(np.float32)
    ref = jm.net.apply(variables, h1, h2, x_prev, mel_t, aux_t, method=lambda n, *a: n.cell(*a))
    with torch.no_grad():
        got = pm.net(*(torch.from_numpy(v) for v in (h1, h2, x_prev, mel_t, aux_t)))
    for g, r in zip(got, ref):
        assert max_err(g, r) <= 1e-5


@pytest.mark.parametrize("batched", [True, False])
def test_inference_matches_jax(models, batched):
    jm, pm = models
    mels = np.random.default_rng(2).standard_normal((23, 20)).astype(np.float32)
    ref = jm.inference(mels, batched=batched, target=8 * 4, overlap=2 * 4, use_pallas=True, seed=5)
    got = pm.inference(mels, batched=batched, target=8 * 4, overlap=2 * 4, seed=5)
    assert got.shape == ref.shape == (23 * 4,)
    assert float(np.std(ref)) > 1e-2
    assert max_err(got, ref) <= 1e-5


def test_weight_bridge_round_trip(models):
    """port state_dict → the JAX package's converter → the JAX tree, with
    the running statistics folded into the params (frozen_batch)."""
    jm, pm = models
    back = convert_wavernn_state_dict({k: v.numpy() for k, v in pm.net.state_dict().items()})
    stats = jm.model_state["batch_stats"]["upsample"]["resnet"]
    src = jax.tree.map(np.asarray, jm.params)
    for name, node in stats.items():
        src["upsample"]["resnet"][name].update({k: np.asarray(v) for k, v in node.items()})

    def walk(a, b, path):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_allclose(np.asarray(b[k]), a[k], atol=1e-7, err_msg=f"{path}/{k}")

    walk(src, back, "")


def test_unported_modes_raise():
    from tpu_tts_torch.vocoder.configs import WavernnConfig
    from tpu_tts_torch.vocoder.models import setup_model
    from tpu_tts_torch.vocoder.models.wavernn import Wavernn

    for overrides in ({"mode": "mold"}, {"mode": "gauss"}, {"use_aux_net": False}):
        with pytest.raises(NotImplementedError):
            Wavernn(port_wavernn_config(**overrides), device="cpu")
    with pytest.raises(NotImplementedError):
        setup_model(WavernnConfig(model="hifigan"), device="cpu")
    assert type(setup_model(port_wavernn_config(), device="cpu")) is Wavernn
