"""The port's VITS layers against `tpu_tts` on the same weights and inputs (CPU, f32).

Tolerances: text encoder 1e-5, flow reverse 1e-5, SDP reverse `logw` 1e-4
(the spline's softmax/cumsum/sqrt chain is summed in another order),
`generate_path` exact. Also: the port imports nothing of JAX or `tpu_tts`,
and asking for CUDA without it raises.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import cached_flax_shape_check, jax_model, max_err, port_model
from tpu_tts.ops.helpers import generate_path as jax_generate_path
from tpu_tts_torch.ops.helpers import generate_path

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer


@pytest.fixture(scope="module")
def models():
    return jax_model(), port_model()


def _tokens(B=2, T=11, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 40, (B, T)).astype(np.int32)
    lengths = np.array([T, T - 4][:B], dtype=np.int32)
    return x, lengths


def _jax_apply(model, fn, *args, **kw):
    run = jax.jit(lambda p, *a: model.net.apply({"params": p}, *a, method=fn, **kw))
    return run(model.params["generator"], *args)


def test_generate_path_exact():
    rng = np.random.default_rng(1)
    dur = rng.integers(0, 4, (2, 7)).astype(np.float32)
    mask = (rng.uniform(size=(2, 7, 20)) > 0.2).astype(np.float32)
    ref = np.asarray(jax_generate_path(jnp.asarray(dur), jnp.asarray(mask)))
    got = generate_path(torch.from_numpy(dur), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_text_encoder_matches_jax(models):
    jm, pm = models
    x, xl = _tokens()
    ref = _jax_apply(jm, lambda m, x, xl: m.text_encoder(x, xl), jnp.asarray(x), jnp.asarray(xl))
    with torch.no_grad():
        got = pm.net.text_encoder(torch.from_numpy(x).long(), torch.from_numpy(xl).long())
    for r, g in zip(ref, got):  # h, m, logs, x_mask
        assert max_err(g.transpose(1, 2), r) <= 1e-5


def test_sdp_reverse_logw_matches_jax(models):
    jm, pm = models
    x, xl = _tokens(seed=2)

    def logw(m, x, xl):
        h, _, _, mask = m.text_encoder(x, xl)
        return m.duration_predictor(h, mask, reverse=True, noise_scale=0.0)

    ref = _jax_apply(jm, logw, jnp.asarray(x), jnp.asarray(xl), rngs={"sdp": jax.random.PRNGKey(0)})
    with torch.no_grad():
        h, _, _, mask = pm.net.text_encoder(torch.from_numpy(x).long(), torch.from_numpy(xl).long())
        got = pm.net.duration_predictor.reverse(h, mask, torch.zeros(2, 2, x.shape[1]), noise_scale=0.0)
    assert float(np.max(np.abs(np.asarray(ref)))) > 1e-2  # the flows do real work
    assert max_err(got.transpose(1, 2), ref) <= 1e-4


def test_flow_reverse_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 24, 32)).astype(np.float32)
    mask = np.ones((2, 24, 1), np.float32)
    mask[1, 17:] = 0
    ref = _jax_apply(jm, lambda m, z, mk: m.flow(z * mk, mk, reverse=True), jnp.asarray(z), jnp.asarray(mask))
    with torch.no_grad():
        zt, mt = torch.from_numpy(z).transpose(1, 2), torch.from_numpy(mask).transpose(1, 2)
        got = pm.net.flow.reverse(zt * mt, mt)
    assert max_err(got.transpose(1, 2), z * mask) > 1e-2  # not the identity
    assert max_err(got.transpose(1, 2), ref) <= 1e-5


def test_cuda_request_without_cuda_raises(monkeypatch):
    from tpu_tts_torch.device import resolve_device
    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.models.vits import Vits
    from tests.torch_port_common import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: resolve_device(), lambda: resolve_device("cuda"), lambda: Vits(port_config()),
                 lambda: Synthesizer()):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_tpu_tts():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import tpu_tts_torch
        for mod in pkgutil.walk_packages(tpu_tts_torch.__path__, "tpu_tts_torch."):
            importlib.import_module(mod.name)
        import chip_smoke
        bad = sorted(m for m in sys.modules if m in ("jax", "flax", "tpu_tts") or m.startswith(("jax.", "flax.", "tpu_tts.")))
        bad += [m for m in ("tpu_tts_torch.api", "tpu_tts_torch.bin.synthesize", "tpu_tts_torch.zoo.manage",
                            "tpu_tts_torch.text.phonemizers.en_rules", "tpu_tts_torch.infer.batcher",
                            "tpu_tts_torch.managers", "tpu_tts_torch.text.phonemizers.ja_jp_phonemizer",
                            "tpu_tts_torch.text.phonemizers.ko_kr_phonemizer",
                            "tpu_tts_torch.text.phonemizers.bn_phonemizer", "tpu_tts_torch.models.xtts",
                            "tpu_tts_torch.models.xtts_convert", "tpu_tts_torch.infer.xtts_pool",
                            "tpu_tts_torch.layers.xtts.gpt", "tpu_tts_torch.layers.xtts.perceiver",
                            "tpu_tts_torch.layers.xtts.tokenizer", "tpu_tts_torch.layers.xtts.text_norm",
                            "tpu_tts_torch.layers.xtts.num_words", "tpu_tts_torch.audio.torch_transforms",
                            "tpu_tts_torch.configs.xtts_config", "tpu_tts_torch.train.trainer",
                            "tpu_tts_torch.train.optimizers", "tpu_tts_torch.train.checkpoint",
                            "tpu_tts_torch.data.dataset", "tpu_tts_torch.data.formatters",
                            "tpu_tts_torch.data.samplers", "tpu_tts_torch.ops.mas", "tpu_tts_torch.layers.losses",
                            "tpu_tts_torch.vocoder.models.hifigan_discriminator", "tpu_tts_torch.bin.train_tts",
                            "tpu_tts_torch.layers.xtts.dvae", "tpu_tts_torch.layers.xtts.dataset",
                            "tpu_tts_torch.train.precision", "tpu_tts_torch.encoder.configs",
                            "tpu_tts_torch.encoder.models", "tpu_tts_torch.encoder.losses",
                            "tpu_tts_torch.encoder.dataset", "tpu_tts_torch.encoder.encoder_convert",
                            "tpu_tts_torch.bin.train_encoder", "tpu_tts_torch.bin.compute_embeddings",
                            "tpu_tts_torch.bin.eval_encoder", "tpu_tts_torch.vocoder.configs.gan_configs",
                            "tpu_tts_torch.vocoder.models.gan", "tpu_tts_torch.vocoder.models.melgan_generator",
                            "tpu_tts_torch.vocoder.models.melgan_discriminator",
                            "tpu_tts_torch.vocoder.models.univnet_generator",
                            "tpu_tts_torch.vocoder.models.univnet_discriminator",
                            "tpu_tts_torch.vocoder.models.vocoder_convert", "tpu_tts_torch.vocoder.layers.losses",
                            "tpu_tts_torch.vocoder.layers.pqmf", "tpu_tts_torch.vocoder.datasets",
                            "tpu_tts_torch.vocoder.datasets.gan_dataset", "tpu_tts_torch.bin.train_vocoder",
                            "tpu_tts_torch.configs.delightful_tts_config", "tpu_tts_torch.layers.delightful",
                            "tpu_tts_torch.models.delightful_tts", "tpu_tts_torch.models.delightful_convert",
                            "tpu_tts_torch.layers.feed_forward", "tpu_tts_torch.audio.numpy_transforms",
                            "tpu_tts_torch.ops.helpers", "tpu_tts_torch.configs.forward_tts_config",
                            "tpu_tts_torch.layers.norms", "tpu_tts_torch.models.forward_tts",
                            "tpu_tts_torch.models.forward_convert")
                if m not in sys.modules]  # the serving modules are among those walked
        print(len([m for m in sys.modules if m.startswith("tpu_tts_torch.")]), bad)
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=_repo_root())
    assert out.returncode == 0, out.stderr
    n_port, bad = out.stdout.strip().split(" ", 1)
    assert int(n_port) >= 20
    assert bad == "[]", bad


def _repo_root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
