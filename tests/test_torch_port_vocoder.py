"""The port's GAN vocoders against `tpu_tts` on the CPU (float32).

Weights come from a numpy seed on the JAX side (`randomize` over the flax
shapes from `jax.eval_shape`) and reach the port through
`vocoder_convert.gan_state_dict_from_flax`. Tolerances:

- K1's plain version (`mrf_stack_reference`) at C = 8, 16 and 24 against
  the mean of `tpu_tts`'s flax ResBlock1 modules: 1e-5;
- the generators in eval (HiFi-GAN at `upsample_initial_channel` 16, stage
  widths 8 … 1, without `conv_post`'s bias; MelGAN full-band and 4-band;
  UnivNet with its noise given) and PQMF analysis and synthesis: 1e-5;
- every loss of `vocoder/layers/losses.py` on fixed arrays: 1e-6 relative;
- the Coqui-key loader: the port's weights written in Coqui's layout (old
  weight norm, a generator-only file, a plain `conv_pre`) give back the
  JAX params through `convert_gan_torch_state_dict` and load into the port;
- `GANDataset` (noise off): the eval window, its mel and the padding of a
  short clip equal `tpu_tts`'s;
- the `Synthesizer` with Glow-TTS and a tiny HiFi-GAN against `tpu_tts`'s
  vocoder stage (the audio handshake, `_interpolate_mel`, `GAN.inference`)
  on the port's mel: 2e-4.

`tests/test_torch_port_vocoder_train.py` holds the GAN steps against JAX
and drives `bin/train_vocoder`.
"""

import copy
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import flax_param_shapes, max_err, randomize

torch.set_num_threads(1)

MELS = 20


def _audio(**kw):
    return dict(num_mels=MELS, fft_size=64, win_length=64, hop_length=16, sample_rate=22050, **kw)


def _mel(T, seed, B=2):
    return np.random.default_rng(seed).standard_normal((B, T, MELS)).astype(np.float32)


def _disc_tree_from_port(sd):
    """The port's HiFi-GAN discriminator `state_dict` → the flax tree
    (`mpd/disc_p{p}/...`, `msd/disc_s{i}/...`): weight norm's (g, v) as
    flax's (g per output channel, v with the output axis last), a
    spectral-normed weight as flax's raw `v`."""
    tree = {}
    for k, v in sd.items():
        m = re.match(r"(mpd|msd)\.discriminators\.(\d+)\.(convs\.(\d+)|conv_post)\.(.*)$", k)
        which, i, conv, leaf = m.group(1), int(m.group(2)), m.group(3).replace(".", "_"), m.group(5)
        net = f"disc_p{(2, 3, 5, 7, 11)[i]}" if which == "mpd" else f"disc_s{i}"
        node = tree.setdefault(which, {}).setdefault(net, {}).setdefault(conv, {})
        a = v.detach().numpy()
        perm = tuple(range(2, a.ndim)) + (1, 0)  # [out, in, ..k..] → [..k.., in, out]
        if leaf == "bias":
            node["bias"] = a
        elif leaf == "parametrizations.weight.original0":
            node["g"] = a.reshape(-1)
        else:  # original1, or a spectral-normed weight
            node["v"] = np.ascontiguousarray(np.transpose(a, perm))
    return tree


def _pair(config_cls, seed, base_channels=None, **overrides):
    """(JAX `GAN`, port `GAN`) of one config on the same seeded weights; with
    `base_channels`, a MelGAN-family generator of that width on both sides."""
    from tpu_tts.config.shared_configs import BaseAudioConfig as JaxAudio
    from tpu_tts.vocoder import configs as jax_configs
    from tpu_tts.vocoder.models.gan import GAN as JaxGAN
    from tpu_tts.vocoder.models.vocoder_convert import convert_gan_torch_state_dict
    from tpu_tts_torch.config.shared_configs import BaseAudioConfig
    from tpu_tts_torch.vocoder import configs
    from tpu_tts_torch.vocoder.models import setup_model
    from tpu_tts_torch.vocoder.models.vocoder_convert import gan_state_dict_from_flax

    jc = getattr(jax_configs, config_cls)(audio=JaxAudio(**_audio()), **overrides)
    pc = getattr(configs, config_cls)(audio=BaseAudioConfig(**_audio()), **overrides)
    jm = JaxGAN.init_from_config(jc)
    pm = setup_model(pc, device="cpu")
    n_stages = len(pc.generator_model_params.get("upsample_factors", ()))
    if base_channels is not None:
        from tpu_tts.vocoder.models.melgan_generator import MelganGenerator as JaxMelgan
        from tpu_tts_torch.vocoder.models.melgan_generator import MelganGenerator

        kw = dict(in_channels=MELS, out_channels=jm.generator.out_channels, base_channels=base_channels,
                  upsample_factors=tuple(pc.generator_model_params["upsample_factors"]),
                  num_res_blocks=pc.generator_model_params["num_res_blocks"])
        jm.generator, pm.net.model_g = JaxMelgan(**kw), MelganGenerator(**kw)
    # the generator tree's layout: the JAX converter on the port's state dict (a flax trace's paths and shapes)
    g_tree = convert_gan_torch_state_dict({k: v.numpy() for k, v in pm.net.state_dict().items()
                                           if k.startswith("model_g.")}, generator_name=pc.generator_model)
    g_tree = g_tree["generator"]
    if "bias" in g_tree.get("conv_post", {}) and not pc.generator_model_params.get("conv_post_bias", True):
        del g_tree["conv_post"]["bias"]  # the converter's zero fill of a bias the model leaves out
    jm.params = {"generator": randomize(g_tree, seed)}
    if pc.discriminator_model == "hifigan_discriminator":
        # 70 M parameters: the port's own init (biases drawn too), carried to JAX by transposes
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in pm.model_d.named_parameters():
                if name.endswith("bias"):
                    p.normal_(0.0, 0.1, generator=gen)
        jm.params["discriminator"] = _disc_tree_from_port(pm.model_d.state_dict())
    else:
        d_shapes = flax_param_shapes(jm.discriminator, jnp.zeros((1, 16 * jc.audio.hop_length, 1)))
        jm.params["discriminator"] = randomize(d_shapes, seed + 1)
    sd = gan_state_dict_from_flax(jm.params if pc.discriminator_model != "hifigan_discriminator" else
                                  {"generator": jm.params["generator"]}, pc.generator_model, n_stages)
    pm.net.load_state_dict(sd, strict=pc.discriminator_model != "hifigan_discriminator")
    return jm, pm


TINY_HIFIGAN = dict(generator_model_params={
    "upsample_factors": [2, 2, 2, 2], "upsample_kernel_sizes": [4, 4, 4, 4], "upsample_initial_channel": 16,
    "resblock_kernel_sizes": [3, 7, 11], "resblock_dilation_sizes": [[1, 3, 5]] * 3, "resblock_type": "1",
    "conv_post_bias": False})
TINY_MB = dict(generator_model_params={"upsample_factors": [2, 2], "num_res_blocks": 2},
               discriminator_model_params={"base_channels": 4, "max_channels": 16, "downsample_factors": [2, 2]},
               stft_loss_params={"n_ffts": [64, 128, 32], "hop_lengths": [16, 32, 8], "win_lengths": [48, 96, 24]},
               subband_stft_loss_params={"n_ffts": [32, 57, 17], "hop_lengths": [8, 12, 4],
                                         "win_lengths": [24, 40, 12]})


@functools.lru_cache(maxsize=None)
def hifigan_pair():
    return _pair("HifiganConfig", 11, **TINY_HIFIGAN)


@functools.lru_cache(maxsize=None)
def multiband_pair(base_channels=None):
    return _pair("MultibandMelganConfig", 21, base_channels, **TINY_MB)


# ------------------------------------------------------------------ K1, widths
@pytest.mark.parametrize("C", [8, 16, 24])
def test_mrf_reference_matches_flax_resblocks(C):
    """The plain MRF stack at widths that are not a multiple of 32 against
    the mean of `tpu_tts`'s flax ResBlock1 modules (k 3/7/11, d 1/3/5)."""
    from tpu_tts.vocoder.models.hifigan_generator import ResBlock1
    from tpu_tts_torch.ops.hifigan_mrf import mrf_stack_reference, pack_stage

    x = np.random.default_rng(C).standard_normal((2, 50, C)).astype(np.float32)
    blocks = [ResBlock1(C, k, (1, 3, 5)) for k in (3, 7, 11)]
    params = [randomize(flax_param_shapes(rb, jnp.asarray(x)), C + i) for i, rb in enumerate(blocks)]
    ref = jax.jit(lambda ps, x: sum(rb.apply({"params": p}, x) for rb, p in zip(blocks, ps)) / 3)(params, x)

    def fold(node):
        v, g = np.asarray(node["v"], np.float64), np.asarray(node["g"], np.float64)
        w = v / np.sqrt(np.sum(v**2, axis=(0, 1), keepdims=True) + 1e-12) * g
        return torch.from_numpy(np.transpose(w, (2, 1, 0)).astype(np.float32)), torch.from_numpy(np.asarray(node["bias"]))

    stage = pack_stage([[(*fold(p[f"convs1_{u}"]), *fold(p[f"convs2_{u}"]), d) for u, d in enumerate((1, 3, 5))]
                        for p in params])
    got = mrf_stack_reference(torch.from_numpy(x).transpose(1, 2), stage)
    assert max_err(got.transpose(1, 2), ref) <= 1e-5


# ---------------------------------------------------------------- generators
def test_hifigan_generator_matches_jax():
    """A HiFi-GAN generator at 16 → 8 … 1 channels without `conv_post`'s
    bias, in eval (every stage through `mrf_stack`, its plain version on
    the CPU), and its edge-padded `inference`, against the flax one."""
    jm, pm = hifigan_pair()
    assert pm.model_g.conv_post.bias is None and pm.model_g.inference_padding == 5
    _check_generator(jm, pm, 22, 16, pad=5)


def _check_generator(jm, pm, T, hop, pad):
    """`GAN.inference` (a mel of T frames) and the generator's own
    edge-padded `inference` (a mel of T − 2·pad frames, padded by `pad` a
    side) against the flax generator, both at T frames: one JAX program."""
    ref_fn = jax.jit(lambda p, m: jm._gen_apply(p, m))
    mel = _mel(T, T)
    ref = np.asarray(ref_fn(jm.params["generator"], mel))
    if jm.pqmf is not None:
        ref = np.asarray(jax.jit(jm.pqmf.synthesis)(ref))
    got = pm.inference(mel)
    assert got.shape == ref.shape == (2, T * hop, 1) and float(np.std(ref)) > 1e-3
    assert max_err(got, ref) <= 1e-5
    short = mel[:, 1: 1 + T - 2 * pad]
    ref_pad = ref_fn(jm.params["generator"], np.pad(short, ((0, 0), (pad, pad), (0, 0)), mode="edge"))
    with torch.no_grad():
        got_pad = pm.model_g.inference(torch.from_numpy(short).transpose(1, 2))
    assert max_err(got_pad.transpose(1, 2), ref_pad) <= 1e-5


@pytest.mark.parametrize("name", ["MelganConfig", "MultibandMelganConfig"])
def test_melgan_generators_and_pqmf_match_jax(name):
    """MelGAN (full band, its modules at a 64-channel base) and the 4-band
    generator of `setup_generator` (base 384) with PQMF synthesis in
    `GAN.inference`, the generator's edge-padded `inference`, and PQMF
    analysis, against `tpu_tts`."""
    if name == "MultibandMelganConfig":
        jm, pm = multiband_pair()
    else:
        from tpu_tts.vocoder.models.melgan_generator import MelganGenerator as JaxMelgan
        from tpu_tts_torch.vocoder.models.melgan_generator import MelganGenerator
        from tpu_tts_torch.vocoder.models.vocoder_convert import gan_state_dict_from_flax

        kw = dict(in_channels=MELS, base_channels=64, upsample_factors=(2, 2, 2, 2), num_res_blocks=2)
        jg = JaxMelgan(**kw)
        params = randomize(flax_param_shapes(jg, jnp.zeros((1, 8, MELS))), 31)
        jm = type("JaxGen", (), {"params": {"generator": params}, "pqmf": None,
                                 "_gen_apply": staticmethod(lambda p, m: jg.apply({"params": p}, m))})()
        pm = type("PortGen", (), {})()
        pm.model_g = MelganGenerator(**kw).eval()
        sd = gan_state_dict_from_flax({"generator": params}, "melgan_generator", 4)
        pm.model_g.load_state_dict({k[len("model_g."):]: v for k, v in sd.items()}, strict=True)
        pm.inference = lambda mel: pm.model_g(torch.from_numpy(mel).transpose(1, 2)).transpose(1, 2).detach().numpy()
        pm.pqmf = None
    _check_generator(jm, pm, 14, 16, pad=2)
    if pm.pqmf is not None:
        wav = np.random.default_rng(3).standard_normal((2, 256, 1)).astype(np.float32)
        assert max_err(pm.pqmf.analysis(torch.from_numpy(wav).transpose(1, 2)).transpose(1, 2),
                       jm.pqmf.analysis(jnp.asarray(wav))) <= 1e-5


def test_univnet_generator_matches_jax():
    """A tiny UnivNet (two LVC blocks) with its noise given, against the flax one."""
    from tpu_tts.vocoder.models.univnet_generator import UnivnetGenerator as JaxUnivnet
    from tpu_tts_torch.vocoder.models.univnet_generator import UnivnetGenerator
    from tpu_tts_torch.vocoder.models.vocoder_convert import gan_state_dict_from_flax

    kw = dict(in_channels=8, hidden_channels=4, cond_channels=MELS, upsample_factors=(4, 4),
              lvc_layers_each_block=2, kpnet_hidden_channels=8)
    mel, z = _mel(6, 4), np.random.default_rng(5).standard_normal((2, 6, 8)).astype(np.float32)
    jg = JaxUnivnet(**kw)
    params = randomize(flax_param_shapes(jg, jnp.asarray(mel), z=jnp.asarray(z)), 6)
    ref = jax.jit(lambda p, c, z: jg.apply({"params": p}, c, z=z))(params, mel, z)
    pg = UnivnetGenerator(**kw).eval()
    sd = gan_state_dict_from_flax({"generator": params}, "univnet_generator")
    pg.load_state_dict({k[len("model_g."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pg(torch.from_numpy(mel).transpose(1, 2), z=torch.from_numpy(z).transpose(1, 2))
    assert float(np.std(np.asarray(ref))) > 1e-3
    assert max_err(got.transpose(1, 2), ref) <= 1e-5


# -------------------------------------------------------------------- losses
def test_losses_match_jax():
    """Every loss on fixed arrays: the STFT losses (an odd FFT size among
    them), the L1 mel and magnitude losses, the MSE and hinge terms, feature
    matching, and the composite G (the subband term's row-major reshape
    included) and D losses; the JAX values in one jitted program."""
    from tpu_tts.vocoder.configs import MultibandMelganConfig as JaxConfig
    from tpu_tts.vocoder.layers import losses as jl
    from tpu_tts_torch.vocoder.configs import MultibandMelganConfig
    from tpu_tts_torch.vocoder.layers import losses as pl

    rng = np.random.default_rng(7)
    arrays = {"y": 0.3 * rng.standard_normal((2, 300)), "y_hat": 0.3 * rng.standard_normal((2, 300)),
              "sub": rng.standard_normal((2, 75, 4)), "sub_hat": rng.standard_normal((2, 75, 4)),
              **{f"s{i}": rng.standard_normal((2, n)) for i, n in enumerate((5, 9))},
              **{f"r{i}": rng.standard_normal((2, n)) for i, n in enumerate((5, 9))},
              **{f"f{d}{i}": rng.standard_normal((2, 3, n)) for d in range(2) for i, n in enumerate((7, 4))},
              **{f"fr{d}{i}": rng.standard_normal((2, 3, n)) for d in range(2) for i, n in enumerate((7, 4))}}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    flags = dict(use_stft_loss=True, use_subband_stft_loss=True, use_mse_gan_loss=True, use_hinge_gan_loss=True,
                 use_feat_match_loss=True, use_l1_spec_loss=True, hinge_G_loss_weight=0.5, l1_spec_loss_weight=3.0,
                 stft_loss_params=TINY_MB["stft_loss_params"],
                 subband_stft_loss_params=TINY_MB["subband_stft_loss_params"])
    jc, pc = JaxConfig(**flags), MultibandMelganConfig(**flags)
    for c in (jc, pc):
        c.audio.fft_size, c.audio.win_length, c.audio.hop_length = 64, 64, 16
    l1_kw = [dict(sample_rate=8000, n_fft=64, hop_length=16, win_length=64, num_mels=10, fmin=0.0, fmax=None,
                  use_mel=use_mel) for use_mel in (True, False)]

    def values(lib, a, cfg, ch_first):
        """Every loss of `lib` (the JAX or the port module) on the arrays `a`."""
        scores, scores_r = [a["s0"], a["s1"]], [a["r0"], a["r1"]]
        feats = [[a[f"f{d}0"], a[f"f{d}1"]] for d in range(2)]
        feats_r = [[a[f"fr{d}0"], a[f"fr{d}1"]] for d in range(2)]
        out = {}
        for n_fft, hop, win in ((64, 16, 48), (57, 12, 40)):
            out[f"stft{n_fft}"] = lib.stft_loss(a["y_hat"], a["y"], n_fft, hop, win)
        out["multi_scale"] = lib.multi_scale_stft_loss(a["y_hat"], a["y"])
        for kw in l1_kw:
            out[f"l1_{kw['use_mel']}"] = lib.l1_spec_loss(a["y_hat"], a["y"], **kw)
        out["mse_G"], out["hinge_G"] = lib.mse_G_loss(scores), lib.hinge_G_loss(scores)
        out["mse_D"], out["hinge_D"] = lib.mse_D_loss(scores, scores_r), lib.hinge_D_loss(scores, scores_r)
        out["feat"] = lib.feature_matching_loss(feats, feats_r)
        wav = (lambda y: y[:, None]) if ch_first else (lambda y: y[:, :, None])
        bands = (lambda b: b.transpose(1, 2)) if ch_first else (lambda b: b)
        out["G"] = lib.generator_loss(lib.GeneratorLossConfig(cfg), y_hat=wav(a["y_hat"]), y=wav(a["y"]),
                                      scores_fake=scores, feats_fake=feats, feats_real=feats_r,
                                      y_hat_sub=bands(a["sub_hat"]), y_sub=bands(a["sub"]))
        out["D"] = lib.discriminator_loss(cfg, scores, scores_r)
        return out

    want = jax.device_get(jax.jit(lambda a: values(jl, a, jc, False))(arrays))
    got = values(pl, {k: torch.from_numpy(v) for k, v in arrays.items()}, pc, True)
    w_leaves, w_tree = jax.tree_util.tree_flatten(want)
    g_leaves, g_tree = jax.tree_util.tree_flatten(jax.tree.map(float, got))
    assert w_tree == g_tree and len(w_leaves) > 30
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), g_leaves):
        assert abs(g - float(w)) <= 1e-6 * max(1.0, abs(float(w))), (jax.tree_util.keystr(path), g, float(w))


# -------------------------------------------------------------- checkpoints
def _coqui_layout(sd, plain=()):
    """A port state dict in Coqui's layouts: old-style weight norm
    `weight_g`/`weight_v`, a plain folded `weight` for the modules named in
    `plain`, and spectral norm as `parametrizations.weight.original` with its
    power iteration's `_u`/`_v` vectors."""
    out = {}
    for k, v in sd.items():
        base = k.split(".parametrizations.weight.")[0]
        if k.startswith("model_d.msd.discriminators.0.") and k.endswith(".weight"):
            out[k[: -len("weight")] + "parametrizations.weight.original"] = v
            out[k[: -len("weight")] + "parametrizations.weight.0._u"] = torch.ones(v.shape[0])
            out[k[: -len("weight")] + "parametrizations.weight.0._v"] = torch.ones(v[0].numel())
        elif ".parametrizations.weight.original" not in k:
            out[k] = v
        elif any(base.endswith(p) for p in plain):
            if k.endswith("original1"):
                g = sd[f"{base}.parametrizations.weight.original0"]
                out[f"{base}.weight"] = v * (g / v.flatten(1).norm(dim=1).reshape(g.shape))
        else:
            out[f"{base}.weight_{'g' if k.endswith('original0') else 'v'}"] = v
    return out


def _effective(tree, prefix=""):
    """A flax param tree with each weight-norm pair folded into its kernel."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "v" in v and "g" in v:
            vv = np.asarray(v["v"], np.float64)
            out[path] = vv / np.sqrt(np.sum(vv**2, axis=(0, 1), keepdims=True) + 1e-12) * np.asarray(v["g"])
            out.update({f"{path}/{n}": np.asarray(x) for n, x in v.items() if n not in ("v", "g")})
        elif isinstance(v, dict):
            out.update(_effective(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.mark.parametrize("pair", ["hifigan", "multiband"])
def test_coqui_keys_round_trip(pair, tmp_path):
    """The port's state dict carries Coqui's names: through the JAX
    converter (`convert_gan_torch_state_dict`) it gives back the JAX
    generator. Written in Coqui's older layouts (old-style weight norm; a
    generator-only file with a plain `conv_pre` weight) it loads into a
    fresh port model that then vocodes as the original does."""
    from tpu_tts.vocoder.models.vocoder_convert import convert_gan_torch_state_dict
    from tpu_tts_torch.vocoder.models import setup_model

    jm, pm = hifigan_pair() if pair == "hifigan" else multiband_pair()
    name = pm.config.generator_model
    sd = {k: v.detach() for k, v in pm.net.state_dict().items()}
    full = _coqui_layout(sd)
    gen_only = _coqui_layout({k[len("model_g."):]: v for k, v in sd.items() if k.startswith("model_g.")},
                             plain=("conv_pre", "layers.1"))
    back = convert_gan_torch_state_dict({k: v.numpy() for k, v in sd.items() if k.startswith("model_g.")},
                                        generator_name=name)
    want, have = _effective(jm.params["generator"]), _effective(back["generator"])
    if pair == "hifigan":  # the JAX converter zero-fills the bias `conv_post_bias=False` leaves out
        assert not have.pop("conv_post/bias").any()
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-5, err_msg=k)
    mel = _mel(14, 12)
    ref = pm.inference(mel)
    for sd, has_disc in ((full, True),) if pair == "hifigan" else ((full, True), (gen_only, False)):
        torch.save({"model": sd, "step": 3}, tmp_path / "coqui.pth")
        fresh = setup_model(pm.config, device="cpu")
        disc_before = {k: v.clone() for k, v in fresh.model_d.state_dict().items()}
        fresh.load_checkpoint(pm.config, str(tmp_path / "coqui.pth"))
        assert max_err(fresh.inference(mel), ref) <= 1e-5
        disc_now = fresh.model_d.state_dict()
        loaded = all(torch.equal(disc_now[k], v) for k, v in pm.model_d.state_dict().items())
        assert loaded == has_disc
        if not has_disc:
            assert all(torch.equal(disc_now[k], v) for k, v in disc_before.items())


# ------------------------------------------------------------------ dataset
def test_gan_dataset_matches_jax(tmp_path):
    """`GANDataset` with noise off: the eval window of each clip, its mel and
    the padding of a clip shorter than `seq_len + pad_short` against
    `tpu_tts`'s; training windows are `seq_len` long slices of the padded
    clip, repeatable per (seed, epoch, item)."""
    import scipy.io.wavfile

    from tpu_tts.audio import AudioProcessor as JaxAP
    from tpu_tts.vocoder.datasets.gan_dataset import GANDataset as JaxDataset
    from tpu_tts_torch.audio import AudioProcessor
    from tpu_tts_torch.vocoder.datasets import load_wav_data
    from tpu_tts_torch.vocoder.datasets.gan_dataset import GANDataLoader, GANDataset

    rng = np.random.default_rng(13)
    for i, n in enumerate((3000, 700, 5000)):
        scipy.io.wavfile.write(tmp_path / f"c{i}.wav", 22050, (0.3 * rng.standard_normal(n) * 32767).astype(np.int16))
    train, evals = load_wav_data(str(tmp_path), 1)
    items = sorted(train + evals)
    kw = dict(items=items, seq_len=1024, hop_len=16, pad_short=100, conv_pad=0, use_noise_augment=False,
              use_cache=True)
    jd = JaxDataset(ap=JaxAP(verbose=False, **_audio()), is_training=False, **kw)
    pd = GANDataset(ap=AudioProcessor(**_audio()), is_training=False, **kw)
    for i in range(len(items)):
        a, b = jd[i], pd[i]
        np.testing.assert_array_equal(a["waveform"], b["waveform"])
        assert max_err(a["mel"], b["mel"]) <= 1e-5
    a, b = jd.collate([jd[i] for i in range(3)]), pd.collate([pd[i] for i in range(3)])
    assert {k: v.shape for k, v in a.items()} == {k: tuple(v.shape) for k, v in b.items()}
    assert a["mel_input"].shape == (3, 64, MELS) and a["waveform"].shape == (3, 1024, 1)

    train_set = GANDataset(ap=AudioProcessor(**_audio()), is_training=True, seed=4, **kw)
    loader = GANDataLoader(train_set, batch_size=2, seed=4)
    loader.set_epoch(1)
    first = [b["waveform"] for b in loader]
    assert len(first) == 1 and torch.equal(first[0], next(iter(loader))["waveform"])
    for i in range(len(items)):
        wav, seg = train_set._load_wav(i), train_set[i]["waveform"]
        assert len(seg) == 1024 and any(np.array_equal(wav[s: s + 1024], seg) for s in range(len(wav) - 1023))


# -------------------------------------------------------------- Synthesizer
def test_synthesizer_glow_hifigan_matches_jax(tmp_path):
    """Glow-TTS → a tiny HiFi-GAN through the port's `Synthesizer` (Coqui
    `.pth` files beside their configs; the vocoder's audio at another rate
    and level) against `tpu_tts`'s vocoder stage on the port's own mel (the
    Glow-TTS mel is held to JAX in `tests/test_torch_port_glow.py`): the
    denormalize → normalize handshake, `_interpolate_mel` and
    `GAN.inference`."""
    from tests.test_torch_port_glow import TEXT, port_glow_config
    from tpu_tts.audio import AudioProcessor as JaxAP
    from tpu_tts.infer.synthesizer import _interpolate_mel
    from tpu_tts_torch.infer.synthesis import synthesis
    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP, Synthesizer
    from tpu_tts_torch.models.glow_tts import GlowTTS

    jv, pv = hifigan_pair()
    torch.manual_seed(0)
    pg = GlowTTS.init_from_config(port_glow_config(), device="cpu")
    with torch.no_grad():
        pg.net.encoder.duration_predictor.proj.bias.fill_(1.2)  # 2-5 frames a token
    torch.save(pg.net.state_dict(), tmp_path / "glow.pth")
    pg.config.save_json(str(tmp_path / "glow.json"))
    torch.save({"model": {k: v for k, v in pv.net.state_dict().items() if k.startswith("model_g.")}},
               tmp_path / "vocoder.pth")
    voc_config = copy.deepcopy(pv.config)
    voc_config.audio.sample_rate, voc_config.audio.ref_level_db = 24000, 25
    voc_config.save_json(str(tmp_path / "vocoder.json"))
    synth = Synthesizer(str(tmp_path / "glow.pth"), str(tmp_path / "glow.json"), str(tmp_path / "vocoder.pth"),
                        str(tmp_path / "vocoder.json"), device="cpu")
    wav = np.asarray(synth.tts(TEXT), dtype=np.float32)

    mel = synthesis(synth.tts_model, TEXT, synth.tts_config)["model_outputs"]
    voc_ap = JaxAP(verbose=False, **voc_config.audio.to_dict())
    tts_ap = JaxAP(verbose=False, **synth.tts_config.audio.to_dict())
    vocoder_input = _interpolate_mel(voc_ap.normalize(tts_ap.denormalize(mel.T)).T, 24000 / 22050)
    ref = np.asarray(jv.inference(vocoder_input.astype(np.float32)))[0, :, 0]
    assert synth.output_sample_rate == 24000 and float(np.std(ref)) > 1e-3
    assert len(wav) == len(ref) + SENTENCE_GAP == vocoder_input.shape[0] * 16 + SENTENCE_GAP
    assert max_err(wav[: len(ref)], ref) <= 2e-4
