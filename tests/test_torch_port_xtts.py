"""The port's XTTS-v2 against `tpu_tts` on the CPU, at the JAX fixture's
widths (2 GPT layers, 32 wide; the decoder at its fixed 512 → 256 → 128),
with seeded weights carried across by `models/xtts_convert.py`.

Tolerances: the GPT, conditioning and greedy latents within 1e-4 (float32
sums in another order); the decoder's waveform within 2e-4, the bar of
`tests/test_hifigan_pallas.py`. Greedy codes must equal JAX's, or where they
first part, the port's pick must score within 1e-4 of JAX's best logit at
that step (a near-tie flip), and the waveforms are compared up to there.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import XTTS_ARGS, cached_flax_shape_check, jax_xtts, max_err, port_xtts, seeded, speaker_wav

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer


@pytest.fixture(scope="module")
def models():
    return jax_xtts(), port_xtts()


def _cond(models, seed):
    jm, pm = models
    wav = speaker_wav(seed)
    jc, js = jm.get_conditioning_latents(wav)
    pc, ps = pm.get_conditioning_latents(wav)
    return (jc, js), (pc, ps)


def test_conditioning_matches_jax(models):
    (jc, js), (pc, ps) = _cond(models, 1)
    assert tuple(pc.shape) == (1, 4, 32) and tuple(ps.shape) == (1, 16)
    assert max_err(pc, jc) <= 1e-4
    assert max_err(ps, js) <= 1e-4
    assert abs(float(ps.norm()) - 1.0) <= 1e-5


def test_gpt_prefill_and_decode_steps_match_jax(models):
    """A right-padded two-row prompt (text lengths 6 and 9, conditioning
    lengths 4 and 3), then greedy chunks through `stream_chunk`: two steps,
    then four with row 1 joining the timeline at step 2 (`audio_start`).
    The prefilled cache rows, every code and every latent against JAX."""
    from tpu_tts.models.xtts import XttsNet

    jm, pm = models
    rng = np.random.default_rng(4)
    cond = (rng.standard_normal((2, 4, 32)) * 0.5).astype(np.float32)
    text = np.zeros((2, 32), np.int32)
    text[0, :6], text[1, :9] = rng.integers(1, 48, 6), rng.integers(1, 48, 9)
    tl, cl, ast = np.array([6, 9], np.int32), np.array([4, 3], np.int32), np.array([0, 2], np.int32)

    def run(p, cond, text, tl, cl, ast):
        apply = lambda *a, **k: jm.net.apply({"params": p}, *a, **k)  # noqa: E731
        cache, plen, code = apply(cond, text, tl, cl, method=XttsNet.stream_prefill)
        prefill = [c[0] for c in cache]
        stopped, key = jnp.zeros((2,), bool), jax.random.PRNGKey(0)
        (cache, code, stopped, key), (c1, l1, _) = apply(cache, plen, code, stopped, key, 0, 2, 1.0, 1, tl, 4, cl,
                                                          jnp.zeros_like(ast), method=XttsNet.stream_chunk)
        (cache, code, stopped, key), (c2, l2, _) = apply(cache, plen, code, stopped, key, 2, 4, 1.0, 1, tl, 4, cl, ast,
                                                          method=XttsNet.stream_chunk)
        return prefill, jnp.concatenate([c1, c2], 1), jnp.concatenate([l1, l2], 1)

    j_prefill, j_codes, j_lats = jax.jit(run)(jm.params, cond, text, tl, cl, ast)

    net, t = pm.net, torch.from_numpy
    gen = torch.Generator().manual_seed(0)
    cache, plen, code = net.stream_prefill(t(cond), t(text).long(), t(tl).long(), t(cl).long())
    assert plen == 36 and tuple(cache.shape) == (2, 2, 128, 2, 2, 16)
    for layer in range(2):
        assert max_err(cache[layer, 0, :plen], np.asarray(j_prefill[layer])[:plen]) <= 1e-4
    stopped = torch.zeros(2, dtype=torch.bool)
    (cache, code, stopped), (c1, l1, _) = net.stream_chunk(cache, plen, code, stopped, gen, 0, 2, 1.0, 1, t(tl).long(),
                                                           4, t(cl).long(), torch.zeros(2, dtype=torch.long))
    (cache, code, stopped), (c2, l2, _) = net.stream_chunk(cache, plen, code, stopped, gen, 2, 4, 1.0, 1, t(tl).long(),
                                                           4, t(cl).long(), t(ast).long())
    np.testing.assert_array_equal(torch.cat([c1, c2], 1).numpy(), np.asarray(j_codes))
    assert len(set(np.asarray(j_codes).ravel().tolist())) > 2
    assert max_err(torch.cat([l1, l2], 1), j_lats) <= 1e-4


@pytest.mark.parametrize("padded", [False, True])
def test_incremental_decode_matches_teacher_forced(models, padded):
    """Logits of decode step t (code t fed at audio position t) equal the
    teacher-forced forward's mel logits at t; with `padded`, over a prompt
    right-padded with a non-zero id and key-masked."""
    _, pm = models
    net = pm.net
    rng = np.random.default_rng(6)
    cond = torch.from_numpy((rng.standard_normal((1, 4, 32)) * 0.5).astype(np.float32))
    text = torch.arange(1, 7)[None]
    codes = torch.from_numpy(rng.integers(0, 32, (1, 6)))
    with torch.no_grad():
        ref = net.gpt(cond, text, codes)["mel_logits"]
    lengths = key_valid = None
    if padded:
        lengths = torch.tensor([6])
        text = torch.cat([text, torch.full((1, 10), 17)], 1)
    cache, plen, _ = net.stream_prefill(cond, text, lengths)
    if padded:
        key_valid = net.gpt.key_valid_mask(4, plen, lengths, cache.shape[2])
    with torch.no_grad():
        for step in range(6):
            logits, latent, cache = net.gpt.decode_step(codes[:, step], step, cache, plen + step, key_valid)
            assert tuple(latent.shape) == (1, 32)
            assert max_err(logits, ref[:, step]) <= 1e-4, step


def test_stream_chunks_reproduce_generate_latents(models):
    """The chunked path draws what the one-loop decode draws (one generator
    carried across chunks), sampled at top_k 5."""
    (_, _), (pc, _) = _cond(models, 2)
    _, pm = models
    text, tl = pm._bucket_text(torch.arange(1, 7)[None])
    codes_f, lats_f, _ = pm.net.generate_latents(pc, text, torch.Generator().manual_seed(7), 24, 0.75, 5, tl)
    cache, plen, code = pm.net.stream_prefill(pc, text, tl)
    stopped, gen, codes, lats = torch.zeros(1, dtype=torch.bool), torch.Generator().manual_seed(7), [], []
    for i0 in range(0, 24, 8):
        (cache, code, stopped), (c, lat, _) = pm.net.stream_chunk(cache, plen, code, stopped, gen, i0, 8, 0.75, 5, tl,
                                                                  4)
        codes.append(c)
        lats.append(lat)
    assert torch.equal(torch.cat(codes, 1), codes_f)
    assert max_err(torch.cat(lats, 1), lats_f) == 0.0


def test_decode_latents_with_conds_matches_jax(models):
    """Two rows of latents, each with its own speaker embedding on
    `cond_layer` and every `conds.{i}`, through the interpolations and the
    decoder (the plain MRF on the CPU)."""
    from tpu_tts.models.xtts import XttsNet

    jm, pm = models
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 12, 32)).astype(np.float32)
    spk = rng.standard_normal((2, 16)).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=1, keepdims=True)
    ref = jax.jit(lambda p, lt, s: jm.net.apply({"params": p}, lt, s, method=XttsNet.decode_latents))(
        jm.params, lat, spk)
    got = pm.net.decode_latents(torch.from_numpy(lat), torch.from_numpy(spk))
    assert tuple(got.shape) == tuple(np.asarray(ref).shape[:2]) == (2, 52 * 16)  # 12 → 48 → 52 frames, hop 16
    assert max_err(got, np.asarray(ref)[:, :, 0]) <= 2e-4
    swapped = pm.net.decode_latents(torch.from_numpy(lat), torch.from_numpy(spk[::-1].copy()))
    assert max_err(swapped, got) > 1e-3  # the speaker moves the waveform


@pytest.mark.parametrize("scale", [2.0, 24000 / 22050])
def test_linear_interp_matches_jax(scale):
    """The decoder's interpolation against JAX's `_torch_linear_interp`,
    at lengths where floor(T·scale) == T at the sample-rate step (there
    `F.interpolate` would return its input unchanged) and beyond; within
    1e-5 (float32 source positions and weights, rounded in another
    order)."""
    from tpu_tts.models.xtts import _torch_linear_interp

    from tpu_tts_torch.models.xtts import linear_interp

    rng = np.random.default_rng(5)
    interp = jax.jit(_torch_linear_interp, static_argnums=1)
    for T in (2, 8, 11, 12):
        x = rng.standard_normal((2, T, 3)).astype(np.float32)
        ref = np.asarray(interp(x, scale))
        got = linear_interp(torch.from_numpy(x).transpose(1, 2), scale).transpose(1, 2)
        assert tuple(got.shape) == ref.shape and max_err(got, ref) <= 1e-5, T


def _jax_best_logit_gap(jm, cond, ids, j_codes, p_codes):
    """(steps equal, gap): where the codes first part, how far the port's
    pick scores below JAX's best logit there (teacher-forced JAX)."""
    diff = np.nonzero(np.asarray(j_codes)[0] != np.asarray(p_codes)[0])[0]
    if diff.size == 0:
        return len(j_codes[0]), 0.0
    t = int(diff[0])
    prev = np.concatenate([[jm.args.gpt_start_audio_token], np.asarray(j_codes)[0, :t]])[None].astype(np.int32)
    out = jm.net.apply({"params": jm.params}, jnp.asarray(cond), jnp.asarray(ids), jnp.asarray(prev),
                       method=lambda m, c, x, a: m.gpt(c, x, a))
    logits = np.asarray(out["mel_logits"])[0, t]
    return t, float(logits.max() - logits[int(np.asarray(p_codes)[0, t])])


def test_greedy_inference_matches_jax(models):
    jm, pm = models
    (jc, js), (pc, ps) = _cond(models, 3)
    ids = np.arange(1, 9, dtype=np.int32)[None]
    ref = jm.inference(text_tokens=jnp.asarray(ids), gpt_cond_latent=jc, speaker_embedding=js, max_new_tokens=24,
                       top_k=1)
    got = pm.inference(text_tokens=ids, gpt_cond_latent=pc, speaker_embedding=ps, max_new_tokens=24, top_k=1)
    assert got["gpt_codes"].shape == ref["gpt_codes"].shape == (1, 24)
    agree, gap = _jax_best_logit_gap(jm, jc, ids, ref["gpt_codes"], got["gpt_codes"])
    assert gap <= 1e-4
    assert len(set(ref["gpt_codes"][0, :agree].tolist())) > 2
    n = min(pm._n_samples(agree), ref["wav"].size, got["wav"].size)
    if agree == 24:
        assert got["wav"].shape == ref["wav"].shape
    assert max_err(got["wav"][:n], ref["wav"][:n]) <= 2e-4


def test_greedy_inference_stream_matches_jax(models):
    """Chunk for chunk (first chunk, then chunks with 2 latents of overlap
    context, a budget that ends mid-chunk), the port's stream against JAX's."""
    jm, pm = models
    (jc, js), (pc, ps) = _cond(models, 4)
    tokens = list(range(1, 7))
    jm.bpe.encode = lambda text, lang: tokens
    kw = dict(stream_chunk_size=8, first_chunk_size=8, overlap_latents=2, max_new_tokens=20, top_k=1)
    ref = list(jm.inference_stream("x", "en", gpt_cond_latent=jc, speaker_embedding=js, **kw))
    got = list(pm.inference_stream(text_tokens=tokens, gpt_cond_latent=pc, speaker_embedding=ps, **kw))
    assert [c.size for c in got] == [c.size for c in ref] and len(ref) == 3
    for g, r in zip(got, ref):
        assert max_err(g, r) <= 2e-4


def test_stream_chunk_shorter_than_overlap_raises(models):
    """JAX's overlap tail shrinks when a chunk is shorter than the overlap
    (`tpu_tts/models/xtts.py`:854): the port refuses that configuration."""
    _, pm = models
    for kw in (dict(stream_chunk_size=2, first_chunk_size=8), dict(stream_chunk_size=8, first_chunk_size=2)):
        with pytest.raises(ValueError, match="overlap_latents"):
            next(pm.inference_stream(text_tokens=[1, 2, 3], gpt_cond_latent=np.zeros((1, 4, 32), np.float32),
                                     speaker_embedding=np.zeros((1, 16), np.float32), overlap_latents=4, **kw))


def test_coqui_keys_round_trip(models, tmp_path):
    """The port's state dict carries Coqui's XTTS-v2 names: through the JAX
    converter it gives back the JAX params (folded weight-norm kernels
    compared). Rewritten into Coqui's own layout (old-style weight norm, a
    plain `conv_pre`/`conv_post` without bias, the decoder-side speaker
    encoder, a seeded 64 → 512 ResNet, instead of `speaker_proj`, with
    its spectrogram front end's buffers) it loads into the port, serves the
    same waveform, and clones from a wav as JAX's converted model does:
    the conditioning latents and the speaker encoder's embedding within
    1e-5."""
    from tpu_tts.models.xtts_convert import convert_xtts_torch_state_dict
    from tpu_tts_torch.configs.xtts_config import XttsArgs, XttsConfig
    from tpu_tts_torch.models.xtts import Xtts

    jm, pm = models
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    back = convert_xtts_torch_state_dict(sd)

    def effective(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) and "v" in v and "g" in v:
                norm = np.sqrt(np.sum(np.asarray(v["v"], np.float64) ** 2, axis=(0, 1), keepdims=True))
                out[path] = np.asarray(v["v"]) / norm * np.asarray(v["g"])
                out.update({f"{path}/{n}": np.asarray(x) for n, x in v.items() if n not in ("v", "g")})
            elif isinstance(v, dict):
                out.update(effective(v, path))
            else:
                out[path] = np.asarray(v)
        return out

    want = {k: v for k, v in effective(jax.tree.map(np.asarray, jm.params)).items() if not k.startswith("speaker_proj")}
    have = effective(back)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-5, err_msg=k)

    coqui, dec = {}, pm.net.hifigan_decoder["waveform_decoder"]
    for k, v in pm.net.state_dict().items():
        plain = re.search(r"waveform_decoder\.(conv_pre|conv_post)\.parametrizations\.weight\.original0$", k)
        if plain:
            conv = plain.group(1)
            coqui[f"hifigan_decoder.waveform_decoder.{conv}.weight"] = getattr(dec, conv).parametrizations["weight"]()
        elif not (k.startswith("speaker_proj.") or k.endswith("conv_post.bias") or ".original1" in k and (
                ".conv_pre." in k or ".conv_post." in k)):
            coqui[k.replace(".parametrizations.weight.original0", ".weight_g")
                  .replace(".parametrizations.weight.original1", ".weight_v")] = v
    coqui = {k: v.detach().clone() for k, v in coqui.items()}
    from tpu_tts_torch.encoder.models import ResNetSpeakerEncoder

    encoder = seeded(ResNetSpeakerEncoder(input_dim=64, proj_dim=512, norm_type="frozen_batch"), 9)
    coqui.update({f"hifigan_decoder.speaker_encoder.{k}": v.clone() for k, v in encoder.state_dict().items()})
    coqui["hifigan_decoder.speaker_encoder.torch_spec.1.mel_scale.fb"] = torch.ones(257, 64)  # Coqui's front end
    coqui["gpt.gpt.h.0.attn.bias"] = torch.ones(1, 1, 8, 8)  # GPT-2's causal-mask buffer
    path = tmp_path / "coqui.pth"
    torch.save({"model": coqui, "step": 0}, path)
    other = Xtts(XttsConfig(model_args=XttsArgs(**XTTS_ARGS)), device="cpu")
    other.load_checkpoint(other.config, str(path))
    assert other.net.use_ref_speaker_encoder and not hasattr(other.net, "speaker_proj")
    post = other.net.hifigan_decoder["waveform_decoder"].conv_post
    assert float(post.bias.detach().abs().max()) == 0.0  # Coqui's conv_post has no bias
    with torch.no_grad():
        post.bias.copy_(dec.conv_post.bias)
    lat, spk = torch.randn(1, 6, 32), torch.nn.functional.normalize(torch.randn(1, 16), dim=-1)
    assert max_err(other.net.decode_latents(lat, spk), pm.net.decode_latents(lat, spk)) <= 1e-5

    from tpu_tts.configs.xtts_config import XttsConfig as JaxXttsConfig
    from tpu_tts.models.xtts import Xtts as JaxXtts
    from tpu_tts.models.xtts import XttsArgs as JaxXttsArgs

    cfg = JaxXttsConfig()
    cfg.model_args = JaxXttsArgs(**XTTS_ARGS)
    ref_model = JaxXtts(cfg)
    ref_model.params = ref_model.convert_torch_state_dict({k: v.numpy() for k, v in coqui.items()})
    wav = speaker_wav(0)
    ref_cond, ref_spk = ref_model.get_conditioning_latents(wav, sr=22050)
    cond, spk = other.get_conditioning_latents(wav, sr=22050)
    assert spk.shape == (1, 512) and abs(float(spk.norm()) - 1.0) <= 1e-5
    assert max_err(cond, ref_cond) <= 1e-5 and max_err(spk, ref_spk) <= 1e-5
    assert max_err(other.get_conditioning_latents(speaker_wav(1), sr=22050)[1], spk) > 1e-2  # another voice
