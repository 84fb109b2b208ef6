"""The port's XTTS stream pool and `/api/tts_stream` on the CPU.

The invariants of `tests/test_xtts_pool.py` on the port's pool: with greedy
decoding (top_k=1) each pooled stream is its solo `Xtts.inference_stream`
(itself held to JAX in `test_torch_port_xtts.py`), across mixed text
lengths, compaction, mid-round admission, conditioning-width buckets, a
timeline rebase and a budget that ends mid-chunk; a starved request seeds
the next round. The port's pool against `tpu_tts`'s on the same greedy
requests (mixed lengths, a mid-round admission, a budget below a chunk):
equal codes, each chunk within 2e-4. Then the server's XTTS routes and
the model-directory load. The model is the JAX fixture's with a cheaper
decoder (upsampling 2 × 2, one GPT token → 2 latent frames), weights from
a numpy seed through the bridge. Pooled and solo waveforms agree within
1e-5 (the same float32 math at another batch size).
"""

import argparse
import copy
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tests.torch_port_common import cached_flax_shape_check, max_err, port_xtts, speaker_wav

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("cached_flax_shape_check")  # flax checks each param shape once per initializer

CHEAP = dict(decoder_upsample_rates=(2, 2), gpt_code_stride=512)
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return port_xtts(**CHEAP)


def _cond(model, seed):
    return model.get_conditioning_latents(speaker_wav(seed))


def _solo(model, tokens, cond, max_new_tokens=20, **kw):
    c, s = cond
    kw = {"stream_chunk_size": 8, "first_chunk_size": 4, **kw}
    return np.concatenate(list(model.inference_stream(text_tokens=tokens, gpt_cond_latent=c, speaker_embedding=s,
                                                      max_new_tokens=max_new_tokens, top_k=1, **kw)))


def _pool(model, **kw):
    from tpu_tts_torch.infer.xtts_pool import XttsStreamPool

    kw = {"max_streams": 3, "stream_chunk_size": 8, "first_chunk_size": 4, "max_new_tokens": 20, "top_k": 1,
          "gather_window_s": 0.3, **kw}
    return XttsStreamPool(model, **kw)


def _submit(pool, tokens, cond, **kw):
    return pool.submit(text_tokens=tokens, gpt_cond_latent=cond[0], speaker_embedding=cond[1], **kw)


TOK = np.arange(1, 7)


def test_pool_matches_single_stream(model):
    cond = _cond(model, 1)
    single = _solo(model, TOK, cond)
    pool = _pool(model)
    try:
        its = [_submit(pool, TOK, c) for c in (_cond(model, 7), cond, _cond(model, 9))]
        outs = [np.concatenate(list(it)) for it in its]
    finally:
        pool.close()
    assert pool.rounds_served == 1
    assert all(np.isfinite(o).all() and o.size > 0 for o in outs)
    assert outs[1].shape == single.shape and max_err(outs[1], single) <= TOL
    solo_codes = model.inference(text_tokens=TOK, gpt_cond_latent=cond[0], speaker_embedding=cond[1],
                                 max_new_tokens=20, top_k=1)["gpt_codes"][0]
    assert its[1].codes == solo_codes[: len(its[1].codes)].tolist() and len(its[1].codes) == 20
    n = min(outs[0].size, outs[1].size)
    assert max_err(outs[0][:n], outs[1][:n]) > 1e-3  # other conditioning, other audio


def test_pool_mixed_lengths_batch_and_match_single(model):
    """Two text lengths of one bucket in one round; a budget of 14 ends mid
    chunk (4 + 8 + 2), so the tail's invalid latents must be zeros."""
    cond = _cond(model, 3)
    toks = [np.arange(1, 7), np.arange(1, 10)]
    singles = [_solo(model, t, cond, max_new_tokens=14) for t in toks]
    pool = _pool(model, max_new_tokens=14)
    try:
        outs = [np.concatenate(list(it)) for it in [_submit(pool, t, cond) for t in toks]]
    finally:
        pool.close()
    assert pool.rounds_served == 1
    for o, s in zip(outs, singles):
        assert o.shape == s.shape and max_err(o, s) <= TOL


def test_pool_compaction_evicts_finished_rows(model):
    """Two of four rows exhaust a 4-token budget in the first chunk; the
    round compacts to the two live rows, whose outputs stay their solo runs."""
    cond = _cond(model, 4)
    single = _solo(model, TOK, cond)
    ref_short = _solo(model, TOK, cond, max_new_tokens=4)
    pool = _pool(model, max_streams=4)
    try:
        short = [_submit(pool, TOK, c, max_tokens=4) for c in (_cond(model, 5), _cond(model, 6))]
        long_ = [_submit(pool, TOK, cond) for _ in range(2)]
        outs_short = [np.concatenate(list(it)) for it in short]
        outs_long = [np.concatenate(list(it)) for it in long_]
    finally:
        pool.close()
    assert pool.compactions >= 1
    assert all(o.size == ref_short.size and np.isfinite(o).all() for o in outs_short)
    for o in outs_long:
        assert o.shape == single.shape and max_err(o, single) <= TOL


def test_pool_mid_round_admission_matches_single(model):
    """A request arriving after the round has emitted audio joins it at the
    next chunk boundary (audio_start > 0) and matches its solo run; the
    first request's output survives the splice."""
    cond, cond2 = _cond(model, 11), _cond(model, 12)
    tok_b = np.arange(3, 11)
    solo_a, solo_b = _solo(model, TOK, cond, max_new_tokens=60), _solo(model, tok_b, cond2, max_new_tokens=20)
    pool = _pool(model, gather_window_s=0.05, max_new_tokens=60)
    try:
        it_a = _submit(pool, TOK, cond)
        first_a = next(it_a)  # the round is live
        out_b = np.concatenate(list(_submit(pool, tok_b, cond2, max_tokens=20)))
        out_a = np.concatenate([first_a] + list(it_a))
    finally:
        pool.close()
    assert pool.rounds_served == 1 and pool.admissions == 1
    assert out_a.shape == solo_a.shape and max_err(out_a, solo_a) <= TOL
    assert out_b.shape == solo_b.shape and max_err(out_b, solo_b) <= TOL


def test_pool_cond_width_bucket_mixes_refs(model):
    """A two-reference request (8 stacked latents) and a one-reference one
    share a round; the narrow row is padded and masked by `cond_lengths`."""
    cond1 = _cond(model, 13)
    c_a, s_a = _cond(model, 14)
    c_b, _ = _cond(model, 15)
    cond2 = (torch.cat([c_a, c_b], dim=1), s_a)
    solos = [_solo(model, TOK, c) for c in (cond1, cond2)]
    pool = _pool(model)
    try:
        outs = [np.concatenate(list(it)) for it in [_submit(pool, TOK, c) for c in (cond1, cond2)]]
    finally:
        pool.close()
    assert pool.rounds_served == 1, "1-ref and 2-ref requests must share a round"
    for o, s in zip(outs, solos):
        assert o.shape == s.shape and max_err(o, s) <= TOL


def test_pool_starved_request_seeds_next_round(model):
    from tpu_tts_torch.infer.xtts_pool import _Request

    pool = _pool(model)
    try:
        short, long_ = _Request(np.arange(1, 7), None, None), _Request(np.arange(1, 41), None, None)
        long_.deferrals = pool.max_deferrals
        pending, batch, bucket = pool._select_round([short, long_])
        assert batch == [long_] and bucket == 64 and pending == [short]
        long2 = _Request(np.arange(1, 41), None, None)
        pending, batch, bucket = pool._select_round([short, long2])
        assert batch == [short] and bucket == 32 and long2.deferrals == 1
    finally:
        pool.close()


def test_pool_timeline_rebase_keeps_outputs_exact(model):
    """Twenty requests of 8 tokens queued at once into a round of two
    streams: each pair takes 4 + 8 steps of the shared timeline, so the pair
    admitted at step 84 of the 92 that kv_cache_len leaves after the prompt
    (128 − 36) runs its second chunk past the end. The pool rebases instead
    of draining, and every request still matches its solo run."""
    cond = _cond(model, 21)
    solo = _solo(model, TOK, cond, max_new_tokens=8)
    pool = _pool(model, max_streams=2, gather_window_s=0.3)
    try:
        its = [_submit(pool, TOK, cond, max_tokens=8) for _ in range(20)]
        outs = [np.concatenate(list(it)) for it in its]
    finally:
        pool.close()
    assert pool.rebases == 1 and pool.rounds_served == 1 and pool.admissions == 18
    for o in outs:
        assert o.shape == solo.shape and max_err(o, solo) <= TOL


# --------------------------------------------------------- against tpu_tts
def _record_jax_pool(pool):
    """`tpu_tts`'s pool exposes neither its requests nor their codes: record
    each submitted request off its input queue, and at every emission the
    codes of the latents each row stored in that chunk."""
    reqs, codes, stored, last = [], {}, {}, {}
    put, chunk_fn, emit = pool._in.put, pool._chunk_fn, pool._emit

    def record_put(req):
        if req is not None:
            reqs.append(req)
        put(req)

    def record_chunk_fn(n_steps, n_cond):
        fn = chunk_fn(n_steps, n_cond)

        def run(*args):
            out = fn(*args)
            last["codes"] = np.asarray(out[1][0])
            return out

        return run

    def record_emit(slots, done, emitted, *args, **kwargs):
        if not kwargs.get("flush"):
            for i, req in enumerate(slots):
                if req is not None:
                    n = emitted[id(req)] - stored.get(id(req), 0)
                    codes.setdefault(id(req), []).extend(last["codes"][i, :n].tolist())
                    stored[id(req)] = emitted[id(req)]
        return emit(slots, done, emitted, *args, **kwargs)

    pool._in.put, pool._chunk_fn, pool._emit = record_put, record_chunk_fn, record_emit
    return lambda: [codes.get(id(r), []) for r in reqs]


def _serve_mixed(pool, conds):
    """Two text lengths of one bucket start a round: A on the pool's budget
    of 28, and C capped at 6, below a chunk, so that its budget ends inside
    its second emission. B (8 tokens, budget 20) arrives once A's first
    chunk is out and, in a pool of two streams, takes C's slot in the live
    round once C has finished. Returns the streams in the order
    of submission (A, C, B) and each one's chunks."""
    a = _submit(pool, TOK, conds[0])
    c = _submit(pool, np.arange(1, 10), conds[2], max_tokens=6)
    first_a = next(a)
    b = _submit(pool, np.arange(3, 11), conds[1], max_tokens=20)
    return [a, c, b], [[first_a] + list(a), list(c), list(b)]


def test_pool_matches_jax_pool(model):
    """The same greedy requests through `tpu_tts`'s XttsStreamPool on the
    JAX weights and through the port's on the bridged ones, at the same
    conditioning: one round and one mid-round admission in each, equal
    codes, and each emitted chunk of each stream within 2e-4 (the
    decoder's bar against JAX)."""
    from tests.torch_port_common import jax_xtts
    from tpu_tts.infer.xtts_pool import XttsStreamPool as JaxPool

    conds = [tuple(x.numpy() for x in _cond(model, seed)) for seed in (41, 42, 43)]
    kw = {"max_streams": 2, "stream_chunk_size": 8, "first_chunk_size": 4, "max_new_tokens": 28, "top_k": 1,
          "gather_window_s": 0.3}
    jpool = JaxPool(jax_xtts(**CHEAP), **kw)
    jax_codes = _record_jax_pool(jpool)
    try:
        _, j_chunks = _serve_mixed(jpool, conds)
    finally:
        jpool.close()
    pool = _pool(model, **kw)
    try:
        streams, p_chunks = _serve_mixed(pool, conds)
    finally:
        pool.close()
    for p in (jpool, pool):
        assert p.rounds_served == 1 and p.admissions == 1
    assert [s.codes for s in streams] == jax_codes()
    assert [len(s.codes) for s in streams] == [28, 6, 20]
    for k, (pc, jc) in enumerate(zip(p_chunks, j_chunks)):
        assert [x.shape for x in pc] == [x.shape for x in jc], k
        assert max(max_err(x, y) for x, y in zip(pc, jc)) <= 2e-4, k


@pytest.mark.parametrize("first_chunk,chunk,budget", [(4, 8, 14), (8, 4, 10)])
def test_pool_budget_matches_single(model, first_chunk, chunk, budget):
    """A per-request budget below the pool's that ends mid-chunk, and (8, 4)
    a first chunk longer than the others: each row's history holds the
    budget plus the longest chunk (JAX's holds budget + chunk,
    `tpu_tts/infer/xtts_pool.py`:625, and overwrites a row's latents there).
    The budget is at least a chunk: the solo stream clamps its chunks to
    `max_new_tokens`, and a shorter decode window moves the last samples."""
    cond = _cond(model, 8)
    ref = _solo(model, TOK, cond, max_new_tokens=budget, first_chunk_size=first_chunk, stream_chunk_size=chunk)
    pool = _pool(model, first_chunk_size=first_chunk, stream_chunk_size=chunk)
    try:
        out = np.concatenate(list(_submit(pool, TOK, cond, max_tokens=budget)))
    finally:
        pool.close()
    assert out.shape == ref.shape and max_err(out, ref) <= TOL


# ------------------------------------------------------------------ server
@pytest.fixture(scope="module")
def xtts_server(model, tmp_path_factory):
    """The port's server on a model directory (config.json, the state dict,
    a `speakers_xtts.pth` of one speaker), the token ids given by a
    character table, and a greedy pool of small chunks."""
    from tpu_tts_torch.infer.xtts_pool import XttsStreamPool
    from tpu_tts_torch.server.server import TTSHandler, create_server

    tmp = tmp_path_factory.mktemp("xtts_dir")
    config = copy.deepcopy(model.config)
    config.model_args.kv_cache_len = 320  # room for /api/tts's 256 tokens
    config.save_json(str(tmp / "config.json"))
    torch.save(model.net.state_dict(), str(tmp / "model.pth"))
    c, s = _cond(model, 30)
    torch.save({"Ana": {"gpt_cond_latent": c[0], "speaker_embedding": s[0]}}, str(tmp / "speakers_xtts.pth"))
    wav_path = tmp / "speaker.wav"
    scipy.io.wavfile.write(str(wav_path), 22050, (speaker_wav(31) * 20000).astype(np.int16))
    server = create_server(argparse.Namespace(model_dir=str(tmp), device="cpu", host="127.0.0.1", port=0,
                                              max_streams=3))
    synth = TTSHandler.synthesizer
    synth.tts_model.bpe.encode = lambda text, lang: [ord(ch) % 40 + 1 for ch in text][:12]
    TTSHandler._pool = XttsStreamPool(synth.tts_model, max_streams=3, stream_chunk_size=8, first_chunk_size=4,
                                      max_new_tokens=16, top_k=1, gather_window_s=0.3)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", str(wav_path), TTSHandler
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        TTSHandler._pool.close()
        TTSHandler._pool = None


def _fetch(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def test_stream_route_streams_pcm_of_the_solo_length(xtts_server):
    """Two concurrent requests (bundled speaker, speaker_wav) share a round;
    each reply is chunked PCM16 at 24 kHz, the solo stream's samples."""
    base, wav_path, handler = xtts_server
    model, pool = handler.synthesizer.tts_model, handler._pool
    rounds0, adm0 = pool.rounds_served, pool.admissions
    results = {}
    queries = {"a": "text=hello+there&speaker_id=Ana", "b": f"text=a+longer+one&speaker_wav={wav_path}"}
    threads = [threading.Thread(target=lambda k=k, q=q: results.__setitem__(k, _fetch(f"{base}/api/tts_stream?{q}")))
               for k, q in queries.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert (pool.rounds_served - rounds0 == 1) or (pool.admissions - adm0 >= 1)
    conds = {"a": model.speaker_latents("Ana"), "b": handler._cond_latents_cached(model, wav_path)}
    for key, text in (("a", "hello there"), ("b", "a longer one")):
        status, headers, body = results[key]
        assert status == 200 and headers["X-Audio-Format"] == "pcm_s16le" and headers["X-Sample-Rate"] == "24000"
        pcm = np.frombuffer(body, dtype="<i2")
        solo = _solo(model, model.bpe.encode(text, "en"), conds[key], max_new_tokens=16)
        assert pcm.size == solo.size and np.abs(pcm).max() > 0
        ref = (np.clip(solo, -1, 1) * 32767).astype("<i2")
        assert np.abs(pcm.astype(np.int32) - ref).max() <= 1  # one step of PCM16 rounding


@pytest.mark.parametrize("query,code", [("speaker_id=Ana", 400), ("text=hi", 400),
                                        ("text=hi&speaker_wav=/nonexistent/x.wav", 400)])
def test_stream_route_rejects_bad_requests(xtts_server, query, code):
    base, _, _ = xtts_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _fetch(f"{base}/api/tts_stream?{query}")
    assert e.value.code == code


def test_stream_route_505_for_http10(xtts_server):
    base, _, _ = xtts_server
    host, port = base.rsplit("//", 1)[1].split(":")
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(b"GET /api/tts_stream?text=hi&speaker_id=Ana HTTP/1.0\r\n\r\n")
        status = sock.recv(64).split(b"\r\n")[0]
    assert b" 505 " in status


def test_stream_route_501_for_non_xtts():
    from tpu_tts_torch.server.server import TTSHandler

    sent = {}

    class _H(TTSHandler):
        def __init__(self):  # no socket
            pass

        def _send(self, code, body, ctype="text/plain"):
            sent["code"] = code

        class synthesizer:
            tts_model = object()

    _H()._stream_pcm({"text": "hello"})
    assert sent["code"] == 501


def test_api_tts_serves_xtts_from_a_model_directory(xtts_server):
    """`/api/tts` through `Synthesizer.tts` → `Xtts.synthesize` →
    `inference`: a bundled speaker and a speaker_wav, each the model's own
    `inference` waveform plus the sentence gap, at 24 kHz."""
    import io

    from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP

    base, wav_path, handler = xtts_server
    synth = handler.synthesizer
    assert synth.output_sample_rate == 24000 and synth.tts_config.model_dir
    n = synth.tts_model.inference(text="hi there", gpt_cond_latent=synth.tts_model.speaker_latents("Ana")[0],
                                  speaker_embedding=synth.tts_model.speaker_latents("Ana")[1])["wav"].size
    for query in ("speaker_id=Ana", f"speaker_wav={wav_path}"):
        status, _, body = _fetch(f"{base}/api/tts?text=hi+there&{query}")
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        assert status == 200 and sr == 24000 and np.abs(pcm).max() > 0
        if query.startswith("speaker_id"):
            assert pcm.size == n + SENTENCE_GAP
