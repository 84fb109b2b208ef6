"""TTS HTTP server of the port.

Counterpart of `tpu_tts/server/server.py` on the stdlib `http.server`: the
index page (`/`), `/details`, `/api/tts` GET and POST with `speaker_id` and
`language_id`, the MaryTTS routes (`/locales`, `/voices`, `/process` GET and
POST), `create_server` and `main` with `--max_batch`,
`--speakers_file_path` and `--list_models`. A model the micro-batcher
supports (VITS) is served through it, so concurrent `/api/tts` requests
share one batched inference call; every other model (a mel model with its
vocoder, WaveRNN or a GAN vocoder, among them) and every request the
batcher does not take run on the locked path, one synthesis at a time, as
the reference server's global lock. The index page offers the model's
speakers and languages to choose from, and `/details` lists them.

XTTS (`tpu_tts/server/server.py`:71-188): `/api/tts_stream` answers with
chunked 16-bit PCM as the shared `XttsStreamPool` emits it (`_get_pool`,
`--max_streams` streams a round), the cloning latents of a bundled
`speaker_id` or of a `speaker_wav` path on the server (computed once per
file and modification time, `_cond_latents_cached`); 400 without `text`,
505 for an HTTP/1.0 client (chunked framing is HTTP/1.1's), 501 for a
model that cannot stream, 400 for a `speaker_wav` that is not a file.
`/api/tts` serves XTTS through `Synthesizer.tts` → `Xtts.synthesize`, and
takes `speaker_wav` too. `--model_dir` loads a model directory
(`config.json`, a checkpoint, `speakers_xtts.pth`).
"""

import argparse
import html
import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from tpu_tts_torch.audio import wav_bytes

_INDEX_HTML = """<!DOCTYPE html>
<html>
<head><title>tpu-TTS</title>
<style>
 body { font-family: sans-serif; max-width: 720px; margin: 3em auto; }
 textarea { width: 100%; height: 5em; }
 select, button { margin-top: 0.6em; padding: 0.4em 1em; }
</style></head>
<body>
<h1>tpu-TTS server</h1>
<textarea id="text" placeholder="Type a sentence..."></textarea><br/>
<!--CHOICES-->
<button onclick="speak()">Speak</button>
<p><audio id="audio" controls autoplay hidden></audio></p>
<script>
async function speak() {
  const text = document.getElementById('text').value;
  const pick = (id) => document.getElementById(id) ? document.getElementById(id).value : '';
  const r = await fetch('/api/tts?text=' + encodeURIComponent(text) + '&speaker_id=' +
                        encodeURIComponent(pick('speaker_id')) + '&language_id=' + encodeURIComponent(pick('language_id')));
  const b = await r.blob();
  const a = document.getElementById('audio');
  a.src = URL.createObjectURL(b); a.hidden = false; a.play();
}
</script>
</body></html>
"""


def _choices(names, element_id: str, label: str) -> str:
    if not names:
        return ""
    options = "".join(f'<option value="{html.escape(n)}">{html.escape(n)}</option>' for n in names)
    return f'<label>{label} <select id="{element_id}">{options}</select></label><br/>'


def index_html(synthesizer) -> str:
    """The index page with a choice of the model's speakers and languages."""
    speakers = synthesizer.speaker_manager.speaker_names if synthesizer.speaker_manager else []
    languages = synthesizer.language_manager.language_names if synthesizer.language_manager else []
    return _INDEX_HTML.replace("<!--CHOICES-->", _choices(speakers, "speaker_id", "Speaker")
                               + _choices(languages, "language_id", "Language"))


class TTSHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    timeout = 60
    synthesizer = None
    lock = threading.Lock()
    details = {}
    index = _INDEX_HTML
    # the micro-batcher of a model it supports, else None (the locked path)
    _batcher = None
    # the XTTS stream pool, built on the first /api/tts_stream request:
    # concurrent streams share its decode rounds
    _pool = None
    _pool_lock = threading.Lock()
    pool_max_streams = 8
    # speaker_wav → (cond, spk), keyed by (path, mtime); a key being computed
    # holds an Event, so a burst of requests with one new speaker computes it
    # once and the followers land in the same pool round
    _cond_cache = {}
    _cond_inflight = {}

    @classmethod
    def _get_pool(cls, model):
        with cls._pool_lock:
            if cls._pool is None:
                from tpu_tts_torch.infer.xtts_pool import XttsStreamPool

                cls._pool = XttsStreamPool(model, max_streams=cls.pool_max_streams)
            return cls._pool

    @classmethod
    def _cond_latents_cached(cls, model, speaker_wav):
        from tpu_tts_torch.audio.numpy_transforms import load_wav

        key = (speaker_wav, os.path.getmtime(speaker_wav))
        while True:
            with cls._pool_lock:
                if key in cls._cond_cache:
                    return cls._cond_cache[key]
                evt = cls._cond_inflight.get(key)
                if evt is None:
                    cls._cond_inflight[key] = threading.Event()
                    break
            evt.wait(timeout=300)  # a follower waits for the leader's result
        try:
            sr = model.args.input_sample_rate
            out = model.get_conditioning_latents(load_wav(filename=speaker_wav, sample_rate=sr, resample=True), sr=sr)
            with cls._pool_lock:
                if len(cls._cond_cache) > 64:  # bound the memory of a long-lived server
                    cls._cond_cache.clear()
                cls._cond_cache[key] = out
            return out
        finally:
            with cls._pool_lock:
                cls._cond_inflight.pop(key).set()

    def _resolve_xtts(self):
        """The loaded TTS model if it streams (XTTS), else None."""
        from tpu_tts_torch.models.xtts import Xtts

        model = getattr(self.synthesizer, "tts_model", None)
        return model if isinstance(model, Xtts) else None

    def _stream_pcm(self, q):
        """`/api/tts_stream`: chunked PCM16 (rate in X-Sample-Rate) as the
        pool emits each chunk."""
        text = q.get("text", "")
        if not text:
            self._send(400, "missing `text` parameter")
            return
        if getattr(self, "request_version", "HTTP/1.1") == "HTTP/1.0":
            self._send(505, "/api/tts_stream requires an HTTP/1.1 client (chunked response)")
            return
        model = self._resolve_xtts()
        if model is None:
            self._send(501, "streaming needs an XTTS model (got a batch-synthesis model)")
            return
        speaker_id, speaker_wav = q.get("speaker_id", ""), q.get("speaker_wav", "")
        if speaker_wav and not os.path.isfile(speaker_wav):
            self._send(400, "`speaker_wav` is not a readable file on the server")
            return
        if speaker_id and speaker_id in model._bundled_speakers():
            cond, spk = model.speaker_latents(speaker_id)
        elif speaker_wav:
            cond, spk = self._cond_latents_cached(model, speaker_wav)
        else:
            self._send(400, "XTTS streaming needs `speaker_id` (bundled) or `speaker_wav` (path)")
            return
        stream = self._get_pool(model).submit(text=text, language=q.get("language_id", "") or "en",
                                              gpt_cond_latent=cond, speaker_embedding=spk)
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("X-Sample-Rate", str(model.args.output_sample_rate))
        self.send_header("X-Audio-Format", "pcm_s16le")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        # the headers are out: nothing below may reach do_GET's error reply
        # (a second status line inside the body); on an error the connection
        # drops without the closing 0-chunk, so the client sees a cut stream
        try:
            for chunk in stream:
                pcm = (np.clip(np.asarray(chunk, np.float32), -1.0, 1.0) * 32767).astype("<i2").tobytes()
                if pcm:
                    self.wfile.write(b"%x\r\n" % len(pcm) + pcm + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True  # the client hung up; the round finishes its rows
        except Exception:
            traceback.print_exc()
            self.close_connection = True

    def _send(self, code, body, ctype="text/plain"):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        print(" > %s - %s" % (self.address_string(), fmt % args), flush=True)

    def _synth_to_wav_bytes(self, text, speaker_id="", language_id="", style_wav=None, speaker_wav=None) -> bytes:
        if self._batcher is not None and text and style_wav is None and not speaker_wav:
            wav = self._batcher.tts(text, speaker_name=speaker_id, language_name=language_id)
        else:
            with self.lock:
                wav = self.synthesizer.tts(text, speaker_name=speaker_id, language_name=language_id,
                                           style_wav=style_wav, speaker_wav=speaker_wav or None)
        return wav_bytes(np.asarray(wav, dtype=np.float32), self.synthesizer.output_sample_rate)

    def _tts(self, q):
        """`/api/tts` of a query (GET) or body (POST)."""
        text = q.get("text", "")
        if not text:
            self._send(400, "missing `text` parameter")
            return
        speaker_wav = q.get("speaker_wav", "")
        if speaker_wav and not os.path.isfile(speaker_wav):
            self._send(400, "`speaker_wav` is not a readable file on the server")
            return
        wav = self._synth_to_wav_bytes(text, q.get("speaker_id", ""), q.get("language_id", ""), q.get("style_wav"),
                                       speaker_wav)
        self._send(200, wav, "audio/wav")

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if url.path in ("/", "/index.html"):
                self._send(200, self.index, "text/html")
            elif url.path == "/details":
                self._send(200, json.dumps(self.details, indent=2, default=str), "application/json")
            elif url.path == "/api/tts":
                self._tts(q)
            elif url.path == "/api/tts_stream":
                self._stream_pcm(q)
            # MaryTTS compatibility layer
            elif url.path == "/locales":
                self._send(200, "en_US\n")
            elif url.path == "/voices":
                self._send(200, "default en_US u\n")
            elif url.path == "/process":
                self._send(200, self._synth_to_wav_bytes(q.get("INPUT_TEXT", "")), "audio/wav")
            else:
                self._send(404, "not found")
        except Exception as e:  # surface errors as 500s, keep serving
            traceback.print_exc()
            self._send(500, f"error: {e}")

    def do_POST(self):
        url = urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length).decode("utf-8") if length else ""
        try:
            if url.path == "/process":  # MaryTTS form posts
                q = {k: v[0] for k, v in parse_qs(body).items()}
                self._send(200, self._synth_to_wav_bytes(q.get("INPUT_TEXT", "")), "audio/wav")
            elif url.path == "/api/tts":
                try:
                    q = json.loads(body) if body else {}
                except json.JSONDecodeError:
                    q = {k: v[0] for k, v in parse_qs(body).items()}
                self._tts(q)
            else:
                self._send(404, "not found")
        except Exception as e:
            traceback.print_exc()
            self._send(500, f"error: {e}")


def create_server(args):
    """A `ThreadingHTTPServer` serving the checkpoint of `args.model_path` with
    `args.config_path` (and the vocoder of `args.vocoder_path` with
    `args.vocoder_config_path`, if given), or the model directory
    `args.model_dir`, on `args.device` (`cuda` unless told otherwise),
    through the micro-batcher (`args.max_batch` rows a call, 16 if unset)
    when it supports the model; XTTS streams through a pool of
    `args.max_streams` (8 if unset)."""
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    if getattr(args, "model_name", None) or getattr(args, "vocoder_name", None):
        raise NotImplementedError("loading released models by name needs a download; not ported (ROADMAP.md)")
    synthesizer = Synthesizer(
        tts_checkpoint=getattr(args, "model_path", None) or "",
        tts_config_path=getattr(args, "config_path", None) or "",
        vocoder_checkpoint=getattr(args, "vocoder_path", None) or "",
        vocoder_config=getattr(args, "vocoder_config_path", None) or "",
        device=getattr(args, "device", None),
        tts_speakers_file=getattr(args, "speakers_file_path", None) or "",
        model_dir=getattr(args, "model_dir", None) or "",
    )
    if TTSHandler._batcher is not None:
        TTSHandler._batcher.close()
    TTSHandler._batcher = None
    if TTSHandler._pool is not None:
        TTSHandler._pool.close()
    TTSHandler._pool = None
    TTSHandler._cond_cache = {}
    TTSHandler.pool_max_streams = int(getattr(args, "max_streams", 8) or 8)
    TTSHandler.synthesizer = synthesizer
    if TTSMicroBatcher.supports(synthesizer):
        TTSHandler._batcher = TTSMicroBatcher(synthesizer, max_batch=int(getattr(args, "max_batch", 16) or 16))
    TTSHandler.details = {
        "tts_config": synthesizer.tts_config.to_dict() if synthesizer.tts_config else {},
        "vocoder_config": synthesizer.vocoder_config.to_dict() if synthesizer.vocoder_config else None,
        "speakers": synthesizer.speaker_manager.speaker_names if synthesizer.speaker_manager else [],
        "languages": synthesizer.language_manager.language_names if synthesizer.language_manager else [],
    }
    TTSHandler.index = index_html(synthesizer)
    return ThreadingHTTPServer((args.host, args.port), TTSHandler)


def build_parser():
    parser = argparse.ArgumentParser(description="Run the tpu-tts PyTorch port's HTTP server.")
    parser.add_argument("--model_name", type=str, default=None, help="Released model name (needs a download; "
                        "not ported).")
    parser.add_argument("--model_path", type=str, default=None, help=".pth checkpoint of the model.")
    parser.add_argument("--config_path", type=str, default=None, help="config.json of the model.")
    parser.add_argument("--model_dir", type=str, default=None, help="Model directory (XTTS): config.json, a "
                        ".pth checkpoint and an optional speakers_xtts.pth.")
    parser.add_argument("--vocoder_path", type=str, default=None, help=".pth checkpoint of the vocoder.")
    parser.add_argument("--vocoder_config_path", type=str, default=None, help="config.json of the vocoder.")
    parser.add_argument("--vocoder_name", type=str, default=None, help="Released vocoder name (not ported).")
    parser.add_argument("--speakers_file_path", type=str, default=None, help="JSON file for multi-speaker model.")
    parser.add_argument("--list_models", action="store_true", help="List released models and exit.")
    parser.add_argument("--max_batch", type=int, default=16,
                        help="Max sentences per micro-batched /api/tts inference call (VITS).")
    parser.add_argument("--max_streams", type=int, default=8,
                        help="Concurrent /api/tts_stream requests batched per decode round (XTTS).")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=5002)
    parser.add_argument("--use_cuda", type=bool, default=False, help="Accepted for reference-CLI compat; "
                        "--device says where the models run.")
    parser.add_argument("--debug", type=bool, default=False, help="Accepted for reference-CLI compat.")
    parser.add_argument("--show_details", type=bool, default=False, help="Accepted for reference-CLI compat; "
                        "/details is always served.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_models:
        from tpu_tts_torch.zoo.manage import ModelManager

        ModelManager().list_models()
        return
    if not (args.model_path and args.config_path) and not args.model_dir:
        raise SystemExit("--model_path and --config_path, or --model_dir, are required (loading by --model_name "
                         "is not ported)")
    server = create_server(args)
    print(f" > Serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
