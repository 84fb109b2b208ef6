"""TTS HTTP server of the port.

Counterpart of `tpu_tts/server/server.py` on the stdlib `http.server`: the
index page (`/`), `/details`, `/api/tts` GET and POST with `speaker_id` and
`language_id`, the MaryTTS routes (`/locales`, `/voices`, `/process` GET and
POST), `create_server` and `main` with `--max_batch`,
`--speakers_file_path` and `--list_models`. A model the micro-batcher
supports (VITS) is served through it, so concurrent `/api/tts` requests
share one batched inference call; every other model and every request the
batcher does not take run on the locked path, one synthesis at a time, as
the reference server's global lock. The index page offers the model's
speakers and languages to choose from, and `/details` lists them.
`/api/tts_stream` and the XTTS pool come with XTTS (ROADMAP.md, M7).
"""

import argparse
import html
import json
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

    def _synth_to_wav_bytes(self, text, speaker_id="", language_id="", style_wav=None) -> bytes:
        if self._batcher is not None and text and style_wav is None:
            wav = self._batcher.tts(text, speaker_name=speaker_id, language_name=language_id)
        else:
            with self.lock:
                wav = self.synthesizer.tts(text, speaker_name=speaker_id, language_name=language_id,
                                           style_wav=style_wav)
        return wav_bytes(np.asarray(wav, dtype=np.float32), self.synthesizer.output_sample_rate)

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if url.path in ("/", "/index.html"):
                self._send(200, self.index, "text/html")
            elif url.path == "/details":
                self._send(200, json.dumps(self.details, indent=2, default=str), "application/json")
            elif url.path == "/api/tts":
                text = q.get("text", "")
                if not text:
                    self._send(400, "missing `text` parameter")
                    return
                wav = self._synth_to_wav_bytes(text, q.get("speaker_id", ""), q.get("language_id", ""),
                                               q.get("style_wav"))
                self._send(200, wav, "audio/wav")
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
                text = q.get("text", "")
                if not text:
                    self._send(400, "missing `text` parameter")
                    return
                wav = self._synth_to_wav_bytes(text, q.get("speaker_id", ""), q.get("language_id", ""))
                self._send(200, wav, "audio/wav")
            else:
                self._send(404, "not found")
        except Exception as e:
            traceback.print_exc()
            self._send(500, f"error: {e}")


def create_server(args):
    """A `ThreadingHTTPServer` serving the checkpoint of `args.model_path` with
    `args.config_path` (and the vocoder of `args.vocoder_path` with
    `args.vocoder_config_path`, if given) on `args.device` (`cuda` unless
    told otherwise), through the micro-batcher (`args.max_batch` rows a
    call, 16 if unset) when it supports the model."""
    from tpu_tts_torch.infer.batcher import TTSMicroBatcher
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    if getattr(args, "model_name", None) or getattr(args, "vocoder_name", None):
        raise NotImplementedError("loading released models by name needs a download; not ported (ROADMAP.md)")
    synthesizer = Synthesizer(
        tts_checkpoint=args.model_path or "",
        tts_config_path=args.config_path or "",
        vocoder_checkpoint=getattr(args, "vocoder_path", None) or "",
        vocoder_config=getattr(args, "vocoder_config_path", None) or "",
        device=getattr(args, "device", None),
        tts_speakers_file=getattr(args, "speakers_file_path", None) or "",
    )
    if TTSHandler._batcher is not None:
        TTSHandler._batcher.close()
    TTSHandler._batcher = None
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
    parser.add_argument("--vocoder_path", type=str, default=None, help=".pth checkpoint of the vocoder.")
    parser.add_argument("--vocoder_config_path", type=str, default=None, help="config.json of the vocoder.")
    parser.add_argument("--vocoder_name", type=str, default=None, help="Released vocoder name (not ported).")
    parser.add_argument("--speakers_file_path", type=str, default=None, help="JSON file for multi-speaker model.")
    parser.add_argument("--list_models", action="store_true", help="List released models and exit.")
    parser.add_argument("--max_batch", type=int, default=16,
                        help="Max sentences per micro-batched /api/tts inference call (VITS).")
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
    if not (args.model_path and args.config_path):
        raise SystemExit("--model_path and --config_path are required (loading by --model_name is not ported)")
    server = create_server(args)
    print(f" > Serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
