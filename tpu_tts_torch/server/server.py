"""TTS HTTP server of the port.

Counterpart of `tpu_tts/server/server.py` (`/api/tts` GET and POST, `/details`,
`create_server`, `main`, `--vocoder_path`/`--vocoder_config_path`) on the
stdlib `http.server`. Requests take the locked path: one synthesis at a
time, as the reference server's global lock.
The micro-batcher, the MaryTTS routes and the XTTS stream route are not
ported yet (ROADMAP.md).
"""

import argparse
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from tpu_tts_torch.audio import wav_bytes


class TTSHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    timeout = 60
    synthesizer = None
    lock = threading.Lock()
    details = {}

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

    def _tts(self, text: str):
        if not text:
            self._send(400, "missing `text` parameter")
            return
        with self.lock:
            wavs = self.synthesizer.tts(text)
        self._send(200, wav_bytes(np.asarray(wavs, dtype=np.float32), self.synthesizer.output_sample_rate), "audio/wav")

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if url.path == "/details":
                self._send(200, json.dumps(self.details, indent=2, default=str), "application/json")
            elif url.path == "/api/tts":
                self._tts(q.get("text", ""))
            else:
                self._send(404, "not found")
        except Exception as e:  # surface errors as 500s, keep serving
            traceback.print_exc()
            self._send(500, f"error: {e}")

    def do_POST(self):
        url = urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length).decode("utf-8") if length else ""
        if url.path != "/api/tts":
            self._send(404, "not found")
            return
        try:
            q = json.loads(body) if body else {}
        except json.JSONDecodeError:
            q = {k: v[0] for k, v in parse_qs(body).items()}
        try:
            self._tts(q.get("text", ""))
        except Exception as e:
            traceback.print_exc()
            self._send(500, f"error: {e}")


def create_server(args):
    """A `ThreadingHTTPServer` serving the checkpoint of `args.model_path` with
    `args.config_path` (and the vocoder of `args.vocoder_path` with
    `args.vocoder_config_path`, if given) on `args.device` (`cuda` unless
    told otherwise)."""
    from tpu_tts_torch.infer.synthesizer import Synthesizer

    synthesizer = Synthesizer(
        tts_checkpoint=args.model_path or "",
        tts_config_path=args.config_path or "",
        vocoder_checkpoint=getattr(args, "vocoder_path", None) or "",
        vocoder_config=getattr(args, "vocoder_config_path", None) or "",
        device=getattr(args, "device", None),
    )
    TTSHandler.synthesizer = synthesizer
    TTSHandler.details = {
        "tts_config": synthesizer.tts_config.to_dict() if synthesizer.tts_config else {},
        "vocoder_config": synthesizer.vocoder_config.to_dict() if synthesizer.vocoder_config else None,
    }
    return ThreadingHTTPServer((args.host, args.port), TTSHandler)


def build_parser():
    parser = argparse.ArgumentParser(description="Run the tpu-tts PyTorch port's HTTP server.")
    parser.add_argument("--model_path", type=str, required=True, help="torch state_dict file of the model.")
    parser.add_argument("--config_path", type=str, required=True, help="config.json of the model.")
    parser.add_argument("--vocoder_path", type=str, default=None, help="torch state_dict file of the vocoder.")
    parser.add_argument("--vocoder_config_path", type=str, default=None, help="config.json of the vocoder.")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=5002)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = create_server(args)
    print(f" > Serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
